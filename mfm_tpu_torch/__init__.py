"""mfm_tpu_torch: Markovian Flow Matching in PyTorch, with hand-written CUDA
kernels for an NVIDIA Hopper card (sm_90a).

A port of ``mfm_tpu`` (JAX/Pallas on a TPU), which stays beside it as the
reference every module here is tested against. The package keeps
``mfm_tpu``'s subpackage and module names:

- ``targets``      unnormalised target densities (4-mode, 16-mode, phi-four)
- ``kernels``      the ensemble MALA kernel and its accept/reject algebra
- ``smc``          the fixed-iteration bisection used by tempering
- ``flows``        the CNF vector field, ODE transport, flow-matching loss,
                   the hand-written AdamW and the pullback random-walk MH
- ``ops``          the CUDA kernels (fused field apply, pairwise Stein/RBF
                   sums), each with its plain PyTorch version
- ``diagnostics``  Stein discrepancy and MMD
- ``drivers``      the MFM training loop, final sampling and evaluation
- ``utils``        flax -> torch parameter conversion

It imports ``torch`` and never ``jax``. Randomness is injected: every
stochastic leaf function takes its noise as tensors, and the drivers draw
that noise from an explicit ``torch.Generator``.
"""

__version__ = "0.1.0"
