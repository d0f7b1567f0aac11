"""mfm_tpu_torch: Markovian Flow Matching in PyTorch, with hand-written CUDA
kernels for an NVIDIA Hopper card (sm_90a).

A port of ``mfm_tpu`` (JAX/Pallas on a TPU), which stays beside it as the
reference every module here is tested against. The package keeps
``mfm_tpu``'s subpackage and module names:

- ``targets``      unnormalised target densities (4-mode, 16-mode, phi-four)
                   and the flow references (Gaussian, bimodal, flat, phi^4)
- ``kernels``      the ensemble MALA, HMC and NUTS kernels and their
                   accept/reject algebra
- ``adaptation``   dual averaging and the Welford mass (window adaptation)
- ``smc``          adaptive tempered and waste-free SMC: resampling, ESS,
                   the root solvers
- ``flows``        the CNF vector field, ODE transport, flow-matching loss,
                   the hand-written AdamW, the flow kernels and the
                   latent pullback target
- ``ops``          the CUDA kernels (fused field apply, pairwise Stein/RBF
                   sums, phi^4 value and score), each with its plain
                   PyTorch version
- ``diagnostics``  Stein discrepancy and MMD
- ``drivers``      the MFM training loop, the SMC and flow-SMC drivers,
                   final sampling and evaluation
- ``utils``        flax -> torch parameter conversion

It imports ``torch`` and never ``jax``. Randomness is injected: every
stochastic leaf function takes its noise as tensors, and the drivers draw
that noise from an explicit ``torch.Generator``.
"""

__version__ = "0.1.0"
