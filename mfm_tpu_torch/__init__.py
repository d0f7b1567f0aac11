"""mfm_tpu_torch: Markovian Flow Matching in PyTorch, with hand-written CUDA
kernels for an NVIDIA Hopper card (sm_90a).

A port of ``mfm_tpu`` (JAX/Pallas on a TPU), which stays beside it as the
reference every module here is tested against. The package keeps
``mfm_tpu``'s subpackage and module names:

- ``targets``      unnormalised target densities (4-mode, 16-mode, phi-four)
                   and the flow references (Gaussian, bimodal, flat, phi^4)
- ``kernels``      the ensemble MALA, HMC and NUTS kernels and their
                   accept/reject algebra, the transport slice sampler
                   (TESS), conditional importance sampling (CIS), the
                   sampler protocol and ``inference_loop``
- ``adaptation``   dual averaging and the Welford mass (window adaptation);
                   cross-chain and ensemble-chain adaptation, the optimizer
                   loop, and the ATESS, MSC and MSC-MALA warmups
- ``optimizers``   COCOB, the parameter-free coin-betting optimizer
- ``vi``           SVGD and coin-SVGD
- ``sbi``          a simulator and SNPE-A
- ``smc``          adaptive tempered and waste-free SMC: resampling, ESS,
                   the root solvers
- ``flows``        the CNF vector field, ODE transport, flow-matching loss,
                   the hand-written AdamW and optax's Adam, SGD,
                   global-norm clip and chain, the flow kernels, the latent pullback
                   target, and the coupling flows (real-NVP, RQ spline)
- ``ops``          the CUDA kernels (fused field apply, pairwise Stein/RBF
                   sums, phi^4 value and score), each with its plain
                   PyTorch version
- ``diagnostics``  Stein discrepancy and MMD
- ``drivers``      the MFM training loop, the SMC and flow-SMC drivers,
                   the baselines FAB (``fab``, with its YAML config
                   reader), flowMC (``flowmc``) and DDS (``dds``) behind
                   ``baselines.run_baseline``, final sampling (IS, the MALA
                   move correction, the defensive mixture) and evaluation
- ``utils``        flax -> torch parameter conversion (vector fields,
                   coupling flows, the Cox target's state), checkpoints,
                   the run logger, and the profiling helpers

It imports ``torch`` and never ``jax``. Randomness is injected: every
stochastic leaf function takes its noise as tensors, and the drivers draw
that noise from an explicit ``torch.Generator``.
"""

__version__ = "0.1.0"
