from mfm_tpu_torch.smc.solvers import bisection

__all__ = ["bisection"]
