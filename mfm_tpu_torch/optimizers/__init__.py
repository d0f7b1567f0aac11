from mfm_tpu_torch.optimizers.cocob import CocobState, cocob

__all__ = ["CocobState", "cocob"]
