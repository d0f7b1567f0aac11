from mfm_tpu_torch.sbi.snpe import SNPE, SNPE_A, simulator

__all__ = ["SNPE", "SNPE_A", "simulator"]
