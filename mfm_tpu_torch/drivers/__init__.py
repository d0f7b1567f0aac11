from mfm_tpu_torch.drivers.baselines import is_resample
from mfm_tpu_torch.drivers.eval import evaluate_samples
from mfm_tpu_torch.drivers.mfm import (
    MFMRun,
    build_mfm,
    next_beta,
    run_mfm,
    sample_flow,
    sample_flow_parts,
)

__all__ = [
    "is_resample",
    "evaluate_samples",
    "MFMRun",
    "build_mfm",
    "next_beta",
    "run_mfm",
    "sample_flow",
    "sample_flow_parts",
]
