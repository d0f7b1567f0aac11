from mfm_tpu_torch.drivers.baselines import is_resample
from mfm_tpu_torch.drivers.eval import (
    aggregate_seeds,
    check_floor,
    evaluate_samples,
    report_row,
)
from mfm_tpu_torch.drivers.flow_smc import FlowSMCResult, run_flow_smc
from mfm_tpu_torch.drivers.mfm import (
    MFMRun,
    build_mfm,
    next_beta,
    run_mfm,
    sample_flow,
    sample_flow_parts,
)
from mfm_tpu_torch.drivers.smc_run import SMCRunResult, run_smc

__all__ = [
    "is_resample",
    "evaluate_samples",
    "check_floor",
    "report_row",
    "aggregate_seeds",
    "MFMRun",
    "build_mfm",
    "next_beta",
    "run_mfm",
    "sample_flow",
    "sample_flow_parts",
    "FlowSMCResult",
    "run_flow_smc",
    "SMCRunResult",
    "run_smc",
]
