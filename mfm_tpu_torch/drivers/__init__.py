from mfm_tpu_torch.drivers.baselines import BaselineResult, is_resample, run_baseline
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
    mala_move_correct,
    next_beta,
    run_mfm,
    sample_flow,
    sample_flow_defensive,
    sample_flow_defensive_parts,
    sample_flow_move,
    sample_flow_parts,
)
from mfm_tpu_torch.drivers.multi_seed import SeedSweep, run_mfm_seeds, seed_run
from mfm_tpu_torch.drivers.smc_run import SMCRunResult, run_smc

__all__ = [
    "BaselineResult",
    "is_resample",
    "run_baseline",
    "evaluate_samples",
    "check_floor",
    "report_row",
    "aggregate_seeds",
    "MFMRun",
    "build_mfm",
    "next_beta",
    "run_mfm",
    "mala_move_correct",
    "sample_flow",
    "sample_flow_defensive",
    "sample_flow_defensive_parts",
    "sample_flow_move",
    "sample_flow_parts",
    "SeedSweep",
    "run_mfm_seeds",
    "seed_run",
    "FlowSMCResult",
    "run_flow_smc",
    "SMCRunResult",
    "run_smc",
]
