from mfm_tpu_torch.vi.svgd import (
    SVGDState,
    coin_svgd,
    median_heuristic,
    rbf_kernel_matrix,
    stein_functional_gradient,
    svgd,
    update_median_heuristic,
)

__all__ = [
    "SVGDState",
    "coin_svgd",
    "median_heuristic",
    "rbf_kernel_matrix",
    "stein_functional_gradient",
    "svgd",
    "update_median_heuristic",
]
