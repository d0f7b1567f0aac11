"""Target densities and the flow reference-distribution registry."""

from mfm_tpu_torch.targets.base import Target
from mfm_tpu_torch.targets.gaussian import (
    GaussianMixture,
    IndepGaussian,
    four_mode_mixture,
    random_mixture,
)
from mfm_tpu_torch.targets.phi_four import PhiFour

REF_DISTS = {
    "stdgauss": lambda dim: IndepGaussian(dim),
    "widegauss": lambda dim: IndepGaussian(dim, var=5.0),
}


def make_ref_dist(name: str, dim: int) -> Target:
    try:
        return REF_DISTS[name](dim)
    except KeyError:
        raise NotImplementedError(
            f"reference distribution {name!r} is not ported yet "
            f"(ported: {sorted(REF_DISTS)})"
        ) from None


__all__ = [
    "Target",
    "IndepGaussian",
    "GaussianMixture",
    "four_mode_mixture",
    "random_mixture",
    "PhiFour",
    "REF_DISTS",
    "make_ref_dist",
]
