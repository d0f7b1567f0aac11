"""Target densities and the flow reference-distribution registry."""

from mfm_tpu_torch.targets.base import Target
from mfm_tpu_torch.targets.gaussian import (
    FlatDistribution,
    GaussianMixture,
    IndepGaussian,
    bimodal_mixture,
    four_mode_mixture,
    random_mixture,
)
from mfm_tpu_torch.targets.phi_four import PhiFour, PhiFourBase

# name -> (dim, device) -> reference; 'bimodal' is 2-D whatever dim says,
# as in mfm_tpu
REF_DISTS = {
    "stdgauss": lambda dim, device: IndepGaussian(dim),
    "widegauss": lambda dim, device: IndepGaussian(dim, var=5.0),
    "bimodal": lambda dim, device: bimodal_mixture(device),
    "flat": lambda dim, device: FlatDistribution(dim),
    "phifour": lambda dim, device: PhiFourBase(dim, device=device),
}


def make_ref_dist(name: str, dim: int, device=None) -> Target:
    if name == "prior":
        raise NotImplementedError("reference distribution 'prior' is not ported yet")
    try:
        return REF_DISTS[name](dim, device)
    except KeyError:
        raise ValueError(f"unknown reference distribution {name!r}") from None


__all__ = [
    "Target",
    "IndepGaussian",
    "FlatDistribution",
    "GaussianMixture",
    "bimodal_mixture",
    "four_mode_mixture",
    "random_mixture",
    "PhiFour",
    "PhiFourBase",
    "REF_DISTS",
    "make_ref_dist",
]
