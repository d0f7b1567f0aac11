"""Target densities and the flow reference-distribution registry."""

from mfm_tpu_torch.targets.base import GeometricPath, PriorReference, Target, as_logprob_fn
from mfm_tpu_torch.targets.cox import LogGaussianCoxPines
from mfm_tpu_torch.targets.funnel import Funnel, ManyWell
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
# as in mfm_tpu. 'prior' is not in the table: it wraps the run's target
# (``PriorReference``), which ``drivers.mfm.build_mfm`` does.
REF_DISTS = {
    "stdgauss": lambda dim, device: IndepGaussian(dim),
    "widegauss": lambda dim, device: IndepGaussian(dim, var=5.0),
    "bimodal": lambda dim, device: bimodal_mixture(device),
    "flat": lambda dim, device: FlatDistribution(dim),
    "phifour": lambda dim, device: PhiFourBase(dim, device=device),
}


def make_ref_dist(name: str, dim: int, device=None) -> Target:
    if name == "prior":
        raise ValueError(
            "reference distribution 'prior' is made from the target: PriorReference(target)"
        )
    try:
        return REF_DISTS[name](dim, device)
    except KeyError:
        raise ValueError(f"unknown reference distribution {name!r}") from None


__all__ = [
    "Target",
    "as_logprob_fn",
    "GeometricPath",
    "PriorReference",
    "LogGaussianCoxPines",
    "Funnel",
    "ManyWell",
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
