"""Gaussian-family targets (counterpart of ``mfm_tpu.targets.gaussian``).

The mixture log-density is one ``(B, K, d)`` broadcast reduction and a
``logsumexp`` in log space, as in the reference.
"""

import math

import torch

from mfm_tpu_torch.targets.base import Target

_LOG2PI = math.log(2.0 * math.pi)


class IndepGaussian(Target):
    """Isotropic Gaussian N(mean, var * I); also the 'stdgauss' reference."""

    def __init__(self, dim: int, mean: float = 0.0, var: float = 1.0):
        self.dim = dim
        self.mean = float(mean)
        self.var = float(var)
        self.std = math.sqrt(self.var)

    def log_lik(self, x):
        z = (x - self.mean) / self.std
        quad = torch.sum(z * z, dim=-1)
        norm = self.dim * (_LOG2PI + 2.0 * math.log(self.std))
        return -0.5 * (quad + norm)

    def sample(self, generator, shape=()):
        eps = torch.randn(
            tuple(shape) + (self.dim,), generator=generator, device=generator.device
        )
        return self.mean + self.std * eps


class GaussianMixture(Target):
    """Mixture of diagonal-covariance Gaussians; ``covs`` holds per-dimension
    variances, shape (K, d)."""

    def __init__(self, modes, covs, weights, device=None):
        as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
        self.modes = as_t(modes)
        self.covs = as_t(covs)
        self.weights = as_t(weights)
        self.dim = self.modes.shape[-1]
        self.chol_covs = torch.sqrt(self.covs)
        self.log_weights = torch.log(self.weights)
        self._log_norm = -0.5 * torch.sum(_LOG2PI + torch.log(self.covs), dim=-1)

    @property
    def n_modes(self) -> int:
        return self.modes.shape[0]

    def log_lik(self, x):
        z = (x[..., None, :] - self.modes) / self.chol_covs
        comp = -0.5 * torch.sum(z * z, dim=-1) + self._log_norm + self.log_weights
        return torch.logsumexp(comp, dim=-1)

    def sample(self, generator, shape=()):
        """Ancestral sampler: a mode index, then Gaussian noise."""
        shape = tuple(shape)
        n = math.prod(shape)
        idx = torch.multinomial(
            self.weights, n, replacement=True, generator=generator
        ).reshape(shape)
        eps = torch.randn(
            shape + (self.dim,), generator=generator, device=self.modes.device
        )
        return self.modes[idx] + self.chol_covs[idx] * eps


def four_mode_mixture(device=None) -> GaussianMixture:
    """The '4-mode' benchmark target: modes at (+-8, +-8), unit variances."""
    modes = 8.0 * torch.tensor([[1.0, 1.0], [1.0, -1.0], [-1.0, 1.0], [-1.0, -1.0]])
    return GaussianMixture(modes, torch.ones(4, 2), torch.ones(4) / 4.0, device)


# ``mfm_tpu.targets.random_mixture()`` draws its 16 modes from PRNGKey(0).
# JAX's threefry stream cannot be reproduced in torch, so the drawn float32
# values are tabled here; tests/test_torch_targets.py holds them equal to a
# fresh JAX draw.
_MIXTURE16_MODES = [
    8.7632417678833, -8.13110637664795, -6.984241008758545, -9.709424018859863,
    -7.889575481414795, 5.683584690093994, 6.795407295227051, -8.894965171813965,
    11.563681602478027, -12.049652099609375, -10.27301025390625, 1.360467553138733,
    -9.614153861999512, 2.420788526535034, 11.762964248657227, 4.946615695953369,
    5.736855983734131, -4.654992580413818, 8.193829536437988, 3.610272169113159,
    -6.067538738250732, -7.884390354156494, 7.062798976898193, 9.11553955078125,
    8.144769668579102, -4.832089424133301, 8.009264945983887, 11.521417617797852,
    -12.6480131149292, 4.369305610656738, 11.914633750915527, -9.718527793884277,
]
_MIXTURE16_COVS = [
    0.2948678731918335, 0.36137455701828003, 1.1082388162612915, 0.8379682302474976,
    0.6831867694854736, 0.5547288060188293, 0.5632060170173645, 1.160188913345337,
    0.5193029046058655, 2.901132583618164, 0.9095674157142639, 1.6193196773529053,
    0.5217586755752563, 0.687738299369812, 0.8298592567443848, 1.2478166818618774,
    0.5514799952507019, 0.9659648537635803, 0.6200039386749268, 0.37554314732551575,
    0.5752232074737549, 0.8512898683547974, 1.9448113441467285, 1.500980257987976,
    0.5602277517318726, 0.7621433138847351, 1.4976768493652344, 2.287140130996704,
    0.8149284720420837, 1.0273104906082153, 0.7231099009513855, 0.4132106304168701,
]
_MIXTURE16_WEIGHTS = [
    0.06233842670917511, 0.06689196825027466, 0.08242753893136978,
    0.11962796747684479, 0.04859733581542969, 0.06071411073207855,
    0.04775719344615936, 0.06223822385072708, 0.0411914698779583,
    0.010878645814955235, 0.06571689248085022, 0.030604319646954536,
    0.07914730161428452, 0.01966680772602558, 0.09307865798473358,
    0.10912317782640457,
]


def random_mixture(device=None) -> GaussianMixture:
    """The 'gaussian-mixture' benchmark: 16 modes in a box (the values
    ``mfm_tpu.targets.random_mixture()`` draws with its default key)."""
    return GaussianMixture(
        torch.tensor(_MIXTURE16_MODES).reshape(16, 2),
        torch.tensor(_MIXTURE16_COVS).reshape(16, 2),
        torch.tensor(_MIXTURE16_WEIGHTS),
        device,
    )
