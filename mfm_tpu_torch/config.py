"""Run configuration of the port: ``MFMConfig``, ``preset`` and ``from_yaml``.

The fields, defaults, validation and per-example presets are those of the
reference package's configuration, so one YAML file or ``--set`` override
means the same in both. This module is the port's own copy: nothing here
reads the reference package. Field names keep their meaning, except
``pallas_field``, which here selects the fused CUDA field kernel
(``ops/field.py``).
"""

import dataclasses
import os
from typing import Optional, Sequence, Tuple


@dataclasses.dataclass
class MFMConfig:
    # problem
    example: str = "4-mode"
    dim: int = 2
    seed: int = 0

    # flow architecture
    hidden_x: Sequence[int] = (128, 128)
    hidden_t: Sequence[int] = (128, 128)
    hidden_xt: Sequence[int] = (128, 128)
    fourier_dim: int = 128
    fourier_std: float = 1.0
    non_linearity: str = "relu"
    grad_clip_score: float = 1.0  # applied to the score gate when dim > 128
    # None = the dim > 128 rule; True/False forces the score-gate clip on or
    # off. Targets whose score explodes at any dim (Neal's funnel:
    # |d/dx log p| ~ exp(-v) in the neck) need True, or tail latents
    # diverge through the transport.
    clip_score: Optional[bool] = None
    # the fused CUDA field kernel (ops/field.py) for every transport stage:
    # exact fp32, relu/tanh, widths and d <= 128. Only with
    # field_precision='highest'; build_mfm raises on a net it cannot take.
    pallas_field: bool = False

    # flow matching
    sigma: float = 1e-4
    ref_dist: str = "stdgauss"
    cond_flow: bool = True
    ot_cond_flow: bool = False

    # CNF transport
    hutchinson: bool = False
    # None derives the estimator from ``hutchinson``; or force one of
    # 'exact' | 'hutchinson' | 'exact_disc'. 'exact_disc' is the exact
    # log-Jacobian of the discrete integrator map, small d only (it
    # materialises a (B, d, d) Jacobian).
    divergence_mode: Optional[str] = None
    ode_steps: int = 24
    ode_method: str = "rk4"
    # 'highest' = fp32 products; 'default' = bf16 operands, fp32 accumulation
    field_precision: str = "highest"
    # evaluation-time transport overrides (final sampling + IS correction):
    # IS weights exponentiate the Hutchinson logdet noise, so more or better
    # probes at eval time raise the IS effective sample size at high dim;
    # training keeps the single-probe estimator.
    eval_hutchinson_probes: int = 1
    eval_probe_dist: str = "gaussian"  # or 'rademacher' (lower variance)
    eval_ode_steps: Optional[int] = None  # None = same as ode_steps

    # interleaving & kernels
    num_importance_samples: int = 0  # >0 CIS, <0 indep-MH, 0 pullback-RWM
    mcmc_per_flow_steps: float = 10.0  # <0 trains on exact target samples
    num_chain: int = 128
    step_size: float = 0.2
    mcmc_kernel: str = "mala"  # mala | hmc | nuts
    hmc_num_integration_steps: int = 10
    nuts_max_depth: int = 6
    nuts_variant: str = "auto"  # auto | static | iterative
    # in-loop MCMC adaptation. None = auto: on for hmc/nuts, off for mala.
    adapt_step_size: Optional[bool] = None
    adapt_mass: Optional[bool] = None  # diagonal inverse mass (hmc/nuts only)
    da_target_acceptance: Optional[float] = None  # auto: 0.8 hmc/nuts, 0.574 mala
    mass_refresh_every: int = 100  # window length for Welford mass refreshes
    # freeze in-loop adaptation after this fraction of learning_iter: the
    # rest of the run keeps the dual-averaged step size and the last mass
    # estimate. 1.0 adapts to the end.
    adapt_freeze_fraction: float = 0.6
    learning_iter: int = 400
    eval_iter: int = 100

    # adaptive tempering
    alpha: float = 0.95
    anneal_iter: int = 200
    num_anneal_temp: int = 200
    # flowMC baseline: coupling-flow depth. None = len(hidden_x) +
    # len(hidden_t) + 4; set it to decouple the flow depth from the field.
    flowmc_n_layers: Optional[int] = None

    # SMC tempering path. "reference": pi_beta ∝ exp(beta*log_lik +
    # log_prior); for flat-prior targets (the mixtures, many-well,
    # phi-four) its beta=0 end is improper while particles start from
    # N(0, I), which biases the logZ telescope. "geometric":
    # pi_beta ∝ N(0,I)^(1-beta) * p^beta, whose beta=0 end is the initial
    # distribution. Samples at beta=1 target p either way. Proper-prior
    # targets (pines) keep "reference".
    smc_path: str = "reference"  # reference | geometric

    # waste-free SMC (Dau & Chopin 2022) for the SMC drivers: resample
    # M = num_chain / P ancestors per tempering step and keep all P chain
    # states per ancestor. 0 = standard SMC (iter_per_temp inner moves,
    # last state kept); P >= 2 replaces the move budget with P - 1.
    waste_free_p: int = 0

    # optimizer
    learning_rate: float = 1e-3
    weight_decay: float = 1e-4
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_epsilon: float = 1e-8
    gradient_clip: float = 1.0
    warmup_steps: int = 0

    # execution
    chunk_size: int = 100  # iterations per logged chunk
    mesh_shape: Optional[Tuple[int, ...]] = None  # (ensemble, chains) or None
    checkpoint_dir: Optional[str] = None
    checkpoint_every_chunks: int = 0  # 0 disables

    # plotting / misc
    lim: Optional[Sequence[float]] = (-16.0, 16.0)
    grid_width: int = 400
    levels: int = 50

    def __post_init__(self):
        # fail at construction (dataclass, YAML, CLI --set) rather than at
        # the first transport build
        allowed = (None, "exact", "hutchinson", "exact_disc")
        if self.divergence_mode not in allowed:
            raise ValueError(
                f"divergence_mode={self.divergence_mode!r} not in "
                f"{allowed[1:]}"
            )

    @property
    def iter_per_temp(self) -> int:
        return max(self.anneal_iter // self.num_anneal_temp, 1)

    @property
    def score_clip(self) -> Optional[float]:
        """Score-gate clipping activates above dim 128 unless
        ``clip_score`` forces it."""
        on = self.dim > 128 if self.clip_score is None else self.clip_score
        return self.grad_clip_score if on else None

    @property
    def divergence(self) -> str:
        if self.divergence_mode is not None:  # validated in __post_init__
            return self.divergence_mode
        return "hutchinson" if self.hutchinson else "exact"

    def resolved_adaptation(self) -> Tuple[bool, bool, float]:
        """(adapt_step_size, adapt_mass, target_acceptance) with None fields
        resolved: gradient-trajectory kernels (hmc/nuts) adapt by default;
        MALA keeps its fixed step size unless asked. Target acceptance
        defaults: 0.8 (hmc/nuts), 0.574 (MALA)."""
        grad_traj = self.mcmc_kernel in ("hmc", "nuts")
        astep = grad_traj if self.adapt_step_size is None else self.adapt_step_size
        if self.adapt_mass and not grad_traj:
            raise ValueError(
                "adapt_mass=True requires a trajectory kernel (hmc/nuts); "
                f"mcmc_kernel={self.mcmc_kernel!r} has no mass matrix"
            )
        amass = (
            (grad_traj and astep) if self.adapt_mass is None else self.adapt_mass
        )
        tacc = self.da_target_acceptance
        if tacc is None:
            tacc = 0.8 if grad_traj else 0.574
        return astep, amass and grad_traj, tacc


def preset(example: str, **overrides) -> MFMConfig:
    """Per-example hyperparameters, then ``overrides``."""
    cfg = MFMConfig(example=example)
    if example == "4-mode":
        cfg.dim = 2
        cfg.step_size = 0.2
        cfg.lim = (-16.0, 16.0)
        cfg.levels = 20
        cfg.learning_iter = 1000
    elif example == "gaussian-mixture":
        cfg.dim = 2
        cfg.step_size = 0.2
        cfg.lim = (-16.0, 16.0)
        cfg.levels = 20
        cfg.learning_iter = 10_000
    elif example == "phi-four":
        cfg.dim = 64
        cfg.num_chain = 1024
        cfg.eval_iter = 1
        cfg.step_size = 1e-4
        cfg.lim = (-1.6, 1.6)
        cfg.learning_iter = 10_000
        cfg.chunk_size = 1000
        # bf16 operands, fp32 accumulation in the field; --set
        # field_precision=highest gives fp32 products
        cfg.field_precision = "default"
    elif example == "pines":
        cfg.dim = 1600
        cfg.num_chain = 128
        cfg.eval_iter = 1
        cfg.step_size = 0.01
        cfg.hidden_x = cfg.hidden_t = cfg.hidden_xt = (1024, 1024)
        cfg.lim = None
        cfg.learning_iter = 10_000
        cfg.chunk_size = 1000
        cfg.hutchinson = True  # the exact trace is O(d) passes at d=1600
        # prior -> posterior transport; pass ref_dist='stdgauss' for the
        # standard Gaussian reference
        cfg.ref_dist = "prior"
        # bf16 operands, fp32 accumulation in the field. The flow-MH
        # correction stays exact against the bf16-defined flow: forward and
        # inverse use the same function. --set field_precision=highest
        # gives fp32 products.
        cfg.field_precision = "default"
        # Rademacher eval probes: at d=1600 one Gaussian Hutchinson probe
        # puts several nats of noise on each logdet, which tilts any
        # exponentiated use of it; Rademacher probes drop the diagonal
        # variance term at the same cost.
        cfg.eval_probe_dist = "rademacher"
    elif example == "funnel":
        # Neal's funnel through the full MFM pipeline; dim and sigma follow
        # the FAB setup
        cfg.dim = 10
        cfg.step_size = 0.1
        cfg.lim = (-8.0, 8.0)
        cfg.learning_iter = 2000
        # the funnel score explodes like exp(-v) in the neck at any dim;
        # unclipped, tail latents diverge through the transport at eval
        cfg.clip_score = True
    elif example == "many-well":
        # dim=32 = 16 double-well pairs, 2^16 modes
        cfg.dim = 32
        cfg.step_size = 0.02
        cfg.lim = (-3.0, 3.0)
        cfg.learning_iter = 2000
    else:
        raise ValueError(f"unknown example {example!r}")
    for k, v in overrides.items():
        if not hasattr(cfg, k):
            raise ValueError(f"unknown config field {k!r}")
        setattr(cfg, k, v)
    cfg.__post_init__()  # overrides bypass dataclass init; re-validate
    return cfg


def from_yaml(path: str, **overrides) -> MFMConfig:
    """Load a config from one flat YAML file, with an optional ``include``
    chain and an optional ``example`` preset as its base.

    Resolution order: preset(example) if given -> included file(s) ->
    this file's fields -> keyword overrides.
    """
    import yaml

    def collect(p):
        """Depth-first: included files contribute only their explicit fields."""
        with open(p) as fh:
            raw = dict(yaml.safe_load(fh) or {})
        include = raw.pop("include", None)
        fields = {}
        if include is not None:
            fields.update(collect(os.path.join(os.path.dirname(p), include)))
        fields.update(raw)
        return fields

    merged = {**collect(path), **overrides}
    example = merged.pop("example", None)
    cfg = preset(example) if example is not None else MFMConfig()
    for k, v in merged.items():
        if not hasattr(cfg, k):
            raise ValueError(f"unknown config field {k!r} in {path}")
        if isinstance(getattr(cfg, k), tuple) and isinstance(v, list):
            v = tuple(v)
        setattr(cfg, k, v)
    cfg.__post_init__()  # overrides bypass dataclass init; re-validate
    return cfg
