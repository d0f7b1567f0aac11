"""Helpers shared by the port's parity tests (tests/test_torch_*.py): the
same inputs, made with numpy or by JAX, go through ``mfm_tpu`` and its
counterpart in ``mfm_tpu_torch``; arrays cross as numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfm_tpu.flows.vector_field import NON_LINEARITIES, VectorFieldNet as FlaxNet
from mfm_tpu_torch.adaptation.window import DualAveragingState, WelfordState
from mfm_tpu_torch.drivers.mfm import MFMCarry
from mfm_tpu_torch.flows import VectorFieldNet, field_params
from mfm_tpu_torch.flows.train import AdamWFiniteState, TrainState
from mfm_tpu_torch.kernels import ChainState
from mfm_tpu_torch.utils.convert import params_from_flax


@pytest.fixture(autouse=True)
def cli_run_dir(tmp_path, monkeypatch):
    """Autouse where imported: the CLI's per-seed logs go to a temporary
    --run-dir, not to runs/ in the working directory."""
    from mfm_tpu_torch import cli

    monkeypatch.setattr(cli, "RUN_DIR", str(tmp_path / "runs"))


def tt(a) -> torch.Tensor:
    """numpy / JAX array -> float32 (or integer/bool as is) torch tensor."""
    a = np.asarray(a)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a))


def npy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def flax_field(key, dim=4, width=16, fourier=8, act="relu", score_fn=None,
               score_clip=None, perturb=0.05, gate_perturb=None):
    """A flax VectorFieldNet with every parameter perturbed (its zero heads
    would make a parity test blind to head and gate bugs)."""
    kf, ki = jax.random.split(key)
    freqs = jax.random.normal(kf, (fourier,))
    net = FlaxNet(
        fourier_freqs=freqs, hidden_x=(width, width), hidden_t=(width, width),
        hidden_xt=(width, width), act=NON_LINEARITIES[act], score_fn=score_fn,
        score_clip=score_clip, precision=jax.lax.Precision.HIGHEST,
    )
    params = net.init(ki, jnp.zeros((1, dim)), jnp.zeros((1,)))
    gate_perturb = perturb if gate_perturb is None else gate_perturb

    def bump(path, p):
        scale = gate_perturb if "gate_head" in jax.tree_util.keystr(path) else perturb
        return p + scale * jax.random.normal(jax.random.fold_in(ki, p.size), p.shape)

    params = jax.tree_util.tree_map_with_path(bump, params)
    return net, params, freqs


def torch_field(params, freqs, dim=4, width=16, act="relu", score_fn=None, score_clip=None,
                precision="highest"):
    """The port's net and parameter dict carrying the flax parameters."""
    net = VectorFieldNet(
        dim, tt(freqs), (width, width), (width, width), (width, width), act=act,
        score_fn=score_fn, score_clip=score_clip, precision=precision,
    )
    state = params_from_flax(jax.tree_util.tree_map(np.asarray, params), np.asarray(freqs))
    net.load_state_dict(state)
    return net, field_params(net)


def nuts_noise(key, B, d, depth, variant):
    """``mfm_tpu_torch.kernels.nuts.NUTSNoise`` made of the draws the
    reference's NUTS kernel takes from ``key`` (mfm_tpu/kernels/nuts.py):
    static, :177,195-209 and each subtree's merge keys (:129) in pre-order;
    iterative, :303,432 and one key_prop a leaf (:340)."""
    from mfm_tpu_torch.kernels.nuts import NUTSNoise

    def merges(k, depth):
        if depth == 0:
            return []
        kl, kr, km = jax.random.split(k, 3)
        return [jax.random.uniform(km, (B,))] + merges(kl, depth - 1) + merges(kr, depth - 1)

    if variant == "static":
        key_mom, key_tree = jax.random.split(key)
        keys = jax.random.split(key_tree, 3 * depth)
        dirs = [jax.random.uniform(keys[3 * j], (B,)) for j in range(depth)]
        tree = [u for j in range(depth) for u in merges(keys[3 * j + 1], j)]
        takes = [jax.random.uniform(keys[3 * j + 2], (B,)) for j in range(depth)]
    else:
        key_mom, k = jax.random.split(key)
        dirs, tree, takes = [], [], []
        for j in range(depth):
            k, key_dir, key_sub, key_acc = jax.random.split(k, 4)
            dirs.append(jax.random.uniform(key_dir, (B,)))
            takes.append(jax.random.uniform(key_acc, (B,)))
            for _ in range(1 << j):
                key_sub, key_prop = jax.random.split(key_sub)
                tree.append(jax.random.uniform(key_prop, (B,)))
    stack = lambda us: tt(jnp.stack(us)) if us else torch.zeros((0, B))
    return NUTSNoise(tt(jax.random.normal(key_mom, (B, d))), stack(dirs), stack(tree),
                     stack(takes))


def closure_vars(fn) -> dict:
    """The free variables of a (possibly jitted) closure by name: how a test
    reaches a reference driver's inner functions (``ais_forward`` inside
    ``run_fab``, ``rollout`` inside ``run_dds``) without editing it."""
    fn = getattr(fn, "__wrapped__", fn)
    return dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__ or ())))


class _Captured(Exception):
    pass


def capture_chunked_scan(module, monkeypatch, run, *args, **kwargs):
    """Call ``run(*args, **kwargs)`` (a reference driver of ``module``) up to
    its ``host_chunked_scan`` and return that call's (body, carry, keys)
    instead of running the scan."""
    seen = {}

    def fake(body, carry, keys, chunk=None):
        seen.update(body=body, carry=carry, keys=keys)
        raise _Captured

    monkeypatch.setattr(module, "host_chunked_scan", fake)
    try:
        run(*args, **kwargs)
    except _Captured:
        pass
    monkeypatch.undo()
    return seen["body"], seen["carry"], seen["keys"]


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def flax_from_params(params: dict) -> dict:
    """The flax tree of a ``VectorFieldNet`` from the port's ``{name:
    tensor}`` parameters: the inverse of ``utils.convert.params_from_flax``
    (a ``Dense`` kernel is (in, out), ``nn.Linear.weight`` (out, in))."""
    tree = {}
    for name, v in params.items():
        if name == "fourier_freqs":
            continue
        layer, kind = name.rsplit(".", 1)
        arr = jnp.asarray(npy(v).T if kind == "weight" else npy(v))
        if "." in layer:  # a trunk's layer i
            trunk, i = layer.split(".")
            node = tree.setdefault(trunk, {}).setdefault(f"Dense_{i}", {})
        else:  # a head
            node = tree.setdefault(layer, {})
        node["kernel" if kind == "weight" else "bias"] = arr
    return {"params": tree}


def port_mfm_carry(jcarry) -> MFMCarry:
    """The port's ``MFMCarry`` of a reference ``MFMCarry``: one run's, or a
    seed sweep's with every leaf stacked on a leading seed axis (the
    Welford count, the same for every seed, stays one number)."""
    c, tr = jcarry.chain, jcarry.train
    opt = tr.opt_state
    step = lambda v: tt(np.asarray(v)).to(torch.int32)
    adapt = ()
    if jcarry.da is not None:
        count = int(np.asarray(jcarry.wf.count).reshape(-1)[0])
        adapt = (DualAveragingState(*(tt(v) for v in jcarry.da)),
                 WelfordState(tt(jcarry.wf.mean), tt(jcarry.wf.m2), count),
                 tt(jcarry.inv_mass))
    return MFMCarry(
        ChainState(tt(c.position), tt(c.logdensity), tt(c.logdensity_grad)),
        TrainState(
            step(tr.step),
            params_from_flax(_tree_np(tr.params)),
            AdamWFiniteState(
                step(opt.count), step(opt.notfinite_count),
                params_from_flax(_tree_np(opt.mu)), params_from_flax(_tree_np(opt.nu)),
            ),
        ),
        tt(jcarry.beta),
        *adapt,
    )
