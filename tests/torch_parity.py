"""Helpers shared by the port's parity tests (tests/test_torch_*.py): the
same inputs, made with numpy or by JAX, go through ``mfm_tpu`` and its
counterpart in ``mfm_tpu_torch``; arrays cross as numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mfm_tpu.flows.vector_field import NON_LINEARITIES, VectorFieldNet as FlaxNet
from mfm_tpu_torch.flows import VectorFieldNet, field_params
from mfm_tpu_torch.utils.convert import params_from_flax


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
