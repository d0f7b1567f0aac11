"""Inputs the benchmark makes from the seed, on the device, and hands to
the program and to the reference alike: generators, the field's weights
and Fourier frequencies for S nets, and the configuration as the program
takes it.

The weights' law is the configuration's ``weights`` entry: every Dense
weight normal with standard deviation gain / sqrt(fan in) and every bias
with gain * ``bias_std`` (gain 1 in the trunks, the heads' gains given), the
frequencies ``fourier_std`` N(0, 1). No parameter is zero: zero heads, as
the program initialises them, make the transport the identity, which no
comparison could tell from a broken field.
"""

import torch

STREAMS = {"weights": 1, "positions": 2, "feed": 3, "real": 4}


def generator(device, seed: int, stream: str) -> torch.Generator:
    """One named stream of the run's seed (any integer, large ones too)."""
    mixed = (seed * 1_000_003 + STREAMS[stream] * 7_919) % (2**63 - 1)
    return torch.Generator(device=device).manual_seed(mixed)


def field_shapes(conf: dict) -> dict:
    """name -> shape of the field's parameters, as the program names them."""
    d, F = conf["dim"], conf["fourier_dim"]
    shapes = {}

    def trunk(name, fan_in, widths):
        for i, w in enumerate(widths):
            shapes[f"{name}.{i}.weight"], shapes[f"{name}.{i}.bias"] = (w, fan_in), (w,)
            fan_in = w
        return fan_in

    ht = trunk("t_trunk", 2 * F, conf["hidden_t"])
    hx = trunk("x_trunk", d, conf["hidden_x"])
    hxt = trunk("xt_trunk", hx + ht, conf["hidden_xt"])
    shapes["gate_head.weight"], shapes["gate_head.bias"] = (d, ht), (d,)
    shapes["field_head.weight"], shapes["field_head.bias"] = (d, hxt), (d,)
    return shapes


def make_field(conf: dict, S: int, gen: torch.Generator):
    """(params {name: (S, ...)}, freqs (S, F)) from one normal draw."""
    law = conf["weights"]
    shapes = field_shapes(conf)
    sizes = [torch.Size(s).numel() for s in shapes.values()]
    F = conf["fourier_dim"]
    flat = torch.randn((S, sum(sizes) + F), generator=gen, device=gen.device)
    params, at = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        v = flat[:, at:at + n].reshape((S,) + shape)
        at += n
        gain = law.get(name.split(".")[0] + "_gain", 1.0)
        if name.endswith("bias"):
            v = (gain * law["bias_std"]) * v
        else:
            v = (gain / shape[1] ** 0.5) * v
        params[name] = v.contiguous()
    freqs = (conf["fourier_std"] * flat[:, at:]).contiguous()
    return params, freqs


def program_config(conf: dict):
    """The program's ``MFMConfig``: its preset, then every entry of the
    configuration file's ``config``."""
    from mfm_tpu_torch.config import preset

    fields = {k: tuple(v) if isinstance(v, list) else v for k, v in conf["config"].items()}
    return preset(conf["preset"], **fields)


def flat_conf(conf: dict) -> dict:
    """The configuration's sizes and weight law in one dict."""
    return {**conf["config"], "weights": conf["weights"]}
