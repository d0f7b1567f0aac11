"""End-of-run figures (counterpart of ``mfm_tpu.drivers.plots``): pair
scatters with the target's contours, phi-four field overlays and the 2-D
flow progression, returned as matplotlib figures (and saved as PNGs by
``save_figs`` or ``MetricLogger.log_figures``).

matplotlib is imported only when a figure is drawn (``_plt``), with the
Agg backend; nothing else of the port needs it. The progression takes its
reference draw ``u`` or a generator to draw it from.
"""

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from mfm_tpu_torch.flows.cnf import draw_probe


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def contour_grid(log_prob_fn: Callable, lim, grid_width: int = 400, device="cpu"):
    """(xx, yy, values) on the host: the target's log-density on a
    ``grid_width`` square grid over ``lim``, floored at -1000."""
    grid = torch.linspace(lim[0], lim[1], grid_width, device=device)
    xx, yy = torch.meshgrid(grid, grid, indexing="ij")
    pts = torch.stack([xx.ravel(), yy.ravel()], dim=1)
    vals = torch.clamp(log_prob_fn(pts), min=-1000.0).reshape(grid_width, grid_width)
    return _host(xx), _host(yy), _host(vals)


def plot_contours(ax_list, log_prob_fn: Callable, lim, grid_width: int = 400, levels: int = 50,
                  device="cpu"):
    """Overlay the target's log-density contours on 2-D axes; the grid is
    evaluated on ``device``, the target's."""
    xx, yy, vals = contour_grid(log_prob_fn, lim, grid_width, device)
    for ax in ax_list:
        ax.contour(xx, yy, vals, levels=levels)


def pair_scatter(
    flow_samples,
    exact_samples,
    lim=None,
    log_prob_fn: Optional[Callable] = None,
    max_dims: int = 10,
    grid_width: int = 400,
    levels: int = 50,
    device="cpu",
):
    """One figure per (x0, x_i) pair, the flow's and the IS-corrected
    samples side by side. Returns the figures."""
    plt = _plt()
    flow_samples = _host(flow_samples)
    exact_samples = _host(exact_samples)
    dim = flow_samples.shape[1]
    figs = []
    for i in range(min(dim - 1, max_dims)):
        fig, ax = plt.subplots(1, 2, figsize=(11, 4))
        ax[1].set_title(r"$\hat{\pi}$ (flow)")
        ax[0].set_title(r"$\pi$ (IS-corrected)")
        ax[1].plot(flow_samples[:, 0], flow_samples[:, i + 1], ".", alpha=0.2)
        ax[0].plot(exact_samples[:, 0], exact_samples[:, i + 1], ".", alpha=0.2)
        if lim is not None:
            plt.setp(ax, xlim=lim, ylim=lim)
        if dim == 2 and log_prob_fn is not None and lim is not None:
            plot_contours(ax, log_prob_fn, lim, grid_width, levels, device)
        figs.append(fig)
    return figs


def phi_four_fields(flow_samples, exact_samples, lim=(-1.6, 1.6)):
    """Lattice field overlays, each row padded with its zero boundary."""
    plt = _plt()
    fig, ax = plt.subplots(1, 2, figsize=(11, 4), sharex=True, sharey=True)
    for axis, samples, title in (
        (ax[0], exact_samples, r"$\pi$"),
        (ax[1], flow_samples, r"$\hat{\pi}$"),
    ):
        padded = np.pad(_host(samples), ((0, 0), (1, 1)))
        for row in padded:
            axis.plot(row, color="red", alpha=0.1)
        axis.set_title(title)
        axis.set_xlabel(r"$d$")
        axis.set_ylabel(r"$\phi$")
    plt.setp(ax, xlim=[0, padded.shape[1] - 1], ylim=list(lim))
    return fig


def flow_progression(
    transport,
    params,
    u: torch.Tensor,
    save_ts: Sequence[float] = (0.0, 0.25, 0.5, 0.75, 1.0),
    probe: Optional[torch.Tensor] = None,
):
    """The forward transport of ``u`` at the times ``save_ts``, one panel
    each (the 4-mode progression); ``probe`` for a Hutchinson transport."""
    plt = _plt()
    traj = _host(transport.forward_traj(params, u, list(save_ts), probe))
    n_col = traj.shape[0]
    fig, ax = plt.subplots(1, n_col, figsize=(5 * n_col, 3))
    for i in range(n_col):
        ax[i].plot(traj[i, :, 0], traj[i, :, 1], ".", alpha=0.2)
        ax[i].set_title(f"t={save_ts[i]:.2f}")
    return fig


def save_figs(figs, prefix: str):
    """Save a figure or a list of them as ``<prefix>_<i>.png``; returns the
    paths."""
    paths = []
    for i, fig in enumerate(figs if isinstance(figs, (list, tuple)) else [figs]):
        path = f"{prefix}_{i}.png"
        fig.savefig(path, dpi=120, bbox_inches="tight")
        paths.append(path)
    return paths


def make_run_figures(target, cfg, flow_samples, exact_samples, run=None, noise=None,
                     max_scatter: int = 2048):
    """The end-of-run figure set, by name:

    - ``pairs``: the (x0, x_i) scatters of the flow's and the IS-corrected
      samples, the first 10 dimensions, with contours in 2-D;
    - ``fields``: the phi-four field overlay (phi-four only);
    - ``progression``: the forward transport at 5 times (2-D targets with a
      trained MFM run ``run``).

    The scatters take at most ``max_scatter`` points. ``noise`` is the
    progression's reference draw ``u`` (a tensor), or a generator to draw
    it (and a Hutchinson transport's probe) from; default a generator
    seeded 0 on the samples' device."""
    figs = {}
    device = flow_samples.device
    fs = flow_samples[:max_scatter]
    es = exact_samples[:max_scatter]
    log_prob = target.log_prob if target.dim == 2 else None
    figs["pairs"] = pair_scatter(
        fs, es, lim=cfg.lim, log_prob_fn=log_prob, grid_width=cfg.grid_width,
        levels=cfg.levels, device=device,
    )
    if cfg.example == "phi-four":
        figs["fields"] = phi_four_fields(fs[:100], es[:100])
    if target.dim == 2 and run is not None:
        probe = None
        if isinstance(noise, torch.Tensor):
            u = noise
        else:
            gen = noise if noise is not None else torch.Generator(device).manual_seed(0)
            u = run.ref_dist.sample(gen, (min(1024, fs.shape[0]),))
            probe = draw_probe(run.transport, gen, *u.shape)
        figs["progression"] = flow_progression(run.transport, run.train.params, u, probe=probe)
    return figs
