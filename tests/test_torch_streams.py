"""No two of a seeded run's random streams share a draw.

The reference splits ``PRNGKey(seed)`` into independent keys for the net,
the initial positions and the loop, and folds in 7, 999 and 1000 for the
probe, the eval and the exact samples. The port gives each of these a
generator of its own, a named stream of ``make_generator``'s scheme; the
net's weights come from ``init_generator(seed)``, which once was
``manual_seed(seed)``, the very seed of stream 0 at seed 0 on the CPU (so
that many-well's first initial positions were its Fourier frequencies).

Each case runs a path the way a user runs it, at a tiny size on the CPU,
with every generator it makes recorded: the CLI's single-seed MFM run
(init, initial positions and step noise, warm-up, probe, eval, exact
samples), the seed sweep (``run_mfm_seeds``, the CLI's ``--vmap-seeds``),
and the baselines FAB, flowMC and DDS. No two of its generators may start
with the same draws, and its numbers must not depend on the global generator.
"""

import pytest
import torch

from mfm_tpu_torch import cli, config
from mfm_tpu_torch.drivers import mfm
from mfm_tpu_torch.drivers.multi_seed import run_mfm_seeds
from torch_parity import cli_run_dir  # noqa: F401

TINY = ["--device", "cpu", "--learning-iter", "4", "--num-chain", "8", "--ode-steps", "2",
        "--set", "hidden_x=(8,)", "--set", "hidden_t=(8,)", "--set", "hidden_xt=(8,)",
        "--set", "fourier_dim=4", "--set", "eval_iter=2"]
PATHS = {  # name: (CLI arguments, the streams the path must draw from)
    "run_mfm": (["--example", "many-well"],
                {"init", "step", "warm", "probe", "eval", "real"}),
    "run_mfm_seeds": (["--example", "many-well", "--vmap-seeds"],
                      {"init", "step", "warm", "eval", "real"}),
    "fab": (["--example", "4-mode", "--do-fab"], {"init", "step", "warm", "eval", "real"}),
    "flowmc": (["--example", "4-mode", "--do-flowmc"], {"init", "step", "warm", "eval", "real"}),
    "dds": (["--example", "4-mode", "--do-dds"], {"init", "step", "warm", "eval", "real"}),
}
STREAMS = {"step": mfm.STEP_STREAM, "warm": mfm.WARM_STREAM, "init": mfm.INIT_STREAM,
           "probe": mfm.PROBE_STREAM, "eval": mfm.EVAL_STREAM, "real": mfm.REAL_STREAM}


class Recorded(torch.Generator):
    """A generator that notes every seed it is given."""

    seeds = []

    def manual_seed(self, seed):
        Recorded.seeds.append((str(self.device), int(seed)))
        return super().manual_seed(seed)


@pytest.fixture
def recorded(monkeypatch):
    Recorded.seeds = []
    monkeypatch.setattr(torch, "Generator", Recorded)
    return Recorded.seeds


def first_draws(seed: int) -> torch.Tensor:
    return torch.rand(64, generator=torch._C.Generator().manual_seed(seed))


def test_streams_are_named_apart():
    """The named streams are distinct numbers of one scheme, each far from
    the next seed's."""
    assert len(set(STREAMS.values())) == len(STREAMS)
    assert max(STREAMS.values()) < 1_000_003
    assert mfm.init_generator(5).initial_seed() == 5 * 1_000_003 + mfm.INIT_STREAM


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("path", list(PATHS))
def test_no_two_streams_of_a_run_share_a_draw(path, seed, recorded):
    argv, streams = PATHS[path]
    rows = []
    for global_seed in (1, 2):  # the run's numbers owe nothing to the global generator
        torch.manual_seed(global_seed)
        out = cli.main([*argv, *TINY, "--seed", str(seed)])
        rows.append(repr([{k: v for k, v in m.items() if "time" not in k and k != "it_per_s"}
                          for m in out]))
    assert rows[0] == rows[1]
    seeds = [s for _, s in recorded][: len(recorded) // 2]
    assert all(dev == "cpu" for dev, _ in recorded)
    named = {name: seed * 1_000_003 + k for name, k in STREAMS.items()}
    assert {name for name, s in named.items() if s in seeds} == streams
    assert set(seeds) <= set(named.values()), f"a generator off the named streams: {seeds}"
    distinct = sorted(set(seeds))
    draws = [first_draws(s) for s in distinct]
    for i in range(len(draws)):
        for j in range(i + 1, len(draws)):
            assert not torch.equal(draws[i], draws[j]), (distinct[i], distinct[j])


def test_seed_zero_positions_are_not_the_fourier_frequencies():
    """At seed 0 on the CPU the initial positions share no value with the
    net's Fourier frequencies (they were the same 128 draws)."""
    cfg = config.preset("many-well", seed=0)
    target = cli.make_target("many-well", "cpu")
    pieces = mfm.build_mfm(target, cfg, "cpu", mfm.init_generator(0))
    positions = target.init_positions(mfm.make_generator("cpu", 0), cfg.num_chain)
    assert not torch.isin(pieces.fourier, positions).any()


def test_a_sweep_gives_each_seed_its_own_streams(recorded):
    """Three seeds as one sweep: every generator of every seed distinct."""
    cfg = config.preset("many-well", learning_iter=3, num_chain=4, hidden_x=(4,),
                        hidden_t=(4,), hidden_xt=(4,), fourier_dim=4, ode_steps=2)
    run_mfm_seeds(cli.make_target("many-well", "cpu"), cfg, [0, 1, 2], "cpu")
    seeds = [s for _, s in recorded]
    want = {s * 1_000_003 + STREAMS[k] for s in (0, 1, 2) for k in ("init", "step", "warm")}
    assert sorted(seeds) == sorted(want)
