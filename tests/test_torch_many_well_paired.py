"""``tools/many_well_paired.py``, the paired study of many-well's NaN rows:
its exact McNemar p and Wilson interval against scipy, phase 52's
false-failure rate against a direct sum over scipy's binomial and Fisher
tests, the two step-noise arms (the port's own draws, then the reference's
loop keys, then the port's again), the initial positions of each
``--init`` (the reference's against JAX's), a tiny dry run on the CPU that records all four cells of
every seed and summarises them, and ``chip_smoke.py``'s gate of phase 52
against the committed study on the card."""

import importlib.util
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from scipy import stats

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))

import many_well_nonfinite as nf  # noqa: E402
import many_well_paired as mp  # noqa: E402
from mfm_tpu_torch import cli, config  # noqa: E402
from mfm_tpu_torch.drivers import mfm, multi_seed  # noqa: E402
from mfm_tpu_torch.drivers.mfm import init_generator, make_generator  # noqa: E402

TINY = ["--set", "num_chain=8", "--set", "eval_iter=4"]
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def port_draws():
    """Every test leaves ``build_mfm`` as the port's own."""
    yield
    multi_seed.build_mfm = mfm.build_mfm = mp.PORT_BUILD


@pytest.mark.parametrize("b, c", [(0, 0), (0, 1), (3, 9), (51, 33), (127, 83), (40, 40),
                                  (0, 25), (210, 150)])
def test_mcnemar_is_scipys_binomial_test(b, c):
    want = 1.0 if b + c == 0 else stats.binomtest(b, b + c, 0.5).pvalue
    assert mp.mcnemar_exact(b, c) == pytest.approx(want, rel=1e-9, abs=1e-15)
    assert mp.mcnemar_exact(b, c) == mp.mcnemar_exact(c, b)


@pytest.mark.parametrize("k, n", [(0, 20), (7, 20), (206, 400), (485, 1000), (1000, 1000)])
def test_wilson_is_scipys(k, n):
    ci = stats.binomtest(k, n).proportion_ci(0.95, method="wilson")
    np.testing.assert_allclose(mp.wilson(k, n), (ci.low, ci.high), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("share, limit", [(0.45, 0.01), (0.5, 0.001), (0.41, 0.05)])
def test_false_failure_rate_is_the_binomial_sum(share, limit):
    n, ref_bad, ref_n = 60, 85, 209
    want = sum(stats.binom.pmf(x, n, share) for x in range(n + 1)
               if stats.fisher_exact([[x, n - x], [ref_bad, ref_n - ref_bad]])[1] < limit)
    assert mp.false_failure_rate(share, n, ref_bad, ref_n, limit) == pytest.approx(want, rel=1e-6)


def test_the_arms_draw_the_port_then_the_references_step_noise():
    """Arm R replays ``PRNGKey(seed)``'s loop keys for every seed of the
    sweep; arm P, after it, draws from the port's generators again."""
    cfg = config.preset("many-well", learning_iter=3, num_chain=8)
    seeds = [2000, 2001]
    target = cli.make_target("many-well", "cpu")

    def draws():
        pieces = multi_seed.build_mfm(target, cfg, "cpu", [init_generator(s) for s in seeds])
        gens = [make_generator("cpu", s) for s in seeds]
        return [pieces.draw_step_noise(gens, count) for count in (1, 2, 3)]

    mp.use_draws("P", "port", cfg, "cpu", seeds)
    port = draws()
    mp.use_draws("R", "port", cfg, "cpu", seeds)
    ref = draws()
    replay = [nf.reference_noise(s, cfg, "cpu") for s in seeds]
    for count, (move, fm) in enumerate(ref, 1):
        for i, draw in enumerate(replay):
            want_move, want_fm = draw(count)
            torch.testing.assert_close(move[0][i * 8:(i + 1) * 8], want_move[0], rtol=0, atol=0)
            torch.testing.assert_close(fm.eps[i], want_fm.eps, rtol=0, atol=0)
    assert not torch.equal(port[0][1].eps, ref[0][1].eps)
    mp.use_draws("P", "port", cfg, "cpu", seeds)
    for (move, fm), (want_move, want_fm) in zip(draws(), port):
        torch.testing.assert_close(fm.eps, want_fm.eps, rtol=0, atol=0)
        torch.testing.assert_close(move[0], want_move[0], rtol=0, atol=0)


def test_paired_dry_run_records_all_four_cells(tmp_path, capsys):
    out = tmp_path / "study.jsonl"
    torch.set_num_threads(1)
    mp.main(["--device", "cpu", "--learning-iter", "4", "--seeds", "0-2", *TINY,
             "--out", str(out)])
    lines = [json.loads(t) for t in out.read_text().splitlines()]
    assert sorted((ln["seed"], ln["noise"]) for ln in lines) == [
        (s, a) for s in range(3) for a in "PR"]
    for ln in lines:
        assert ln["learning_iter"] == 4 and set(ln["latents"]) == {"P", "R"}
        for rec in ln["latents"].values():
            assert rec["flow_row_finite"] == (rec["nonfinite_samples"] == 0)
            assert len(rec["nonfinite_max_abs_u"]) == rec["nonfinite_samples"]
            assert all(0 < u <= rec["max_abs_u"] for u in rec["nonfinite_max_abs_u"])
    # the reference's latents are the same draws in both arms
    by = {(ln["seed"], ln["noise"]): ln["latents"]["R"]["max_abs_u"] for ln in lines}
    assert all(by[(s, "P")] == by[(s, "R")] for s in range(3))
    capsys.readouterr()
    mp.main(["--summary", str(out)])
    table = json.loads(capsys.readouterr().out)
    assert table["seeds"] == 3 and set(table["shares"]) == set(mp.CELLS)
    for cell in mp.CELLS:
        k = sum(not ln["latents"][cell[1]]["flow_row_finite"] for ln in lines
                if ln["noise"] == cell[0])
        assert table["shares"][cell]["nan_seeds"] == k
    pairs = [r["pair"] for f in ("latent_effect", "noise_effect") for r in table[f]["pairs"]]
    assert pairs == ["PP-PR", "RP-RR", "PP-RP", "PR-RR"]
    assert table["reference"] == list(mp.reference_pool())


@pytest.mark.parametrize("init", ["reference", "cpu"])
def test_the_initial_positions_of_each_init(init):
    """``--init reference``: ``run_mfm``'s ``init_positions(key_pos, B)``;
    ``--init cpu``: a CPU generator's draws of the step stream."""
    cfg = config.preset("many-well", learning_iter=3, num_chain=8)
    seeds = [2000, 2001]
    target = cli.make_target("many-well", "cpu")
    mp.use_draws("R", init, cfg, "cpu", seeds)
    pieces = multi_seed.build_mfm(target, cfg, "cpu", [init_generator(s) for s in seeds])
    carry = pieces.init_fn(torch.zeros(16, cfg.dim))
    want = [target.init_positions(make_generator("cpu", s), 8) for s in seeds]
    if init == "reference":
        key_pos = [jax.random.split(jax.random.PRNGKey(s), 3)[1] for s in seeds]
        want = [torch.from_numpy(np.asarray(jax.random.normal(k, (8, cfg.dim)))) for k in key_pos]
    torch.testing.assert_close(carry.chain.position, torch.cat(want), rtol=0, atol=5e-7)


def test_phase_52_gate_is_the_studys():
    """``chip_smoke.py`` gates phase 52 at the limit ``choose_limit`` picks
    for the port's share in the committed study (cell PP) against the
    committed reference pool."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    table = mp.summary([ROOT / "tools" / "many_well_paired_h100.jsonl"])
    assert table["seeds"] == 1000
    assert smoke.MANY_WELL_GATED
    assert smoke.MANY_WELL_PORT_SHARE == table["shares"]["PP"]["share"]
    assert smoke.MANY_WELL_P_LIMIT == mp.choose_limit(
        smoke.MANY_WELL_PORT_SHARE, len(smoke.MANY_WELL_SEEDS), *mp.reference_pool())
    assert not (table["latent_effect"]["law_difference"] or table["noise_effect"]["law_difference"])


def test_choose_limit_takes_the_largest_that_holds():
    # a share at the pool's: 0.01 holds; far above it: none holds, the floor
    assert mp.choose_limit(88 / 209, 60, 88, 209) == 0.01
    assert mp.choose_limit(0.7, 60, 88, 209) == mp.LIMITS[-1]
    for share in (0.5, 0.53):
        lim = mp.choose_limit(share, 60, 88, 209)
        ok = [mp.false_failure_rate(share, 60, 88, 209, x) < mp.FALSE_FAILURE for x in mp.LIMITS]
        assert lim == (mp.LIMITS[ok.index(True)] if any(ok) else mp.LIMITS[-1])
