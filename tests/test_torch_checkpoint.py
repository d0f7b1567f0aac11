"""Checkpoint and resume of the port's ``run_mfm`` (``utils.checkpoint``,
the counterpart of ``mfm_tpu.utils.checkpoint`` and of the resume in
``mfm_tpu/drivers/mfm.py:462-517``), on the CPU at a small size (phi-four,
d=4, 16 chains, 16-wide trunks, 3 RK4 steps, 12 iterations in chunks of 4,
a checkpoint every chunk).

A run resumed from its checkpoint at 4 or 8 ends with the uninterrupted
run's bits: the checkpoint holds the carry and the noise generator's
state, which fix the rest of the run. A run started at a finished
checkpoint returns empty metrics and the checkpoint's state, as the
reference's does (``tests/test_mfm_e2e.py:298``).
"""

import shutil

import pytest
import torch

import mfm_tpu_torch.targets as pt
from mfm_tpu_torch.config import MFMConfig
from mfm_tpu_torch.drivers import run_mfm
from mfm_tpu_torch.utils.checkpoint import latest_step, restore_checkpoint, save_checkpoint

torch.set_num_threads(1)

D, B = 4, 16
CFG = dict(
    example="phi-four", dim=D, num_chain=B, hidden_x=(16, 16), hidden_t=(16, 16),
    hidden_xt=(16, 16), fourier_dim=8, ode_steps=3, mcmc_per_flow_steps=3.0,
    learning_iter=12, chunk_size=4, step_size=1e-3, field_precision="highest",
    checkpoint_every_chunks=1,
)


def _same_bits(a, b):
    assert torch.equal(a.chain.position, b.chain.position)
    assert torch.equal(a.chain.logdensity, b.chain.logdensity)
    assert torch.equal(a.beta, b.beta)
    for k, v in a.train.params.items():
        assert torch.equal(v, b.train.params[k]), k
        assert torch.equal(a.train.opt_state.nu[k], b.train.opt_state.nu[k]), k
    assert torch.equal(a.train.step, b.train.step)


@pytest.mark.parametrize("overrides,resume_at", [
    ({"pallas_field": True}, 8),
    ({"pallas_field": False}, 4),
    ({"mcmc_kernel": "hmc", "mass_refresh_every": 3, "hmc_num_integration_steps": 3}, 8),
], ids=["kernel-8", "module-4", "hmc-adapt-8"])
def test_resumed_run_has_the_uninterrupted_bits(tmp_path, overrides, resume_at):
    target = pt.PhiFour(D)
    whole = run_mfm(target, MFMConfig(**CFG, **overrides), "cpu")
    ckpt = tmp_path / "ckpt"
    cfg = MFMConfig(**CFG, **overrides, checkpoint_dir=str(ckpt))
    first = run_mfm(target, cfg, "cpu")
    assert latest_step(str(ckpt)) == 12
    _same_bits(first, whole)
    for step in range(resume_at + 4, 13, 4):  # the run stopped after resume_at
        shutil.rmtree(ckpt / f"step_{step:08d}")
    assert latest_step(str(ckpt)) == resume_at
    resumed = run_mfm(target, cfg, "cpu")
    _same_bits(resumed, whole)
    for k, v in resumed.metrics.items():  # only the iterations it ran
        assert torch.equal(v, whole.metrics[k][resume_at:]), k
    assert latest_step(str(ckpt)) == 12

    # a rerun at the finished checkpoint runs nothing and returns its state
    again = run_mfm(target, cfg, "cpu")
    assert again.metrics == {}
    _same_bits(again, whole)


def test_checkpoint_round_trip(tmp_path):
    """Any tree of tensors, ints and Nones comes back with its structure (from
    the template), bits and dtypes; a missing directory restores nothing."""
    from mfm_tpu_torch.adaptation.window import WelfordState

    state = ({"a": torch.arange(5, dtype=torch.int32), "b": None},
             WelfordState(torch.randn(3), torch.rand(3), 7),
             [torch.Generator().manual_seed(3).get_state()])
    save_checkpoint(str(tmp_path), 5, state)
    save_checkpoint(str(tmp_path), 40, state)
    template = ({"a": torch.zeros(5, dtype=torch.int32), "b": None},
                WelfordState(torch.zeros(3), torch.zeros(3), 0), [torch.zeros(1, dtype=torch.uint8)])
    got, step = restore_checkpoint(str(tmp_path), template=template)
    assert step == 40 and got[1].count == 7 and got[0]["b"] is None
    assert isinstance(got[1], WelfordState)
    assert torch.equal(got[0]["a"], state[0]["a"]) and got[0]["a"].dtype == torch.int32
    assert torch.equal(got[1].mean, state[1].mean) and torch.equal(got[2][0], state[2][0])
    assert restore_checkpoint(str(tmp_path / "none")) == (None, None)
    with pytest.raises(ValueError, match="leaves"):
        restore_checkpoint(str(tmp_path), 5, template=(template[0],))
