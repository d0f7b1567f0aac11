"""The port's roofline accounting (``mfm_tpu_torch.diagnostics.roofline``)
against the reference's.

On a matrix product the two count the same work exactly: flop_counter's
2mnk against XLA's cost model, and the operands plus the result against
XLA's "bytes accessed" (a (64, 32) @ (32, 16) f32 product: 65,536 flops,
14,336 bytes). On the CPU neither has a ceiling. The kernels' wrappers
report to the open counter; here (no card) a report is made by hand.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfm_tpu.diagnostics import roofline as jroof
from mfm_tpu_torch.diagnostics import roofline as proof

torch.set_num_threads(1)


@pytest.mark.parametrize("m,k,n", [(64, 32, 16), (100, 48, 24)])
def test_matmul_counts_equal_xla(m, k, n):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    ref = jroof.roofline("mm", lambda x, y: x @ y, jnp.asarray(a), jnp.asarray(b))
    got = proof.roofline("mm", lambda x, y: x @ y, torch.from_numpy(a), torch.from_numpy(b))
    assert got.flops == ref.flops == 2 * m * k * n
    assert got.bytes_accessed == ref.bytes_accessed == 4 * (m * k + k * n + m * n)
    assert got._fields == ref._fields
    assert got.pct_peak_flops is None and got.pct_peak_bandwidth is None
    assert got.bound == ref.bound and got.seconds > 0.0


def test_device_peaks_on_cpu():
    assert proof.device_peaks() == jroof.device_peaks() == (None, None)
    assert proof.device_peaks("cpu") == (None, None)
    assert proof.CEILINGS["NVIDIA H100 80GB HBM3"]["bf16"] == 989.4e12
    assert proof.H100["hbm"] == 3.35e12


def test_kernel_reports_add_to_the_aten_counts():
    """What a wrapper reports while a count is open adds to the aten ops'
    counts, by kernel name and launch; outside a count nothing is open,
    and counts do not nest."""
    x = torch.randn(8, 4)

    def fn(v):
        y = v @ v.T  # 2 * 8 * 4 * 8 flops; 4 * (32 + 32 + 64) bytes
        for _ in range(3):
            proof.counter.add_kernel("k", 10.0, 100.0)
        return y

    assert proof.counter is None
    _, costs = proof.count(fn, x)
    assert proof.counter is None
    assert costs.kernels == {"k": proof.KernelCount(3, 30.0, 300.0)}
    assert costs.flops == 512 + 30.0 and costs.bytes == 4 * 128 + 300.0
    with pytest.raises(RuntimeError, match="already open"):
        proof.count(lambda v: proof.count(fn, v), x)
    assert proof.counter is None


def test_views_and_allocations_move_no_bytes():
    x = torch.randn(16, 8)
    fn = lambda v: torch.empty(100).fill_(1.0).sum() + v.T[0, 0] + v.reshape(-1)[3]
    _, costs = proof.count(fn, x)
    # fill_ reads and writes 100 floats, sum reads 100 and writes 1, each
    # add reads two scalars and writes one; the allocation, the transpose,
    # the reshape and the indexing move nothing
    assert costs.aten_flops == 0
    assert costs.aten_bytes == 4 * (200 + 101 + 3 + 3)


def test_counts_see_through_jvp_and_vmap():
    """A transport's tangent field runs under ``torch.func``: its products
    are counted all the same, every stage of every step."""
    from mfm_tpu_torch.flows import make_transport, make_vector_field, module_tangent_field

    net, params = make_vector_field(torch.Generator().manual_seed(0), 3, hidden_x=(8,),
                                    hidden_t=(8,), hidden_xt=(8,), fourier_dim=4, device="cpu")
    u = torch.randn(5, 3)
    one = make_transport(module_tangent_field(net), "exact", n_steps=1, method="euler")
    two = make_transport(module_tangent_field(net), "exact", n_steps=2, method="euler")
    _, c1 = proof.count(one.forward, params, u)
    _, c2 = proof.count(two.forward, params, u)
    assert c1.flops > 0 and c2.flops == 2 * c1.flops
    rep = proof.roofline("transport", two.forward, params, u, repeats=1)
    assert rep.flops == c2.flops and rep.bytes_accessed == c2.bytes
