"""The distributed SMC resampler and the ring gather
(``mfm_tpu_torch.smc.distributed``) and a sharded ``run_smc`` on the CPU,
as 2 and as 4 gloo processes, against the reference's
``mfm_tpu.smc.distributed`` on the virtual CPU mesh and against one
process.

One module-scoped fixture a world size starts the ranks once
(``torch_mesh_worker.start_workers``). The uniforms come from the
reference's keys and are injected.

- float64: the distributed ancestors equal the reference's distributed
  ones and both single-device resamplers' bit for bit, systematic and
  stratified (``tests/test_dist_resample.py``'s exactness);
- float32: each ancestor that differs from the single-device one is an
  off-by-one at a tie (its grid point within 1e-6, the float32 cumsum's
  drift, of the cumulative weight between the two), on fewer than 1 % of
  the slots (``mfm_tpu/smc/distributed.py:38-46``);
- the ring gather equals ``particles[ancestors]`` exactly;
- ``run_smc`` on a float64 target, sharded against one process: MALA with
  the systematic resampler gives the same log Z, lambda and harvest bit
  for bit (every global quantity comes from gathered rows); waste-free
  HMC, whose mass is the particle variance (two all-reduces, another
  summation order), and the multinomial resampler on gathered weights
  agree to 1e-12 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_worker as w
from mfm_tpu.parallel import make_mesh as j_make_mesh
from mfm_tpu.smc.distributed import distributed_stratified as j_dist_stratified
from mfm_tpu.smc.distributed import distributed_systematic as j_dist_systematic
from mfm_tpu.smc.resampling import stratified as j_stratified
from mfm_tpu.smc.resampling import systematic as j_systematic
from mfm_tpu_torch.smc import resampling

torch.set_num_threads(1)

N = 1 << 12
KEY = jax.random.PRNGKey(11)


def _weights(key, dtype):
    wts = jax.random.uniform(key, (N,), dtype=dtype) ** 3
    return wts / wts.sum()


@pytest.fixture(scope="module")
def inputs():
    with jax.enable_x64(True):
        w64 = np.asarray(_weights(jax.random.fold_in(KEY, 1), jnp.float64))
        u64 = {"systematic": np.array(jax.random.uniform(KEY, (), jnp.float64)),
               "stratified": np.array(jax.random.uniform(KEY, (N,), jnp.float64))}
    w32 = np.asarray(_weights(jax.random.fold_in(KEY, 2), jnp.float32))
    u32 = {"systematic": np.asarray(jax.random.uniform(KEY, ())),
           "stratified": np.asarray(jax.random.uniform(KEY, (N,)))}
    particles = np.random.default_rng(3).standard_normal((N, 3))
    ancestors = np.asarray(j_systematic(KEY, jnp.asarray(w32), N))
    return {
        "w_f64": torch.from_numpy(np.array(w64)), "w_f32": torch.from_numpy(np.array(w32)),
        "num_samples": N,
        **{f"u_{k}_f64": torch.from_numpy(v) for k, v in u64.items()},
        **{f"u_{k}_f32": torch.from_numpy(np.array(v)) for k, v in u32.items()},
        "take_particles": torch.from_numpy(particles),
        "take_ancestors": torch.from_numpy(ancestors.astype(np.int64)),
    }


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    return w.start_workers("smc", inputs, (2, 4), str(tmp_path_factory.mktemp("smc")))


@pytest.fixture(scope="module")
def one_process(inputs):
    return w.case_run_smc(inputs, None)


def _reference(name, world, dtype):
    """(the reference's single-device ancestors, its distributed ones)."""
    single, dist = {"systematic": (j_systematic, j_dist_systematic),
                    "stratified": (j_stratified, j_dist_stratified)}[name]
    mesh = j_make_mesh((world,), ("chains",), jax.devices()[:world])
    with jax.enable_x64(dtype == "f64"):
        jdtype = jnp.float64 if dtype == "f64" else jnp.float32
        wts = _weights(jax.random.fold_in(KEY, 1 if dtype == "f64" else 2), jdtype)
        ref = np.asarray(single(KEY, wts, N))
        got = np.asarray(jax.jit(lambda k, v: dist(k, v, N, mesh))(KEY, wts))
    return ref, got


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["systematic", "stratified"])
def test_float64_ancestors_are_exact(ranks, inputs, name, world):
    ref, jdist = _reference(name, world, "f64")
    port_single = resampling.get_resampler(name)(inputs[f"u_{name}_f64"], inputs["w_f64"], N)
    np.testing.assert_array_equal(port_single.numpy(), ref)
    np.testing.assert_array_equal(jdist, ref)
    for r in ranks[world]:
        np.testing.assert_array_equal(r["case_resample"][f"{name}_f64"].numpy(), ref)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["systematic", "stratified"])
def test_float32_ancestors_differ_only_at_ulp_ties(ranks, inputs, name, world):
    ref, _ = _reference(name, world, "f32")
    got = ranks[world][0]["case_resample"][f"{name}_f32"].numpy()
    assert all(np.array_equal(r["case_resample"][f"{name}_f32"].numpy(), got)
               for r in ranks[world])
    diff = got != ref
    assert diff.mean() < 0.01, f"{diff.sum()} of {N} slots differ"
    assert (np.abs(got[diff] - ref[diff]) <= 1).all()
    cum = np.cumsum(inputs["w_f32"].numpy().astype(np.float64))
    grid = (np.arange(N) + inputs[f"u_{name}_f32"].numpy().astype(np.float64)) / N
    tie = np.abs(grid[diff] - cum[np.minimum(got, ref)[diff]])
    assert tie.max(initial=0.0) < 1e-6  # a grid point at a cumulative weight, within f32 drift


@pytest.mark.parametrize("world", [2, 4])
def test_ring_gather_is_exact_and_sizes_are_refused(ranks, inputs, world):
    want = inputs["take_particles"][inputs["take_ancestors"]]
    for r in ranks[world]:
        assert torch.equal(r["case_resample"]["take"], want)
        assert "must divide the mesh's shard count" in r["case_resample"]["refused"]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", list(w.SMC_CASES))
def test_sharded_run_smc_matches_one_process(ranks, one_process, case, world):
    one = one_process[case]
    results = [r["case_run_smc"][case] for r in ranks[world]]
    for r in results[1:]:
        assert all(torch.equal(r[k], results[0][k]) for k in r)
    got = results[0]
    assert got["log_z"].dtype == torch.float64 and 0 < float(one["lmbda"]) <= 1
    if case == "mala":
        for k in ("log_z", "lmbda", "particles"):
            assert torch.equal(got[k], one[k]), k
    else:
        for k in ("log_z", "lmbda", "particles"):
            np.testing.assert_allclose(got[k].numpy(), one[k].numpy(), rtol=1e-12, atol=1e-12,
                                       err_msg=k)
