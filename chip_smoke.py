#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (mfm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA card

Phases, all of them in every run, each printing one line (or more) of its
own; any failure exits non-zero before the final line:

1. the card (nvidia-smi name and power limit), torch and nvcc versions;
2. build of the CUDA kernels from mfm_tpu_torch/csrc (nvcc, sm_90a);
3. each kernel against its plain PyTorch version at the slice's shapes:
   K1 primal and with K=64 tangents (B=1024, d=64, widths 128, F=128,
   relu, every parameter perturbed so the heads are non-zero), K2a at
   (1024, 64) and (12800, 2), K2b at (12800, 2), K3 (value and score) at
   (1024, 64) Dirichlet, (1024, 64) periodic and (37, 64) with the ends at
   0.5; errors and CUDA-event times of kernel and plain version, and each
   kernel's bound (the larger of its operations over the card's peak rate
   and its bytes over the memory rate); K1's achieved TFLOP/s and its share
   of the fp32 FMA bound and of the 3xTF32 tensor-core bound;
4. one forward + inverse transport through the kernel against the same
   transport through the nn.Module (torch.func.jvp), B=1024, d=64, with the
   phi-four score gate: x, u and logdet; the K3-backed score's tangent over
   the 64 basis vectors against jvp(grad(...)) of an autodiff stencil that
   shares no code with it, B=1024, d=64, with both times; then, with a
   large gate, the kernel path's divergence against the trace of the
   autograd Jacobian of the whole field (score gate included), B=16, d=64;
5. the phi-four preset as shipped, through mfm_tpu_torch.cli.main (d=64,
   1024 chains, 128-wide trunks, the bf16 field, exact divergence, 24 RK4
   steps, PhiFour on K3, 500 iterations), with the ESS of the final IS
   weights;
6. the same with the 'phifour' reference (--ref-dist phifour), 100
   iterations;
7. the same with the fused fp32 field (field_precision=highest,
   pallas_field=true), 300 iterations;
8. a 4-mode run through the same entry point (reaches the MMD kernel).

The launch counters are zeroed just before phase 5 and read after phase 8:
every kernel must have been launched by the main path. The line before
last is the kernel summary as JSON; the last line is
{"ok": true, "device": {...}}. Without a CUDA device, or without the
package beside this file, it exits non-zero and prints no result.
"""

import json
import math
import shutil
import subprocess
import sys
import time


# NVIDIA H100 SXM data sheet: fp32 outside the tensor cores, TF32 in them
# (dense), HBM3. Every bound below is the larger of operations / peak and
# bytes / memory rate, for this run's shapes.
FP32_PEAK = 67e12
TF32_PEAK = 495e12
HBM_RATE = 3.35e12


def bound(flops, nbytes, peak=FP32_PEAK):
    """(bound_ms, bound_by) of ``flops`` operations moving ``nbytes``."""
    ops_ms, bytes_ms = flops / peak * 1e3, nbytes / HBM_RATE * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    sys.exit(1)


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean CUDA-event time of ``fn`` over ``reps`` launches, after a warm
    call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def errors(torch, got, ref):
    got, ref = got.double(), ref.double()
    abs_err = float(torch.max(torch.abs(got - ref)))
    rel_err = abs_err / max(float(torch.max(torch.abs(ref))), 1e-30)
    return abs_err, rel_err


def phase_device(torch):
    smi = shutil.which("nvidia-smi")
    if smi is None:
        fail("nvidia-smi not found")
    card = subprocess.run(
        [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    nvcc_ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True)
    release = [l for l in nvcc_ver.stdout.splitlines() if "release" in l]
    print(
        f"[1 device] torch {torch.__version__} (CUDA {torch.version.cuda}); "
        f"nvcc: {release[0].strip() if release else 'not found'}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
        flush=True,
    )
    return card


def phase_build():
    from mfm_tpu_torch.ops import build

    t0 = time.perf_counter()
    lib_path = build.build()
    build.load_library()
    secs = time.perf_counter() - t0
    log = (lib_path.parent / "build.log").read_text()
    usage = [l.split("ptxas info    :")[-1].strip() for l in log.splitlines()
             if ("Used" in l and "registers" in l) or "spill" in l]
    print(f"[2 build] {secs:.1f} s -> {lib_path}; ptxas: {' | '.join(usage)}", flush=True)


def perturbed_net(torch, dim, width, n_fourier, score_fn, seed=0, gate_scale=0.05):
    """A net with every parameter perturbed (zero heads would hide a head
    bug); ``gate_scale`` sizes the gate head's perturbation, which a stiff
    score (phi-four's is O(100)) needs small for the ODE to stay stable."""
    from mfm_tpu_torch.flows import VectorFieldNet, field_params

    gen = torch.Generator().manual_seed(seed)
    freqs = torch.randn(n_fourier, generator=gen)
    net = VectorFieldNet(
        dim, freqs, (width, width), (width, width), (width, width), act="relu",
        score_fn=score_fn, generator=gen,
    )
    params = {
        k: v + (gate_scale if k.startswith("gate_head") else 0.05)
        * torch.randn(v.shape, generator=gen)
        for k, v in field_params(net).items()
    }
    return net.cuda(), {k: v.cuda() for k, v in params.items()}


def phase_kernels(torch, report):
    from mfm_tpu_torch.ops import field, pairwise, phi_four
    from mfm_tpu_torch.targets import PhiFour, four_mode_mixture

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    B, d, W, F, K = 1024, 64, 128, 128, 64
    net, params = perturbed_net(torch, d, W, F, None)
    layout = field.field_layout(params, F)
    packed = field.pack_field_params(params, layout)
    freqs = net.fourier_freqs.contiguous()
    x = torch.randn((B, d), generator=gen, device=dev)
    t = torch.rand(B, generator=gen, device=dev)
    ex = torch.randn((K, B, d), generator=gen, device=dev)

    # sums of <= 256 products per output in three TF32 passes (3xTF32, as
    # close to fp64 as cuBLAS's fp32, ~5e-7), in another order: agreement
    # to ~1e-6 relative; the tolerance leaves headroom
    tol_k1 = 1e-4
    kern = lambda: field.field_apply(packed, layout, "relu", freqs, x, t)
    plain = lambda: field.field_apply_plain(packed, layout, "relu", freqs, x, t)
    (f_k, g_k), (f_p, g_p) = kern(), plain()
    torch.cuda.synchronize()
    err_p = max(errors(torch, f_k, f_p), errors(torch, g_k, g_p))
    ms_p, plain_ms_p = cuda_ms(torch, kern, 50), cuda_ms(torch, plain, 50)
    bound_p, by_p = bound(field.field_flops(layout, B, 0), field.field_bytes(layout, B, 0))
    print(f"[3 K1 primal B={B} d={d}] max abs {err_p[0]:.3e} rel {err_p[1]:.3e} "
          f"(tol rel {tol_k1}); kernel {ms_p:.4f} ms, plain {plain_ms_p:.4f} ms, "
          f"bound {bound_p:.4f} ms ({by_p})", flush=True)
    if not err_p[1] <= tol_k1:
        fail("K1 primal disagrees with its plain version")

    kern = lambda: field.field_apply(packed, layout, "relu", freqs, x, t, ex)
    plain = lambda: field.field_apply_plain(packed, layout, "relu", freqs, x, t, ex)
    out_k, out_p = kern(), plain()
    torch.cuda.synchronize()
    err_t = max(errors(torch, a, b) for a, b in zip(out_k, out_p))
    # plain, kernel, kernel, plain: the two versions compared in turns
    plain_a, ms_a = cuda_ms(torch, plain, 20), cuda_ms(torch, kern, 20)
    ms_b, plain_b = cuda_ms(torch, kern, 20), cuda_ms(torch, plain, 20)
    ms_t, plain_ms_t = min(ms_a, ms_b), min(plain_a, plain_b)
    flops, nbytes = field.field_flops(layout, B, K), field.field_bytes(layout, B, K)
    bound_t, by_t = bound(flops, nbytes)
    bound_tc = bound(3 * flops, nbytes, TF32_PEAK)[0]
    print(f"[3 K1 tangents K={K} B={B} d={d}] max abs {err_t[0]:.3e} rel {err_t[1]:.3e} "
          f"(tol rel {tol_k1}); kernel {ms_t:.4f} ms, plain {plain_ms_t:.4f} ms "
          f"(kernel {ms_a:.4f} / {ms_b:.4f}, plain {plain_a:.4f} / {plain_b:.4f})", flush=True)
    print(f"[3 K1 work K={K}] {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.1f} MB: "
          f"{flops / ms_t / 1e9:.1f} TFLOP/s; bound {bound_t:.4f} ms at the fp32 FMA peak "
          f"({by_t}), share {bound_t / ms_t:.3f}; 3xTF32 bound {bound_tc:.4f} ms, share "
          f"{bound_tc / ms_t:.3f}; bytes alone {nbytes / HBM_RATE * 1e3:.4f} ms", flush=True)
    if not err_t[1] <= tol_k1:
        fail("K1 with tangents disagrees with its plain version")
    if not ms_t < plain_ms_t:
        fail("K1 with tangents is slower than its plain version")
    report["field_apply"] = dict(
        max_abs_err=max(err_p[0], err_t[0]), max_rel_err=max(err_p[1], err_t[1]),
        ms=ms_t, plain_ms=plain_ms_t, bound_ms=bound_t, bound_by=by_t, library_ms=None,
        flops=flops, share_of_bound=bound_t / ms_t, bound_3xtf32_ms=bound_tc,
        primal_ms=ms_p, primal_plain_ms=plain_ms_p, primal_bound_ms=bound_p,
        shape=f"B={B} d={d} K={K} widths={W} F={F}",
    )

    # the fp64-reduced kernel sum against the plain version's Gram-form
    # fp32 tiles: relative 1e-4 covers the Gram cancellation at |x| ~ 8
    tol_k2 = 1e-4
    four = four_mode_mixture(dev)
    cases = [
        ("stein_pairwise_sum", (1024, 64), PhiFour(64).score,
         lambda T, D: 0.5 * torch.randn((T, D), generator=gen, device=dev)),
        ("stein_pairwise_sum", (12800, 2), four.score, lambda T, D: four.sample(gen, (T,))),
    ]
    for name, (T, D), score, draw in cases:
        X = draw(T, D).contiguous()
        S = score(X).contiguous()
        kern = lambda: pairwise.stein_pairwise_sum(X, S)
        plain = lambda: pairwise.stein_pairwise_sum_plain(X, S)
        err = errors(torch, kern(), plain())
        ms, plain_ms = cuda_ms(torch, kern, 5), cuda_ms(torch, plain, 5)
        # per pair: four length-D dot products (x.x, s.x, x.s, s.s) and ~20
        # scalar operations for the IMQ terms
        bnd, by = bound(T * T * (8 * D + 20), 4 * 2 * T * D + 8)
        print(f"[3 K2a T={T} d={D}] abs {err[0]:.3e} rel {err[1]:.3e} (tol rel {tol_k2}); "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bnd:.4f} ms ({by})",
              flush=True)
        if not err[1] <= tol_k2:
            fail(f"K2a at ({T}, {D}) disagrees with its plain version")
        prev = report.get(name, {"max_abs_err": 0.0, "max_rel_err": 0.0})
        report[name] = dict(max_abs_err=max(prev["max_abs_err"], err[0]),
                            max_rel_err=max(prev["max_rel_err"], err[1]), ms=ms,
                            plain_ms=plain_ms, bound_ms=bnd, bound_by=by, library_ms=None,
                            shape=f"T={T} d={D}")

    A = four.sample(gen, (12800,)).contiguous()
    Bm = four.sample(gen, (12800,)).contiguous()
    kern = lambda: pairwise.rbf_kernel_sum(A, Bm)
    plain = lambda: pairwise.rbf_kernel_sum_plain(A, Bm)
    err = errors(torch, kern(), plain())
    ms, plain_ms = cuda_ms(torch, kern, 5), cuda_ms(torch, plain, 5)
    # per pair: a squared distance over d=2 (3 operations a dimension), a
    # scale and an exp
    bnd, by = bound(12800 * 12800 * (3 * 2 + 3), 4 * 2 * 12800 * 2 + 8)
    print(f"[3 K2b T=12800 d=2] abs {err[0]:.3e} rel {err[1]:.3e} (tol rel {tol_k2}); "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bnd:.4f} ms ({by})", flush=True)
    if not err[1] <= tol_k2:
        fail("K2b disagrees with its plain version")
    report["rbf_kernel_sum"] = dict(max_abs_err=err[0], max_rel_err=err[1], ms=ms,
                                    plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
                                    library_ms=None, shape="Ta=Tb=12800 d=2")

    # K3: value and score are fp32 sums of d terms (warp shuffles against
    # torch's reduction) and one stencil per site; 1e-5 relative to each
    # output's largest entry. The first case is the main path's shape, whose
    # times are reported.
    tol_k3 = 1e-5
    k3 = {"max_abs_err": 0.0, "max_rel_err": 0.0}
    for B3, D3, pbc, bc in ((1024, 64, False, 0.0), (1024, 64, True, 0.0), (37, 64, False, 0.5)):
        x = 1.5 * torch.randn((B3, D3), generator=gen, device=dev)
        args = (0.1, 20.0, pbc, bc)
        kern = lambda: phi_four.phi_four_value_and_score(x, *args)
        plain = lambda: phi_four.phi_four_value_and_score_plain(x, *args)
        (v_k, s_k), (v_p, s_p) = kern(), plain()
        v_only, no_score = phi_four.phi_four_value_and_score(x, *args, with_score=False)
        torch.cuda.synchronize()
        err = max(errors(torch, v_k, v_p), errors(torch, s_k, s_p))
        ms, plain_ms = cuda_ms(torch, kern, 50), cuda_ms(torch, plain, 50)
        # ~16 operations a site for the value and the score; x read once,
        # the value and the score written once
        bnd, by = bound(16 * B3 * D3, 4 * (2 * B3 * D3 + B3))
        print(f"[3 K3 B={B3} d={D3} {'pbc' if pbc else f'dirichlet {bc}'}] max abs {err[0]:.3e} "
              f"rel {err[1]:.3e} (tol rel {tol_k3}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bnd:.6f} ms ({by})", flush=True)
        if not (err[1] <= tol_k3 and no_score is None and torch.equal(v_only, v_k)):
            fail(f"K3 at ({B3}, {D3}) pbc={pbc} bc={bc} disagrees with its plain version")
        k3 = dict(max_abs_err=max(k3["max_abs_err"], err[0]),
                  max_rel_err=max(k3["max_rel_err"], err[1]),
                  ms=k3.get("ms", ms), plain_ms=k3.get("plain_ms", plain_ms),
                  bound_ms=k3.get("bound_ms", bnd), bound_by=k3.get("bound_by", by),
                  library_ms=None, shape="B=1024 d=64 dirichlet, value and score")
    report["phi_four_value_and_score"] = k3


def phase_transport(torch):
    from mfm_tpu_torch.flows import kernel_tangent_field, make_transport, module_tangent_field
    from mfm_tpu_torch.targets import PhiFour

    target = PhiFour(64)
    net, params = perturbed_net(torch, 64, 128, 128, target.score, seed=1, gate_scale=1e-4)
    gen = torch.Generator(device="cuda").manual_seed(1)
    u = torch.randn((1024, 64), generator=gen, device="cuda")
    out = {}
    for name, bind in (("kernel", kernel_tangent_field(net)), ("module", module_tangent_field(net))):
        tr = make_transport(bind, divergence="exact", n_steps=24, method="rk4")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, ld_f = tr.forward(params, u)
        u_back, ld_i = tr.inverse(params, x)
        torch.cuda.synchronize()
        out[name] = (x, ld_f, u_back, ld_i, time.perf_counter() - t0)
    (xk, lfk, uk, lik, tk), (xm, lfm, um, lim, tm) = out["kernel"], out["module"]
    ex, eu = errors(torch, xk, xm)[0], errors(torch, uk, um)[0]
    eld = max(errors(torch, lfk, lfm)[0], errors(torch, lik, lim)[0])
    finite = all(bool(torch.isfinite(v).all()) for v in (xk, lfk, uk, lik))
    # 96 stage evaluations in fp32 with a different summation order: x, u
    # to 1e-4 absolute, the logdet (a sum of 96 x 64 diagonal terms) to 1e-3
    moved = float(torch.max(torch.abs(xk - u)))
    print(f"[4 transport B=1024 d=64] max abs x {ex:.3e} u {eu:.3e} logdet {eld:.3e} "
          f"(tol 1e-4 / 1e-4 / 1e-3); max |x - u| {moved:.3f}, logdet range [{float(lfk.min()):.3f}, "
          f"{float(lfk.max()):.3f}]; fwd+inv kernel {tk:.3f} s, module {tm:.3f} s", flush=True)
    if not (finite and ex <= 1e-4 and eu <= 1e-4 and eld <= 1e-3):
        fail("the kernel transport disagrees with the module transport")

    # The score gate's tangent: the K3-backed score's analytic H e against
    # forward-over-reverse autodiff of a stencil written out here, over the
    # 64 basis tangents of an exact-divergence stage. fp32 both, 1e-5
    # relative to the largest entry.
    from torch.func import grad, jvp, vmap

    def stencil_log_lik(y):  # the log-density, independent of ops/phi_four.py
        c = 0.1 * y.shape[-1]
        w = 1.0 - y * y
        y_ = torch.nn.functional.pad(y, (1, 1))
        d1 = y_[..., 1:] - y_[..., :-1]
        return -20.0 * (0.5 * c * torch.sum(d1 * d1, -1) + torch.sum(w * w, -1) / (4.0 * c))

    x = 1.5 * torch.rand((1024, 64), generator=gen, device="cuda") - 0.75
    basis = torch.eye(64, device="cuda")[:, None, :].expand(64, 1024, 64)
    k3_tangent = lambda: vmap(lambda e: jvp(target.score, (x,), (e,))[1])(basis)
    autodiff = lambda: vmap(
        lambda e: jvp(grad(lambda y: stencil_log_lik(y).sum()), (x,), (e,))[1]
    )(basis)
    err = errors(torch, k3_tangent(), autodiff())
    ms, ad_ms = cuda_ms(torch, k3_tangent, 10), cuda_ms(torch, autodiff, 10)
    print(f"[4 score tangent B=1024 d=64 K=64] max abs {err[0]:.3e} rel {err[1]:.3e} (tol rel "
          f"1e-5); K3-backed H e {ms:.4f} ms, autodiff jvp(grad) {ad_ms:.4f} ms", flush=True)
    if not err[1] <= 1e-5:
        fail("the K3-backed score's tangent is not the stencil's Hessian-vector product")

    # The two transports share the score-gate term, and its gate is tiny
    # above. Here the gate is large (no ODE to keep stable): the kernel
    # path's divergence against the trace of the autograd Jacobian of the
    # whole field, which shares no code with it.
    from torch.func import functional_call, jacrev, vmap

    from mfm_tpu_torch.flows.cnf import exact_divergence

    net, params = perturbed_net(torch, 64, 128, 128, target.score, seed=2, gate_scale=0.05)
    x = 2.0 * torch.rand((16, 64), generator=gen, device="cuda") - 1.0
    t = torch.rand(16, generator=gen, device="cuda")
    bind = kernel_tangent_field(net)
    with torch.no_grad():
        _, div = exact_divergence(bind(params), x, t)
        net.score_fn = lambda y: torch.zeros_like(y)
        _, div_no_gate = exact_divergence(bind(params), x, t)
        net.score_fn = target.score
    jac = vmap(jacrev(lambda xi, ti: functional_call(net, params, (xi, ti))))(x, t)
    trace = torch.diagonal(jac, dim1=-2, dim2=-1).sum(-1).detach()
    err = errors(torch, div, trace)
    gate_term = float(torch.max(torch.abs(div - div_no_gate)))
    # fp32 sums of 64 diagonal terms (|gate| * 256 each) in another order
    print(f"[4 divergence B=16 d=64 gate 0.05] max abs {err[0]:.3e} rel {err[1]:.3e} "
          f"(tol rel 1e-4); score-gate term up to {gate_term:.3f}", flush=True)
    if not (err[1] <= 1e-4 and gate_term > 100 * err[0]):
        fail("the kernel path's divergence is not the trace of the field's Jacobian")


def run_cli(argv, label):
    from mfm_tpu_torch import cli

    t0 = time.perf_counter()
    (m,) = cli.main(argv)
    wall = time.perf_counter() - t0
    row = {k: m[k] for k in ("logpdf", "stein_u", "stein_v", "mmd", "logpdf_star",
                             "stein_u_star", "stein_v_star", "mmd_star")}
    print(f"[{label}] row {json.dumps(row)} metrics_kernel={m['metrics_kernel']} "
          f"IS ESS {m['is_ess']:.3f}, {m['is_unique']} distinct resampled points; "
          f"train_time {m['train_time']:.3f} s, {m['it_per_s']:.2f} it/s, wall {wall:.1f} s",
          flush=True)
    if not all(math.isfinite(v) for v in row.values()):
        fail(f"{label}: non-finite metric row")
    return m


def main():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is false)")
    try:
        import mfm_tpu_torch  # noqa: F401
        from mfm_tpu_torch.ops import field, pairwise, phi_four
    except ImportError as e:
        fail(f"the port is not importable beside this script: {e}")

    report = {}
    phase_device(torch)
    phase_build()
    phase_kernels(torch, report)
    phase_transport(torch)

    counters = (field.field_apply, pairwise.stein_pairwise_sum, pairwise.rbf_kernel_sum,
                phi_four.phi_four_value_and_score)
    for fn in counters:
        fn.launches = 0
    phases = [
        (["--example", "phi-four", "--seed", "0", "--learning-iter", "500"], "5 phi-four"),
        (["--example", "phi-four", "--seed", "0", "--learning-iter", "100",
          "--ref-dist", "phifour"], "6 phi-four phifour-ref"),
        (["--example", "phi-four", "--seed", "0", "--learning-iter", "300",
          "--set", "field_precision=highest", "--set", "pallas_field=true"],
         "7 phi-four fused field"),
        (["--example", "4-mode", "--seed", "0", "--learning-iter", "200"], "8 4-mode"),
    ]
    for argv, label in phases:
        before = [f.launches for f in counters]
        run_cli(argv, label)
        print(f"[{label.split()[0]} launches] " + " ".join(
            f"{f.__name__}={f.launches - b}" for f, b in zip(counters, before)), flush=True)
    launches = {f.__name__: f.launches for f in counters}
    print(f"[5-8 launches] {json.dumps(launches)}", flush=True)
    if not all(launches.values()):
        fail(f"a kernel of the main path was never launched: {launches}")

    replaces = {
        "field_apply": ("mfm_tpu_torch/csrc/field.cu", "mfm_tpu/ops/field_pallas.py:177"),
        "stein_pairwise_sum": ("mfm_tpu_torch/csrc/pairwise.cu",
                               "mfm_tpu/ops/pairwise_pallas.py:76"),
        "rbf_kernel_sum": ("mfm_tpu_torch/csrc/pairwise.cu",
                           "mfm_tpu/ops/pairwise_pallas.py:137"),
        "phi_four_value_and_score": ("mfm_tpu_torch/csrc/phi_four.cu",
                                     "mfm_tpu/ops/phi_four_pallas.py:58"),
    }
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **report[name]}
        for name, (src, rep) in replaces.items()
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
