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
   (1024, 64), (12800, 2), (12800, 64) and (12800, 1600), at the eval
   shapes of pines (128, 1600; distinct points and an IS-resampled set with
   repeats), many-well (12800, 32; both routes) and funnel (12800, 10), on
   two modes at +-16 and +-32 (the route the data picks, within 1e-5 of
   float64), with what the route's bound costs, at a d on each
   side of its route threshold with a ragged T, and at beta = -0.3; K2b at
   (12800, 2) between two point sets, of one with itself, as the three
   sums of an MMD in one launch, at d = 10 and 32 on funnel and many-well
   draws, and ragged at d = 33 (K2a and K2b against
   their plain versions in float64, every call twice for equal bits, and
   no slower than before their redesign); K3 (value and score) at
   (1024, 64) Dirichlet, (1024, 64) periodic and (37, 64) with the ends at
   0.5, and K3 through PhiFour.value_and_score; the phi-four score gate
   with 64 tangents at (1024, 64) Dirichlet, periodic, tilted, and clipped
   at (37, 64), timed with its inputs cold in the L2 (and warm) and its
   launches queued behind a spin (device time, not host dispatch); errors
   and CUDA-event times of kernel and plain version, and each kernel's
   bound (the larger of its operations over the card's peak rate and its
   bytes over the memory rate; for K2a and K2b over the pairs any
   implementation must visit, with the special-function pipe as a third
   rate); K1's achieved TFLOP/s
   and its share of the fp32 FMA bound and of the 3xTF32 tensor-core bound;
4. one forward + inverse transport through K1 against the same transport
   through the nn.Module (torch.func.jvp), B=1024, d=64, both with
   PhiFour's fused score gate: x, u and logdet; the fused score gate of a
   stage against the generic route (vmap(jvp) of the K3-backed score), and
   that score's tangent over the 64 basis vectors against jvp(grad(...))
   of an autodiff stencil that shares no code with it, B=1024, d=64, with
   the times; then, with a large gate, each path's divergence against the
   trace of the autograd Jacobian of the whole field (score gate
   included), B=16, d=64;
5. the phi-four preset as shipped, through mfm_tpu_torch.cli.main (d=64,
   1024 chains, 128-wide trunks, the bf16 field, exact divergence, 24 RK4
   steps, PhiFour on K3, 200 iterations), with the ESS of the final IS
   weights;
6. the same with the 'phifour' reference (--ref-dist phifour), 100
   iterations;
7. the same with the fused fp32 field (field_precision=highest,
   pallas_field=true), 300 iterations;
8. a 4-mode run through the same entry point (reaches the MMD kernel), 100
   iterations;
9. pines as shipped at full width (d=1600, 128 chains, trunks 1024, the bf16
   field, Hutchinson, the 'prior' reference, Rademacher eval probes), 120
   iterations: K2a at its eval;
10. many-well (d=32, 120 iterations) and 11. funnel (d=10, 100): K2a, and
   K2b's general kernel for the MMD against exact draws;
12. many-well on the fused fp32 field (K1 at d=32), 120 iterations;
13. gaussian-mixture, 60 iterations;
14-16. 4-mode with the CIS flow kernel (4 candidates), with independence
   MH, and with the minibatch-OT coupling, 30 iterations each;
17. the SMC baseline (--do-smc) on phi-four: 1024 particles, d=64, MALA at
   the preset step on K3, systematic resampling, 1000 adaptive tempering
   steps, with its log Z and final lambda;
18. the SMC baseline on pines: d=1600, 128 particles, the Cox target on its
   prior path, 500 steps (K2a at (128, 1600) at its eval);
19. phi-four as shipped with NUTS as the MCMC move (static, depth 6, every
   leapfrog a K3 launch), step and mass adaptation frozen at iteration 60,
   100 iterations;
20. the SMC baseline on 4-mode with HMC on the geometric path, waste-free
   (P=4), 128 particles, 200 steps, 12,800 harvested samples (K2a, K2b);
21. pines as shipped, 120 iterations, then 4 flow-annealed SMC steps
   (--flow-smc 4) with latent MALA on 128 particles at d=1600 through the
   transport with its Rademacher probes (a forward and a reverse pass a
   move).

The iteration counts are a small fraction of the presets' (the depth is cut
so that the whole script stays well inside its time limit on a slow host);
a run this short can still diverge for a few of its 12,800 flow samples,
which makes its row non-finite: many-well with seed 0 does at 100 and 150
iterations, on either field, and not at 120 or 200.

The launch counters are zeroed just before phase 5 and read after the last
phase: every kernel must have been launched by the main path, and each
phase by the kernels it names. Each phase prints its host ms a step
(train_time over the steps: an SMC step, an MFM iteration, a flow-SMC
tempering step). The line before
last is the kernel summary as JSON; the last line is
{"ok": true, "device": {...}}. Without a CUDA device, or without the
package beside this file, it exits non-zero and prints no result.
"""

import json
import math
import re
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


def cuda_ms(torch, fn, reps: int, queued: bool = False) -> float:
    """Mean CUDA-event time of ``fn`` over ``reps`` launches, after a warm
    call. A small kernel called back to back can be paced by its host
    dispatch; ``queued`` first holds the stream in a spin of ~0.5 ms a rep,
    so that the host has queued every launch before the first one starts
    and the events see device time only."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(reps * 1_000_000)
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


def kernel_name(mangled: str) -> str:
    """``phi_four_score_gate_kernel<4,1>`` from its mangled name (integer
    and boolean template arguments, a boolean as 0 or 1)."""
    m = re.search(r"\d([a-z][a-z_]*kernel)(I(?:L[ib]\d+E)+E)?", mangled)
    if m is None:
        return mangled
    values = re.findall(r"L[ib](\d+)E", m.group(2) or "")
    return m.group(1) + (f"<{','.join(values)}>" if values else "")


def phase_build():
    from mfm_tpu_torch.ops import build

    t0 = time.perf_counter()
    lib_path = build.build()
    build.load_library()
    secs = time.perf_counter() - t0
    log = (lib_path.parent / "build.log").read_text()
    usage, name = [], "?"
    for line in log.splitlines():  # ptxas -v: each entry's name, then its usage
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            name = kernel_name(entry.group(1))
        elif "spill" in line or ("Used" in line and "registers" in line):
            usage.append(f"{name}: {line.split('ptxas info    :')[-1].strip()}")
    print(f"[2 build] {secs:.1f} s -> {lib_path}; ptxas: {' | '.join(usage)}", flush=True)


def perturbed_net(torch, dim, width, n_fourier, target, seed=0, gate_scale=0.05):
    """A net with every parameter perturbed (zero heads would hide a head
    bug), with ``target``'s score gate (fused for PhiFour) or none;
    ``gate_scale`` sizes the gate head's perturbation, which a stiff score
    (phi-four's is O(100)) needs small for the ODE to stay stable."""
    from mfm_tpu_torch.flows import VectorFieldNet, field_params

    gen = torch.Generator().manual_seed(seed)
    freqs = torch.randn(n_fourier, generator=gen)
    net = VectorFieldNet(
        dim, freqs, (width, width), (width, width), (width, width), act="relu",
        score_fn=target and target.score, score_gate=target and target.score_gate,
        generator=gen,
    )
    params = {
        k: v + (gate_scale if k.startswith("gate_head") else 0.05)
        * torch.randn(v.shape, generator=gen)
        for k, v in field_params(net).items()
    }
    return net.cuda(), {k: v.cuda() for k, v in params.items()}


def phase_kernels(torch, report):
    from mfm_tpu_torch.ops import field, phi_four
    from mfm_tpu_torch.targets import PhiFour

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

    phase_pairwise(torch, report, gen)

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
    # the same launch through the target, as MALA calls it (the launcher
    # straight, no custom op): back to back, this is its host time
    x = 1.5 * torch.randn((1024, 64), generator=gen, device=dev)
    target = PhiFour(64)
    k3["target_ms"] = cuda_ms(torch, lambda: target.value_and_score(x), 200)
    k3["launcher_ms"] = cuda_ms(torch, lambda: phi_four.phi_four_value_and_score(x), 200)
    print(f"[3 K3 back to back B=1024 d=64] PhiFour.value_and_score {k3['target_ms']:.4f} ms, "
          f"phi_four_value_and_score {k3['launcher_ms']:.4f} ms", flush=True)
    report["phi_four_value_and_score"] = k3
    phase_score_gate(torch, report, gen)


# K2a/K2b before their redesign, on this card at 700 W (PERF.md section 6):
# the redesigned kernels must not be slower.
PARENT_MS = {"K2a T=1024 d=64": 0.0644, "K2a T=12800 d=2": 1.7155, "K2b Ta=Tb=12800 d=2": 0.3256}
SFU_PER_CLOCK_SM = 16  # special-function results a clock an SM (exp2, rsqrt)


def sm_clock_hz():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    return float(out) * 1e6


def pair_bound(torch, pairs, flops_per_pair, nbytes):
    """The bound of a pairwise sum over ``pairs`` pairs that any
    implementation must visit: the largest of its bytes over the memory
    rate, one special-function operation a pair over that pipe's rate, and
    its multiply-adds over the fp32 FMA peak. Beside it, what three TF32
    passes on the tensor cores would need (fp32's accuracy too): the floor
    of the Gram route, which may yet come in under the fp32 bound."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    flops = pairs * flops_per_pair
    parts = {
        "bytes": nbytes / HBM_RATE * 1e3,
        "special-function": pairs / (SFU_PER_CLOCK_SM * n_sm * sm_clock_hz()) * 1e3,
        "fp32": flops / FP32_PEAK * 1e3,
        "3xtf32": 3 * flops / TF32_PEAK * 1e3,
    }
    pipe = max(("bytes", "special-function", "fp32"), key=parts.get)
    return dict(bound_ms=parts[pipe], bound_by="bytes" if pipe == "bytes" else "operations",
                bound_pipe=pipe, bound_fp32_ms=parts["fp32"], bound_3xtf32_ms=parts["3xtf32"],
                bound_sfu_ms=parts["special-function"], bound_bytes_ms=parts["bytes"])


def in_turns(torch, kern, plain, reps, plain_reps):
    """(kernel ms, plain ms): plain, kernel, kernel, plain, launches queued."""
    plain_a, ms_a = cuda_ms(torch, plain, plain_reps, True), cuda_ms(torch, kern, reps, True)
    ms_b, plain_b = cuda_ms(torch, kern, reps, True), cuda_ms(torch, plain, plain_reps, True)
    return min(ms_a, ms_b), min(plain_a, plain_b)


def pairwise_inputs(torch):
    """The seeded inputs of the three shapes K2a and K2b were timed at before
    their redesign, by label: (X, S) for K2a, (A, B) for K2b. A generator of
    their own, so that tools/pairwise_variants.py gives the parent's kernels
    the same arrays."""
    from mfm_tpu_torch.targets import PhiFour, four_mode_mixture

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    four = four_mode_mixture(dev)
    X64 = 0.5 * torch.randn((1024, 64), generator=gen, device=dev)
    X2, A, B = (four.sample(gen, (12800,)).contiguous() for _ in range(3))
    return {
        "K2a T=1024 d=64": (X64, PhiFour(64).score(X64).contiguous()),
        "K2a T=12800 d=2": (X2, four.score(X2).contiguous()),
        "K2b Ta=Tb=12800 d=2": (A, B),
    }


def phase_pairwise(torch, report, gen):
    """K2a and K2b against their plain versions run in float64 on the card,
    relative to the sum: 1e-5 on the differences routes (fp32 terms of
    rsqrt.approx / ex2.approx, 2 ulp each, summed in fp64); on the Gram
    route the larger of 1e-5 and the fp32 plain version's own error against
    float64 (both take the Gram form's cancellation). Every kernel call is
    made twice and must return the same bits."""
    from mfm_tpu_torch.ops import pairwise
    from mfm_tpu_torch.targets import (
        Funnel, LogGaussianCoxPines, ManyWell, PhiFour, four_mode_mixture,
    )

    dev = torch.device("cuda")
    four = four_mode_mixture(dev)
    gauss = lambda scale: (lambda T, D: scale * torch.randn((T, D), generator=gen, device=dev))
    old = pairwise_inputs(torch)
    wide = pairwise.GRAM_MIN_D
    cox, wells, funnel = LogGaussianCoxPines(1600, device=dev), ManyWell(32), Funnel(10)
    exact = lambda target: (lambda T, D: target.sample(gen, (T,)))
    pines = lambda T, D: cox.prior_sample(gen, (T,))
    # an IS-resampled set: 4 distinct points, each 32 times
    resampled = lambda T, D: pines(4, D)[torch.arange(T, device=dev) // (T // 4)]
    centres = {}

    def two_modes(offset):  # unit Gaussians at +-offset in every coordinate
        def draw(T, D):
            centres[offset] = offset * (2.0 * torch.randint(
                0, 2, (T, 1), generator=gen, device=dev) - 1.0)
            return centres[offset] + torch.randn((T, D), generator=gen, device=dev)
        return draw, lambda x: centres[offset] - x

    (far16, score16), (far32, score32) = two_modes(16.0), two_modes(32.0)
    # the route each shape must take: the Gram form wherever it was taken
    # before the route looked at the data, the differences form for repeated
    # points and far modes; None where either is right
    stein_cases = [  # (T, d, score, draw, beta, timed, route)
        (1024, 64, PhiFour(64).score, lambda T, D: old["K2a T=1024 d=64"][0], -0.5, True, "gram"),
        (12800, 2, four.score, lambda T, D: old["K2a T=12800 d=2"][0], -0.5, True, "diff"),
        (12800, 64, PhiFour(64).score, gauss(0.5), -0.5, True, "gram"),
        (12800, 1600, lambda x: -x, gauss(1.0), -0.5, True, "gram"),
        (128, 1600, cox.score, pines, -0.5, True, "gram"),       # pines' eval, distinct points
        (128, 1600, cox.score, resampled, -0.5, False, "diff"),  # and its IS-resampled set
        (12800, 32, wells.score, exact(wells), -0.5, True, None),      # many-well's eval
        (12800, 10, funnel.score, exact(funnel), -0.5, True, "diff"),  # funnel's eval
        (12800, 32, score16, far16, -0.5, False, "diff"),
        (12800, 64, score32, far32, -0.5, False, "diff"),
        (1000, wide - 1, lambda x: -x, gauss(1.0), -0.5, False, "diff"),  # each side of the
        (1000, wide, lambda x: -x, gauss(1.0), -0.5, False, "gram"),  # threshold, ragged T
        (1000, 3, lambda x: -x / 4.0, gauss(2.0), -0.3, False, "diff"),  # the general-b instances
        (300, 200, lambda x: -x, gauss(1.0), -0.3, False, "gram"),
    ]
    rows = []
    for T, D, score, draw, beta, timed, expect in stein_cases:
        X = draw(T, D).contiguous()
        S = score(X).contiguous()
        kern = lambda: pairwise.stein_pairwise_sum(X, S, beta)
        ref = pairwise.stein_pairwise_sum_plain(X.double(), S.double(), beta)
        plain32 = pairwise.stein_pairwise_sum_plain(X, S, beta)
        counts = pairwise.stein_pairwise_sum.route_counts
        before = dict(counts)
        got, again = kern(), kern()
        torch.cuda.synchronize()
        # the route both calls took: by d and, from GRAM_MIN_D on, the data
        (route,) = [k for k in counts if counts[k] == before[k] + 2]
        err, plain_err = errors(torch, got, ref), errors(torch, plain32, ref)
        tol = 1e-5
        label = f"K2a T={T} d={D}" + ("" if beta == -0.5 else f" beta={beta}")
        line = (f"[3 {label} {route}] abs {err[0]:.3e} rel {err[1]:.3e} (tol rel {tol:.1e}; "
                f"plain fp32 rel {plain_err[1]:.3e}); bits repeat {torch.equal(got, again)}")
        if not (err[1] <= tol and torch.equal(got, again)):
            print(line, flush=True)
            fail(f"{label} disagrees with its float64 plain version, or does not repeat")
        if expect not in (None, route):
            fail(f"{label}: took the {route} route, must take {expect}")
        row = dict(shape=f"T={T} d={D}", form=route, max_abs_err=err[0], max_rel_err=err[1],
                   tol_rel=tol)
        if timed:
            plain = lambda: pairwise.stein_pairwise_sum_plain(X, S, beta)
            big = T * D > 1e6
            # the route by name: the kernel's own time, with no read-back of
            # the route's bound between the queued launches
            named = lambda: pairwise.stein_pairwise_sum(X, S, beta, route=route)
            ms, plain_ms = in_turns(torch, named, plain, 5 if big else 50, 3 if big else 5)
            # per unordered pair: three length-D products (x.x, s.s and the
            # cross terms) and ~12 operations for the IMQ terms
            bnd = pair_bound(torch, T * (T + 1) // 2, 6 * D + 12, 4 * 2 * T * D + 8)
            row.update(ms=ms, plain_ms=plain_ms, library_ms=None, **bnd,
                       share_of_bound=bnd["bound_ms"] / ms,
                       share_of_3xtf32_bound=bnd["bound_3xtf32_ms"] / ms)
            line += (f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bnd['bound_ms']:.4f} "
                     f"ms ({bnd['bound_pipe']}; fp32 {bnd['bound_fp32_ms']:.4f}, 3xTF32 "
                     f"{bnd['bound_3xtf32_ms']:.4f}), share {row['share_of_bound']:.3f}"
                     + (f" (of 3xTF32 {row['share_of_3xtf32_bound']:.3f})" if route == "gram" else ""))
            if D >= wide:  # the other route at the same shape, and the bound's cost
                other = "diff" if route == "gram" else "gram"
                alt = lambda: pairwise.stein_pairwise_sum(X, S, beta, route=other)
                alt_err = errors(torch, alt(), ref)
                row["other_route_ms"] = cuda_ms(torch, alt, 3 if big else 20, True)
                line += (f"; the {other} route {row['other_route_ms']:.4f} ms "
                         f"(rel {alt_err[1]:.3e})")
                # what the bound costs a call (a product of 64 rows with all
                # rows, and a scalar read back): host-paced calls, with and without
                named_ms = min(cuda_ms(torch, named, 5 if big else 50),
                               cuda_ms(torch, named, 5 if big else 50))
                default_ms = min(cuda_ms(torch, kern, 5 if big else 50),
                                 cuda_ms(torch, kern, 5 if big else 50))
                row.update(route_bound_ms=default_ms - named_ms, host_paced_ms=default_ms)
                line += (f"; not queued: {default_ms:.4f} ms with the route's bound, "
                         f"{named_ms:.4f} ms with the route named")
            rows.append(row)
        print(line, flush=True)
        if timed and not row["share_of_bound"] <= 1.0:
            fail(f"{label}: faster than its bound, so the bound's count is wrong")
        parent = PARENT_MS.get(label)
        if parent is not None and not row["ms"] <= parent:
            fail(f"{label}: {row['ms']:.4f} ms, slower than before its redesign ({parent} ms)")
    main = rows[1]  # the eval of the 4-mode run; every shape under "shapes"

    report["stein_pairwise_sum"] = dict(
        main, max_abs_err=max(r["max_abs_err"] for r in rows),
        max_rel_err=max(r["max_rel_err"] for r in rows), shapes=rows)

    T = 12800
    A, Bm = old["K2b Ta=Tb=12800 d=2"]
    W1, W2 = (wells.sample(gen, (T,)).contiguous() for _ in range(2))  # many-well's MMD, d=32
    F1, F2 = (funnel.sample(gen, (T,)).contiguous() for _ in range(2))  # funnel's, d=10
    between = (lambda p, q: pairwise.rbf_kernel_sum(p, q),
               lambda p, q: pairwise.rbf_kernel_sum_plain(p, q), T * T, 2)
    itself = (lambda p, q: pairwise.rbf_kernel_sum(p, p),
              lambda p, q: pairwise.rbf_kernel_sum_plain(p, p), T * (T + 1) // 2, 1)
    mmd = (lambda p, q: pairwise.rbf_mmd_sums(p, q),
           lambda p, q: pairwise.rbf_mmd_sums_plain(p, q), T * T + T * (T + 1), 2)
    rbf_cases = [  # (label, the two point sets, (kernel, plain, pairs, point sets read))
        ("K2b Ta=Tb=12800 d=2", A, Bm, between),
        ("K2b A=B T=12800 d=2", A, Bm, itself),
        ("K2b MMD T=12800 d=2", A, Bm, mmd),
        ("K2b Ta=Tb=12800 d=32", W1, W2, between),  # rbf_general_kernel from here on
        ("K2b MMD T=12800 d=32", W1, W2, mmd),
        ("K2b Ta=Tb=12800 d=10", F1, F2, between),
        ("K2b MMD T=12800 d=10", F1, F2, mmd),
    ]
    rows = []
    for label, P0, P1, (kernel, plain, pairs, n_sets) in rbf_cases:
        D = P0.shape[1]
        kern = lambda: kernel(P0, P1)
        got, again = kern(), kern()
        ref = plain(P0.double(), P1.double())
        torch.cuda.synchronize()
        err = max(errors(torch, g, r) for g, r in zip(got.reshape(-1), ref.reshape(-1)))
        ms, plain_ms = in_turns(torch, kern, lambda: plain(P0, P1), 50 if D <= 4 else 10, 5)
        # per pair: a squared distance over d (a subtraction and a
        # multiply-add a dimension), an exp and an add
        bnd = pair_bound(torch, pairs, 3 * D + 2, 4 * n_sets * T * D + 8)
        row = dict(shape=label[4:], max_abs_err=err[0], max_rel_err=err[1], ms=ms,
                   plain_ms=plain_ms, library_ms=None, **bnd, share_of_bound=bnd["bound_ms"] / ms)
        rows.append(row)
        print(f"[3 {label}] abs {err[0]:.3e} rel {err[1]:.3e} (tol rel 1e-5); bits repeat "
              f"{torch.equal(got, again)}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bnd['bound_ms']:.4f} ms ({bnd['bound_pipe']}), share {row['share_of_bound']:.3f}",
              flush=True)
        if not (err[1] <= 1e-5 and torch.equal(got, again)):
            fail(f"{label} disagrees with its float64 plain version, or does not repeat")
        if not row["share_of_bound"] <= 1.0:
            fail(f"{label}: faster than its bound, so the bound's count is wrong")
        parent = PARENT_MS.get(label)
        if parent is not None and not ms <= parent:
            fail(f"{label}: {ms:.4f} ms, slower than before its redesign ({parent} ms)")
    # the chunked route, ragged on both sides, at another bandwidth
    P = 1.5 * torch.randn((1000, 33), generator=gen, device=dev)
    Q = 1.5 * torch.randn((700, 33), generator=gen, device=dev) + 0.3
    got = pairwise.rbf_mmd_sums(P, Q, 20.0)
    again = pairwise.rbf_mmd_sums(P, Q, 20.0)
    err = errors(torch, got, pairwise.rbf_mmd_sums_plain(P.double(), Q.double(), 20.0))
    print(f"[3 K2b MMD Tx=1000 Ty=700 d=33 sigma2=20] abs {err[0]:.3e} rel {err[1]:.3e} "
          f"(tol rel 1e-5); bits repeat {torch.equal(got, again)}", flush=True)
    if not (err[1] <= 1e-5 and torch.equal(got, again)):
        fail("K2b at d=33 disagrees with its float64 plain version, or does not repeat")
    report["rbf_kernel_sum"] = dict(
        rows[2], max_abs_err=max(r["max_abs_err"] for r in rows),
        max_rel_err=max(r["max_rel_err"] for r in rows), shapes=rows)


L2_BYTES = 50 * 2**20  # the H100's L2


def phase_score_gate(torch, report, gen):
    """The fused score gate against its plain version, both in place on
    their own copies of field and dfield. Timed cold: each launch takes the
    next of enough copies of its inputs to overflow the L2 twice, so its
    bytes come from HBM, as the bound counts them; and warm, back to back
    on one copy (the L2 then holds most of a slice-sized working set)."""
    from mfm_tpu_torch.ops import phi_four

    dev = torch.device("cuda")
    K = 64
    # fp32 sums of three terms per score and per H e entry, in another
    # order: 1e-5 relative to each output's largest entry (as K3)
    tol = 1e-5
    cases = [  # (label, B, d, kwargs); the first is the main path's
        ("dirichlet", 1024, 64, {}),
        ("pbc", 1024, 64, {"pbc": True}),
        ("tilt", 1024, 64, {"bc_value": 0.5, "tilt_lambda": 2.0, "tilt_val": 0.3}),
        ("clip", 37, 64, {"clip": 60.0}),
    ]
    out = {"max_abs_err": 0.0, "max_rel_err": 0.0}
    for label, B, d, kw in cases:
        x = 2.0 * torch.rand((B, d), generator=gen, device=dev) - 1.0
        gate = 0.05 * torch.randn((B, d), generator=gen, device=dev)
        field = torch.randn((B, d), generator=gen, device=dev)
        ex = torch.randn((K, B, d), generator=gen, device=dev)
        dfield = torch.randn((K, B, d), generator=gen, device=dev)
        got = phi_four.phi_four_score_gate(x, gate, field.clone(), ex, dfield.clone(), **kw)
        ref = phi_four.phi_four_score_gate_plain(x, gate, field.clone(), ex, dfield.clone(), **kw)
        torch.cuda.synchronize()
        err = max(errors(torch, got[0], ref[0]), errors(torch, got[1], ref[1]))
        # x, gate, field read and field written; ex and dfield read and
        # dfield written; ~10 operations a site and tangent
        nbytes = 4 * (4 * B * d + 3 * K * B * d)
        bnd, by = bound(10 * K * B * d, nbytes)
        copies = [tuple(v.clone() for v in (x, gate, field, ex, dfield))
                  for _ in range(max(2, math.ceil(2 * L2_BYTES / nbytes)))]
        turn = [0]

        def cold(fn):
            def call():
                turn[0] += 1
                return fn(*copies[turn[0] % len(copies)], **kw)
            return call

        kern = cold(phi_four.phi_four_score_gate)
        plain = cold(phi_four.phi_four_score_gate_plain)
        plain_a, ms_a = cuda_ms(torch, plain, 10, True), cuda_ms(torch, kern, 50, True)
        ms_b, plain_b = cuda_ms(torch, kern, 50, True), cuda_ms(torch, plain, 10, True)
        ms, plain_ms = min(ms_a, ms_b), min(plain_a, plain_b)
        f2, d2 = field.clone(), dfield.clone()
        warm = lambda: phi_four.phi_four_score_gate(x, gate, f2, ex, d2, **kw)
        warm_ms, host_ms = cuda_ms(torch, warm, 50, True), cuda_ms(torch, warm, 50)
        inside = ""
        if "clip" in kw:
            s = phi_four.phi_four_value_and_score(x)[1]
            inside = f", {float((s.abs() < kw['clip']).float().mean()):.2f} of the sites inside"
        print(f"[3 score gate {label} B={B} d={d} K={K}] max abs {err[0]:.3e} rel {err[1]:.3e} "
              f"(tol rel {tol}){inside}; kernel cold {ms:.4f} ms ({ms_a:.4f} / {ms_b:.4f}, "
              f"{len(copies)} copies of {nbytes / 1e6:.1f} MB), warm {warm_ms:.4f} ms, warm "
              f"and not queued (host-paced) {host_ms:.4f} ms; plain "
              f"cold {plain_ms:.4f} ms; bound {bnd:.4f} ms ({by}), share {bnd / ms:.3f}",
              flush=True)
        if not err[1] <= tol:
            fail(f"the score gate ({label}) disagrees with its plain version")
        out = dict(max_abs_err=max(out["max_abs_err"], err[0]),
                   max_rel_err=max(out["max_rel_err"], err[1]),
                   ms=out.get("ms", ms), plain_ms=out.get("plain_ms", plain_ms),
                   bound_ms=out.get("bound_ms", bnd), bound_by=out.get("bound_by", by),
                   library_ms=None, share_of_bound=out.get("share_of_bound", bnd / ms),
                   warm_ms=out.get("warm_ms", warm_ms), shape=f"B=1024 d=64 K={K} dirichlet")
    report["phi_four_score_gate"] = out


def phase_transport(torch):
    from mfm_tpu_torch.flows import kernel_tangent_field, make_transport, module_tangent_field
    from mfm_tpu_torch.targets import PhiFour

    target = PhiFour(64)
    net, params = perturbed_net(torch, 64, 128, 128, target, seed=1, gate_scale=1e-4)
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

    # A stage's score gate: the fused kernel against the generic route
    # (vmap(jvp) of the K3-backed score, torch epilogue), 64 basis tangents.
    from torch.func import grad, jvp, vmap

    from mfm_tpu_torch.targets.base import generic_score_gate

    x = 1.5 * torch.rand((1024, 64), generator=gen, device="cuda") - 0.75
    basis = torch.eye(64, device="cuda")[:, None, :].expand(64, 1024, 64).contiguous()
    gate = 0.05 * torch.randn((1024, 64), generator=gen, device="cuda")
    field = torch.randn((1024, 64), generator=gen, device="cuda")
    dfield = torch.randn((64, 1024, 64), generator=gen, device="cuda")
    generic = lambda: generic_score_gate(target.score, x, gate, field, basis, dfield)
    fused = target.score_gate(x, gate, field.clone(), basis, dfield.clone())
    err = max(errors(torch, a, b) for a, b in zip(fused, generic()))
    f2, d2 = field.clone(), dfield.clone()  # the fused gate adds in place
    ms = cuda_ms(torch, lambda: target.score_gate(x, gate, f2, basis, d2), 10)
    gen_ms = cuda_ms(torch, generic, 10)
    print(f"[4 score gate stage B=1024 d=64 K=64] max abs {err[0]:.3e} rel {err[1]:.3e} (tol rel "
          f"1e-5); fused {ms:.4f} ms, generic route {gen_ms:.4f} ms (back to back)", flush=True)
    if not err[1] <= 1e-5:
        fail("the fused score gate disagrees with the generic route")

    # The score gate's tangent: the K3-backed score's analytic H e against
    # forward-over-reverse autodiff of a stencil written out here, over the
    # 64 basis tangents of an exact-divergence stage. fp32 both, 1e-5
    # relative to the largest entry.

    def stencil_log_lik(y):  # the log-density, independent of ops/phi_four.py
        c = 0.1 * y.shape[-1]
        w = 1.0 - y * y
        y_ = torch.nn.functional.pad(y, (1, 1))
        d1 = y_[..., 1:] - y_[..., :-1]
        return -20.0 * (0.5 * c * torch.sum(d1 * d1, -1) + torch.sum(w * w, -1) / (4.0 * c))

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

    # The gate is tiny above. Here it is large (no ODE to keep stable):
    # each path's divergence against the trace of the autograd Jacobian of
    # the whole field (nn.Module forward, autograd through K3's score),
    # which shares no code with the fused score gate.
    from torch.func import functional_call, jacrev, vmap

    from mfm_tpu_torch.flows.cnf import exact_divergence

    net, params = perturbed_net(torch, 64, 128, 128, target, seed=2, gate_scale=0.05)
    no_gate = {k: torch.zeros_like(v) if k.startswith("gate_head") else v
               for k, v in params.items()}
    x = 2.0 * torch.rand((16, 64), generator=gen, device="cuda") - 1.0
    t = torch.rand(16, generator=gen, device="cuda")
    jac = vmap(jacrev(lambda xi, ti: functional_call(net, params, (xi, ti))))(x, t)
    trace = torch.diagonal(jac, dim1=-2, dim2=-1).sum(-1).detach()
    for name, bind in (("kernel", kernel_tangent_field(net)), ("module", module_tangent_field(net))):
        with torch.no_grad():
            _, div = exact_divergence(bind(params), x, t)
            _, div_no_gate = exact_divergence(bind(no_gate), x, t)
        err = errors(torch, div, trace)
        gate_term = float(torch.max(torch.abs(div - div_no_gate)))
        # fp32 sums of 64 diagonal terms (|gate| * 256 each) in another order
        print(f"[4 divergence {name} B=16 d=64 gate 0.05] max abs {err[0]:.3e} rel {err[1]:.3e} "
              f"(tol rel 1e-4); score-gate term up to {gate_term:.3f}", flush=True)
        if not (err[1] <= 1e-4 and gate_term > 100 * err[0]):
            fail(f"the {name} path's divergence is not the trace of the field's Jacobian")


def run_cli(argv, label):
    from mfm_tpu_torch import cli

    t0 = time.perf_counter()
    (m,) = cli.main(argv)
    wall = time.perf_counter() - t0
    row = {k: m[k] for k in ("logpdf", "stein_u", "stein_v", "mmd", "logpdf_star",
                             "stein_u_star", "stein_v_star", "mmd_star")}
    weights = ("no importance weights (SMC harvest)" if m["is_ess"] is None else
               f"IS ESS {m['is_ess']:.3f}, {m['is_unique']} distinct resampled points")
    extra = {k: m[k] for k in ("log_z", "lmbda", "step_size", "flow_smc_log_z",
                               "flow_smc_lmbda", "flow_smc_ess_fraction", "flow_smc_time")
             if k in m}
    print(f"[{label}] row {json.dumps(row)} metrics_kernel={m['metrics_kernel']} {weights}; "
          f"train_time {m['train_time']:.3f} s, {m['it_per_s']:.2f} it/s "
          f"({1e3 / m['it_per_s']:.2f} host ms a step), wall {wall:.1f} s; {json.dumps(extra)}",
          flush=True)
    if not all(math.isfinite(v) for v in (*row.values(), *extra.values())):
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
                phi_four.phi_four_value_and_score, phi_four.phi_four_score_gate)
    for fn in counters:
        fn.launches = 0
    K1, K2A, K2B, K3, GATE = (f.__name__ for f in counters)
    fused = ["--set", "field_precision=highest", "--set", "pallas_field=true"]
    short = ["--example", "4-mode", "--learning-iter", "30"]
    phases = [  # (arguments after --seed 0, label, the kernels the run must launch)
        (["--example", "phi-four", "--learning-iter", "200"], "5 phi-four", (K3, GATE, K2A)),
        (["--example", "phi-four", "--learning-iter", "100", "--ref-dist", "phifour"],
         "6 phi-four phifour-ref", (K3, GATE, K2A)),
        (["--example", "phi-four", "--learning-iter", "300", *fused],
         "7 phi-four fused field", (K1, K3, GATE, K2A)),
        (["--example", "4-mode", "--learning-iter", "100"], "8 4-mode", (K2A, K2B)),
        (["--example", "pines", "--learning-iter", "120"], "9 pines", (K2A,)),
        (["--example", "many-well", "--learning-iter", "120"], "10 many-well", (K2A, K2B)),
        (["--example", "funnel", "--learning-iter", "100"], "11 funnel", (K2A, K2B)),
        (["--example", "many-well", "--learning-iter", "120", *fused],
         "12 many-well fused field", (K1, K2A, K2B)),
        (["--example", "gaussian-mixture", "--learning-iter", "60"], "13 gaussian-mixture",
         (K2A, K2B)),
        ([*short, "--num-importance-samples", "4"], "14 4-mode CIS", (K2A, K2B)),
        ([*short, "--num-importance-samples", "-1"], "15 4-mode independence MH",
         (K2A, K2B)),
        ([*short, "--ot-cond-flow"], "16 4-mode OT coupling", (K2A, K2B)),
        (["--example", "phi-four", "--do-smc", "--learning-iter", "1000"], "17 phi-four SMC",
         (K3, K2A)),
        (["--example", "pines", "--do-smc", "--learning-iter", "500"], "18 pines SMC", (K2A,)),
        (["--example", "phi-four", "--mcmc-kernel", "nuts", "--learning-iter", "100"],
         "19 phi-four NUTS", (K3, GATE, K2A)),
        (["--example", "4-mode", "--do-smc", "--mcmc-kernel", "hmc", "--set", "smc_path=geometric",
          "--set", "waste_free_p=4", "--learning-iter", "200"], "20 4-mode HMC waste-free SMC",
         (K2A, K2B)),
        (["--example", "pines", "--learning-iter", "120", "--flow-smc", "4"], "21 pines flow-SMC",
         (K2A,)),
    ]
    for argv, label, must in phases:
        before = [f.launches for f in counters]
        routes = dict(pairwise.stein_pairwise_sum.route_counts)
        run_cli(["--seed", "0", *argv], label)
        n = {f.__name__: f.launches - b for f, b in zip(counters, before)}
        took = {k: v - routes[k] for k, v in pairwise.stein_pairwise_sum.route_counts.items()}
        print(f"[{label.split()[0]} launches] " + " ".join(f"{k}={v}" for k, v in n.items())
              + f"; K2a routes {took}", flush=True)
        missing = [k for k in must if not n[k]]
        if missing:
            fail(f"{label}: the run launched no {', '.join(missing)}")
    launches = {f.__name__: f.launches for f in counters}
    print(f"[main path launches] {json.dumps(launches)}", flush=True)
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
        "phi_four_score_gate": ("mfm_tpu_torch/csrc/phi_four.cu",
                                "mfm_tpu/ops/phi_four_pallas.py:58 with the score's jax.jvp "
                                "(mfm_tpu/flows/cnf.py:72)"),
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
