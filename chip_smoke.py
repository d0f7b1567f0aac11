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
   0.5, and K3 through PhiFour.value_and_score, back to back (the pace of
   its launcher) and queued behind a spin at (1024, 64) (its device time,
   cold in the L2 and warm; the time reported); the phi-four score gate
   with 64 tangents at (1024, 64) Dirichlet, periodic, tilted, clipped
   at (37, 64), and at (256, 2048) Dirichlet (rows wider than 1024 sites
   take its one-warp-a-row kernel), timed with its inputs cold in the L2
   (and warm) and its
   launches queued behind a spin (device time, not host dispatch); errors
   and CUDA-event times of kernel and plain version, and each kernel's
   bound (the larger of its operations over the card's peak rate and its
   bytes over the memory rate; for K2a and K2b over the pairs any
   implementation must visit, with the special-function pipe as a third
   rate); K1's achieved TFLOP/s
   and its share of the fp32 FMA bound and of the 3xTF32 tensor-core bound;
4. one forward + inverse transport through K1 against the same transport
   through the module field (its tangent pass), B=1024, d=64, both with
   PhiFour's fused score gate: x, u and logdet; the fused score gate of a
   stage against the generic route (vmap(jvp) of the K3-backed score), and
   that score's tangent over the 64 basis vectors against jvp(grad(...))
   of an autodiff stencil that shares no code with it, B=1024, d=64, with
   the times; then, with a large gate, each path's divergence against the
   trace of the autograd Jacobian of the whole field (score gate
   included), B=16, d=64;
5. the phi-four preset as shipped, through mfm_tpu_torch.cli.main (d=64,
   1024 chains, 128-wide trunks, the bf16 field, exact divergence, 24 RK4
   steps, PhiFour on K3, 50 iterations), with the ESS of the final IS
   weights;
6. the same with the 'phifour' reference (--ref-dist phifour), 50
   iterations;
7. the same with the fused fp32 field (field_precision=highest,
   pallas_field=true), 150 iterations;
8. a 4-mode run through the same entry point (reaches the MMD kernel), 25
   iterations;
9. pines as shipped at full width (d=1600, 128 chains, trunks 1024, the bf16
   field, Hutchinson, the 'prior' reference, Rademacher eval probes), 30
   iterations: K2a at its eval;
10. many-well (d=32, 120 iterations) and 11. funnel (d=10, 25): K2a, and
   K2b's general kernel for the MMD against exact draws;
12. many-well on the fused fp32 field (K1 at d=32), 120 iterations;
13. gaussian-mixture, 15 iterations;
14-16. 4-mode with the CIS flow kernel (4 candidates), with independence
   MH, and with the minibatch-OT coupling, 10 iterations each;
17. the SMC baseline (--do-smc) on phi-four: 1024 particles, d=64, MALA at
   the preset step on K3, systematic resampling, 1000 adaptive tempering
   steps, with its log Z and final lambda;
18. the SMC baseline on pines: d=1600, 128 particles, the Cox target on its
   prior path, 500 steps (K2a at (128, 1600) at its eval);
19. phi-four as shipped with NUTS as the MCMC move (static, depth 6, every
   leapfrog a K3 launch), step and mass adaptation frozen at iteration 30,
   50 iterations;
20. the SMC baseline on 4-mode with HMC on the geometric path, waste-free
   (P=4), 128 particles, 25 steps, 12,800 harvested samples (K2a, K2b);
21. pines as shipped, 15 iterations, then 1 flow-annealed SMC step
   (--flow-smc 1) with latent MALA on 128 particles at d=1600 through the
   transport with its Rademacher probes (a forward and a reverse pass a
   move);
22. the FAB baseline (--do-fab) on phi-four: batch 1024, d=64, 8 spline
   coupling layers with 128x128 gelu conditioners (configs/fab/many_well.yaml
   with the preset's hidden_xt), an HMC bridge of K=4 (every gradient of
   log gamma an autograd pass through the flow and K3's analytic score), 3
   epochs after 3 prefill passes;
23. the flowMC baseline (--do-flowmc) on phi-four: 1024 chains, 5 rounds
   of 10 MALA steps, 10 NLL epochs and 10 flow independence-MH moves;
24. the DDS baseline (--do-dds) on phi-four: batch 1024, 100 checkpointed
   steps of a 128-wide control net gated by the detached K3 score, 10
   iterations (at the preset's learning rate its chain blows up within ten
   iterations, in the reference too: a finite row far off the target);
25. FAB on 4-mode, 5 epochs, 12,800 eval samples (K2a, K2b);
26. pines as shipped, 15 iterations, then 50 self-tuning MALA moves on the
   IS-resampled set (--move-correct 50);
27. many-well, 120 iterations, the IS proposal mixed with 10 % N(0, 4 I)
   (--defensive-alpha 0.9);
28. 4-mode, 10 iterations, 1 flow-SMC step on 12,800 particles, then 25
   MALA moves on the annealed ensemble (--flow-smc 1 --move-correct 25);
29-32. the CLI's 10 replication seeds (no --seed) as one seed sweep
   (--vmap-seeds) at full width, each seed then evaluated on 1,280 samples
   (eval_iter=10): 4-mode 15 iterations (K2a, K2b), phi-four as shipped
   15 (K3, the gate, K2a), phi-four on the fused field 50 (K1 on its seed
   axis, S=10, one launch a stage; K3, the gate, K2a), pines 10 (10 x 128
   chains at d=1600, 1024-wide trunks; K2a); each prints the sweep's host
   ms an iteration, per seed, and its training launches an iteration
   beside the single-seed phase of the same example (5, 7, 8, 9), and
   every seed's row;
33. 4-mode, 10 iterations: --vmap-seeds over seeds 0 and 1 against --seed 0
   and --seed 1 run alone, each row within the stated tolerance;
34. phi-four on the fused field, 30 iterations in chunks of 10 with a
   checkpoint each: run, delete the last checkpoint, run again (resumed at
   20) and hold parameters and chains to the first run's; a run at the
   finished checkpoint returns no metrics;
35-40. the library, driven as Python calls on phi-four at its preset's
   width (d=64, a perturbed fp32 field with trunks (128, 128) x 3, F=128,
   24 RK4 steps, exact divergence, relu, no score gate): every move's
   transport runs on K1, every loss (-log q_flow of the chains, a gradient
   through the inverse transport) on the module field, every density and
   score on K3. 35 ATESS cross-chain (256 chains, 5 steps, one Adam step
   a refit), then one TESS step at its first angle with the fitted flow on
   K1 and on the module field, on the same noise; 36 ATESS by parallel ECA
   (4 batches of 64, 4 steps), then one more update in which the holding
   batch must keep its chains bit for bit; 37 MSC (256 chains, 4 CIS
   candidates: 1,280 rows a transport, 5 steps), then one CIS step's
   log-weights on K1 against the module field; 38 MSC-MALA (256 chains, 4
   MALA steps at 1e-4 a step, 5 steps); 39 SVGD (sgd) and coin-SVGD
   (COCOB), 1,024 particles from phi-four's initial positions, 300 steps
   each, with the KSD-U of each set and of the start (K2a); 40 TESS with
   the identity flow on N(0, I) at d=64 (4,096 chains, 200 steps, the
   pooled second half's moments), CIS with the identity flow on N(0.5,
   0.25), SNPE-A's loss and gradient on 4,096 simulations, and the
   profiling helpers around one TESS step. Each prints its host ms a step
   (with the moves' transports apart), shrink trips or acceptance, peak
   device memory and its launches.
41. the roofline (``mfm_tpu_torch.diagnostics.roofline``): FLOPs and bytes
   of one call counted (the aten ops by flop_counter, the kernels by the
   hand counts their wrappers report), the median of three calls timed,
   and both set against the H100's ceilings, for ensemble MALA on pines'
   Cox target (128 chains, 400 steps), one Hutchinson transport at pines'
   widths (128 rows), the Stein discrepancy of 12,800 4-mode draws on K2a,
   and one exact transport of phi-four on K1 and the fused score gate
   (1,024 rows); each kernel's count must equal its hand count times its
   launches;
42. a 4-mode run at phase 8's configuration and depth, its forward
   transport at the progression figure's five times (t=0 is u, t=1 the
   forward map, 1e-5), then the figures: rendered and counted where
   matplotlib imports, else ``--plots`` refused by name before training;
43. ``python -m mfm_tpu_torch.parallel.run_seeds`` as two processes on the
   card (gloo for the rows; 2 seeds, 20 iterations): one aggregate on both,
   equal within 1e-2 to the same seeds run one after another here (the
   metric columns), under a time limit of its own that kills the children;
44-46. the chain mesh (``parallel.mesh``), two ranks sharing this card
   under gloo, each launcher in a session of its own killed whole on a
   failure or past its limit; the ranks' launches count on the main path.
   44 ``python -m mfm_tpu_torch.parallel.run_mfm --example phi-four`` (the
   reference demo's phi-four: 1,024 chains, 20 iterations): one state
   digest and one chunks digest on both ranks, the final loss, beta and
   mean acceptance within 1e-3 of the same run in this process, K3
   launched on each rank (no flow step comes before iteration 101, so no
   score gate); 45 the CLI under torchrun with ``--set
   mesh_shape=(1,2)`` on phi-four on the fused field (50 iterations,
   eval_iter=10; K1, K3, the gate, K2a at rank 0's eval): the training
   metrics and the flow row within 1e-2 of the same arguments in this
   process (the IS row's differences reported), each rank's host ms an
   iteration, and the gloo round trip of an all-reduce of the gradient's
   size; 46, on phase 45's ranks (one torchrun for both), ``--do-smc``
   on phi-four with ``mesh_shape=(2,)`` (the distributed resampler and the
   ring gather, 200 steps) against one process that replays the ranks'
   ancestors: every step's log Z increment and lambda equal, log Z and
   lambda within 1e-3, and the single-device resampler on the same weights
   differing only by off-by-ones at float32 ties; and two steps of
   ``atess(mesh=)`` by parallel ECA (4 batches of 64) on the ``ensemble``
   axis against the unsharded call, positions within 1e-4;
47-51. the seed bands: the CLI's 10 replication seeds as one sweep
   (``--vmap-seeds``) at each band's reduced configuration (64 chains,
   widths 32, 8 RK4 steps, 512 eval samples a seed), held to the
   reference's rows over the same seeds from
   ``tools/seed_band_reference.json`` (made from the JAX package on the
   CPU by ``tools/seed_band_reference.py``; this script reads only the
   JSON): 47 4-mode (K2a, K2b), 48 gaussian-mixture (K2a, K2b), 49
   phi-four as shipped (K3, the gate, K2a), 50 phi-four on the fused field
   (K1, K3, the gate, K2a), 51 pines as shipped (K2a). Each held column
   (logpdf, KSD-U and their IS-resampled ``*_star``, MMD and MMD* where
   the target has an exact sampler, and the IS estimate of log Z) must lie
   within ci95_ref + ci95_port of the reference's mean (ci95 = 1.96 sigma
   over the seeds) and within 4 standard errors of the difference of the
   means (KSD-U against the reference samples' float64 statistic, which
   K2a computes); each prints both means, the gap, the gap over that
   standard error, the mean ``is_ess`` and ``is_unique`` and its
   launches, and fails on a column outside either limit, a non-finite row
   on either side, or a kernel of its band never launched;
52. many-well as preset (d=32, 128 chains, trunks 128, 24 RK4 steps, exact
   divergence) at 100 iterations over seeds 1000-1059 as one seed sweep,
   each seed sampled on 12,800 latents as the CLI samples it: the share of
   seeds whose flow row is not finite, against the reference's pooled
   share over its committed seeds (``many_well`` and ``many_well_more`` in
   the same JSON), with the two-sided Fisher p; it fails below
   ``MANY_WELL_P_LIMIT``. A paired study on the card over seeds 2000-2999
   (``tools/many_well_paired.py``) found neither the port's step noise nor
   its eval latents apart from the reference's (effects -1.2 and +0.6
   points, McNemar p 0.45-0.85), and the port's share there 53.0 %; the
   limit is the largest at which a port of that share fails in fewer than
   1 run in 200 against the pool, or 0.001 where none does.

Phases 10, 12, 27 and 52 (many-well) and 47-51 (the seed bands) run in two
processes of their own on the card (``chip_smoke.py --beside KIND``),
started after phase 4 beside phases 5-40 and joined after phase 40, where
their lines are printed and their launches added to the main path's; they
time nothing and are held to committed data, so the times that phases
5-40 print are taken with the card shared. Phases 41-46 run after the
join.

Every CLI phase logs under a temporary --run-dir. Phase 3 also holds K1's
seed axis (S=10 nets on 10 x 1024 rows, 64 tangents, one launch) to its
plain version and times it beside 10 single-seed launches.

The iteration counts are a small fraction of the presets' (the depth is cut
so that the whole script stays well inside its time limit on a slow host);
a run this short can still diverge for a few of its 12,800 flow samples,
which makes its row non-finite: many-well does so at 100 iterations for
53.0 % of 1,000 seeds on the card and for 52.0 % of the reference's on 200
of the same seeds (phase 52 counts them), for none of 20 at the preset's
2,000, and its phases 10, 12 and 27 run seed 0 at 120 iterations, where it
does not.

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
import os
import re
import shutil
import subprocess
import sys
import time


def ceilings():
    """The H100 SXM data sheet's rates (``mfm_tpu_torch.diagnostics.roofline``,
    the repository's one table): fp32 outside the tensor cores, TF32 and
    bf16 in them (dense), HBM3. Every bound below is the larger of
    operations / peak and bytes / memory rate, for this run's shapes."""
    from mfm_tpu_torch.diagnostics.roofline import H100

    return H100


def bound(flops, nbytes, peak="fp32"):
    """(bound_ms, bound_by) of ``flops`` operations moving ``nbytes``."""
    ops_ms, bytes_ms = flops / ceilings()[peak] * 1e3, nbytes / ceilings()["hbm"] * 1e3
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
    bound_tc = bound(3 * flops, nbytes, "tf32")[0]
    print(f"[3 K1 tangents K={K} B={B} d={d}] max abs {err_t[0]:.3e} rel {err_t[1]:.3e} "
          f"(tol rel {tol_k1}); kernel {ms_t:.4f} ms, plain {plain_ms_t:.4f} ms "
          f"(kernel {ms_a:.4f} / {ms_b:.4f}, plain {plain_a:.4f} / {plain_b:.4f})", flush=True)
    print(f"[3 K1 work K={K}] {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.1f} MB: "
          f"{flops / ms_t / 1e9:.1f} TFLOP/s; bound {bound_t:.4f} ms at the fp32 FMA peak "
          f"({by_t}), share {bound_t / ms_t:.3f}; 3xTF32 bound {bound_tc:.4f} ms, share "
          f"{bound_tc / ms_t:.3f}; bytes alone {nbytes / ceilings()['hbm'] * 1e3:.4f} ms",
          flush=True)
    if not err_t[1] <= tol_k1:
        fail("K1 with tangents disagrees with its plain version")
    if not ms_t < plain_ms_t:
        fail("K1 with tangents is slower than its plain version")
    seeds = phase_k1_seeds(torch, gen, ms_t, tol_k1)
    # the library's shapes (phases 35-38): the 256 chains of a move, the
    # 1,280 candidates of a CIS step
    library = {}
    for B_lib in (256, 1280):
        x_l = torch.randn((B_lib, d), generator=gen, device=dev)
        t_l = torch.rand(B_lib, generator=gen, device=dev)
        ex_l = torch.randn((K, B_lib, d), generator=gen, device=dev)
        kern = lambda: field.field_apply(packed, layout, "relu", freqs, x_l, t_l, ex_l)
        plain = lambda: field.field_apply_plain(packed, layout, "relu", freqs, x_l, t_l, ex_l)
        err = max(errors(torch, a, b) for a, b in zip(kern(), plain()))
        ms, plain_ms = cuda_ms(torch, kern, 20), cuda_ms(torch, plain, 20)
        bnd, by = bound(field.field_flops(layout, B_lib, K), field.field_bytes(layout, B_lib, K))
        print(f"[3 K1 tangents K={K} B={B_lib} d={d}, the library's shape] max abs {err[0]:.3e} "
              f"rel {err[1]:.3e} (tol rel {tol_k1}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bnd:.4f} ms ({by}), share {bnd / ms:.3f}", flush=True)
        if not err[1] <= tol_k1:
            fail(f"K1 at B={B_lib} disagrees with its plain version")
        library[f"B={B_lib}"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
                                     share_of_bound=bnd / ms, max_abs_err=err[0],
                                     max_rel_err=err[1])
    report["field_apply"] = dict(
        max_abs_err=max(err_p[0], err_t[0], seeds["max_abs_err"],
                        *(v["max_abs_err"] for v in library.values())),
        max_rel_err=max(err_p[1], err_t[1], seeds["max_rel_err"],
                        *(v["max_rel_err"] for v in library.values())),
        ms=ms_t, plain_ms=plain_ms_t, bound_ms=bound_t, bound_by=by_t, library_ms=None,
        flops=flops, share_of_bound=bound_t / ms_t, bound_3xtf32_ms=bound_tc,
        primal_ms=ms_p, primal_plain_ms=plain_ms_p, primal_bound_ms=bound_p,
        shape=f"B={B} d={d} K={K} widths={W} F={F}",
        seed_axis=seeds, library_shapes=library,
    )

    phase_pairwise(torch, report, gen)

    # K3: value and score are fp32 sums of d terms (warp shuffles against
    # torch's reduction) and one stencil per site; 1e-5 relative to each
    # output's largest entry. The first case is the main path's shape, whose
    # times are reported.
    tol_k3 = 1e-5
    k3 = {"max_abs_err": 0.0, "max_rel_err": 0.0}
    for B3, D3, pbc, bc in ((1024, 64, False, 0.0), (1024, 64, True, 0.0), (37, 64, False, 0.5),
                            (256, 64, False, 0.0), (1280, 64, False, 0.0)):  # the library's
        x = 1.5 * torch.randn((B3, D3), generator=gen, device=dev)
        args = (0.1, 20.0, pbc, bc)
        kern = lambda: phi_four.phi_four_value_and_score(x, *args)
        plain = lambda: phi_four.phi_four_value_and_score_plain(x, *args)
        (v_k, s_k), (v_p, s_p) = kern(), plain()
        v_only, no_score = phi_four.phi_four_value_and_score(x, *args, with_score=False)
        torch.cuda.synchronize()
        err = max(errors(torch, v_k, v_p), errors(torch, s_k, s_p))
        ms, plain_ms = cuda_ms(torch, kern, 50), cuda_ms(torch, plain, 50)
        bnd, by = bound(*phi_four.phi_four_cost(B3, D3))
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
    # its device time at the main path's shape: launches queued behind a
    # spin, cold (each reads the next of enough copies of x, by x's own
    # bytes, to fill the L2 twice; the outputs come back in the allocator's
    # same blocks and may stay in the L2) and warm (one copy)
    copies = [x.clone() for _ in range(math.ceil(2 * L2_BYTES / (x.numel() * x.element_size())))]
    turn = [0]

    def cold(fn):
        def call():
            turn[0] += 1
            return fn(copies[turn[0] % len(copies)])
        return call

    k3["ms"] = cuda_ms(torch, cold(phi_four.phi_four_value_and_score), 200, True)
    k3["plain_ms"] = cuda_ms(torch, cold(phi_four.phi_four_value_and_score_plain), 20, True)
    k3["warm_ms"] = cuda_ms(torch, lambda: phi_four.phi_four_value_and_score(x), 200, True)
    k3["share_of_bound"] = k3["bound_ms"] / k3["ms"]
    print(f"[3 K3 back to back B=1024 d=64] PhiFour.value_and_score {k3['target_ms']:.4f} ms, "
          f"phi_four_value_and_score {k3['launcher_ms']:.4f} ms; queued (device time): "
          f"cold {k3['ms']:.4f} ms ({len(copies)} copies of x), warm {k3['warm_ms']:.4f} ms, "
          f"plain cold {k3['plain_ms']:.4f} ms; bound {k3['bound_ms']:.6f} ms "
          f"({k3['bound_by']}), share {k3['share_of_bound']:.3f}", flush=True)
    report["phi_four_value_and_score"] = k3
    phase_score_gate(torch, report, gen)


def phase_k1_seeds(torch, gen, single_ms, tol):
    """K1's seed axis at a seed sweep's shape: S=10 nets (every parameter
    perturbed, different by seed) on 10 x 1024 seed-major rows, d=64, widths
    128, F=128, 64 tangents, one launch; against the plain version seed by
    seed, and timed beside S single-seed launches of the same work."""
    from mfm_tpu_torch.ops import field

    S, B, d, W, F, K = 10, 1024, 64, 128, 128, 64
    nets = [perturbed_net(torch, d, W, F, None, seed=10 + s)[1] for s in range(S)]
    stacked = {k: torch.stack([p[k] for p in nets]) for k in nets[0]}
    layout = field.field_layout(nets[0], F)
    packed = field.pack_field_params(stacked, layout)
    freqs = torch.randn((S, F), generator=gen, device="cuda")
    x = torch.randn((S * B, d), generator=gen, device="cuda")
    t = torch.rand(S * B, generator=gen, device="cuda")
    ex = torch.randn((K, S * B, d), generator=gen, device="cuda")
    kern = lambda: field.field_apply(packed, layout, "relu", freqs, x, t, ex)
    plain = lambda: field.field_apply_plain(packed, layout, "relu", freqs, x, t, ex)
    out_k, out_p = kern(), plain()
    torch.cuda.synchronize()
    err = max(errors(torch, a, b) for a, b in zip(out_k, out_p))
    one = [packed[0].contiguous(), freqs[0].contiguous(), x[:B], t[:B], ex[:, :B].contiguous()]
    single = lambda: field.field_apply(one[0], layout, "relu", one[1], *one[2:])
    ms_a, single_a = cuda_ms(torch, kern, 10), cuda_ms(torch, single, 20)
    single_b, ms_b = cuda_ms(torch, single, 20), cuda_ms(torch, kern, 10)
    ms, single_ms_now = min(ms_a, ms_b), min(single_a, single_b)
    plain_ms = cuda_ms(torch, plain, 3)
    flops, nbytes = field.field_flops(layout, S * B, K), field.field_bytes(layout, B, K, S)
    bnd, by = bound(flops, nbytes)
    print(f"[3 K1 seed axis S={S} B={B} d={d} K={K}] max abs {err[0]:.3e} rel {err[1]:.3e} "
          f"(tol rel {tol}); one launch {ms:.4f} ms ({ms_a:.4f} / {ms_b:.4f}), plain "
          f"{plain_ms:.4f} ms; S x the single-seed launch {S * single_ms_now:.4f} ms "
          f"({single_ms_now:.4f} each, {single_ms:.4f} in the tangent case above); bound "
          f"{bnd:.4f} ms ({by}), share {bnd / ms:.3f}", flush=True)
    if not err[1] <= tol:
        fail("K1's seed axis disagrees with its plain version")
    return dict(S=S, shape=f"S={S} B={B} d={d} K={K} widths={W} F={F}", ms=ms,
                plain_ms=plain_ms, bound_ms=bnd, bound_by=by, share_of_bound=bnd / ms,
                single_seed_x_S_ms=S * single_ms_now, max_abs_err=err[0], max_rel_err=err[1])


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


def pair_bound(torch, pairs, flops, nbytes):
    """The bound of a pairwise sum over ``pairs`` pairs that any
    implementation must visit (``ops.pairwise.stein_cost``, ``rbf_cost``):
    the largest of its bytes over the memory rate, one special-function
    operation a pair over that pipe's rate, and its multiply-adds over the
    fp32 FMA peak. Beside it, what three TF32 passes on the tensor cores
    would need (fp32's accuracy too): the floor of the Gram route, which
    may yet come in under the fp32 bound."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    peak = ceilings()
    parts = {
        "bytes": nbytes / peak["hbm"] * 1e3,
        "special-function": pairs / (SFU_PER_CLOCK_SM * n_sm * sm_clock_hz()) * 1e3,
        "fp32": flops / peak["fp32"] * 1e3,
        "3xtf32": 3 * flops / peak["tf32"] * 1e3,
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
            bnd = pair_bound(torch, *pairwise.stein_cost(T, D))
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
        bnd = pair_bound(torch, pairs, *pairwise.rbf_cost(pairs, n_sets * T, D))
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
        # rows wider than 1024 sites take the one-warp-a-row kernel
        ("wide", 256, 2048, {}),
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
        flops, nbytes = phi_four.score_gate_cost(B, d, K)
        bnd, by = bound(flops, nbytes)
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
        out.update(max_abs_err=max(out["max_abs_err"], err[0]),
                   max_rel_err=max(out["max_rel_err"], err[1]),
                   ms=out.get("ms", ms), plain_ms=out.get("plain_ms", plain_ms),
                   bound_ms=out.get("bound_ms", bnd), bound_by=out.get("bound_by", by),
                   library_ms=None, share_of_bound=out.get("share_of_bound", bnd / ms),
                   warm_ms=out.get("warm_ms", warm_ms), shape=f"B=1024 d=64 K={K} dirichlet")
        if label == "wide":
            out["wide"] = dict(shape=f"B={B} d={d} K={K} dirichlet", ms=ms, plain_ms=plain_ms,
                               bound_ms=bnd, bound_by=by, share_of_bound=bnd / ms,
                               max_abs_err=err[0], max_rel_err=err[1])
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


# the training loop's launches and train_time of the last run_mfm or
# run_mfm_seeds call the CLI made (``instrument_training``)
TRAINING = {}
# the fused fp32 field: K1 in every transport
FUSED = ["--set", "field_precision=highest", "--set", "pallas_field=true"]


def launch_counters():
    """The five kernels' wrappers, whose ``launches`` count the main path."""
    from mfm_tpu_torch.ops import field, pairwise, phi_four

    return (field.field_apply, pairwise.stein_pairwise_sum, pairwise.rbf_kernel_sum,
            phi_four.phi_four_value_and_score, phi_four.phi_four_score_gate)


def instrument_training(counters):
    """Wrap the CLI's ``run_mfm`` and ``run_mfm_seeds`` so that each call
    records its kernels' launches (training and its warm-up, not the eval)
    and its train_time in ``TRAINING``."""
    from mfm_tpu_torch import cli

    def wrap(fn):
        def recorded(*args, **kwargs):
            before = [f.launches for f in counters]
            out = fn(*args, **kwargs)
            TRAINING["launches"] = {f.__name__: f.launches - b for f, b in zip(counters, before)}
            TRAINING["train_time"] = out.train_time
            if out.metrics and out.metrics["loss"].ndim == 1:  # one run, not a sweep
                import torch

                TRAINING["summary"] = training_summary(torch, out)
            return out
        return recorded

    cli.run_mfm, cli.run_mfm_seeds = wrap(cli.run_mfm), wrap(cli.run_mfm_seeds)


def run_cli(argv, label, run_dir):
    from mfm_tpu_torch import cli

    TRAINING.clear()
    t0 = time.perf_counter()
    (m,) = cli.main([*argv, "--run-dir", run_dir])
    wall = time.perf_counter() - t0
    row = {k: m[k] for k in ("logpdf", "stein_u", "stein_v", "mmd", "logpdf_star",
                             "stein_u_star", "stein_v_star", "mmd_star")}
    weights = ("no importance weights (SMC harvest)" if m["is_ess"] is None else
               f"IS ESS {m['is_ess']:.3f}, {m['is_unique']} distinct resampled points")
    extra = {k: m[k] for k in ("log_z", "lmbda", "step_size", "flow_smc_log_z",
                               "flow_smc_lmbda", "flow_smc_ess_fraction", "flow_smc_time",
                               "log_z_is", "is_ess_frac", "final_loss", "mean_accept",
                               "mean_global_accept", "log_z_alpha2", "defensive_n_flow")
             if k in m}
    print(f"[{label}] row {json.dumps(row)} metrics_kernel={m['metrics_kernel']} {weights}; "
          f"train_time {m['train_time']:.3f} s, {m['it_per_s']:.2f} it/s "
          f"({1e3 / m['it_per_s']:.2f} host ms a step), wall {wall:.1f} s; {json.dumps(extra)}",
          flush=True)
    if not all(math.isfinite(v) for v in (*row.values(), *extra.values())):
        fail(f"{label}: non-finite metric row")
    return m


ROW = ("logpdf", "stein_u", "stein_v", "mmd", "logpdf_star", "stein_u_star", "stein_v_star",
       "mmd_star")


def run_cli_seeds(argv, label, run_dir, single):
    """One ``--vmap-seeds`` run of the CLI over its 10 replication seeds:
    every seed's row finite; host ms an iteration of the sweep and per seed,
    and the training's launches an iteration, beside ``single`` (the
    TRAINING record and iterations of the same example's single-seed
    phase)."""
    from mfm_tpu_torch import cli

    TRAINING.clear()
    t0 = time.perf_counter()
    rows = cli.main([*argv, "--vmap-seeds", "--run-dir", run_dir])
    wall = time.perf_counter() - t0
    iters = int(argv[argv.index("--learning-iter") + 1])
    S = len(rows)
    sweep_ms = 1e3 * TRAINING["train_time"] / iters
    per_it = {k: v / iters for k, v in TRAINING["launches"].items()}
    one_ms = 1e3 * single["train_time"] / single["iters"]
    one_it = {k: v / single["iters"] for k, v in single["launches"].items()}
    fmt = lambda d: " ".join(f"{k}={v:.1f}" for k, v in d.items())
    print(f"[{label}] {S} seeds: sweep train_time {TRAINING['train_time']:.3f} s over {iters} its = "
          f"{sweep_ms:.2f} host ms an iteration for all seeds, {sweep_ms / S:.2f} per seed "
          f"(single-seed phase {single['label']}: {one_ms:.2f}); wall {wall:.1f} s; training "
          f"launches an iteration {fmt(per_it)} (single seed: {fmt(one_it)})", flush=True)
    print(f"[{label.split()[0]} rows] " + json.dumps(
        {k: [round(float(m[k]), 5) for m in rows] for k in ROW + ("is_ess",)}), flush=True)
    if S != 10 or not all(math.isfinite(m[k]) for m in rows for k in ROW):
        fail(f"{label}: {S} seeds, or a non-finite metric row")
    return dict(sweep_ms=sweep_ms, per_seed_ms=sweep_ms / S, single_ms=one_ms,
                launches_per_it=per_it, single_launches_per_it=one_it, wall=wall)


def run_phases(counters, phases, run_dir, single, sweeps):
    """The CLI phases ``(argv, label, must[, single-seed label])``: each
    prints its launches and K2a's routes and fails if it launched none of a
    kernel in ``must``; a single-seed run's training record goes into
    ``single``, a sweep's comparison with it into ``sweeps``."""
    from mfm_tpu_torch.ops import pairwise

    for argv, label, must, *alone in phases:
        before = [f.launches for f in counters]
        routes = dict(pairwise.stein_pairwise_sum.route_counts)
        if alone:
            sweeps[label] = run_cli_seeds(argv, label, run_dir, single[alone[0]])
        else:
            run_cli(["--seed", "0", *argv], label, run_dir)
            if TRAINING:
                single[label] = dict(TRAINING, label=label,
                                     iters=int(argv[argv.index("--learning-iter") + 1]))
        n = {f.__name__: f.launches - b for f, b in zip(counters, before)}
        took = {k: v - routes[k] for k, v in pairwise.stein_pairwise_sum.route_counts.items()}
        print(f"[{label.split()[0]} launches] " + " ".join(f"{k}={v}" for k, v in n.items())
              + f"; K2a routes {took}", flush=True)
        missing = [k for k in must if not n[k]]
        if missing:
            fail(f"{label}: the run launched no {', '.join(missing)}")


def phase_seed_equality(torch, run_dir):
    """4-mode, 10 iterations: ``--vmap-seeds`` over seeds 0 and 1 (the CLI's
    sweep and per-seed evaluation) against ``--seed 0`` and ``--seed 1`` run
    alone. On the CPU the two give the same bits (tests/test_torch_multi_seed.py);
    on the card the seed axis batches the field's fp32 products (a batched
    cuBLAS product against an unbatched one, another order of the same
    sums), whose rounding the AdamW steps carry into the trained flow: rows
    to 1e-2 relative (3.6e-4 at 20 iterations on an H100 80GB HBM3). Another seed's row is 3-40 % away,
    and a wrong seed, noise stream or evaluation would be too."""
    import argparse

    from mfm_tpu_torch import cli
    from mfm_tpu_torch.config import preset

    dev = torch.device("cuda")
    cfg = preset("4-mode", learning_iter=10, mcmc_per_flow_steps=10.0, num_importance_samples=0,
                 mcmc_kernel="mala", eval_iter=10)
    args = argparse.Namespace(run_dir=run_dir, wandb=False, pallas_metrics=None, plots=False)
    target = cli.EXAMPLES["4-mode"](device=dev)
    swept = cli.run_seeds_vmapped(target, cfg, [0, 1], dev, args)
    worst, where = 0.0, None
    for seed, row in zip((0, 1), swept):
        cfg.seed = seed
        alone = cli.run_one(target, cfg, dev)
        for k in ROW:
            rel = abs(row[k] - alone[k]) / max(abs(alone[k]), 1e-6)
            if rel >= worst:
                worst, where = rel, f"{k} of seed {seed}: {row[k]:.6g} against {alone[k]:.6g}"
    print(f"[33 seed equality] 4-mode 10 its, --vmap-seeds over seeds 0, 1 against each alone: "
          f"max relative difference of the rows {worst:.3e} (tol 1e-2), at {where}", flush=True)
    if not worst <= 1e-2:
        fail("a seed of the sweep disagrees with its run alone")
    return worst


def phase_resume(torch, ckpt_dir):
    """phi-four on the fused field, 30 iterations in chunks of 10 with a
    checkpoint each: run, delete step 30, run again (it resumes at 20) and
    hold its parameters and chains to the first run's; the same kernels on
    the same inputs, so equal bits are expected, and 1e-6 is the stated
    tolerance. A run started at the finished checkpoint returns no
    metrics."""
    import os
    import shutil

    from mfm_tpu_torch.config import preset
    from mfm_tpu_torch.drivers import run_mfm
    from mfm_tpu_torch.targets import PhiFour
    from mfm_tpu_torch.utils.checkpoint import latest_step

    cfg = preset("phi-four", seed=0, learning_iter=30, chunk_size=10, field_precision="highest",
                 pallas_field=True, checkpoint_dir=ckpt_dir, checkpoint_every_chunks=1)
    target = PhiFour(64)
    first = run_mfm(target, cfg, "cuda")
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(ckpt_dir))
    shutil.rmtree(os.path.join(ckpt_dir, "step_00000030"))
    resumed_at = latest_step(ckpt_dir)
    second = run_mfm(target, cfg, "cuda")
    diff = max(float(torch.max(torch.abs(second.train.params[k] - v)))
               for k, v in first.train.params.items())
    diff_x = float(torch.max(torch.abs(second.chain.position - first.chain.position)))
    ran = {k: tuple(v.shape) for k, v in second.metrics.items()}
    third = run_mfm(target, cfg, "cuda")
    print(f"[34 resume] phi-four fused 30 its, chunk 10: checkpoints {steps}; resumed at "
          f"{resumed_at}, ran {ran.get('loss')}; max abs difference to the whole run: "
          f"parameters {diff:.3e}, positions {diff_x:.3e} (tol 1e-6); a run at the finished "
          f"checkpoint returned metrics {third.metrics}", flush=True)
    if not (steps == [10, 20, 30] and resumed_at == 20 and ran.get("loss") == (10,)
            and diff <= 1e-6 and diff_x <= 1e-6 and third.metrics == {}):
        fail("the resumed run is not the whole run")
    return max(diff, diff_x)


# The library phases (35-40): chains, steps and particles (depth; the
# widths and d are phi-four's preset: d=64, trunks (128, 128) x 3, F=128,
# 24 RK4 steps, exact divergence, relu, fp32, no score gate)
LIB = dict(d=64, width=128, fourier=128, chains=256, atess_steps=5, eca_batches=4,
           eca_batch_size=64, eca_steps=4, msc_steps=5, cis_samples=4, mala_samples=4,
           mala_step=1e-4, svgd_particles=1024, svgd_steps=300, tess_chains=4096,
           tess_steps=200, cis_chains=512, snpe_sims=4096)


class Counted:
    """A batched density that counts its calls: a TESS step calls it
    2 + (shrink loop trips) times."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, x):
        self.calls += 1
        return self.fn(x)


def library_flows(torch, dev="cuda"):
    """phi-four and one flow on two fields: the move's transport on K1, the
    loss's on the module field (a gradient through a transport, which K1
    refuses). The parameters are perturbed, so the flow is not the
    identity."""
    from mfm_tpu_torch.flows import kernel_tangent_field, make_transport, module_tangent_field
    from mfm_tpu_torch.targets import PhiFour

    net, params = perturbed_net(torch, LIB["d"], LIB["width"], LIB["fourier"], None, seed=3)
    k_tr = make_transport(kernel_tangent_field(net), divergence="exact", n_steps=24)
    m_tr = make_transport(module_tangent_field(net), divergence="exact", n_steps=24)

    moves = dict(transports=0, secs=0.0)

    def flow(u, p):  # the move, through K1; its host time, to the end of its launches
        t0 = time.perf_counter()
        with torch.no_grad():
            out = k_tr.forward(p, u)
        torch.cuda.synchronize()
        moves["transports"] += 1
        moves["secs"] += time.perf_counter() - t0
        return out

    def module_flow(u, p):
        with torch.no_grad():
            return m_tr.forward(p, u)

    def loss(p, positions):  # -log q_flow(positions) + const, through the module field
        u, logdet = m_tr.inverse(p, positions)
        return torch.mean(0.5 * torch.sum(u * u, dim=-1) + logdet)

    return dict(target=PhiFour(LIB["d"]), params=params, flow=flow, module_flow=module_flow,
                loss=loss, moves=moves)


def split_time(lib, secs):
    """How ``secs`` of a run split between the moves' K1 transports and the
    rest (the refits' loss steps, the draws)."""
    m = lib["moves"]
    return (f"moves: {m['transports']} K1 transports in {m['secs']:.2f} s "
            f"({1e3 * m['secs'] / max(m['transports'], 1):.1f} ms each), the rest (refits, "
            f"draws) {secs - m['secs']:.2f} s")


def finite(torch, *trees):
    from torch.utils._pytree import tree_leaves

    return all(bool(torch.isfinite(v).all()) for t in trees for v in tree_leaves(t)
               if isinstance(v, torch.Tensor) and v.is_floating_point())


def flow_agreement(torch, lib, p, u, k_values, m_values, label):
    """K1 against the module field at the same pullback points ``u``: x to
    1e-4 and logdet to 1e-3 absolute (phase 4's tolerances), and the
    target-scored values built on them (TESS slice values, CIS log-weights)
    to 1e-5 relative: phi-four's log-density is O(1e3-1e5) here, where one
    fp32 ulp is already 1e-4-1e-2, so 1e-3 absolute cannot hold there."""
    xk, ldk = lib["flow"](u, p)
    xm, ldm = lib["module_flow"](u, p)
    ex, eld = errors(torch, xk, xm)[0], errors(torch, ldk, ldm)[0]
    same_inf = torch.equal(torch.isinf(k_values), torch.isinf(m_values))
    fin = torch.isfinite(m_values)
    ev_abs, ev_rel = errors(torch, k_values[fin], m_values[fin])
    print(f"[{label} K1 vs module] max abs x {ex:.3e} (tol 1e-4), logdet {eld:.3e} (tol 1e-3); "
          f"values max abs {ev_abs:.3e}, rel {ev_rel:.3e} (tol rel 1e-5) at |value| up to "
          f"{float(m_values[fin].abs().max()):.1f}", flush=True)
    if not (ex <= 1e-4 and eld <= 1e-3 and ev_rel <= 1e-5 and same_inf):
        fail(f"{label}: the K1 flow disagrees with the module-field flow")


def library_phase(torch, counters, label, must, fn):
    """Run one library phase: its kernels' launches, peak device memory and
    wall; it fails if it launched none of a kernel it names."""
    before = [f.launches for f in counters]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = {f.__name__: f.launches - b for f, b in zip(counters, before)}
    print(f"[{label.split()[0]} launches] " + " ".join(f"{k}={v}" for k, v in n.items())
          + f"; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; wall {wall:.1f} s",
          flush=True)
    missing = [k for k in must if not n[k]]
    if missing:
        fail(f"{label}: launched no {', '.join(missing)}")
    return dict(launches=n, wall=wall, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                result=result)


def phase_atess(torch, lib, dev="cuda"):
    """35: ATESS cross-chain on phi-four; then one TESS step at its first
    angle with the fitted flow on K1 and on the module field."""
    from mfm_tpu_torch.adaptation import atess
    from mfm_tpu_torch.flows import adam
    from mfm_tpu_torch.kernels import tess

    B, d, steps = LIB["chains"], LIB["d"], LIB["atess_steps"]
    gen = torch.Generator(device=dev).manual_seed(35)
    logp = Counted(lib["target"].log_prob)
    algo = atess(logp, adam(1e-3), lib["params"], lib["flow"], lib["loss"], 1, B,
                 num_steps=steps)
    t0 = time.perf_counter()
    state, kernel_fn, fitted = algo.run(gen, torch.randn((B, d), generator=gen, device=dev))
    secs = time.perf_counter() - t0
    trips = logp.calls / steps - 2
    split = split_time(lib, secs)
    new, info = kernel_fn(gen, state.states)  # the refitted kernel moves once more
    print(f"[35 atess cross-chain] {B} chains, {steps} steps, adam(1e-3), 1 loss step each: "
          f"{1e3 * secs / steps:.1f} host ms a step ({split}); {trips:.1f} shrink loop trips a step; "
          f"the refitted kernel's step: mean subiter {float(info.subiter.float().mean()):.2f}, "
          f"max {int(info.subiter.max())}", flush=True)
    if not finite(torch, state.states, fitted, new):
        fail("35: non-finite chains or parameters")
    noise = tess.draw_noise(gen, B, d, 0)
    first = tess.build_kernel(max_subiter=0)  # no shrinking: the slice at the first angle
    sk, ik = first(state.states, lib["target"].log_prob, lambda u: lib["flow"](u, fitted), noise)
    sm, im = first(state.states, lib["target"].log_prob,
                   lambda u: lib["module_flow"](u, fitted), noise)
    flow_agreement(torch, lib, fitted, sk.pullback_position, ik.slice_value, im.slice_value,
                   "35 first-angle slice")
    return dict(ms=1e3 * secs / steps, trips=trips)


def phase_atess_eca(torch, lib, dev="cuda"):
    """36: ATESS by parallel ECA; then one more update, in which the holding
    batch (step % num_batch) must keep its chains bit for bit."""
    from mfm_tpu_torch.adaptation import atess
    from mfm_tpu_torch.adaptation.atess import base
    from mfm_tpu_torch.flows import adam
    from mfm_tpu_torch.kernels import tess

    nb, bs, d, steps = LIB["eca_batches"], LIB["eca_batch_size"], LIB["d"], LIB["eca_steps"]
    gen = torch.Generator(device=dev).manual_seed(36)
    logp = Counted(lib["target"].log_prob)
    algo = atess(logp, adam(1e-3), lib["params"], lib["flow"], lib["loss"], nb, bs,
                 num_steps=steps, eca=True)
    t0 = time.perf_counter()
    state, kernel_fn, params = algo.run(gen, torch.randn((nb, bs, d), generator=gen, device=dev))
    secs = time.perf_counter() - t0
    moves = steps * (nb - 1)
    trips = logp.calls / moves - 2
    split = split_time(lib, secs)
    kernel = tess.build_kernel()

    def kernel_factory(p, opt_state):
        return lambda noise, s: kernel(s, lib["target"].log_prob,
                                       lambda u: lib["flow"](u, p), noise)

    _, update, _ = base(kernel_factory, adam(1e-3), lib["loss"], nb, bs, n_opt_iter=1, eca=True)
    after, _, _ = update(gen, state, *params)
    holder = state.step % nb
    kept = torch.equal(after.states.position[holder], state.states.position[holder])
    moved = [b for b in range(nb) if b != holder
             and not torch.equal(after.states.position[b], state.states.position[b])]
    print(f"[36 atess eca] {nb} batches x {bs} chains, {steps} steps: {1e3 * secs / steps:.1f} "
          f"host ms a step ({nb} refits, {nb - 1} moves; {split}); {trips:.1f} shrink loop trips "
          f"a move; "
          f"step {state.step}: holding batch {holder} kept its chains bit for bit: {kept}, "
          f"batches moved {moved}", flush=True)
    if kernel_fn is not None or not finite(torch, state.states, params, after.states):
        fail("36: a kernel under eca, or non-finite chains or parameters")
    if not (kept and len(moved) == nb - 1):
        fail("36: the holding batch moved, or another batch did not")
    return dict(ms=1e3 * secs / steps, trips=trips)


def cis_acceptance(torch, infos, final_pullback):
    """The share of chains that took a fresh candidate, from each step's
    current point (candidate 0) and the next step's."""
    cur = infos.pullback_positions[:, :, 0]  # (steps, B, d)
    nxt = torch.cat([cur[1:], final_pullback[None]], dim=0)
    return float((cur != nxt).any(-1).float().mean())


def phase_msc(torch, lib, dev="cuda"):
    """37: MSC (CIS through K1, B (N+1) rows a transport); then one CIS step
    with the fitted flow on K1 and on the module field, on the same noise."""
    from mfm_tpu_torch.adaptation import msc
    from mfm_tpu_torch.flows import adam
    from mfm_tpu_torch.kernels import cis

    B, d, N, steps = LIB["chains"], LIB["d"], LIB["cis_samples"], LIB["msc_steps"]
    gen = torch.Generator(device=dev).manual_seed(37)
    algo = msc(lib["target"].log_prob, adam(1e-3), lib["params"], lib["flow"], lib["loss"], B,
               num_steps=steps, num_importance_samples=N)
    t0 = time.perf_counter()
    state, kernel_fn, fitted, infos = algo.run(gen, torch.randn((B, d), generator=gen,
                                                                device=dev))
    secs = time.perf_counter() - t0
    acc = cis_acceptance(torch, infos, state.states.pullback_position)
    print(f"[37 msc] {B} chains, {N} candidates ({B * (N + 1)} rows a transport), {steps} steps: "
          f"{1e3 * secs / steps:.1f} host ms a step ({split_time(lib, secs)}); CIS acceptance "
          f"{acc:.4f}", flush=True)
    if not finite(torch, state.states, fitted) or infos.log_weights.isnan().any():
        fail("37: non-finite chains, parameters or a NaN log-weight")
    noise = cis.draw_noise(gen, B, N, d)
    kernel = cis.build_kernel(N)
    sk, ik = kernel(state.states, lib["target"].log_prob, lambda u: lib["flow"](u, fitted), noise)
    sm, im = kernel(state.states, lib["target"].log_prob,
                    lambda u: lib["module_flow"](u, fitted), noise)
    flow_agreement(torch, lib, fitted, ik.pullback_positions.reshape(-1, d),
                   ik.log_weights.reshape(-1), im.log_weights.reshape(-1), "37 CIS log-weights")
    return dict(ms=1e3 * secs / steps, acceptance=acc)


def phase_msc_mala(torch, lib, dev="cuda"):
    """38: MSC-MALA: a K1 transport of fresh draws, then MALA steps on K3."""
    from mfm_tpu_torch.adaptation import msc_mala
    from mfm_tpu_torch.flows import adam

    B, steps, n = LIB["chains"], LIB["msc_steps"], LIB["mala_samples"]
    target = lib["target"]
    gen = torch.Generator(device=dev).manual_seed(38)
    algo = msc_mala(target.value_and_score, adam(1e-3), lib["params"], lib["flow"], lib["loss"],
                    B, LIB["mala_step"], num_steps=steps, num_mala_samples=n)
    t0 = time.perf_counter()
    state, kernel_fn, fitted, infos = algo.run(gen, target.init_positions(gen, B))
    secs = time.perf_counter() - t0
    acc = float(infos.acceptance_rate.mean())
    print(f"[38 msc-mala] {B} chains, {n} MALA steps a step at {LIB['mala_step']}, {steps} steps: "
          f"{1e3 * secs / steps:.1f} host ms a step ({split_time(lib, secs)}); MALA acceptance "
          f"{acc:.4f}", flush=True)
    if not finite(torch, state.states, fitted):
        fail("38: non-finite chains or parameters")
    return dict(ms=1e3 * secs / steps, acceptance=acc)


def phase_svgd(torch, lib, dev="cuda"):
    """39: SVGD (sgd) and coin-SVGD (COCOB) on phi-four from its initial
    positions; the KSD-U of each particle set and of the start (K2a)."""
    from mfm_tpu_torch.drivers.eval import evaluate_samples
    from mfm_tpu_torch.flows import sgd
    from mfm_tpu_torch.vi import coin_svgd, svgd

    target, N, steps = lib["target"], LIB["svgd_particles"], LIB["svgd_steps"]
    gen = torch.Generator(device=dev).manual_seed(39)
    x0 = target.init_positions(gen, N)
    out = {}
    for name, algo in (("svgd sgd(1e-3)", svgd(target.score, sgd(1e-3))),
                       ("coin-svgd", coin_svgd(target.score))):
        state = algo.init(x0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            state = algo.step(state)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        m = evaluate_samples(target, state.particles, x0)
        print(f"[39 {name}] {N} particles, {steps} steps: {1e3 * secs / steps:.2f} host ms a step; "
              f"KSD-U {m['stein_u']:.6g} (initial positions {m['stein_u_star']:.6g}), logpdf "
              f"{m['logpdf']:.6g} ({m['logpdf_star']:.6g}); length scale "
              f"{float(state.kernel_parameters['length_scale']):.6g}", flush=True)
        if not (finite(torch, state.particles) and math.isfinite(m["stein_u"])):
            fail(f"39 {name}: non-finite particles or KSD")
        out[name] = dict(ms=1e3 * secs / steps, ksd_u=m["stein_u"], ksd_u_initial=m["stein_u_star"])
    return out


def phase_library_checks(torch, trace_dir, dev="cuda"):
    """40: TESS invariance and CIS with the identity flow on the card, as the
    reference's tests ask; SNPE-A's loss and gradient; the profiling
    helpers around one TESS step."""
    import os

    from mfm_tpu_torch.kernels import cis, tess
    from mfm_tpu_torch.sbi import SNPE_A
    from mfm_tpu_torch.targets import IndepGaussian
    from mfm_tpu_torch.utils import profiling

    gen = torch.Generator(device=dev).manual_seed(40)
    identity = lambda u: (u, torch.zeros(u.shape[:1], device=u.device))
    B, d, steps = LIB["tess_chains"], LIB["d"], LIB["tess_steps"]
    target = IndepGaussian(d)
    kernel = tess.build_kernel()
    state = tess.init(torch.randn((B, d), generator=gen, device=dev))
    pool, trips = [], []
    t0 = time.perf_counter()
    for k in range(steps):
        state, info = kernel(state, target.log_prob, identity, gen)
        trips.append(info.subiter)
        if k >= steps // 2:
            pool.append(state.position)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    pool = torch.cat(pool)
    mean_err = float(pool.mean(0).abs().max())
    var_err = float((pool.var(0, correction=0) - 1.0).abs().max())
    print(f"[40 tess invariance] N(0, I) at d={d}, {B} chains, {steps} steps: "
          f"{1e3 * secs / steps:.2f} host ms a step, mean subiter "
          f"{float(torch.stack(trips).float().mean()):.2f}; pooled second half: max |mean| "
          f"{mean_err:.4f} (tol 0.05), max |var - 1| {var_err:.4f} (tol 0.1)", flush=True)
    if not (mean_err <= 0.05 and var_err <= 0.1):
        fail("40: TESS with the identity flow does not keep N(0, I)")

    target1 = IndepGaussian(1, mean=0.5, var=0.25)
    ck = cis.build_kernel(32)
    cstate = cis.init(torch.randn((LIB["cis_chains"], 1), generator=gen, device=dev))
    cpool = []
    for k in range(50):
        cstate, _ = ck(cstate, target1.log_prob, identity, gen)
        if k >= 25:
            cpool.append(cstate.position)
    cpool = torch.cat(cpool)
    cm, cv = float(cpool.mean()), float(cpool.var(correction=0))
    print(f"[40 cis] N(0.5, 0.25), {LIB['cis_chains']} chains, 32 candidates, 50 steps: pooled "
          f"mean {cm:.4f} (0.5 within 0.03), var {cv:.4f} (0.25 within 10 %)", flush=True)
    if not (abs(cm - 0.5) <= 0.03 and abs(cv - 0.25) <= 0.025):
        fail("40: CIS with the identity flow does not sample N(0.5, 0.25)")

    n = LIB["snpe_sims"]
    prior = lambda g, m: torch.randn((m, 2), generator=g, device=g.device)
    lik = lambda g, theta: theta + 0.1 * torch.randn(theta.shape, generator=g, device=g.device)
    logq = lambda p, theta, data: -0.5 * torch.sum((data - theta - p) ** 2, dim=-1)
    loss = SNPE_A(logq, 1, lik, prior).get_loss_function(gen, n)
    p = torch.zeros(2, device=dev, requires_grad=True)
    val = loss(p)
    (grad,) = torch.autograd.grad(val, p)
    print(f"[40 snpe-a] {n} simulations: loss {float(val.detach()):.6g}, gradient "
          f"{[round(float(g), 6) for g in grad]}", flush=True)
    if not (bool(torch.isfinite(val)) and bool(torch.isfinite(grad).all())):
        fail("40: SNPE-A's loss or gradient is not finite")

    step = lambda s: kernel(s, target.log_prob, identity, gen)
    secs, _ = profiling.timed(step, state, repeats=3)
    with profiling.trace(trace_dir, device=dev) as prof:
        step(state)
    events = prof.key_averages()
    device_us = sum(getattr(e, "self_device_time_total", 0) for e in events)
    print(f"[40 profiling] timed: {1e3 * secs:.2f} ms a TESS step ({B} chains); trace: "
          f"{len(events)} kinds of event, {device_us / 1e3:.3f} ms of device time, "
          f"trace.json {os.path.getsize(os.path.join(trace_dir, 'trace.json'))} bytes",
          flush=True)


def phase_library(torch, counters, tmp):
    """Phases 35-40: the library on phi-four at its preset's width."""
    K1, K2A, _, K3, _ = (f.__name__ for f in counters)
    lib = library_flows(torch)
    out = {}
    for label, must, fn in (
            ("35 atess", (K1, K3), lambda: phase_atess(torch, lib)),
            ("36 atess eca", (K1, K3), lambda: phase_atess_eca(torch, lib)),
            ("37 msc", (K1, K3), lambda: phase_msc(torch, lib)),
            ("38 msc-mala", (K1, K3), lambda: phase_msc_mala(torch, lib)),
            ("39 svgd", (K3, K2A), lambda: phase_svgd(torch, lib)),
            ("40 library checks", (), lambda: phase_library_checks(torch, f"{tmp}/trace"))):
        lib["moves"].update(transports=0, secs=0.0)
        out[label] = library_phase(torch, counters, label, must, fn)
    return out


def phase_roofline(torch):
    """41: the roofline rows of the reference's bench (``bench.py::bench_roofline``)
    and one through the fused field, each counted once
    (``diagnostics.roofline.count``) and timed as the median of three calls:
    ensemble MALA on pines' Cox target (128 chains, 400 steps); one
    Hutchinson forward transport at pines' widths (d=1600, a 1024 x 1024
    joint trunk, the score gate, 128 rows, 24 RK4 steps) on the module
    field; the Stein discrepancy of 12,800 4-mode draws through K2a, as the
    card's eval takes it; one exact forward transport of phi-four on K1 and
    the fused score gate (1,024 rows, 24 RK4 steps). A row whose kernels
    reported to the count must show each launch's hand count times the
    launches its wrapper counted, and no other kernel."""
    from mfm_tpu_torch.diagnostics import roofline
    from mfm_tpu_torch.flows import (
        kernel_tangent_field, make_transport, make_vector_field, module_tangent_field,
    )
    from mfm_tpu_torch.kernels import mala
    from mfm_tpu_torch.ops import field, pairwise, phi_four
    from mfm_tpu_torch.targets import LogGaussianCoxPines, PhiFour, four_mode_mixture

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(41)
    reports = {}

    def row(name, fn, args, kernels):
        """``kernels``: wrapper -> its hand (flops, bytes) a launch."""
        before = {k: k.launches for k in kernels}
        with torch.no_grad():
            _, costs = roofline.count(fn, *args)
            torch.cuda.synchronize()
            launches = {k.__name__: k.launches - before[k] for k in kernels}
            for k, (flops, nbytes) in kernels.items():
                n, got = launches[k.__name__], costs.kernels.get(k.__name__)
                if not n or got != roofline.KernelCount(n, n * flops, n * nbytes):
                    fail(f"41 {name}: {k.__name__} counted {got}, its wrapper {n} launches of "
                         f"{flops} flops and {nbytes} bytes")
            if set(costs.kernels) != set(launches):
                fail(f"41 {name}: kernels {sorted(costs.kernels)} reported, "
                     f"{sorted(launches)} expected")
            r = roofline.roofline(name, fn, *args)
        pct = lambda v: "None" if v is None else f"{v:.3f} %"
        print(f"[41 roofline {name}] {r.flops / 1e9:.4f} GFLOP, {r.bytes_accessed / 1e9:.4f} GB, "
              f"{1e3 * r.seconds:.3f} ms a call: {r.achieved_flops_per_sec / 1e12:.3f} TFLOP/s "
              f"({pct(r.pct_peak_flops)} of the bf16 peak), "
              f"{r.achieved_bytes_per_sec / 1e9:.1f} GB/s ({pct(r.pct_peak_bandwidth)} of HBM); "
              f"{r.bound}-bound by the counts; kernels (launches, flops) "
              f"{ {k: (v.launches, v.flops) for k, v in costs.kernels.items()} }", flush=True)
        if not (r.flops > 0 and r.bytes_accessed > 0 and math.isfinite(r.seconds)):
            fail(f"41 {name}: nothing counted")
        reports[name] = dict(r.as_dict(), kernels={k: v._asdict() for k, v in
                                                  costs.kernels.items()})

    cox = LogGaussianCoxPines(1600, device=dev)
    kernel = mala.build_kernel(cox.value_and_score)
    state = mala.init(cox.init_positions(gen, 128), cox.value_and_score)
    noises = [mala.draw_noise(gen, 128, 1600) for _ in range(400)]

    def run_mala(s):
        for n in noises:
            s = kernel(s, 0.01, n.noise, n.u_accept)[0]
        return s

    row("mala_lgcp_128x400", run_mala, (state,), {})

    net, params = make_vector_field(
        torch.Generator().manual_seed(41), 1600, cox.score, hidden_x=(), hidden_t=(),
        hidden_xt=(1024, 1024), score_clip=10.0, score_gate=cox.score_gate, device=dev)
    tr = make_transport(module_tangent_field(net), "hutchinson", n_steps=24)
    u = torch.randn((128, 1600), generator=gen, device=dev)
    probe = torch.randn((128, 1600), generator=gen, device=dev)
    row("rk4_transport_pines_128", tr.forward, (params, u, probe), {})

    four = four_mode_mixture(dev)
    X = four.sample(gen, (12800,)).contiguous()
    row("stein_12800", lambda x: pairwise.stein_disc_fused(x, four.score), (X,),
        {pairwise.stein_pairwise_sum: pairwise.stein_cost(12800, 2)[1:]})

    target = PhiFour(64)
    net, params = perturbed_net(torch, 64, 128, 128, target, seed=1, gate_scale=1e-4)
    layout = field.field_layout(params, 128)
    tr = make_transport(kernel_tangent_field(net), "exact", n_steps=24)
    u = torch.randn((1024, 64), generator=gen, device=dev)
    row("rk4_transport_phi_four_fused_1024", tr.forward, (params, u),
        {field.field_apply: (field.field_flops(layout, 1024, 64),
                             field.field_bytes(layout, 1024, 64)),
         phi_four.phi_four_score_gate: phi_four.score_gate_cost(1024, 64, 64)})
    return reports


def phase_figures(torch, tmp):
    """42: a 4-mode run at phase 8's configuration and depth (25
    iterations), its forward transport at the five times of the progression
    figure on the card: the t=0 snapshot is u, the t=1 one the forward map
    (1e-5). Then the figures: where matplotlib imports, the run's figure set
    is rendered and its PNGs counted; where it does not (the card's
    machine), ``--plots`` must be refused by name before training."""
    from mfm_tpu_torch import cli
    from mfm_tpu_torch.config import preset
    from mfm_tpu_torch.drivers import run_mfm, sample_flow
    from mfm_tpu_torch.drivers.mfm import make_generator
    from mfm_tpu_torch.utils.logging import MetricLogger

    dev = torch.device("cuda")
    cfg = preset("4-mode", learning_iter=25, mcmc_per_flow_steps=10.0,
                 num_importance_samples=0, mcmc_kernel="mala")
    target = cli.make_target("4-mode", dev)
    run = run_mfm(target, cfg, dev)
    gen = make_generator(dev, cfg.seed, 999)
    u = run.ref_dist.sample(gen, (1024,))
    save_ts = [0.0, 0.25, 0.5, 0.75, 1.0]
    with torch.no_grad():
        traj = run.transport.forward_traj(run.train.params, u, save_ts)
        x1 = run.transport.forward(run.train.params, u)[0]
    e0 = float(torch.max(torch.abs(traj[0] - u)))
    e1 = float(torch.max(torch.abs(traj[-1] - x1)))
    moved = float(torch.max(torch.abs(x1 - u)))
    print(f"[42 progression] 4-mode 25 its, 1024 draws at t={save_ts}: max abs t=0 - u "
          f"{e0:.3e}, t=1 - forward {e1:.3e} (tol 1e-5); max |x(1) - u| {moved:.3f}", flush=True)
    if not (traj.shape == (5, 1024, 2) and bool(torch.isfinite(traj).all())
            and e0 <= 1e-5 and e1 <= 1e-5 and moved > 1e-3):
        fail("42: the progression's snapshots disagree with u and the forward map")
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        argv = ["--example", "4-mode", "--seed", "0", "--learning-iter", "5", "--plots",
                "--run-dir", f"{tmp}/plots"]
        try:
            cli.main(argv)
        except SystemExit as e:
            said = str(e)
        else:
            fail("42: --plots ran where matplotlib does not import")
        print(f"[42 figures] matplotlib does not import: --plots refused before training: "
              f"{said!r}", flush=True)
        if "--plots needs matplotlib" not in said:
            fail("42: --plots was not refused by name")
        return "refused"
    from mfm_tpu_torch.drivers.plots import make_run_figures

    fs, es, _ = sample_flow(run, 2048, target, gen)
    figs = make_run_figures(target, cfg, fs, es, run=run, noise=u)
    paths = MetricLogger(run_dir=f"{tmp}/figs", run_name="4-mode-seed0",
                         stdout_every=0).log_figures(figs)
    print(f"[42 figures] matplotlib imports: rendered {len(paths)} PNGs "
          f"({', '.join(os.path.basename(p) for p in paths)})", flush=True)
    if len(paths) != 2 or not all(os.path.getsize(p) for p in paths):
        fail("42: the figure set is not pairs_0 and progression_0")
    return "rendered"


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def phase_seeds(torch, limit_s=300):
    """43: ``python -m mfm_tpu_torch.parallel.run_seeds`` as two processes on
    this card (2 seeds, 20 iterations, gloo for the rows): both print the
    same aggregate of 2 rows, and on the metric columns (logpdf*, KSD-U*,
    MMD*; not train_time, a clock) it is ``aggregate_row`` of the two seeds
    run one after another here, within 1e-2 relative (the tolerance of
    phase 33's seed equality on the card). The launcher runs in a session
    of its own, killed whole past ``limit_s`` or on a failure, so that a
    hung rendezvous cannot hold the script."""
    import signal

    from mfm_tpu_torch.cli import make_target
    from mfm_tpu_torch.parallel.distributed import aggregate_row
    from mfm_tpu_torch.parallel.run_seeds import COLUMNS, seed_row

    cmd = [sys.executable, "-m", "mfm_tpu_torch.parallel.run_seeds", "--num-processes", "2",
           "--num-seeds", "2", "--learning-iter", "20", "--device", "cuda",
           "--coordinator", f"localhost:{free_port()}"]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=os.path.dirname(os.path.abspath(__file__)),
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=limit_s)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        fail(f"43: the two processes did not finish in {limit_s} s; killed")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
    wall = time.perf_counter() - t0
    if proc.returncode:
        fail(f"43: run_seeds exited {proc.returncode}: {err[-1500:]}")
    lines = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    dev = torch.device("cuda")
    target = make_target("4-mode", dev)
    mean, ci = aggregate_row([seed_row(target, s, 20, dev) for s in (0, 1)])
    rel = lambda got, ref: max(abs(g - r) / max(abs(r), 1e-6)
                               for g, r in zip(got[:3], ref[:3]))
    worst = max(rel(lines[0]["aggregate_mean"], mean), rel(lines[0]["aggregate_ci95"], ci)) \
        if lines else math.inf
    print(f"[43 seeds] 2 processes on one card, {wall:.1f} s: {json.dumps(lines)}; "
          f"in this process {dict(zip(COLUMNS, mean.round(6).tolist()))} "
          f"+- {ci.round(6).tolist()}; max relative difference on the metric columns "
          f"{worst:.3e} (tol 1e-2)", flush=True)
    if not (len(lines) == 2 and all(r["total_rows"] == 2 for r in lines)
            and lines[0]["aggregate_mean"] == lines[1]["aggregate_mean"]
            and lines[0]["aggregate_ci95"] == lines[1]["aggregate_ci95"]):
        fail("43: the two processes do not print one aggregate of two rows")
    if not worst <= 1e-2:
        fail("43: the processes' aggregate disagrees with the seeds run here")
    return dict(wall=wall, max_rel_diff=worst)


# ---------------------------------------------------------------- the mesh
# Phases 44-46 run ranks of a chain mesh as processes beside this one, all
# on this card (gloo: NCCL cannot put two ranks on one card). A rank of
# ``torchrun`` runs this file with ``--mesh-worker KIND OUT_DIR [cli args]``
# (``mesh_worker``) and writes what it measured to OUT_DIR.
MESH = dict(ranks=2, run_mfm_iters=20, run_mfm_chunk=5, cli_iters=50, smc_steps=200,
            atess_batches=4, atess_batch_size=64, atess_steps=2, allreduce_reps=50)


def run_ranks(cmd, label, limit_s):
    """Run ``cmd`` in a session of its own, killed whole past ``limit_s`` or
    on a failure; (stdout, wall)."""
    import signal

    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=os.path.dirname(os.path.abspath(__file__)),
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=limit_s)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        fail(f"{label}: the ranks did not finish in {limit_s} s; killed")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
    if proc.returncode:
        fail(f"{label}: exited {proc.returncode}: {err[-2500:]}")
    return out, time.perf_counter() - t0


def torchrun(out_dir, spec, label, limit_s=300):
    """``mesh_worker`` on MESH['ranks'] ranks under torchrun with ``spec``
    (the CLI arguments of its runs); every rank's record, in rank order,
    and the wall."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={MESH['ranks']}", os.path.abspath(__file__), "--mesh-worker",
           out_dir, json.dumps(spec)]
    _, wall = run_ranks(cmd, label, limit_s)
    recs = []
    for r in range(MESH["ranks"]):
        with open(os.path.join(out_dir, f"rank{r}.json")) as fh:
            recs.append(json.load(fh))
    return recs, wall


# the ranks' records of phases 45-46, which share one torchrun
MESH_RANKS = {}


def add_launches(counters, recs):
    """The launches the ranks made, counted on the main path; the sum."""
    total = {f.__name__: sum(r["launches"][f.__name__] for r in recs) for f in counters}
    for f in counters:
        f.launches += total[f.__name__]
    return total


def rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def training_summary(torch, run):
    """What a phase compares of a training run: the last loss and beta, the
    run's mean acceptance, and its host ms an iteration."""
    m = run.metrics
    return dict(loss=float(m["loss"][-1]), beta=float(m["beta"][-1]),
                acceptance_mean=float(torch.nanmean(m["acceptance_mean"])),
                host_ms=1e3 * run.train_time / m["loss"].shape[-1])


def phase_mesh_run_mfm(torch, counters):
    """44: ``python -m mfm_tpu_torch.parallel.run_mfm --example phi-four``
    (the reference demo's phi-four: d=64, 1,024 chains, step 1e-4, 20
    iterations in chunks of 5) as two ranks on this card: both print one
    state digest and one chunks digest; the final loss, beta and mean
    acceptance within 1e-3 relative of the same configuration run in this
    process; each rank launched K3. Its 20 iterations are all MALA-type (the
    first flow step is iteration 101), so no transport runs and the score
    gate does not launch here; phases 45-46 launch it."""
    from mfm_tpu_torch.parallel.run_mfm import make_config, summary, train

    cmd = [sys.executable, "-m", "mfm_tpu_torch.parallel.run_mfm", "--example", "phi-four",
           "--num-processes", str(MESH["ranks"]), "--device", "cuda",
           "--learning-iter", str(MESH["run_mfm_iters"]), "--chunk-size",
           str(MESH["run_mfm_chunk"]), "--coordinator",
           f"localhost:{free_port()}", "--timeout", "240"]
    out, wall = run_ranks(cmd, "44", 300)
    lines = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    if len(lines) != MESH["ranks"]:
        fail(f"44: {len(lines)} lines from {MESH['ranks']} ranks")
    total = add_launches(counters, lines)
    cfg = make_config("phi-four", 1, MESH["run_mfm_iters"], MESH["run_mfm_chunk"])
    run, collector, _ = train("phi-four", cfg, "cuda")
    one = summary(run, cfg, collector, {}, 0, 1)
    diffs = {k: rel(lines[0][k], one[k]) for k in ("final_loss", "final_beta", "mean_acceptance")}
    print(f"[44 run_mfm] {MESH['ranks']} ranks, wall {wall:.1f} s: "
          f"{json.dumps([{k: v for k, v in r.items() if k != 'launches'} for r in lines])}; "
          f"one process: loss {one['final_loss']}, beta {one['final_beta']}, acceptance "
          f"{one['mean_acceptance']}, {one['steady_iters_per_sec']} it/s; relative differences "
          f"{json.dumps({k: float(f'{v:.3e}') for k, v in diffs.items()})} (tol 1e-3); ranks' "
          f"launches {json.dumps(total)}", flush=True)
    if not (len({r["state_digest"] for r in lines}) == 1
            and len({r["chunks_digest"] for r in lines}) == 1):
        fail("44: the ranks' digests differ")
    if not all(v <= 1e-3 for v in diffs.values()):
        fail("44: the sharded run disagrees with the run in one process")
    if not all(r["launches"]["phi_four_value_and_score"] for r in lines):
        fail("44: a rank launched no K3")
    return dict(wall=wall, diffs=diffs)


CLI_ARGV = ["--seed", "0", "--example", "phi-four", "--learning-iter", str(MESH["cli_iters"]),
            "--set", "eval_iter=10", "--set", "field_precision=highest", "--set",
            "pallas_field=true"]
SMC_ARGV = ["--seed", "0", "--example", "phi-four", "--do-smc", "--learning-iter",
            str(MESH["smc_steps"]), "--set", "eval_iter=4"]


def phase_mesh_cli(torch, counters, run_dir, out_dir):
    """45: the CLI under torchrun (``--set mesh_shape=(1,2)``) on phi-four on
    the fused field (K1, K3, the gate; K2a at rank 0's eval), 50
    iterations, eval_iter=10, against the same arguments in this process:
    the training metrics (last loss and beta, mean acceptance) and the flow
    row within 1e-2 relative; the IS row's differences reported, not
    gated (at this depth it rests on 1-2 points). Also: each rank's host ms
    an iteration at 512 chains against 1,024 here, and the gloo round trip
    of an all-reduce of the gradient's size from the card. The same ranks
    then run phase 46's work (one torchrun for both: a rank takes seconds
    to reach the card), whose launches count there."""
    run = ["--run-dir", run_dir]
    recs, wall = torchrun(out_dir, {"cli": [*CLI_ARGV, *run, "--set", "mesh_shape=(1,2)"],
                                    "smc": [*SMC_ARGV, *run, "--set", "mesh_shape=(2,)"]}, "45")
    MESH_RANKS.update(recs=recs, wall=wall, out_dir=out_dir)
    total = add_launches(counters, [r["cli"] for r in recs])
    TRAINING.clear()
    one = run_cli(CLI_ARGV, "45 phi-four fused one process", run_dir)
    one_train = TRAINING["summary"]
    row, train = recs[0]["cli"]["rows"][0], recs[0]["cli"]["training"]
    flow_diff = {k: rel(row[k], one[k]) for k in ROW[:4]}
    is_diff = {k: rel(row[k], one[k]) for k in ROW[4:]}
    train_diff = {k: rel(train[k], one_train[k]) for k in ("loss", "beta", "acceptance_mean")}
    fmt = lambda d: json.dumps({k: float(f"{v:.3e}") for k, v in d.items()})
    print(f"[45 cli mesh] 2 ranks (1, 2), wall {wall:.1f} s for phases 45-46 (rank 0: group "
          f"after {recs[0]['t_group']:.1f} s, the CLI run {recs[0]['t_cli']:.1f} s, 46's SMC "
          f"{recs[0]['t_smc']:.1f} s and ATESS {recs[0]['t_atess']:.1f} s); rank 0's row "
          f"{json.dumps(row)}; training {fmt(train_diff)}, flow row {fmt(flow_diff)} (tol 1e-2); "
          f"IS row {fmt(is_diff)} (reported, is_ess {row['is_ess']:.3f} against "
          f"{one['is_ess']:.3f}); host ms an iteration: rank 0 at 512 chains "
          f"{train['host_ms']:.2f}, rank 1 {recs[1]['cli']['training']['host_ms']:.2f}, one "
          f"process at 1,024 {one_train['host_ms']:.2f}; gloo all-reduce of "
          f"{recs[0]['allreduce']['numel']} floats from the card {recs[0]['allreduce']['ms']:.3f} "
          f"ms a round trip; ranks' launches {json.dumps(total)}", flush=True)
    if not all(math.isfinite(v) for v in row.values() if isinstance(v, float)):
        fail("45: non-finite row")
    if not all(v <= 1e-2 for v in (*flow_diff.values(), *train_diff.values())):
        fail("45: the sharded CLI run disagrees with the run in one process")
    for k in ("field_apply", "phi_four_value_and_score", "phi_four_score_gate"):
        if not all(r["cli"]["launches"][k] for r in recs):
            fail(f"45: a rank launched no {k}")
    if not recs[0]["cli"]["launches"]["stein_pairwise_sum"]:
        fail("45: rank 0's eval launched no K2a")
    return dict(wall=wall, train=train_diff, flow=flow_diff, is_row=is_diff,
                host_ms=[r["cli"]["training"]["host_ms"] for r in recs],
                one_host_ms=one_train["host_ms"], allreduce=recs[0]["allreduce"])


def atess_case(torch, mesh=None):
    """Two steps of ``atess(..., eca=True)`` on phi-four at its preset's
    width (phase 36's flows, MESH's batches); under ``mesh`` on its
    ``ensemble`` axis. The gathered positions and fitted parameters."""
    from mfm_tpu_torch.adaptation import atess
    from mfm_tpu_torch.flows import adam
    from mfm_tpu_torch.kernels import tess
    from mfm_tpu_torch.parallel.mesh import shard_chains

    lib = library_flows(torch)
    nb, bs, d = MESH["atess_batches"], MESH["atess_batch_size"], LIB["d"]
    gen = torch.Generator(device="cuda").manual_seed(46)
    x = torch.randn((nb, bs, d), generator=gen, device="cuda")
    noise = [[tess.draw_noise(gen, bs, d) for _ in range(nb)] for _ in range(MESH["atess_steps"])]
    if mesh is not None:
        x = shard_chains(x, mesh)
    algo = atess(lib["target"].log_prob, adam(1e-3), lib["params"], lib["flow"], lib["loss"], nb,
                 bs, num_steps=MESH["atess_steps"], eca=True, mesh=mesh)
    state, _, (params, _) = algo.run(noise, x)
    gather = (lambda v: v) if mesh is None else mesh.all_gather_rows
    return gather(state.states.position), {k: gather(v) for k, v in params.items()}


# every SMC step of the last run_smc (``instrument_smc``): its log Z
# increment, lambda and the ancestors of every rank; and with a replay, what
# the single-device resampler chose from the weights and uniform it got
SMC_STEPS, REPLAYED = [], []


def instrument_smc(replay=None):
    """Wrap ``drivers.smc_run.build_smc`` so that ``run_smc``'s steps record
    themselves in ``SMC_STEPS`` (a collective on every rank of a mesh: the
    ancestors are gathered). With ``replay`` (another run's SMC_STEPS) the
    resampler returns that run's ancestors, step by step, and records in
    ``REPLAYED`` what the single-device resampler would have chosen. Returns
    the function that undoes both; each step reads its numbers back, so no
    other phase runs under it."""
    from mfm_tpu_torch.drivers import smc_run
    from mfm_tpu_torch.smc import resampling

    build, get_resampler = smc_run.build_smc, resampling.get_resampler

    def recorded(*args, **kwargs):
        pieces = build(*args, **kwargs)
        SMC_STEPS.clear()
        gather = (lambda v: v) if pieces.mesh is None else pieces.mesh.all_gather_rows

        def step_fn(carry, noise):
            carry, info = pieces.step_fn(carry, noise)
            SMC_STEPS.append(dict(incr=float(info.log_likelihood_increment),
                                  lmbda=float(carry.state.lmbda),
                                  ancestors=gather(info.ancestors).cpu()))
            return carry, info

        return pieces._replace(step_fn=step_fn)

    def replaying(name):
        single, steps = get_resampler(name), iter(replay)
        REPLAYED.clear()

        def resample(u, weights, num_samples):
            theirs = next(steps)["ancestors"].to(weights.device)
            REPLAYED.append(dict(mine=single(u, weights, num_samples).cpu(),
                                 theirs=theirs.cpu(), weights=weights.cpu(), u=u.cpu()))
            return theirs

        return resample

    smc_run.build_smc = recorded
    if replay is not None:
        resampling.get_resampler = replaying

    def restore():
        smc_run.build_smc, resampling.get_resampler = build, get_resampler

    return restore


def resampler_ties(torch, replayed):
    """Where the sharded run's ancestors and the single-device resampler's
    differ on the same weights and uniform: (steps, slots, whether every
    difference is an off-by-one at a float32 tie, its grid point within
    1e-6 of the cumulative weight between the two;
    ``mfm_tpu/smc/distributed.py:38-46``)."""
    steps = slots = 0
    ok = True
    for r in replayed:
        diff = r["mine"] != r["theirs"]
        if not bool(diff.any()):
            continue
        n = r["weights"].shape[0]
        cum = torch.cumsum(r["weights"].double(), 0)
        grid = (torch.arange(n, dtype=torch.float64) + r["u"].double()) / n
        lo = torch.minimum(r["mine"], r["theirs"])[diff]
        steps, slots = steps + 1, slots + int(diff.sum())
        ok = ok and bool(((r["mine"] - r["theirs"])[diff].abs() == 1).all()
                         and ((grid[diff] - cum[lo]).abs() < 1e-6).all())
    return steps, slots, ok


def phase_mesh_smc_atess(torch, counters, run_dir):
    """46: on phase 45's ranks: ``--do-smc`` on phi-four with
    ``mesh_shape=(2,)`` (the distributed resampler and the ring gather, 200
    steps) against the same arguments in this process, with the sharded
    run's ancestors replayed here (``instrument_smc``): every step's log Z
    increment and lambda equal within 1e-6, log Z and lambda of the two
    rows within 1e-3; and on every step's weights, the sharded ancestors
    against the single-device resampler's: equal but for off-by-ones at
    float32 ties (without the replay one such tie sets two runs apart, as
    in the reference). Then two steps of ``atess(mesh=)`` by parallel ECA
    (4 batches of 64) on the ``ensemble`` axis against the unsharded call,
    positions within 1e-4."""
    if not MESH_RANKS:
        fail("46: phase 45's ranks did not run")
    recs = MESH_RANKS["recs"]
    total = add_launches(counters, [{"launches": {k: r["launches"][k] - r["cli"]["launches"][k]
                                                  for k in r["launches"]}} for r in recs])
    sharded = torch.load(os.path.join(MESH_RANKS["out_dir"], "smc_steps.pt"), weights_only=True)
    restore = instrument_smc(replay=sharded)
    try:
        one = run_cli(SMC_ARGV, "46 phi-four SMC one process, the ranks' ancestors", run_dir)
    finally:
        restore()
    steps_equal = len(sharded) == len(SMC_STEPS) == len(REPLAYED) and all(
        a["lmbda"] == b["lmbda"] and rel(a["incr"], b["incr"]) <= 1e-6
        for a, b in zip(sharded, SMC_STEPS))
    tie_steps, tie_slots, ties_ok = resampler_ties(torch, REPLAYED)
    row = recs[0]["smc"]["rows"][0]
    smc_diff = {k: rel(row[k], one[k]) for k in ("log_z", "lmbda")}
    t0 = time.perf_counter()
    pos, params = atess_case(torch)
    one_atess_s = time.perf_counter() - t0
    got = torch.load(os.path.join(MESH_RANKS["out_dir"], "atess.pt"), weights_only=True)
    ex = errors(torch, got["pos"].to(pos.device), pos)
    ep = max(errors(torch, got["params"][k].to(v.device), v)[0] for k, v in params.items())
    print(f"[46 smc and atess mesh] on phase 45's ranks (SMC {recs[0]['t_smc']:.1f} s, ATESS "
          f"{recs[0]['t_atess']:.1f} s; ATESS here {one_atess_s:.1f} s): SMC log_z "
          f"{row['log_z']:.6f} against {one['log_z']:.6f}, lmbda {row['lmbda']:.6f} against "
          f"{one['lmbda']:.6f}: relative "
          f"{json.dumps({k: float(f'{v:.3e}') for k, v in smc_diff.items()})} (tol 1e-3); "
          f"{len(sharded)} steps' increments and lambda equal: {steps_equal}; the single-device "
          f"resampler differs at {tie_slots} slot(s) of {tie_steps} step(s), each an off-by-one "
          f"at a float32 tie: {ties_ok}; atess positions max abs {ex[0]:.3e} (tol 1e-4), "
          f"parameters {ep:.3e}; ranks' launches {json.dumps(total)}", flush=True)
    if not (steps_equal and all(v <= 1e-3 for v in smc_diff.values())):
        fail("46: the sharded SMC run disagrees with the run in one process")
    if not ties_ok:
        fail("46: the distributed resampler differs from the single-device one beyond ties")
    if not ex[0] <= 1e-4:
        fail("46: the sharded ATESS disagrees with the unsharded call")
    if not (total["phi_four_value_and_score"] and total["field_apply"]):
        fail("46: the ranks launched no K3 or no K1")
    return dict(smc=smc_diff, tie_steps=tie_steps, tie_slots=tie_slots, atess_pos=ex[0],
                atess_params=ep)


def mesh_worker(out_dir, spec):
    """One rank of phases 45-46 under torchrun: the CLI's run of
    ``spec["cli"]`` with the training recorded, the all-reduce's round trip,
    the CLI's SMC run of ``spec["smc"]``, then the sharded ATESS; writes
    ``rank<r>.json`` (and ``atess.pt`` from rank 0), with the launches and
    the seconds to the group and of each part."""
    t_start = time.perf_counter()
    import torch
    import torch.distributed as dist

    from mfm_tpu_torch import cli
    from mfm_tpu_torch.ops import field, pairwise, phi_four
    from mfm_tpu_torch.parallel.mesh import init_from_env, make_mesh

    spec = json.loads(spec)
    counters = (field.field_apply, pairwise.stein_pairwise_sum, pairwise.rbf_kernel_sum,
                phi_four.phi_four_value_and_score, phi_four.phi_four_score_gate)
    launches = lambda: {f.__name__: f.launches for f in counters}
    rank, world, _, dev = init_from_env("cuda")
    rec = {"rank": rank, "t_group": time.perf_counter() - t_start}
    try:
        instrument_training(counters)
        t0 = time.perf_counter()
        rec["cli"] = dict(rows=cli.main(spec["cli"]), training=TRAINING.get("summary"))
        rec["cli"]["launches"] = launches()
        rec["t_cli"] = time.perf_counter() - t0

        from mfm_tpu_torch.config import preset
        from mfm_tpu_torch.drivers.mfm import build_mfm
        from mfm_tpu_torch.targets import PhiFour

        mesh = make_mesh((world,), device=dev)
        pieces = build_mfm(PhiFour(64), preset("phi-four"), dev, torch.Generator())
        n = sum(v.numel() for v in pieces.net.parameters())
        buf = torch.ones(n, device=dev)
        mesh.all_reduce_sum(buf)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(MESH["allreduce_reps"]):
            mesh.all_reduce_sum(buf)
        torch.cuda.synchronize()
        rec["allreduce"] = dict(numel=n, ms=1e3 * (time.perf_counter() - t0)
                                / MESH["allreduce_reps"])

        instrument_smc()
        t0 = time.perf_counter()
        rec["smc"] = dict(rows=cli.main(spec["smc"]))
        rec["t_smc"] = time.perf_counter() - t0
        if rank == 0:
            torch.save(SMC_STEPS, os.path.join(out_dir, "smc_steps.pt"))
        t0 = time.perf_counter()
        pos, params = atess_case(torch, make_mesh((world,), ("ensemble",), device=dev))
        rec["t_atess"] = time.perf_counter() - t0
        if rank == 0:
            torch.save({"pos": pos.cpu(), "params": {k: v.cpu() for k, v in params.items()}},
                       os.path.join(out_dir, "atess.pt"))
        rec["launches"] = launches()
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
            json.dump(rec, fh)
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------- the seed bands
# Phases 47-51 hold the port's 10-seed sweeps on the card to the reference's
# rows over the same seeds, committed as data by tools/seed_band_reference.py
# (the reference package on the CPU; this script reads only its JSON).
BAND_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                         "seed_band_reference.json")
BAND_KERNELS = {  # the kernels each band's card run must launch
    "4-mode": ("stein_pairwise_sum", "rbf_kernel_sum"),
    "gaussian-mixture": ("stein_pairwise_sum", "rbf_kernel_sum"),
    "phi-four": ("phi_four_value_and_score", "phi_four_score_gate", "stein_pairwise_sum"),
    "phi-four-fused": ("field_apply", "phi_four_value_and_score", "phi_four_score_gate",
                       "stein_pairwise_sum"),
    "pines": ("stein_pairwise_sum",),
}
BAND_COLUMNS = ("logpdf", "stein_u", "stein_v", "mmd", "logpdf_star", "stein_u_star",
                "stein_v_star", "mmd_star", "is_log_z")
# The card's KSD is K2a's, with fp64 sums: it is held to KSD-U of the
# reference's own samples in float64, not to the reference's fp32 statistic,
# which loses a few per cent to cancellation where |x|^2 is large (pines).
BAND_REFERENCE = {"stein_u": "stein_u_f64", "stein_u_star": "stein_u_star_f64"}
# |gap| over the standard error of the difference of the means, at 10 seeds
# a side: the ci95 rule alone lets a shift of ~3.9 sigma through, this one
# ~1.8 sigma.
BAND_SE_LIMIT = 4.0


def set_flags(overrides):
    """``--set`` flags for config overrides as the JSON holds them (a list
    is a tuple field, a bool the CLI's true/false)."""
    text = lambda v: (str(v).lower() if isinstance(v, bool)
                      else repr(tuple(v)) if isinstance(v, list) else str(v))
    return [f for k, v in overrides.items() for f in ("--set", f"{k}={text(v)}")]


def run_band(torch, band, run_dir):
    """The CLI's 10 seeds as one sweep (``--vmap-seeds``) at the band's
    overrides on the card: each seed's metric row with the IS estimate of
    log Z from the weights the CLI's ``sample_flow`` returned, and the wall."""
    from mfm_tpu_torch import cli

    drawn = []
    sample_flow = cli.sample_flow

    def recorded(*args, **kwargs):
        out = sample_flow(*args, **kwargs)
        drawn.append(out[2])
        return out

    argv = ["--example", band["example"], "--vmap-seeds", "--run-dir", run_dir,
            *set_flags({**band["overrides"], **band["port_overrides"]})]
    cli.sample_flow = recorded
    t0 = time.perf_counter()
    try:
        rows = cli.main(argv)
    finally:
        cli.sample_flow = sample_flow
    wall = time.perf_counter() - t0
    for m, log_w in zip(rows, drawn):
        m["is_log_z"] = float(torch.logsumexp(log_w.double(), 0)) - math.log(log_w.numel())
    return rows, wall


def phase_band(torch, counters, label, name, band, run_dir):
    """One seed band: the port's 10 seeds against the reference's, each held
    column within ci95_ref + ci95_port of the reference's mean (ci95 = 1.96
    sigma over seeds, ``aggregate_seeds``) and within ``BAND_SE_LIMIT``
    standard errors of the difference; fails on a column outside either, a
    non-finite row on either side, or a kernel of the band never launched."""
    import numpy as np

    from mfm_tpu_torch.drivers import aggregate_seeds

    before = [f.launches for f in counters]
    rows, wall = run_band(torch, band, run_dir)
    n = {f.__name__: f.launches - b for f, b in zip(counters, before)}
    ref_rows = band["rows"]
    port = np.array([[m[c] for c in BAND_COLUMNS] for m in rows], dtype=np.float64)
    ref = np.array([[r[BAND_REFERENCE.get(c, c)] for c in BAND_COLUMNS] for r in ref_rows],
                   dtype=np.float64)
    got, want = aggregate_seeds(port.tolist()), aggregate_seeds(ref.tolist())
    sd_port, sd_ref = got["ci95"] / 1.96, want["ci95"] / 1.96
    outside = []
    print(f"[{label}] {band['example']} {json.dumps(band['overrides'])} + "
          f"{json.dumps(band['port_overrides'])}: {len(rows)} seeds in {wall:.1f} s of wall; "
          f"reference {len(ref_rows)} seeds", flush=True)
    for c in band["held"]:
        i = BAND_COLUMNS.index(c)
        gap, width = abs(got["mean"][i] - want["mean"][i]), want["ci95"][i] + got["ci95"][i]
        se = math.sqrt(sd_ref[i] ** 2 / len(ref) + sd_port[i] ** 2 / len(port))
        z = gap / se if se else (0.0 if gap == 0 else math.inf)
        own = f" ({BAND_REFERENCE[c]})" if c in BAND_REFERENCE else ""
        print(f"[{label.split()[0]} {c}] reference{own} {want['mean'][i]: .5e} +- "
              f"{want['ci95'][i]:.4e}, port {got['mean'][i]: .5e} +- "
              f"{got['ci95'][i]:.4e}; gap {gap:.4e} of band {width:.4e}, {z:.2f} standard errors "
              f"of the difference (limit {BAND_SE_LIMIT})", flush=True)
        if not (gap <= width and z <= BAND_SE_LIMIT):
            outside.append(c)
    ess = lambda rs: float(np.mean([r["is_ess"] for r in rs]))
    unique = lambda rs: float(np.mean([r["is_unique"] for r in rs]))
    print(f"[{label.split()[0]} weights] mean is_ess reference {ess(ref_rows):.3f}, port "
          f"{ess(rows):.3f}; mean is_unique reference {unique(ref_rows):.1f}, port "
          f"{unique(rows):.1f}", flush=True)
    print(f"[{label.split()[0]} launches] " + " ".join(f"{k}={v}" for k, v in n.items()),
          flush=True)
    if len(rows) != 10 or len(ref_rows) != 10:
        fail(f"{label}: {len(rows)} port seeds, {len(ref_rows)} reference seeds, not 10 each")
    if not (np.all(np.isfinite(port)) and np.all(np.isfinite(ref))):
        fail(f"{label}: a non-finite metric row (port or reference)")
    if outside:
        fail(f"{label}: {', '.join(outside)} outside the reference's seed band or more than "
             f"{BAND_SE_LIMIT} standard errors from its mean")
    missing = [k for k in BAND_KERNELS[name] if not n[k]]
    if missing:
        fail(f"{label}: the band launched no {', '.join(missing)}")
    return dict(wall=wall, launches=n)


def phase_bands(torch, counters, run_dir, first=47):
    """Phases ``first``.. : every band of the committed reference file, in
    the order of ``BAND_KERNELS``."""
    with open(BAND_FILE) as fh:
        bands = json.load(fh)["bands"]
    if sorted(bands) != sorted(BAND_KERNELS):
        fail(f"{BAND_FILE} holds bands {sorted(bands)}, not {sorted(BAND_KERNELS)}")
    t0 = time.perf_counter()
    for i, name in enumerate(BAND_KERNELS):
        phase_band(torch, counters, f"{first + i} band {name}", name, bands[name], run_dir)
    wall = time.perf_counter() - t0
    print(f"[{first}-{first + len(BAND_KERNELS) - 1} bands] {wall:.1f} s of wall", flush=True)
    return wall


# ----------------------------------------------------- many-well's NaN rows
# Phase 52: many-well as preset at 100 iterations over MANY_WELL_SEEDS as one
# seed sweep (run_mfm_seeds, the CLI's --vmap-seeds path), each seed then
# sampled as the CLI samples it; the share of seeds with a non-finite flow
# row against the reference's pooled share in the committed JSON.
MANY_WELL_SEEDS = range(1000, 1060)
# the port's share of seeds with a NaN flow row over seeds 2000-2999 on the
# H100 (cell PP of tools/many_well_paired.py's paired study, committed in
# tools/many_well_paired_h100.jsonl)
MANY_WELL_PORT_SHARE = 0.53
# two-sided Fisher p below which the shares differ: the largest of 0.01,
# 0.005, 0.002 and 0.001 at which a port whose true share is
# MANY_WELL_PORT_SHARE fails in fewer than 1 run in 200 against the
# committed pool, else 0.001 (tools/many_well_paired.py::choose_limit):
# against 192 of 409 it fails 0.550 % of runs at 0.001, 2.24 % at 0.01
MANY_WELL_P_LIMIT = 0.001
MANY_WELL_GATED = True


def phase_many_well(torch, label="52 many-well NaN rows"):
    """The port's share of seeds whose flow row is not finite against the
    reference's, two-sided Fisher p; fails below ``MANY_WELL_P_LIMIT`` when
    ``MANY_WELL_GATED``, and on a non-finite training metric."""
    from mfm_tpu_torch import cli
    from mfm_tpu_torch.config import preset
    from mfm_tpu_torch.drivers.eval import fisher_exact
    from mfm_tpu_torch.drivers.mfm import EVAL_STREAM, make_generator
    from mfm_tpu_torch.drivers.multi_seed import run_mfm_seeds, seed_run

    with open(BAND_FILE) as fh:
        data = json.load(fh)
    ref = list({r["seed"]: r for k in ("many_well", "many_well_more")
                for r in data[k]["rows"]}.values())
    ref_bad = sum(not r["flow_row_finite"] for r in ref)
    seeds = list(MANY_WELL_SEEDS)
    cfg = preset("many-well", learning_iter=100)
    target = cli.make_target("many-well", "cuda")
    t0 = time.perf_counter()
    sweep = run_mfm_seeds(target, cfg, seeds, "cuda")
    n = cfg.eval_iter * cfg.num_chain
    bad = []
    for i, seed in enumerate(seeds):
        flow, _, _ = cli.sample_flow(seed_run(sweep, cfg, i), n, target,
                                     make_generator("cuda", seed, EVAL_STREAM))
        bad.append(int((~torch.isfinite(flow).all(-1)).sum()))
    wall = time.perf_counter() - t0
    port_bad = sum(b > 0 for b in bad)
    p = fisher_exact(port_bad, len(seeds), ref_bad, len(ref))
    print(f"[{label}] seeds {seeds[0]}-{seeds[-1]} as one sweep in {wall:.1f} s of wall: "
          f"{port_bad}/{len(seeds)} seeds with a non-finite flow row ({sum(bad)} samples of "
          f"{n * len(seeds)}), reference {ref_bad}/{len(ref)}; two-sided Fisher p {p:.4f} "
          f"(fails below {MANY_WELL_P_LIMIT}: {MANY_WELL_GATED})", flush=True)
    if not all(bool(torch.isfinite(v).all()) for v in sweep.metrics.values()):
        fail(f"{label}: a non-finite training metric")
    if MANY_WELL_GATED and p < MANY_WELL_P_LIMIT:
        fail(f"{label}: the port's share {port_bad}/{len(seeds)} differs from the reference's "
             f"{ref_bad}/{len(ref)} (p {p:.4f} < {MANY_WELL_P_LIMIT})")
    return wall


# ------------------------------------------------ phases beside the main one
# The seed bands (47-51) and many-well's runs (10, 12, 27 and 52) are each
# run by a process of their own on this card (``beside_worker``), started
# after phase 4 and joined after phase 40: they hold the port to committed
# data and time nothing, and beside phases 5-40 they take none of the
# script's wall. Their lines are printed at the join, their launches added
# to the main path's there. Phases 41-46 come after the join, so the
# roofline and the ranks run with the card to themselves.
MANY_WELL_PHASES = [  # as run_phases takes them; seed 0's row is finite at 120
    (["--example", "many-well", "--learning-iter", "120"], "10 many-well",
     ("stein_pairwise_sum", "rbf_kernel_sum")),
    (["--example", "many-well", "--learning-iter", "120", *FUSED],
     "12 many-well fused field", ("field_apply", "stein_pairwise_sum", "rbf_kernel_sum")),
    (["--example", "many-well", "--learning-iter", "120", "--defensive-alpha", "0.9"],
     "27 many-well defensive", ("stein_pairwise_sum", "rbf_kernel_sum")),
]
BESIDE = ("bands", "many-well")
BESIDE_LIMIT_S = 900  # from their start; past it both are killed and the script fails


def beside_worker(kind, out_dir):
    """One process beside the main one: the seed bands, or many-well's CLI
    phases then phase 52; its launches go to ``<out_dir>/<kind>.json``."""
    import tempfile

    import torch

    t0 = time.perf_counter()
    counters = launch_counters()
    for f in counters:
        f.launches = 0
    instrument_training(counters)
    with tempfile.TemporaryDirectory() as tmp:
        if kind == "bands":
            phase_bands(torch, counters, f"{tmp}/runs")
        else:
            run_phases(counters, MANY_WELL_PHASES, f"{tmp}/runs", {}, {})
            phase_many_well(torch)
    with open(os.path.join(out_dir, f"{kind}.json"), "w") as fh:
        json.dump(dict(launches={f.__name__: f.launches for f in counters},
                       wall=time.perf_counter() - t0), fh)


def start_beside(out_dir):
    """Start every ``BESIDE`` worker in a session of its own, its output to
    files under ``out_dir``; each is killed whole if this process exits
    first (a failure, or SIGTERM)."""
    import atexit
    import signal

    here = os.path.dirname(os.path.abspath(__file__))
    procs = {}
    for kind in BESIDE:
        with open(os.path.join(out_dir, f"{kind}.out"), "w") as out, \
                open(os.path.join(out_dir, f"{kind}.err"), "w") as err:
            procs[kind] = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--beside", kind, out_dir],
                stdout=out, stderr=err, cwd=here, start_new_session=True)

    def kill():
        for proc in procs.values():
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()

    atexit.register(kill)
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    return dict(procs=procs, out_dir=out_dir, t0=time.perf_counter(), kill=kill)


def join_beside(beside, counters):
    """Wait for the workers, print their output, fail if one failed, and add
    their launches to the main path's."""
    waited = time.perf_counter()
    late = []
    for kind, proc in beside["procs"].items():
        left = BESIDE_LIMIT_S - (time.perf_counter() - beside["t0"])
        try:
            proc.wait(timeout=max(left, 1))
        except subprocess.TimeoutExpired:
            late.append(kind)
            beside["kill"]()
    waited = time.perf_counter() - waited
    for kind in beside["procs"]:
        with open(os.path.join(beside["out_dir"], f"{kind}.out")) as fh:
            sys.stdout.write(fh.read())
        with open(os.path.join(beside["out_dir"], f"{kind}.err")) as fh:
            sys.stderr.write(fh.read())
        sys.stdout.flush()
        sys.stderr.flush()
    if late:
        fail(f"the phases beside ({', '.join(late)}) did not finish within {BESIDE_LIMIT_S} s")
    for kind, proc in beside["procs"].items():
        if proc.returncode:
            fail(f"the phases beside: {kind} exited {proc.returncode}")
    for kind in beside["procs"]:
        with open(os.path.join(beside["out_dir"], f"{kind}.json")) as fh:
            rec = json.load(fh)
        for f in counters:
            f.launches += rec["launches"][f.__name__]
        print(f"[beside {kind}] {rec['wall']:.1f} s of wall beside phases 5-40; launches "
              + " ".join(f"{k}={v}" for k, v in rec["launches"].items()), flush=True)
    print(f"[beside] joined after phase 40, which waited {waited:.1f} s for them", flush=True)


def main():
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is false)")
    try:
        import mfm_tpu_torch  # noqa: F401
        from mfm_tpu_torch.ops import field, pairwise, phi_four  # noqa: F401
    except ImportError as e:
        fail(f"the port is not importable beside this script: {e}")

    report = {}
    phase_device(torch)
    phase_build()
    phase_kernels(torch, report)
    phase_transport(torch)

    counters = launch_counters()
    for fn in counters:
        fn.launches = 0
    K1, K2A, K2B, K3, GATE = (f.__name__ for f in counters)
    short = ["--example", "4-mode", "--learning-iter", "10"]
    phases = [  # (arguments after --seed 0, label, the kernels the run must launch)
        (["--example", "phi-four", "--learning-iter", "50"], "5 phi-four", (K3, GATE, K2A)),
        (["--example", "phi-four", "--learning-iter", "50", "--ref-dist", "phifour"],
         "6 phi-four phifour-ref", (K3, GATE, K2A)),
        (["--example", "phi-four", "--learning-iter", "150", *FUSED],
         "7 phi-four fused field", (K1, K3, GATE, K2A)),
        (["--example", "4-mode", "--learning-iter", "25"], "8 4-mode", (K2A, K2B)),
        (["--example", "pines", "--learning-iter", "30"], "9 pines", (K2A,)),
        (["--example", "funnel", "--learning-iter", "25"], "11 funnel", (K2A, K2B)),
        (["--example", "gaussian-mixture", "--learning-iter", "15"], "13 gaussian-mixture",
         (K2A, K2B)),
        ([*short, "--num-importance-samples", "4"], "14 4-mode CIS", (K2A, K2B)),
        ([*short, "--num-importance-samples", "-1"], "15 4-mode independence MH",
         (K2A, K2B)),
        ([*short, "--ot-cond-flow"], "16 4-mode OT coupling", (K2A, K2B)),
        (["--example", "phi-four", "--do-smc", "--learning-iter", "1000"], "17 phi-four SMC",
         (K3, K2A)),
        (["--example", "pines", "--do-smc", "--learning-iter", "500"], "18 pines SMC", (K2A,)),
        (["--example", "phi-four", "--mcmc-kernel", "nuts", "--learning-iter", "50"],
         "19 phi-four NUTS", (K3, GATE, K2A)),
        (["--example", "4-mode", "--do-smc", "--mcmc-kernel", "hmc", "--set", "smc_path=geometric",
          "--set", "waste_free_p=4", "--learning-iter", "25"], "20 4-mode HMC waste-free SMC",
         (K2A, K2B)),
        (["--example", "pines", "--learning-iter", "15", "--flow-smc", "1"], "21 pines flow-SMC",
         (K2A,)),
        (["--example", "phi-four", "--do-fab", "--learning-iter", "3"], "22 phi-four FAB",
         (K3, K2A)),
        (["--example", "phi-four", "--do-flowmc", "--learning-iter", "50"],
         "23 phi-four flowMC", (K3, K2A)),
        (["--example", "phi-four", "--do-dds", "--learning-iter", "10"], "24 phi-four DDS",
         (K3, K2A)),
        (["--example", "4-mode", "--do-fab", "--learning-iter", "5"], "25 4-mode FAB",
         (K2A, K2B)),
        (["--example", "pines", "--learning-iter", "15", "--move-correct", "50"],
         "26 pines move correction", (K2A,)),
        ([*short, "--flow-smc", "1", "--move-correct", "25"], "28 4-mode flow-SMC and moves",
         (K2A, K2B)),
    ]
    # the same examples with --vmap-seeds and no --seed: the CLI's 10 seeds
    # as one sweep at full width (per-seed eval on 1,280 samples), each
    # beside its single-seed phase
    seeds_eval = ["--set", "eval_iter=10"]
    seed_phases = [
        (["--example", "4-mode", "--learning-iter", "15", *seeds_eval],
         "29 4-mode seeds", (K2A, K2B), "8 4-mode"),
        (["--example", "phi-four", "--learning-iter", "15", *seeds_eval],
         "30 phi-four seeds", (K3, GATE, K2A), "5 phi-four"),
        (["--example", "phi-four", "--learning-iter", "50", *FUSED, *seeds_eval],
         "31 phi-four fused field seeds", (K1, K3, GATE, K2A), "7 phi-four fused field"),
        (["--example", "pines", "--learning-iter", "10", *seeds_eval], "32 pines seeds",
         (K2A,), "9 pines"),
    ]
    import tempfile

    instrument_training(counters)
    single = {}
    sweeps = {}
    with tempfile.TemporaryDirectory() as tmp:
        run_dir = f"{tmp}/runs"
        beside = start_beside(tmp)
        run_phases(counters, phases + seed_phases, run_dir, single, sweeps)
        before = [f.launches for f in counters]
        phase_seed_equality(torch, run_dir)
        phase_resume(torch, f"{tmp}/ckpt")
        n = {f.__name__: f.launches - b for f, b in zip(counters, before)}
        print("[33-34 launches] " + " ".join(f"{k}={v}" for k, v in n.items()), flush=True)
        if not (n[K1] and n[K2A] and n[K2B]):
            fail("the equality and resume checks launched no K1, K2a or K2b")
        phase_library(torch, counters, tmp)
        join_beside(beside, counters)
        for label, must, fn in (
                ("41 roofline", (K1, K2A, GATE), lambda: phase_roofline(torch)),
                ("42 figures", (), lambda: phase_figures(torch, tmp)),
                ("43 seeds", (K2A, K2B), lambda: phase_seeds(torch))):
            library_phase(torch, counters, label, must, fn)
        for label, fn in (
                ("44 run_mfm mesh", lambda: phase_mesh_run_mfm(torch, counters)),
                ("45 cli mesh", lambda: phase_mesh_cli(torch, counters, run_dir, f"{tmp}/45")),
                ("46 smc and atess mesh",
                 lambda: phase_mesh_smc_atess(torch, counters, run_dir))):
            os.makedirs(f"{tmp}/{label.split()[0]}", exist_ok=True)
            library_phase(torch, counters, label, (), fn)
    report["field_apply"]["seed_axis"]["sweep_launches_per_iteration"] = sweeps[
        "31 phi-four fused field seeds"]["launches_per_it"][K1]
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
    print(f"[chip_smoke] {time.perf_counter() - t_start:.1f} s of wall in all", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-worker"]:
        mesh_worker(sys.argv[2], sys.argv[3])
    elif sys.argv[1:2] == ["--beside"]:
        beside_worker(sys.argv[2], sys.argv[3])
    else:
        main()
