"""One MFM training run spanning processes (counterpart of
``benchmarks/run_distributed_mfm.py``).

The chains shard over a mesh of every process (``mesh_shape=(1, S)``),
the flow state is replicated, and the summed gradient crosses between
processes as an all-reduce (``drivers/mfm.py``). Each process prints one
JSON line: its id, the global and local devices, the global chain count,
the final loss, beta and mean acceptance, a digest of the gathered global
state (the chains, the flow parameters, beta), a digest of the per-chunk
metrics, the chunk count, the steady iterations a second, and the
kernels' launches in this process. The digests are equal on every rank.

    python -m mfm_tpu_torch.parallel.run_mfm --example phi-four   # 2 processes on cuda
    python -m mfm_tpu_torch.parallel.run_mfm --device cpu --example 4-mode
    # or one command a process (a host):
    python -m mfm_tpu_torch.parallel.run_mfm --process-id 0 --num-processes 2
    python -m mfm_tpu_torch.parallel.run_mfm --process-id 1 --num-processes 2

Without ``--process-id`` it starts ``--num-processes`` local workers in a
session of their own, all on ``--device`` (several share one card, and
then the group is gloo's, ``parallel.mesh.pick_backend``), prints their
lines in process order, and kills the whole session if one fails or the
run outlasts ``--timeout``, so that no rank is left waiting in a
collective.
"""

import argparse
import hashlib
import json
import os
import signal
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_config(example: str, world: int, learning_iter: int, chunk_size: int,
                checkpoint_dir: str = ""):
    """The reference demo's two configurations (4-mode at 16 wide; phi-four
    d=64 with 1,024 chains, ``step_size=1e-4``, ``mcmc_per_flow_steps=100``)
    on a mesh (1, world)."""
    from mfm_tpu_torch.config import MFMConfig

    common = dict(
        learning_iter=learning_iter, chunk_size=chunk_size or learning_iter,
        mesh_shape=(1, world) if world > 1 else None,
        checkpoint_dir=checkpoint_dir or None, checkpoint_every_chunks=1 if checkpoint_dir else 0,
    )
    if example == "phi-four":
        return MFMConfig(example="phi-four", dim=64, num_chain=1024, step_size=1e-4,
                         mcmc_per_flow_steps=100.0, **common)
    return MFMConfig(example="4-mode", dim=2, num_chain=max(4 * world, 16), hidden_x=(16,),
                     hidden_t=(16,), hidden_xt=(16,), fourier_dim=8, ode_steps=4,
                     mcmc_per_flow_steps=2.0, **common)


def make_target(example: str, device):
    from mfm_tpu_torch.targets import PhiFour, four_mode_mixture

    return PhiFour(64, device=device) if example == "phi-four" else four_mode_mixture(device)


def digest(tensors) -> str:
    """SHA-256 of the tensors' bytes, in order."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


class ChunkCollector:
    """Every chunk's means (replicated, so equal on every rank); the wall
    clock apart, since it differs between ranks."""

    def __init__(self):
        self.chunks, self.times = [], []

    def log(self, m):
        self.times.append(float(m.get("train_time", 0.0)))
        self.chunks.append({k: round(float(v), 6) for k, v in m.items() if k != "train_time"})


def train(example: str, cfg, device):
    """``run_mfm`` of ``cfg`` with a ``ChunkCollector``: (run, collector, the
    kernels' launches during the run)."""
    import torch

    from mfm_tpu_torch.drivers import run_mfm
    from mfm_tpu_torch.ops import field, pairwise, phi_four

    counters = (field.field_apply, pairwise.stein_pairwise_sum, pairwise.rbf_kernel_sum,
                phi_four.phi_four_value_and_score, phi_four.phi_four_score_gate)
    before = [f.launches for f in counters]
    collector = ChunkCollector()
    run = run_mfm(make_target(example, device), cfg, device, logger=collector)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return run, collector, {f.__name__: f.launches - b for f, b in zip(counters, before)}


def summary(run, cfg, collector, launches, process_id: int, world: int) -> dict:
    import torch

    chunk = cfg.chunk_size
    return {
        "process_id": process_id,
        "global_devices": world,
        "local_devices": 1,
        "num_chain_global": cfg.num_chain,
        "final_loss": round(float(run.metrics["loss"][-1]), 4),
        "final_beta": float(run.beta),
        "mean_acceptance": round(float(torch.nanmean(run.metrics["acceptance_mean"])), 4),
        "state_digest": digest([run.chain.position, *run.train.params.values(), run.beta]),
        "chunks_digest": hashlib.sha256(
            json.dumps(collector.chunks, sort_keys=True).encode()).hexdigest(),
        "n_chunks": len(collector.chunks),
        "steady_iters_per_sec": round(
            (cfg.learning_iter - chunk) / max(collector.times[-1] - collector.times[0], 1e-9), 3)
        if len(collector.times) > 1 else None,
        "launches": launches,
    }


def worker(args) -> None:
    import torch
    import torch.distributed as dist

    from mfm_tpu_torch.parallel.distributed import initialize_distributed
    from mfm_tpu_torch.parallel.mesh import device_of_rank, pick_backend

    device = device_of_rank(args.device, args.process_id)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda: no CUDA device is available")
        torch.cuda.set_device(device)
    cfg = make_config(args.example, args.num_processes, args.learning_iter, args.chunk_size,
                      args.checkpoint_dir)  # checked before the first collective
    initialize_distributed(args.coordinator, args.num_processes, args.process_id,
                           backend=pick_backend(device, local_world_size=args.num_processes))
    try:
        run, collector, launches = train(args.example, cfg, device)
        print(json.dumps(summary(run, cfg, collector, launches, args.process_id,
                                 args.num_processes)), flush=True)
    finally:
        dist.destroy_process_group()


def launch(args) -> int:
    """Start the workers in a session of their own, each with its stdout
    apart; if one fails or ``args.timeout`` passes, kill the session.
    Prints their lines in process order; returns the worst exit code."""
    procs = []
    for pid in range(args.num_processes):
        cmd = [sys.executable, "-m", "mfm_tpu_torch.parallel.run_mfm",
               "--process-id", str(pid), "--num-processes", str(args.num_processes),
               "--coordinator", args.coordinator, "--example", args.example,
               "--learning-iter", str(args.learning_iter), "--chunk-size", str(args.chunk_size),
               "--device", args.device]
        if args.checkpoint_dir:
            cmd += ["--checkpoint-dir", args.checkpoint_dir]
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True, cwd=ROOT,
                                      start_new_session=True))
    deadline = time.monotonic() + args.timeout
    failed = False
    try:
        while any(p.poll() is None for p in procs):
            if any(p.returncode for p in procs if p.returncode is not None):
                failed = True
                break
            if time.monotonic() > deadline:
                print(f"run_mfm: the workers outlasted --timeout {args.timeout} s",
                      file=sys.stderr)
                failed = True
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
    rc = 0
    for p in procs:
        out, _ = p.communicate()
        sys.stdout.write(out)
        rc = max(rc, abs(p.returncode))
    return rc if rc or not failed else 1


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--num-processes", type=int, default=2)
    p.add_argument("--coordinator", default="localhost:13099",
                   help="host:port where process 0 listens")
    p.add_argument("--example", default="4-mode", choices=["4-mode", "phi-four"])
    p.add_argument("--learning-iter", type=int, default=20)
    p.add_argument("--chunk-size", type=int, default=0,
                   help="iterations a logged chunk (0: one chunk for the whole run)")
    p.add_argument("--checkpoint-dir", default="",
                   help="save every chunk there (each rank its rows) and resume from the latest")
    p.add_argument("--device", default="cuda", help="torch device of every process")
    p.add_argument("--timeout", type=float, default=600.0,
                   help="seconds before the launcher kills every worker")
    args = p.parse_args(argv)
    if args.process_id is None:
        sys.exit(launch(args))
    worker(args)


if __name__ == "__main__":
    main()
