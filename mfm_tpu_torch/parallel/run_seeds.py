"""The reference's seed replication spread over processes (counterpart of
``benchmarks/run_distributed_seeds.py``).

Each process trains its strided share of the seed list on its device, then
one all-gather moves the per-seed metric rows to every process, so that
each prints the same mean +- 1.96 sigma as one JSON line.

    python -m mfm_tpu_torch.parallel.run_seeds                  # 2 processes on cuda
    python -m mfm_tpu_torch.parallel.run_seeds --device cpu
    # or one command a process (a host):
    python -m mfm_tpu_torch.parallel.run_seeds --process-id 0 --num-processes 2
    python -m mfm_tpu_torch.parallel.run_seeds --process-id 1 --num-processes 2

Without ``--process-id`` it starts ``--num-processes`` local workers, all
on ``--device`` (several share one card), prints their lines in process
order, and stops them all if one fails.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
COLUMNS = ("logpdf_star", "stein_u_star", "mmd_star", "train_time")


def seed_row(target, seed: int, learning_iter: int, device) -> list:
    """One seed of the tiny 4-mode configuration: train, sample 256 points
    through the flow, evaluate against 256 exact draws; the row's columns
    are ``COLUMNS``."""
    from mfm_tpu_torch.config import MFMConfig
    from mfm_tpu_torch.drivers import evaluate_samples, run_mfm, sample_flow
    from mfm_tpu_torch.drivers.mfm import EVAL_STREAM, REAL_STREAM, make_generator

    cfg = MFMConfig(
        example="4-mode", dim=2, seed=seed, num_chain=32, learning_iter=learning_iter,
        chunk_size=learning_iter, hidden_x=(16,), hidden_t=(16,), hidden_xt=(16,),
        fourier_dim=8, ode_steps=6, anneal_iter=20, num_anneal_temp=20,
    )
    run = run_mfm(target, cfg, device)
    fs, es, _ = sample_flow(run, 256, target, make_generator(device, seed, EVAL_STREAM))
    real = target.sample(make_generator(device, 1, REAL_STREAM), (256,))  # one set for all seeds
    m = evaluate_samples(target, fs, es, real)
    return [m["logpdf_star"], m["stein_u_star"], m["mmd_star"], run.train_time]


def worker(args) -> None:
    import torch

    from mfm_tpu_torch.parallel.distributed import (
        aggregate_row,
        allgather_rows,
        initialize_distributed,
        local_seeds,
    )
    from mfm_tpu_torch.targets import four_mode_mixture

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    dist = initialize_distributed(args.coordinator, args.num_processes, args.process_id)
    try:
        seeds = local_seeds([i**10 for i in range(args.num_seeds)], args.process_id,
                            args.num_processes)
        target = four_mode_mixture(device)
        rows = [seed_row(target, seed, args.learning_iter, device) for seed in seeds]
        gathered = allgather_rows(rows)
        mean, ci = aggregate_row(gathered)
        print(json.dumps({
            "process_id": args.process_id,
            "local_seeds": seeds,
            "total_rows": int(gathered.shape[0]),
            "world_size": dist.get_world_size(),
            "device": str(device),
            "aggregate_mean": [round(float(v), 6) for v in mean],
            "aggregate_ci95": [round(float(v), 6) for v in ci],
        }), flush=True)
    finally:
        dist.destroy_process_group()


def launch(args) -> None:
    """Start the workers, each with its stdout captured apart so that their
    lines cannot interleave; if one fails, stop the others."""
    procs = []
    for pid in range(args.num_processes):
        cmd = [
            sys.executable, "-m", "mfm_tpu_torch.parallel.run_seeds",
            "--process-id", str(pid), "--num-processes", str(args.num_processes),
            "--coordinator", args.coordinator, "--num-seeds", str(args.num_seeds),
            "--learning-iter", str(args.learning_iter), "--device", args.device,
        ]
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True, cwd=ROOT))
    try:
        while any(p.poll() is None for p in procs):
            if any(p.returncode for p in procs if p.returncode is not None):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    rc = 0
    for p in procs:
        out, _ = p.communicate()
        sys.stdout.write(out)
        rc = max(rc, abs(p.returncode))
    sys.exit(rc)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--num-processes", type=int, default=2)
    p.add_argument("--coordinator", default="localhost:12987",
                   help="host:port where process 0 listens")
    p.add_argument("--num-seeds", type=int, default=4)
    p.add_argument("--learning-iter", type=int, default=30)
    p.add_argument("--device", default="cuda", help="torch device of every process")
    args = p.parse_args(argv)
    if args.process_id is None:
        launch(args)
    else:
        worker(args)


if __name__ == "__main__":
    main()
