"""Seed replication across processes (counterpart of
``mfm_tpu.parallel.distributed``).

The reference's 10-seed protocol is independent seed by seed: each process
trains its strided share of the seeds, and only the metric rows cross
between processes, in one all-gather, so that every process prints the
same mean +- 1.96 sigma.

- ``initialize_distributed`` brings up ``torch.distributed`` over TCP.
  Only host float64 rows cross, so the group is gloo's on one card or many
  (NCCL cannot put two ranks on one card).
- ``local_seeds`` deals a process its share of the seed list.
- ``allgather_rows`` moves every process's rows to every process.
- ``aggregate_row`` is the reference's mean +- 1.96 sigma.

``python -m mfm_tpu_torch.parallel.run_seeds`` runs the protocol.
"""

import datetime
from typing import Sequence

import numpy as np


def initialize_distributed(coordinator_address: str, num_processes: int, process_id: int,
                           backend: str = "gloo", timeout_s: float = 300.0):
    """Join the process group of ``num_processes`` whose rank 0 listens at
    ``coordinator_address`` (``host:port``, or a ``tcp://`` URL); a process
    that does not arrive within ``timeout_s`` fails the rendezvous.
    Returns ``torch.distributed``."""
    import torch.distributed as dist

    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=url, world_size=num_processes,
                            rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))
    return dist


def local_seeds(seeds: Sequence[int], process_id: int, num_processes: int):
    """This process's strided share. The seeds must split evenly, so that
    the all-gather of the rows has one shape on every process."""
    if len(seeds) % num_processes:
        raise ValueError(
            f"{len(seeds)} seeds do not split evenly over {num_processes} processes; "
            "pad the seed list"
        )
    return list(seeds)[process_id::num_processes]


def allgather_rows(rows_local) -> np.ndarray:
    """Every process's metric rows on every process: (total_rows, k) in
    process order."""
    import torch
    import torch.distributed as dist

    rows = torch.from_numpy(np.atleast_2d(np.asarray(rows_local, np.float64)))
    gathered = [torch.empty_like(rows) for _ in range(dist.get_world_size())]
    dist.all_gather(gathered, rows)
    return torch.cat(gathered).numpy().reshape(-1, rows.shape[-1])


def aggregate_row(rows):
    """mean +- 1.96 sigma over seeds."""
    rows = np.asarray(rows, np.float64)
    return rows.mean(axis=0), 1.96 * rows.std(axis=0)
