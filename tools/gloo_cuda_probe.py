"""Which collectives the gloo backend takes on CUDA tensors as they are.

``parallel/mesh.py`` copies every tensor to the host before a gloo
collective, so the port does not depend on the answer; this records it for
the installed torch. Run as two ranks on one card, one collective a run
(a collective that gloo cannot take may abort the process):

    for c in all_reduce all_gather_into_tensor reduce_scatter_tensor broadcast batch_isend_irecv; do
      python -m torch.distributed.run --standalone --nproc-per-node 2 tools/gloo_cuda_probe.py $c
    done

Rank 0 prints one JSON line: the torch version, the collective, and "ok"
or the error it raised. The group's timeout is short, so a collective
that one rank refuses while the other waits in it fails instead of
hanging.
"""

import datetime
import json
import os
import sys

import torch
import torch.distributed as dist


def main():
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", timeout=datetime.timedelta(seconds=20))
    t = torch.ones(8, device="cuda")
    probes = {
        "all_reduce": lambda: dist.all_reduce(t.clone()),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(8 * world, device="cuda"), t),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(8 // world, device="cuda"), t),
        "broadcast": lambda: dist.broadcast(t.clone(), 0),
        "batch_isend_irecv": lambda: [r.wait() for r in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, t, (rank + 1) % world),
            dist.P2POp(dist.irecv, torch.empty_like(t), (rank - 1) % world)])],
    }
    name = sys.argv[1]
    try:
        probes[name]()
        torch.cuda.synchronize()
        out = "ok"
    except (RuntimeError, ValueError, TypeError) as e:
        out = f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"
    if rank == 0:
        print(json.dumps({"torch": torch.__version__, "collective": name, "gloo_on_cuda": out}),
              flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
