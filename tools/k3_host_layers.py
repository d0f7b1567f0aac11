#!/usr/bin/env python3
"""Host time per call of each layer of K3's launch, on one CUDA card.

    python3 tools/k3_host_layers.py [--reps 2000]

At x (1024, 64) fp32 on the card, each layer called back to back --reps
times after a warm call, on the host clock, ending in a synchronisation
(a launch of 0.5 MB takes far less than its dispatch, so this is the
layer's host time):

1. ``PhiFour(64).value_and_score(x)``, MALA's and the flow-MH accept's call;
2. the ``torch.library`` custom op ``mfm_tpu_torch::phi_four``, which the
   score's and the log-likelihood's derivatives go through;
3. the wrapper ``ops.phi_four.phi_four_value_and_score``;
4. the ctypes call of ``mfm_phi_four`` alone, its outputs allocated once.

It uses only names that every version of the port since K3 has, and
imports the package beside it: copied into an older checkout's ``tools/``,
it times that checkout. Prints the card's name and power limit, then one
JSON line of microseconds per call.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from mfm_tpu_torch.ops import build, phi_four  # noqa: E402
from mfm_tpu_torch.targets import PhiFour  # noqa: E402


def host_us(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e6 * (time.perf_counter() - t0) / reps


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=2000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("k3_host_layers: needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip(), flush=True)

    B, d, a, beta = 1024, 64, 0.1, 20.0
    x = torch.rand((B, d), device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    target = PhiFour(d)
    value, score = torch.empty(B, device="cuda"), torch.empty(B, d, device="cuda")
    fn = build.load_library().mfm_phi_four
    stream = torch.cuda.current_stream().cuda_stream
    c = a * d
    ctypes_args = (x.data_ptr(), B, d, c, 1.0 / (4.0 * c), beta, 0, 0.0,
                   value.data_ptr(), score.data_ptr(), stream)
    layers = {
        "value_and_score_us": lambda: target.value_and_score(x),
        "custom_op_us": lambda: phi_four.phi_four(x, a, beta, False, 0.0, True),
        "wrapper_us": lambda: phi_four.phi_four_value_and_score(x, a, beta, False, 0.0),
        "ctypes_us": lambda: fn(*ctypes_args),
    }
    out = {name: host_us(f, args.reps) for name, f in layers.items()}
    print(json.dumps({"k3_host_layers": out, "reps": args.reps,
                      "device": torch.cuda.get_device_name(0)}), flush=True)


if __name__ == "__main__":
    main()
