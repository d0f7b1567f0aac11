"""The fused score gate's share of its roofline, in %: the least time its
launches in the profiled cycles could take (the larger of operations over
the fp32 peak and bytes over HBM's rate, ``counts/``) over the device time
of its kernels by name in the trace."""


def read(r):
    t, peaks, gate = r["trace"], r["peaks"], r["work"].get("score_gate")
    if not t or not peaks or not gate:
        return None
    runs = [v for name, v in t["kernels"].items() if "phi_four_score_gate" in name]
    launches, seconds = sum(v[0] for v in runs), sum(v[1] for v in runs)
    if not launches or seconds <= 0:
        return None
    bound = max(gate["flops"] / peaks["fp32"], gate["bytes"] / peaks["hbm"])
    return 100.0 * launches * bound / seconds
