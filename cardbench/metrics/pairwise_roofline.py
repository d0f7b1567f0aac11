"""K2a's and K2b's share of their roofline, in %: the least time the
profiled evaluations' pairwise sums could take, each the largest of its
operations over the fp32 peak, its bytes over HBM's rate and one
special-function result a pair over that pipe's rate (``counts/``), over
the device time of the pairwise kernels by name in the trace (the Gram
route's centring launches included)."""

NAMES = ("stein_", "rbf_", "centre_rows_kernel", "column_mean_kernel")


def read(r):
    t, peaks, sums = r["trace"], r["peaks"], r["work"].get("pairwise")
    if not t or not peaks or not sums or not r["profiled_units"]:
        return None
    seconds = sum(v[1] for name, v in t["kernels"].items() if any(n in name for n in NAMES))
    if seconds <= 0:
        return None
    bound = sum(max(flops / peaks["fp32"], nbytes / peaks["hbm"], pairs / peaks["sfu"])
                for pairs, flops, nbytes in sums)
    return 100.0 * r["profiled_units"] * bound / seconds
