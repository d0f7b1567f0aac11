"""Milliseconds of a mcmc iteration: CUDA events around every such
iteration of the traced window, their total over their count."""


def read(r):
    total = r["spans"].get("iter.mcmc")
    return total[0] / total[1] if total and total[1] else None
