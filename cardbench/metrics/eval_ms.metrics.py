"""Milliseconds of an evaluation's metrics: CUDA events around that call in
every evaluation of the traced window, their total over their count."""


def read(r):
    total = r["spans"].get("eval.metrics")
    return total[0] / total[1] if total and total[1] else None
