"""Kernel launches an iteration: the kernels in the profiled cycles over
their iterations (the profiler trace)."""


def read(r):
    if not r["trace"] or not r["profiled_units"]:
        return None
    return r["trace"]["launches"] / (r["profiled_units"] * r["work"]["iterations_per_unit"])
