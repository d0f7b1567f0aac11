"""Share of the profiled units' wall time with no operation on the card
(the profiler trace), in %."""


def read(r):
    t = r["trace"]
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
