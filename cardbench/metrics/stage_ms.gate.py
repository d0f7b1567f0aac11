"""Device milliseconds a transport stage spends on the score gate with its
copies: the CUDA events of the program's ``stage.gate`` spans
(``mfm_tpu_torch.utils.profiling``, which records only while a profiler
runs, so over the profiled cycles), their total over its ``stages`` counter.
None where the program has no such spans or events."""


def read(r):
    from mfm_tpu_torch.utils import profiling

    summarize = getattr(profiling, "summarize", None)
    if summarize is None:
        return None
    got = summarize()
    ms = [row["device_ms"] for path, row in got["spans"].items()
          if path.rsplit("/", 1)[-1] == "stage.gate" and row["device_ms"] is not None]
    stages = got["counters"].get("stages", 0)
    if not ms or not stages:
        return None
    return sum(ms) / stages
