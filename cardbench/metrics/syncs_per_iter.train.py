"""Host waits on the card an iteration: the program's ``sync`` counter over its
``step.mcmc`` and ``step.flow`` spans (``mfm_tpu_torch.utils.profiling``,
which records only while a profiler runs, so over the profiled cycles). None
where the program has no such spans."""


def read(r):
    from mfm_tpu_torch.utils import profiling

    summarize = getattr(profiling, "summarize", None)
    if summarize is None:
        return None
    got = summarize()
    steps = sum(got["spans"].get(k, {}).get("count", 0) for k in ("step.mcmc", "step.flow"))
    if not steps:
        return None
    return got["counters"].get("sync", 0) / steps
