"""Host milliseconds an MCMC iteration spends in the flow-matching loss and its
gradient under ``vmap`` over seeds: the program's ``fm_grad`` spans under
``step.mcmc`` (``mfm_tpu_torch.utils.profiling``, which records only while a
profiler runs, so over the profiled cycles), their total over the count of
``step.mcmc``. None where the program has no such spans."""


def read(r):
    from mfm_tpu_torch.utils import profiling

    summarize = getattr(profiling, "summarize", None)
    if summarize is None:
        return None
    rows = summarize()["spans"]
    step, part = rows.get("step.mcmc"), rows.get("step.mcmc/fm_grad")
    if not step or not part:
        return None
    return part["host_ms"] / step["count"]
