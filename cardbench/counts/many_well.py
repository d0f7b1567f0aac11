"""The work of the many-well configuration's evaluation."""

from cardbench.counts import _common as k


def work(config: dict, traffic: dict) -> dict:
    """Operations of one evaluation, and its pairwise sums."""
    c = config["config"]
    n, d = c["eval_iter"] * c["num_chain"], c["dim"]
    # the score gate: gate times the diagonal score derivative on each
    # tangent, and the score once
    transport = k.transport_flops(c, n, 1, d, 3)
    stein = k.stein_cost(n, d)
    mmd = k.mmd_cost(n, n, d)
    pairwise = [stein, stein, mmd, mmd]  # KSD of the draws and of the resampled set; two MMDs
    return {
        "flops_per_unit": transport + sum(p[1] for p in pairwise),
        "transport_flops": transport,
        "row_flops": k.field_row_flops(c),
        "samples_per_unit": n,
        "pairwise": [list(p) for p in pairwise],
    }
