"""The work of the phi-four configuration's training cycle."""

from cardbench.counts import _common as k


def work(config: dict, traffic: dict) -> dict:
    """Operations of one whole cycle of the seed sweep, and the score
    gate's shape."""
    c = config["config"]
    S, B, d = traffic["seeds"], c["num_chain"], c["dim"]
    rows = S * B
    cycle = int(c["mcmc_per_flow_steps"]) + 1
    gate_flops, gate_bytes = k.score_gate_cost(rows, d, d)
    flow = 2 * k.transport_flops(c, rows, S, d, 10)  # inverse and forward, exact divergence
    flow += 16 * rows * d  # the target at the proposals
    mcmc = 2 * 16 * rows * d + 10 * rows * d  # the target at the proposal; the MALA move
    per_iter = k.fm_flops(c, rows) + 12 * S * k.field_params(c)  # loss and AdamW
    return {
        "iterations_per_unit": cycle,
        "flops_per_unit": flow + (cycle - 1) * mcmc + cycle * per_iter,
        "flow_flops": flow,
        "row_flops": k.field_row_flops(c),
        "score_gate": {"flops": gate_flops, "bytes": gate_bytes,
                       "launches_per_unit": 2 * 4 * c["ode_steps"]},
    }
