"""Operations and bytes of the work itself, from the shapes alone, whatever
implements it (a fused kernel does not change them). A multiply-add is two
operations.

The field (``reference/field.py``): its x-dependent layers (x-trunk, joint
trunk, field head) once per row and once more per tangent; its time-only
layers (Fourier features into the t-trunk, the gate head) once per stage
and net, since t is one number a stage. The pairwise sums and the score
gate as ``PERF.md`` section 6 counts them: each unordered pair once, the
points read once.
"""


def dense_flops(fan_in: int, widths) -> (int, int):
    """(operations, width out) of a trunk of Dense layers on one row."""
    total = 0
    for w in widths:
        total += 2 * fan_in * w
        fan_in = w
    return total, fan_in


def field_row_flops(c: dict) -> int:
    """The x-dependent layers on one row: 163,840 for d 64 and widths 128."""
    d = c["dim"]
    fx, hx = dense_flops(d, c["hidden_x"])
    ht = c["hidden_t"][-1]
    fxt, hxt = dense_flops(hx + ht, c["hidden_xt"])
    return fx + fxt + 2 * hxt * d


def field_time_flops(c: dict) -> int:
    """The time-only layers for one t: the t-trunk and the gate head."""
    ft, ht = dense_flops(2 * c["fourier_dim"], c["hidden_t"])
    return ft + 2 * ht * c["dim"]


def transport_flops(c: dict, rows: int, nets: int, tangents: int, gate_per_site: int) -> int:
    """One transport: every RK4 stage, the field on each row and tangent,
    the time-only layers once a net, the score gate on each site and
    tangent."""
    stages = 4 * c["ode_steps"]
    per_stage = (rows * (1 + tangents) * field_row_flops(c) + nets * field_time_flops(c)
                 + gate_per_site * tangents * rows * c["dim"])
    return stages * per_stage


def fm_flops(c: dict, rows: int) -> int:
    """The flow-matching loss, forward and backward (twice the forward), on
    rows that each have their own t."""
    return 3 * rows * (field_row_flops(c) + field_time_flops(c))


def field_params(c: dict) -> int:
    d, F = c["dim"], c["fourier_dim"]
    n, fan = 0, 2 * F
    for w in c["hidden_t"]:
        n, fan = n + fan * w + w, w
    ht, fan = fan, d
    for w in c["hidden_x"]:
        n, fan = n + fan * w + w, w
    fan = fan + ht
    for w in c["hidden_xt"]:
        n, fan = n + fan * w + w, w
    return n + (ht * d + d) + (fan * d + d)


def stein_cost(T: int, d: int):
    """(pairs, operations, bytes) of one Stein sum over T points in d."""
    pairs = T * (T + 1) // 2
    return pairs, pairs * (6 * d + 12), 4 * 2 * T * d + 8


def mmd_cost(m: int, n: int, d: int):
    """(pairs, operations, bytes) of the three RBF sums of one MMD."""
    pairs = m * (m + 1) // 2 + n * (n + 1) // 2 + m * n
    return pairs, pairs * (3 * d + 2), 4 * (m + n) * d + 8


def score_gate_cost(rows: int, d: int, tangents: int):
    """(operations, bytes) of one fused score gate: x, gate and field read,
    field written; the tangents and their field read, the latter written."""
    return 10 * tangents * rows * d, 4 * (4 * rows * d + 3 * tangents * rows * d)
