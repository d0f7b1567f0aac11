"""Ensemble No-U-Turn Sampler (counterpart of ``mfm_tpu/kernels/nuts.py``):
multinomial NUTS (Betancourt 2017) for the whole (B, d) ensemble, every
leapfrog one batched score pass; chains whose trajectory already ended
(u-turn or divergence) are frozen by masks.

Two variants with the reference's semantics and draws:

- ``static`` (:73-241): the doubling recursion unrolled, 2^j leapfrogs in
  doubling j, a multinomial merge at every internal node of the subtree,
  biased progressive sampling across doublings;
- ``iterative`` (:243-483): one leapfrog a leaf with the power-of-two
  momentum checkpoints for the u-turn checks inside a subtree and
  streaming (reservoir) multinomial sampling of its proposal.

``variant='auto'`` is static up to depth 6 and iterative above (:85-86).

The noise is injected (``NUTSNoise``, drawn by ``draw_noise``): the
momentum's standard normals ``eps`` (B, d), and per doubling j the
direction uniform (``direction_u[j] < 0.5`` is forward, as
``bernoulli(key_dir, 0.5)``), the uniforms of the subtree (``tree_u``) and
the top-level take uniform ``take_u[j]``; ``bernoulli(k, p)`` is
``uniform(k) < p``. ``tree_u`` differs by variant. Static: doubling j's
2^j - 1 internal nodes, in pre-order (a node, its left subtree, its right
subtree; the reference's key_m, key_l, key_r of :129), at rows
2^j - 1 - j onward. Iterative: doubling j's 2^j leaves in order (each
leaf's key_prop, :340,358), at rows 2^j - 1 onward.

Early exit, as the reference's while loops: both variants stop doubling
once no chain is active (one host read a doubling), and the iterative one
stops a subtree once no chain grows (one host read a leaf). Frozen chains
do not move, so the result is the same bit for bit as running every
masked leapfrog, which the reference's static variant does.
"""

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from mfm_tpu_torch.kernels.base import ChainState


class NUTSInfo(NamedTuple):
    acceptance_rate: torch.Tensor  # (B,) mean MH acceptance over the trajectory
    is_divergent: torch.Tensor  # (B,)
    is_turning: torch.Tensor  # (B,)
    num_doublings: torch.Tensor  # (B,) realised tree depth
    energy: torch.Tensor  # (B,)


class NUTSNoise(NamedTuple):
    eps: torch.Tensor  # (B, d) standard normal
    direction_u: torch.Tensor  # (max_depth, B) uniform
    tree_u: torch.Tensor  # (n_tree(max_depth, variant), B) uniform, layout above
    take_u: torch.Tensor  # (max_depth, B) uniform


def resolve_variant(max_depth: int, variant: str = "auto") -> str:
    if variant == "auto":
        return "static" if max_depth <= 6 else "iterative"
    if variant not in ("static", "iterative"):
        raise ValueError(f"unknown NUTS variant {variant!r}")
    return variant


def tree_offset(j: int, variant: str) -> int:
    """First row of doubling j's block in ``tree_u``."""
    return (1 << j) - 1 - j if variant == "static" else (1 << j) - 1


def draw_noise(gen: torch.Generator, B: int, d: int, max_depth: int, variant: str) -> NUTSNoise:
    variant = resolve_variant(max_depth, variant)
    dev = gen.device
    eps = torch.randn((B, d), generator=gen, device=dev)
    u = torch.rand((2 * max_depth + tree_offset(max_depth, variant), B), generator=gen, device=dev)
    return NUTSNoise(eps, u[:max_depth], u[2 * max_depth:], u[max_depth:2 * max_depth])


class _Z(NamedTuple):
    """One phase-space point a chain."""

    q: torch.Tensor
    p: torch.Tensor
    logdens: torch.Tensor
    grad: torch.Tensor


class _Tree(NamedTuple):
    z_left: _Z
    z_right: _Z
    prop_q: torch.Tensor
    prop_logdens: torch.Tensor
    prop_grad: torch.Tensor
    log_weight: torch.Tensor  # logsumexp of -H over the subtree
    turning: torch.Tensor
    diverging: torch.Tensor
    sum_accept: torch.Tensor  # sum of min(1, exp(H0 - H)) over its leaves
    n_leaves: torch.Tensor


def _where_z(mask, a: _Z, b: _Z) -> _Z:
    m = mask[:, None]
    return _Z(
        torch.where(m, a.q, b.q), torch.where(m, a.p, b.p),
        torch.where(mask, a.logdens, b.logdens), torch.where(m, a.grad, b.grad),
    )


def _leapfrog(value_and_score, z: _Z, step_size, inv_mass, direction) -> _Z:
    eps = direction[:, None] * step_size
    p = z.p + 0.5 * eps * z.grad
    q = z.q + eps * (inv_mass * p)
    logdens, grad = value_and_score(q)
    p = p + 0.5 * eps * grad
    return _Z(q, p, logdens, grad)


def _energy(z: _Z, inv_mass):
    return -z.logdens + 0.5 * torch.sum(z.p * z.p * inv_mass, dim=-1)


def _uturn(dq, p_left, p_right, inv_mass):
    return (torch.sum(dq * (inv_mass * p_left), dim=-1) <= 0.0) | (
        torch.sum(dq * (inv_mass * p_right), dim=-1) <= 0.0
    )


def _leaf_delta(h0, z: _Z, inv_mass):
    delta = h0 - _energy(z, inv_mass)
    return torch.where(torch.isnan(delta), -torch.inf, delta)


def _take(active, u, p):
    """``active & bernoulli(p)`` with p clipped to [0, 1], a NaN p taken as 0."""
    p = torch.where(torch.isnan(p), 0.0, p)
    return active & (u < torch.clamp(p, 0.0, 1.0))


def build_kernel(
    value_and_score: Callable,
    max_depth: int = 6,
    divergence_threshold: float = 1000.0,
    variant: str = "auto",
) -> Callable:
    """``kernel(state, step_size, inverse_mass, noise: NUTSNoise) -> (state,
    NUTSInfo)``; ``inverse_mass`` (d,) or None for the identity,
    ``step_size`` a number or a 0-d tensor. One step and one inverse mass a
    chain, (B, 1) and (B, d), also work (a seed sweep's per-seed values on
    its rows)."""
    variant = resolve_variant(max_depth, variant)

    def build_tree(depth, tree_u, z_start, step, inv_mass, direction, h0, active) -> _Tree:
        """Static recursion over the subtree grown from z_start; ``tree_u``
        holds its 2^depth - 1 merge uniforms in pre-order."""
        if depth == 0:
            z = _where_z(active, _leapfrog(value_and_score, z_start, step, inv_mass, direction),
                         z_start)  # frozen chains do not move
            delta = _leaf_delta(h0, z, inv_mass)
            diverging = active & (-delta > divergence_threshold)
            return _Tree(
                z, z, z.q, z.logdens, z.grad, torch.where(active, delta, -torch.inf),
                torch.zeros_like(diverging), diverging,
                torch.where(active, torch.clamp(torch.exp(delta), max=1.0), 0.0),
                active.to(torch.float32),
            )
        half = 1 << (depth - 1)
        left = build_tree(depth - 1, tree_u[1:half], z_start, step, inv_mass, direction, h0,
                          active)
        grow = active & ~left.turning & ~left.diverging
        right = build_tree(depth - 1, tree_u[half:], left.z_right, step, inv_mass, direction,
                           h0, grow)
        # multinomial merge of the proposals (uniform within the subtree)
        total = torch.logaddexp(left.log_weight, right.log_weight)
        take_right = _take(grow, tree_u[0], torch.exp(right.log_weight - total))
        tr = take_right[:, None]
        # the outermost points in the growth direction decide the u-turn
        fwd = direction > 0
        lo = _where_z(fwd, left.z_left, right.z_right)
        hi = _where_z(fwd, right.z_right, left.z_left)
        turning_here = grow & _uturn(hi.q - lo.q, lo.p, hi.p, inv_mass)
        return _Tree(
            left.z_left,
            _where_z(grow, right.z_right, left.z_right),
            torch.where(tr, right.prop_q, left.prop_q),
            torch.where(take_right, right.prop_logdens, left.prop_logdens),
            torch.where(tr, right.prop_grad, left.prop_grad),
            torch.where(grow, total, left.log_weight),
            left.turning | (grow & (right.turning | turning_here)),
            left.diverging | right.diverging,
            left.sum_accept + right.sum_accept,
            left.n_leaves + right.n_leaves,
        )

    def subtree(leaf_u, z_start, step, inv_mass, direction, h0, active) -> _Tree:
        """Iterative: 2^j = len(leaf_u) leaves from z_start, one leapfrog a
        leaf, u-turn checks against the momentum checkpoints."""
        B, d = z_start.q.shape
        ckpt_q = torch.zeros((max_depth + 1, B, d), dtype=z_start.q.dtype, device=z_start.q.device)
        ckpt_p = torch.zeros_like(ckpt_q)
        z = z_start
        pq, pld, pg = z_start.q, z_start.logdens, z_start.grad
        logw = torch.full((B,), -torch.inf, device=z.q.device)
        turning = torch.zeros(B, dtype=torch.bool, device=z.q.device)
        diverging = torch.zeros_like(turning)
        sacc = torch.zeros(B, device=z.q.device)
        nlv = torch.zeros(B, device=z.q.device)
        for i in range(leaf_u.shape[0]):
            grow = active & ~turning & ~diverging
            if not bool(grow.any()):  # host read: the reference's while condition
                break
            z_new = _where_z(grow, _leapfrog(value_and_score, z, step, inv_mass, direction), z)
            delta = _leaf_delta(h0, z_new, inv_mass)
            div_new = grow & (-delta > divergence_threshold)
            leaf_w = torch.where(grow & ~div_new, delta, -torch.inf)
            accept = torch.where(grow, torch.clamp(torch.exp(delta), max=1.0), 0.0)
            # streaming multinomial proposal within the subtree
            total = torch.logaddexp(logw, leaf_w)
            take = _take(grow, leaf_u[i], torch.exp(leaf_w - total))
            tk = take[:, None]
            pq = torch.where(tk, z_new.q, pq)
            pld = torch.where(take, z_new.logdens, pld)
            pg = torch.where(tk, z_new.grad, pg)
            logw = torch.where(grow, total, logw)
            # even leaf i stored at slot popcount(i); odd leaf i checks the
            # subtrees ending at it, whose left ends sit at slots pc-t .. pc-1
            pc = bin(i).count("1")
            if i % 2 == 0:
                ckpt_q[pc] = z_new.q
                ckpt_p[pc] = z_new.p
            else:
                t_ones = bin(i & ~(i + 1)).count("1")
                turn_new = torch.zeros_like(turning)
                for s in range(pc - t_ones, pc):
                    dq = direction[:, None] * (z_new.q - ckpt_q[s])
                    turn_new = turn_new | _uturn(dq, ckpt_p[s], z_new.p, inv_mass)
                turning = turning | (grow & turn_new)
            diverging = diverging | div_new
            sacc = sacc + accept
            nlv = nlv + grow.to(torch.float32)
            z = z_new
        return _Tree(z_start, z, pq, pld, pg, logw, turning, diverging, sacc, nlv)

    def kernel(
        state: ChainState, step_size, inverse_mass: Optional[torch.Tensor], noise: NUTSNoise
    ) -> Tuple[ChainState, NUTSInfo]:
        B, d = state.position.shape
        dev = state.position.device
        inv_mass = torch.ones(d, device=dev) if inverse_mass is None else inverse_mass
        p0 = noise.eps / torch.sqrt(torch.as_tensor(inv_mass))
        z0 = _Z(state.position, p0, state.logdensity, state.logdensity_grad)
        h0 = _energy(z0, inv_mass)
        step = torch.as_tensor(step_size, dtype=state.position.dtype, device=dev)

        traj_left = traj_right = z0
        prop_q, prop_ld, prop_g = z0.q, z0.logdens, z0.grad
        log_w = torch.zeros(B, device=dev)  # exp(h0 - h(z0)) = 1
        active = torch.ones(B, dtype=torch.bool, device=dev)
        turning = torch.zeros_like(active)
        diverging = torch.zeros_like(active)
        sum_accept = torch.zeros(B, device=dev)
        n_leaves = torch.zeros(B, device=dev)
        depths = torch.zeros(B, device=dev)
        for j in range(max_depth):
            if j and not bool(active.any()):  # host read: nothing left to grow
                break
            direction = torch.where(noise.direction_u[j] < 0.5, 1.0, -1.0)
            start = _where_z(direction > 0, traj_right, traj_left)
            off = tree_offset(j, variant)
            if variant == "static":
                sub = build_tree(j, noise.tree_u[off:off + (1 << j) - 1], start, step,
                                 inv_mass, direction, h0, active)
            else:
                sub = subtree(noise.tree_u[off:off + (1 << j)], start, step, inv_mass,
                              direction, h0, active)
            valid = active & ~sub.turning & ~sub.diverging
            # biased progressive sampling across doublings
            take = _take(valid, noise.take_u[j],
                         torch.exp(torch.clamp(sub.log_weight - log_w, max=0.0)))
            tk = take[:, None]
            prop_q = torch.where(tk, sub.prop_q, prop_q)
            prop_ld = torch.where(take, sub.prop_logdens, prop_ld)
            prop_g = torch.where(tk, sub.prop_grad, prop_g)
            log_w = torch.where(valid, torch.logaddexp(log_w, sub.log_weight), log_w)
            # extend the trajectory's ends where the subtree was valid
            fwd = direction > 0
            traj_right, traj_left = (
                _where_z(valid & fwd, sub.z_right, traj_right),
                _where_z(valid & ~fwd, sub.z_right, traj_left),
            )
            full_turn = valid & _uturn(traj_right.q - traj_left.q, traj_left.p, traj_right.p,
                                       inv_mass)
            turning = turning | sub.turning | full_turn
            diverging = diverging | sub.diverging
            sum_accept = sum_accept + sub.sum_accept
            n_leaves = n_leaves + sub.n_leaves
            depths = depths + valid.to(torch.float32)
            active = active & ~sub.turning & ~sub.diverging & ~full_turn

        info = NUTSInfo(
            sum_accept / torch.clamp(n_leaves, min=1.0), diverging, turning, depths,
            _energy(_Z(prop_q, p0, prop_ld, prop_g), inv_mass),
        )
        return ChainState(prop_q, prop_ld, prop_g), info

    return kernel
