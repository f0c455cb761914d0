"""Augmented-Lagrangian machinery: multipliers, AL cost, optimality measures.

Reference analogs:
- constant/affine multiplier sequences + update_origin re-expansion
  (mat_seq_common.hpp:12-265, ddp.hpp:311-390)
- cost_seq_aug (ddp.hpp:699-735)
- optimality_constr / optimality_obj (ddp.hpp:516-627)
- the multiplier update rule (ddp.hpp:677-695)

Multipliers are state-affine functions per timestep:
    p_t(x) = val_t + jac_t · (x ⊖ origin_t)
Constant multipliers are the jac ≡ 0 special case (the reference's zero_t
compile-time trick, zero.hpp:8-42, costs nothing at these dims).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ddp_jax.models.base import (
    state_difference,
    state_difference_jacobian,
)


class AffineMults(NamedTuple):
    """Per-step affine vector function seq (≙ affine_vector_function_seq_t)."""

    val: jax.Array  # [T, m]
    jac: jax.Array  # [T, m, ndx]
    origin: jax.Array  # [T, nx]   (full state incl. quaternion coords)


def init_multipliers(problem, xs, jac_init: jax.Array | None = None) -> AffineMults:
    """Zero multipliers anchored at the trajectory states.

    The reference zeroes values then sets jac *random* and origin = x_t in
    solve() (ddp.hpp:759-764).  Pass ``jac_init`` to reproduce that; the
    default (zeros) is the sane choice and converges identically in our
    float64 reruns.
    """
    T, ne, ndx = problem.horizon, problem.ne, problem.ndx
    dtype = xs.dtype
    jac = jnp.zeros((T, ne, ndx), dtype=dtype) if jac_init is None else jac_init
    return AffineMults(
        val=jnp.zeros((T, ne), dtype=dtype),
        jac=jac,
        origin=xs[:-1],
    )


def eval_mults(model, mults: AffineMults, xs) -> jax.Array:
    """p_t(x_t) for a whole trajectory: [T, m].

    ≙ affine_vector_function_seq_t::operator() (mat_seq_common.hpp:106-115).
    """

    def one(val, jac, origin, x):
        return val + jac @ state_difference(model, origin, x)

    return jax.vmap(one)(mults.val, mults.jac, mults.origin, xs[:-1])


def update_origin(model, mults: AffineMults, xs) -> AffineMults:
    """Re-expand the affine functions about a new trajectory.

    ≙ update_origin (mat_seq_common.hpp:62-89):
        val += jac·(x_new ⊖ origin);  jac = jac·d_diff_dfinish;  origin = x_new
    """

    def one(val, jac, origin, x_new):
        d = state_difference(model, origin, x_new)
        J = state_difference_jacobian(model, origin, x_new)
        return val + jac @ d, jac @ J, x_new

    val, jac, origin = jax.vmap(one)(mults.val, mults.jac, mults.origin, xs[:-1])
    return AffineMults(val=val, jac=jac, origin=origin)


def al_costs(problem, xs, us, mults: AffineMults, mu) -> jax.Array:
    """Per-step augmented-Lagrangian cost [T+1]: l + p(x)·eq + (μ/2)‖eq‖²,
    with lf(x_T) in the last slot.  ≙ cost_seq_aug (ddp.hpp:699-735).

    The constraint penalty is evaluated only at the statically-active
    timesteps (problem.active_ts()) — inactive steps contribute exactly
    zero, and skipping them keeps the line-search rollouts from paying T
    constraint evaluations (each a dynamics chain under AdvanceTime) per
    candidate."""
    import numpy as np

    T = problem.horizon
    ts = jnp.arange(T)
    mask = jnp.asarray(problem.eq_mask(), dtype=xs.dtype)

    stage = jax.vmap(lambda t, x, u: problem.cost.stage(t, x, u))(ts, xs[:-1], us)

    active = problem.active_ts() if hasattr(problem, "active_ts") else tuple(range(T))
    if problem.ne and active:

        def pen(t, x, u, p, m):
            ce = problem.constraint.value(t, x, u) * m
            return jnp.dot(p, ce) + 0.5 * mu * jnp.dot(ce, ce)

        if len(active) == T:
            pe = eval_mults(problem.model, mults, xs)
            stage = stage + jax.vmap(pen)(ts, xs[:-1], us, pe, mask)
        else:
            ts_a = np.asarray(active)
            sub = AffineMults(
                mults.val[ts_a], mults.jac[ts_a], mults.origin[ts_a]
            )
            pe_a = jax.vmap(
                lambda val, jac, origin, x: val
                + jac @ state_difference(problem.model, origin, x)
            )(sub.val, sub.jac, sub.origin, xs[:-1][ts_a])
            pen_a = jax.vmap(pen)(
                jnp.asarray(ts_a), xs[:-1][ts_a], us[ts_a], pe_a, mask[ts_a]
            )
            stage = stage.at[ts_a].add(pen_a)
    return jnp.concatenate([stage, problem.cost.terminal(xs[-1])[None]])


def optimality_constr(derivs) -> jax.Array:
    """max_t ‖eq_t‖ (ddp.hpp:516-523)."""
    norms = jnp.linalg.norm(derivs.eq, axis=-1)
    return jnp.max(norms) if norms.shape[0] else jnp.zeros(())


def optimality_obj(problem, derivs, mult_val, mult_jac, mu) -> jax.Array:
    """max_t ‖∂L_aug/∂u_t‖ via the reverse adjoint recursion (ddp.hpp:575-627).

    ``mult_val``/``mult_jac`` must already be expressed at the trajectory
    (origin == x_t), which update_origin guarantees.
    """

    def step(adj, inp):
        lx, lu, fx, fu, eqv, eqx, equ, pe, pex = inp
        lu_aug = lu + equ.T @ pe + mu * (equ.T @ eqv) + fu.T @ adj
        score = jnp.linalg.norm(lu_aug)
        adj_new = fx.T @ adj + lx + mu * (eqx.T @ eqv) + eqx.T @ pe + pex.T @ eqv
        return adj_new, score

    inputs = (
        derivs.lx, derivs.lu, derivs.fx, derivs.fu,
        derivs.eq, derivs.eqx, derivs.equ, mult_val, mult_jac,
    )  # fmt: skip
    # HIGHEST matmul precision: this measure gates the multiplier updates —
    # bf16 matvec noise here stalls/trips the schedule nondeterministically
    with jax.default_matmul_precision("highest"):
        _, scores = jax.lax.scan(step, derivs.lfx, inputs, reverse=True)
    return jnp.max(scores)


def optimality_lag(problem, derivs, mult_val, mult_jac) -> jax.Array:
    """Same recursion without the μ·eq penalty terms (ddp.hpp:525-573)."""

    def step(adj, inp):
        lx, lu, fx, fu, eqv, eqx, equ, pe, pex = inp
        lu_aug = lu + equ.T @ pe + fu.T @ adj
        score = jnp.linalg.norm(lu_aug)
        adj_new = fx.T @ adj + lx + eqx.T @ pe + pex.T @ eqv
        return adj_new, score

    inputs = (
        derivs.lx, derivs.lu, derivs.fx, derivs.fu,
        derivs.eq, derivs.eqx, derivs.equ, mult_val, mult_jac,
    )  # fmt: skip
    with jax.default_matmul_precision("highest"):
        _, scores = jax.lax.scan(step, derivs.lfx, inputs, reverse=True)
    return jnp.max(scores)
