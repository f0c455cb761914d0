"""Forward pass: feedback rollout + backtracking line search on the AL cost.

Reference: ``ddp_solver_t::forward_pass`` (ddp_fwd.ipp:9-67):
    u_t = u_old_t + step·k_t + K_t·(x_t ⊖ x_old_t);  x_{t+1} = f(t, x_t, u_t)
accepted iff Σ(cost_new − cost_old) ≤ 0 on the augmented-Lagrangian cost with
the *old* multipliers; otherwise step *= 0.5 down to 1e-10.  The serial
halving loop becomes a ``lax.while_loop`` whose body does one scan rollout —
identical accepted step as the reference's serial search.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ddp_jax.models.base import state_difference
from ddp_jax.solver.al import AffineMults, al_costs


class ForwardResult(NamedTuple):
    xs: jax.Array  # [T+1, nx]
    us: jax.Array  # [T, nu]
    step: jax.Array  # accepted (or last tried) step length
    accepted: jax.Array  # bool


def feedback_rollout(problem, xs_old, us_old, k, K, step, unroll: int = 1):
    """One closed-loop rollout at a given step length (ddp_fwd.ipp:39-51).

    ``unroll`` > 1 trades compile time for fewer while-loop iterations —
    important for small-horizon MPC latency where per-scan-step dispatch
    overhead dominates tiny-model compute."""
    model = problem.model
    ts = jnp.arange(problem.horizon)

    def body(x, inp):
        t, x_old, u_old, k_t, K_t = inp
        dx = state_difference(model, x_old, x)
        u = u_old + step * k_t + K_t @ dx
        x_next = problem.dynamics(t, x, u)
        return x_next, (u, x_next)

    _, (us, xs_next) = jax.lax.scan(
        body, xs_old[0], (ts, xs_old[:-1], us_old, k, K), unroll=unroll
    )
    xs = jnp.concatenate([xs_old[0][None], xs_next], axis=0)
    return xs, us


def forward_pass(
    problem,
    xs_old,
    us_old,
    k,
    K,
    mults: AffineMults,
    mu,
    do_linesearch: bool = True,
    step_min: float = 1e-10,
    precise: bool = False,
) -> ForwardResult:
    """``precise`` evaluates the acceptance sums in double-float
    (solver/precise.py): in f32 the μ‖eq‖² terms drown the control-cost
    differences the test must resolve once μ is large."""
    if precise:
        from ddp_jax.solver.precise import al_cost_total_tf
        from ddp_jax.ops import twofloat as tf

        cost_old_tf = al_cost_total_tf(problem, xs_old, us_old, mults, mu)

        def try_step(step):
            xs, us = feedback_rollout(problem, xs_old, us_old, k, K, step)
            cost_new = al_cost_total_tf(problem, xs, us, mults, mu)
            # compensated Δ, rounded once at the comparison
            delta = tf.to_float(tf.sub(cost_new, cost_old_tf))
            return xs, us, delta

        cost_old = jnp.zeros((), xs_old.dtype)  # deltas are already relative
    else:
        cost_old = jnp.sum(al_costs(problem, xs_old, us_old, mults, mu))

        def try_step(step):
            xs, us = feedback_rollout(problem, xs_old, us_old, k, K, step)
            cost_new = jnp.sum(al_costs(problem, xs, us, mults, mu))
            return xs, us, cost_new

    one = jnp.ones((), dtype=xs_old.dtype)
    xs1, us1, c1 = try_step(one)
    if not do_linesearch:
        return ForwardResult(xs=xs1, us=us1, step=one, accepted=jnp.asarray(True))

    def cond(c):
        step, accepted, *_ = c
        return jnp.logical_and(~accepted, step >= 2 * step_min)

    def body(c):
        step, _, _, _ = c
        step = step * 0.5
        xs, us, cost_new = try_step(step)
        return (step, cost_new - cost_old <= 0, xs, us)

    step, accepted, xs, us = jax.lax.while_loop(
        cond, body, (one, c1 - cost_old <= 0, xs1, us1)
    )
    return ForwardResult(xs=xs, us=us, step=step, accepted=accepted)
