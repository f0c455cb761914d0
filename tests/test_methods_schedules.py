"""Method-variant semantics and constraint-schedule combinators.

Covers the distinct PRIMAL method (zero multiplier
feedback, ≙ the reference's declared no_multiplier_feedback_t/zero_t wiring,
ddp.hpp:365-371 + zero.hpp:8-42), the reference-startup random multiplier-jac
init (ddp.hpp:760-764), and the every_k/in_range schedule helpers
(≙ periodic_row_filter_t / range_row_filter_t, indexer.hpp:328-448)."""

import pytest

import jax
import jax.numpy as jnp
import numpy as np

from ddp_jax.models.pendulum import pendulum
from ddp_jax.ocp import constraints, costs, dynamics
from ddp_jax.ocp.problem import Problem
from ddp_jax.solver import al as al_mod
from ddp_jax.solver.solve import Method, SolverParams, solve


def make_problem(horizon=60, dtype=jnp.float64, constraint=None):
    model = pendulum(1.0, 1.0, dtype=dtype)
    dyn = dynamics.euler(model, 0.01)
    if constraint is None:
        constraint = constraints.advance_time(
            constraints.ConfigTarget(
                model=model,
                target=jnp.asarray([3.14], dtype=dtype),
                active_ts=(horizon,),
            ),
            dyn,
            times=2,
        )
    return Problem(
        dynamics=dyn,
        cost=costs.quad_control(1.0, dtype=dtype),
        constraint=constraint,
        horizon=horizon,
    )


def _run(method, max_iterations=25, mu=1e6):
    problem = make_problem()
    params = SolverParams(max_iterations=max_iterations, threshold=1e-9, mu=mu)
    return jax.jit(lambda x: solve(problem, params, x, method=method))(jnp.zeros(2))


def test_primal_method_distinct_from_constant():
    """PRIMAL (p += μ·eq) and CONSTANT (p += μ·(eq + eq_u·k)) must produce
    different multiplier trajectories on a problem where eq_u ≠ 0."""
    res_p = _run(Method.PRIMAL)
    res_c = _run(Method.PRIMAL_DUAL_CONSTANT)
    # both keep jac pinned to zero …
    assert float(jnp.max(jnp.abs(res_p.mults.jac))) == 0.0
    assert float(jnp.max(jnp.abs(res_c.mults.jac))) == 0.0
    # … but the value sequences differ (the eq_u·k feedback term is nonzero
    # through the AdvanceTime constraint)
    dv = float(jnp.max(jnp.abs(res_p.mults.val - res_c.mults.val)))
    assert dv > 0.0, "PRIMAL must not alias PRIMAL_DUAL_CONSTANT"


@pytest.mark.slow
def test_method_ladder_convergence():
    """Three-method comparison on the pendulum driver config at a matched
    iteration budget.

    Measured behavior (f64, μ₀=1e6, budget 18 — see docs/DESIGN.md "Method
    ladder"): every method solves the swing-up; the feedback-corrected
    CONSTANT update reaches at least the feasibility of the plain PRIMAL
    update (the eq_u·k correction term is what distinguishes them); AFFINE
    converges feasibility more slowly here because its multiplier jac grows
    by ~μ·eq_x per update (the reference's own rule, ddp.hpp:687) and the
    update_origin re-expansion then couples trajectory motion into the
    multiplier values — the reference never observes this because its
    drivers run μ₀=1e20 under MPFR with w=1e-20, which admits at most one
    multiplier update before optimality."""
    budget = 18
    res = {m: _run(m, max_iterations=budget) for m in Method}
    c = {m: float(r.stats.opt_constr) for m, r in res.items()}
    # every method solves the problem …
    for m, r in res.items():
        np.testing.assert_allclose(float(r.xs[-1, 0]), 3.14, atol=5e-2, err_msg=str(m))
        assert c[m] < 1e-4, (m, c)
    # … and the feedback-corrected constant update is at least as feasible
    # as the plain primal update at the same budget
    assert c[Method.PRIMAL_DUAL_CONSTANT] <= 2.0 * c[Method.PRIMAL], c


def test_random_multiplier_jac_init_converges_identically():
    """≙ ddp.hpp:760-764: the reference sets the multiplier jac RANDOM at
    solve start.  A random jac_init must converge to the same optimum as the
    zeros default (backing al.py's docstring claim with evidence)."""
    problem = make_problem()
    params = SolverParams(max_iterations=30, threshold=1e-9, mu=1e6)
    x0 = jnp.zeros(2)

    res_zero = jax.jit(lambda x: solve(problem, params, x))(x0)

    # solve() with random-jac multipliers: reuse the solver internals by
    # seeding through init_multipliers' jac_init hook
    T, ne, ndx = problem.horizon, problem.ne, problem.ndx
    key = jax.random.PRNGKey(0)
    jac0 = 0.5 * jax.random.normal(key, (T, ne, ndx), dtype=jnp.float64)

    us0 = jnp.zeros((T, problem.nu), jnp.float64)
    xs0 = problem.rollout(x0, us0)
    mults = al_mod.init_multipliers(problem, xs0, jac_init=jac0)
    assert float(jnp.max(jnp.abs(mults.jac))) > 0.0

    res_rand = jax.jit(
        lambda x, j: solve(problem, params, x, mults_init_jac=j)
    )(x0, jac0)

    np.testing.assert_allclose(
        float(res_rand.xs[-1, 0]), float(res_zero.xs[-1, 0]), atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(res_rand.us), np.asarray(res_zero.us), atol=1e-5
    )
    assert float(res_rand.stats.opt_constr) < 1e-6


def test_every_k_and_in_range_schedules():
    """Periodic path constraint (every 4th step) stacked with a terminal
    constraint — ≙ composed periodic/row-concat indexers (test/indexing.cpp
    exercises the same composition in the reference)."""
    dtype = jnp.float64
    model = pendulum(1.0, 1.0, dtype=dtype)
    dyn = dynamics.euler(model, 0.01)
    T = 40

    path = constraints.ConfigTarget(
        model=model,
        target=jnp.asarray([0.3], dtype=dtype),
        active_ts=constraints.every_k(10, offset=20),
    )
    terminal = constraints.advance_time(
        constraints.ConfigTarget(
            model=model, target=jnp.asarray([0.3], dtype=dtype), active_ts=(T,)
        ),
        dyn,
        times=2,
    )
    stacked = constraints.StackConstraints(parts=(path, terminal))
    problem = Problem(
        dynamics=dyn,
        cost=costs.quad_control(1.0, dtype=dtype),
        constraint=stacked,
        horizon=T,
    )

    mask = problem.eq_mask()  # [T, 2]
    # column 0: periodic path rows at t = 20, 30
    assert list(np.nonzero(mask[:, 0])[0]) == [20, 30]
    # column 1: terminal (advance-time shifts T → T-2)
    assert list(np.nonzero(mask[:, 1])[0]) == [T - 2]

    params = SolverParams(max_iterations=60, threshold=1e-8, mu=1e6)
    res = jax.jit(lambda x: solve(problem, params, x))(jnp.zeros(2, dtype))
    assert float(res.stats.opt_constr) < 1e-6
    # the path constraint is actually enforced at its scheduled steps
    np.testing.assert_allclose(float(res.xs[20, 0]), 0.3, atol=1e-4)
    np.testing.assert_allclose(float(res.xs[30, 0]), 0.3, atol=1e-4)
    np.testing.assert_allclose(float(res.xs[-1, 0]), 0.3, atol=1e-4)


def test_in_range_schedule_contains():
    s = constraints.in_range(3, 7)
    assert [t for t in range(10) if t in s] == [3, 4, 5, 6]
    p = constraints.every_k(3)
    assert [t for t in range(10) if t in p] == [0, 3, 6, 9]
    p2 = constraints.every_k(3, offset=2)
    assert [t for t in range(10) if t in p2] == [2, 5, 8]


def test_mu_factor_cap_and_mult_safeguard():
    """mu_factor/mu_max bound the penalty escalation and mult_max clips the
    multipliers (round-4 safeguards); the pendulum still converges with all
    three active, and the caps are respected in the history."""
    problem = make_problem()
    params = SolverParams(
        max_iterations=40, threshold=1e-9, mu=1e4,
        mu_factor=3.0, mu_max=1e7, mult_max=1e4,
    )
    res = solve(problem, params, jnp.zeros(2, jnp.float64), history=True)
    assert float(res.stats.opt_constr) < 1e-6
    assert float(jnp.max(res.history.mu)) <= 1e7 + 1e-6
    assert float(jnp.max(jnp.abs(res.mults.val))) <= 1e4 + 1e-9
