"""End-to-end solver tests on the pendulum.

Mirrors the reference driver test/pendulum_ddp.cpp: swing-up to q = 3.14,
horizon 200, dt = 0.01, terminal config constraint through a double
constraint_advance_time, method primal_dual_affine_multipliers — promoted
from print-and-inspect to real asserts (SURVEY.md §4 implications).
"""

import jax
import jax.numpy as jnp
import pytest

from ddp_jax.models.pendulum import pendulum
from ddp_jax.ocp import constraints, costs, dynamics
from ddp_jax.ocp.problem import Problem
from ddp_jax.solver.solve import Method, SolverParams, solve

HORIZON = 200
DT = 0.01


def make_problem(second_order=True, dtype=jnp.float64):
    model = pendulum(1.0, 1.0, dtype=dtype)
    dyn = dynamics.euler(model, DT)
    # reference: constraint target q = 3.14 at t = horizon, advanced twice
    # (test/pendulum_ddp.cpp:35-56) → active at t = horizon - 2
    con = constraints.advance_time(
        constraints.ConfigTarget(
            model=model,
            target=jnp.asarray([3.14], dtype=dtype),
            active_ts=(HORIZON,),
        ),
        dyn,
        times=2,
    )
    cost = costs.quad_control(1.0, dtype=dtype)
    return Problem(
        dynamics=dyn, cost=cost, constraint=con, horizon=HORIZON, second_order=second_order
    )


@pytest.mark.parametrize(
    "method", [Method.PRIMAL_DUAL_AFFINE, Method.PRIMAL_DUAL_CONSTANT]
)
def test_pendulum_swingup_constrained(method):
    problem = make_problem()
    params = SolverParams(max_iterations=60, threshold=1e-9, mu=1e8)
    x0 = jnp.zeros((2,), dtype=jnp.float64)

    result = jax.jit(
        lambda x: solve(problem, params, x, method=method)
    )(x0)

    # terminal constraint: q two-steps-ahead of t=H-2 reaches 3.14;
    # the realized final state must be at the target
    q_final = result.xs[-1, 0]
    assert abs(float(q_final) - 3.14) < 1e-5, f"q_final={q_final}"
    assert float(result.stats.opt_constr) < 1e-6
    if method is Method.PRIMAL_DUAL_AFFINE:
        # affine multipliers reach full stationarity within the budget;
        # constant multipliers satisfy the constraint but polish the
        # Lagrangian gradient more slowly (no state-feedback term)
        assert bool(result.stats.converged)


def test_pendulum_swingup_ilqr_mode():
    """Gauss-Newton (iLQR) mode also solves the constrained problem."""
    problem = make_problem(second_order=False)
    params = SolverParams(max_iterations=80, threshold=1e-9, mu=1e8)
    x0 = jnp.zeros((2,), dtype=jnp.float64)
    result = solve(problem, params, x0)
    assert abs(float(result.xs[-1, 0]) - 3.14) < 1e-5


def test_solve_vmap_batch():
    """The whole solve vmaps over initial states (the primary batch scaling
    axis, SURVEY.md §2 parallelism table)."""
    problem = make_problem()
    params = SolverParams(max_iterations=60, threshold=1e-9, mu=1e8)
    x0s = jnp.stack(
        [jnp.array([q0, 0.0]) for q0 in (-0.3, 0.0, 0.2, 0.5)]
    )
    results = jax.jit(jax.vmap(lambda x: solve(problem, params, x)))(x0s)
    assert results.xs.shape == (4, HORIZON + 1, 2)
    final_q = results.xs[:, -1, 0]
    assert jnp.all(jnp.abs(final_q - 3.14) < 1e-4), final_q


def test_constraint_satisfied_exactly_at_optimum():
    problem = make_problem()
    params = SolverParams(max_iterations=60, threshold=1e-9, mu=1e8)
    result = solve(problem, params, jnp.zeros((2,)))
    # masked constraint residual along the final trajectory
    eq = problem.eq_all(result.xs, result.us)
    assert float(jnp.max(jnp.abs(eq))) < 1e-6


@pytest.mark.slow
def test_stacked_and_trajectory_constraints():
    """StackConstraints (row-concat analog) + TrajectoryConfigTarget with a
    periodic schedule solve end-to-end."""
    from ddp_jax.ocp.constraints import StackConstraints, TrajectoryConfigTarget

    H = 60
    dtype = jnp.float64
    model = pendulum(1.0, 1.0, dtype=dtype)
    dyn = dynamics.euler(model, DT)
    # waypoint tracking: pass through q=0.8 at t=30, q=1.5 at t=60 (via the
    # same double time-advance as the terminal constraint)
    targets = jnp.zeros((H + 1, 1), dtype).at[30].set(0.8).at[H].set(1.5)
    track = constraints.advance_time(
        TrajectoryConfigTarget(model=model, targets=targets, active_ts=(30, H)),
        dyn,
        times=2,
    )
    con = StackConstraints(parts=(track,))
    problem = Problem(
        dynamics=dyn,
        cost=costs.quad_control(1.0, dtype=dtype),
        constraint=con,
        horizon=H,
    )
    params = SolverParams(max_iterations=50, threshold=1e-8, mu=1e8)
    res = solve(problem, params, jnp.zeros(2, dtype))
    assert float(res.stats.opt_constr) < 1e-6
    # waypoints hit: q at t=30 and t=60
    assert abs(float(res.xs[30, 0]) - 0.8) < 1e-5
    assert abs(float(res.xs[H, 0]) - 1.5) < 1e-5
