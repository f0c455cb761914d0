"""Throughput-mode (static-control-flow) batched solver tests."""

import pytest

import jax
import jax.numpy as jnp
import numpy as np

from ddp_jax.models.pendulum import pendulum
from ddp_jax.ocp import constraints, costs, dynamics
from ddp_jax.ocp.problem import Problem
from ddp_jax.solver.batched import solve_batched
from ddp_jax.solver.solve import SolverParams, solve

HORIZON = 100
DT = 0.01


def make_problem(dtype=jnp.float64):
    model = pendulum(1.0, 1.0, dtype=dtype)
    dyn = dynamics.euler(model, DT)
    con = constraints.advance_time(
        constraints.ConfigTarget(
            model=model, target=jnp.asarray([3.14], dtype=dtype), active_ts=(HORIZON,)
        ),
        dyn,
        times=2,
    )
    return Problem(
        dynamics=dyn,
        cost=costs.quad_control(1.0, dtype=dtype),
        constraint=con,
        horizon=HORIZON,
    )


def test_batched_matches_whileloop_solver():
    """Static-control-flow path reaches the same optimum as the reference-
    faithful while_loop path (same trajectories within tolerance)."""
    problem = make_problem()
    params = SolverParams(max_iterations=40, threshold=1e-9, mu=1e8)
    x0s = jnp.stack([jnp.array([q, 0.0]) for q in (-0.4, 0.0, 0.3)])

    batched = jax.jit(lambda x: solve_batched(problem, params, x))(x0s)
    ref = jax.jit(jax.vmap(lambda x: solve(problem, params, x)))(x0s)

    assert np.max(batched.opt_constr) < 1e-7
    np.testing.assert_allclose(batched.xs[:, -1, 0], 3.14, atol=1e-6)
    # swing-up is nonconvex (discrete pump-swing basins): for clean-path
    # samples the two solvers land on identical controls; for samples whose
    # early factorizations fail the recovery policies differ and may select
    # different (equally feasible) basins — so compare controls on the clean
    # samples and costs within a basin-sized factor on the rest
    np.testing.assert_allclose(
        np.asarray(batched.us[1:]), np.asarray(ref.us[1:]), atol=1e-4
    )
    cost_b = 0.5 * np.sum(np.asarray(batched.us) ** 2, axis=(1, 2))
    cost_r = 0.5 * np.sum(np.asarray(ref.us) ** 2, axis=(1, 2))
    assert np.all(cost_b < 1.5 * cost_r)


def test_batched_cholesky_failure_recovery():
    """Samples whose first factorization fails must still converge (per-
    sample reg/μ escalation replaces the reference's sweep restart)."""
    problem = make_problem()
    params = SolverParams(max_iterations=50, threshold=1e-9, mu=1e8)
    # spread of initial states, including ones that trigger early
    # factorization failures at this μ
    x0s = jnp.stack([jnp.array([q, 0.0]) for q in (-0.3, 0.0, 0.2, 0.5)])
    res = jax.jit(lambda x: solve_batched(problem, params, x))(x0s)
    assert np.all(np.isfinite(np.asarray(res.us)))
    np.testing.assert_allclose(res.xs[:, -1, 0], 3.14, atol=1e-5)
    assert float(jnp.max(res.opt_constr)) < 1e-6


def test_batched_float32():
    """f32 (the bench dtype) solves to f32-appropriate tolerance."""
    problem = make_problem(dtype=jnp.float32)
    params = SolverParams(max_iterations=30, threshold=1e-5, mu=1e4)
    x0s = jnp.zeros((4, 2), jnp.float32)
    res = jax.jit(lambda x: solve_batched(problem, params, x))(x0s)
    assert np.all(np.isfinite(np.asarray(res.us)))
    np.testing.assert_allclose(res.xs[:, -1, 0], 3.14, atol=5e-2)


@pytest.mark.slow
def test_batched_pallas_backend_matches_sweep():
    """backward="pallas" (interpret mode on CPU) reaches the same solution
    as the default XLA sweep backend at the full-solve level."""
    base = make_problem(dtype=jnp.float32)
    # GN mode here matches the bench config; the pallas backend also supports
    # full second-order (covered by tests/test_pallas_riccati.py)
    problem = Problem(
        dynamics=base.dynamics,
        cost=base.cost,
        constraint=base.constraint,
        horizon=base.horizon,
        second_order=False,
    )
    params = SolverParams(max_iterations=12, threshold=1e-5, mu=1e4)
    x0s = jnp.stack([jnp.array([q, 0.0], jnp.float32) for q in (-0.4, 0.0, 0.3, 0.6)])

    ref = jax.jit(lambda x: solve_batched(problem, params, x))(x0s)
    pal = jax.jit(
        lambda x: solve_batched(problem, params, x, backward="pallas", interpret=True)
    )(x0s)
    assert np.all(np.isfinite(np.asarray(pal.us)))
    np.testing.assert_allclose(
        np.asarray(pal.us), np.asarray(ref.us), rtol=1e-3, atol=1e-3
    )
    np.testing.assert_allclose(
        np.asarray(pal.xs[:, -1]), np.asarray(ref.xs[:, -1]), atol=1e-3
    )


def test_matmul_precision_knob_plumbs_through():
    """matmul_precision pins every stage's matmul passes (the arm
    feasibility-tail fix — docs/DESIGN.md 'Reduced-precision matmul passes
    and the arm feasibility tail').  On CPU all precisions are true
    f32/f64, so the knob must be a bit-exact no-op here."""
    problem = make_problem(dtype=jnp.float32)
    params = SolverParams(max_iterations=3, threshold=1e-5, mu=1e4, inner_iters_max=1)
    x0s = jnp.stack([jnp.asarray([0.1 * i, 0.0], jnp.float32) for i in range(4)])
    r0 = jax.jit(lambda x: solve_batched(problem, params, x))(x0s)
    r1 = jax.jit(
        lambda x: solve_batched(problem, params, x, matmul_precision="highest")
    )(x0s)
    np.testing.assert_array_equal(np.asarray(r0.us), np.asarray(r1.us))
    rs = jax.jit(
        lambda x: solve(problem, params, x0s[1], matmul_precision="highest")
    )(x0s)
    assert np.isfinite(np.asarray(rs.us)).all()


def test_forward_seq_matches_sweep_bitwise():
    """forward="seq" (early-exit ladder) must select the identical candidate
    as the parallel sweep — first accepted = largest accepted — so full f64
    solves agree bit-for-bit, including samples whose ladders bottom out."""
    problem = make_problem()
    params = SolverParams(max_iterations=25, threshold=1e-9, mu=1e8)
    x0s = jnp.stack([jnp.array([q, 0.0]) for q in (-0.4, 0.0, 0.3, 0.5)])

    ref = jax.jit(lambda x: solve_batched(problem, params, x))(x0s)
    seq = jax.jit(lambda x: solve_batched(problem, params, x, forward="seq"))(x0s)
    np.testing.assert_array_equal(np.asarray(seq.us), np.asarray(ref.us))
    np.testing.assert_array_equal(np.asarray(seq.xs), np.asarray(ref.xs))
    np.testing.assert_array_equal(
        np.asarray(seq.opt_constr), np.asarray(ref.opt_constr)
    )


def test_forward_seq_precise_cost_matches_sweep():
    """The early-exit ladder composes with double-float acceptance sums."""
    problem = make_problem(dtype=jnp.float32)
    params = SolverParams(max_iterations=8, threshold=1e-5, mu=1e4, inner_iters_max=1)
    x0s = jnp.stack([jnp.asarray([0.1 * i, 0.0], jnp.float32) for i in range(4)])
    ref = jax.jit(
        lambda x: solve_batched(problem, params, x, precise_cost=True)
    )(x0s)
    seq = jax.jit(
        lambda x: solve_batched(problem, params, x, forward="seq", precise_cost=True)
    )(x0s)
    np.testing.assert_array_equal(np.asarray(seq.us), np.asarray(ref.us))


def test_give_up_after_freezes_racing_lane_only():
    """give_up_after: a lane warm-started into the μ-race (μ₀ absurdly high →
    penalty-stiff, every candidate rejected) goes dead after the streak and
    freezes (μ, reg, trajectory), while the healthy lanes are bit-identical
    to a solve without give-up.  ≙ the production panda7 rescue pattern:
    dead lanes stop holding the fleet's early-exit ladder hostage and get
    re-solved separately (docs/DESIGN.md "The panda7 f32 tail")."""
    problem = make_problem()
    params = SolverParams(max_iterations=12, threshold=1e-9, mu=1e8)
    x0s = jnp.stack([jnp.array([q, 0.0]) for q in (-0.4, 0.0, 0.3, 0.5)])
    # lane 0 races terminally: μ = inf is the limit of the μ·10 escalation
    # spiral — its Quu never factorizes, every candidate's AL cost is
    # inf/NaN, and no step is ever accepted
    mu0 = jnp.asarray([jnp.inf, 1e8, 1e8, 1e8])

    base = jax.jit(
        lambda x: solve_batched(
            problem, params, x, forward="seq", mu_init=mu0, history=True
        )
    )(x0s)
    gu = jax.jit(
        lambda x: solve_batched(
            problem, params, x, forward="seq", mu_init=mu0, give_up_after=3,
            history=True,
        )
    )(x0s)

    # the racing lane never accepted a step in either run
    assert float(jnp.max(base.history.step[:, 0])) == 0.0
    assert float(jnp.max(gu.history.step[:, 0])) == 0.0
    # healthy lanes: identical decisions and results with and without give-up
    np.testing.assert_array_equal(np.asarray(gu.us[1:]), np.asarray(base.us[1:]))
    np.testing.assert_array_equal(
        np.asarray(gu.history.step[:, 1:]), np.asarray(base.history.step[:, 1:])
    )
    assert np.max(np.asarray(gu.opt_constr[1:])) < 1e-4
    # dead lane: schedule frozen (μ stays at its raced value, never NaN) and
    # its trajectory is the (frozen) incumbent — finite, not NaN-poisoned
    assert bool(jnp.isinf(gu.mu[0]))
    assert bool(jnp.all(jnp.isfinite(gu.us[0])))
    # give_up_after needs the seq ladder
    with pytest.raises(ValueError, match="give_up_after"):
        solve_batched(problem, params, x0s, give_up_after=3)
