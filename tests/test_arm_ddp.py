"""Articulated-arm DDP: UR5 config-target and spatial (end-effector)
equality constraints, double-pendulum swing-up.

Mirrors the reference drivers test/pinocchio_ddp.cpp (UR5 config constraint,
horizon 10, dt 0.01, primal_dual_affine_multipliers) and
test/pinocchio_spatial_eq_ddp.cpp (UR5 spatial_eq), promoted to asserts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ddp_jax.models import base
from ddp_jax.models.robots import double_pendulum, ee_frame_id, ur5
from ddp_jax.ocp import constraints, costs, dynamics
from ddp_jax.ocp.problem import Problem
from ddp_jax.solver.solve import Method, SolverParams, solve

DT = 0.01


@pytest.fixture(scope="module")
def arm():
    return ur5()


@pytest.mark.slow
def test_ur5_config_constrained_ddp(arm):
    """Reach a (nearby) target configuration at the horizon, as in
    test/pinocchio_ddp.cpp:35-68 (horizon 10, double advance_time)."""
    H = 10
    dyn = dynamics.euler(arm, DT)
    q0 = arm.neutral_configuration()
    q_target = arm.integrate(q0, 0.05 * jnp.arange(1.0, 7.0))
    con = constraints.advance_time(
        constraints.ConfigTarget(model=arm, target=q_target, active_ts=(H,)),
        dyn,
        times=2,
    )
    problem = Problem(
        dynamics=dyn,
        cost=costs.quad_control(1.0, dtype=jnp.float64),
        constraint=con,
        horizon=H,
        second_order=False,  # Gauss-Newton: the reference's scheme-1 analog
    )
    params = SolverParams(max_iterations=45, threshold=1e-8, mu=1e8)
    x0 = base.state_pack(q0, jnp.zeros(arm.nv))
    res = jax.jit(lambda x: solve(problem, params, x))(x0)

    assert float(res.stats.opt_constr) < 1e-5
    # realized final configuration hits the target
    q_final = res.xs[-1, : arm.nq]
    err = arm.difference(q_target, q_final)
    assert float(jnp.max(jnp.abs(err))) < 1e-4, np.asarray(err)


@pytest.mark.slow
def test_ur5_spatial_eq_ddp(arm):
    """spatial_eq variant: end-effector position target at the horizon
    (test/pinocchio_spatial_eq_ddp.cpp:39-63)."""
    H = 12
    dyn = dynamics.euler(arm, DT)
    fid = ee_frame_id(arm)
    q0 = arm.neutral_configuration()
    # reachable target: FK of a nearby configuration
    q_goal = arm.integrate(q0, jnp.asarray([0.2, -0.15, 0.1, 0.05, -0.1, 0.08]))
    p_target = arm.frame_position(fid, q_goal)
    con = constraints.advance_time(
        constraints.FrameTarget(
            model=arm, target=p_target, frame_id=fid, active_ts=(H,)
        ),
        dyn,
        times=2,
    )
    problem = Problem(
        dynamics=dyn,
        cost=costs.quad_control(1.0, dtype=jnp.float64),
        constraint=con,
        horizon=H,
        second_order=False,
    )
    params = SolverParams(max_iterations=55, threshold=1e-8, mu=1e8)
    x0 = base.state_pack(q0, jnp.zeros(arm.nv))
    res = jax.jit(lambda x: solve(problem, params, x))(x0)

    assert float(res.stats.opt_constr) < 1e-5
    p_final = arm.frame_position(fid, res.xs[-1, : arm.nq])
    np.testing.assert_allclose(np.asarray(p_final), np.asarray(p_target), atol=1e-4)


@pytest.mark.slow
def test_double_pendulum_swingup():
    """Acrobat-class swing-up through RNEA/CRBA dynamics with jacfwd
    linearization (BASELINE.json configs[2])."""
    model = double_pendulum()
    H = 150
    dyn = dynamics.euler(model, 0.02)
    q_up = jnp.asarray([jnp.pi, 0.0])
    con = constraints.advance_time(
        constraints.ConfigTarget(model=model, target=q_up, active_ts=(H,)),
        dyn,
        times=2,
    )
    problem = Problem(
        dynamics=dyn,
        cost=costs.quad_control(1e-1, dtype=jnp.float64),
        constraint=con,
        horizon=H,
        second_order=False,
    )
    params = SolverParams(max_iterations=60, threshold=1e-7, mu=1e6)
    x0 = jnp.zeros(4)
    res = jax.jit(lambda x: solve(problem, params, x))(x0)

    assert float(res.stats.opt_constr) < 1e-5
    q_final = res.xs[-1, :2]
    err = model.difference(q_up, q_final)
    assert float(jnp.max(jnp.abs(err))) < 1e-4, np.asarray(q_final)


@pytest.mark.slow
def test_ur5_full_ddp_second_order(arm):
    """Full second-order DDP (dynamics Hessians via jacfwd∘jacfwd) on a
    short-horizon UR5 problem — the reference's default scheme."""
    H = 5
    dyn = dynamics.euler(arm, DT)
    q0 = arm.neutral_configuration()
    q_target = arm.integrate(q0, 0.02 * jnp.ones(6))
    con = constraints.advance_time(
        constraints.ConfigTarget(model=arm, target=q_target, active_ts=(H,)),
        dyn,
        times=2,
    )
    problem = Problem(
        dynamics=dyn,
        cost=costs.quad_control(1.0, dtype=jnp.float64),
        constraint=con,
        horizon=H,
        second_order=True,
    )
    params = SolverParams(max_iterations=25, threshold=1e-8, mu=1e8)
    x0 = base.state_pack(q0, jnp.zeros(arm.nv))
    res = solve(problem, params, x0)
    assert float(res.stats.opt_constr) < 1e-6
