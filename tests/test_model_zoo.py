"""Model-zoo smoke + physics tests: 7-DoF arm, cartpole, acrobot, quadrotor."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ddp_jax.models import base
from ddp_jax.models.robots import acrobot, cartpole, panda7, quadrotor
from ddp_jax.ocp import constraints, costs, dynamics
from ddp_jax.ocp.problem import Problem
from ddp_jax.solver.solve import SolverParams, solve


@pytest.mark.parametrize("ctor,nv", [(panda7, 7), (cartpole, 2), (acrobot, 2), (quadrotor, 6)])
def test_dynamics_identities(ctor, nv):
    m = ctor()
    assert m.nv == nv
    k1, k2, k3 = jax.random.split(jax.random.key(0), 3)
    q = m.random_configuration(k1)
    v = 0.5 * jax.random.normal(k2, (m.nv,), jnp.float64)
    tau = jax.random.normal(k3, (m.nv,), jnp.float64)
    a = m.forward_dynamics(q, v, tau)
    np.testing.assert_allclose(np.asarray(m.rnea(q, v, a)), np.asarray(tau), atol=1e-8)
    M = np.asarray(m.mass_matrix(q))
    assert np.all(np.linalg.eigvalsh(0.5 * (M + M.T)) > 0)


def test_quadrotor_freefall():
    """Unforced quadrotor accelerates at −g in the world z direction."""
    m = quadrotor()
    q = m.neutral_configuration()
    a = m.forward_dynamics(q, jnp.zeros(6), jnp.zeros(6))
    # tangent layout (v_lin_local, ω_local); at neutral orientation local==world
    np.testing.assert_allclose(np.asarray(a[:3]), [0.0, 0.0, -9.81], atol=1e-10)
    np.testing.assert_allclose(np.asarray(a[3:]), 0.0, atol=1e-10)


@pytest.mark.slow
def test_panda7_spatial_eq_ddp():
    """BASELINE configs[3]: equality-constrained DDP on a 7-DoF arm with a
    spatial (end-effector) target and AL multipliers."""
    arm = panda7()
    H = 10
    dyn = dynamics.euler(arm, 0.01)
    q0 = arm.neutral_configuration()
    q_goal = arm.integrate(q0, 0.06 * jnp.ones(7))
    p_target = arm.frame_position(0, q_goal)
    con = constraints.advance_time(
        constraints.FrameTarget(model=arm, target=p_target, frame_id=0, active_ts=(H,)),
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
    params = SolverParams(max_iterations=40, threshold=1e-8, mu=1e8)
    res = jax.jit(lambda x: solve(problem, params, x))(
        base.state_pack(q0, jnp.zeros(7))
    )
    assert float(res.stats.opt_constr) < 1e-5
    p_final = arm.frame_position(0, res.xs[-1, : arm.nq])
    np.testing.assert_allclose(np.asarray(p_final), np.asarray(p_target), atol=1e-4)


@pytest.mark.slow
def test_cartpole_swingup():
    """Cartpole swing-up with a terminal configuration constraint (pole up,
    cart back at origin)."""
    m = cartpole()
    H = 120
    dyn = dynamics.euler(m, 0.02)
    q_up = jnp.asarray([0.0, jnp.pi])
    con = constraints.advance_time(
        constraints.ConfigTarget(model=m, target=q_up, active_ts=(H,)), dyn, times=2
    )
    problem = Problem(
        dynamics=dyn,
        cost=costs.quad_control(1e-1, dtype=jnp.float64),
        constraint=con,
        horizon=H,
        second_order=False,
    )
    params = SolverParams(max_iterations=60, threshold=1e-7, mu=1e8)
    res = jax.jit(lambda x: solve(problem, params, x))(jnp.zeros(4))
    assert float(res.stats.opt_constr) < 1e-5
    np.testing.assert_allclose(np.asarray(res.xs[-1, :2]), np.asarray(q_up), atol=1e-4)


@pytest.mark.slow
def test_quadrotor_attitude_reach_f32_batched():
    """Batched f32 quadrotor (freeflyer) attitude+position reach through
    solve_batched with a ConfigTarget ON THE QUATERNION MANIFOLD — the
    SURVEY 'hard part' (robust quaternion integrate/difference under
    vmap/jit at f32) exercised at the solve level, not just dynamics smoke
   .  ≙ the reference's SE(3)-configuration handling in
    pinocchio_model.ipp:222-321."""
    from ddp_jax.solver.batched import solve_batched

    dtype = jnp.float32
    m = quadrotor(dtype=dtype)
    H = 20
    dyn = dynamics.euler(m, 0.02)
    q0 = m.neutral_configuration()
    # target: translate + rotate 0.3 rad about x — a genuine quaternion move
    dq = jnp.asarray([0.10, 0.0, 0.05, 0.3, 0.0, 0.0], dtype)
    q_target = m.integrate(q0, dq)
    con = constraints.advance_time(
        constraints.ConfigTarget(model=m, target=q_target, active_ts=(H,)),
        dyn,
        times=2,
    )
    problem = Problem(
        dynamics=dyn,
        cost=costs.quad_control(1.0, dtype=dtype),
        constraint=con,
        horizon=H,
        second_order=False,
    )
    params = SolverParams(max_iterations=14, threshold=1e-5, mu=1e4, inner_iters_max=1)

    B = 8
    rng = np.random.default_rng(0)
    x0 = base.state_pack(q0, jnp.zeros(m.nv, dtype))
    # perturb in the TANGENT space then retract — keeps quaternions valid
    dxs = 0.05 * rng.standard_normal((B, 2 * m.nv))
    x0s = jnp.stack(
        [
            base.state_pack(
                m.integrate(q0, jnp.asarray(d[: m.nv], dtype)),
                jnp.asarray(d[m.nv :], dtype),
            )
            for d in dxs
        ]
    )
    res = jax.jit(lambda x: solve_batched(problem, params, x))(x0s)
    oc = np.asarray(res.opt_constr, np.float64)
    assert np.isfinite(np.asarray(res.us)).all()
    assert (oc < 1e-2).all(), oc
    # the terminal quaternion stays unit-norm through the f32 pipeline
    qT = np.asarray(res.xs[:, -1, 3:7], np.float64)
    np.testing.assert_allclose(np.linalg.norm(qT, axis=1), 1.0, atol=1e-5)


@pytest.mark.slow
def test_pendulum_bf16_batched_solve():
    """bf16 end-to-end batched solve (COMPONENTS.md #30 'bf16-capable'):
    the pendulum swing-up reaches feasibility at bf16's ~8-bit mantissa
    resolution.  Tolerances scale with eps(bf16)=2^-8."""
    from ddp_jax.models.pendulum import pendulum
    from ddp_jax.solver.batched import solve_batched

    dtype = jnp.bfloat16
    model = pendulum(1.0, 1.0, dtype=dtype)
    dyn = dynamics.euler(model, 0.01)
    H = 40
    con = constraints.advance_time(
        constraints.ConfigTarget(
            model=model, target=jnp.asarray([3.14], dtype), active_ts=(H,)
        ),
        dyn,
        times=2,
    )
    problem = Problem(
        dynamics=dyn,
        cost=costs.quad_control(1.0, dtype=dtype),
        constraint=con,
        horizon=H,
        second_order=False,
    )
    params = SolverParams(max_iterations=10, threshold=1e-3, mu=1e2, inner_iters_max=1)
    B = 8
    x0s = jnp.stack(
        [jnp.asarray([0.05 * i, 0.0], dtype) for i in range(B)]
    )
    res = jax.jit(lambda x: solve_batched(problem, params, x))(x0s)
    oc = np.asarray(res.opt_constr, np.float64)
    assert np.isfinite(np.asarray(res.us, np.float32)).all()
    # bf16 resolution near pi is ~0.0078; accept an order above it
    assert (oc < 0.1).all(), oc


def test_quadrotor_constrained_solve_end_to_end():
    """Freeflyer (quaternion) StateTarget solve through the manifold
    analytic-Jacobian fast path (round-4): hover → displaced hover with a
    gravity-compensation warm start reaches the 12-dim terminal constraint.
    Fleet version: the quadrotor cell in benchmarks/_common.py."""
    from ddp_jax.models import base
    from ddp_jax.ocp import constraints, costs, dynamics
    from ddp_jax.ocp.problem import Problem
    from ddp_jax.solver.solve import SolverParams, solve

    quad = quadrotor(dtype=jnp.float64)
    H = 24
    dyn = dynamics.euler(quad, 0.02)
    assert dyn.analytic_jacobians_ok  # manifold fast path active
    q0 = quad.neutral_configuration()
    zero_v = jnp.zeros(6, jnp.float64)
    q_goal = quad.integrate(
        q0, jnp.asarray([0.3, -0.2, 0.4, 0.0, 0.0, 0.2], jnp.float64)
    )
    x_goal = base.state_pack(q_goal, zero_v)
    con = constraints.advance_time(
        constraints.StateTarget(model=quad, target=x_goal, active_ts=(H,)),
        dyn,
        times=2,
    )
    problem = Problem(
        dynamics=dyn, cost=costs.quad_control(1.0, jnp.float64),
        constraint=con, horizon=H, second_order=False,
    )
    x0 = base.state_pack(q0, zero_v)
    us0 = jnp.tile(quad.rnea(q0, zero_v, zero_v)[None], (H, 1))
    params = SolverParams(
        max_iterations=40, threshold=1e-8, mu=1e4, inner_iters_max=3
    )
    res = jax.jit(lambda x: solve(problem, params, x, us_init=us0))(x0)
    assert float(res.stats.opt_constr) < 1e-3
    # The constraint pins the SAME-U prediction x̃_H = f(f(x_{H-2}, u), u)
    # (AdvanceTime's reference semantics, problem.hpp:563-567) — the
    # realized rollout applies u_{H-1} (cost-only ⇒ ~0) in its last step,
    # so assert the constraint-consistent prediction, not xs[-1] (a real
    # modeling gotcha on aggressive tasks; see constraints.AdvanceTime).
    x_pred = dyn(H - 1, dyn(H - 2, res.xs[H - 2], res.us[H - 2]), res.us[H - 2])
    np.testing.assert_allclose(
        np.asarray(x_pred[:3]), np.asarray(q_goal[:3]), atol=1e-3
    )
    np.testing.assert_allclose(np.asarray(x_pred[7:]), 0.0, atol=1e-3)
