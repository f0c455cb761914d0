"""Taylor-expansion self-checks of the jacfwd-based derivative engine.

Mirrors the reference's embedded debug verification (problem.hpp:999-1139):
random tangent perturbations must match first-order terms to O(ε²) and
second-order terms to O(ε³).  float64 is the oracle (SURVEY.md §4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ddp_jax.models.base import state_difference, state_integrate
from ddp_jax.models.pendulum import pendulum
from ddp_jax.ocp import constraints, costs, dynamics
from ddp_jax.ocp.problem import Problem

HORIZON = 12
DT = 0.01


@pytest.fixture
def problem():
    model = pendulum(1.3, 0.7, dtype=jnp.float64)
    dyn = dynamics.euler(model, DT)
    con = constraints.advance_time(
        constraints.ConfigTarget(
            model=model, target=jnp.asarray([1.5], dtype=jnp.float64), active_ts=(HORIZON,)
        ),
        dyn,
        times=2,
    )
    return Problem(
        dynamics=dyn,
        cost=costs.quad_control(1.0, dtype=jnp.float64),
        constraint=con,
        horizon=HORIZON,
        second_order=True,
    )


def random_traj(problem, key):
    kx, ku = jax.random.split(key)
    x0 = jax.random.normal(kx, (problem.nx,), dtype=jnp.float64) * 0.3
    us = jax.random.normal(ku, (problem.horizon, problem.nu), dtype=jnp.float64) * 0.5
    xs = problem.rollout(x0, us)
    return xs, us


def test_dynamics_taylor(problem):
    """f(x⊕dx, u+du) ⊖ f(x,u) ≈ fx dx + fu du + ½(dx,du)ᵀH(dx,du)."""
    model = problem.model
    xs, us = random_traj(problem, jax.random.key(0))
    derivs = problem.derivatives(xs, us)
    eps = 1e-4
    rng = np.random.default_rng(1)

    for t in [0, 3, HORIZON - 1]:
        x, u = xs[t], us[t]
        dx = jnp.asarray(rng.standard_normal(problem.ndx)) * eps
        du = jnp.asarray(rng.standard_normal(problem.nu)) * eps
        f0 = problem.f(t, x, u)
        f1 = problem.f(t, state_integrate(model, x, dx), u + du)
        df = state_difference(model, f0, f1)

        lin = derivs.fx[t] @ dx + derivs.fu[t] @ du
        quad = 0.5 * (
            jnp.einsum("oij,i,j->o", derivs.fxx[t], dx, dx)
            + 2 * jnp.einsum("oij,i,j->o", derivs.fux[t], du, dx)
            + jnp.einsum("oij,i,j->o", derivs.fuu[t], du, du)
        )
        assert np.linalg.norm(df - lin) < 10 * eps**2 * max(1, np.linalg.norm(df) / eps)
        assert np.linalg.norm(df - lin - quad) < 100 * eps**3 / eps * np.linalg.norm(df)


def test_constraint_taylor(problem):
    model = problem.model
    xs, us = random_traj(problem, jax.random.key(2))
    derivs = problem.derivatives(xs, us)
    t = HORIZON - 2  # the active step
    mask = problem.eq_mask()
    assert mask[t].all() and not mask[t - 1].any()

    eps = 1e-5
    rng = np.random.default_rng(3)
    x, u = xs[t], us[t]
    dx = jnp.asarray(rng.standard_normal(problem.ndx)) * eps
    du = jnp.asarray(rng.standard_normal(problem.nu)) * eps
    e0 = problem.eq(t, x, u)
    e1 = problem.eq(t, state_integrate(model, x, dx), u + du)
    deq = e1 - e0
    lin = derivs.eqx[t] @ dx + derivs.equ[t] @ du
    assert np.linalg.norm(deq - lin) < 100 * eps**2

    # masked steps contribute nothing
    assert float(jnp.abs(derivs.eq[t - 1]).max()) == 0.0
    assert float(jnp.abs(derivs.eqx[t - 1]).max()) == 0.0


def test_cost_derivatives_closed_form(problem):
    """Default cost l = ½c‖u‖²: lu = c·u, luu = c·I, lx = 0 (problem.hpp:982-987)."""
    xs, us = random_traj(problem, jax.random.key(4))
    derivs = problem.derivatives(xs, us)
    c = 1.0
    np.testing.assert_allclose(derivs.lu, c * us, rtol=1e-12)
    np.testing.assert_allclose(derivs.lx, 0.0, atol=1e-12)
    np.testing.assert_allclose(
        derivs.luu, np.broadcast_to(c * np.eye(problem.nu), derivs.luu.shape), rtol=1e-12
    )
    np.testing.assert_allclose(derivs.lfx, 0.0, atol=1e-12)


def test_advance_time_composition_semantics(problem):
    """Double advance evaluates the inner constraint on a two-step rollout
    with the same control (problem.hpp:563-567)."""
    model = problem.model
    dyn = problem.dynamics
    t = HORIZON - 2
    x = jnp.asarray([0.3, -0.2], dtype=jnp.float64)
    u = jnp.asarray([0.7], dtype=jnp.float64)
    x1 = dyn(t, x, u)
    x2 = dyn(t + 1, x1, u)  # same u — reference semantics
    target = jnp.asarray([1.5], dtype=jnp.float64)
    expected = model.difference(target, x2[:1])
    got = problem.eq(t, x, u)
    np.testing.assert_allclose(got, expected, rtol=1e-12)


def _gn_problem(model, con_target, dtype=jnp.float64, horizon=8):
    dyn = dynamics.euler(model, DT)
    con = constraints.advance_time(
        constraints.ConfigTarget(
            model=model, target=con_target, active_ts=(horizon,)
        ),
        dyn,
        times=2,
    )
    return Problem(
        dynamics=dyn,
        cost=costs.quad_control(1.0, dtype=dtype),
        constraint=con,
        horizon=horizon,
        second_order=False,
    )


def test_analytic_euler_jacobians_match_generic_pendulum():
    """The assembled Euler-step Jacobian path (dynamics.jacobians +
    model.fd_derivatives) must equal the generic shared-primal JVP chart
    path bit-for-roundoff (vector-space config ⇒ same chain rule)."""
    model = pendulum(1.3, 0.7, dtype=jnp.float64)
    prob = _gn_problem(model, jnp.asarray([1.5], jnp.float64))
    assert prob.dynamics.analytic_jacobians_ok

    xs, us = random_traj_for(prob, jax.random.key(0))
    fast = prob.derivatives(xs, us)

    t0 = jnp.asarray(0)
    x, u = xs[0], us[0]
    _, fx, fu = prob.dynamics.jacobians(t0, x, u)
    fx_ref = jax.jacfwd(lambda dx: state_difference(
        model, prob.dynamics(t0, x, u),
        prob.dynamics(t0, state_integrate(model, x, dx), u)))(jnp.zeros(prob.ndx))
    fu_ref = jax.jacfwd(lambda du: state_difference(
        model, prob.dynamics(t0, x, u),
        prob.dynamics(t0, x, u + du)))(jnp.zeros(prob.nu))
    np.testing.assert_allclose(np.asarray(fx), np.asarray(fx_ref), atol=1e-11)
    np.testing.assert_allclose(np.asarray(fu), np.asarray(fu_ref), atol=1e-11)
    np.testing.assert_allclose(np.asarray(fast.fx[0]), np.asarray(fx_ref), atol=1e-11)
    np.testing.assert_allclose(np.asarray(fast.fu[0]), np.asarray(fu_ref), atol=1e-11)


def random_traj_for(prob, key):
    k1, k2 = jax.random.split(key)
    x0 = 0.3 * jax.random.normal(k1, (prob.nx,), dtype=jnp.float64)
    us = 0.2 * jax.random.normal(k2, (prob.horizon, prob.nu), dtype=jnp.float64)
    return prob.rollout(x0, us), us


def test_analytic_euler_jacobians_match_generic_arm():
    """UR5 (revolute-only): the analytic fd_derivatives assembly equals
    jacfwd over the whole Euler step at every timestep of a random
    trajectory (f64 oracle, ≙ the reference's chain-rule first_order_deriv
    vs its debug FD check, problem.hpp:999-1139)."""
    from ddp_jax.models.robots import ur5

    arm = ur5(dtype=jnp.float64)
    q_t = arm.integrate(arm.neutral_configuration(),
                        jnp.asarray(0.05 * np.arange(1.0, 7.0)))
    prob = _gn_problem(arm, q_t, horizon=4)
    assert prob.dynamics.analytic_jacobians_ok

    xs, us = random_traj_for(prob, jax.random.key(1))
    fast = prob.derivatives(xs, us)

    def step_jac(t, x, u):
        fx = jax.jacfwd(lambda dx: state_difference(
            arm, prob.dynamics(t, x, u),
            prob.dynamics(t, state_integrate(arm, x, dx), u)))(jnp.zeros(prob.ndx))
        fu = jax.jacfwd(lambda du: prob.dynamics(t, x, u + du))(jnp.zeros(prob.nu))
        # output chart at a vector-space config is identity
        return fx, fu

    for t in range(prob.horizon):
        fx_ref, fu_ref = step_jac(t, xs[t], us[t])
        np.testing.assert_allclose(
            np.asarray(fast.fx[t]), np.asarray(fx_ref), atol=1e-9,
            err_msg=f"fx mismatch at t={t}")
        np.testing.assert_allclose(
            np.asarray(fast.fu[t]), np.asarray(fu_ref), atol=1e-9,
            err_msg=f"fu mismatch at t={t}")


@pytest.mark.parametrize("which", ["quadrotor", "all_joints"])
def test_analytic_euler_jacobians_match_generic_manifold(which):
    """Quaternion/SO(2)-manifold models take the analytic fast path too
    (round-4): fd_derivatives' coordinate ∂a/∂q chained through the chart
    (Q = ∂integrate/∂δ) plus the group-transport q-row must equal jacfwd
    over the whole Euler step in tangent coordinates — ≙ the reference's
    d_integrate ∘ computeABADerivatives chain for freeflyer/spherical/
    planar joints (problem.hpp:463-503, pinocchio_model.ipp:222-321,
    359-400)."""
    from ddp_jax.models.rigid_body import all_joints_test_model
    from ddp_jax.models.robots import quadrotor

    model = quadrotor(dtype=jnp.float64) if which == "quadrotor" else (
        all_joints_test_model(dtype=jnp.float64)
    )
    dyn = dynamics.euler(model, DT)
    assert dyn.analytic_jacobians_ok

    key = jax.random.key(3)
    kq, kv, ku = jax.random.split(key, 3)
    q = model.random_configuration(kq)
    v = 0.3 * jax.random.normal(kv, (model.nv,), dtype=jnp.float64)
    u = 0.2 * jax.random.normal(ku, (model.nu,), dtype=jnp.float64)
    x = jnp.concatenate([q, v])
    t0 = jnp.asarray(0)

    x1, fx, fu = dyn.jacobians(t0, x, u)
    np.testing.assert_allclose(
        np.asarray(x1), np.asarray(dyn(t0, x, u)), atol=1e-12
    )
    ndx = 2 * model.nv
    fx_ref = jax.jacfwd(lambda dx: state_difference(
        model, dyn(t0, x, u),
        dyn(t0, state_integrate(model, x, dx), u)))(jnp.zeros(ndx))
    fu_ref = jax.jacfwd(lambda du: state_difference(
        model, dyn(t0, x, u), dyn(t0, x, u + du)))(jnp.zeros(model.nu))
    np.testing.assert_allclose(np.asarray(fx), np.asarray(fx_ref), atol=1e-9)
    np.testing.assert_allclose(np.asarray(fu), np.asarray(fu_ref), atol=1e-9)


def test_second_order_analytic_path_matches_generic_arm():
    """Full-DDP Hessians via forward-over-assembled-analytic (round-4: one
    jacfwd over dynamics.jacobians instead of nested JVPs through the
    implicit-FD rule — the arm full-DDP program otherwise exceeds the
    remote compiler budget) equal the generic jacfwd∘jacfwd to roundoff on
    vector-space models."""
    import dataclasses

    from ddp_jax.models.robots import ur5

    arm = ur5(dtype=jnp.float64)
    dyn = dynamics.euler(arm, 0.01)
    H = 3
    con = constraints.advance_time(
        constraints.ConfigTarget(
            model=arm, target=arm.neutral_configuration(), active_ts=(H,)
        ),
        dyn,
        times=2,
    )
    cost = costs.quad_control(1.0, dtype=jnp.float64)
    prob = Problem(
        dynamics=dyn, cost=cost, constraint=con, horizon=H, second_order=True
    )

    @jax.tree_util.register_dataclass
    @dataclasses.dataclass(frozen=True)
    class GenericEuler(dynamics.EulerDynamics):
        @property
        def analytic_jacobians_ok(self):
            return False

    prob_ref = Problem(
        dynamics=GenericEuler(model=arm, dt=dyn.dt), cost=cost,
        constraint=con, horizon=H, second_order=True,
    )
    rng = np.random.default_rng(0)
    x0 = jnp.asarray(
        np.concatenate([0.3 * rng.standard_normal(6), 0.2 * rng.standard_normal(6)])
    )
    us = jnp.asarray(0.5 * rng.standard_normal((H, 6)))
    xs = prob.rollout(x0, us)
    d_fast = prob.derivatives(xs, us)
    d_ref = prob_ref.derivatives(xs, us)
    for f in ("fx", "fu", "fxx", "fux", "fuu"):
        np.testing.assert_allclose(
            np.asarray(getattr(d_fast, f)), np.asarray(getattr(d_ref, f)),
            atol=1e-12, err_msg=f,
        )
