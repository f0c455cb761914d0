"""Associative-scan Riccati vs the sequential sweep: identical gains."""

import pytest

import jax
import jax.numpy as jnp
import numpy as np

from ddp_jax.models.pendulum import pendulum
from ddp_jax.ocp import constraints, costs, dynamics
from ddp_jax.ocp.problem import Problem
from ddp_jax.solver import al as al_mod
from ddp_jax.solver.batched import _backward_sweep
from ddp_jax.solver.parallel_riccati import backward_pass_assoc


def make_derivs(H=64, seed=0, with_constraint=True):
    dtype = jnp.float64
    model = pendulum(1.0, 1.0, dtype=dtype)
    dyn = dynamics.euler(model, 0.01)
    if with_constraint:
        con = constraints.advance_time(
            constraints.ConfigTarget(
                model=model, target=jnp.asarray([2.0], dtype=dtype), active_ts=(H,)
            ),
            dyn,
            times=2,
        )
    else:
        con = constraints.NoConstraint()
    problem = Problem(
        dynamics=dyn,
        cost=costs.quad_control(1.0, dtype=dtype),
        constraint=con,
        horizon=H,
        second_order=False,  # associative path is Gauss-Newton-exact
    )
    k1, k2 = jax.random.split(jax.random.key(seed))
    x0 = 0.3 * jax.random.normal(k1, (2,), dtype)
    us = 0.5 * jax.random.normal(k2, (H, 1), dtype)
    xs = problem.rollout(x0, us)
    derivs = problem.derivatives(xs, us)
    mults = al_mod.init_multipliers(problem, xs)
    return problem, derivs, mults


@pytest.mark.slow
def test_assoc_matches_sequential_unconstrained():
    _, derivs, mults = make_derivs(with_constraint=False)
    mu = jnp.asarray(0.0)
    reg = jnp.asarray(0.0)
    k_seq, K_seq, ok_seq = _backward_sweep(derivs, mults.val, mults.jac, mu, reg)
    k_par, K_par, ok_par = backward_pass_assoc(derivs, mults.val, mults.jac, mu, reg)
    assert bool(ok_seq) and bool(ok_par)
    np.testing.assert_allclose(np.asarray(k_par), np.asarray(k_seq), atol=1e-9)
    np.testing.assert_allclose(np.asarray(K_par), np.asarray(K_seq), atol=1e-9)


def test_assoc_matches_sequential_with_al_terms():
    """AL multiplier terms (constant and affine) fold into the stage cost
    and still match the sequential Q-expansion."""
    problem, derivs, mults = make_derivs(with_constraint=True, seed=3)
    # non-trivial multipliers: value and state-feedback jacobian
    key = jax.random.key(7)
    mults = mults._replace(
        val=0.5 * jax.random.normal(key, mults.val.shape, jnp.float64),
        jac=0.2 * jax.random.normal(key, mults.jac.shape, jnp.float64),
    )
    mu = jnp.asarray(1e4)
    reg = jnp.asarray(0.0)
    k_seq, K_seq, ok_seq = _backward_sweep(derivs, mults.val, mults.jac, mu, reg)
    k_par, K_par, ok_par = backward_pass_assoc(derivs, mults.val, mults.jac, mu, reg)
    assert bool(ok_seq) and bool(ok_par)
    np.testing.assert_allclose(np.asarray(k_par), np.asarray(k_seq), rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(np.asarray(K_par), np.asarray(K_seq), rtol=1e-8, atol=1e-8)


@pytest.mark.slow
def test_assoc_long_horizon_finite():
    """T = 1024 stays finite and well-conditioned under the scan."""
    _, derivs, mults = make_derivs(H=1024, with_constraint=False)
    k, K, ok = backward_pass_assoc(
        derivs, mults.val, mults.jac, jnp.asarray(0.0), jnp.asarray(0.0)
    )
    assert bool(ok)
    assert np.isfinite(np.asarray(k)).all() and np.isfinite(np.asarray(K)).all()


@pytest.mark.slow
def test_solve_batched_with_assoc_backward():
    """Full batched solve using the associative-scan backward pass on a
    long horizon matches the sequential-sweep path."""
    from ddp_jax.solver.batched import solve_batched
    from ddp_jax.solver.solve import SolverParams

    H = 256
    dtype = jnp.float64
    model = pendulum(1.0, 1.0, dtype=dtype)
    dyn = dynamics.euler(model, 0.01)
    con = constraints.advance_time(
        constraints.ConfigTarget(
            model=model, target=jnp.asarray([3.14], dtype=dtype), active_ts=(H,)
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
    params = SolverParams(max_iterations=30, threshold=1e-9, mu=1e8)
    x0s = jnp.stack([jnp.array([0.0, 0.0]), jnp.array([0.2, 0.0])])

    res_a = jax.jit(lambda x: solve_batched(problem, params, x, backward="assoc"))(x0s)
    res_s = jax.jit(lambda x: solve_batched(problem, params, x, backward="sweep"))(x0s)

    np.testing.assert_allclose(np.asarray(res_a.xs[:, -1, 0]), 3.14, atol=1e-5)
    assert float(jnp.max(res_a.opt_constr)) < 1e-6
    # same optimum as the sequential path
    np.testing.assert_allclose(
        np.asarray(res_a.us), np.asarray(res_s.us), rtol=1e-5, atol=1e-6
    )
