"""Pallas batched Riccati kernel vs the XLA sweep (interpret mode on CPU)."""

import pytest

import jax
import jax.numpy as jnp
import numpy as np

from ddp_jax.kernels.riccati_small import backward_sweep_pallas, pack_batch_last
from ddp_jax.models.pendulum import pendulum
from ddp_jax.ocp import constraints, costs, dynamics
from ddp_jax.ocp.problem import Problem
from ddp_jax.solver import al as al_mod
from ddp_jax.solver.batched import _backward_sweep


def make_batch(B=8, H=16, dtype=jnp.float32):
    model = pendulum(1.0, 1.0, dtype=dtype)
    dyn = dynamics.euler(model, 0.01)
    con = constraints.advance_time(
        constraints.ConfigTarget(
            model=model, target=jnp.asarray([2.0], dtype=dtype), active_ts=(H,)
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
    x0s = 0.4 * jax.random.normal(jax.random.key(0), (B, 2), dtype)
    us = 0.3 * jax.random.normal(jax.random.key(1), (B, H, 1), dtype)
    xs = jax.vmap(problem.rollout)(x0s, us)
    derivs = jax.vmap(problem.derivatives)(xs, us)
    mults = jax.vmap(lambda x: al_mod.init_multipliers(problem, x))(xs)
    # give the multipliers non-trivial values so AL terms are exercised
    mults = mults._replace(
        val=0.3 * jax.random.normal(jax.random.key(2), mults.val.shape, dtype),
        jac=0.1 * jax.random.normal(jax.random.key(3), mults.jac.shape, dtype),
    )
    return problem, derivs, mults


def test_pallas_backward_matches_xla():
    B, H = 8, 16
    problem, derivs, mults = make_batch(B, H)
    mu = jnp.full((B,), 1e3, jnp.float32)
    reg = jnp.zeros((B,), jnp.float32)

    k_ref, K_ref, ok_ref = jax.vmap(
        lambda d, mv, mj, m, r: _backward_sweep(d, mv, mj, m, r)
    )(derivs, mults.val, mults.jac, mu, reg)

    packed = pack_batch_last(derivs, mults.val, mults.jac)
    k_p, K_p, ok_p = backward_sweep_pallas(
        packed, mu, reg, T=H, n=2, m=1, e=1, block_b=8, interpret=True
    )
    # kernel layout [T, m, B] / [T, m*n, B] → compare against [B, T, m(,n)]
    k_p_bt = jnp.transpose(k_p, (2, 0, 1))
    K_p_bt = jnp.transpose(K_p.reshape(H, 1, 2, B), (3, 0, 1, 2))
    np.testing.assert_allclose(np.asarray(k_p_bt), np.asarray(k_ref), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(np.asarray(K_p_bt), np.asarray(K_ref), rtol=2e-4, atol=2e-5)
    np.testing.assert_array_equal(np.asarray(ok_p), np.asarray(ok_ref))


def test_pallas_ok_is_per_sample():
    """A failing sample must not poison the other lanes in its block."""
    B, H = 8, 16
    problem, derivs, mults = make_batch(B, H)
    mu = jnp.full((B,), 1e3, jnp.float32)
    reg = jnp.zeros((B,), jnp.float32)
    # make sample 3's Quu indefinite at every step so its Cholesky fails
    luu_bad = derivs.luu.at[3].set(-10.0 * jnp.eye(1, dtype=jnp.float32))
    derivs = derivs._replace(luu=luu_bad)

    _, _, ok_ref = jax.vmap(
        lambda d, mv, mj, m, r: _backward_sweep(d, mv, mj, m, r)
    )(derivs, mults.val, mults.jac, mu, reg)

    packed = pack_batch_last(derivs, mults.val, mults.jac)
    k_p, K_p, ok_p = backward_sweep_pallas(
        packed, mu, reg, T=H, n=2, m=1, e=1, block_b=8, interpret=True
    )
    assert not bool(ok_p[3])
    assert bool(jnp.all(jnp.delete(ok_p, 3)))
    np.testing.assert_array_equal(np.asarray(ok_p), np.asarray(ok_ref))
    # healthy lanes' gains stay finite
    assert bool(jnp.all(jnp.isfinite(jnp.transpose(k_p, (2, 0, 1))[jnp.arange(B) != 3])))


@pytest.mark.slow
def test_pallas_backward_second_order_matches_xla():
    """Full-DDP mode: the kernel's unrolled rank-3 contraction terms match
    the XLA einsum path."""
    B, H = 8, 12
    model = pendulum(1.0, 1.0, dtype=jnp.float32)
    dyn = dynamics.euler(model, 0.01)
    con = constraints.advance_time(
        constraints.ConfigTarget(
            model=model, target=jnp.asarray([2.0], jnp.float32), active_ts=(H,)
        ),
        dyn,
        times=2,
    )
    problem = Problem(
        dynamics=dyn,
        cost=costs.quad_control(1.0, dtype=jnp.float32),
        constraint=con,
        horizon=H,
        second_order=True,
    )
    x0s = 0.4 * jax.random.normal(jax.random.key(0), (B, 2), jnp.float32)
    us = 0.3 * jax.random.normal(jax.random.key(1), (B, H, 1), jnp.float32)
    xs = jax.vmap(problem.rollout)(x0s, us)
    derivs = jax.vmap(problem.derivatives)(xs, us)
    mults = jax.vmap(lambda x: al_mod.init_multipliers(problem, x))(xs)
    mults = mults._replace(
        val=0.3 * jax.random.normal(jax.random.key(2), mults.val.shape, jnp.float32),
        jac=0.1 * jax.random.normal(jax.random.key(3), mults.jac.shape, jnp.float32),
    )
    mu = jnp.full((B,), 1e3, jnp.float32)
    reg = jnp.zeros((B,), jnp.float32)
    # tensor terms must be nonzero for this test to mean anything
    assert float(jnp.max(jnp.abs(derivs.fxx))) > 0

    k_ref, K_ref, ok_ref = jax.vmap(
        lambda d, mv, mj, m, r: _backward_sweep(d, mv, mj, m, r)
    )(derivs, mults.val, mults.jac, mu, reg)

    packed = pack_batch_last(derivs, mults.val, mults.jac, second_order=True)
    k_p, K_p, ok_p = backward_sweep_pallas(
        packed, mu, reg, T=H, n=2, m=1, e=1, block_b=8, interpret=True
    )
    k_p_bt = jnp.transpose(k_p, (2, 0, 1))
    K_p_bt = jnp.transpose(K_p.reshape(H, 1, 2, B), (3, 0, 1, 2))
    np.testing.assert_allclose(np.asarray(k_p_bt), np.asarray(k_ref), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(np.asarray(K_p_bt), np.asarray(K_ref), rtol=2e-4, atol=2e-5)
    np.testing.assert_array_equal(np.asarray(ok_p), np.asarray(ok_ref))


@pytest.mark.slow
def test_solve_batched_pallas_second_order():
    """Full second-order DDP solve through the pallas backward reaches the
    same optimum as the XLA sweep."""
    from ddp_jax.solver.batched import solve_batched
    from ddp_jax.solver.solve import SolverParams

    H = 24
    model = pendulum(1.0, 1.0, dtype=jnp.float32)
    dyn = dynamics.euler(model, 0.01)
    con = constraints.advance_time(
        constraints.ConfigTarget(
            model=model, target=jnp.asarray([2.5], jnp.float32), active_ts=(H,)
        ),
        dyn,
        times=2,
    )
    problem = Problem(
        dynamics=dyn,
        cost=costs.quad_control(1.0, dtype=jnp.float32),
        constraint=con,
        horizon=H,
        second_order=True,
    )
    params = SolverParams(max_iterations=10, threshold=1e-5, mu=1e4)
    x0s = jnp.stack([jnp.array([q, 0.0], jnp.float32) for q in (-0.4, 0.0, 0.3, 0.6)])
    ref = jax.jit(lambda x: solve_batched(problem, params, x))(x0s)
    pal = jax.jit(
        lambda x: solve_batched(problem, params, x, backward="pallas", interpret=True)
    )(x0s)
    np.testing.assert_allclose(
        np.asarray(pal.us), np.asarray(ref.us), rtol=2e-3, atol=2e-3
    )


@pytest.mark.slow
def test_solve_batched_single_reg_level():
    """n_reg_levels=1 (the bench headline config) must match the 4-level
    default wherever the ladder never fires — on the GN pendulum Quu stays
    PD, so results are identical."""
    from ddp_jax.solver.batched import solve_batched
    from ddp_jax.solver.solve import SolverParams

    H = 16
    problem = make_batch(4, H)[0]
    params = SolverParams(max_iterations=6, threshold=1e-5, mu=1e4, inner_iters_max=1)
    x0s = jnp.stack([jnp.array([q, 0.0], jnp.float32) for q in (-0.4, 0.0, 0.3, 0.6)])
    ref = jax.jit(lambda x: solve_batched(problem, params, x))(x0s)
    one = jax.jit(
        lambda x: solve_batched(
            problem, params, x, backward="pallas", interpret=True, n_reg_levels=1
        )
    )(x0s)
    np.testing.assert_allclose(
        np.asarray(one.us), np.asarray(ref.us), rtol=2e-3, atol=2e-3
    )
    assert bool(jnp.all(one.opt_constr < 1e-2))


@pytest.mark.slow
def test_pallas_backward_arm_dims_matches_xla():
    """Arm-class dimensions (UR5: n=12, m=6, e=6 — BASELINE configs[3],
    test/pinocchio_ddp.cpp:35-68): the kernel's unrolled index algebra,
    Cholesky, and AL terms must match the XLA sweep well beyond pendulum
    dims.  f64 interpret mode pins the math."""
    from ddp_jax.models import base
    from ddp_jax.models.robots import ur5

    B, H = 4, 10
    arm = ur5()
    dyn = dynamics.euler(arm, 0.01)
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
        second_order=False,
    )
    x0 = base.state_pack(q0, jnp.zeros(arm.nv))
    x0s = x0[None] + 0.02 * jax.random.normal(
        jax.random.key(0), (B, problem.nx), jnp.float64
    )
    us = 0.05 * jax.random.normal(jax.random.key(1), (B, H, arm.nu), jnp.float64)
    xs = jax.vmap(problem.rollout)(x0s, us)
    derivs = jax.vmap(problem.derivatives)(xs, us)
    mults = jax.vmap(lambda x: al_mod.init_multipliers(problem, x))(xs)
    mults = mults._replace(
        val=0.3 * jax.random.normal(jax.random.key(2), mults.val.shape, jnp.float64),
        jac=0.1 * jax.random.normal(jax.random.key(3), mults.jac.shape, jnp.float64),
    )
    mu = jnp.full((B,), 1e3, jnp.float64)
    reg = jnp.full((B,), 1e-6, jnp.float64)
    n, m, e = problem.ndx, problem.nu, problem.ne
    assert (n, m, e) == (12, 6, 6)

    k_ref, K_ref, ok_ref = jax.vmap(
        lambda d, mv, mj, m_, r: _backward_sweep(d, mv, mj, m_, r)
    )(derivs, mults.val, mults.jac, mu, reg)

    packed = pack_batch_last(derivs, mults.val, mults.jac)
    k_p, K_p, ok_p = backward_sweep_pallas(
        packed, mu, reg, T=H, n=n, m=m, e=e, block_b=B, interpret=True
    )
    k_p_bt = jnp.transpose(k_p, (2, 0, 1))
    K_p_bt = jnp.transpose(K_p.reshape(H, m, n, B), (3, 0, 1, 2))
    np.testing.assert_allclose(
        np.asarray(k_p_bt), np.asarray(k_ref), rtol=1e-9, atol=1e-9
    )
    np.testing.assert_allclose(
        np.asarray(K_p_bt), np.asarray(K_ref), rtol=1e-9, atol=1e-9
    )
    np.testing.assert_array_equal(np.asarray(ok_p), np.asarray(ok_ref))


def _compare(B, H, block_b=None):
    problem, derivs, mults = make_batch(B, H)
    mu = jnp.full((B,), 1e3, jnp.float32)
    reg = jnp.zeros((B,), jnp.float32)
    k_ref, K_ref, ok_ref = jax.vmap(
        lambda d, mv, mj, m, r: _backward_sweep(d, mv, mj, m, r)
    )(derivs, mults.val, mults.jac, mu, reg)
    packed = pack_batch_last(derivs, mults.val, mults.jac)
    k_p, K_p, ok_p = backward_sweep_pallas(
        packed, mu, reg, T=H, n=2, m=1, e=1, block_b=block_b, interpret=True
    )
    assert k_p.shape == (H, 1, B) and K_p.shape == (H, 2, B) and ok_p.shape == (B,)
    k_p_bt = jnp.transpose(k_p, (2, 0, 1))
    K_p_bt = jnp.transpose(K_p.reshape(H, 1, 2, B), (3, 0, 1, 2))
    np.testing.assert_allclose(np.asarray(k_p_bt), np.asarray(k_ref), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(np.asarray(K_p_bt), np.asarray(K_ref), rtol=2e-4, atol=2e-5)
    np.testing.assert_array_equal(np.asarray(ok_p), np.asarray(ok_ref))


@pytest.mark.parametrize("B,block_b", [(12, 8), (5, None)])
def test_pallas_backward_pads_batch_to_block(B, block_b):
    """A batch that is not a multiple of the (power-of-two) block is padded
    up to it and the padding is cut from every output."""
    _compare(B, 16, block_b)


def test_pallas_backward_non_power_of_two_horizon():
    """The time loop runs inside the kernel, so any horizon is one launch:
    T=13 needs no chunking and no power-of-two rounding."""
    _compare(8, 13, 8)


@pytest.mark.parametrize(
    "n,expect", [(4096, 32), (1 << 16, 128), (20000, 128), (256, 32), (1, 32)]
)
def test_lane_block_fills_the_card(n, expect):
    """The default block is the widest power of two (≤ 128 samples, ≥ one
    warp) that still gives enough programs to fill the card's SMs."""
    from ddp_jax.kernels.riccati_small import lane_block

    assert lane_block(n) == expect


def test_block_must_be_power_of_two():
    from ddp_jax.kernels.riccati_small import check_block

    check_block(64)
    with pytest.raises(ValueError, match="power-of-two"):
        check_block(96)
