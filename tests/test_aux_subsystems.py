"""Aux subsystems: diagnostics, MPC driver, checkpointing, mesh sharding."""

import os

import pytest

import jax
import jax.numpy as jnp
import numpy as np

from ddp_jax.diagnostics.checks import assert_finite, check_derivatives
from ddp_jax.diagnostics.profiling import ConvergenceTrace, chronometer
from ddp_jax.models.pendulum import pendulum
from ddp_jax.ocp import constraints, costs, dynamics
from ddp_jax.ocp.problem import Problem
from ddp_jax.solver.mpc import MPCCarry, init_carry, make_mpc_step, run_mpc
from ddp_jax.solver.solve import SolverParams
from ddp_jax.utils import checkpoint

H = 40


def make_problem(dtype=jnp.float64, horizon=H):
    model = pendulum(1.0, 1.0, dtype=dtype)
    dyn = dynamics.euler(model, 0.01)
    con = constraints.advance_time(
        constraints.ConfigTarget(
            model=model, target=jnp.asarray([3.14], dtype=dtype), active_ts=(horizon,)
        ),
        dyn,
        times=2,
    )
    return Problem(
        dynamics=dyn,
        cost=costs.quad_control(1.0, dtype=dtype),
        constraint=con,
        horizon=horizon,
    )


@pytest.mark.slow
def test_derivative_self_check():
    """≙ the reference's embedded debug Taylor verification
    (problem.hpp:999-1139) as an opt-in diagnostic."""
    problem = make_problem()
    us = 0.1 * jnp.ones((H, 1))
    xs = problem.rollout(jnp.asarray([0.3, 0.0]), us)
    report = check_derivatives(problem, xs, us, eps=1e-6)
    assert bool(report.ok)
    assert float(report.f_first_order) < 1e-4
    assert float(report.f_second_order) < 1e-7


def test_assert_finite_raises():
    import pytest

    assert_finite({"a": jnp.ones(3)})
    with pytest.raises(FloatingPointError):
        assert_finite({"a": jnp.asarray([1.0, jnp.nan])}, "bad")


def test_chronometer_and_trace(tmp_path):
    log = str(tmp_path / "chrono.log")
    with chronometer("unit-test phase", path=log):
        _ = jnp.ones(8).sum()
    assert "unit-test phase" in open(log).read()

    tr = ConvergenceTrace("unit", directory=str(tmp_path))
    tr.record(1e-3, 1e-2)
    tr.record(1e-5, 1e-4)
    assert len(open(tr.primal).read().splitlines()) == 2


@pytest.mark.slow
def test_mpc_receding_horizon():
    """Warm-started replanning drives the pendulum to the target AND settles
    it there (BASELINE configs[5]-class driver, single scenario).

    The terminal constraint pins the full state [q, v] = [3.14, 0]
    (StateTarget): a position-only constraint admits closed loops that plan
    through the target with residual velocity forever — the round-1 loose
    tolerance was hiding exactly that."""
    dtype = jnp.float64
    model = pendulum(1.0, 1.0, dtype=dtype)
    dyn = dynamics.euler(model, 0.01)
    horizon = 30
    con = constraints.advance_time(
        constraints.StateTarget(
            model=model,
            target=jnp.asarray([3.14, 0.0], dtype=dtype),
            active_ts=(horizon,),
        ),
        dyn,
        times=2,
    )
    problem = Problem(
        dynamics=dyn,
        cost=costs.quad_control(1.0, dtype=dtype),
        constraint=con,
        horizon=horizon,
    )
    params = SolverParams(max_iterations=4, threshold=1e-6, mu=1e6)
    step = make_mpc_step(problem, params)
    carry = init_carry(problem, dtype=jnp.float64)
    x = jnp.asarray([0.0, 0.0])
    for t in range(120):
        out = step(x, carry)
        carry = out.carry
        x = problem.dynamics(0, x, out.u0)
    # after 120 replans the pendulum must be settled AT the target, at rest
    assert np.isfinite(np.asarray(x)).all()
    assert abs(float(x[0]) - 3.14) < 0.02, float(x[0])
    assert abs(float(x[1])) < 0.1, float(x[1])


def test_mpc_on_device_loop():
    problem = make_problem(horizon=20)
    params = SolverParams(max_iterations=3, threshold=1e-6, mu=1e5)
    xs, us, ocs = jax.jit(
        lambda x: run_mpc(problem, params, x, n_steps=10)
    )(jnp.zeros(2))
    assert xs.shape == (11, 2) and us.shape == (10, 1)
    assert np.isfinite(np.asarray(xs)).all()


def test_checkpoint_roundtrip(tmp_path):
    tree = {
        "us": jnp.arange(6.0).reshape(3, 2),
        "nested": (jnp.ones(4), jnp.zeros((2, 2))),
    }
    path = str(tmp_path / "state.npz")
    checkpoint.save(path, tree)
    like = jax.tree.map(jnp.zeros_like, tree)
    restored = checkpoint.load(path, like)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.slow
def test_mesh_sharded_batch_solve():
    """Batch axis sharded over the 8-device CPU mesh EQUALS the unsharded
    vmap solve — a wrong psum, a sharding-axis mix-up, or a silently
    replicated batch all fail the elementwise comparison here."""
    from ddp_jax.parallel.mesh import batch_sharded_solve, make_batch_mesh
    from ddp_jax.solver.solve import solve

    problem = make_problem(dtype=jnp.float64, horizon=20)
    params = SolverParams(max_iterations=15, threshold=1e-8, mu=1e6)
    mesh = make_batch_mesh(8)
    fn = batch_sharded_solve(problem, params, mesh)
    x0s = jnp.stack([jnp.array([0.05 * i, 0.0]) for i in range(16)])
    us, stats = fn(x0s)
    assert us.shape == (16, 20, 1)

    ref = jax.jit(jax.vmap(lambda x: solve(problem, params, x)))(x0s)
    # tolerance-level equality of controls (fusion reordering across
    # shard_map can flip the while_loop's `done` one iteration early for a
    # converged sample → ~1e-7 relative wiggle on |u| ~ 1e2; an axis mixup
    # or silent replication would be off by orders of magnitude)
    np.testing.assert_allclose(
        np.asarray(us), np.asarray(ref.us), rtol=1e-5, atol=1e-6
    )
    # psum aggregates must equal the locally computed global reductions
    np.testing.assert_allclose(
        float(stats["mean_constr"]),
        float(jnp.mean(ref.stats.opt_constr)),
        rtol=1e-12,
    )
    assert int(stats["n_converged"]) == int(jnp.sum(ref.stats.converged))


@pytest.mark.slow
def test_mesh_sharded_solve_batched_pallas():
    """The PRODUCTION batched path (solve_batched, backward='pallas'
    interpret mode) inside shard_map on the 8-device CPU mesh equals the
    unsharded run elementwise — proves the Riccati kernel launches
    per-shard on its local batch block."""
    from ddp_jax.parallel.mesh import batch_sharded_solve_batched, make_batch_mesh
    from ddp_jax.solver.batched import solve_batched

    problem = make_problem(dtype=jnp.float64, horizon=12)
    params = SolverParams(max_iterations=4, threshold=1e-8, mu=1e5, inner_iters_max=1)
    mesh = make_batch_mesh(8)
    B = 16
    x0s = jnp.stack([jnp.array([0.05 * i, 0.01]) for i in range(B)])
    fn = batch_sharded_solve_batched(
        problem, params, mesh, backward="pallas", interpret=True, block_b=2
    )
    res, stats = fn(x0s)

    ref = jax.jit(
        lambda x: solve_batched(
            problem, params, x, backward="pallas", interpret=True, block_b=2
        )
    )(x0s)
    np.testing.assert_allclose(
        np.asarray(res.us), np.asarray(ref.us), rtol=1e-9, atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(res.opt_constr), np.asarray(ref.opt_constr), rtol=1e-9, atol=1e-12
    )
    np.testing.assert_allclose(
        float(stats["mean_constr"]), float(jnp.mean(ref.opt_constr)), rtol=1e-12
    )


@pytest.mark.slow
def test_batch_mpc_step_on_mesh():
    """Fleet MPC: batched replanning sharded over the 8-device mesh
    (BASELINE configs[5] code path on virtual devices)."""
    from ddp_jax.parallel.mesh import make_batch_mesh
    from ddp_jax.solver.mpc import init_batch_carry, make_batch_mpc_step

    problem = make_problem(dtype=jnp.float64, horizon=20)
    params = SolverParams(max_iterations=3, threshold=1e-6, mu=1e5)
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = make_batch_mesh(8)
    step = make_batch_mpc_step(problem, params, mesh)
    B = 16
    sh = NamedSharding(mesh, P("batch"))
    # distinct per-sample starts so replication bugs can't hide
    x = jax.device_put(
        jnp.stack([jnp.array([0.03 * i, 0.0]) for i in range(B)]), sh
    )
    carry = init_batch_carry(problem, B, jnp.float64, x0s=jnp.asarray(np.asarray(x)))
    carry = jax.device_put(carry, jax.tree.map(lambda _: sh, carry))

    from ddp_jax.solver.batched import solve_batched

    # unsharded reference state (device_get strips the mesh sharding)
    x_ref = jnp.asarray(np.asarray(x))
    carry_ref = jax.tree.map(lambda a: jnp.asarray(np.asarray(a)), carry)
    ref_solve = jax.jit(
        lambda xr, cr: solve_batched(
            problem,
            params,
            xr,
            us_init=cr.us_warm,
            mults_init=cr.mults,
            mu_init=jnp.maximum(cr.mu, params.mu),
            reg_init=jnp.maximum(cr.reg, params.reg),
        )
    )
    from ddp_jax.solver.mpc import MPCCarry as _Carry

    for _ in range(3):
        u0, carry, mean_c = step(x, carry)
        x = jax.vmap(lambda xx, uu: problem.dynamics(0, xx, uu))(x, u0)
        # unsharded reference replan (same warm-start rule) on the same state
        res = ref_solve(x_ref, carry_ref)
        carry_ref = _Carry(
            us_warm=jnp.concatenate([res.us[:, 1:], res.us[:, -1:]], axis=1),
            mults=res.mults,
            mu=jnp.clip(res.mu / 10.0, params.mu, 100.0 * params.mu),
            reg=res.reg,
        )
        np.testing.assert_allclose(
            np.asarray(u0), np.asarray(res.us[:, 0]), rtol=1e-6, atol=1e-8
        )
        np.testing.assert_allclose(
            float(mean_c), float(jnp.mean(res.opt_constr)), rtol=1e-6, atol=1e-10
        )
        x_ref = jax.vmap(lambda xx, uu: problem.dynamics(0, xx, uu))(
            x_ref, res.us[:, 0]
        )
    assert u0.shape == (B, 1)
    np.testing.assert_allclose(
        np.asarray(x), np.asarray(x_ref), rtol=1e-6, atol=1e-8
    )


def test_mpc_multiplier_warm_start_beats_cold():
    """Carrying (mults, μ, reg) across replans reaches lower constraint
    violation at a fixed 3-iteration budget than controls-only warm starts
    (an MPC loop that drops multiplier state re-pays the
    AL feasibility ramp every replan).  ≙ the multiplier state the
    reference's solve() threads across AL iterations (ddp.hpp:677-695)."""
    dtype = jnp.float64
    model = pendulum(1.0, 1.0, dtype=dtype)
    dyn = dynamics.euler(model, 0.01)
    horizon = 30
    con = constraints.advance_time(
        constraints.StateTarget(
            model=model,
            target=jnp.asarray([3.14, 0.0], dtype=dtype),
            active_ts=(horizon,),
        ),
        dyn,
        times=2,
    )
    problem = Problem(
        dynamics=dyn,
        cost=costs.quad_control(1.0, dtype=dtype),
        constraint=con,
        horizon=horizon,
    )
    params = SolverParams(
        max_iterations=3, threshold=1e-12, mu=1e4, inner_iters_max=1
    )

    def run(warm_mults, n_replans, advance_plant):
        step = make_mpc_step(problem, params, warm_mults=warm_mults)
        carry = init_carry(problem, dtype=dtype)
        x = jnp.zeros(2, dtype)
        ocs = []
        for _ in range(n_replans):
            out = step(x, carry)
            carry = out.carry
            if advance_plant:
                x = problem.dynamics(0, x, out.u0)
            ocs.append(float(out.opt_constr))
        return np.asarray(ocs), x

    # (a) static replans (same x): warm-started re-solves CONTINUE the AL
    # ramp — the violation keeps dropping; cold re-solves are stuck at the
    # 3-iteration floor forever
    oc_warm_s, _ = run(True, 12, advance_plant=False)
    oc_cold_s, _ = run(False, 12, advance_plant=False)
    assert np.isfinite(oc_warm_s).all()
    assert oc_warm_s[-1] < 0.1 * oc_cold_s[-1], (oc_warm_s[-1], oc_cold_s[-1])
    # cold never improves (each replan repeats the same truncated solve,
    # modulo the us_warm shift)
    assert oc_cold_s[-1] > 0.5 * oc_cold_s[1]

    # (b) closed loop: warm starts lower both the steady-state violation and
    # the worst-case excursion (cold loops re-pay the AL ramp and spike)
    oc_warm, x_warm = run(True, 40, advance_plant=True)
    oc_cold, _ = run(False, 40, advance_plant=True)
    assert np.isfinite(x_warm).all() and np.isfinite(oc_warm).all()
    tail = slice(10, None)
    assert np.median(oc_warm[tail]) < 0.8 * np.median(oc_cold[tail]), (
        np.median(oc_warm[tail]),
        np.median(oc_cold[tail]),
    )
    assert oc_warm[tail].max() < 0.25 * oc_cold[tail].max(), (
        oc_warm[tail].max(),
        oc_cold[tail].max(),
    )


def test_mpc_carry_checkpoint_roundtrip(tmp_path):
    """The full MPCCarry persists through utils/checkpoint.py and resumes
    bit-identically (SURVEY §5: checkpointed warm starts are the genuine
    addition over the reference).  (The longer resume-loop variant below,
    test_mpc_carry_checkpoint_resume, previously shadowed this name.)"""
    problem = make_problem(horizon=20)
    params = SolverParams(max_iterations=2, threshold=1e-8, mu=1e4)
    step = make_mpc_step(problem, params)
    carry = init_carry(problem, dtype=jnp.float64)
    x = jnp.asarray([0.2, 0.0])
    for _ in range(3):
        out = step(x, carry)
        carry = out.carry
        x = problem.dynamics(0, x, out.u0)

    path = str(tmp_path / "mpc_carry.npz")
    checkpoint.save(path, carry)
    restored = checkpoint.load(path, jax.tree.map(jnp.zeros_like, carry))
    out_a = step(x, carry)
    out_b = step(x, restored)
    np.testing.assert_array_equal(np.asarray(out_a.u0), np.asarray(out_b.u0))
    np.testing.assert_array_equal(
        np.asarray(out_a.carry.mults.val), np.asarray(out_b.carry.mults.val)
    )
    assert float(out_a.carry.mu) == float(out_b.carry.mu)


def test_trajectory_config_target():
    """Per-timestep target gather (the reference's target-view-by-t idiom)."""
    from ddp_jax.models.pendulum import pendulum
    from ddp_jax.ocp.constraints import TrajectoryConfigTarget

    model = pendulum(dtype=jnp.float64)
    T = 10
    targets = jnp.linspace(0.0, 1.0, T + 1)[:, None]
    con = TrajectoryConfigTarget(
        model=model, targets=targets, active_ts=tuple(range(0, T, 2))
    )
    x = jnp.asarray([0.25, 0.0])
    v = con.value(5, x, jnp.zeros(1))
    np.testing.assert_allclose(float(v[0]), 0.25 - 0.5, atol=1e-12)
    assert con.active(2) and not con.active(3)


def test_mpc_carry_checkpoint_resume(tmp_path):
    """A controller host can die mid-loop and resume from a checkpointed
    MPCCarry with bit-identical subsequent replans (SURVEY §5's 'genuine
    addition': persist trajectory/multipliers/μ/reg warm-start state)."""
    from ddp_jax.solver.mpc import init_carry, make_mpc_step
    from ddp_jax.utils import checkpoint

    dtype = jnp.float64
    problem = make_problem(dtype=dtype, horizon=20)
    params = SolverParams(max_iterations=3, threshold=1e-10, mu=1e5, inner_iters_max=1)
    step = make_mpc_step(problem, params)

    x = jnp.asarray([0.4, 0.0], dtype)
    carry = init_carry(problem, dtype=dtype)
    for _ in range(4):
        out = step(x, carry)
        carry = out.carry
        x = problem.dynamics(0, x, out.u0)

    # persist mid-run, 'restart' the host, resume from disk
    path = str(tmp_path / "mpc_carry.npz")
    checkpoint.save(path, carry)
    restored = checkpoint.load(path, carry)
    for a, b in zip(jax.tree.leaves(carry), jax.tree.leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    outs_live, outs_resumed = [], []
    x_live = x_res = x
    c_live, c_res = carry, restored
    for _ in range(3):
        o1 = step(x_live, c_live)
        o2 = step(x_res, c_res)
        outs_live.append(o1.u0)
        outs_resumed.append(o2.u0)
        c_live, c_res = o1.carry, o2.carry
        x_live = problem.dynamics(0, x_live, o1.u0)
        x_res = problem.dynamics(0, x_res, o2.u0)
    for a, b in zip(outs_live, outs_resumed):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_mpc_step_forward_seq_matches_sweep():
    """make_mpc_step(forward="seq") replans bit-identically to the parallel
    sweep (the early-exit ladder picks the same largest accepted step); the
    win is runtime only — warm-started replans accept step 1 after round 1,
    so the ladder does ~1 rollout instead of n_linesearch."""
    problem = make_problem(horizon=20)
    params = SolverParams(max_iterations=3, threshold=1e-10, mu=1e5, inner_iters_max=1)
    step_ref = make_mpc_step(problem, params)
    step_seq = make_mpc_step(problem, params, forward="seq")

    x_a = x_b = jnp.asarray([0.3, 0.0])
    c_a = c_b = init_carry(problem, dtype=jnp.float64)
    for _ in range(4):
        o_a = step_ref(x_a, c_a)
        o_b = step_seq(x_b, c_b)
        np.testing.assert_array_equal(np.asarray(o_a.u0), np.asarray(o_b.u0))
        np.testing.assert_array_equal(
            np.asarray(o_a.carry.mults.val), np.asarray(o_b.carry.mults.val)
        )
        c_a, c_b = o_a.carry, o_b.carry
        x_a = problem.dynamics(0, x_a, o_a.u0)
        x_b = problem.dynamics(0, x_b, o_b.u0)


def test_mpc_carry_resumes_gate_tolerances():
    """The (w, n) gate tolerances persist across replans (MPCCarry once
    re-derived them from params each replan, so the inner-convergence gate
    state reset whenever inner_iters_max did not force it open)."""
    dtype = jnp.float64
    model = pendulum(1.0, 1.0, dtype=dtype)
    dyn = dynamics.euler(model, 0.01)
    horizon = 20
    con = constraints.advance_time(
        constraints.StateTarget(
            model=model,
            target=jnp.asarray([3.14, 0.0], dtype=dtype),
            active_ts=(horizon,),
        ),
        dyn,
        times=2,
    )
    problem = Problem(
        dynamics=dyn,
        cost=costs.quad_control(1.0, dtype=dtype),
        constraint=con,
        horizon=horizon,
    )
    # w-gated schedule (no forced inner cap): w tightens on multiplier
    # updates and must survive the replan boundary
    params = SolverParams(max_iterations=6, threshold=1e-9, mu=1e6)
    step = make_mpc_step(problem, params)
    carry = init_carry(problem, dtype=dtype)
    assert float(carry.w) == 0.0  # cold marker
    x = jnp.asarray([0.0, 0.0])
    out = step(x, carry)
    w1 = float(out.carry.w)
    n1 = float(out.carry.n)
    assert w1 > 0.0 and n1 > 0.0
    out2 = step(problem.dynamics(0, x, out.u0), out.carry)
    # the second replan starts from the carried state; once any update
    # fired, w is strictly below the cold default and keeps shrinking
    assert float(out2.carry.w) <= w1
    assert float(out2.carry.w) < 1.0 / params.mu or w1 < 1.0 / params.mu
    del n1
