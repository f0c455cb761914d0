"""Per-iteration solver observability (solve(..., history=True)).

≙ the reference's per-iteration stdout block (μ/reg/w/n/step/‖eq‖,
ddp.hpp:807-838) and its primal/dual optimality trace files appended on
every update_derivatives (ddp.hpp:651-664).  The tests pin the recorded
schedule to the solver's decision tree and the history path to the
while_loop path's iterates.
"""

import numpy as np

import jax
import jax.numpy as jnp

from ddp_jax.models.pendulum import pendulum
from ddp_jax.ocp import constraints, costs, dynamics
from ddp_jax.ocp.problem import Problem
from ddp_jax.solver.solve import SolverParams, solve

HORIZON = 100
DT = 0.01
ITERS = 40


def make_problem(dtype=jnp.float64):
    model = pendulum(1.0, 1.0, dtype=dtype)
    dyn = dynamics.euler(model, DT)
    con = constraints.advance_time(
        constraints.ConfigTarget(
            model=model,
            target=jnp.asarray([3.14], dtype=dtype),
            active_ts=(HORIZON,),
        ),
        dyn,
        times=2,
    )
    return Problem(
        dynamics=dyn,
        cost=costs.quad_control(1.0, dtype=dtype),
        constraint=con,
        horizon=HORIZON,
        second_order=True,
    )


def _solve_with_history():
    problem = make_problem()
    params = SolverParams(max_iterations=ITERS, threshold=1e-9, mu=1e6)
    x0 = jnp.zeros((2,), dtype=jnp.float64)
    res = jax.jit(lambda x: solve(problem, params, x, history=True))(x0)
    return problem, params, x0, res


def test_history_matches_schedule_decision_tree():
    """Every recorded transition must follow the AL update rules
    (ddp.hpp:677-695, 790-797): μ·10 on constraint failure, w/μ tightening
    on multiplier update, μ nondecreasing, steps in (0, 1]."""
    _, params, _, res = _solve_with_history()
    h = res.history
    mu = np.asarray(h.mu)
    w = np.asarray(h.w)
    n = np.asarray(h.n)
    step = np.asarray(h.step)
    upd_s = np.asarray(h.upd_success)
    upd_f = np.asarray(h.upd_failure)
    done = np.asarray(h.done)

    assert mu.shape == (ITERS,)
    live = ~done  # rows where the iteration actually ran
    assert np.any(upd_s), "schedule never fired a multiplier update"

    # steps: accepted line-search steps are powers-of-two in (0, 1]
    assert np.all(step[live] > 0) and np.all(step[live] <= 1.0)

    # μ is nondecreasing, and a failure row multiplies by ≥10 (the backward
    # pass may escalate further on Cholesky retries)
    mu_prev = np.concatenate([[params.mu], mu[:-1]])
    assert np.all(mu >= mu_prev * (1 - 1e-12))
    fail_rows = np.where(upd_f)[0]
    assert np.all(mu[fail_rows] >= 10.0 * mu_prev[fail_rows] * (1 - 1e-12))

    # a success row divides w by the pre-update μ and tightens n
    w_prev = np.concatenate([[1.0 / params.mu], w[:-1]])
    n_prev = np.concatenate([[params.mu**-0.1], n[:-1]])
    succ = np.where(upd_s)[0]
    assert np.allclose(w[succ], w_prev[succ] / mu_prev[succ], rtol=1e-12)
    # n_new = max(n_prev · μ^-0.9, threshold)
    assert np.allclose(
        n[succ],
        np.maximum(n_prev[succ] * mu_prev[succ] ** -0.9, params.threshold),
        rtol=1e-9,
    )

    # an update fires on exactly one branch
    assert not np.any(np.logical_and(upd_s, upd_f))
    # after the first converged row everything is frozen
    assert np.all(done == np.logical_or.accumulate(done))
    if done.any():
        j = int(done.argmax())
        assert int(res.stats.iterations) == j + 1
        assert bool(res.stats.converged)
        frozen = slice(j, None)
        assert np.all(mu[frozen] == mu[j])
        assert not np.any(upd_s[frozen]) and not np.any(upd_f[frozen])


def test_history_path_matches_while_loop_path():
    """history=True swaps while_loop → fixed-length scan; the iterates must
    be identical (same body, same masking)."""
    problem, params, x0, res_h = _solve_with_history()
    res_w = jax.jit(lambda x: solve(problem, params, x))(x0)
    assert res_w.history is None
    np.testing.assert_allclose(
        np.asarray(res_h.us), np.asarray(res_w.us), rtol=0, atol=1e-13
    )
    assert int(res_h.stats.iterations) == int(res_w.stats.iterations)
    assert float(res_h.stats.opt_constr) == float(res_w.stats.opt_constr)
    # the recorded traces land at the final stats
    h = res_h.history
    done = np.asarray(h.done)
    j = int(done.argmax()) if done.any() else ITERS - 1
    assert float(np.asarray(h.opt_constr)[j]) == float(res_w.stats.opt_constr)


def test_history_feeds_convergence_trace(tmp_path):
    """ConvergenceTrace.record_history writes one primal/dual line per
    executed iteration (≙ /tmp/<name>_primal.dat, _dual.dat)."""
    from ddp_jax.diagnostics.profiling import ConvergenceTrace, format_history

    _, _, _, res = _solve_with_history()
    trace = ConvergenceTrace("hist_test", directory=str(tmp_path))
    trace.record_history(res.history)
    done = np.asarray(res.history.done)
    n_expected = int(done.argmax()) + 1 if done.any() else ITERS
    primal = (tmp_path / "hist_test_primal.dat").read_text().strip().splitlines()
    dual = (tmp_path / "hist_test_dual.dat").read_text().strip().splitlines()
    assert len(primal) == n_expected and len(dual) == n_expected
    assert float(primal[-1]) == float(np.asarray(res.history.opt_constr)[-1]) or float(
        primal[-1]
    ) == float(np.asarray(res.history.opt_constr)[n_expected - 1])

    # the stdout-block renderer covers the same rows and stays parseable
    text = format_history(res.history)
    assert len(text.splitlines()) == n_expected + 1  # header + rows
    assert "mu*=10" in text or "p+=mu*eq" in text


def test_batched_history_records_schedule():
    """solve_batched(history=True) stacks [I, B] per-iteration state; the
    recorded schedule must be self-consistent with the returned result."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ddp_jax.solver.batched import solve_batched

    problem = make_problem(dtype=jnp.float64)
    params = SolverParams(max_iterations=5, threshold=1e-9, mu=1e5, inner_iters_max=1)
    x0s = jnp.stack([jnp.asarray([0.1 * i, 0.0]) for i in range(4)])
    res = jax.jit(lambda x: solve_batched(problem, params, x, history=True))(x0s)
    h = res.history
    assert h is not None
    I, B = params.max_iterations, 4
    assert h.mu.shape == (I, B) and h.opt_constr.shape == (I, B)
    # final carried state matches the last recorded row
    np.testing.assert_array_equal(np.asarray(h.mu[-1]), np.asarray(res.mu))
    # success/failure updates are mutually exclusive
    assert not np.any(np.asarray(h.upd_success) & np.asarray(h.upd_failure))
    # mu only moves by the x10 escalations the history records
    mus = np.asarray(h.mu)
    assert np.all(mus[1:] >= mus[:-1] - 1e-12)
    assert np.isfinite(np.asarray(h.opt_obj)).all()
    # history off by default
    res0 = jax.jit(lambda x: solve_batched(problem, params, x))(x0s)
    assert res0.history is None
