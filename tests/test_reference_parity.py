"""Reference-parity: ddp_jax vs a transliteration of the reference solver.

Discharges the BASELINE north-star correctness bar — "matching the reference
C++ solver's control sequences within tolerance at the same horizon and
iteration budget" — with three artifacts (the C++ itself cannot build here:
conan/pinocchio are absent, so tests/reference_oracle.py stands in, a
clean-room transliteration of ddp.hpp:744-842 / ddp_bwd.ipp / ddp_fwd.ipp /
problem.hpp on the pendulum driver config, test/pendulum_ddp.cpp:24-114):

1. *Step fidelity*: solve(reference_schedule=True) tracks the f64 oracle
   essentially bitwise (≤1e-10, measured 2.4e-14) through 8 full outer
   iterations — backward pass, line-searched forward pass, multiplier
   update decision tree and tolerance schedule all agree decision-for-
   decision.  (Beyond the point where the inner Newton solve hits the f64
   noise floor, the reference's raw ``opt_obj < w`` gate becomes a
   noise-level comparison and any two f64 implementations diverge — the
   very failure mode the reference's MPFR-1000 scalars avoid and our
   float-native schedule gates against; docs/DESIGN.md.)

2. *Precision envelope*: the same oracle instantiated at mpmath dps=120 —
   the analog of the reference's MPFR-1000 instantiation
   (test/pendulum_ddp.cpp:15-17) — on the *literal* driver config
   (μ₀=1e20, horizon 200, 200 iterations, threshold 1e-80) converges to
   ‖eq‖ ≈ 8.6e-43 / opt_obj ≈ 3.5e-103.  Its controls are committed as
   tests/golden_pendulum_reference.npz; the f64 oracle run of the same
   config reproduces them to ~9e-9 (its noise floor).

3. *Optimum parity* (the north star): ddp_jax's float-native schedule in
   ordinary f64 — μ₀=1e8, same horizon 200, within the same 200-iteration
   budget (converges in ~47) — matches the golden MPFR-analog control
   sequence to max|Δu| ≤ 1e-9 (measured 7.4e-12): hardware floats + the
   adapted schedule reach the answer the reference needs 1000-digit
   arithmetic for.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from reference_oracle import solve_pendulum_reference
from test_pendulum_solve import HORIZON, make_problem

from ddp_jax.solver.solve import Method, SolverParams, solve

GOLDEN = "tests/golden_pendulum_reference.npz"


def _golden():
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "golden_pendulum_reference.npz")
    return np.load(path)


def test_reference_schedule_stepwise_parity():
    """solve(reference_schedule=True) == the oracle, iteration for
    iteration, while every gate decision is above the f64 noise floor."""
    rng = np.random.RandomState(0)
    jac_row = rng.uniform(-1, 1, size=(2,))  # ≙ eq.jac().setRandom()
    iters, mu0 = 8, 1e4

    res_o = solve_pendulum_reference(
        mu_init=mu0, max_iterations=iters, threshold=1e-300, jac_init=jac_row
    )

    problem = make_problem(second_order=True, dtype=jnp.float64)
    jac_init = np.zeros((HORIZON, 1, 2))
    jac_init[HORIZON - 2, 0] = jac_row
    params = SolverParams(max_iterations=iters, threshold=1e-300, mu=mu0)
    res_t = jax.jit(
        lambda x: solve(
            problem, params, x,
            method=Method.PRIMAL_DUAL_AFFINE,
            mults_init_jac=jnp.asarray(jac_init),
            reference_schedule=True,
        )
    )(jnp.zeros(2, jnp.float64))

    us_o = np.asarray(res_o["us"], dtype=np.float64)
    xs_o = np.asarray(res_o["xs"], dtype=np.float64)
    assert np.abs(np.asarray(res_t.us) - us_o).max() < 1e-10
    assert np.abs(np.asarray(res_t.xs) - xs_o).max() < 1e-10
    # the μ/schedule state agrees too (no update fired or both fired alike)
    assert float(res_t.stats.mu) == pytest.approx(float(res_o["mu"]))
    assert float(res_t.stats.opt_obj) == pytest.approx(
        float(res_o["opt_obj"]), rel=1e-6
    )


def test_oracle_f64_reproduces_mpmath_golden():
    """The f64 instantiation of the oracle reproduces the committed
    mpmath-dps-120 golden run (literal driver config) to its noise floor —
    the reference's precision-envelope property (component #30)."""
    g = _golden()
    assert int(g["horizon"]) == 200 and float(g["mu_init"]) == 1e20
    res = solve_pendulum_reference(mu_init=1e20, max_iterations=200)
    du = np.abs(np.asarray(res["us"], dtype=np.float64) - g["us"]).max()
    assert du < 1e-6, du  # measured 9.4e-9
    # high-precision run satisfied the constraint far below f64 resolution
    assert float(g["opt_constr"]) < 1e-40


def test_solve_matches_reference_golden_controls():
    """North star: same horizon (200), same iteration budget (≤200), ddp_jax
    f64 with the float-native schedule lands on the reference's (MPFR-analog)
    control sequence."""
    g = _golden()
    problem = make_problem(second_order=True, dtype=jnp.float64)
    params = SolverParams(max_iterations=200, threshold=1e-9, mu=1e8)
    res = jax.jit(lambda x: solve(problem, params, x))(jnp.zeros(2, jnp.float64))
    assert bool(res.stats.converged)
    assert int(res.stats.iterations) <= 200
    du = np.abs(np.asarray(res.us) - g["us"]).max()
    dx = np.abs(np.asarray(res.xs) - g["xs"]).max()
    assert du < 1e-9, du  # measured 7.4e-12
    assert dx < 1e-11, dx  # measured 6.7e-14


def _gate_seq(history, k):
    out = []
    for i in range(k):
        if bool(history.upd_success[i]):
            out.append("success")
        elif bool(history.upd_failure[i]):
            out.append("failure")
        else:
            out.append("none")
    return out


@pytest.mark.slow
def test_decision_sequence_parity_vs_mpmath_oracle():
    """Decision-sequence parity: the *gate outcome
    stream* of solve(reference_schedule=True) in f64 matches the mpmath
    dps=120 oracle (≙ the reference's MPFR instantiation of the
    ddp.hpp:677-695 decision tree), decision for decision, as far as the
    decisions are resolvable in f64 at all:

    - μ₀=1e4 (random jac init, the stepwise-parity config): 16 identical
      (gate, step, μ) decisions INCLUDING three update_success firings
      (iterations 7, 11, 14).  Divergence at 16 is precision-forced: after
      three successes w = 1e-4/μ³ = 1e-16, and the reference gate
      opt_obj < w then compares a μ-scaled stationarity (noise ~μ·eps₆₄)
      against a sub-noise threshold — the very regime the reference's
      MPFR-1000 scalars exist for (test/pendulum_ddp.cpp:15-17).
    - the literal driver config μ₀=1e20 (test/pendulum_ddp.cpp:33):
      14 identical gate outcomes, and the μ/reg escalation trace identical
      over all 28 recorded iterations.  The oracle's iteration-15
      update_success fires on opt_obj ≈ 3e-21 < w = 1e-20 — an f64
      implementation cannot resolve any μ=1e20-scaled measure at 1e-20
      (noise floor μ·eps₆₄ ≈ 2e4), so the gate stream past 14 is
      MPFR-only by construction, not an implementation difference (the f64
      oracle transliteration reads "none" there too, matching ddp_jax).
    """
    mpmath = pytest.importorskip("mpmath")
    mpmath.mp.dps = 120
    mp_kw = dict(
        scalar=mpmath.mpf, sin=mpmath.sin, cos=mpmath.cos, sqrt=mpmath.sqrt,
        record_history=True, threshold=1e-300,
    )

    # --- μ₀=1e4: full decision tree fires within f64 resolution ---
    rng = np.random.RandomState(0)
    jac_row = rng.uniform(-1, 1, size=(2,))
    iters = 16
    res_o = solve_pendulum_reference(
        mu_init=1e4, max_iterations=iters, jac_init=jac_row, **mp_kw
    )
    problem = make_problem(second_order=True, dtype=jnp.float64)
    jac_init = np.zeros((HORIZON, 1, 2))
    jac_init[HORIZON - 2, 0] = jac_row
    params = SolverParams(max_iterations=iters, threshold=1e-300, mu=1e4)
    res_t = jax.jit(
        lambda x: solve(
            problem, params, x, method=Method.PRIMAL_DUAL_AFFINE,
            mults_init_jac=jnp.asarray(jac_init),
            reference_schedule=True, history=True,
        )
    )(jnp.zeros(2, jnp.float64))
    gates_o = [h["gate"] for h in res_o["history"]]
    gates_t = _gate_seq(res_t.history, iters)
    assert gates_t == gates_o, (gates_t, gates_o)
    assert gates_o.count("success") == 3  # real firings, not a trivial run
    for i, ho in enumerate(res_o["history"]):
        assert float(res_t.history.step[i]) == float(ho["step"]), i
        assert float(res_t.history.mu[i]) == pytest.approx(float(ho["mu"])), i
        assert float(res_t.history.reg[i]) == pytest.approx(float(ho["reg"])), i

    # --- literal μ₀=1e20 driver config: gate parity to the precision wall ---
    iters20 = 28
    res_o20 = solve_pendulum_reference(
        mu_init=1e20, max_iterations=iters20, **mp_kw
    )
    params20 = SolverParams(max_iterations=iters20, threshold=1e-300, mu=1e20)
    res_t20 = jax.jit(
        lambda x: solve(
            problem, params20, x, method=Method.PRIMAL_DUAL_AFFINE,
            reference_schedule=True, history=True,
        )
    )(jnp.zeros(2, jnp.float64))
    gates_o20 = [h["gate"] for h in res_o20["history"]]
    gates_t20 = _gate_seq(res_t20.history, iters20)
    assert gates_t20[:14] == gates_o20[:14]
    # μ/reg escalation decisions agree over the whole record
    for i, ho in enumerate(res_o20["history"]):
        assert float(res_t20.history.mu[i]) == pytest.approx(float(ho["mu"])), i
        assert float(res_t20.history.reg[i]) == pytest.approx(float(ho["reg"])), i
    # the first divergent oracle decision is below any f64-resolvable
    # magnitude: update_success on opt_obj < w = 1e-20 at μ = 1e20
    first_succ = gates_o20.index("success")
    assert first_succ >= 14
    # the gating w is the one carried INTO the iteration (w is recorded
    # post-update; every earlier iteration was "none", leaving w = 1/μ)
    assert float(res_o20["history"][first_succ - 1]["w"]) == pytest.approx(1e-20)
    assert float(res_o20["history"][first_succ]["opt_obj"]) < 1e-19


@pytest.mark.slow
def test_mpmath_oracle_short_smoke():
    """The precision-generic oracle instantiates at mpmath scalars (the
    MPFR-instantiation analog) and the literal μ₀=1e20 config converges
    immediately under high precision."""
    mpmath = pytest.importorskip("mpmath")
    mpmath.mp.dps = 60
    res = solve_pendulum_reference(
        mu_init=1e20, max_iterations=3, threshold=1e-80,
        scalar=mpmath.mpf, sin=mpmath.sin, cos=mpmath.cos, sqrt=mpmath.sqrt,
    )
    assert float(res["opt_constr"]) < 1e-10
