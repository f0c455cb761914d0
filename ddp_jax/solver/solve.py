"""Top-level equality-constrained DDP solve: the augmented-Lagrangian outer
loop.

Reference: ``ddp_solver_t::solve`` (ddp.hpp:744-842) and
``update_derivatives`` (ddp.hpp:641-696).  Control flow map:

    reference                          here
    ---------                          ----
    outer for-loop w/ early return     lax.while_loop, `done` flag
    multiplier update decision tree    masked scalar updates (jnp.where)
    backward restart loop              bounded while_loop in riccati.py
    line-search halving loop           bounded while_loop in rollout.py

The whole solve is a single pure JAX function: jit it once, vmap it over
thousands of initial states / targets, shard the batch over a device mesh.
"""

from __future__ import annotations

import enum
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ddp_jax.solver import al as al_mod
from ddp_jax.solver.riccati import backward_pass
from ddp_jax.solver.rollout import forward_pass


class Method(enum.Enum):
    """≙ method enum (ddp.hpp:18-22).

    PRIMAL and PRIMAL_DUAL_CONSTANT keep the multiplier state-independent
    (jac pinned to zero, the reference's zero_t/constant split); AFFINE gives
    multipliers a state-feedback term re-expanded each iteration.

    PRIMAL additionally drops the control-feedback correction from the AL
    multiplier update: p += μ·eq instead of p += μ·(eq + eq_u·k).  This is
    the distinction the reference *declares* via
    ``multiplier_feedback_sequence`` — primal maps to
    ``no_multiplier_feedback_t``/``zero_t`` (ddp.hpp:365-371, zero.hpp:8-42)
    — though its ``zero_feedback_multipliers()`` accessor (ddp.hpp:388) has
    no call site: as shipped, the reference's update_derivatives always
    feeds the control feedback (ddp.hpp:683-689), making primal behaviorally
    identical to constant there.  We implement the declared semantics, which
    also matches the classic first-order AL update p += μ·eq.
    """

    PRIMAL = "primal"
    PRIMAL_DUAL_CONSTANT = "primal_dual_constant_multipliers"
    PRIMAL_DUAL_AFFINE = "primal_dual_affine_multipliers"


class SolverParams(NamedTuple):
    """≙ solver_parameters_t (ddp.hpp:42-50).  w/n defaults follow the test
    drivers: w = 1/μ, n = 1/μ^0.1 (test/pendulum_ddp.cpp:102-103).

    Finite-precision additions (the reference runs its schedule under
    MPFR-1000, where w /= μ each success stays meaningful; in f64/f32 it
    collapses below the attainable optimality floor within one update):

    - ``w_min``: floor on the inner-convergence tolerance w.  None → scaled
      to dtype as 10·sqrt(eps).
    - plateau gating (always on): if the μ-dependent inner optimality measure
      failed to drop 10× since the previous iterate *and* the previous
      iteration did not change (p, μ), the inner Newton solve is at its
      numerical floor and the multiplier-update gate opens.
    - ``inner_iters_max``: bound on inner Newton iterations between
      multiplier/μ updates (classic bounded-inner-loop AL).  None → the gate
      opens only via w/plateau, the reference's rule.  Small fixed budgets
      (the batched bench) want 1-2: with *accurate* gains the inner measure
      keeps improving 10×/iter, so the plateau never trips and updates fire
      too late to build feasibility in 10 iterations — see
      docs/DESIGN.md "Reduced-precision matmul passes and the AL gate".
    """

    max_iterations: int
    threshold: float
    mu: float
    reg: float = 0.0
    w: float | None = None
    n: float | None = None
    w_min: float | None = None
    inner_iters_max: int | None = None
    # Penalty escalation on update_failure.  The reference hard-codes μ·10
    # unbounded (ddp.hpp:790-792) — safe under MPFR and with its
    # converge-the-inner-problem gate, but with a bounded inner loop
    # (inner_iters_max small) a slow-feasibility workload alternates
    # success/failure and the unbounded ×10 races μ past the stiffness the
    # line search can absorb (measured: 7-DoF spatial_eq lanes stall at
    # ‖eq‖~0.1 with μ→1e15 and step→1e-2).  mu_factor softens the growth;
    # mu_max caps it (classic bounded-penalty AL practice).
    mu_factor: float = 10.0
    mu_max: float | None = None
    # Safeguarded multipliers (Bertsekas-style bound): clip p elementwise
    # after each update.  REQUIRED whenever mu_max is finite: with μ capped,
    # a still-infeasible lane keeps firing p += μ·eq and the multipliers
    # run away (measured: quadrotor fleet diverges to ‖eq‖ ~ 10 with
    # mu_max=1e6 and no bound, converges with both).  None → unbounded.
    mult_max: float | None = None


class SolveStats(NamedTuple):
    iterations: jax.Array
    opt_lag: jax.Array  # μ-free Lagrangian stationarity (the stopping measure)
    opt_obj: jax.Array  # μ-dependent AL stationarity (≙ ddp.hpp:575-627's
    # optimality_obj, the multiplier-update gate measure)
    opt_constr: jax.Array
    mu: jax.Array
    reg: jax.Array
    step: jax.Array
    converged: jax.Array


class SolveHistory(NamedTuple):
    """Per-iteration solver state, stacked over the iteration axis.

    ≙ the reference's per-iteration stdout block (μ/reg/w/n/step/‖eq‖,
    ddp.hpp:807-838) plus its primal/dual optimality trace files
    (ddp.hpp:651-664).  Rows after convergence repeat the converged state
    (the fixed-length scan freezes the carry once ``done``)."""

    mu: jax.Array  # [I] penalty after this iteration's update decision
    reg: jax.Array  # [I] regularization after the backward/forward pair
    w: jax.Array  # [I] inner-convergence tolerance
    n: jax.Array  # [I] constraint-progress tolerance
    step: jax.Array  # [I] accepted line-search step
    opt_obj: jax.Array  # [I] μ-dependent AL stationarity (dual trace)
    opt_lag: jax.Array  # [I] μ-free Lagrangian stationarity
    opt_constr: jax.Array  # [I] max_t ‖eq‖ (primal trace)
    upd_success: jax.Array  # [I] bool: first-order multiplier update fired
    upd_failure: jax.Array  # [I] bool: μ·10 escalation fired
    done: jax.Array  # [I] bool: converged at iteration start


class SolveResult(NamedTuple):
    xs: jax.Array  # [T+1, nx]
    us: jax.Array  # [T, nu]
    fb_k: jax.Array  # [T, nu]       feedforward (for MPC warm starts)
    fb_K: jax.Array  # [T, nu, ndx]  feedback gains
    mults: al_mod.AffineMults
    stats: SolveStats
    history: SolveHistory | None = None  # solve(..., history=True) only


def solve(
    problem,
    params: SolverParams,
    x_init: jax.Array,
    us_init: jax.Array | None = None,
    method: Method = Method.PRIMAL_DUAL_AFFINE,
    precise: bool | str = False,
    mults_init_jac: jax.Array | None = None,
    history: bool = False,
    matmul_precision: str | None = None,
    reference_schedule: bool = False,
) -> SolveResult:
    """``precise=True`` runs the finite-precision-critical stages in
    double-float (solver/precise.py): TF Riccati sweep, TF line-search
    acceptance sums, TF optimality reductions.  The float analog of
    instantiating the reference at MPFR scalars (test/pendulum_ddp.cpp:15-17)
    — same algorithm, wider accumulators, still f32 storage and plain
    elementwise ops.

    ``precise="storage"`` additionally stores the ITERATE (xs, us) as
    double-float pairs and evaluates the dynamics, constraint values, and
    line-search costs in TF (rollout_tf / eq_values_tf /
    forward_pass_storage_tf) — removing the f32 storage floor
    (docs/DESIGN.md) that caps the envelope mode.  Requires a vector-space
    model with ``forward_dynamics_tf`` and TF-capable constraint/cost
    (models/pendulum.py, ConfigTarget/StateTarget/AdvanceTime,
    QuadControlCost).  This is the full-stack analog of the reference's
    whole-program MPFR instantiation.

    ``history=True`` records per-iteration solver state (SolveHistory — the
    reference's μ/reg/w/n/step/‖eq‖ stdout block and primal/dual trace
    files, ddp.hpp:807-838, 651-664) into ``SolveResult.history``.  The
    outer loop then runs as a fixed-length scan of ``max_iterations``
    (converged iterations freeze the carry and repeat their row) instead of
    an early-exiting while_loop — same final iterate, no early exit.

    ``matmul_precision``: None (platform default) | "high" | "highest" —
    pins every stage's matmul passes (see solve_batched's knob; a float32
    product may run in TF32 on the GPU, which costs feasibility on
    arm-class models).

    ``reference_schedule=True`` disables every float-native schedule
    adaptation and runs the reference's exact outer loop (ddp.hpp:744-842):
    raw ``opt_obj < w`` gate (no w_min floor / plateau / inner cap), μ·10 on
    failure with w and n unchanged, on success n = opt_obj(new mults)/μ^0.1
    and w /= μ (ddp.hpp:787-797), stopping on the μ-dependent opt_obj
    measure, and the pre-loop forward result discarded (never swapped in,
    ddp.hpp:768-826).  Exists to be cross-validated against
    tests/reference_oracle.py — the reference-parity artifact."""
    if matmul_precision is not None:
        with jax.default_matmul_precision(matmul_precision):
            return solve(
                problem, params, x_init, us_init=us_init, method=method,
                precise=precise, mults_init_jac=mults_init_jac,
                history=history, reference_schedule=reference_schedule,
            )  # fmt: skip
    T, nu, ne, ndx = problem.horizon, problem.nu, problem.ne, problem.ndx
    dtype = x_init.dtype
    model = problem.model

    from ddp_jax.diagnostics.asserts import ddp_assert, val

    ddp_assert(
        val(x_init.shape, "x_init.shape") == (problem.nx,),
        val(params.max_iterations, "max_iterations") >= 1,
        val(params.mu, "mu") > 0.0,
        msg="solve() preconditions",
    )
    if us_init is None:
        us_init = jnp.zeros((T, nu), dtype=dtype)
    else:
        ddp_assert(
            val(us_init.shape, "us_init.shape") == (T, nu),
            msg="warm-start shape",
        )
    storage = precise == "storage"
    if storage:
        from ddp_jax.solver import precise as precise_mod
        from ddp_jax.ops.twofloat import TF

        if not precise_mod.supports_tf_storage(problem):
            raise ValueError(
                "precise='storage' needs a vector-space model with "
                "forward_dynamics_tf and TF-capable constraint/cost "
                "(see solver/precise.py supports_tf_storage)"
            )
        zf = jnp.zeros_like
        xs_tf = precise_mod.rollout_tf(
            problem, TF(x_init, zf(x_init)), TF(us_init, zf(us_init))
        )
        xs, xs_lo = xs_tf.hi, xs_tf.lo
        us, us_lo = us_init, zf(us_init)
    else:
        xs = problem.rollout(x_init, us_init)
        us = us_init
        xs_lo = jnp.zeros_like(xs)
        us_lo = jnp.zeros_like(us)

    mu = jnp.asarray(params.mu, dtype)
    reg = jnp.asarray(params.reg, dtype)
    w = jnp.asarray(params.w if params.w is not None else 1.0 / params.mu, dtype)
    n = jnp.asarray(
        params.n if params.n is not None else 1.0 / params.mu**0.1, dtype
    )
    threshold = jnp.asarray(params.threshold, dtype)
    eps = jnp.finfo(dtype).eps
    w_min = jnp.asarray(
        params.w_min if params.w_min is not None else 10.0 * eps**0.5, dtype
    )

    affine = method is Method.PRIMAL_DUAL_AFFINE
    # mults_init_jac reproduces the reference's random multiplier-jac
    # startup (ddp.hpp:760-764); default zeros converges to the same optimum
    # (tests/test_methods_schedules.py pins that claim)
    mults = al_mod.init_multipliers(problem, xs, jac_init=mults_init_jac)

    if precise:
        from ddp_jax.solver import precise as precise_mod

        bwd = precise_mod.backward_pass_tf  # accepts *_lo kwargs
        opt_obj_fn = precise_mod.optimality_obj_tf
        opt_lag_fn = precise_mod.optimality_lag_tf
    else:
        bwd = lambda d, mv, mj, mu_, reg_, **kw: backward_pass(
            d, mv, mj, mu_, reg_
        )
        opt_obj_fn = lambda p, d, mv, mj, mu_, **kw: al_mod.optimality_obj(
            p, d, mv, mj, mu_
        )
        opt_lag_fn = lambda p, d, mv, mj, **kw: al_mod.optimality_lag(
            p, d, mv, mj
        )

    tf_jacs = bool(storage) and precise_mod.supports_tf_jacobians(problem)

    def derivs_with_eq_tf(derivs, xs_hi, xs_lo, us_hi, us_lo):
        """Storage mode: re-evaluate eq values in TF on the TF trajectory.
        With TF-Jacobian support (supports_tf_jacobians — model/cost/
        constraint hooks) the first-order rows lx/lu/fx/fu/eqx/equ are also
        re-evaluated on the TF iterate at pair resolution and their lo
        residues returned (rows_lo) — the last stage the reference's MPFR
        instantiation covered that storage mode alone did not
        (problem.hpp:50-341 Scalar-templated derivative evaluation)."""
        from ddp_jax.ops.twofloat import TF as _TF

        eq_tf = precise_mod.eq_values_tf(
            problem, _TF(xs_hi, xs_lo), _TF(us_hi, us_lo)
        )
        derivs = derivs._replace(eq=eq_tf.hi)
        rows_lo = None
        if tf_jacs:
            rows_hi, rows_lo = precise_mod.derivs_rows_tf(
                problem, _TF(xs_hi, xs_lo), _TF(us_hi, us_lo)
            )
            derivs = derivs._replace(**rows_hi)
        return derivs, eq_tf.lo, rows_lo

    def constrain_jac(jac):
        # constant-multiplier methods never grow a state-feedback term
        return jac if affine else jnp.zeros_like(jac)

    mults = mults._replace(jac=constrain_jac(mults.jac))

    # --- pre-loop: derivatives → backward → forward (ddp.hpp:768-773) ---
    derivs = problem.derivatives(xs, us)
    eq_lo = rows_lo = None
    if storage:
        derivs, eq_lo, rows_lo = derivs_with_eq_tf(derivs, xs, xs_lo, us, us_lo)
    bres = bwd(derivs, mults.val, mults.jac, mu, reg, eq_lo=eq_lo, rows_lo=rows_lo)
    mu = bres.mu
    if storage:
        from ddp_jax.ops.twofloat import TF

        ftf = precise_mod.forward_pass_storage_tf(
            problem,
            precise_mod.TrajTF(TF(xs, xs_lo), TF(us, us_lo)),
            bres.k, bres.K,
            precise_mod.MultsTF.from_plain(mults),
            mu,
        )
        fwd_xs, fwd_xs_lo = ftf.traj.xs.hi, ftf.traj.xs.lo
        fwd_us, fwd_us_lo = ftf.traj.us.hi, ftf.traj.us.lo
        fwd_step = ftf.step
    else:
        fwd = forward_pass(
            problem, xs, us, bres.k, bres.K, mults, mu, precise=precise
        )
        fwd_xs, fwd_us, fwd_step = fwd.xs, fwd.us, fwd.step
        fwd_xs_lo = jnp.zeros_like(fwd_xs)
        fwd_us_lo = jnp.zeros_like(fwd_us)
    fb_val, fb_jac, fb_origin = bres.k, bres.K, xs[:-1]
    if not reference_schedule:
        # the reference never swaps the pre-loop forward's trajectory in
        # (ddp.hpp:773 writes new_traj; the loop's update_derivatives reads
        # traj and iteration 0's forward overwrites new_traj) — keeping it
        # is our (documented) improvement; reference mode discards it
        xs, us = fwd_xs, fwd_us
        xs_lo, us_lo = fwd_xs_lo, fwd_us_lo

    class Carry(NamedTuple):
        it: jax.Array
        done: jax.Array
        xs: jax.Array
        us: jax.Array
        mults: al_mod.AffineMults
        m_lo_val: jax.Array  # [T, ne] double-float residue of mults.val
        m_lo_jac: jax.Array  # [T, ne, ndx] … of mults.jac (precise=True;
        # zeros otherwise — the two accumulating multiplier recurrences
        # (update_origin, p += μ·eq) carry their f32 round-off here)
        xs_lo: jax.Array  # [T+1, nx] TF residue of xs (precise="storage")
        us_lo: jax.Array  # [T, nu]  … of us
        m_lo_origin: jax.Array  # [T, nx] … of mults.origin
        fb_val: jax.Array
        fb_jac: jax.Array
        fb_origin: jax.Array
        mu: jax.Array
        reg: jax.Array
        w: jax.Array
        n: jax.Array
        opt_lag: jax.Array
        opt_constr: jax.Array
        step: jax.Array
        opt_obj_prev: jax.Array
        just_changed: jax.Array  # (p, μ) changed last iteration → give the
        # inner Newton solve at least one step before trusting a plateau
        inner: jax.Array  # inner iterations since the last (p, μ) change

    def cond(c: Carry):
        return jnp.logical_and(c.it < params.max_iterations, ~c.done)

    def body(c: Carry) -> tuple[Carry, SolveHistory]:
        # --- update_derivatives (ddp.hpp:641-696) ---
        derivs = problem.derivatives(c.xs, c.us)
        if storage:
            derivs, eq_lo, rows_lo = derivs_with_eq_tf(
                derivs, c.xs, c.xs_lo, c.us, c.us_lo
            )
        else:
            eq_lo = rows_lo = None
        if precise:
            from ddp_jax.ops.twofloat import TF as _TF

            xs_arg = _TF(c.xs, c.xs_lo) if storage else c.xs
            m_tf = precise_mod.update_origin_tf(
                model,
                precise_mod.MultsTF(
                    c.mults, c.m_lo_val, c.m_lo_jac, c.m_lo_origin
                ),
                xs_arg,
            )
            mults, m_lo_val, m_lo_jac, m_lo_origin = (
                m_tf.hi, m_tf.lo_val, m_tf.lo_jac, m_tf.lo_origin,
            )
        else:
            mults = al_mod.update_origin(model, c.mults, c.xs)
            m_lo_val, m_lo_jac = c.m_lo_val, c.m_lo_jac
            m_lo_origin = c.m_lo_origin
        mults = mults._replace(jac=constrain_jac(mults.jac))
        m_lo_jac = constrain_jac(m_lo_jac)
        fbm = al_mod.update_origin(
            model,
            al_mod.AffineMults(c.fb_val, c.fb_jac, c.fb_origin),
            c.xs,
        )

        lo_kw = dict(
            eq_lo=eq_lo, mult_val_lo=m_lo_val, mult_jac_lo=m_lo_jac,
            rows_lo=rows_lo,
        ) if storage else {}
        opt_obj = opt_obj_fn(problem, derivs, mults.val, mults.jac, c.mu, **lo_kw)
        opt_constr = al_mod.optimality_constr(derivs)
        # Stopping uses the μ-free Lagrangian stationarity measure
        # (optimality_lag, ddp.hpp:525-573): the reference's opt_obj carries
        # μ·eqᵀeq_u terms whose float floor is μ·eps — unusable as a
        # convergence test once μ has escalated past 1/eps.
        opt_lag = opt_lag_fn(problem, derivs, mults.val, mults.jac, **lo_kw)

        if reference_schedule:
            # reference stopping rule (ddp.hpp:673-675) and raw gate
            # (ddp.hpp:677): no dtype floor, no plateau, no inner cap
            done = jnp.logical_and(opt_obj < threshold, opt_constr < threshold)
            gate = opt_obj < c.w
        else:
            done = jnp.logical_and(opt_lag < threshold, opt_constr < threshold)
            # inner-convergence gate: the reference's opt_obj < w, with a
            # dtype floor and plateau detection (see SolverParams docstring)
            plateau = jnp.logical_and(
                opt_obj >= 0.1 * c.opt_obj_prev, ~c.just_changed
            )
            gate = jnp.logical_or(opt_obj < jnp.maximum(c.w, w_min), plateau)
            if params.inner_iters_max is not None:
                gate = jnp.logical_or(gate, c.inner >= params.inner_iters_max)
        upd_success = jnp.logical_and(~done, jnp.logical_and(gate, opt_constr < c.n))
        upd_failure = jnp.logical_and(~done, jnp.logical_and(gate, opt_constr >= c.n))

        # first-order AL multiplier update (ddp.hpp:680-688):
        #   p   += μ (eq + eq_u·k);  p_x += μ (eq_x + eq_u·K)
        # PRIMAL uses zero multiplier feedback (no_multiplier_feedback_t /
        # zero_t, ddp.hpp:365-371): p += μ·eq only.
        gain = jnp.where(upd_success, c.mu, jnp.zeros_like(c.mu))
        fb_term = (
            jnp.zeros_like(derivs.eq)
            if method is Method.PRIMAL
            else jnp.einsum("tou,tu->to", derivs.equ, fbm.val)
        )
        fb_term_jac = (
            jnp.zeros_like(derivs.eqx)
            if method is Method.PRIMAL
            else jnp.einsum("tou,tuj->toj", derivs.equ, fbm.jac)
        )
        if precise:
            if storage:
                from ddp_jax.ops import twofloat as _tf

                val_inc = _tf.add(_tf.TF(derivs.eq, eq_lo), _tf.from_float(fb_term))
            else:
                val_inc = derivs.eq + fb_term
            m_tf = precise_mod.mult_update_tf(
                precise_mod.MultsTF(mults, m_lo_val, m_lo_jac, m_lo_origin),
                gain,
                val_inc,
                derivs.eqx + fb_term_jac,
            )
            mults, m_lo_val, m_lo_jac = m_tf.hi, m_tf.lo_val, m_tf.lo_jac
            mults = mults._replace(jac=constrain_jac(mults.jac))
            m_lo_jac = constrain_jac(m_lo_jac)
        else:
            new_val = mults.val + gain * (derivs.eq + fb_term)
            new_jac = mults.jac + gain * (derivs.eqx + fb_term_jac)
            if params.mult_max is not None:
                # safeguarded multipliers (see SolverParams.mult_max)
                new_val = jnp.clip(new_val, -params.mult_max, params.mult_max)
                new_jac = jnp.clip(new_jac, -params.mult_max, params.mult_max)
            mults = mults._replace(val=new_val, jac=constrain_jac(new_jac))

        # Tolerance schedule.  The reference tightens n = opt_obj/μ^0.1 and
        # w /= μ (ddp.hpp:795-797) — but opt_obj is μ-scaled, so under finite
        # precision that rule lets updates fire unconditionally and the
        # multipliers pick up μ-amplified noise.  We use the classic
        # LANCELOT-style multiplicative tightening instead, floored at the
        # stopping threshold; behavior coincides with the reference when
        # precision is not the binding constraint.
        mu_new = jnp.where(upd_failure, c.mu * params.mu_factor, c.mu)
        if params.mu_max is not None:
            mu_new = jnp.minimum(mu_new, jnp.asarray(params.mu_max, dtype))
        if reference_schedule:
            # exact ddp.hpp:787-797: on success n = opt_obj recomputed with
            # the *updated* multipliers / μ^0.1 and w /= μ; on failure only
            # μ·10 fires (n, w untouched)
            lo_kw2 = dict(
                eq_lo=eq_lo, mult_val_lo=m_lo_val, mult_jac_lo=m_lo_jac,
                rows_lo=rows_lo,
            ) if storage else {}
            opt_obj2 = opt_obj_fn(
                problem, derivs, mults.val, mults.jac, c.mu, **lo_kw2
            )
            n_new = jnp.where(upd_success, opt_obj2 / c.mu**0.1, c.n)
            w_new = jnp.where(upd_success, c.w / c.mu, c.w)
        else:
            n_new = jnp.where(
                upd_success,
                jnp.maximum(c.n * c.mu**-0.9, threshold),
                jnp.where(upd_failure, mu_new**-0.1, c.n),
            )
            w_new = jnp.where(upd_success, c.w / c.mu, c.w)

        # --- backward / forward (ddp.hpp:804-826) ---
        bres = bwd(
            derivs, mults.val, mults.jac, mu_new, c.reg,
            **(dict(
                eq_lo=eq_lo, mult_val_lo=m_lo_val, mult_jac_lo=m_lo_jac,
                rows_lo=rows_lo,
            ) if storage else {}),
        )
        if storage:
            from ddp_jax.ops.twofloat import TF as _TF

            ftf = precise_mod.forward_pass_storage_tf(
                problem,
                precise_mod.TrajTF(
                    _TF(c.xs, c.xs_lo), _TF(c.us, c.us_lo)
                ),
                bres.k, bres.K,
                precise_mod.MultsTF(mults, m_lo_val, m_lo_jac, m_lo_origin),
                bres.mu,
            )
            fwd_xs, fwd_xs_lo = ftf.traj.xs.hi, ftf.traj.xs.lo
            fwd_us, fwd_us_lo = ftf.traj.us.hi, ftf.traj.us.lo
            fwd_step = ftf.step
        else:
            fwd = forward_pass(
                problem, c.xs, c.us, bres.k, bres.K, mults, bres.mu,
                precise=precise,
            )
            fwd_xs, fwd_us, fwd_step = fwd.xs, fwd.us, fwd.step
            fwd_xs_lo, fwd_us_lo = c.xs_lo, c.us_lo
        reg = jnp.where(
            fwd_step >= 0.5,
            jnp.where(bres.reg / 2 < 1e-5, jnp.zeros_like(bres.reg), bres.reg / 2),
            bres.reg,
        )

        keep = lambda old, new: jnp.where(done, old, new)
        rec = SolveHistory(
            mu=keep(c.mu, bres.mu),
            reg=keep(c.reg, reg),
            w=keep(c.w, w_new),
            n=keep(c.n, n_new),
            step=keep(c.step, fwd_step),
            opt_obj=opt_obj,
            opt_lag=opt_lag,
            opt_constr=opt_constr,
            upd_success=upd_success,
            upd_failure=upd_failure,
            done=done,
        )
        new_c = Carry(
            it=jnp.where(c.done, c.it, c.it + 1),
            done=done,
            xs=keep(c.xs, fwd_xs),
            us=keep(c.us, fwd_us),
            mults=jax.tree.map(keep, c.mults, mults),
            m_lo_val=keep(c.m_lo_val, m_lo_val),
            m_lo_jac=keep(c.m_lo_jac, m_lo_jac),
            xs_lo=keep(c.xs_lo, fwd_xs_lo),
            us_lo=keep(c.us_lo, fwd_us_lo),
            m_lo_origin=keep(c.m_lo_origin, m_lo_origin),
            fb_val=keep(c.fb_val, bres.k),
            fb_jac=keep(c.fb_jac, bres.K),
            fb_origin=keep(c.fb_origin, c.xs[:-1]),
            mu=keep(c.mu, bres.mu),
            reg=keep(c.reg, reg),
            w=keep(c.w, w_new),
            n=keep(c.n, n_new),
            opt_lag=opt_lag,
            opt_constr=opt_constr,
            step=keep(c.step, fwd_step),
            opt_obj_prev=opt_obj,
            just_changed=jnp.logical_or(upd_success, upd_failure),
            inner=jnp.where(
                jnp.logical_or(upd_success, upd_failure),
                jnp.ones_like(c.inner),
                c.inner + 1,
            ),
        )
        return new_c, rec

    init = Carry(
        it=jnp.asarray(0),
        done=jnp.asarray(False),
        xs=xs,
        us=us,
        mults=mults,
        m_lo_val=jnp.zeros_like(mults.val),
        m_lo_jac=jnp.zeros_like(mults.jac),
        xs_lo=xs_lo,
        us_lo=us_lo,
        m_lo_origin=jnp.zeros_like(mults.origin),
        fb_val=fb_val,
        fb_jac=fb_jac,
        fb_origin=fb_origin,
        mu=mu,
        reg=reg,
        w=w,
        n=n,
        opt_lag=jnp.asarray(jnp.inf, dtype),
        opt_constr=jnp.asarray(jnp.inf, dtype),
        step=fwd_step,
        opt_obj_prev=jnp.asarray(jnp.inf, dtype),
        just_changed=jnp.asarray(True),
        inner=jnp.asarray(1, jnp.int32),  # the pre-loop bwd/fwd already ran
    )
    if history:
        final, hist = jax.lax.scan(
            lambda c, _: body(c), init, None, length=params.max_iterations
        )
    else:
        final = jax.lax.while_loop(cond, lambda c: body(c)[0], init)
        hist = None

    return SolveResult(
        xs=final.xs,
        us=final.us,
        fb_k=final.fb_val,
        fb_K=final.fb_jac,
        mults=final.mults,
        stats=SolveStats(
            iterations=final.it,
            opt_lag=final.opt_lag,
            opt_obj=final.opt_obj_prev,
            opt_constr=final.opt_constr,
            mu=final.mu,
            reg=final.reg,
            step=final.step,
            converged=final.done,
        ),
        history=hist,
    )
