"""Throughput-mode batched solver: static control flow end-to-end.

``solve()`` (solver/solve.py) mirrors the reference's data-dependent outer
loop (early exit, Cholesky-retry restarts, serial step-halving).  Those
while_loops are correct but hostile to the compiler and to batched
throughput: under vmap every sample pays for the slowest sample's loop, and
deeply nested dynamic control flow compiles poorly.

This module is the production throughput path (BASELINE.json configs[1]:
"batched pendulum iLQR: 4096 initial states per chip, shared cost,
line-search sweep"):

- outer loop: ``lax.scan`` over a **fixed** iteration count
- line search: **parallel sweep** over step candidates (1, ½, ¼, …) — one
  batched rollout per candidate, accept the largest step with Δcost ≤ 0
  (same acceptance rule as the reference's serial halving, ddp_fwd.ipp:53-63,
  evaluated in parallel); samples with no accepted candidate keep their
  trajectory
- Cholesky failure: per-sample reg escalation for the *next* iteration
  (≙ ddp_bwd.ipp:105-110's bump-and-restart, amortized across iterations
  instead of restarting a sweep)
- AL schedule: same gating as solve() but expressed as masked elementwise
  updates — every sample carries its own (μ, n, w) state.

Everything vmaps: the public entry takes a batch of initial states and
returns stacked results.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ddp_jax.solver import al as al_mod
from ddp_jax.solver.riccati import factor_solve
from ddp_jax.solver.rollout import feedback_rollout
from ddp_jax.solver.solve import Method, SolverParams


class BatchSolveHistory(NamedTuple):
    """Per-iteration solver state for the whole batch, [I, B] each — the
    production-path analog of solve(history=True)'s SolveHistory (≙ the
    reference's per-iteration stdout block, ddp.hpp:807-838).  Recorded by
    solve_batched(..., history=True); the pre-loop backward/forward pair is
    not an outer iteration and is not recorded, matching the reference."""

    mu: jax.Array
    reg: jax.Array
    step: jax.Array
    opt_obj: jax.Array
    opt_lag: jax.Array
    opt_constr: jax.Array
    upd_success: jax.Array
    upd_failure: jax.Array


class BatchSolveResult(NamedTuple):
    xs: jax.Array  # [B, T+1, nx]
    us: jax.Array  # [B, T, nu]
    fb_k: jax.Array  # [B, T, nu]
    fb_K: jax.Array  # [B, T, nu, ndx]
    opt_constr: jax.Array  # [B]
    opt_lag: jax.Array  # [B]
    mu: jax.Array  # [B]
    mults: al_mod.AffineMults | None = None  # [B, T, ...], re-anchored at xs
    reg: jax.Array | None = None  # [B]
    w: jax.Array | None = None  # [B] inner-convergence gate tolerance
    n: jax.Array | None = None  # [B] constraint-progress gate tolerance
    history: BatchSolveHistory | None = None  # history=True only


def _backward_multi_reg(
    derivs, mult_val, mult_jac, mu, reg, n_levels=4, unroll=1, sweep_fn=None
):
    """Static-control-flow analog of the reference's Cholesky-retry loop
    (ddp_bwd.ipp:26, 105-132): run the sweep at several regularization levels
    in parallel — [reg, 2·max(reg,μ), 32·max(reg,μ), …] — and keep the
    smallest level that factorizes everywhere.  Returns (k, K, ok, reg_used).

    ``sweep_fn(derivs, mult_val, mult_jac, mu, reg) -> (k, K, ok)`` swaps the
    sweep implementation (e.g. the double-float precise.backward_sweep_tf).
    """
    base = jnp.maximum(reg, mu) * 2.0
    dtype = derivs.lx.dtype
    scales = 16.0 ** jnp.arange(n_levels - 1, dtype=dtype)
    levels = jnp.concatenate([reg[None], base * scales])
    if sweep_fn is None:
        sweep_fn = lambda d, v, j, m, r: _backward_sweep(d, v, j, m, r, unroll=unroll)
    ks, Ks, oks = jax.vmap(
        lambda r: sweep_fn(derivs, mult_val, mult_jac, mu, r)
    )(levels)
    idx = jnp.argmax(oks)  # first (smallest-reg) successful level
    any_ok = jnp.any(oks)
    return ks[idx], Ks[idx], any_ok, levels[idx]


def _backward_sweep(derivs, mult_val, mult_jac, mu, reg, unroll=1):
    """One Riccati sweep (no retry loop): returns (k, K, ok).

    Matmuls are pinned to HIGHEST precision: at these dims the cost is
    negligible, and a reduced-precision float32 product (TF32 on the GPU
    keeps ~3 decimal digits) injects relative noise into the gains that
    compounds through the T-step recursion (docs/DESIGN.md "Reduced-precision
    matmul passes and the AL gate"), making the XLA backend disagree with
    the (exact-f32) Pallas kernel."""
    nu = derivs.lu.shape[1]
    dtype = derivs.lx.dtype
    I_u = jnp.eye(nu, dtype=dtype)

    inputs = (
        derivs.lx, derivs.lu, derivs.lxx, derivs.lux, derivs.luu,
        derivs.fx, derivs.fu, derivs.fxx, derivs.fux, derivs.fuu,
        derivs.eq, derivs.eqx, derivs.equ, derivs.eqxx, derivs.equx, derivs.equu,
        mult_val, mult_jac,
    )  # fmt: skip

    def step(carry, inp):
        Vx, Vxx = carry
        (lx, lu, lxx, lux, luu, fx, fu, fxx, fux, fuu,
         eqv, eqx, equ, eqxx, equx, equu, pe, pex) = inp  # fmt: skip
        tmp = pe + mu * eqv
        tmp2 = pex + mu * eqx
        Qx = lx + fx.T @ Vx + eqx.T @ tmp + pex.T @ eqv
        Qu = lu + fu.T @ Vx + equ.T @ tmp
        Qxx = (
            lxx + fx.T @ Vxx @ fx + eqx.T @ tmp2 + pex.T @ eqx
            + jnp.einsum("o,oij->ij", tmp, eqxx)
            + jnp.einsum("o,oij->ij", Vx, fxx)
        )  # fmt: skip
        Quu = (
            luu + fu.T @ Vxx @ fu + mu * equ.T @ equ
            + jnp.einsum("o,oij->ij", tmp, equu)
            + jnp.einsum("o,oij->ij", Vx, fuu)
        )  # fmt: skip
        Qux = (
            lux + fu.T @ Vxx @ fx + equ.T @ tmp2
            + jnp.einsum("o,oij->ij", tmp, equx)
            + jnp.einsum("o,oij->ij", Vx, fux)
        )  # fmt: skip
        ok_t, k, K = factor_solve(Quu + reg * I_u, Qu, Qux)
        Vx_new = Qx + Qux.T @ k
        Vxx_new = Qxx + Qux.T @ K
        return (Vx_new, Vxx_new), (k, K, ok_t)

    with jax.default_matmul_precision("highest"):
        _, (ks, Ks, oks) = jax.lax.scan(
            step, (derivs.lfx, derivs.lfxx), inputs, reverse=True, unroll=unroll
        )
    return ks, Ks, jnp.all(oks)


def _backward_pallas_levels(
    derivs, mult_val, mult_jac, mu, reg, n_levels=4, block_b=None, interpret=False,
    second_order=False,
):
    """Batch-level Pallas backward (kernels/riccati_small.py) with static
    multi-level regularization retry: the whole [B]-batch sweeps in one
    kernel launch per level (one sample per GPU thread), vs the XLA path's
    several small kernels per time step.  ``second_order`` adds the full-DDP
    rank-3 contraction terms.  Returns batch-major
    (k [B,T,m], K [B,T,m,n], ok [B], reg_used [B])."""
    from ddp_jax.kernels.riccati_small import backward_sweep_pallas, pack_batch_last

    B, T = derivs.lx.shape[0], derivs.lx.shape[1]
    n, m, e = derivs.lx.shape[-1], derivs.lu.shape[-1], derivs.eq.shape[-1]
    packed = pack_batch_last(derivs, mult_val, mult_jac, second_order=second_order)
    base = jnp.maximum(reg, mu) * 2.0
    k = K = None
    ok_acc = jnp.zeros((B,), bool)
    reg_used = reg
    lvl = reg
    for i in range(n_levels):
        k_i, K_i, ok_i = backward_sweep_pallas(
            packed, mu, lvl, T=T, n=n, m=m, e=e, block_b=block_b,
            interpret=interpret,
        )  # fmt: skip
        newly = jnp.logical_and(~ok_acc, ok_i)
        if k is None:
            k, K = k_i, K_i
        else:
            k = jnp.where(newly[None, None, :], k_i, k)
            K = jnp.where(newly[None, None, :], K_i, K)
        reg_used = jnp.where(newly, lvl, reg_used)
        ok_acc = jnp.logical_or(ok_acc, ok_i)
        lvl = base * (16.0**i)
    # kernel layout [T, m, B] / [T, m*n, B] → batch-major
    k_bt = jnp.transpose(k, (2, 0, 1))
    K_bt = jnp.transpose(K.reshape(T, m, n, B), (3, 0, 1, 2))
    return k_bt, K_bt, ok_acc, reg_used


def _linesearch_sweep(
    problem, xs, us, k, K, mults, mu, n_candidates, unroll=1, precise=False
):
    """Parallel line-search: rollout all candidate steps, pick the largest
    accepted one; keep the incumbent trajectory when none is accepted.
    ``precise`` evaluates the acceptance sums in double-float (the f32 floor
    of the μ‖eq‖² terms otherwise masks small true decreases)."""
    dtype = xs.dtype
    steps = 2.0 ** -jnp.arange(n_candidates, dtype=dtype)  # 1, ½, ¼, …
    if precise:
        from ddp_jax.ops import twofloat as tf
        from ddp_jax.solver.precise import al_cost_total_tf

        cost_old_tf = al_cost_total_tf(problem, xs, us, mults, mu)

        def rollout_at(step):
            xs_c, us_c = feedback_rollout(problem, xs, us, k, K, step, unroll=unroll)
            cost = al_cost_total_tf(problem, xs_c, us_c, mults, mu)
            return xs_c, us_c, tf.to_float(tf.sub(cost, cost_old_tf))

        cost_old = jnp.zeros((), dtype)
    else:
        cost_old = jnp.sum(al_mod.al_costs(problem, xs, us, mults, mu))

        def rollout_at(step):
            xs_c, us_c = feedback_rollout(problem, xs, us, k, K, step, unroll=unroll)
            cost = jnp.sum(al_mod.al_costs(problem, xs_c, us_c, mults, mu))
            return xs_c, us_c, cost

    xs_cand, us_cand, cost_cand = jax.vmap(rollout_at)(steps)
    accepted = cost_cand - cost_old <= 0
    # index of first (largest-step) accepted candidate; n_candidates if none
    idx = jnp.argmax(accepted)
    any_acc = jnp.any(accepted)
    xs_new = jnp.where(any_acc, xs_cand[idx], xs)
    us_new = jnp.where(any_acc, us_cand[idx], us)
    step_used = jnp.where(any_acc, steps[idx], jnp.zeros((), dtype))
    return xs_new, us_new, step_used


def _linesearch_seq(
    problem, xs, us, k, K, mults, mu, n_candidates, unroll=1, precise=False,
    dead=None,
):
    """Sequential early-exit line search: walk the step ladder 1, ½, ¼, …
    largest-first and STOP at the first accepted candidate.

    ``dead`` (scalar bool under the per-sample vmap) marks a lane that has
    given up (solve_batched's give_up_after): it enters the ladder already
    done, keeps its incumbent trajectory at step 0, and — crucially — stops
    driving the batched while_loop's trip count.  Without it, one μ-racing
    lane that rejects every candidate forces the WHOLE fleet through the
    full ladder every outer iteration (docs/DESIGN.md "The panda7 f32
    tail").

    Picks the identical candidate to `_linesearch_sweep` (first accepted =
    largest accepted), but evaluates rollouts lazily: near convergence the
    full step is accepted almost always, so the expected rollout count is
    ~1 instead of always n_candidates.  Under the solver's per-sample vmap
    the `lax.while_loop` runs until EVERY lane has accepted (done lanes are
    select-masked), so the batch pays max-first-accept-index rollouts per
    iteration — still ≤ the parallel sweep's fixed n_candidates, and far
    less whenever the batch's gains are accurate.

    Worth it exactly when one rollout is FLOP-heavy (arm-class dims, where
    the rollout evaluates RNEA+CRBA per step per candidate).  At pendulum
    dims the rollout is dispatch-bound and the parallel sweep's single wide
    launch wins — see
    docs/DESIGN.md "Kernel boundary".  ≙ the reference's serial step
    halving (ddp_fwd.ipp:34-63), which this reintroduces batched.
    """
    dtype = xs.dtype
    if precise:
        from ddp_jax.ops import twofloat as tf
        from ddp_jax.solver.precise import al_cost_total_tf

        cost_old_tf = al_cost_total_tf(problem, xs, us, mults, mu)

        def delta_at(step):
            xs_c, us_c = feedback_rollout(problem, xs, us, k, K, step, unroll=unroll)
            cost = al_cost_total_tf(problem, xs_c, us_c, mults, mu)
            return xs_c, us_c, tf.to_float(tf.sub(cost, cost_old_tf))
    else:
        cost_old = jnp.sum(al_mod.al_costs(problem, xs, us, mults, mu))

        def delta_at(step):
            xs_c, us_c = feedback_rollout(problem, xs, us, k, K, step, unroll=unroll)
            cost = jnp.sum(al_mod.al_costs(problem, xs_c, us_c, mults, mu))
            return xs_c, us_c, cost - cost_old

    def cond(carry):
        i, _, _, _, done = carry
        return jnp.logical_and(i < n_candidates, jnp.logical_not(done))

    def body(carry):
        i, xs_b, us_b, step_b, done = carry
        step = jnp.asarray(2.0, dtype) ** (-i.astype(dtype))
        xs_c, us_c, delta = delta_at(step)
        acc = delta <= 0
        xs_b = jnp.where(acc, xs_c, xs_b)
        us_b = jnp.where(acc, us_c, us_b)
        step_b = jnp.where(acc, step, step_b)
        return i + 1, xs_b, us_b, step_b, acc

    done0 = jnp.zeros((), bool) if dead is None else dead
    init = (jnp.zeros((), jnp.int32), xs, us, jnp.zeros((), dtype), done0)
    _, xs_new, us_new, step_used, _ = jax.lax.while_loop(cond, body, init)
    return xs_new, us_new, step_used


class _BatchCarry(NamedTuple):
    xs: jax.Array
    us: jax.Array
    mults: al_mod.AffineMults
    fb: al_mod.AffineMults
    mu: jax.Array
    reg: jax.Array
    w: jax.Array
    n: jax.Array
    oo_prev: jax.Array
    just_changed: jax.Array
    inner: jax.Array  # [B] inner iterations since the last (p, μ) change
    streak: jax.Array  # [B] consecutive outer iterations at step 0 (the
    # give_up_after counter; stays 0-reset when give-up is disabled)


def _bwhere(c, a, b):
    """jnp.where with the [B] condition broadcast against trailing dims."""
    return jnp.where(c.reshape(c.shape + (1,) * (a.ndim - 1)), a, b)


def solve_batched(
    problem,
    params: SolverParams,
    x0s: jax.Array,  # [B, nx]
    us_init: jax.Array | None = None,  # [B, T, nu]
    method: Method = Method.PRIMAL_DUAL_AFFINE,
    n_linesearch: int | None = None,  # default: 8 candidates (1 … 1/128)
    unroll: int = 1,
    backward: str = "sweep",
    # "sweep": per-sample multi-reg XLA scan (default, works for any problem)
    # "assoc": associative-scan Riccati (O(log T) depth; Gauss-Newton only —
    #   requires problem.second_order=False); reg folded into the stage cost
    # "pallas": Pallas (Triton route) kernel sweep, one sample per GPU
    #   thread; the whole batch runs one kernel launch per reg level instead
    #   of several small XLA kernels per time step.  Supports full
    #   second-order DDP (rank-3 contraction terms unrolled)
    # "tf": double-float sweep (solver/precise.py) — extended-precision
    #   gains on f32 inputs; the float analog of the reference's MPFR runs
    forward: str = "sweep",
    # "sweep": XLA scan rollout, candidates vmapped (works for any problem)
    # "seq": early-exit ladder — while_loop over candidates largest-first,
    #   stops when every lane has accepted; same accepted step as "sweep"
    #   but ~1 rollout/iter expected. Wins when one rollout is FLOP-heavy
    #   (arm dims); loses to the wide sweep at dispatch-bound pendulum dims
    block_b: int | None = None,  # Pallas kernel's batch block (power of two)
    interpret: bool = False,  # Pallas interpret mode (CPU tests)
    precise_cost: bool = False,  # double-float line-search acceptance sums
    n_reg_levels: int = 4,  # parallel regularization ladder depth (≥1)
    give_up_after: int | None = None,  # forward="seq" only: a lane that has
    # rejected the ENTIRE candidate ladder (step 0) for this many consecutive
    # outer iterations is declared dead — it stops line-searching (so it no
    # longer forces the fleet's early-exit while_loop to full ladder depth)
    # and its (p, μ, w, n) schedule freezes.  Dead lanes are the μ-racing
    # pathology (docs/DESIGN.md "The panda7 f32 tail"): they never recover
    # in-budget, and the production pattern re-solves them in a per-lane
    # rescue pass (benchmarks/_common.py::rescue).  None = never give up.
    mults_init: al_mod.AffineMults | None = None,  # [B, T, ...] warm-start
    # multipliers (e.g. the previous MPC replan's result.mults); re-anchored
    # to the warm-start rollout via update_origin before the first sweep
    mu_init: jax.Array | None = None,  # [B] warm-start penalty state
    reg_init: jax.Array | None = None,  # [B] warm-start regularization
    w_init: jax.Array | None = None,  # [B] warm-start gate tolerance w
    n_init: jax.Array | None = None,  # [B] warm-start gate tolerance n
    history: bool = False,  # record BatchSolveHistory ([I, B] per-iteration
    # μ/reg/step/optimality rows) into the result
    matmul_precision: str | None = None,
    # None → platform default (a float32 product may run in TF32 on the
    # GPU) | "high" | "highest" (true f32).  On arm-class models
    # reduced-precision passes in the DERIVATIVE/ROLLOUT stages open an
    # infeasibility tail at small iteration budgets (docs/DESIGN.md
    # "Reduced-precision matmul passes and the arm feasibility tail").  The
    # Riccati sweeps already pin HIGHEST internally; this knob widens the
    # envelope to every stage.
) -> BatchSolveResult:
    """Fixed-budget batched AL-DDP.  Runs exactly params.max_iterations outer
    iterations for every sample (converged samples no-op via the line-search
    keeping their trajectory).

    Batch-major throughout: every per-sample helper is vmapped, the outer
    scan carries [B]-leading state, and the backward pass can be a batch-level
    primitive (the Pallas kernel gives each sample its own GPU thread — it
    could not live inside a per-sample vmap).
    """
    if matmul_precision is not None:
        with jax.default_matmul_precision(matmul_precision):
            return solve_batched(
                problem, params, x0s, us_init=us_init, method=method,
                n_linesearch=n_linesearch, unroll=unroll, backward=backward,
                forward=forward, block_b=block_b,
                interpret=interpret, precise_cost=precise_cost,
                n_reg_levels=n_reg_levels, give_up_after=give_up_after,
                mults_init=mults_init,
                mu_init=mu_init, reg_init=reg_init, w_init=w_init,
                n_init=n_init, history=history,
            )  # fmt: skip
    T, nu = problem.horizon, problem.nu
    dtype = x0s.dtype
    model = problem.model
    B = x0s.shape[0]

    from ddp_jax.diagnostics.asserts import ddp_assert, val

    ddp_assert(
        val(x0s.ndim, "x0s.ndim") == 2,
        val(x0s.shape[-1], "x0s state dim") == problem.nx,
        val(params.max_iterations, "max_iterations") >= 1,
        msg="solve_batched() preconditions",
    )
    affine = method is Method.PRIMAL_DUAL_AFFINE
    eps = jnp.finfo(dtype).eps
    w_min = jnp.asarray(
        params.w_min if params.w_min is not None else 10.0 * eps**0.5, dtype
    )
    threshold = jnp.asarray(params.threshold, dtype)

    if backward not in ("sweep", "assoc", "pallas", "tf"):
        raise ValueError(f"unknown backward backend {backward!r}")
    if backward == "assoc" and problem.second_order:
        raise ValueError(
            "backward='assoc' is Gauss-Newton only; build the Problem "
            "with second_order=False"
        )
    if give_up_after is not None and forward != "seq":
        raise ValueError(
            "give_up_after only applies to forward='seq' (the early-exit "
            "ladder is what dead lanes would otherwise hold hostage)"
        )

    if us_init is None:
        us_init = jnp.zeros((B, T, nu), dtype=dtype)

    # vmapped per-sample helpers
    vrollout = jax.vmap(problem.rollout)
    vderivs = jax.vmap(problem.derivatives)
    vinit_mults = jax.vmap(lambda xs_: al_mod.init_multipliers(problem, xs_))
    vupdate_origin = jax.vmap(lambda m_, xs_: al_mod.update_origin(model, m_, xs_))
    if forward in ("sweep", "seq"):
        if n_linesearch is None:
            n_linesearch = 8
        if forward == "seq":
            vls = jax.vmap(
                lambda xs_, us_, k_, K_, mults_, mu_, dead_: _linesearch_seq(
                    problem, xs_, us_, k_, K_, mults_, mu_, n_linesearch,
                    unroll=unroll, precise=precise_cost, dead=dead_,
                )
            )
        else:
            # dead_ unused: the parallel sweep pays its fixed width anyway
            vls = jax.vmap(
                lambda xs_, us_, k_, K_, mults_, mu_, dead_: _linesearch_sweep(
                    problem, xs_, us_, k_, K_, mults_, mu_, n_linesearch,
                    unroll=unroll, precise=precise_cost,
                )
            )
    else:
        raise ValueError(f"unknown forward backend {forward!r}")
    v_oo = jax.vmap(
        lambda d, mv, mj, mu_: al_mod.optimality_obj(problem, d, mv, mj, mu_)
    )
    v_oc = jax.vmap(al_mod.optimality_constr)
    v_olag = jax.vmap(lambda d, mv, mj: al_mod.optimality_lag(problem, d, mv, mj))

    def constrain_jac(jac):
        return jac if affine else jnp.zeros_like(jac)

    def run_backward(derivs, mv, mj, mu_, reg_):
        if backward == "assoc":
            from ddp_jax.solver.parallel_riccati import backward_pass_assoc

            k_, K_, ok_ = jax.vmap(backward_pass_assoc)(derivs, mv, mj, mu_, reg_)
            return k_, K_, ok_, reg_
        if backward == "pallas":
            return _backward_pallas_levels(
                derivs, mv, mj, mu_, reg_, n_levels=n_reg_levels,
                block_b=block_b, interpret=interpret,
                second_order=problem.second_order,
            )
        if backward == "tf":
            from ddp_jax.solver.precise import backward_sweep_tf

            return jax.vmap(
                lambda d, v_, j_, m_, r_: _backward_multi_reg(
                    d, v_, j_, m_, r_, n_levels=n_reg_levels,
                    sweep_fn=backward_sweep_tf,
                )
            )(derivs, mv, mj, mu_, reg_)
        return jax.vmap(
            lambda d, v_, j_, m_, r_: _backward_multi_reg(
                d, v_, j_, m_, r_, n_levels=n_reg_levels, unroll=unroll
            )
        )(derivs, mv, mj, mu_, reg_)

    # --- pre-loop backward/forward (≙ solve(): ddp.hpp:768-773) ---
    xs = vrollout(x0s, us_init)
    us = us_init
    if mults_init is None:
        mults = vinit_mults(xs)
    else:
        # warm start (≙ the multiplier state the reference's solve carries
        # across AL iterations, ddp.hpp:677-695, extended across replans):
        # re-express the affine functions about the new rollout
        mults = vupdate_origin(mults_init, xs)
        mults = mults._replace(jac=constrain_jac(mults.jac))
    mu = (
        jnp.full((B,), params.mu, dtype)
        if mu_init is None
        else jnp.broadcast_to(jnp.asarray(mu_init, dtype), (B,))
    )
    reg = (
        jnp.full((B,), params.reg, dtype)
        if reg_init is None
        else jnp.broadcast_to(jnp.asarray(reg_init, dtype), (B,))
    )
    if w_init is not None:
        w = jnp.broadcast_to(jnp.asarray(w_init, dtype), (B,))
    else:
        w = jnp.full(
            (B,), params.w if params.w is not None else 1.0 / params.mu, dtype
        )
    if n_init is not None:
        n = jnp.broadcast_to(jnp.asarray(n_init, dtype), (B,))
    else:
        n = jnp.full(
            (B,), params.n if params.n is not None else 1.0 / params.mu**0.1, dtype
        )

    derivs = vderivs(xs, us)
    k, K, ok, reg_u = run_backward(derivs, mults.val, mults.jac, mu, reg)
    xs1, us1, step = vls(xs, us, k, K, mults, mu, jnp.zeros((B,), bool))
    # guard: failed cholesky poisons the candidate rollouts
    ok = jnp.logical_and(ok, jnp.isfinite(jnp.sum(us1, axis=(1, 2))))
    xs = _bwhere(ok, xs1, xs)
    us = _bwhere(ok, us1, us)
    # NaN gains from a failed factorization must never enter the carry:
    # 0·NaN = NaN would poison later masked updates
    fb = al_mod.AffineMults(
        _bwhere(ok, k, jnp.zeros_like(k)),
        _bwhere(ok, K, jnp.zeros_like(K)),
        xs[:, :-1],
    )
    # carry the reg level that actually factorized; escalate further only
    # if every level failed (μ is left alone — see note in iteration())
    reg = jnp.where(ok, reg_u, jnp.maximum(reg, mu) * 2.0)

    # give-up threshold: with give_up_after unset, use a count the streak
    # can never reach so `dead` stays all-False and fuses away
    _gu = (
        give_up_after
        if give_up_after is not None
        else params.max_iterations + 2
    )

    def iteration(c: _BatchCarry, _):
        dead = c.streak >= _gu
        derivs = vderivs(c.xs, c.us)
        mults = vupdate_origin(c.mults, c.xs)
        mults = mults._replace(jac=constrain_jac(mults.jac))
        fbm = vupdate_origin(c.fb, c.xs)

        oo = v_oo(derivs, mults.val, mults.jac, c.mu)
        oc = v_oc(derivs)
        olag = v_olag(derivs, mults.val, mults.jac)
        done = jnp.logical_and(olag < threshold, oc < threshold)
        # a dead lane's schedule freezes: no multiplier updates, no further
        # μ escalation (it is already racing), no gate-tolerance motion
        done = jnp.logical_or(done, dead)

        plateau = jnp.logical_and(oo >= 0.1 * c.oo_prev, ~c.just_changed)
        gate = jnp.logical_or(oo < jnp.maximum(c.w, w_min), plateau)
        if params.inner_iters_max is not None:
            # bounded inner loop: force the gate open after K inner Newton
            # iterations (accurate gains otherwise defer updates — see
            # docs/DESIGN.md "Reduced-precision matmul passes and the AL gate")
            gate = jnp.logical_or(gate, c.inner >= params.inner_iters_max)
        upd_s = jnp.logical_and(~done, jnp.logical_and(gate, oc < c.n))
        upd_f = jnp.logical_and(~done, jnp.logical_and(gate, oc >= c.n))

        # where-select (not gain·delta): a NaN delta under a closed gate
        # must not leak into the multipliers.  PRIMAL drops the feedback
        # correction: p += μ·eq (zero multiplier feedback, ddp.hpp:365-371).
        fb_term = (
            jnp.zeros_like(derivs.eq)
            if method is Method.PRIMAL
            else jnp.einsum("btou,btu->bto", derivs.equ, fbm.val)
        )
        fb_term_jac = (
            jnp.zeros_like(derivs.eqx)
            if method is Method.PRIMAL
            else jnp.einsum("btou,btuj->btoj", derivs.equ, fbm.jac)
        )
        val_upd = mults.val + c.mu[:, None, None] * (derivs.eq + fb_term)
        jac_upd = mults.jac + c.mu[:, None, None, None] * (derivs.eqx + fb_term_jac)
        if params.mult_max is not None:
            # safeguarded multipliers (see SolverParams.mult_max)
            val_upd = jnp.clip(val_upd, -params.mult_max, params.mult_max)
            jac_upd = jnp.clip(jac_upd, -params.mult_max, params.mult_max)
        mults = mults._replace(
            val=_bwhere(upd_s, val_upd, mults.val),
            jac=constrain_jac(_bwhere(upd_s, jac_upd, mults.jac)),
        )
        mu_new = jnp.where(upd_f, c.mu * params.mu_factor, c.mu)
        if params.mu_max is not None:
            mu_new = jnp.minimum(mu_new, jnp.asarray(params.mu_max, dtype))
        n_new = jnp.where(
            upd_s,
            jnp.maximum(c.n * c.mu**-0.9, threshold),
            jnp.where(upd_f, mu_new**-0.1, c.n),
        )
        w_new = jnp.where(upd_s, c.w / c.mu, c.w)

        k, K, ok, reg_u = run_backward(derivs, mults.val, mults.jac, mu_new, c.reg)
        xs1, us1, step = vls(c.xs, c.us, k, K, mults, mu_new, dead)
        ok = jnp.logical_and(ok, jnp.isfinite(jnp.sum(us1, axis=(1, 2))))
        # carry the reg level that factorized; relax on a full accepted
        # step (ddp.hpp:819-824); escalate only if all levels failed.
        # Unlike the reference's in-sweep retry we never escalate μ here:
        # compounding μ·2 across outer iterations blows μ past the
        # float64-useful range.
        reg_new = jnp.where(
            ok,
            jnp.where(
                step >= 0.5,
                jnp.where(reg_u / 2 < 1e-5, jnp.zeros_like(reg_u), reg_u / 2),
                reg_u,
            ),
            jnp.maximum(c.reg, mu_new) * 2.0,
        )
        # dead lanes stop escalating reg too (×2 per iteration overflows f32)
        reg_new = jnp.where(dead, c.reg, reg_new)
        streak_new = jnp.where(
            jnp.logical_and(ok, step > 0),
            jnp.zeros_like(c.streak),
            c.streak + 1,
        )
        fb_new = al_mod.AffineMults(
            _bwhere(ok, k, c.fb.val),
            _bwhere(ok, K, c.fb.jac),
            _bwhere(ok, c.xs[:, :-1], c.fb.origin),
        )
        rec = (
            BatchSolveHistory(
                mu=mu_new, reg=reg_new, step=step, opt_obj=oo, opt_lag=olag,
                opt_constr=oc, upd_success=upd_s, upd_failure=upd_f,
            )  # fmt: skip
            if history
            else None
        )
        return (
            _BatchCarry(
                xs=_bwhere(ok, xs1, c.xs),
                us=_bwhere(ok, us1, c.us),
                mults=mults,
                fb=fb_new,
                mu=mu_new,
                reg=reg_new,
                w=w_new,
                n=n_new,
                oo_prev=oo,
                just_changed=jnp.logical_or(upd_s, upd_f),
                inner=jnp.where(
                    jnp.logical_or(upd_s, upd_f),
                    jnp.ones_like(c.inner),
                    c.inner + 1,
                ),
                streak=streak_new,
            ),
            rec,
        )

    init = _BatchCarry(
        xs=xs,
        us=us,
        mults=mults,
        fb=fb,
        mu=mu,
        reg=reg,
        w=w,
        n=n,
        oo_prev=jnp.full((B,), jnp.inf, dtype),
        just_changed=jnp.ones((B,), bool),
        inner=jnp.ones((B,), jnp.int32),  # the pre-loop bwd/fwd already ran
        streak=jnp.where(
            jnp.logical_and(ok, step > 0),
            jnp.zeros((B,), jnp.int32),
            jnp.ones((B,), jnp.int32),
        ),
    )
    final, hist = jax.lax.scan(
        iteration,
        init,
        None,
        length=params.max_iterations,
        unroll=min(unroll, params.max_iterations),
    )

    derivs = vderivs(final.xs, final.us)
    mults = vupdate_origin(final.mults, final.xs)
    oc = v_oc(derivs)
    olag = v_olag(derivs, mults.val, mults.jac)
    return BatchSolveResult(
        xs=final.xs,
        us=final.us,
        fb_k=final.fb.val,
        fb_K=final.fb.jac,
        opt_constr=oc,
        opt_lag=olag,
        mu=final.mu,
        mults=mults,
        reg=final.reg,
        w=final.w,
        n=final.n,
        history=hist,
    )
