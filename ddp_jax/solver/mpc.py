"""Receding-horizon MPC driver with warm starts.

The reference has no MPC loop (its drivers solve once and print); BASELINE
configs[5] requires "multi-host receding-horizon MPC … 10 ms replan budget".
The discipline for that budget: compile once, execute many — a single jitted
``step`` advances the warm start, re-solves with a fixed (small) iteration
budget, and returns the first control + feedback gains.  No host round-trips
inside the loop; the whole step vmaps over scenario batches and shards over
a mesh (see parallel/mesh.py).

Warm starts carry the FULL solver state between replans, not just controls:
multiplier state is the thing the reference's solve() threads across AL
iterations (ddp.hpp:677-695) — an MPC loop that re-inits multipliers to
zero re-pays the AL feasibility ramp inside every replan's small iteration
budget.  ``MPCCarry`` therefore holds (us_warm, mults, μ, reg, w, n); the
next replan re-anchors the affine multipliers to its warm-start rollout via
``update_origin`` and resumes the penalty *and gate-tolerance* schedule
where it left off.

Multiplier time-shifting: the constraint schedule is *horizon-relative*
(``active_ts`` are slot indices — a terminal constraint lives at slot H-k
in every replan), so by default the slot-t multiplier warm-starts slot t of
the next replan unshifted.  ``shift_mults=True`` shifts the sequence one
step with the controls instead — the right choice for *time-indexed* path
constraints that slide through the horizon window.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ddp_jax.solver import al as al_mod
from ddp_jax.solver.batched import solve_batched
from ddp_jax.solver.solve import Method, SolverParams


class MPCCarry(NamedTuple):
    """Warm-start state carried between replans (persist with
    utils/checkpoint.py to resume a restarted controller host)."""

    us_warm: jax.Array  # [T, nu]
    mults: al_mod.AffineMults  # [T, ne] / [T, ne, ndx] / [T, nx]
    mu: jax.Array  # [] penalty where the last replan ended
    reg: jax.Array  # [] regularization likewise
    # inner-convergence gate tolerances (w, n) — the remaining pieces of the
    # reference's schedule state (ddp.hpp:795-797).  Zero ⇒ cold (the step
    # re-derives the params defaults), so checkpoints of older carries
    # resume correctly.  Irrelevant at inner_iters_max=1 (the gate is
    # forced open); carried for larger budgets so the w-gate does not
    # reset every replan.
    w: jax.Array | None = None  # []
    n: jax.Array | None = None  # []


class MPCStep(NamedTuple):
    u0: jax.Array  # [nu]      control to apply now
    k0: jax.Array  # [nu]      feedforward at t=0
    K0: jax.Array  # [nu, ndx] feedback gain at t=0 (for inter-replan control)
    carry: MPCCarry
    opt_constr: jax.Array


def init_carry(problem, dtype=None, x0: jax.Array | None = None) -> MPCCarry:
    """Cold-start carry: zero controls/multipliers, μ/reg = 0 (the step
    floors them at params.mu/params.reg).  ``x0`` anchors the multiplier
    origins at a *valid* state — required for quaternion-manifold models,
    where an all-zero origin is not a point on the manifold."""
    dtype = dtype or jnp.float32
    T, ne, ndx, nx = problem.horizon, problem.ne, problem.ndx, problem.nx
    if x0 is None:
        from ddp_jax.models import base

        model = problem.model
        x0 = base.state_pack(
            jnp.asarray(model.neutral_configuration(), dtype),
            jnp.zeros((model.nv,), dtype),
        )
    origin = jnp.broadcast_to(jnp.asarray(x0, dtype), (T, nx))
    return MPCCarry(
        us_warm=jnp.zeros((T, problem.nu), dtype=dtype),
        mults=al_mod.AffineMults(
            val=jnp.zeros((T, ne), dtype=dtype),
            jac=jnp.zeros((T, ne, ndx), dtype=dtype),
            origin=origin,
        ),
        mu=jnp.zeros((), dtype),
        reg=jnp.zeros((), dtype),
        w=jnp.zeros((), dtype),
        n=jnp.zeros((), dtype),
    )


def _shift_mults(mults: al_mod.AffineMults) -> al_mod.AffineMults:
    """Shift the multiplier sequence one step with the controls (for
    time-indexed path constraints), repeating the tail slot."""
    sh = lambda a: jnp.concatenate([a[1:], a[-1:]], axis=0)
    return al_mod.AffineMults(sh(mults.val), sh(mults.jac), sh(mults.origin))


def _advance_carry(
    res,
    params,
    warm_mults: bool,
    shift_mults: bool,
    mu_carry_max: float,
    mu_decay: float,
):
    """Build the next MPCCarry from a B=1 BatchSolveResult.

    The carried penalty is *decayed* (μ/mu_decay, floored at params.mu):
    with warm multipliers doing the feasibility work, re-entering at the
    escalated μ is counterproductive — measured on the pendulum StateTarget
    loop (3-iter budget, 40 replans), holding μ pumps the multiplier update
    p += μ·eq into divergence (tail ‖eq‖ 0.10 → 0.55 and climbing) while
    decay settles at 0.05-0.07; resetting μ outright loses the escalation
    signal entirely and the loop diverges."""
    us = res.us[0]
    us_warm = jnp.concatenate([us[1:], us[-1:]], axis=0)
    mults = jax.tree.map(lambda a: a[0], res.mults)
    if shift_mults:
        mults = _shift_mults(mults)
    if not warm_mults:
        mults = mults._replace(
            val=jnp.zeros_like(mults.val), jac=jnp.zeros_like(mults.jac)
        )
    mu_next = jnp.clip(
        res.mu[0] / mu_decay,
        jnp.asarray(params.mu, res.mu.dtype),
        jnp.asarray(mu_carry_max, res.mu.dtype),
    )
    # clamp w at the dtype's smallest normal: w /= μ compounds across
    # replans and an f32 underflow to 0 would read as a cold carry; any
    # w below the solver's w_min floor gates identically anyway
    tiny = jnp.finfo(res.w.dtype).tiny
    return MPCCarry(
        us_warm=us_warm, mults=mults, mu=mu_next, reg=res.reg[0],
        w=jnp.maximum(res.w[0], tiny), n=res.n[0],
    )


def make_mpc_step(
    problem,
    params: SolverParams,
    method=Method.PRIMAL_DUAL_AFFINE,
    unroll: int = 4,
    backward: str = "sweep",
    forward: str = "sweep",
    n_linesearch: int | None = None,
    matmul_precision: str | None = None,
    warm_mults: bool = True,
    shift_mults: bool = False,
    mu_carry_max: float | None = None,
    mu_decay: float = 10.0,
):
    """Build the jitted replan function: (x_measured, carry) → MPCStep.

    Uses the static-control-flow batched solver internals on a single
    sample so the compiled program has a deterministic 10 ms-class runtime
    (no data-dependent loops).  ``forward="seq"`` relaxes that determinism
    one notch: the early-exit ladder bounds runtime above by the full-sweep
    cost but finishes after ~1 rollout when the warm start accepts step 1 —
    the common case after the first replan — so p50 drops while the worst
    case stays the budgeted sweep.

    ``warm_mults=False`` reverts to controls-only warm starts (the round-2
    behavior); ``mu_carry_max`` caps the carried penalty so a persistently
    infeasible plant cannot escalate μ without bound across replans —
    unbounded μ carry drags the multipliers with it (|p| ≈ μ·‖eq‖) until
    the Riccati conditioning collapses.  Default: 100·params.mu (measured
    stable on the pendulum StateTarget loop where 1e8·params.mu diverges).
    """
    if mu_carry_max is None:
        mu_carry_max = 100.0 * params.mu
    w_def = params.w if params.w is not None else 1.0 / params.mu
    n_def = params.n if params.n is not None else params.mu**-0.1

    def _wn_warm(carry):
        """(w, n) warm state; zeros (cold carry / old checkpoint) → defaults."""
        if carry.w is None or carry.n is None:
            return None, None
        w = jnp.where(carry.w > 0, carry.w, jnp.asarray(w_def, carry.w.dtype))
        n = jnp.where(carry.n > 0, carry.n, jnp.asarray(n_def, carry.n.dtype))
        return w, n

    def step(x_measured: jax.Array, carry: MPCCarry) -> MPCStep:
        w_warm, n_warm = _wn_warm(carry)
        res = solve_batched(
            problem,
            params,
            x_measured[None],
            us_init=carry.us_warm[None],
            method=method,
            unroll=unroll,
            backward=backward,
            forward=forward,
            n_linesearch=n_linesearch,
            matmul_precision=matmul_precision,
            mults_init=(
                jax.tree.map(lambda a: a[None], carry.mults) if warm_mults else None
            ),
            mu_init=jnp.maximum(carry.mu, params.mu)[None] if warm_mults else None,
            reg_init=jnp.maximum(carry.reg, params.reg)[None] if warm_mults else None,
            w_init=w_warm[None] if (warm_mults and w_warm is not None) else None,
            n_init=n_warm[None] if (warm_mults and n_warm is not None) else None,
        )
        return MPCStep(
            u0=res.us[0, 0],
            k0=res.fb_k[0, 0],
            K0=res.fb_K[0, 0],
            carry=_advance_carry(
                res, params, warm_mults, shift_mults, mu_carry_max, mu_decay
            ),
            opt_constr=res.opt_constr[0],
        )

    return jax.jit(step)


def make_batch_mpc_step(
    problem,
    params: SolverParams,
    mesh,
    method=Method.PRIMAL_DUAL_AFFINE,
    unroll: int = 1,
    backward: str = "sweep",
    forward: str = "sweep",
    n_linesearch: int | None = None,
    matmul_precision: str | None = None,
    warm_mults: bool = True,
    shift_mults: bool = False,
    mu_carry_max: float | None = None,
    mu_decay: float = 10.0,
    **solve_kw,
):
    """Fleet MPC: replan a batch of scenarios sharded over a device mesh.

    BASELINE configs[5]: "multi-host receding-horizon MPC: 32k scenarios
    across N hosts, 10 ms replan budget".  Returns a jitted
    fn(x_measured [B, nx], carry) → (u0 [B, nu], carry', mean_constr) with
    the batch axis sharded, per-scenario warm-start state (controls +
    multipliers + μ/reg) carried between replans, and the convergence
    aggregate psum-reduced over the mesh.  Build the initial carry with
    ``init_batch_carry``.  ``**solve_kw`` forwards to solve_batched
    (e.g. n_reg_levels=..., interpret=...).
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    if mu_carry_max is None:
        mu_carry_max = 100.0 * params.mu

    w_def = params.w if params.w is not None else 1.0 / params.mu
    n_def = params.n if params.n is not None else params.mu**-0.1

    def shard_fn(x, carry):
        us_warm, mults, mu, reg, w_c, n_c = carry
        w_warm = jnp.where(w_c > 0, w_c, jnp.asarray(w_def, w_c.dtype))
        n_warm = jnp.where(n_c > 0, n_c, jnp.asarray(n_def, n_c.dtype))
        res = solve_batched(
            problem, params, x, us_init=us_warm, method=method, unroll=unroll,
            backward=backward, forward=forward, n_linesearch=n_linesearch,
            matmul_precision=matmul_precision,
            mults_init=mults if warm_mults else None,
            mu_init=jnp.maximum(mu, params.mu) if warm_mults else None,
            reg_init=jnp.maximum(reg, params.reg) if warm_mults else None,
            w_init=w_warm if warm_mults else None,
            n_init=n_warm if warm_mults else None, **solve_kw,
        )  # fmt: skip
        us_next = jnp.concatenate([res.us[:, 1:], res.us[:, -1:]], axis=1)
        mults_next = res.mults
        if shift_mults:
            mults_next = jax.vmap(_shift_mults)(mults_next)
        if not warm_mults:
            mults_next = mults_next._replace(
                val=jnp.zeros_like(mults_next.val),
                jac=jnp.zeros_like(mults_next.jac),
            )
        carry_next = MPCCarry(
            us_warm=us_next,
            mults=mults_next,
            mu=jnp.clip(
                res.mu / mu_decay,
                jnp.asarray(params.mu, res.mu.dtype),
                jnp.asarray(mu_carry_max, res.mu.dtype),
            ),
            reg=res.reg,
            w=jnp.maximum(res.w, jnp.finfo(res.w.dtype).tiny),
            n=res.n,
        )
        n_total = jax.lax.psum(x.shape[0], "batch")
        mean_constr = jax.lax.psum(jnp.sum(res.opt_constr), "batch") / n_total
        return res.us[:, 0], carry_next, mean_constr

    carry_spec = MPCCarry(
        us_warm=P("batch"),
        mults=al_mod.AffineMults(P("batch"), P("batch"), P("batch")),
        mu=P("batch"),
        reg=P("batch"),
        w=P("batch"),
        n=P("batch"),
    )
    shard = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P("batch"), carry_spec),
        out_specs=(P("batch"), carry_spec, P()),
        check_vma=False,
    )
    x_shard = NamedSharding(mesh, P("batch"))
    carry_shard = jax.tree.map(lambda sp: NamedSharding(mesh, sp), carry_spec)
    jitted = jax.jit(shard, in_shardings=(x_shard, carry_shard))

    def step(x, carry):
        # legacy checkpoints (pre-(w, n) MPCCarry) restore with w=None/n=None;
        # normalize to zero arrays so shard_fn's jnp.where(w_c > 0, ...)
        # restores the defaults — mirrors make_mpc_step's _wn_warm
        if carry.w is None or carry.n is None:
            z = jnp.zeros_like(carry.mu)
            carry = carry._replace(
                w=z if carry.w is None else carry.w,
                n=z if carry.n is None else carry.n,
            )
        return jitted(x, carry)

    return step


def init_batch_carry(problem, B: int, dtype=None, x0s: jax.Array | None = None):
    """Batched cold-start carry for make_batch_mpc_step."""
    dtype = dtype or jnp.float32
    one = init_carry(problem, dtype, None if x0s is None else x0s[0])
    carry = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), one)
    if x0s is not None:
        origin = jnp.broadcast_to(
            jnp.asarray(x0s, dtype)[:, None, :],
            (B, problem.horizon, problem.nx),
        )
        carry = carry._replace(mults=carry.mults._replace(origin=origin))
    return carry


def run_mpc(
    problem,
    params: SolverParams,
    x0: jax.Array,
    n_steps: int,
    plant=None,
    method=Method.PRIMAL_DUAL_AFFINE,
):
    """Closed-loop rollout: replan at every step, apply u0 to the plant
    (defaults to the problem's own dynamics), entirely on-device via scan."""
    plant = plant or problem.dynamics

    def body(state, t):
        x, carry = state
        out = make_step_inner(x, carry)
        x_next = plant(t, x, out.u0)
        return (x_next, out.carry), (x, out.u0, out.opt_constr)

    make_step_inner = lambda x, c: _step_impl(problem, params, method, x, c)
    carry0 = init_carry(problem, dtype=x0.dtype, x0=x0)
    (x_end, _), (xs, us, ocs) = jax.lax.scan(
        body, (x0, carry0), jnp.arange(n_steps)
    )
    return jnp.concatenate([xs, x_end[None]]), us, ocs


def _step_impl(problem, params, method, x_measured, carry):
    res = solve_batched(
        problem,
        params,
        x_measured[None],
        us_init=carry.us_warm[None],
        method=method,
        mults_init=jax.tree.map(lambda a: a[None], carry.mults),
        mu_init=jnp.maximum(carry.mu, params.mu)[None],
        reg_init=jnp.maximum(carry.reg, params.reg)[None],
    )
    return MPCStep(
        u0=res.us[0, 0],
        k0=res.fb_k[0, 0],
        K0=res.fb_K[0, 0],
        carry=_advance_carry(
            res, params, warm_mults=True, shift_mults=False,
            mu_carry_max=100.0 * params.mu, mu_decay=10.0,
        ),  # fmt: skip
        opt_constr=res.opt_constr[0],
    )
