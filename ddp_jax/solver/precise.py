"""Extended-precision (double-float) solver stages: the float
multiprecision envelope.

The reference threads MPFR 500/1000-digit scalars through its *entire*
template stack (test/pendulum_ddp.cpp:15-17, test/pinocchio_mpfr_500.cpp:1-17;
scalar-templated e.g. pinocchio_model.hpp:15).  An accelerator has no MPFR;
the float equivalent is double-float (ops/twofloat.py): ~48 mantissa bits
from f32 pairs, all plain elementwise adds/muls that vmap/jit.

This module applies it where finite precision actually binds the solver:

- ``al_costs_tf`` / ``al_cost_total_tf``: the line-search acceptance test
  compares Σ AL-costs whose μ‖eq‖² terms dwarf the control-cost differences
  being resolved (cost_seq_aug ≙ ddp.hpp:699-735; acceptance
  ddp_fwd.ipp:53-63).  In f32 the comparison floor is μ·eps·‖eq‖²; the TF
  sum restores it to ~eps² and lets late iterations keep making progress.
- ``optimality_obj_tf`` / ``optimality_lag_tf``: the adjoint recursions
  (ddp.hpp:516-627) with compensated accumulation, so the multiplier-update
  gate and the convergence test see sub-f32-noise values.
- ``backward_sweep_tf``: the full Riccati recursion (ddp_bwd.ipp:9-155)
  carried in TF — Q-expansion products are error-free (two_prod), V carries
  a (hi, lo) pair, and the Quu solve is float Cholesky + one step of
  compensated iterative refinement.  Usable as an on-device oracle (the role
  MPFR-1000 plays in the reference's tests) and as a drop-in
  ``backward="tf"`` backend in solve_batched.

``solve(..., precise=True)`` (solver/solve.py) turns all three on.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ddp_jax.ops import twofloat as tf
from ddp_jax.ops.twofloat import TF
from ddp_jax.solver import al as al_mod


def _F(x) -> TF:
    return tf.from_float(x)


def _mul_scalar(s, x) -> TF:
    """Error-free product of plain-float operands (broadcasts)."""
    return TF(*tf.two_prod(s, x))


def al_costs_tf(problem, xs, us, mults, mu) -> TF:
    """Per-step AL cost [T+1] in TF: l + p·eq + (μ/2)‖eq‖² with error-free
    products and compensated dot products.  ≙ cost_seq_aug (ddp.hpp:699-735).
    Constraint penalties are evaluated at statically-active timesteps only
    (same skip as al.al_costs — zeros contribute exactly zero to the TF sum)."""
    import numpy as np

    T = problem.horizon
    ts = jnp.arange(T)
    mask = jnp.asarray(problem.eq_mask(), dtype=xs.dtype)

    stage_l = jax.vmap(lambda t, x, u: problem.cost.stage(t, x, u))(
        ts, xs[:-1], us
    )
    hi = stage_l
    lo = jnp.zeros_like(stage_l)

    active = problem.active_ts() if hasattr(problem, "active_ts") else tuple(range(T))
    if problem.ne and active:

        def pen(t, x, u, p, m):
            ce = problem.constraint.value(t, x, u) * m
            acc = tf.add(tf.dot(p, ce), tf.mul(_F(0.5 * mu), tf.dot(ce, ce)))
            return acc

        if len(active) == T:
            pe = al_mod.eval_mults(problem.model, mults, xs)
            pen_all = jax.vmap(pen)(ts, xs[:-1], us, pe, mask)
            acc = tf.add(TF(hi, lo), pen_all)
            hi, lo = acc.hi, acc.lo
        else:
            from ddp_jax.models.base import state_difference

            ts_a = np.asarray(active)
            pe_a = jax.vmap(
                lambda val, jac, origin, x: val
                + jac @ state_difference(problem.model, origin, x)
            )(mults.val[ts_a], mults.jac[ts_a], mults.origin[ts_a], xs[:-1][ts_a])
            pen_a = jax.vmap(pen)(
                jnp.asarray(ts_a), xs[:-1][ts_a], us[ts_a], pe_a, mask[ts_a]
            )
            acc_a = tf.add(TF(hi[ts_a], lo[ts_a]), pen_a)
            hi = hi.at[ts_a].set(acc_a.hi)
            lo = lo.at[ts_a].set(acc_a.lo)

    lf = _F(problem.cost.terminal(xs[-1]))
    return TF(
        jnp.concatenate([hi, lf.hi[None]]),
        jnp.concatenate([lo, lf.lo[None]]),
    )


def al_cost_total_tf(problem, xs, us, mults, mu) -> TF:
    """Compensated Σ_t AL cost (scalar TF)."""
    return tf.sum_(al_costs_tf(problem, xs, us, mults, mu))


def _zero3(derivs, mult_val, mult_jac, eq_lo, mult_val_lo, mult_jac_lo):
    z = jnp.zeros_like
    return (
        eq_lo if eq_lo is not None else z(derivs.eq),
        mult_val_lo if mult_val_lo is not None else z(mult_val),
        mult_jac_lo if mult_jac_lo is not None else z(mult_jac),
    )


def optimality_obj_tf(
    problem, derivs, mult_val, mult_jac, mu,
    eq_lo=None, mult_val_lo=None, mult_jac_lo=None, rows_lo=None,
) -> jax.Array:
    """max_t ‖∂L_aug/∂u_t‖ (ddp.hpp:575-627) with TF accumulation.  The
    optional lo arrays carry eq/multiplier pair residues (storage mode);
    ``rows_lo`` carries the TF-evaluated-Jacobian residues of
    lx/lu/fx/fu/eqx/equ (TF-Jacobian mode, derivs_rows_tf)."""

    def step(adj: TF, inp):
        (lx, lu, fx, fu, eqv, eqx, equ, pe, pex,
         eqv_lo, pe_lo, pex_lo, rl) = inp  # fmt: skip
        eqv_tf, pe_tf, pex_tf = TF(eqv, eqv_lo), TF(pe, pe_lo), TF(pex, pex_lo)
        equ_tf = tf.tT(TF(equ, rl.equ))
        lu_aug = tf.add(TF(lu, rl.lu), tf.matvec(equ_tf, pe_tf))
        lu_aug = tf.add(lu_aug, tf.matvec(equ_tf, tf.mul(_F(mu), eqv_tf)))
        lu_aug = tf.add(lu_aug, tf.matvec(tf.tT(TF(fu, rl.fu)), adj))
        score = jnp.sqrt(tf.dot(tf.to_float(lu_aug), tf.to_float(lu_aug)).hi)
        eqx_tf = tf.tT(TF(eqx, rl.eqx))
        adj_new = tf.add(tf.matvec(tf.tT(TF(fx, rl.fx)), adj), TF(lx, rl.lx))
        adj_new = tf.add(adj_new, tf.matvec(eqx_tf, tf.mul(_F(mu), eqv_tf)))
        adj_new = tf.add(adj_new, tf.matvec(eqx_tf, pe_tf))
        adj_new = tf.add(adj_new, tf.matvec(tf.tT(pex_tf), eqv_tf))
        return adj_new, score

    lo3 = _zero3(derivs, mult_val, mult_jac, eq_lo, mult_val_lo, mult_jac_lo)
    rl = rows_lo if rows_lo is not None else _rows_lo_zero(derivs)
    inputs = (
        derivs.lx, derivs.lu, derivs.fx, derivs.fu,
        derivs.eq, derivs.eqx, derivs.equ, mult_val, mult_jac, *lo3, rl,
    )  # fmt: skip
    _, scores = jax.lax.scan(step, _F(derivs.lfx), inputs, reverse=True)
    return jnp.max(scores)


def optimality_lag_tf(
    problem, derivs, mult_val, mult_jac,
    eq_lo=None, mult_val_lo=None, mult_jac_lo=None, rows_lo=None,
) -> jax.Array:
    """max_t ‖∂L/∂u_t‖ (μ-free, ddp.hpp:525-573) with TF accumulation."""

    def step(adj: TF, inp):
        (lx, lu, fx, fu, eqv, eqx, equ, pe, pex,
         eqv_lo, pe_lo, pex_lo, rl) = inp  # fmt: skip
        eqv_tf, pe_tf, pex_tf = TF(eqv, eqv_lo), TF(pe, pe_lo), TF(pex, pex_lo)
        lu_aug = tf.add(TF(lu, rl.lu), tf.matvec(tf.tT(TF(equ, rl.equ)), pe_tf))
        lu_aug = tf.add(lu_aug, tf.matvec(tf.tT(TF(fu, rl.fu)), adj))
        score = jnp.sqrt(tf.dot(tf.to_float(lu_aug), tf.to_float(lu_aug)).hi)
        adj_new = tf.add(tf.matvec(tf.tT(TF(fx, rl.fx)), adj), TF(lx, rl.lx))
        adj_new = tf.add(adj_new, tf.matvec(tf.tT(TF(eqx, rl.eqx)), pe_tf))
        adj_new = tf.add(adj_new, tf.matvec(tf.tT(pex_tf), eqv_tf))
        return adj_new, score

    lo3 = _zero3(derivs, mult_val, mult_jac, eq_lo, mult_val_lo, mult_jac_lo)
    rl = rows_lo if rows_lo is not None else _rows_lo_zero(derivs)
    inputs = (
        derivs.lx, derivs.lu, derivs.fx, derivs.fu,
        derivs.eq, derivs.eqx, derivs.equ, mult_val, mult_jac, *lo3, rl,
    )  # fmt: skip
    _, scores = jax.lax.scan(step, _F(derivs.lfx), inputs, reverse=True)
    return jnp.max(scores)


class MultsTF(NamedTuple):
    """Affine multiplier sequence with double-float value/jac accumulators.

    The reference's multipliers live in MPFR scalars end-to-end
    (pinocchio_model.hpp:15); here the hi parts stay the f32 arrays every
    other solver stage consumes, while the lo parts carry the rounding
    residue of the two accumulating recurrences across iterations:

    - ``update_origin``: val += jac·(x_new ⊖ origin) every iteration, and
    - the AL update: val += μ·(eq + eq_u·k),  jac += μ·(eq_x + eq_u·K),

    both of which compound f32 round-off precisely when μ is large and the
    increments are small (late iterations).  ≙ mat_seq_common.hpp:62-89 and
    ddp.hpp:677-695 under an MPFR scalar."""

    hi: al_mod.AffineMults
    lo_val: jax.Array  # [T, m]
    lo_jac: jax.Array  # [T, m, ndx]
    lo_origin: jax.Array | None = None  # [T, nx] — TF-storage mode only

    @classmethod
    def from_plain(cls, mults: al_mod.AffineMults) -> "MultsTF":
        return cls(
            hi=mults,
            lo_val=jnp.zeros_like(mults.val),
            lo_jac=jnp.zeros_like(mults.jac),
            lo_origin=jnp.zeros_like(mults.origin),
        )


def update_origin_tf(model, m: MultsTF, xs) -> MultsTF:
    """update_origin (mat_seq_common.hpp:62-89) with compensated
    accumulation: val' = val ⊕ jac·d in TF; jac' = jac·J with the product
    round-off folded into lo_jac.

    ``xs`` may be a plain [T+1, nx] array (envelope mode — origins stay
    plain floats) or a TF pair (storage mode — d is computed in TF against
    the TF origin and the new origin keeps its lo)."""
    from ddp_jax.models.base import state_difference, state_difference_jacobian

    storage = isinstance(xs, TF)

    def one(val, vlo, jac, jlo, origin, olo, x_new_hi, x_new_lo):
        if storage:
            # vector-space difference in TF (storage mode gates on it)
            d = tf.sub(TF(x_new_hi, x_new_lo), TF(origin, olo))
            J = None
        else:
            d = _F(state_difference(model, origin, x_new_hi))
            J = state_difference_jacobian(model, origin, x_new_hi)
        acc = tf.add(TF(val, vlo), tf.matvec(TF(jac, jlo), d))
        if J is None:
            jac_new = TF(jac, jlo)  # vector space: d_difference = I
        else:
            jac_new = tf.matmat(TF(jac, jlo), _F(J))
        return (acc.hi, acc.lo, jac_new.hi, jac_new.lo, x_new_hi, x_new_lo)

    olo = m.lo_origin if m.lo_origin is not None else jnp.zeros_like(m.hi.origin)
    if storage:
        xh, xl = xs.hi[:-1], xs.lo[:-1]
    else:
        xh, xl = xs[:-1], jnp.zeros_like(xs[:-1])
    val, vlo, jac, jlo, origin, lo_origin = jax.vmap(one)(
        m.hi.val, m.lo_val, m.hi.jac, m.lo_jac, m.hi.origin, olo, xh, xl
    )
    return MultsTF(al_mod.AffineMults(val, jac, origin), vlo, jlo, lo_origin)


def mult_update_tf(m: MultsTF, gain, val_inc, jac_inc) -> MultsTF:
    """Compensated first-order AL update (ddp.hpp:680-688):
    val ⊕= gain·val_inc, jac ⊕= gain·jac_inc, with the gain products
    error-free (two_prod) and the sums carried in TF.  ``val_inc``/
    ``jac_inc`` may be plain floats or TF pairs (storage mode)."""
    vi = val_inc if isinstance(val_inc, TF) else _F(val_inc)
    ji = jac_inc if isinstance(jac_inc, TF) else _F(jac_inc)
    gmul = lambda x: tf.mul(_F(jnp.broadcast_to(gain, ())), x)
    val = tf.add(TF(m.hi.val, m.lo_val), gmul(vi))
    jac = tf.add(TF(m.hi.jac, m.lo_jac), gmul(ji))
    return MultsTF(
        al_mod.AffineMults(val.hi, jac.hi, m.hi.origin), val.lo, jac.lo,
        m.lo_origin,
    )


# ---------------------------------------------------------------------------
# TF trajectory storage: the full-stack extended-precision mode
# ---------------------------------------------------------------------------
# The envelope above widens every *accumulating stage* but stores the iterate
# (xs, us) in f32 — docs/DESIGN.md "The f32 storage floor" shows opt_lag
# stalling ~5e-2 on the T=60 pendulum driver because the trajectory (and so
# every eq value and every μ-amplified term built from it) is quantized to
# ~eps_f32·‖x‖ each iteration.  The functions below carry (xs, us) as TF
# pairs through the rollout, the dynamics, the constraint evaluation, and
# the line-search cost — the configuration the reference reaches by
# instantiating the whole stack at an MPFR scalar (test/pendulum_ddp.cpp:
# 15-17).  solve(..., precise="storage") wires them in.
#
# Model/problem requirements (vector-space configuration throughout):
# - model.forward_dynamics_tf(q, v, tau) -> TF   (e.g. models/pendulum.py)
# - constraint.value_tf(step_tf, t, x, u) -> TF  (ConfigTarget/StateTarget/
#   AdvanceTime provide it)
# - cost.stage_tf / terminal_tf                  (QuadControlCost provides it)


class TrajTF(NamedTuple):
    xs: TF  # [T+1, nx]
    us: TF  # [T, nu]


def _constraint_supports_tf(con) -> bool:
    """True iff the WHOLE constraint stack evaluates in TF.  AdvanceTime
    always defines value_tf (it just forwards through the TF step), so the
    gate must recurse into its inner constraint — otherwise
    AdvanceTime(FrameTarget) passes hasattr and dies mid-trace with
    AttributeError instead of solve()'s clean ValueError."""
    if not hasattr(con, "value_tf"):
        return False
    inner = getattr(con, "inner", None)
    return _constraint_supports_tf(inner) if inner is not None else True


def supports_tf_storage(problem) -> bool:
    model = problem.model
    from ddp_jax.ocp.dynamics import EulerDynamics, _vector_space_config

    return (
        isinstance(problem.dynamics, EulerDynamics)
        and _vector_space_config(model)
        and hasattr(model, "forward_dynamics_tf")
        and _constraint_supports_tf(problem.constraint)
        and hasattr(problem.cost, "stage_tf")
    )


class RowsLo(NamedTuple):
    """TF residues of the first-order derivative rows (TF-Jacobian mode).

    ``solve(precise="storage")`` on a model exposing ``fd_derivatives_tf``
    evaluates lx/lu/fx/fu/eqx/equ on the TF iterate at pair resolution
    (derivs_rows_tf); the hi parts replace the Derivs rows and these lo
    parts ride into the TF backward sweep and optimality adjoints — the one
    stage the reference's whole-stack MPFR instantiation covered
    (problem.hpp:50-341 templated on Scalar) that TF storage alone did not
    (docs/DESIGN.md "The f32 storage floor")."""

    lx: jax.Array  # [T, ndx]
    lu: jax.Array  # [T, nu]
    fx: jax.Array  # [T, ndx, ndx]
    fu: jax.Array  # [T, ndx, nu]
    eqx: jax.Array  # [T, ne, ndx]
    equ: jax.Array  # [T, ne, nu]


def _rows_lo_zero(derivs) -> RowsLo:
    z = jnp.zeros_like
    return RowsLo(
        lx=z(derivs.lx), lu=z(derivs.lu), fx=z(derivs.fx), fu=z(derivs.fu),
        eqx=z(derivs.eqx), equ=z(derivs.equ),
    )  # fmt: skip


def supports_tf_jacobians(problem) -> bool:
    """Whether the whole first-order derivative sweep can run in TF:
    TF-storage support plus model/cost/constraint TF-Jacobian hooks."""

    def con_ok(con):
        if not hasattr(con, "jac_tf"):
            return False
        inner = getattr(con, "inner", None)
        return con_ok(inner) if inner is not None else True

    return (
        supports_tf_storage(problem)
        and hasattr(problem.model, "fd_derivatives_tf")
        and con_ok(problem.constraint)
        and hasattr(problem.cost, "grad_tf")
    )


def euler_jac_tf(dyn, x: TF, u: TF):
    """Double-float Euler-step tangent Jacobians (fx, fu) — the TF analog
    of dynamics.EulerDynamics.jacobians on a vector-space model:

        fx = [[I, dt·I], [dt·∂a/∂q, I + dt·∂a/∂v]],  fu = [[0], [dt·∂a/∂u]]

    with the ∂a blocks from model.fd_derivatives_tf at pair resolution."""
    model = dyn.model
    nq, nv = model.nq, model.nv
    q = TF(x.hi[..., :nq], x.lo[..., :nq])
    v = TF(x.hi[..., nq:], x.lo[..., nq:])
    _, A, Bv, Bu = model.fd_derivatives_tf(q, v, u)
    dtype = x.hi.dtype
    dt = _F(dyn.dt)
    I = jnp.eye(nv, dtype=dtype)
    zI = jnp.zeros_like(I)
    dtI = tf.mul(dt, TF(I, zI))

    def hcat(a: TF, b: TF) -> TF:
        return TF(
            jnp.concatenate([a.hi, b.hi], axis=-1),
            jnp.concatenate([a.lo, b.lo], axis=-1),
        )

    def vcat(a: TF, b: TF) -> TF:
        return TF(
            jnp.concatenate([a.hi, b.hi], axis=-2),
            jnp.concatenate([a.lo, b.lo], axis=-2),
        )

    top = hcat(TF(I, zI), dtI)
    bot = hcat(tf.mul(dt, A), tf.add(TF(I, zI), tf.mul(dt, Bv)))
    fx = vcat(top, bot)
    nu = u.hi.shape[-1]
    zU = jnp.zeros((nv, nu), dtype)
    fu = vcat(TF(zU, zU), tf.mul(dt, Bu))
    return fx, fu


def derivs_rows_tf(problem, xs: TF, us: TF):
    """Evaluate the first-order derivative rows (lx, lu, fx, fu, eqx, equ)
    on the TF iterate at pair resolution, for every timestep.

    Returns (rows_hi: dict, rows_lo: RowsLo) with the same [T, …] layouts
    as Derivs; eq rows are masked by the static activity mask.  ≙ the
    reference's compute_derivatives under an MPFR scalar for the rows the
    optimality adjoints and the Q-expansion consume linearly."""
    T = problem.horizon
    dyn = problem.dynamics

    def step_tf(t, x, u):
        return euler_step_tf(dyn, x, u)

    def jac_step_tf(t, x, u):
        return euler_jac_tf(dyn, x, u)

    def per_t(t, xh, xl, uh, ul):
        x = TF(xh, xl)
        u = TF(uh, ul)
        lx, lu = problem.cost.grad_tf(t, x, u)
        fx, fu = euler_jac_tf(dyn, x, u)
        eqx, equ = problem.constraint.jac_tf(jac_step_tf, step_tf, t, x, u)
        return lx, lu, fx, fu, eqx, equ

    ts = jnp.arange(T)
    lx, lu, fx, fu, eqx, equ = jax.vmap(per_t)(
        ts, xs.hi[:-1], xs.lo[:-1], us.hi, us.lo
    )
    mask = jnp.asarray(problem.eq_mask(), dtype=xs.hi.dtype)[:, :, None]
    eqx = TF(eqx.hi * mask, eqx.lo * mask)
    equ = TF(equ.hi * mask, equ.lo * mask)
    rows_hi = dict(
        lx=lx.hi, lu=lu.hi, fx=fx.hi, fu=fu.hi, eqx=eqx.hi, equ=equ.hi
    )
    rows_lo = RowsLo(
        lx=lx.lo, lu=lu.lo, fx=fx.lo, fu=fu.lo, eqx=eqx.lo, equ=equ.lo
    )
    return rows_hi, rows_lo


def euler_step_tf(dyn, x: TF, u: TF) -> TF:
    """Semi-implicit Euler step in TF (≙ dynamics_t::eval_to,
    problem.hpp:441-461, at the wide scalar).  Vector-space ⊕ ≡ +."""
    model = dyn.model
    nq = model.nq
    q = TF(x.hi[..., :nq], x.lo[..., :nq])
    v = TF(x.hi[..., nq:], x.lo[..., nq:])
    a = model.forward_dynamics_tf(q, v, u)
    dt = _F(dyn.dt)
    q1 = tf.add(q, tf.mul(dt, v))
    v1 = tf.add(v, tf.mul(dt, a))
    return TF(
        jnp.concatenate([q1.hi, v1.hi], axis=-1),
        jnp.concatenate([q1.lo, v1.lo], axis=-1),
    )


def rollout_tf(problem, x0: TF, us: TF) -> TF:
    """TF forward rollout (≙ Problem.rollout / make_trajectory)."""
    dyn = problem.dynamics

    def body(x, u_pair):
        x1 = euler_step_tf(dyn, x, TF(*u_pair))
        return x1, (x1.hi, x1.lo)

    _, (hs, ls) = jax.lax.scan(body, x0, (us.hi, us.lo))
    return TF(
        jnp.concatenate([x0.hi[None], hs], axis=0),
        jnp.concatenate([x0.lo[None], ls], axis=0),
    )


def eq_values_tf(problem, xs: TF, us: TF) -> TF:
    """Masked TF constraint values [T, ne] at the statically-active steps."""
    import numpy as np

    T, ne = problem.horizon, problem.ne
    dtype = xs.hi.dtype
    step_tf = lambda t, x, u: euler_step_tf(problem.dynamics, x, u)
    hi = jnp.zeros((T, ne), dtype)
    lo = jnp.zeros((T, ne), dtype)
    for t in problem.active_ts():
        x_t = TF(xs.hi[t], xs.lo[t])
        u_t = TF(us.hi[t], us.lo[t])
        v = problem.constraint.value_tf(step_tf, t, x_t, u_t)
        hi = hi.at[t].set(v.hi)
        lo = lo.at[t].set(v.lo)
    del np
    return TF(hi, lo)


def al_cost_total_storage_tf(problem, traj: TrajTF, mults: "MultsTF", mu) -> TF:
    """Σ_t AL cost with the trajectory, constraint values, multiplier
    evaluation, and the reduction all in TF (cost_seq_aug ≙ ddp.hpp:699-735
    at the wide scalar)."""
    T = problem.horizon
    xs, us = traj.xs, traj.us
    stage = jax.vmap(
        lambda t, xh, xl, uh, ul: problem.cost.stage_tf(t, TF(xh, xl), TF(uh, ul))
    )(jnp.arange(T), xs.hi[:-1], xs.lo[:-1], us.hi, us.lo)
    total = tf.sum_(stage)
    step_tf = lambda t, x, u: euler_step_tf(problem.dynamics, x, u)
    for t in problem.active_ts():
        x_t = TF(xs.hi[t], xs.lo[t])
        u_t = TF(us.hi[t], us.lo[t])
        ce = problem.constraint.value_tf(step_tf, t, x_t, u_t)
        # pe = val + jac·(x ⊖ origin), all TF (origin carries its own lo)
        d = tf.sub(x_t, TF(mults.hi.origin[t], mults.lo_origin[t]))
        pe = tf.add(
            TF(mults.hi.val[t], mults.lo_val[t]),
            _matvec_tf(TF(mults.hi.jac[t], mults.lo_jac[t]), d),
        )
        total = tf.add(total, tf.sum_(tf.mul(pe, ce)))
        total = tf.add(
            total, tf.mul(_F(jnp.asarray(0.5, ce.hi.dtype) * mu), tf.sum_(tf.mul(ce, ce)))
        )
    total = tf.add(total, problem.cost.terminal_tf(TF(xs.hi[-1], xs.lo[-1])))
    return total


def _matvec_tf(A: TF, x: TF) -> TF:
    """TF [m,n] · TF [n] with the state-tangent identity (vector space)."""
    return tf.sum_(
        tf.mul(A, TF(x.hi[None, :], x.lo[None, :])), axis=1
    )


def feedback_rollout_tf(problem, traj_old: TrajTF, k, K, step) -> TrajTF:
    """Closed-loop rollout in TF (ddp_fwd.ipp:39-51 at the wide scalar):
    u = u_old ⊕ step·k ⊕ K·(x ⊖ x_old); x' = f_tf(x, u).  Gains (k, K) are
    plain f32 (they multiply deltas — their own rounding is harmless)."""
    dyn = problem.dynamics
    xs_old, us_old = traj_old.xs, traj_old.us

    def body(x, inp):
        xo_hi, xo_lo, uo_hi, uo_lo, k_t, K_t = inp
        dx = tf.sub(x, TF(xo_hi, xo_lo))
        u = tf.add(TF(uo_hi, uo_lo), TF(*tf.two_prod(step, k_t)))
        u = tf.add(u, _matvec_tf(_F(K_t), dx))
        x1 = euler_step_tf(dyn, x, u)
        return x1, (u.hi, u.lo, x1.hi, x1.lo)

    x0 = TF(xs_old.hi[0], xs_old.lo[0])
    _, (uh, ul, xh, xl) = jax.lax.scan(
        body, x0, (xs_old.hi[:-1], xs_old.lo[:-1], us_old.hi, us_old.lo, k, K)
    )
    xs = TF(
        jnp.concatenate([xs_old.hi[0][None], xh], axis=0),
        jnp.concatenate([xs_old.lo[0][None], xl], axis=0),
    )
    return TrajTF(xs=xs, us=TF(uh, ul))


class ForwardTFResult(NamedTuple):
    traj: TrajTF
    step: jax.Array
    accepted: jax.Array


def forward_pass_storage_tf(
    problem, traj_old: TrajTF, k, K, mults: "MultsTF", mu,
    step_min: float = 1e-10,
) -> ForwardTFResult:
    """Backtracking line search with TF trajectories end-to-end
    (ddp_fwd.ipp:9-67 at the wide scalar)."""
    dtype = traj_old.xs.hi.dtype
    cost_old = al_cost_total_storage_tf(problem, traj_old, mults, mu)

    def try_step(step):
        traj = feedback_rollout_tf(problem, traj_old, k, K, step)
        cost_new = al_cost_total_storage_tf(problem, traj, mults, mu)
        delta = tf.to_float(tf.sub(cost_new, cost_old))
        return traj, delta

    one = jnp.ones((), dtype)
    traj1, d1 = try_step(one)

    def cond(c):
        step, accepted, *_ = c
        return jnp.logical_and(~accepted, step >= 2 * step_min)

    def body(c):
        step, _, _ = c
        step = step * 0.5
        traj, d = try_step(step)
        return (step, d <= 0, traj)

    step, accepted, traj = jax.lax.while_loop(
        cond, body, (one, d1 <= 0, traj1)
    )
    return ForwardTFResult(traj=traj, step=step, accepted=accepted)


def backward_sweep_tf(
    derivs, mult_val, mult_jac, mu, reg,
    eq_lo=None, mult_val_lo=None, mult_jac_lo=None, rows_lo=None,
):
    """One Riccati sweep (ddp_bwd.ipp:9-155) carried in double-float.

    Inputs are plain-float Derivs (their values are exact by definition);
    every product in the Q-expansion is error-free, (Vx, Vxx) propagate as
    TF pairs, and the Quu⁻¹ solves are float Cholesky + one compensated
    iterative-refinement step (≈ full TF accuracy for well-conditioned Quu).

    The optional ``*_lo`` arrays are the TF residues of eq values and
    multipliers (TF-storage mode): the μ-amplified terms tmp = p + μ·eq and
    tmp2 = p_x + μ·eq_x then carry the full pair resolution instead of
    being floored at eps_f32·‖eq‖.  ``rows_lo`` (TF-Jacobian mode) carries
    the residues of the TF-evaluated first-order rows, so Qu/Qx/Qux seed at
    pair resolution too.

    Returns (k [T,m], K [T,m,n], ok) as plain floats (rounded from TF).
    """
    nu = derivs.lu.shape[1]
    dtype = derivs.lx.dtype
    I_u = jnp.eye(nu, dtype=dtype)
    z = jnp.zeros_like
    eq_lo = eq_lo if eq_lo is not None else z(derivs.eq)
    mult_val_lo = mult_val_lo if mult_val_lo is not None else z(mult_val)
    mult_jac_lo = mult_jac_lo if mult_jac_lo is not None else z(mult_jac)
    rl = rows_lo if rows_lo is not None else _rows_lo_zero(derivs)

    inputs = (
        derivs.lx, derivs.lu, derivs.lxx, derivs.lux, derivs.luu,
        derivs.fx, derivs.fu, derivs.fxx, derivs.fux, derivs.fuu,
        derivs.eq, derivs.eqx, derivs.equ, derivs.eqxx, derivs.equx, derivs.equu,
        mult_val, mult_jac, eq_lo, mult_val_lo, mult_jac_lo, rl,
    )  # fmt: skip

    def refine(chol, Quu_reg: TF, rhs: TF):
        """Solve (Quu+reg·I) x = −rhs with one compensated refinement step."""
        apply = tf.matvec if rhs.hi.ndim == 1 else tf.matmat
        x0 = -jax.scipy.linalg.cho_solve((chol, True), tf.to_float(rhs))
        # residual of A·x = −rhs:  r = −rhs − A·x0, computed in TF
        r = tf.neg(tf.add(rhs, apply(Quu_reg, _F(x0))))
        dx = jax.scipy.linalg.cho_solve((chol, True), tf.to_float(r))
        return tf.add(_F(x0), _F(dx))

    def step(carry, inp):
        Vx, Vxx = carry  # TF [n], TF [n,n]
        (lx, lu, lxx, lux, luu, fx, fu, fxx, fux, fuu,
         eqv, eqx, equ, eqxx, equx, equu, pe, pex,
         eqv_lo, pe_lo, pex_lo, rl) = inp  # fmt: skip

        eqv_tf = TF(eqv, eqv_lo)
        pe_tf = TF(pe, pe_lo)
        pex_tf = TF(pex, pex_lo)
        fx_tf, fu_tf = TF(fx, rl.fx), TF(fu, rl.fu)
        eqx_tf, equ_tf = TF(eqx, rl.eqx), TF(equ, rl.equ)
        tmp = tf.add(pe_tf, tf.mul(_F(mu), eqv_tf))  # p + μ·eq
        tmp2 = tf.add(pex_tf, tf.mul(_F(mu), eqx_tf))  # p_x + μ·eq_x

        Qx = tf.add(TF(lx, rl.lx), tf.matvec(tf.tT(fx_tf), Vx))
        Qx = tf.add(Qx, tf.matvec(tf.tT(eqx_tf), tmp))
        Qx = tf.add(Qx, tf.matvec(tf.tT(pex_tf), eqv_tf))

        Qu = tf.add(TF(lu, rl.lu), tf.matvec(tf.tT(fu_tf), Vx))
        Qu = tf.add(Qu, tf.matvec(tf.tT(equ_tf), tmp))

        Vfx = tf.matmat(Vxx, fx_tf)
        Vfu = tf.matmat(Vxx, fu_tf)

        Qxx = tf.add(_F(lxx), tf.matmat(tf.tT(fx_tf), Vfx))
        Qxx = tf.add(Qxx, tf.matmat(tf.tT(eqx_tf), tmp2))
        Qxx = tf.add(Qxx, tf.matmat(tf.tT(pex_tf), eqx_tf))
        Qxx = tf.add(Qxx, tf.contract0(tmp, _F(eqxx)))
        Qxx = tf.add(Qxx, tf.contract0(Vx, _F(fxx)))

        Quu = tf.add(_F(luu), tf.matmat(tf.tT(fu_tf), Vfu))
        Quu = tf.add(Quu, tf.matmat(tf.tT(tf.mul(_F(mu), equ_tf)), equ_tf))
        Quu = tf.add(Quu, tf.contract0(tmp, _F(equu)))
        Quu = tf.add(Quu, tf.contract0(Vx, _F(fuu)))

        Qux = tf.add(_F(lux), tf.matmat(tf.tT(fu_tf), Vfx))
        Qux = tf.add(Qux, tf.matmat(tf.tT(equ_tf), tmp2))
        Qux = tf.add(Qux, tf.contract0(tmp, _F(equx)))
        Qux = tf.add(Qux, tf.contract0(Vx, _F(fux)))

        Quu_reg = tf.add(Quu, _F(reg * I_u))
        chol = jnp.linalg.cholesky(tf.to_float(Quu_reg))
        ok_t = jnp.all(jnp.isfinite(chol))
        k = refine(chol, Quu_reg, Qu)  # TF [m]
        K = refine(chol, Quu_reg, Qux)  # TF [m,n]

        Vx_new = tf.add(Qx, tf.matvec(tf.tT(Qux), k))
        Vxx_new = tf.add(Qxx, tf.matmat(tf.tT(Qux), K))
        return (Vx_new, Vxx_new), (tf.to_float(k), tf.to_float(K), ok_t)

    _, (ks, Ks, oks) = jax.lax.scan(
        step, (_F(derivs.lfx), _F(derivs.lfxx)), inputs, reverse=True
    )
    return ks, Ks, jnp.all(oks)


def backward_pass_tf(
    derivs, mult_val, mult_jac, mu, reg, max_retries: int = 24,
    eq_lo=None, mult_val_lo=None, mult_jac_lo=None, rows_lo=None,
):
    """TF sweep with the reference's failure-escalation loop
    (ddp_bwd.ipp:26, 105-132: reg = max(reg, μ)·2, μ·2, restart).
    Same result contract as riccati.backward_pass."""
    from ddp_jax.solver.riccati import BackwardResult

    sweep = lambda m_, r_: backward_sweep_tf(
        derivs, mult_val, mult_jac, m_, r_,
        eq_lo=eq_lo, mult_val_lo=mult_val_lo, mult_jac_lo=mult_jac_lo,
        rows_lo=rows_lo,
    )
    ks0, Ks0, ok0 = sweep(mu, reg)

    def cond(c):
        it, ok, *_ = c
        return jnp.logical_and(~ok, it < max_retries)

    def body(c):
        it, _, mu_, reg_, _, _ = c
        reg_ = jnp.maximum(reg_, mu_) * 2.0
        mu_ = mu_ * 2.0
        ks, Ks, ok = sweep(mu_, reg_)
        return (it + 1, ok, mu_, reg_, ks, Ks)

    it, ok, mu, reg, ks, Ks = jax.lax.while_loop(
        cond, body, (jnp.asarray(0), ok0, mu, reg, ks0, Ks0)
    )
    return BackwardResult(k=ks, K=Ks, mu=mu, reg=reg, ok=ok, dV=jnp.zeros((), ks.dtype))
