"""Equality constraints eq(t, x, u) = 0 with dense masked schedules.

The reference represents "constraint active only at some timesteps" with
ragged row-filter indexers (indexer.hpp:328-448).  The batch-first design is a
dense array of fixed width ``ne`` per step plus a static 0/1 activity mask:
XLA wants static shapes, and the masked FLOPs are negligible at these dims.
Inactive steps contribute exactly zero to every solver term because value and
Jacobians are multiplied by the mask.

Constraint protocol (all constraints are registered-dataclass pytrees):
- ``ne``: static max constraint dim
- ``value(t, x, u) -> [ne]`` traced constraint value (unmasked)
- ``active(t: int) -> bool`` Python-level activity schedule, evaluated at
  trace time for t in range(horizon)

Combinators mirror the reference:
- ``ConfigTarget``   ≙ config_constraint_t  (problem.hpp:745-864)
- ``FrameTarget``    ≙ spatial_constraint_t (problem.hpp:631-742)
- ``AdvanceTime``    ≙ constraint_advance_time_t (problem.hpp:527-629):
  eq'(t,x,u) = eq(t+1, f(t,x,u), u) — note the same u is forwarded to the
  inner constraint/dynamics, exactly as the reference does
  (problem.hpp:563-567), so double advancement rolls two steps with one u.
- ``StackConstraints`` ≙ row_concat_indexer_t-style concatenation
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ddp_jax.models.base import state_split


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class NoConstraint:
    """ne = 0: unconstrained problem; all eq arrays are zero-width."""

    ne: int = dataclasses.field(default=0, metadata={"static": True})

    def value(self, t, x, u):
        return jnp.zeros((0,), dtype=x.dtype)

    def active(self, t: int) -> bool:
        return False


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ConfigTarget:
    """eq = q_target ⊖ q — reach a target configuration.

    Reference: config_constraint_t::eval_to (problem.hpp:792-806) computes
    difference(target_q, config(x)); its Jacobian d_difference_dq_finish
    (problem.hpp:834-845) falls out of jacfwd here.
    """

    model: object
    target: jax.Array  # [nq]
    active_ts: tuple = dataclasses.field(default=(), metadata={"static": True})

    @property
    def ne(self) -> int:
        return self.model.nv

    def value(self, t, x, u):
        del t, u
        q, _ = state_split(self.model, x)
        return self.model.difference(self.target, q)

    def value_tf(self, step_tf, t, x, u):
        """Double-float evaluation for the TF-storage solve mode
        (solver/precise.py).  Vector-space models only: difference ≡ −."""
        del step_tf, t, u
        from ddp_jax.ops import twofloat as tf

        nq = self.model.nq
        q = tf.TF(x.hi[..., :nq], x.lo[..., :nq])
        return tf.sub(q, tf.from_float(self.target))

    def jac_tf(self, jac_step_tf, step_tf, t, x, u):
        """Double-float (eqx [ne, ndx], equ [ne, nu]) for the TF-Jacobian
        solve mode.  Vector-space: ∂(q − target)/∂x = [I | 0], exact."""
        del jac_step_tf, step_tf, t
        from ddp_jax.ops import twofloat as tf

        nv = self.model.nv
        dtype = x.hi.dtype
        eqx = jnp.concatenate(
            [jnp.eye(nv, dtype=dtype), jnp.zeros((nv, nv), dtype)], axis=1
        )
        equ = jnp.zeros((nv, u.hi.shape[-1]), dtype)
        z = jnp.zeros_like
        return tf.TF(eqx, z(eqx)), tf.TF(equ, z(equ))

    def active(self, t: int) -> bool:
        return t in self.active_ts


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class StateTarget:
    """eq = x_target ⊖ x on the full state tangent space (ne = 2·nv):
    configuration AND velocity — "arrive at rest".  The reference's config
    constraint (problem.hpp:745-864) pins only q; receding-horizon control
    with a position-only terminal constraint plans trajectories that pass
    THROUGH the target with residual velocity and never settles, so the MPC
    drivers want this variant."""

    model: object
    target: jax.Array  # [nq + nv] full state
    active_ts: tuple = dataclasses.field(default=(), metadata={"static": True})

    @property
    def ne(self) -> int:
        return 2 * self.model.nv

    def value(self, t, x, u):
        del t, u
        q, v = state_split(self.model, x)
        qt = self.target[: q.shape[0]]
        vt = self.target[q.shape[0] :]
        return jnp.concatenate([self.model.difference(qt, q), v - vt])

    def value_tf(self, step_tf, t, x, u):
        """TF-storage evaluation (vector-space models: ⊖ ≡ −)."""
        del step_tf, t, u
        from ddp_jax.ops import twofloat as tf

        return tf.sub(x, tf.from_float(self.target))

    def jac_tf(self, jac_step_tf, step_tf, t, x, u):
        """TF (eqx, equ): ∂(x − target)/∂x = I, exact (vector space)."""
        del jac_step_tf, step_tf, t
        from ddp_jax.ops import twofloat as tf

        n = 2 * self.model.nv
        dtype = x.hi.dtype
        eqx = jnp.eye(n, dtype=dtype)
        equ = jnp.zeros((n, u.hi.shape[-1]), dtype)
        z = jnp.zeros_like
        return tf.TF(eqx, z(eqx)), tf.TF(equ, z(equ))

    def active(self, t: int) -> bool:
        return t in self.active_ts


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FrameTarget:
    """eq = frame_position(frame_id, q) − p_target (3-D end-effector target).

    Reference: spatial_constraint_t (problem.hpp:631-742), the "spatial_eq"
    variant (test/pinocchio_spatial_eq_ddp.cpp).
    """

    model: object
    target: jax.Array  # [3]
    frame_id: int = dataclasses.field(default=0, metadata={"static": True})
    active_ts: tuple = dataclasses.field(default=(), metadata={"static": True})

    ne: int = dataclasses.field(default=3, metadata={"static": True})

    def value(self, t, x, u):
        del t, u
        q, _ = state_split(self.model, x)
        return self.model.frame_position(self.frame_id, q) - self.target

    def active(self, t: int) -> bool:
        return t in self.active_ts


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TrajectoryConfigTarget:
    """eq = q_target[t] ⊖ q — track a per-timestep configuration reference.

    The reference's constraint-target view is indexed by t
    (problem.hpp:680, :793 — ``m_constraint_target_view[t]``); this is the
    dense-array equivalent with a gather, for tracking-MPC workloads.
    ``targets``: [T_pad, nq] with T_pad ≥ max active t + 1.
    """

    model: object
    targets: jax.Array  # [T_pad, nq]
    active_ts: tuple = dataclasses.field(default=(), metadata={"static": True})

    @property
    def ne(self) -> int:
        return self.model.nv

    def value(self, t, x, u):
        del u
        q, _ = state_split(self.model, x)
        tgt = self.targets[jnp.clip(t, 0, self.targets.shape[0] - 1)]
        return self.model.difference(tgt, q)

    def active(self, t: int) -> bool:
        return t in self.active_ts


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class AdvanceTime:
    """Apply ``inner`` one step ahead through the dynamics.

    eq'(t, x, u) = inner(t+1, f(t, x, u), u).  Same-u forwarding matches
    constraint_advance_time_t::eval_to (problem.hpp:563-567); composing twice
    therefore predicts two steps with a repeated control, as in the reference
    pendulum/UR5 drivers (test/pendulum_ddp.cpp:52).  Derivatives come from
    jacfwd through the composition — the reference's hand-rolled product rule
    (problem.hpp:569-605) is unnecessary.

    Modeling gotcha (faithful to the reference): a doubly-advanced terminal
    constraint pins the same-u PREDICTION f(f(x_{T-2}, u), u), while the
    realized rollout applies u_{T-1} in its last step — and u_{T-1} enters
    no constraint, so the control cost drives it to ~0.  On slow problems
    the two coincide; on aggressive tasks (quadrotor braking hard at the
    terminal) the realized x_T keeps the difference M⁻¹(u_{T-2}-u_{T-1})·dt
    (tests/test_model_zoo.py::test_quadrotor_constrained_solve_end_to_end
    demonstrates it).  If the realized terminal state matters, constrain
    x_{T-1} with a single advance, or add a terminal state cost.
    """

    inner: object
    dynamics: object

    @property
    def ne(self) -> int:
        return self.inner.ne

    def value(self, t, x, u):
        x_next = self.dynamics(t, x, u)
        return self.inner.value(t + 1, x_next, u)

    def value_tf(self, step_tf, t, x, u):
        """TF-storage evaluation: roll the supplied TF dynamics step and
        evaluate the inner constraint in TF (same-u forwarding)."""
        return self.inner.value_tf(step_tf, t + 1, step_tf(t, x, u), u)

    def jac_tf(self, jac_step_tf, step_tf, t, x, u):
        """TF (eqx, equ) via the composition product rule in double-float:
        eqx = eqx_inner·fx, equ = eqx_inner·fu + equ_inner (same-u
        forwarding) — ≙ problem.hpp:569-605's product rule, carried at pair
        resolution."""
        from ddp_jax.ops import twofloat as tf

        x1 = step_tf(t, x, u)
        fx, fu = jac_step_tf(t, x, u)
        eqx_i, equ_i = self.inner.jac_tf(jac_step_tf, step_tf, t + 1, x1, u)
        eqx = tf.matmat(eqx_i, fx)
        equ = tf.add(tf.matmat(eqx_i, fu), equ_i)
        return eqx, equ

    def active(self, t: int) -> bool:
        return self.inner.active(t + 1)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class StackConstraints:
    """Concatenate several constraints into one eq vector (≙ row-concat
    indexers, indexer.hpp:152-195).  Each part keeps its own schedule; the
    stacked mask is per-row, applied by the problem layer."""

    parts: tuple

    @property
    def ne(self) -> int:
        return sum(p.ne for p in self.parts)

    def value(self, t, x, u):
        return jnp.concatenate([p.value(t, x, u) for p in self.parts], axis=-1)

    def active(self, t: int) -> bool:
        return any(p.active(t) for p in self.parts)

    def row_mask(self, t: int):
        """Per-row activity at step t (parts may differ)."""
        import numpy as np

        return np.concatenate(
            [np.full((p.ne,), p.active(t), dtype=bool) for p in self.parts]
        )


def advance_time(constraint, dynamics, times: int = 1):
    for _ in range(times):
        constraint = AdvanceTime(inner=constraint, dynamics=dynamics)
    return constraint


@dataclasses.dataclass(frozen=True)
class EveryK:
    """Periodic schedule: active at t = offset, offset+k, offset+2k, …

    ≙ periodic_row_filter_t (indexer.hpp:395-448).  Usable anywhere an
    ``active_ts`` tuple is accepted — activity tests are ``t in schedule``,
    which dispatches to ``__contains__``; as a frozen hashable dataclass it
    is valid static pytree metadata."""

    k: int
    offset: int = 0

    def __contains__(self, t) -> bool:
        return t >= self.offset and (t - self.offset) % self.k == 0

    def __iter__(self):
        raise TypeError("EveryK is unbounded; iterate the horizon instead")


@dataclasses.dataclass(frozen=True)
class InRange:
    """Half-open range schedule: active for begin <= t < end.

    ≙ range_row_filter_t (indexer.hpp:328-393)."""

    begin: int
    end: int

    def __contains__(self, t) -> bool:
        return self.begin <= t < self.end


def every_k(k: int, offset: int = 0) -> EveryK:
    """Schedule active every k-th step starting at ``offset``."""
    return EveryK(k=k, offset=offset)


def in_range(begin: int, end: int) -> InRange:
    """Schedule active on the half-open step range [begin, end)."""
    return InRange(begin=begin, end=end)
