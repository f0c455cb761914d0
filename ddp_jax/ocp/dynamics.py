"""Discrete-time dynamics on the state manifold.

``EulerDynamics`` matches the reference discretization exactly
(``dynamics_t::eval_to``, problem.hpp:441-461):

    q' = q ⊕ (dt · v)
    v' = v + dt · FD(q, v, u)

where FD is the model's forward dynamics (ABA).  An RK4 discretizer is
provided as an extension (the reference has only Euler).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ddp_jax.models.base import state_pack, state_split


def _vector_space_config(model) -> bool:
    """True iff the configuration space is a vector space (integrate is
    addition, difference is subtraction, tangent == coordinates).

    RobotModel: every joint revolute/prismatic.  Closed-form models
    (Pendulum): nq == nv with additive integrate — pinned by
    tests/test_derivatives.py parity against the generic chart path."""
    jt = getattr(model, "joint_types", None)
    if jt is not None:
        return all(t in ("revolute", "prismatic") for t in jt)
    # closed-form models must opt in explicitly (model.vector_space = True);
    # inferring from nq == nv would silently mis-handle a model with
    # non-additive integrate (e.g. angle wrapping)
    return bool(getattr(model, "vector_space", False))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class EulerDynamics:
    model: object
    dt: jax.Array

    def __call__(self, t, x: jax.Array, u: jax.Array) -> jax.Array:
        del t
        model = self.model
        q, v = state_split(model, x)
        a = model.forward_dynamics(q, v, u)
        q_next = model.integrate(q, self.dt * v)
        v_next = v + self.dt * a
        return state_pack(q_next, v_next)

    @property
    def analytic_jacobians_ok(self) -> bool:
        """Whether ``jacobians`` is available and exact for this model: the
        model must expose assembled ∂FD blocks (``fd_derivatives``).  Valid
        for every joint type: vector-space configurations use the raw
        blocks; quaternion/SO(2)-manifold configurations chain them through
        the chart (d_integrate/d_difference corrections — exactly
        problem.hpp:463-503's structure, where the reference composes
        d_integrate_dq/dv with computeABADerivatives for all Lie-group
        joints, pinocchio_model.ipp:222-321, 359-400)."""
        return hasattr(self.model, "fd_derivatives")

    def jacobians(self, t, x: jax.Array, u: jax.Array):
        """(x_next, fx, fu) assembled from the Euler-step structure.

        ≙ dynamics_t::first_order_deriv (problem.hpp:463-503): the reference
        chains d_integrate with the model's analytic ABA derivatives instead
        of differencing the whole step; this is the same chain rule on

            q' = q ⊕ (dt·v),  v' = v + dt·a(q, v, u).

        Vector-space configurations (revolute/prismatic chains, pendulum):

            fx = [[I, dt·I], [dt·∂a/∂q, I + dt·∂a/∂v]],  fu = [[0], [dt·∂a/∂u]]

        Manifold configurations (freeflyer/spherical/planar — quaternion and
        SO(2) blocks): the dynamics blocks still come from ONE kinematics
        pass + ONE Cholesky (fd_derivatives), and only the cheap chart maps
        are autodiffed — no JVP columns pushed through RNEA/ABA:

            fx = [[d_int_dq, d_int_dv·dt], [dt·(∂a/∂q)·Q, I + dt·∂a/∂v]]

        with Q = ∂ integrate(q, δ)/∂δ|₀ (coordinate→tangent map, ≙ the E
        correction) and d_int_dq/dv the group transport Jacobians
        (≙ d_integrate_dq/dv, pinocchio_model.ipp:238-254)."""
        del t
        model = self.model
        dt = self.dt
        q, v = state_split(model, x)
        a, A, Bv, Bu = model.fd_derivatives(q, v, u)
        nv, nu = Bv.shape[0], u.shape[-1]
        dtype = x.dtype
        I = jnp.eye(nv, dtype=dtype)
        if _vector_space_config(model):
            top = jnp.concatenate([I, dt * I], axis=1)
        else:
            z = jnp.zeros((nv,), dtype)
            q1 = model.integrate(q, dt * v)
            # A is the coordinate ∂a/∂q [nv, nq]; chain through the chart:
            # a(integrate(q, δ)) ≈ a + A·Q·δ with Q = ∂integrate/∂δ|₀
            Q = jax.jacfwd(lambda d: model.integrate(q, d))(z)  # [nq, nv]
            A = A @ Q
            # group-transport blocks of the q-row (chart maps only — each a
            # few quaternion/SO(2) products, no dynamics)
            d_int_dq = jax.jacfwd(
                lambda d: model.difference(
                    q1, model.integrate(model.integrate(q, d), dt * v)
                )
            )(z)
            d_int_dv = jax.jacfwd(
                lambda dv_: model.difference(
                    q1, model.integrate(q, dt * (v + dv_))
                )
            )(z)
            top = jnp.concatenate([d_int_dq, d_int_dv], axis=1)
        fx = jnp.concatenate(
            [top, jnp.concatenate([dt * A, I + dt * Bv], axis=1)], axis=0
        )
        fu = jnp.concatenate([jnp.zeros((nv, nu), dtype), dt * Bu], axis=0)
        x_next = state_pack(model.integrate(q, dt * v), v + dt * a)
        return x_next, fx, fu


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RK4Dynamics:
    """Classical RK4 on the (q, v) manifold (tangent increments retracted once).

    Not present in the reference; useful for larger dt at equal accuracy.
    """

    model: object
    dt: jax.Array

    def __call__(self, t, x: jax.Array, u: jax.Array) -> jax.Array:
        del t
        model = self.model
        dt = self.dt

        def xdot(q, v):
            return v, model.forward_dynamics(q, v, u)

        q0, v0 = state_split(model, x)
        k1q, k1v = xdot(q0, v0)
        k2q, k2v = xdot(model.integrate(q0, 0.5 * dt * k1q), v0 + 0.5 * dt * k1v)
        k3q, k3v = xdot(model.integrate(q0, 0.5 * dt * k2q), v0 + 0.5 * dt * k2v)
        k4q, k4v = xdot(model.integrate(q0, dt * k3q), v0 + dt * k3v)
        dq = (dt / 6.0) * (k1q + 2 * k2q + 2 * k3q + k4q)
        dv = (dt / 6.0) * (k1v + 2 * k2v + 2 * k3v + k4v)
        return state_pack(model.integrate(q0, dq), v0 + dv)


def euler(model, dt: float) -> EulerDynamics:
    dtype = jnp.result_type(*jax.tree_util.tree_leaves(model))
    return EulerDynamics(model=model, dt=jnp.asarray(dt, dtype))


def rk4(model, dt: float) -> RK4Dynamics:
    dtype = jnp.result_type(*jax.tree_util.tree_leaves(model))
    return RK4Dynamics(model=model, dt=jnp.asarray(dt, dtype))
