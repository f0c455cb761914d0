"""Closed-form 1-DoF pendulum model.

Reference: ``pendulum_model_t`` (pendulum_model.hpp:10-133):
acceleration a = -g/l sin(q) + tau/m; vector-space integrate/difference.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

_G = 9.81


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Pendulum:
    mass: jax.Array
    length: jax.Array

    nq: int = dataclasses.field(default=1, metadata={"static": True})
    nv: int = dataclasses.field(default=1, metadata={"static": True})
    nu: int = dataclasses.field(default=1, metadata={"static": True})

    name: str = dataclasses.field(default="pendulum", metadata={"static": True})
    # explicit vector-space opt-in: integrate/difference really are +/−
    # (no wrapping), so the analytic Euler-Jacobian path is exact
    # (ocp/dynamics.py _vector_space_config)
    vector_space: bool = dataclasses.field(default=True, metadata={"static": True})

    def neutral_configuration(self) -> jax.Array:
        return jnp.zeros((1,), dtype=jnp.result_type(self.mass))

    def random_configuration(self, key: jax.Array) -> jax.Array:
        return jax.random.uniform(
            key, (1,), minval=-jnp.pi, maxval=jnp.pi, dtype=jnp.result_type(self.mass)
        )

    def integrate(self, q: jax.Array, dq: jax.Array) -> jax.Array:
        return q + dq

    def difference(self, q0: jax.Array, q1: jax.Array) -> jax.Array:
        return q1 - q0

    def forward_dynamics(self, q: jax.Array, v: jax.Array, tau: jax.Array) -> jax.Array:
        del v  # no damping, matching the reference (pendulum_model.hpp:105-114)
        return -(_G / self.length) * jnp.sin(q) + tau / self.mass

    def forward_dynamics_tf(self, q, v, tau):
        """Double-float forward dynamics: the model's piece of the TF-storage
        solve mode (solver/precise.py) — a TF trajectory is only as accurate
        as the dynamics evaluated on it.  ≙ instantiating dynamics_aba at an
        MPFR scalar (pendulum_model.hpp:105-114 under test/pendulum_ddp.cpp:
        15-17's scalar typedef)."""
        del v
        from ddp_jax.ops import twofloat as tf

        s = tf.sin(q)
        coef = tf.div(
            tf.from_float(jnp.asarray(-_G, q.hi.dtype)),
            tf.from_float(self.length),
        )
        return tf.add(tf.mul(coef, s), tf.div(tau, tf.from_float(self.mass)))

    def fd_derivatives_tf(self, q, v, tau):
        """Double-float (a, ∂a/∂q, ∂a/∂v, ∂a/∂τ) — the model's piece of the
        TF-Jacobian solve mode (solver/precise.py derivs_rows_tf), widening
        the derivative sweep itself ≙ the reference evaluating
        d_dynamics_aba at an MPFR scalar (pendulum_model.hpp:116-130 under
        test/pendulum_ddp.cpp:15-17)."""
        del v
        from ddp_jax.ops import twofloat as tf

        dtype = q.hi.dtype
        coef = tf.div(
            tf.from_float(jnp.asarray(-_G, dtype)), tf.from_float(self.length)
        )
        s, c = tf.sincos(q)
        a = tf.add(tf.mul(coef, s), tf.div(tau, tf.from_float(self.mass)))
        A = tf.mul(coef, c)
        A = tf.TF(A.hi[None, :], A.lo[None, :])  # [1, 1]
        z = jnp.zeros((1, 1), dtype)
        Bv = tf.TF(z, z)
        Bu = tf.div(
            tf.from_float(jnp.ones((1, 1), dtype)),
            tf.from_float(self.mass),
        )
        return a, A, Bv, Bu

    def fd_derivatives(self, q: jax.Array, v: jax.Array, tau: jax.Array):
        """(a, ∂a/∂q, ∂a/∂v, ∂a/∂τ) closed-form — the reference's analytic
        d_dynamics_aba (pendulum_model.hpp:116-130), feeding the analytic
        Euler-step Jacobian path (ocp/dynamics.py)."""
        a = self.forward_dynamics(q, v, tau)
        dtype = a.dtype
        A = (-(_G / self.length) * jnp.cos(q))[None, :].astype(dtype)
        Bv = jnp.zeros((1, 1), dtype)
        Bu = (jnp.ones((1, 1), dtype) / self.mass).astype(dtype)
        return a, A, Bv, Bu


def pendulum(mass: float = 1.0, length: float = 1.0, dtype=jnp.float32) -> Pendulum:
    return Pendulum(mass=jnp.asarray(mass, dtype), length=jnp.asarray(length, dtype))
