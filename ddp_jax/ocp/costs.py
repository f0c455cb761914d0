"""Stage/terminal cost API.

The reference hard-codes l = ½·c·‖u‖², lf = 0 (problem.hpp:932-942, c default
1e2 at :1147).  Here costs are pluggable pytrees with ``stage(t, x, u)`` and
``terminal(x)``; derivatives are taken by the problem layer with jacfwd in
tangent coordinates, so any differentiable cost works.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ddp_jax.models.base import state_split


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class QuadControlCost:
    """l = ½·c·‖u‖², lf = 0 — the reference's cost (problem.hpp:937-942)."""

    c: jax.Array

    def stage(self, t, x, u):
        del t, x
        return 0.5 * self.c * jnp.sum(u * u)

    def stage_tf(self, t, x, u):
        """Double-float stage cost for the TF-storage solve mode."""
        del t, x
        from ddp_jax.ops import twofloat as tf

        return tf.mul(tf.from_float(0.5 * self.c), tf.sum_(tf.mul(u, u)))

    def grad_tf(self, t, x, u):
        """Double-float (lx [ndx], lu [nu]) for the TF-Jacobian solve mode
        (solver/precise.py derivs_rows_tf).  Vector-space models only
        (ndx = nx): lx ≡ 0, lu = c·u at pair resolution."""
        del t
        from ddp_jax.ops import twofloat as tf

        z = jnp.zeros_like(x.hi)
        lx = tf.TF(z, z)
        lu = tf.mul(tf.from_float(self.c), u)
        return lx, lu

    def terminal(self, x):
        return jnp.zeros((), dtype=x.dtype)

    def terminal_tf(self, x):
        from ddp_jax.ops import twofloat as tf

        z = jnp.zeros((), dtype=x.hi.dtype)
        return tf.TF(z, z)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class QuadTrackingCost:
    """Quadratic state-tracking + control cost (extension over the reference; used for
    unconstrained iLQR where the reference would use an equality constraint).

    l  = ½ (x−x_ref)ᵀ Qdiag (x−x_ref) + ½ u ᵀ Rdiag u
    lf = ½ (x−x_ref)ᵀ Qfdiag (x−x_ref)

    ``x_ref`` comparison is done coordinate-wise (valid for vector-space
    models; manifold models should use a constraint or a difference-based
    cost).
    """

    x_ref: jax.Array
    q_diag: jax.Array
    r_diag: jax.Array
    qf_diag: jax.Array

    def stage(self, t, x, u):
        del t
        e = x - self.x_ref
        return 0.5 * jnp.sum(e * self.q_diag * e) + 0.5 * jnp.sum(u * self.r_diag * u)

    def terminal(self, x):
        e = x - self.x_ref
        return 0.5 * jnp.sum(e * self.qf_diag * e)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ManifoldTrackingCost:
    """Tracking cost measured through the model's manifold difference —
    correct for quaternion-bearing states (extension over the reference).

    l = ½ dq ᵀ Qq dq + ½ dv ᵀ Qv dv + ½ uᵀ R u with (dq, dv) = x ⊖ x_ref.
    """

    model: object
    x_ref: jax.Array
    q_diag: jax.Array
    v_diag: jax.Array
    r_diag: jax.Array
    terminal_scale: jax.Array

    def _state_err(self, x):
        from ddp_jax.models.base import state_difference

        return state_difference(self.model, self.x_ref, x)

    def stage(self, t, x, u):
        del t
        e = self._state_err(x)
        nv = self.model.nv
        dq, dv = e[:nv], e[nv:]
        return (
            0.5 * jnp.sum(dq * self.q_diag * dq)
            + 0.5 * jnp.sum(dv * self.v_diag * dv)
            + 0.5 * jnp.sum(u * self.r_diag * u)
        )

    def terminal(self, x):
        e = self._state_err(x)
        nv = self.model.nv
        dq, dv = e[:nv], e[nv:]
        return self.terminal_scale * (
            0.5 * jnp.sum(dq * self.q_diag * dq) + 0.5 * jnp.sum(dv * self.v_diag * dv)
        )


def quad_control(c: float = 1.0, dtype=jnp.float32) -> QuadControlCost:
    return QuadControlCost(c=jnp.asarray(c, dtype))
