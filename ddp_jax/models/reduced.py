"""Mimic-joint (gear/linkage) reduction: a reduced-coordinate model wrapper.

URDF ``<mimic joint="master" multiplier="c" offset="o"/>`` declares a joint
whose position is slaved to another: q_mimic = c·q_master + o (urdfdom's
JointMimic, which the reference's ingestion path pinocchio_model.ipp:98-113
understands).  The batched-accelerator treatment is *reduction*: keep the full model
for the kinematics/dynamics kernels and expose the independent (master)
coordinates as the model surface, related by a constant linear coupling

    q_full = C · q_red + d,      v_full = C · v_red.

Classical constrained-dynamics projection (Jourdain/gear reduction):

    M_red(q)   = Cᵀ M_full(q_full) C
    τ_full→red = Cᵀ τ  (power conservation: τ_redᵀ v_red = τ_fullᵀ v_full)
    FD:  a_red  = M_red⁻¹ (τ_red − Cᵀ rnea_full(q_full, C v_red, 0))
    ID:  τ_red  = Cᵀ rnea_full(q_full, C v_red, C a_red)

Scope: every joint in the model must be 1-DoF with vector-space
configuration (revolute / prismatic) — the gripper/linkage case mimic
exists for.  load_urdf raises otherwise.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ReducedModel:
    """Reduced-coordinate wrapper over a RobotModel with slaved joints."""

    full: object  # RobotModel (all joints revolute/prismatic)
    coupling: jax.Array  # C [nv_full, nv_red]
    offset: jax.Array  # d [nq_full]

    # ---- dims ----
    @property
    def nb(self) -> int:
        return self.full.nb

    @property
    def nq(self) -> int:
        return self.coupling.shape[1]

    @property
    def nv(self) -> int:
        return self.coupling.shape[1]

    @property
    def nu(self) -> int:
        return self.nv

    @property
    def dtype(self):
        return self.full.dtype

    @property
    def name(self) -> str:
        return self.full.name

    @property
    def frame_names(self):
        return self.full.frame_names

    # ---- coordinate maps ----
    def q_full(self, q: jax.Array) -> jax.Array:
        return self.coupling @ q + self.offset

    def v_full(self, v: jax.Array) -> jax.Array:
        return self.coupling @ v

    # ---- configuration space (vector space by construction) ----
    def neutral_configuration(self) -> jax.Array:
        return jnp.zeros((self.nq,), self.dtype)

    def random_configuration(self, key: jax.Array) -> jax.Array:
        return 0.5 * jax.random.normal(key, (self.nq,), self.dtype)

    def integrate(self, q: jax.Array, dq: jax.Array) -> jax.Array:
        return q + dq

    def difference(self, q0: jax.Array, q1: jax.Array) -> jax.Array:
        return q1 - q0

    # ---- frames ----
    def frame_position(self, frame_id: int, q: jax.Array) -> jax.Array:
        return self.full.frame_position(frame_id, self.q_full(q))

    # ---- dynamics (projected) ----
    def mass_matrix(self, q: jax.Array) -> jax.Array:
        C = self.coupling
        return C.T @ self.full.mass_matrix(self.q_full(q)) @ C

    def rnea(self, q: jax.Array, v: jax.Array, a: jax.Array) -> jax.Array:
        C = self.coupling
        return C.T @ self.full.rnea(self.q_full(q), C @ v, C @ a)

    def forward_dynamics(self, q: jax.Array, v: jax.Array, tau: jax.Array) -> jax.Array:
        C = self.coupling
        qf, vf = self.q_full(q), C @ v
        bias = C.T @ self.full.rnea(qf, vf, jnp.zeros_like(vf))
        M_red = C.T @ self.full.mass_matrix(qf) @ C
        return jnp.linalg.solve(M_red, tau - bias)

    # ---- limits (master selection) ----
    @property
    def q_lower(self):
        return self._select_limit(self.full.q_lower)

    @property
    def q_upper(self):
        return self._select_limit(self.full.q_upper)

    @property
    def v_limit(self):
        return self._select_limit(self.full.v_limit)

    @property
    def tau_limit(self):
        return self._select_limit(self.full.tau_limit)

    def _select_limit(self, lim):
        if lim is None:
            return None
        # master column k owns exactly one unit row; pick that row's limit
        C = jnp.abs(self.coupling)
        idx = jnp.argmax(C == 1.0, axis=0)
        return lim[idx]


def reduce_mimic(full, masters: list[int], mimic: dict[int, tuple[int, float, float]]):
    """Build a ReducedModel.

    ``masters``: full-model joint indices that stay independent (order
    defines the reduced layout).  ``mimic``: full_idx → (master_full_idx,
    multiplier, offset).  All joints must be 1-DoF vector-space.
    """
    import numpy as np

    for t in full.joint_types:
        if t not in ("revolute", "prismatic"):
            raise ValueError(
                f"mimic reduction needs all joints revolute/prismatic, got {t}"
            )
    nvf, nvr = full.nv, len(masters)
    col = {m: k for k, m in enumerate(masters)}
    C = np.zeros((nvf, nvr))
    d = np.zeros(nvf)
    for m, k in col.items():
        C[m, k] = 1.0
    for j, (m, mult, off) in mimic.items():
        C[j, col[m]] = mult
        d[j] = off
    dtype = full.dtype
    return ReducedModel(
        full=full, coupling=jnp.asarray(C, dtype), offset=jnp.asarray(d, dtype)
    )
