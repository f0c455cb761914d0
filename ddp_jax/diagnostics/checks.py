"""Derivative self-verification and NaN guarding.

≙ the reference's debug-build Taylor check embedded in compute_derivatives
(problem.hpp:999-1139) — here an opt-in utility instead of a compiled-in
assert, with float64 as the oracle, and the NaN-poisoning/assert machinery
(mat_seq.hpp:36, assertions.hpp) mapped to jax_debug_nans + explicit guards.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ddp_jax.models.base import state_difference, state_integrate


class DerivCheckReport(NamedTuple):
    f_first_order: jax.Array  # max over t of ‖df − fx dx − fu du‖/‖df‖
    f_second_order: jax.Array  # max over t of residual after Hessian terms
    eq_first_order: jax.Array
    l_first_order: jax.Array
    ok: jax.Array


def check_derivatives(problem, xs, us, eps: float = 1e-6, key=None) -> DerivCheckReport:
    """Taylor-verify the jacfwd derivative engine along a trajectory.

    For random tangent perturbations of size eps, first-order residuals must
    be O(eps²) and (with second_order) the Hessian-corrected residual O(eps³).
    """
    if key is None:
        key = jax.random.key(0)
    derivs = problem.derivatives(xs, us)
    model = problem.model
    T = problem.horizon
    kx, ku = jax.random.split(key)
    dxs = eps * jax.random.normal(kx, (T, problem.ndx), dtype=xs.dtype)
    dus = eps * jax.random.normal(ku, (T, problem.nu), dtype=xs.dtype)
    ts = jnp.arange(T)
    mask = jnp.asarray(problem.eq_mask(), dtype=xs.dtype)

    def per_t(t, x, u, dx, du, fx, fu, fxx, fux, fuu, eqx, equ, lx, lu, m):
        xp = state_integrate(model, x, dx)
        up = u + du
        df = state_difference(model, problem.f(t, x, u), problem.f(t, xp, up))
        lin = fx @ dx + fu @ du
        quad = 0.5 * (
            jnp.einsum("oij,i,j->o", fxx, dx, dx)
            + 2.0 * jnp.einsum("oij,i,j->o", fux, du, dx)
            + jnp.einsum("oij,i,j->o", fuu, du, du)
        )
        nf = jnp.maximum(jnp.linalg.norm(df), 1e-30)
        r1 = jnp.linalg.norm(df - lin) / nf
        r2 = jnp.linalg.norm(df - lin - quad) / nf
        deq = (problem.eq(t, xp, up) - problem.eq(t, x, u)) * m
        req = jnp.linalg.norm(deq - (eqx @ dx + equ @ du)) / jnp.maximum(
            jnp.linalg.norm(deq), 1e-30
        )
        dl = problem.l(t, xp, up) - problem.l(t, x, u)
        rl = jnp.abs(dl - lx @ dx - lu @ du) / jnp.maximum(jnp.abs(dl), 1e-30)
        return r1, r2, req, rl

    r1, r2, req, rl = jax.vmap(per_t)(
        ts, xs[:-1], us, dxs, dus,
        derivs.fx, derivs.fu, derivs.fxx, derivs.fux, derivs.fuu,
        derivs.eqx, derivs.equ, derivs.lx, derivs.lu, mask,
    )  # fmt: skip
    tol1 = jnp.asarray(100.0 * eps, xs.dtype)
    report = DerivCheckReport(
        f_first_order=jnp.max(r1),
        f_second_order=jnp.max(r2),
        eq_first_order=jnp.max(req),
        l_first_order=jnp.max(rl),
        ok=jnp.max(r1) < tol1,
    )
    return report


def assert_finite(tree, name: str = "tree") -> None:
    """Eager NaN/Inf guard (≙ the pervasive hasNaN asserts,
    pinocchio_model.ipp:227-232)."""
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        arr = jnp.asarray(leaf)
        if not bool(jnp.all(jnp.isfinite(arr))):
            raise FloatingPointError(
                f"non-finite values in {name}{jax.tree_util.keystr(path)}"
            )


def nan_debug_mode(enable: bool = True) -> None:
    """Globally trap NaN production (the sanitizer-mode analog,
    SURVEY.md §5: jit-disabled + NaN-debug plays the ASan/UBSan role)."""
    jax.config.update("jax_debug_nans", enable)
