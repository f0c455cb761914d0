"""Riccati backward pass with augmented-Lagrangian terms.

Reference: ``ddp_solver_t::backward_pass`` (ddp_bwd.ipp:9-155).  The serial
per-timestep reverse sweep becomes one ``lax.scan`` carrying (Vx, Vxx); the
reference's "Cholesky failed → bump μ and reg → restart whole sweep" outer
``while`` (ddp_bwd.ipp:26, 105-132) becomes a bounded ``lax.while_loop``
around the scan.  Everything is written for a single problem instance and is
vmap-able over a batch axis end-to-end.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class BackwardResult(NamedTuple):
    k: jax.Array  # [T, nu]        feedforward gain
    K: jax.Array  # [T, nu, ndx]   feedback gain
    mu: jax.Array  # possibly-escalated AL penalty
    reg: jax.Array  # possibly-escalated regularization
    ok: jax.Array  # bool: final sweep factorized everywhere
    dV: jax.Array  # expected cost decrease Σ kᵀQu (diagnostic)


def _chol_solve(chol, rhs):
    return jax.scipy.linalg.cho_solve((chol, True), rhs)


def factor_solve(A, *rhs):
    """Cholesky-factor A and solve A·x = −rhs for each rhs.

    bf16 inputs factor in f32 ("bf16 storage, f32 factorization" — tensor
    cores accumulate bf16 products in f32 anyway, and neither LAPACK nor the
    GPU solver libraries implement a bf16 Cholesky); results are cast back
    to the working dtype.  Returns (ok, x1, x2, ...)."""
    dtype = A.dtype
    fdtype = jnp.float32 if dtype == jnp.bfloat16 else dtype
    chol = jnp.linalg.cholesky(A.astype(fdtype))
    ok = jnp.all(jnp.isfinite(chol))
    outs = tuple(
        (-_chol_solve(chol, r.astype(fdtype))).astype(dtype) for r in rhs
    )
    return (ok,) + outs


def backward_pass(
    derivs,
    mult_val: jax.Array,  # [T, ne]      pe   (multiplier value at origin = x_t)
    mult_jac: jax.Array,  # [T, ne, ndx] pe_x (zero for constant multipliers)
    mu: jax.Array,
    reg: jax.Array,
    max_retries: int = 24,
) -> BackwardResult:
    T, nu = derivs.lu.shape
    ndx = derivs.lx.shape[1]
    dtype = derivs.lx.dtype
    I_u = jnp.eye(nu, dtype=dtype)

    inputs = (
        derivs.lx, derivs.lu, derivs.lxx, derivs.lux, derivs.luu,
        derivs.fx, derivs.fu, derivs.fxx, derivs.fux, derivs.fuu,
        derivs.eq, derivs.eqx, derivs.equ, derivs.eqxx, derivs.equx, derivs.equu,
        mult_val, mult_jac,
    )  # fmt: skip

    def sweep(mu, reg):
        def step(carry, inp):
            Vx, Vxx = carry
            (lx, lu, lxx, lux, luu, fx, fu, fxx, fux, fuu,
             eqv, eqx, equ, eqxx, equx, equu, pe, pex) = inp  # fmt: skip

            # Q-expansion with AL terms (ddp_bwd.ipp:61-88)
            tmp = pe + mu * eqv  # p + μ·eq
            tmp2 = pex + mu * eqx  # p_x + μ·eq_x
            Qx = lx + fx.T @ Vx + eqx.T @ tmp + pex.T @ eqv
            Qu = lu + fu.T @ Vx + equ.T @ tmp
            Qxx = (
                lxx
                + fx.T @ Vxx @ fx
                + eqx.T @ tmp2
                + pex.T @ eqx
                + jnp.einsum("o,oij->ij", tmp, eqxx)
                + jnp.einsum("o,oij->ij", Vx, fxx)
            )
            Quu = (
                luu
                + fu.T @ Vxx @ fu
                + mu * equ.T @ equ
                + jnp.einsum("o,oij->ij", tmp, equu)
                + jnp.einsum("o,oij->ij", Vx, fuu)
            )
            Qux = (
                lux
                + fu.T @ Vxx @ fx
                + equ.T @ tmp2
                + jnp.einsum("o,oij->ij", tmp, equx)
                + jnp.einsum("o,oij->ij", Vx, fux)
            )

            # Factor Quu + reg·I (ddp_bwd.ipp:102-104).  cholesky returns NaN
            # on non-PD input, which poisons V and flips `ok` — the analog of
            # the reference's break-and-restart.
            ok_t, k, K = factor_solve(Quu + reg * I_u, Qu, Qux)

            # Simplified V-update as in the reference (ddp_bwd.ipp:141-147).
            Vx_new = Qx + Qux.T @ k
            Vxx_new = Qxx + Qux.T @ K
            dV_t = jnp.dot(k, Qu)
            return (Vx_new, Vxx_new), (k, K, ok_t, dV_t)

        # HIGHEST matmul precision: a reduced-precision float32 product
        # (TF32 on the GPU, ~3 decimal digits) injects relative noise per
        # step that compounds through the recursion (docs/DESIGN.md
        # "Reduced-precision matmul passes and the AL gate")
        with jax.default_matmul_precision("highest"):
            (_, _), (ks, Ks, oks, dVs) = jax.lax.scan(
                step, (derivs.lfx, derivs.lfxx), inputs, reverse=True
            )
        return ks, Ks, jnp.all(oks), jnp.sum(dVs)

    ks0, Ks0, ok0, dV0 = sweep(mu, reg)

    def cond(c):
        it, ok, *_ = c
        return jnp.logical_and(~ok, it < max_retries)

    def body(c):
        it, _, mu, reg, _, _, _ = c
        # Escalation rule (ddp_bwd.ipp:105-110): reg = max(reg, mu), then
        # mu *= 2, reg *= 2.
        reg = jnp.maximum(reg, mu) * 2.0
        mu = mu * 2.0
        ks, Ks, ok, dV = sweep(mu, reg)
        return (it + 1, ok, mu, reg, ks, Ks, dV)

    it, ok, mu, reg, ks, Ks, dV = jax.lax.while_loop(
        cond, body, (jnp.asarray(0), ok0, mu, reg, ks0, Ks0, dV0)
    )
    return BackwardResult(k=ks, K=Ks, mu=mu, reg=reg, ok=ok, dV=dV)
