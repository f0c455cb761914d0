"""Pallas (Triton route) kernel: batched small-dimension Riccati backward sweep.

The hot op of the batched pendulum-class workload.  XLA's vmapped scan
launches several small kernels per time step on tiny [B, n, m] data, which is
latency-bound.  This kernel instead:

- gives every batch sample its own GPU thread: every stacked array is
  [T, rows, B] with the batch as the contiguous axis, so each tiny-matrix
  element is one coalesced [block_b] load and one register per thread
- runs the whole reverse time loop INSIDE one kernel (fori_loop), carrying
  (Vx, Vxx) and the per-sample ``ok`` flag in the loop carry (registers);
  inputs stream from device memory one step at a time, so nothing has to
  fit in fast memory and any horizon is one launch
- unrolls the n/m/e index algebra in Python at trace time (static small
  dims), including an unrolled Cholesky–Banachiewicz factorization and
  triangular solves for Quu

Gauss-Newton form (no dynamics Hessians) with AL multiplier terms — the
throughput path's math (solver/batched.py::_backward_sweep with
fxx=fux=fuu=0); ``second_order`` adds the full-DDP rank-3 contraction terms.
Exactness vs the XLA path is pinned by tests.

Grid: one program per batch block of ``block_b`` samples (a power of two, as
the Triton route requires of every load and store; B is padded up to it).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

# Hopper has 132 SMs: below this many programs some sit idle
_TARGET_PROGRAMS = 132


def lane_block(n: int, max_block: int = 128, min_block: int = 32) -> int:
    """Power-of-two batch block for ``n`` samples: the widest block (one
    sample per thread, so ``block // 32`` warps) that still yields enough
    programs to fill the card's SMs, never narrower than one warp."""
    blk = max_block
    while blk > min_block and -(-n // blk) < _TARGET_PROGRAMS:
        blk //= 2
    return blk


def check_block(block_b: int) -> None:
    if block_b < 1 or block_b & (block_b - 1):
        raise ValueError(
            f"block_b={block_b}: the Triton route needs a power-of-two block"
        )


def triton_params(block_b: int):
    """One sample per thread: a warp per 32 samples of the block."""
    return pltriton.CompilerParams(num_warps=max(1, block_b // 32), num_stages=1)


def pad_lanes(x, block_b: int):
    """Pad the last (batch) axis up to a multiple of ``block_b`` by repeating
    the last sample, so padded lanes compute finite values."""
    pad = -x.shape[-1] % block_b
    if not pad:
        return x
    return jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)], mode="edge")


def _chol_solve_unrolled(A, rhs_list, m, reg):
    """Factor A (+reg·I) ∈ sym[m,m] given as nested [B]-vector lists and
    solve for each rhs in rhs_list (each a length-m list of [B]-vectors).

    Unrolled Cholesky–Banachiewicz + forward/back substitution; every
    statement is one elementwise op over the batch block."""
    L = [[None] * m for _ in range(m)]
    for i in range(m):
        for j in range(i + 1):
            s = A[i][j] + (reg if i == j else 0.0)
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = jnp.sqrt(s)
            else:
                L[i][j] = s / L[j][j]
    outs = []
    for rhs in rhs_list:
        # forward: L y = rhs
        y = [None] * m
        for i in range(m):
            s = rhs[i]
            for k in range(i):
                s = s - L[i][k] * y[k]
            y[i] = s / L[i][i]
        # backward: Lᵀ x = y
        x = [None] * m
        for i in reversed(range(m)):
            s = y[i]
            for k in range(i + 1, m):
                s = s - L[k][i] * x[k]
            x[i] = s / L[i][i]
        outs.append(x)
    return outs, L


def _bwd_kernel(
    # refs: [T, rows, block_b] stacked derivative blocks (see caller
    # ordering); with second_order=True six tensor blocks (fxx … equu)
    # follow lfxx; then the outputs k, K, ok
    *args,
    T, n, m, e, second_order,
):  # fmt: skip
    (lx_ref, lu_ref, lxx_ref, lux_ref, luu_ref,
     fx_ref, fu_ref,
     eq_ref, eqx_ref, equ_ref, pe_ref, pex_ref,
     mu_ref, reg_ref, lfx_ref, lfxx_ref) = args[:16]  # fmt: skip
    rest = args[16:]
    if second_order:
        fxx_ref, fux_ref, fuu_ref, eqxx_ref, equx_ref, equu_ref = rest[:6]
        rest = rest[6:]
    k_out, K_out, ok_out = rest
    mu = mu_ref[0, :]
    reg = reg_ref[0, :]

    def at(ref, t, idx):
        return ref[t, idx, :]

    def body(step, carry):
        Vx, Vxx, ok = carry
        t = T - 1 - step
        # load blocks as nested lists of [block_b] vectors
        lx = [at(lx_ref, t, i) for i in range(n)]
        lu = [at(lu_ref, t, i) for i in range(m)]
        lxx = [[at(lxx_ref, t, i * n + j) for j in range(n)] for i in range(n)]
        lux = [[at(lux_ref, t, i * n + j) for j in range(n)] for i in range(m)]
        luu = [[at(luu_ref, t, i * m + j) for j in range(m)] for i in range(m)]
        fx = [[at(fx_ref, t, i * n + j) for j in range(n)] for i in range(n)]
        fu = [[at(fu_ref, t, i * m + j) for j in range(m)] for i in range(n)]
        eq = [at(eq_ref, t, i) for i in range(e)]
        eqx = [[at(eqx_ref, t, i * n + j) for j in range(n)] for i in range(e)]
        equ = [[at(equ_ref, t, i * m + j) for j in range(m)] for i in range(e)]
        pe = [at(pe_ref, t, i) for i in range(e)]
        pex = [[at(pex_ref, t, i * n + j) for j in range(n)] for i in range(e)]
        Vxx = [list(Vxx[i * n : (i + 1) * n]) for i in range(n)]

        tmp = [pe[a] + mu * eq[a] for a in range(e)]
        tmp2 = [[pex[a][j] + mu * eqx[a][j] for j in range(n)] for a in range(e)]

        # Qx = lx + fxᵀVx + eqxᵀtmp + pexᵀeq
        Qx = []
        for i in range(n):
            s = lx[i]
            for o in range(n):
                s = s + fx[o][i] * Vx[o]
            for a in range(e):
                s = s + eqx[a][i] * tmp[a] + pex[a][i] * eq[a]
            Qx.append(s)
        # Qu = lu + fuᵀVx + equᵀtmp
        Qu = []
        for i in range(m):
            s = lu[i]
            for o in range(n):
                s = s + fu[o][i] * Vx[o]
            for a in range(e):
                s = s + equ[a][i] * tmp[a]
            Qu.append(s)
        # Vxx·fx cache: (Vxx @ fx)[o][j]
        Vfx = [[None] * n for _ in range(n)]
        for o in range(n):
            for j in range(n):
                s = Vxx[o][0] * fx[0][j]
                for r in range(1, n):
                    s = s + Vxx[o][r] * fx[r][j]
                Vfx[o][j] = s
        Vfu = [[None] * m for _ in range(n)]
        for o in range(n):
            for j in range(m):
                s = Vxx[o][0] * fu[0][j]
                for r in range(1, n):
                    s = s + Vxx[o][r] * fu[r][j]
                Vfu[o][j] = s
        # Qxx = lxx + fxᵀ(Vxx fx) + eqxᵀtmp2 + pexᵀeqx [+ Vx·fxx + tmp·eqxx]
        Qxx = [[None] * n for _ in range(n)]
        for i in range(n):
            for j in range(n):
                s = lxx[i][j]
                for o in range(n):
                    s = s + fx[o][i] * Vfx[o][j]
                for a in range(e):
                    s = s + eqx[a][i] * tmp2[a][j] + pex[a][i] * eqx[a][j]
                if second_order:
                    for o in range(n):
                        s = s + Vx[o] * at(fxx_ref, t, (o * n + i) * n + j)
                    for a in range(e):
                        s = s + tmp[a] * at(eqxx_ref, t, (a * n + i) * n + j)
                Qxx[i][j] = s
        # Quu = luu + fuᵀ(Vxx fu) + μ·equᵀequ [+ Vx·fuu + tmp·equu]
        Quu = [[None] * m for _ in range(m)]
        for i in range(m):
            for j in range(m):
                s = luu[i][j]
                for o in range(n):
                    s = s + fu[o][i] * Vfu[o][j]
                for a in range(e):
                    s = s + mu * equ[a][i] * equ[a][j]
                if second_order:
                    for o in range(n):
                        s = s + Vx[o] * at(fuu_ref, t, (o * m + i) * m + j)
                    for a in range(e):
                        s = s + tmp[a] * at(equu_ref, t, (a * m + i) * m + j)
                Quu[i][j] = s
        # Qux = lux + fuᵀ(Vxx fx) + equᵀtmp2 [+ Vx·fux + tmp·equx]
        Qux = [[None] * n for _ in range(m)]
        for i in range(m):
            for j in range(n):
                s = lux[i][j]
                for o in range(n):
                    s = s + fu[o][i] * Vfx[o][j]
                for a in range(e):
                    s = s + equ[a][i] * tmp2[a][j]
                if second_order:
                    for o in range(n):
                        s = s + Vx[o] * at(fux_ref, t, (o * m + i) * n + j)
                    for a in range(e):
                        s = s + tmp[a] * at(equx_ref, t, (a * m + i) * n + j)
                Qux[i][j] = s

        # factor Quu + reg·I, solve for k and K columns
        rhss = [Qu] + [[Qux[i][j] for i in range(m)] for j in range(n)]
        sols, L = _chol_solve_unrolled(Quu, rhss, m, reg)
        k_sol = sols[0]
        K_cols = sols[1:]  # K_cols[j][i] = (Quu⁻¹Qux)[i][j]

        # per-sample success flag: each sample fails independently (reducing
        # over the block here would let one bad sample poison its whole
        # block).  Carried as a float 0/1 mask.
        ok_t = ok
        for i in range(m):
            good = jnp.logical_and(L[i][i] > 0.0, jnp.isfinite(L[i][i]))
            ok_t = ok_t * jnp.where(good, 1.0, 0.0).astype(ok.dtype)

        for i in range(m):
            k_out[t, i, :] = -k_sol[i]
            for j in range(n):
                K_out[t, i * n + j, :] = -K_cols[j][i]

        # V updates: Vx' = Qx − Quxᵀ(Quu⁻¹Qu); Vxx' = Qxx − Quxᵀ(Quu⁻¹Qux)
        Vx_new = []
        for i in range(n):
            s = Qx[i]
            for o in range(m):
                s = s - Qux[o][i] * k_sol[o]
            Vx_new.append(s)
        Vxx_new = []
        for i in range(n):
            for j in range(n):
                s = Qxx[i][j]
                for o in range(m):
                    s = s - Qux[o][i] * K_cols[j][o]
                Vxx_new.append(s)
        return tuple(Vx_new), tuple(Vxx_new), ok_t

    Vx0 = tuple(lfx_ref[i, :] for i in range(n))
    Vxx0 = tuple(lfxx_ref[i, :] for i in range(n * n))
    ok0 = jnp.ones_like(mu)  # [block_b] per-sample float 0/1 mask
    _, _, ok = jax.lax.fori_loop(0, T, body, (Vx0, Vxx0, ok0))
    ok_out[0, :] = ok


def backward_sweep_pallas(
    derivs_bl: dict,
    mu: jax.Array,  # [B]
    reg: jax.Array,  # [B]
    *,
    T: int,
    n: int,
    m: int,
    e: int,
    block_b: int | None = None,
    interpret: bool = False,
):
    """Run the batched backward sweep with the batch as the contiguous axis.

    ``derivs_bl`` maps names → arrays shaped [T, rows, B] (matrices
    flattened row-major into the middle axis):
      lx [T,n,B], lu [T,m,B], lxx [T,n*n,B], lux [T,m*n,B], luu [T,m*m,B],
      fx [T,n*n,B], fu [T,n*m,B], eq [T,e,B], eqx [T,e*n,B], equ [T,e*m,B],
      pe [T,e,B], pex [T,e*n,B], lfx [n,B], lfxx [n*n,B];
      with second_order also fxx [T,n*n*n,B], fux [T,n*m*n,B],
      fuu [T,n*m*m,B], eqxx [T,e*n*n,B], equx [T,e*m*n,B], equu [T,e*m*m,B]
      (full-DDP tensor terms, ≙ the reference's rank-3 contractions,
      ddp_bwd.ipp:74-87 via tensor.hpp:179-235).

    ``block_b`` (a power of two; default ``lane_block(B)``) is the number of
    samples per program; B is padded up to a multiple of it.

    Returns (k [T,m,B], K [T,m*n,B], ok [B]).
    """
    B = derivs_bl["lx"].shape[-1]
    dtype = derivs_bl["lx"].dtype
    if block_b is None:
        block_b = lane_block(B)
    check_block(block_b)
    second_order = "fxx" in derivs_bl
    Bp = B + (-B % block_b)

    def bs(rows, with_t=True):
        if with_t:
            return pl.BlockSpec((T, rows, block_b), lambda i: (0, 0, i))
        return pl.BlockSpec((rows, block_b), lambda i: (0, i))

    in_specs = [
        bs(n), bs(m), bs(n * n), bs(m * n), bs(m * m),
        bs(n * n), bs(n * m),
        bs(e), bs(e * n), bs(e * m), bs(e), bs(e * n),
        bs(1, with_t=False), bs(1, with_t=False),
        bs(n, with_t=False), bs(n * n, with_t=False),
    ]  # fmt: skip
    names = ["lx", "lu", "lxx", "lux", "luu", "fx", "fu",
             "eq", "eqx", "equ", "pe", "pex"]  # fmt: skip
    inputs = [derivs_bl[k_] for k_ in names] + [
        mu[None, :], reg[None, :], derivs_bl["lfx"], derivs_bl["lfxx"],
    ]  # fmt: skip
    if second_order:
        in_specs += [
            bs(n * n * n), bs(n * m * n), bs(n * m * m),
            bs(e * n * n), bs(e * m * n), bs(e * m * m),
        ]  # fmt: skip
        inputs += [derivs_bl[k_] for k_ in ("fxx", "fux", "fuu", "eqxx", "equx", "equu")]
    inputs = [pad_lanes(x, block_b) for x in inputs]
    out_specs = (bs(m), bs(m * n), bs(1, with_t=False))
    out_shape = (
        jax.ShapeDtypeStruct((T, m, Bp), dtype),
        jax.ShapeDtypeStruct((T, m * n, Bp), dtype),
        jax.ShapeDtypeStruct((1, Bp), dtype),
    )
    kernel = functools.partial(
        _bwd_kernel, T=T, n=n, m=m, e=e, second_order=second_order
    )
    k, K, ok = pl.pallas_call(
        kernel,
        grid=(Bp // block_b,),
        in_specs=in_specs,
        out_specs=out_specs,
        out_shape=out_shape,
        compiler_params=triton_params(block_b),
        interpret=interpret,
        name="riccati_backward",
    )(*inputs)
    return k[..., :B], K[..., :B], ok[0, :B] > 0.5


def pack_batch_last(derivs, mult_val, mult_jac, second_order: bool = False):
    """[B, T, …] solver-layout Derivs → the kernel's [T, rows, B] dict.

    With ``second_order`` the six rank-3 tensor blocks ride along for the
    full-DDP kernel path."""

    def mv(x, rows):
        # [B, T, ...] → [T, rows, B]
        b = x.shape[0]
        t = x.shape[1]
        return jnp.transpose(x.reshape(b, t, rows), (1, 2, 0))

    def mv_const(x, rows):
        # [B, ...] → [rows, B]
        return jnp.transpose(x.reshape(x.shape[0], rows), (1, 0))

    n = derivs.lx.shape[-1]
    m = derivs.lu.shape[-1]
    e = derivs.eq.shape[-1]
    out = dict(
        lx=mv(derivs.lx, n), lu=mv(derivs.lu, m),
        lxx=mv(derivs.lxx, n * n), lux=mv(derivs.lux, m * n), luu=mv(derivs.luu, m * m),
        fx=mv(derivs.fx, n * n), fu=mv(derivs.fu, n * m),
        eq=mv(derivs.eq, e), eqx=mv(derivs.eqx, e * n), equ=mv(derivs.equ, e * m),
        pe=mv(mult_val, e), pex=mv(mult_jac, e * n),
        lfx=mv_const(derivs.lfx, n), lfxx=mv_const(derivs.lfxx, n * n),
    )  # fmt: skip
    if second_order:
        out.update(
            fxx=mv(derivs.fxx, n * n * n), fux=mv(derivs.fux, n * m * n),
            fuu=mv(derivs.fuu, n * m * m),
            eqxx=mv(derivs.eqxx, e * n * n), equx=mv(derivs.equx, e * m * n),
            equu=mv(derivs.equu, e * m * m),
        )  # fmt: skip
    return out
