"""Double-float (error-free compensated pair) arithmetic.

The reference's multiprecision story is MPFR 500/1000-digit scalars threaded
through the whole template stack (SURVEY.md §2 #30; test/pinocchio_mpfr_500
.cpp, test/pendulum_ddp.cpp:15-17) — its tests use 1000-digit floats as the
derivative oracle.  There is no MPFR on an accelerator, and f32 is the fast
dtype; the extended-precision primitive here is the **double-float**: an unevaluated
pair (hi, lo) of f32 giving ~48 mantissa bits (or f64 pairs on CPU giving
~106), built from Dekker/Knuth error-free transformations that are all plain
elementwise add/mul — they vmap, jit, and run inside Pallas kernels unchanged.

This module provides the pair type and the operations the solver stack
needs: +, −, ×, ÷, sqrt, fused dot/sum reductions.  diagnostics and tests
use it as an on-device oracle (f32 pipeline vs twofloat reference) the same
way the reference uses MPFR against double.

Algorithms: Knuth two_sum, Dekker split/two_prod (f32 split at 2^12+1, f64 at
2^27+1), Bailey/Hida double-double add/mul/div/sqrt (QD library operation
set, public domain algorithms).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class TF(NamedTuple):
    """Unevaluated sum hi + lo with |lo| ≤ ulp(hi)/2.  A pytree: vmap/jit/
    scan/Pallas all treat it as two ordinary arrays."""

    hi: jax.Array
    lo: jax.Array


def _split_const(dtype) -> float:
    # Dekker splitter: 2^ceil(p/2) + 1 for p mantissa bits.  Only f32/f64
    # are supported — for bf16/f16 the f64 splitter would silently destroy
    # the error terms instead of widening precision.
    dt = jnp.dtype(dtype)
    if dt == jnp.float32:
        return float(2**12 + 1)
    if dt == jnp.float64:
        return float(2**27 + 1)
    raise TypeError(f"twofloat arithmetic supports f32/f64 only, got {dt}")


def two_sum(a, b):
    """Error-free a + b = s + e (Knuth)."""
    s = a + b
    v = s - a
    e = (a - (s - v)) + (b - v)
    return s, e


def quick_two_sum(a, b):
    """Error-free a + b = s + e assuming |a| ≥ |b| (Dekker)."""
    s = a + b
    e = b - (s - a)
    return s, e


def two_prod(a, b):
    """Error-free a · b = p + e (Dekker split; no FMA assumed)."""
    p = a * b
    c = _split_const(jnp.result_type(a, b))
    aa = a * c
    a_hi = aa - (aa - a)
    a_lo = a - a_hi
    bb = b * c
    b_hi = bb - (bb - b)
    b_lo = b - b_hi
    e = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, e


def from_float(x) -> TF:
    x = jnp.asarray(x)
    return TF(x, jnp.zeros_like(x))


def to_float(x: TF):
    return x.hi + x.lo


def neg(x: TF) -> TF:
    return TF(-x.hi, -x.lo)


def add(x: TF, y: TF) -> TF:
    s, e = two_sum(x.hi, y.hi)
    e = e + x.lo + y.lo
    s, e = quick_two_sum(s, e)
    return TF(s, e)


def sub(x: TF, y: TF) -> TF:
    return add(x, neg(y))


def mul(x: TF, y: TF) -> TF:
    p, e = two_prod(x.hi, y.hi)
    e = e + x.hi * y.lo + x.lo * y.hi
    p, e = quick_two_sum(p, e)
    return TF(p, e)


def div(x: TF, y: TF) -> TF:
    q1 = x.hi / y.hi
    r = sub(x, mul(from_float(q1), y))
    q2 = r.hi / y.hi
    r = sub(r, mul(from_float(q2), y))
    q3 = r.hi / y.hi
    s, e = quick_two_sum(q1, q2)
    return add(TF(s, e), from_float(q3))


def sqrt(x: TF) -> TF:
    """One Newton refinement of the f32 sqrt (Karp's trick)."""
    a = jnp.sqrt(x.hi)
    # r = (x − a²) / (2a);  sqrt ≈ a + r.  Guard a == 0: the correction is
    # 0/0 there (QD special-cases x == 0), and the guarded denominator also
    # keeps NaN out of the unused jvp/vjp branch.
    a2 = mul(from_float(a), from_float(a))
    r = sub(x, a2)
    denom = jnp.where(a == 0.0, jnp.ones_like(a), 2.0 * a)
    corr = jnp.where(a == 0.0, jnp.zeros_like(a), r.hi / denom)
    s, e = quick_two_sum(a, corr)
    return TF(s, e)


def scale(x: TF, c) -> TF:
    """x · c for an exact (power-of-two or plain float) scalar c."""
    return mul(x, from_float(jnp.asarray(c, x.hi.dtype)))


def sum_(x: TF, axis=None) -> TF:
    """Compensated reduction of a TF array along ``axis``."""

    def body(acc, pair):
        return add(acc, TF(*pair)), None

    if axis is None:
        flat = TF(jnp.ravel(x.hi), jnp.ravel(x.lo))
        zero = TF(jnp.zeros((), x.hi.dtype), jnp.zeros((), x.hi.dtype))
        acc, _ = jax.lax.scan(body, zero, (flat.hi, flat.lo))
        return acc
    hi = jnp.moveaxis(x.hi, axis, 0)
    lo = jnp.moveaxis(x.lo, axis, 0)
    zero = TF(jnp.zeros(hi.shape[1:], hi.dtype), jnp.zeros(hi.shape[1:], hi.dtype))
    acc, _ = jax.lax.scan(body, zero, (hi, lo))
    return acc


def dot(a, b) -> TF:
    """Compensated inner product of two plain-float vectors: exact products,
    compensated accumulation (≈ twice the working precision — the classic
    'dot2' kernel)."""
    p, e = two_prod(a, b)
    return sum_(TF(p, e))


def mv(A, x) -> TF:
    """Compensated matrix-vector product [m,n]·[n] → TF [m]."""
    p, e = two_prod(A, x[None, :])
    return sum_(TF(p, e), axis=1)


def tT(x: TF) -> TF:
    """Transpose of a TF matrix (exact)."""
    return TF(x.hi.T, x.lo.T)


def matvec(A: TF, x: TF) -> TF:
    """TF matrix · TF vector: [m,n]·[n] → [m], compensated accumulation."""
    p = mul(A, TF(x.hi[None, :], x.lo[None, :]))
    return sum_(p, axis=1)


def matmat(A: TF, B: TF) -> TF:
    """TF matrix · TF matrix: [m,k]·[k,n] → [m,n], compensated accumulation.
    Materializes the [m,k,n] product tensor — small-dims use only."""
    p = mul(
        TF(A.hi[:, :, None], A.lo[:, :, None]),
        TF(B.hi[None, :, :], B.lo[None, :, :]),
    )
    return sum_(p, axis=1)


def contract0(v: TF, T3: TF) -> TF:
    """Σ_o v_o · T3[o, :, :] — the backward pass's rank-3 contraction
    (≙ tensor.hpp:179-235 noalias_contract_add_outdim) in TF."""
    p = mul(TF(v.hi[:, None, None], v.lo[:, None, None]), T3)
    return sum_(p, axis=0)


# ---------------------------------------------------------------------------
# elementary functions: TF-accurate sin/cos
# ---------------------------------------------------------------------------
# Needed by the TF-storage solve mode (solver/precise.py): a TF trajectory is
# useless if the dynamics round its configuration through a working-precision
# sin.  Strategy: Cody–Waite range reduction with a 3-term π/2 cascade (each
# product error-free), then a TF-Horner Taylor series on |y| ≤ π/4.
#
# Accuracy: with f32 pairs (~2^-48 pair resolution) the series truncation
# (~1e-16 relative at π/4 with the terms below) and the reduction cascade
# (~|k|·2^-70) are both below pair resolution — full TF accuracy.  With f64
# pairs the same truncation bounds mean plain-f64-level accuracy (not the
# full 2^-106 pair resolution); every floor the solver chases is far above
# either.  Arguments are assumed |x| ≲ 1e4 (robot configurations), keeping
# the reduction multiple k f32-exact.

# π/2 = c0 + c1 + c2 cascades generated from 60-digit mpmath π/2 (NOT from
# float64(π/2), whose ~2^-54 truncation would cap the f32 cascade at
# ~|k|·2^-57).  Residual after 3 terms: 6.7e-24 (f32 cascade),
# 3.5e-50 (f64) relative — both below the ~|k|·2^-70 reduction claim.
_PI2_CASCADE = {
    "float32": (1.5707963705062866, -4.371138828673793e-08,
                -1.7151245100058819e-15),
    "float64": (1.5707963267948966, 6.123233995736766e-17,
                -1.4973849048591698e-33),
}


def _pi2_terms(dtype):
    """π/2 = c0 + c1 + c2 as a cascade of ``dtype`` floats (c0 the rounded
    head, c1 the rounded head of the remainder, c2 the rest), exact against
    true π/2 to the cascade residual above."""
    import numpy as np

    name = np.dtype(dtype).name
    if name in _PI2_CASCADE:
        return _PI2_CASCADE[name]
    # other dtypes (e.g. bfloat16 pairs): build from float64 π/2 — the f64
    # truncation floor (~2^-54) is far below their pair resolution anyway
    pi2 = np.float64(np.pi / 2)
    c0 = np.asarray(pi2, dtype)
    c1 = np.asarray(pi2 - np.float64(c0), dtype)
    c2 = np.asarray(pi2 - np.float64(c0) - np.float64(c1), dtype)
    return float(c0), float(c1), float(c2)


def _poly_tf(y2: TF, coeffs) -> TF:
    """TF-Horner Σ c_i · y2^i with each f64 coefficient split hi/lo."""
    dtype = y2.hi.dtype
    import numpy as np

    def c_tf(c):
        hi = np.asarray(c, dtype)
        lo = np.asarray(np.float64(c) - np.float64(hi), dtype)
        return TF(jnp.full_like(y2.hi, float(hi)), jnp.full_like(y2.hi, float(lo)))

    acc = c_tf(coeffs[-1])
    for c in reversed(coeffs[:-1]):
        acc = add(mul(acc, y2), c_tf(c))
    return acc


# 1/(2k+1)! for sin·y·P(y²), 1/(2k)! for cos·P(y²), |y| ≤ π/4
_SIN_COEFFS = [
    1.0, -1.0 / 6, 1.0 / 120, -1.0 / 5040, 1.0 / 362880,
    -1.0 / 39916800, 1.0 / 6227020800, -1.0 / 1307674368000,
    1.0 / 355687428096000,
]  # fmt: skip
_COS_COEFFS = [
    1.0, -0.5, 1.0 / 24, -1.0 / 720, 1.0 / 40320, -1.0 / 3628800,
    1.0 / 479001600, -1.0 / 87178291200, 1.0 / 20922789888000,
]  # fmt: skip


def _sincos_reduced(y: TF):
    y2 = mul(y, y)
    s = mul(y, _poly_tf(y2, _SIN_COEFFS))
    c = _poly_tf(y2, _COS_COEFFS)
    return s, c


def sincos(x: TF):
    """(sin x, cos x) at TF accuracy (see module notes above)."""
    dtype = x.hi.dtype
    c0, c1, c2 = _pi2_terms(dtype)
    k = jnp.round(to_float(x) / c0)
    # y = x − k·(c0 + c1 + c2), every product error-free
    y = sub(x, TF(*two_prod(k, jnp.asarray(c0, dtype))))
    y = sub(y, TF(*two_prod(k, jnp.asarray(c1, dtype))))
    y = sub(y, TF(*two_prod(k, jnp.asarray(c2, dtype))))
    s, c = _sincos_reduced(y)
    q = jnp.mod(k, 4.0)  # quadrant: sin(y + q·π/2)
    sin_hi = jnp.select(
        [q == 0, q == 1, q == 2], [s.hi, c.hi, -s.hi], -c.hi
    )
    sin_lo = jnp.select(
        [q == 0, q == 1, q == 2], [s.lo, c.lo, -s.lo], -c.lo
    )
    cos_hi = jnp.select(
        [q == 0, q == 1, q == 2], [c.hi, -s.hi, -c.hi], s.hi
    )
    cos_lo = jnp.select(
        [q == 0, q == 1, q == 2], [c.lo, -s.lo, -c.lo], s.lo
    )
    return TF(sin_hi, sin_lo), TF(cos_hi, cos_lo)


def sin(x: TF) -> TF:
    return sincos(x)[0]


def cos(x: TF) -> TF:
    return sincos(x)[1]
