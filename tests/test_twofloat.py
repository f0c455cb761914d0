"""Double-float arithmetic: ~2× working precision on plain elementwise ops.

The f64-on-CPU suite plays the reference's MPFR-oracle role (SURVEY.md §4);
these tests pin that the f32-pair arithmetic reaches ~f64 accuracy — the
float multiprecision envelope (SURVEY.md §2 #30).
"""

import jax
import jax.numpy as jnp
import numpy as np

from ddp_jax.ops import twofloat as tf


def _rand(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, n)


def test_add_mul_vs_f64():
    a64 = _rand(1000, 1)
    b64 = _rand(1000, 2)
    a = tf.from_float(jnp.asarray(a64, jnp.float32))
    b = tf.from_float(jnp.asarray(b64, jnp.float32))
    s = tf.add(a, b)
    p = tf.mul(a, b)
    # f32 inputs are exact embeddings of themselves; the pair ops must agree
    # with f64 on those inputs to ~2^-48 (vs f32's 2^-24)
    a64c = np.asarray(a.hi, np.float64)
    b64c = np.asarray(b.hi, np.float64)
    err_s = np.abs(np.asarray(s.hi, np.float64) + np.asarray(s.lo, np.float64) - (a64c + b64c))
    err_p = np.abs(np.asarray(p.hi, np.float64) + np.asarray(p.lo, np.float64) - (a64c * b64c))
    assert err_s.max() == 0.0  # add of two f32 is exactly representable in a pair
    assert err_p.max() < 1e-13


def test_dot_ill_conditioned():
    """Cancellation-heavy dot product: plain f32 loses everything, the
    compensated pair keeps ~full f32-pair precision."""
    n = 2000
    rng = np.random.default_rng(3)
    a64 = rng.uniform(-1, 1, n)
    # construct b so partial sums nearly cancel
    b64 = rng.uniform(-1, 1, n)
    s_true = float(np.dot(np.asarray(a64, np.float32).astype(np.float64),
                          np.asarray(b64, np.float32).astype(np.float64)))
    a32 = jnp.asarray(a64, jnp.float32)
    b32 = jnp.asarray(b64, jnp.float32)
    s32 = float(jnp.dot(a32, b32))
    sdd = tf.dot(a32, b32)
    sdd_val = float(np.asarray(sdd.hi, np.float64) + np.asarray(sdd.lo, np.float64))
    assert abs(sdd_val - s_true) < 1e-9
    assert abs(sdd_val - s_true) <= abs(s32 - s_true) + 1e-12


def test_div_sqrt():
    xs = jnp.asarray(_rand(100, 4) + 1.5, jnp.float32)
    ys = jnp.asarray(_rand(100, 5) + 1.5, jnp.float32)
    q = tf.div(tf.from_float(xs), tf.from_float(ys))
    r = tf.sqrt(tf.from_float(xs))
    q64 = np.asarray(xs, np.float64) / np.asarray(ys, np.float64)
    r64 = np.sqrt(np.asarray(xs, np.float64))
    assert np.abs(np.asarray(q.hi, np.float64) + np.asarray(q.lo, np.float64) - q64).max() < 1e-13
    assert np.abs(np.asarray(r.hi, np.float64) + np.asarray(r.lo, np.float64) - r64).max() < 1e-13


def test_pendulum_rollout_twofloat_tracks_f64():
    """Long f32 rollouts drift (semi-implicit Euler accumulates roundoff);
    the same recursion in pair arithmetic tracks the f64 trajectory."""
    g_l, dt = 9.81, 0.01
    T = 2000
    u64 = 0.3 * np.sin(np.arange(T) * 0.01)

    def step64(q, v, u):
        v = v + dt * (-g_l * np.sin(q) + u)
        return q + dt * v, v

    q64, v64 = 0.3, 0.0
    for t in range(T):
        q64, v64 = step64(q64, v64, u64[t])

    # twofloat recursion: sin() evaluated at hi (f32) — the compensation
    # targets the accumulation, which is where f32 loses ground
    def step_tf(carry, u):
        q, v = carry
        acc = tf.from_float(-g_l * jnp.sin(tf.to_float(q)) + u)
        v = tf.add(v, tf.scale(acc, dt))
        q = tf.add(q, tf.scale(v, dt))
        return (q, v), None

    q0 = tf.from_float(jnp.asarray(0.3, jnp.float32))
    v0 = tf.from_float(jnp.asarray(0.0, jnp.float32))
    (qf, vf), _ = jax.lax.scan(step_tf, (q0, v0), jnp.asarray(u64, jnp.float32))

    # plain f32 recursion for comparison
    def step32(carry, u):
        q, v = carry
        v = v + dt * (-g_l * jnp.sin(q) + u)
        return (q + dt * v, v), None

    (q32, v32), _ = jax.lax.scan(
        step32, (jnp.asarray(0.3, jnp.float32), jnp.asarray(0.0, jnp.float32)),
        jnp.asarray(u64, jnp.float32),
    )  # fmt: skip
    err_tf = abs(float(tf.to_float(qf)) - q64)
    err_32 = abs(float(q32) - q64)
    # the pair recursion must beat plain f32 by a wide margin
    assert err_tf < err_32 / 10 or err_tf < 1e-6, (err_tf, err_32)


def test_sqrt_zero_and_dtype_guard():
    r = tf.sqrt(tf.from_float(jnp.asarray([0.0, 4.0], jnp.float32)))
    np.testing.assert_array_equal(np.asarray(tf.to_float(r)), [0.0, 2.0])
    import pytest

    with pytest.raises(TypeError):
        tf.two_prod(jnp.asarray(1.0, jnp.bfloat16), jnp.asarray(1.0, jnp.bfloat16))


def test_sincos_tf_accuracy():
    """TF sin/cos (range-reduced Taylor, ops/twofloat.py) reach well below
    f32 working precision on f32 pairs — the precision the TF-storage
    dynamics (models/pendulum.py forward_dynamics_tf) inherits."""
    xs64 = np.array([0.0, 0.3, 1.2, 3.14, -2.9, 7.7, -15.3, 3.14159265])
    x_hi = xs64.astype(np.float32)
    x_lo = (xs64 - x_hi.astype(np.float64)).astype(np.float32)
    s, c = tf.sincos(tf.TF(jnp.asarray(x_hi), jnp.asarray(x_lo)))
    s_val = np.asarray(s.hi, np.float64) + np.asarray(s.lo, np.float64)
    c_val = np.asarray(c.hi, np.float64) + np.asarray(c.lo, np.float64)
    # measured ~1e-15; f32 working precision is ~6e-8
    np.testing.assert_allclose(s_val, np.sin(xs64), atol=5e-14, rtol=0)
    np.testing.assert_allclose(c_val, np.cos(xs64), atol=5e-14, rtol=0)


def test_sincos_tf_f64_pairs():
    """f64-pair mode degrades gracefully to ~f64 accuracy (module note)."""
    xs = jnp.asarray([0.4, -2.2, 9.9], jnp.float64)
    s, c = tf.sincos(tf.from_float(xs))
    np.testing.assert_allclose(
        np.asarray(tf.to_float(s)), np.sin(np.asarray(xs)), atol=1e-15
    )
    np.testing.assert_allclose(
        np.asarray(tf.to_float(c)), np.cos(np.asarray(xs)), atol=1e-15
    )
