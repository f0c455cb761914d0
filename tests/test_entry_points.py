"""The measurement entry points' device checks, trace reduction and the
compile-cache helper (CPU: every device check here must refuse)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def test_require_gpu_raises_on_cpu_host():
    from benchmarks._common import require_gpu

    with pytest.raises(RuntimeError, match="no GPU"):
        require_gpu()


def test_chip_smoke_fails_without_gpu():
    """No CPU fallback: on a CPU-only host chip_smoke exits non-zero and
    prints no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")],
        capture_output=True, text=True, timeout=300, env=env,
    )  # fmt: skip
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stdout + out.stderr


def test_trace_reduction_requires_gpu_plane(tmp_path):
    """The MPC row reads replan times from the GPU device plane; a trace
    without one (a CPU run) is an error, not a silently missing key."""
    import glob

    from bench import device_call_ms

    f = jax.jit(lambda x: jnp.sin(x) @ x)
    x = jnp.ones((8, 8))
    f(x).block_until_ready()
    with jax.profiler.trace(str(tmp_path)):
        for _ in range(3):
            f(x).block_until_ready()
    (path,) = glob.glob(str(tmp_path / "**" / "*.xplane.pb"), recursive=True)
    with pytest.raises(RuntimeError, match="no GPU device plane"):
        device_call_ms(path, "f", 3)


def test_spans_per_call_windows():
    """Each kernel belongs to the call whose host start precedes it; a
    call's span runs from its first kernel's start to its last kernel's
    end, its busy time is the union of its kernels' intervals (overlaps
    counted once); a call with no kernel is an error."""
    from bench import spans_per_call

    calls = [0.0, 10e6, 20e6]
    ks = [3e6, 1e6, 12e6, 21e6, 21.5e6, 25e6]
    ke = [5e6, 2e6, 14e6, 22e6, 23e6, 29e6]
    span, busy = spans_per_call(calls, ks, ke)
    np.testing.assert_allclose(span, [4.0, 2.0, 8.0])
    np.testing.assert_allclose(busy, [3.0, 2.0, 6.0])
    with pytest.raises(RuntimeError, match="call 1 ran no kernel"):
        spans_per_call(calls, [1e6, 21e6], [2e6, 22e6])


@pytest.mark.parametrize("env_dir", [None, "from_env"])
def test_compile_cache_honours_env(monkeypatch, tmp_path, env_dir):
    """With JAX_COMPILATION_CACHE_DIR set, the helper sets no directory;
    otherwise the cache goes to the fixed <repo>/.jax_cache."""
    from ddp_jax.utils import compile_cache as cc

    before = jax.config.jax_compilation_cache_dir
    try:
        jax.config.update("jax_compilation_cache_dir", None)
        if env_dir is None:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            assert cc.setup_compile_cache() == os.path.join(ROOT, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == os.path.join(ROOT, ".jax_cache")
        else:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
            assert cc.setup_compile_cache() == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir is None
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
