"""The Pallas Riccati kernel compiled for the card (Triton route), against
the plain XLA sweep.  Marked ``gpu``: each skips where JAX's first device is not a
GPU.  Run on the card: JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ddp_jax.kernels.riccati_small import backward_sweep_pallas, pack_batch_last
from ddp_jax.solver.batched import _backward_sweep

from test_pallas_riccati import make_batch

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("dtype,tol", [(jnp.float32, 1e-4), (jnp.float64, 1e-9)])
def test_riccati_kernel_on_gpu(gpu, dtype, tol):
    B, H = 200, 24  # B pads to the block; T is not a power of two
    problem, derivs, mults = make_batch(B, H, dtype)
    mu = jnp.full((B,), 1e3, dtype)
    reg = jnp.zeros((B,), dtype)
    k_ref, K_ref, _ = jax.vmap(_backward_sweep)(derivs, mults.val, mults.jac, mu, reg)
    packed = pack_batch_last(derivs, mults.val, mults.jac)
    k, K, ok = jax.jit(
        lambda p, m, r: backward_sweep_pallas(p, m, r, T=H, n=2, m=1, e=1)
    )(packed, mu, reg)
    assert bool(ok.all())
    k = np.asarray(jnp.transpose(k, (2, 0, 1)))
    K = np.asarray(jnp.transpose(K.reshape(H, 1, 2, B), (3, 0, 1, 2)))
    for got, want in ((k, k_ref), (K, K_ref)):
        want = np.asarray(want)
        assert np.max(np.abs(got - want)) <= tol * max(1.0, np.max(np.abs(want)))
