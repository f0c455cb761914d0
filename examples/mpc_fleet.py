"""Scenario-fleet MPC: batched replanning sharded over a device mesh.

The BASELINE configs[5] pattern (32k scenarios, 10 ms replans) scaled to
whatever devices are present; on CPU set
XLA_FLAGS=--xla_force_host_platform_device_count=8 to exercise the mesh.

Run: python examples/mpc_fleet.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import time

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from ddp_jax.models.pendulum import pendulum
from ddp_jax.ocp import constraints, costs, dynamics
from ddp_jax.ocp.problem import Problem
from ddp_jax.parallel.mesh import make_batch_mesh
from ddp_jax.solver.mpc import init_batch_carry, make_batch_mpc_step
from ddp_jax.solver.solve import SolverParams
from ddp_jax.utils.compile_cache import setup_compile_cache


def main():
    setup_compile_cache()
    dtype = jnp.float32
    H = 24
    model = pendulum(1.0, 1.0, dtype=dtype)
    dyn = dynamics.euler(model, 0.01)
    con = constraints.advance_time(
        constraints.ConfigTarget(
            model=model, target=jnp.asarray([3.14], dtype=dtype), active_ts=(H,)
        ),
        dyn,
        times=2,
    )
    problem = Problem(
        dynamics=dyn,
        cost=costs.quad_control(1.0, dtype=dtype),
        constraint=con,
        horizon=H,
        second_order=False,
    )
    # 6 iterations converge the fleet within a few replans
    params = SolverParams(max_iterations=6, threshold=1e-4, mu=1e4)

    n_dev = len(jax.devices())
    mesh = make_batch_mesh(n_dev)
    step = make_batch_mpc_step(problem, params, mesh)
    B = n_dev * 512
    sh = NamedSharding(mesh, P("batch"))
    rng = np.random.default_rng(0)
    x = jax.device_put(
        jnp.asarray(np.stack([rng.uniform(-0.5, 0.5, B), np.zeros(B)], 1), dtype), sh
    )
    carry = init_batch_carry(problem, B, dtype, x0s=jnp.asarray(np.asarray(x)))
    carry = jax.device_put(carry, jax.tree.map(lambda _: sh, carry))

    u0, carry, mc = step(x, carry)  # compile
    jax.block_until_ready(u0)

    # blocking protocol: wait for u0 each replan (a real plant in the loop)
    t0 = time.perf_counter()
    n_replans = 20
    for _ in range(n_replans):
        u0, carry, mc = step(x, carry)
        x = x.at[:, 0].add(0.01 * x[:, 1])  # stand-in plant step
        jax.block_until_ready(u0)
    dt_block = (time.perf_counter() - t0) / n_replans

    # sustained protocol: keep the device queue full (the on-device cost)
    t0 = time.perf_counter()
    for _ in range(n_replans):
        u0, carry, mc = step(x, carry)
    jax.block_until_ready(u0)
    dt_sust = (time.perf_counter() - t0) / n_replans

    print(
        f"{B} scenarios on {n_dev} {jax.devices()[0].device_kind} device(s): "
        f"{dt_block * 1e3:.2f} ms/replan blocking ({B / dt_block:.0f} scenario-replans/s), "
        f"{dt_sust * 1e3:.2f} ms/replan sustained ({B / dt_sust:.0f}/s), "
        f"mean |eq| = {float(mc):.2e}"
    )


if __name__ == "__main__":
    main()
