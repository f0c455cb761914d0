"""Pendulum swing-up with a terminal equality constraint.

The ddp_jax analog of the reference driver test/pendulum_ddp.cpp: horizon
200, dt 0.01, target q = 3.14 enforced through a double time-advance
constraint, primal-dual affine multipliers.

Run: python examples/pendulum_swingup.py  (CPU or GPU)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from ddp_jax import Method, SolverParams, solve
from ddp_jax.models.pendulum import pendulum
from ddp_jax.ocp import constraints, costs, dynamics
from ddp_jax.ocp.problem import Problem
from ddp_jax.utils.compile_cache import setup_compile_cache

HORIZON, DT = 200, 0.01


def main():
    setup_compile_cache()
    dtype = jnp.float64 if jax.config.read("jax_enable_x64") else jnp.float32
    model = pendulum(mass=1.0, length=1.0, dtype=dtype)
    dyn = dynamics.euler(model, DT)
    con = constraints.advance_time(
        constraints.ConfigTarget(
            model=model, target=jnp.asarray([3.14], dtype=dtype), active_ts=(HORIZON,)
        ),
        dyn,
        times=2,
    )
    problem = Problem(
        dynamics=dyn,
        cost=costs.quad_control(1.0, dtype=dtype),
        constraint=con,
        horizon=HORIZON,
    )
    mu = 1e8 if dtype == jnp.float64 else 1e4
    params = SolverParams(max_iterations=60, threshold=1e-8, mu=mu)
    res = jax.jit(lambda x: solve(problem, params, x, method=Method.PRIMAL_DUAL_AFFINE))(
        jnp.zeros(2, dtype)
    )
    print(f"converged={bool(res.stats.converged)} after {int(res.stats.iterations)} iters")
    print(f"final q = {float(res.xs[-1, 0]):.8f} (target 3.14)")
    print(f"|eq| = {float(res.stats.opt_constr):.3e}")
    # print the trajectory like the reference driver does
    for t in range(0, HORIZON + 1, 25):
        u = float(res.us[min(t, HORIZON - 1), 0])
        print(f"t={t:3d}  q={float(res.xs[t, 0]):+8.4f}  v={float(res.xs[t, 1]):+8.4f}  u={u:+9.4f}")


if __name__ == "__main__":
    main()
