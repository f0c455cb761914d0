"""UR5 reaching with config-target and spatial (end-effector) constraints.

Analog of test/pinocchio_ddp.cpp and test/pinocchio_spatial_eq_ddp.cpp.

Run: python examples/ur5_reach.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from ddp_jax import SolverParams, solve
from ddp_jax.models import base
from ddp_jax.models.robots import ee_frame_id, ur5
from ddp_jax.ocp import constraints, costs, dynamics
from ddp_jax.ocp.problem import Problem
from ddp_jax.utils.compile_cache import setup_compile_cache


def main():
    # f64 reference solve (on whatever device JAX finds; the GPU has
    # native f64)
    jax.config.update("jax_enable_x64", True)
    setup_compile_cache()
    arm = ur5()
    H = 12
    dyn = dynamics.euler(arm, 0.01)
    fid = ee_frame_id(arm)
    q0 = arm.neutral_configuration()
    x0 = base.state_pack(q0, jnp.zeros(arm.nv))

    # spatial_eq: reach the end-effector position of a nearby configuration
    q_goal = arm.integrate(q0, jnp.asarray([0.2, -0.15, 0.1, 0.05, -0.1, 0.08]))
    p_target = arm.frame_position(fid, q_goal)
    con = constraints.advance_time(
        constraints.FrameTarget(model=arm, target=p_target, frame_id=fid, active_ts=(H,)),
        dyn,
        times=2,
    )
    problem = Problem(
        dynamics=dyn,
        cost=costs.quad_control(1.0, dtype=jnp.float64),
        constraint=con,
        horizon=H,
        second_order=False,
    )
    params = SolverParams(max_iterations=55, threshold=1e-8, mu=1e8)
    res = jax.jit(lambda x: solve(problem, params, x))(x0)
    p_final = arm.frame_position(fid, res.xs[-1, : arm.nq])
    print(f"target EE position : {p_target}")
    print(f"reached EE position: {p_final}")
    print(f"|eq| = {float(res.stats.opt_constr):.3e}; iterations = {int(res.stats.iterations)}")


if __name__ == "__main__":
    main()
