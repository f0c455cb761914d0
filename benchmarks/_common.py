"""Shared by bench.py and chip_smoke.py: device identification and the five
cells' problems, one constructor per cell, so the two cannot drift apart.

Every cell is Gauss-Newton (``second_order=False``) in float32.  A cell's
``kw`` holds the solve_batched options it runs with, kernel choices
included; each kernel choice rests on an on-card measurement of the kernel
against the plain XLA stage (PERF.md "Kernel decisions (H100)").
"""

from __future__ import annotations

import os
import subprocess
import sys
from typing import NamedTuple

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from ddp_jax.utils.compile_cache import setup_compile_cache  # noqa: E402,F401

FEAS_TOL = 1e-2  # a lane is feasible when its opt_constr (‖eq‖∞) is below this


def nvidia_smi() -> str | None:
    """The card's name and power limit, as nvidia-smi reports them, or None
    where there is no nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        )  # fmt: skip
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip()


def device_info() -> dict:
    import jax

    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }


def require_gpu() -> dict:
    """Device info of JAX's GPU; raises where JAX found none (no CPU
    fallback: a CPU number is never a device number)."""
    info = device_info()
    if info["platform"] != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's first device is {info['platform']!r} "
            f"({info['kind']}); this measures the card and has no CPU fallback"
        )
    return info


class Cell(NamedTuple):
    name: str
    problem: object
    params: object
    x0s: object  # [B, nx]
    us0: object  # [B, T, nu] or None
    kw: dict  # solve_batched options


def _pendulum_problem(horizon: int, dtype):
    """BASELINE configs[1] problem: pendulum swing-up to q=3.14, terminal
    config constraint through a double advance_time."""
    import jax.numpy as jnp

    from ddp_jax.models.pendulum import pendulum
    from ddp_jax.ocp import constraints, costs, dynamics
    from ddp_jax.ocp.problem import Problem

    model = pendulum(1.0, 1.0, dtype=dtype)
    dyn = dynamics.euler(model, 0.01)
    con = constraints.advance_time(
        constraints.ConfigTarget(
            model=model, target=jnp.asarray([3.14], dtype=dtype), active_ts=(horizon,)
        ),
        dyn,
        times=2,
    )
    return Problem(
        dynamics=dyn, cost=costs.quad_control(1.0, dtype=dtype),
        constraint=con, horizon=horizon, second_order=False,
    )  # fmt: skip


# Pendulum fleet recipe: 8 fixed AL-DDP iterations with the bounded inner
# loop (inner_iters_max=1: the multiplier/μ gate opens every iteration);
# one regularization level (on the GN pendulum Quu = c·I + μ·equᵀequ +
# fuᵀVxx·fu never loses definiteness, so a deeper ladder is dead work — a
# lane that did fail keeps its trajectory and recovers through the
# cross-iteration reg escalation); 4 line-search candidates (the ladder
# never accepts past 1/8 on this workload once the gains are accurate);
# unroll 4 on the rollout and iteration scans.
PENDULUM_ITERS = 8
PENDULUM_KW = dict(
    backward="pallas", n_reg_levels=1, n_linesearch=4, unroll=4,
)  # fmt: skip


def pendulum_cell(B=4096, T=32, dtype=None, **kw) -> Cell:
    """Batched pendulum (BASELINE configs[1]: B=4096, T=32); T=200 is the
    reference's own horizon (test/pendulum_ddp.cpp:33)."""
    import jax.numpy as jnp

    from ddp_jax.solver.solve import SolverParams

    dtype = dtype or jnp.float32
    problem = _pendulum_problem(T, dtype)
    params = SolverParams(
        max_iterations=PENDULUM_ITERS, threshold=1e-5, mu=1e4, inner_iters_max=1
    )
    rng = np.random.default_rng(0)
    x0s = jnp.asarray(
        np.stack([rng.uniform(-np.pi, np.pi, B), np.zeros(B)], axis=1), dtype
    )
    return Cell(f"pendulum_T{T}", problem, params, x0s, None, {**PENDULUM_KW, **kw})


def pendulum_t200_cell(B=4096, dtype=None, **kw) -> Cell:
    """The reference's horizon; the early-exit ladder (forward="seq") pays
    ~1 rollout per iteration where the wide sweep would pay 4 of 200 steps."""
    return pendulum_cell(B, 200, dtype, **{"forward": "seq", **kw})


# panda7 recipe: highest matmul precision (keeps the μ-race tail small), a
# 2-candidate ladder, 24 iterations, then the infeasible lanes re-solve from
# x0 at a fresh μ₀=1e3 (PANDA7_RESCUE_KW) — docs/DESIGN.md "The panda7 f32
# tail".
PANDA7_KW = dict(
    backward="sweep", matmul_precision="highest", n_linesearch=2, forward="seq",
)  # fmt: skip
PANDA7_RESCUE_KW = {**PANDA7_KW, "n_linesearch": 8}
PANDA7_RESCUE_B = 128  # the rescue pass re-solves up to this many lanes


def panda7_cell(B=256, H=16, iters=24, dtype=None, **kw) -> Cell:
    """BASELINE configs[3]-class 7-DoF spatial_eq fleet."""
    import jax
    import jax.numpy as jnp

    from ddp_jax.models import base
    from ddp_jax.models.robots import ee_frame_id, panda7
    from ddp_jax.ocp import constraints, costs, dynamics
    from ddp_jax.ocp.problem import Problem
    from ddp_jax.solver.solve import SolverParams

    dtype = dtype or jnp.float32
    arm = panda7(dtype=dtype)
    dyn = dynamics.euler(arm, 0.01)
    fid = ee_frame_id(arm, "ee")
    q_ready = jnp.asarray([0.0, -0.785, 0.0, -2.356, 0.0, 1.571, 0.785], dtype)
    q_goal = arm.integrate(q_ready, jnp.asarray(0.04 * np.arange(1.0, 8.0), dtype))
    con = constraints.advance_time(
        constraints.FrameTarget(
            model=arm, target=arm.frame_position(fid, q_goal),
            frame_id=fid, active_ts=(H,),
        ),
        dyn, times=2,
    )  # fmt: skip
    problem = Problem(
        dynamics=dyn, cost=costs.quad_control(1.0, dtype=dtype),
        constraint=con, horizon=H, second_order=False,
    )  # fmt: skip
    params = SolverParams(
        max_iterations=iters, threshold=1e-5, mu=1e4, inner_iters_max=1
    )
    rng = np.random.default_rng(0)
    x0 = base.state_pack(q_ready, jnp.zeros(arm.nv, dtype))
    x0s = jnp.asarray(
        np.asarray(x0)[None] + 0.05 * rng.standard_normal((B, problem.nx)), dtype
    )
    zero_v = jnp.zeros(arm.nv, dtype)
    grav = jax.vmap(lambda q: arm.rnea(q, zero_v, zero_v))(x0s[:, : arm.nq])
    us0 = jnp.tile(grav[:, None, :], (1, H, 1))
    return Cell("panda7_spatial_eq", problem, params, x0s, us0, {**PANDA7_KW, **kw})


def panda7_rescue_params():
    from ddp_jax.solver.solve import SolverParams

    return SolverParams(max_iterations=32, threshold=1e-5, mu=1e3, inner_iters_max=1)


QUADROTOR_KW = dict(
    backward="sweep", matmul_precision="highest", n_linesearch=8, forward="seq",
)  # fmt: skip


def quadrotor_cell(B=256, H=32, iters=36, dtype=None, **kw) -> Cell:
    """configs[2]-class quaternion-manifold freeflyer StateTarget fleet
    (36 iterations, inner budget K=3)."""
    import jax
    import jax.numpy as jnp

    from ddp_jax.models import base
    from ddp_jax.models.robots import quadrotor
    from ddp_jax.ocp import constraints, costs, dynamics
    from ddp_jax.ocp.problem import Problem
    from ddp_jax.solver.solve import SolverParams

    dtype = dtype or jnp.float32
    quad = quadrotor(dtype=dtype)
    dyn = dynamics.euler(quad, 0.02)
    q0 = quad.neutral_configuration()
    q_goal = quad.integrate(q0, jnp.asarray([0.3, -0.2, 0.4, 0.0, 0.0, 0.2], dtype))
    x_goal = base.state_pack(q_goal, jnp.zeros(quad.nv, dtype))
    con = constraints.advance_time(
        constraints.StateTarget(model=quad, target=x_goal, active_ts=(H,)),
        dyn, times=2,
    )  # fmt: skip
    problem = Problem(
        dynamics=dyn, cost=costs.quad_control(1.0, dtype=dtype),
        constraint=con, horizon=H, second_order=False,
    )  # fmt: skip
    params = SolverParams(
        max_iterations=iters, threshold=1e-5, mu=1e4, inner_iters_max=3
    )
    rng = np.random.default_rng(0)
    x0 = base.state_pack(q0, jnp.zeros(quad.nv, dtype))
    dxs = 0.05 * rng.standard_normal((B, 2 * quad.nv))
    x0s = jax.vmap(lambda d: base.state_integrate(quad, x0, d))(jnp.asarray(dxs, dtype))
    zero_v = jnp.zeros(quad.nv, dtype)
    grav = jax.vmap(lambda x: quad.rnea(x[: quad.nq], zero_v, zero_v))(x0s)
    us0 = jnp.tile(grav[:, None, :], (1, H, 1))
    return Cell("quadrotor_state_eq", problem, params, x0s, us0, {**QUADROTOR_KW, **kw})


# The replan pins "highest" matmul precision like the other arm-class
# cells: at the default precision this program crashed the process on the
# H100 (PERF.md findings).
UR5_MPC_KW = dict(matmul_precision="highest")


def ur5_mpc(H=16, iters=3, dtype=None):
    """UR5 receding-horizon replan (BASELINE north star: arm MPC under a
    10 ms budget): returns (problem, params, x0); build the step with
    ``make_mpc_step(problem, params, **UR5_MPC_KW)``."""
    import jax.numpy as jnp

    from ddp_jax.models import base
    from ddp_jax.models.robots import ur5
    from ddp_jax.ocp import constraints, costs, dynamics
    from ddp_jax.ocp.problem import Problem
    from ddp_jax.solver.solve import SolverParams

    dtype = dtype or jnp.float32
    arm = ur5(dtype=dtype)
    dyn = dynamics.euler(arm, 0.01)
    q0 = arm.neutral_configuration()
    q_target = arm.integrate(q0, jnp.asarray(0.05 * np.arange(1.0, 7.0), dtype))
    con = constraints.advance_time(
        constraints.ConfigTarget(model=arm, target=q_target, active_ts=(H,)),
        dyn, times=2,
    )  # fmt: skip
    problem = Problem(
        dynamics=dyn, cost=costs.quad_control(1.0, dtype=dtype),
        constraint=con, horizon=H, second_order=False,
    )  # fmt: skip
    params = SolverParams(max_iterations=iters, threshold=1e-5, mu=1e4, inner_iters_max=1)
    x0 = base.state_pack(q0, jnp.zeros(arm.nv, dtype))
    return problem, params, x0


def solve_cell(cell: Cell, interpret: bool = False):
    """jit the cell's solve: returns fn(x0s, us0) → BatchSolveResult."""
    import jax

    from ddp_jax.solver.batched import solve_batched

    kw = dict(cell.kw)
    if interpret:
        kw["interpret"] = True
    return jax.jit(
        lambda x, u: solve_batched(cell.problem, cell.params, x, us_init=u, **kw)
    )


def rescue(cell: Cell, oc, interpret: bool = False, rescue_b: int = PANDA7_RESCUE_B):
    """panda7 tail policy: re-solve the lanes with opt_constr ≥ FEAS_TOL from
    x0 at a fresh μ₀ in one padded block of ``rescue_b`` lanes.  Returns
    (final opt_constr [B] as numpy, number of lanes re-solved, fn, args)
    where fn(*args) repeats the rescue solve (None when nothing failed)."""
    import jax.numpy as jnp

    oc = np.asarray(oc).copy()
    bad = np.nonzero(oc >= FEAS_TOL)[0]
    if bad.size == 0:
        return oc, 0, None, None
    if bad.size > rescue_b:
        raise RuntimeError(
            f"{cell.name}: {bad.size} infeasible lanes exceed the rescue block "
            f"of {rescue_b}"
        )
    rc = cell._replace(params=panda7_rescue_params(), kw=PANDA7_RESCUE_KW)
    fn = solve_cell(rc, interpret=interpret)
    idx = jnp.asarray(np.resize(bad, rescue_b))
    args = (cell.x0s[idx], cell.us0[idx])
    rr = fn(*args)
    oc[bad] = np.asarray(rr.opt_constr)[: bad.size]
    return oc, int(bad.size), fn, args
