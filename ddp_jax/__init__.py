"""ddp_jax — a batched trajectory-optimization framework in JAX.

Equality-constrained DDP/iLQR with augmented-Lagrangian multipliers over
rigid-body dynamics, written batched-first in JAX (vmap/scan/pjit, Pallas
kernels for hot paths).  Capability-parity target: the C++ reference
``s-elkazdadi/ddp-pinocchio`` (see SURVEY.md) — re-designed for batched
accelerators, not ported: Jacobians/Hessians come from ``jax.jacfwd`` instead of finite
differences, per-timestep loops become ``lax.scan``, and thousands of solves
batch across a device mesh instead of running single-threaded.
"""

from ddp_jax.models import pendulum
from ddp_jax.solver.solve import Method, SolverParams, solve

__all__ = ["Method", "SolverParams", "solve", "pendulum"]

__version__ = "0.1.0"
