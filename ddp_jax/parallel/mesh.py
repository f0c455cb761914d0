"""Device-mesh scaling: shard the solve batch over chips/hosts.

The reference is single-process/single-thread (SURVEY.md §2 parallelism
table); batched scaling runs thousands of independent solves
(scenarios/initial states) and shards the batch axis over a
``jax.sharding.Mesh`` — NVLink between the cards of a host, the network
across hosts.  Global
reductions (convergence statistics, shared value blocks) ride ``psum``
inside ``shard_map``.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ddp_jax.solver.solve import SolverParams, solve


def make_batch_mesh(n_devices: int | None = None) -> Mesh:
    devices = jax.devices()
    n = n_devices if n_devices is not None else len(devices)
    return jax.make_mesh((n,), ("batch",))


def batch_sharded_solve(problem, params: SolverParams, mesh: Mesh):
    """jit a batched solve with the batch axis sharded over ``mesh``.

    Returns fn(x0s [B, nx]) -> (us [B, T, nu], stats dict with globally
    psum-reduced convergence aggregates).
    """

    def shard_fn(x0s):
        res = jax.vmap(lambda x: solve(problem, params, x))(x0s)
        # global convergence aggregates over all shards (collectives)
        n_total = jax.lax.psum(x0s.shape[0], "batch")
        mean_constr = jax.lax.psum(jnp.sum(res.stats.opt_constr), "batch") / n_total
        n_converged = jax.lax.psum(jnp.sum(res.stats.converged), "batch")
        return res.us, {"mean_constr": mean_constr, "n_converged": n_converged}

    # check_vma=False: solver internals mix batch-varying carries with
    # unvarying constants (e.g. the zero terminal-cost Hessian as scan init),
    # which the strict varying-manual-axes checker rejects.
    shard = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=P("batch"),
        out_specs=(P("batch"), P()),
        check_vma=False,
    )
    x_sharding = NamedSharding(mesh, P("batch"))
    return jax.jit(shard, in_shardings=(x_sharding,))


def batch_sharded_solve_batched(problem, params: SolverParams, mesh: Mesh, **kw):
    """jit the fixed-budget production path (solver/batched.py::solve_batched)
    with the batch axis sharded over ``mesh``.

    ``**kw`` forwards to solve_batched (backward=..., n_reg_levels=...,
    interpret=..., ...), so the Pallas backends run per-shard — each device
    launches the kernel on its local batch block.  Returns
    fn(x0s [B, nx]) -> (BatchSolveResult, stats dict with the psum-reduced
    convergence aggregate)."""
    from ddp_jax.solver import al as al_mod
    from ddp_jax.solver.batched import BatchSolveResult, solve_batched

    def shard_fn(x0s):
        res = solve_batched(problem, params, x0s, **kw)
        n_total = jax.lax.psum(x0s.shape[0], "batch")
        mean_constr = jax.lax.psum(jnp.sum(res.opt_constr), "batch") / n_total
        return res, {"mean_constr": mean_constr}

    b = P("batch")
    res_spec = BatchSolveResult(
        xs=b, us=b, fb_k=b, fb_K=b, opt_constr=b, opt_lag=b, mu=b,
        mults=al_mod.AffineMults(val=b, jac=b, origin=b), reg=b, w=b, n=b,
    )  # fmt: skip
    shard = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=P("batch"),
        out_specs=(res_spec, P()),
        check_vma=False,
    )
    x_sharding = NamedSharding(mesh, P("batch"))
    return jax.jit(shard, in_shardings=(x_sharding,))


def multihost_init(coordinator_address: str | None = None, **kw) -> None:
    """Initialize multi-host JAX (no-op on single host).

    ≙ the reference's absent distributed runtime; on several hosts call
    this before building the mesh (jax.distributed.initialize)."""
    if jax.process_count() > 1 or coordinator_address is not None:
        jax.distributed.initialize(coordinator_address=coordinator_address, **kw)
