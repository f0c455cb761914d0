"""Smoke test of the batched AL-DDP main path on one GPU.

    python chip_smoke.py                  # one card: the phases below
    python chip_smoke.py --four           # four cards: the sharded fleet only
    python chip_smoke.py --cpu-rehearsal  # same phases, tiny sizes, CPU,
                                          # Pallas kernels in interpret mode

This process stays off JAX: it prints the card's name and power limit, then
runs each JAX phase group in a child process, one after the other, so one
process holds the card at a time.

1. Device check: JAX's first device must be a GPU (no CPU fallback).
2. Kernels: the Pallas Riccati kernel, compiled for the card at the
   pendulum cells' widths (B=4096, T=32 and 200), against the XLA sweep in
   float32 (1e-4) and float64 (1e-9), with ``compiled.memory_analysis()``.
3. The five cells once each, through solve_batched / make_mpc_step: finite
   outputs and a feasible fraction (opt_constr < 1e-2) of at least 0.99 for
   the four fleets; for the UR5 MPC replan, every replan's u0 and
   opt_constr finite and the first replan's opt_constr below 0.1 (a third
   of the zero-control rollout's violation).
4. The GPU-marked tests (``pytest -m gpu``) in a child of their own.

Any failing phase exits non-zero.  The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
FEAS_MIN = 0.99  # fleets: fraction of lanes with opt_constr < FEAS_TOL
FOUR_B = 32768  # BASELINE configs[4]: 8192 scenarios per card
FOUR_REPLANS = 3


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------- phase 2


def _max_rel(a, b):
    """max|a − b| / max(1, max|b|), in float64 on the host."""
    import numpy as np

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(1.0, float(np.max(np.abs(b)))))


def _memory(compiled) -> str:
    m = compiled.memory_analysis()
    if m is None:
        return "memory_analysis: none"
    keys = ("argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes",
            "generated_code_size_in_bytes")  # fmt: skip
    return "memory_analysis: " + ", ".join(f"{k}={getattr(m, k, None)}" for k in keys)


def _riccati_inputs(B, T, dtype):
    """Rollout + derivatives of the pendulum cell's problem at [B, T] with
    non-trivial multipliers, so the AL terms are exercised."""
    import jax
    import jax.numpy as jnp

    from benchmarks._common import pendulum_cell

    cell = pendulum_cell(B=B, T=T, dtype=dtype)
    p = cell.problem

    @jax.jit
    def make(x0s):
        us = 0.3 * jax.random.normal(jax.random.key(1), (B, T, p.nu), dtype)
        xs = jax.vmap(p.rollout)(x0s, us)
        derivs = jax.vmap(p.derivatives)(xs, us)
        mv = 0.3 * jax.random.normal(jax.random.key(2), (B, T, p.ne), dtype)
        mj = 0.1 * jax.random.normal(jax.random.key(3), (B, T, p.ne, p.ndx), dtype)
        return derivs, mv, mj, jnp.full((B,), 1e3, dtype), jnp.zeros((B,), dtype)

    return make(cell.x0s)


def check_riccati(B, T, dtype, tol, interpret):
    """Triton-route Riccati kernel vs the XLA sweep (HIGHEST precision)."""
    import jax
    import jax.numpy as jnp

    from ddp_jax.solver import batched as bt

    args = _riccati_inputs(B, T, dtype)

    def kernel(d, mv, mj, mu, reg):
        return bt._backward_pallas_levels(d, mv, mj, mu, reg, n_levels=1, interpret=interpret)

    def ref(d, mv, mj, mu, reg):
        return jax.vmap(
            lambda *a: bt._backward_multi_reg(*a, n_levels=1)
        )(d, mv, mj, mu, reg)

    compiled = jax.jit(kernel).lower(*args).compile()
    kp, Kp, okp, _ = compiled(*args)
    kx, Kx, okx, _ = jax.jit(ref)(*args)
    dk, dK = _max_rel(kp, kx), _max_rel(Kp, Kx)
    ok = bool(okp.all()) and bool(okx.all())
    log(f"  riccati_backward B={B} T={T} {jnp.dtype(dtype).name}: rel max|dk|={dk:.3e} "
        f"rel max|dK|={dK:.3e} tol={tol:g} all_ok={ok}; {_memory(compiled)}")  # fmt: skip
    if not (ok and dk <= tol and dK <= tol):
        raise AssertionError(f"riccati kernel parity failed at B={B} T={T} {dtype}")


def phase_kernels(small: bool):
    import jax
    import jax.numpy as jnp

    log("phase 2: kernels (compiled for the card, vs the plain reference)")
    log("  (the XLA reference pins HIGHEST matmul precision; an unpinned float32 "
        "product may run in TF32, ~3 decimal digits)")  # fmt: skip
    B, Ts = (64, (8, 13)) if small else (4096, (32, 200))
    for T in Ts:
        check_riccati(B, T, jnp.float32, 1e-4, small)
    with jax.enable_x64(True):
        for T in Ts:
            check_riccati(B, T, jnp.float64, 1e-9, small)


# ---------------------------------------------------------------- phase 3


def _fleet(cell, small, rescue=False):
    import jax
    import numpy as np

    from benchmarks._common import FEAS_TOL, rescue as rescue_lanes, solve_cell

    t0 = time.perf_counter()
    res = solve_cell(cell, interpret=small)(cell.x0s, cell.us0)
    jax.block_until_ready(res.us)
    finite = all(
        bool(np.isfinite(np.asarray(a)).all()) for a in (res.us, res.xs, res.opt_constr)
    )
    oc = np.asarray(res.opt_constr)
    n_rescued = 0
    if rescue:
        oc, n_rescued, _, _ = rescue_lanes(cell, oc, interpret=small)
    frac = float(np.mean(oc < FEAS_TOL))
    log(f"  {cell.name}: B={cell.x0s.shape[0]} T={cell.problem.horizon} "
        f"iters={cell.params.max_iterations} kw={cell.kw} finite={finite} "
        f"frac_feasible={frac:.4f} p99_constr={np.percentile(oc, 99):.3e} "
        f"n_rescued={n_rescued} first_call_s={time.perf_counter() - t0:.1f}")  # fmt: skip
    if not finite or frac < FEAS_MIN:
        raise AssertionError(f"{cell.name}: finite={finite} frac_feasible={frac}")


MPC_FIRST_MAX = 0.1  # a third of the zero-control rollout's violation (0.3)


def _mpc(small):
    """UR5 replan, 12 warm-started replans on a fixed measured state.  Check:
    every replan's u0 and opt_constr finite, and the first replan (cold
    carry, 3 AL iterations) ends below MPC_FIRST_MAX.  Later replans are
    printed, not checked: on a fixed state the shifted warm start drifts
    (PERF.md, open questions)."""
    import numpy as np

    from ddp_jax.solver.mpc import init_carry, make_mpc_step
    from benchmarks._common import UR5_MPC_KW, ur5_mpc

    problem, params, x0 = ur5_mpc()
    step = make_mpc_step(problem, params, **UR5_MPC_KW)
    carry = init_carry(problem, x0.dtype)
    ocs = []
    for _ in range(12):
        out = step(x0, carry)
        carry = out.carry
        ocs.append(float(out.opt_constr))
        if not (np.isfinite(np.asarray(out.u0)).all() and np.isfinite(ocs[-1])):
            raise AssertionError("ur5_mpc: non-finite replan output")
    log(f"  ur5_mpc: H={problem.horizon} iters={params.max_iterations} replans=12, "
        f"all finite; opt_constr per replan {[f'{o:.2e}' for o in ocs]} "
        f"(check: first < {MPC_FIRST_MAX:g})")  # fmt: skip
    if not ocs[0] < MPC_FIRST_MAX:
        raise AssertionError(f"ur5_mpc: first replan opt_constr {ocs[0]}")


def phase_cells(small: bool):
    from benchmarks._common import panda7_cell, pendulum_cell, pendulum_t200_cell, quadrotor_cell

    log("phase 3: the five cells")
    if small:
        _fleet(pendulum_cell(B=64, T=32), small)
        _fleet(pendulum_cell(B=64, T=50, forward="seq"), small)
        _fleet(panda7_cell(B=16, H=8, iters=24), small, rescue=True)
        _fleet(quadrotor_cell(B=16), small)
    else:
        _fleet(pendulum_cell(), small)
        _fleet(pendulum_t200_cell(), small)
        _fleet(panda7_cell(), small, rescue=True)
        _fleet(quadrotor_cell(), small)
    _mpc(small)


# ---------------------------------------------------------------- four cards


def phase_four(small: bool):
    """BASELINE configs[4]: the pendulum fleet sharded over a flat
    ("batch",) mesh of four cards, against card 0's shard solved alone."""
    import jax
    import numpy as np

    from benchmarks._common import pendulum_cell
    from ddp_jax.parallel.mesh import batch_sharded_solve_batched, make_batch_mesh
    from ddp_jax.solver.mpc import init_batch_carry, make_batch_mpc_step

    B = 64 if small else FOUR_B
    cell = pendulum_cell(B=B, T=32)
    kw = dict(cell.kw, interpret=True) if small else cell.kw
    mesh4, mesh1 = make_batch_mesh(4), make_batch_mesh(1)
    shard = B // 4
    log(f"four cards: pendulum fleet B={B} ({shard} per card) T=32 kw={cell.kw}")

    fn4 = batch_sharded_solve_batched(cell.problem, cell.params, mesh4, **kw)
    fn1 = batch_sharded_solve_batched(cell.problem, cell.params, mesh1, **kw)
    t0 = time.perf_counter()
    res4, st4 = fn4(cell.x0s)
    jax.block_until_ready(res4.us)
    t4 = time.perf_counter() - t0
    devs = {s.device for s in res4.us.addressable_shards}
    log(f"  solve_batched over 4 cards: shards on {sorted(str(d) for d in devs)} "
        f"first_call_s={t4:.1f}")  # fmt: skip
    if len(devs) != 4:
        raise AssertionError(f"expected 4 distinct devices, got {devs}")
    res1, _ = fn1(cell.x0s[:shard])
    oc = np.asarray(res4.opt_constr)
    host_mean = float(np.mean(oc.astype(np.float64)))
    psum_mean = float(st4["mean_constr"])
    d_us = float(np.max(np.abs(np.asarray(res4.us)[:shard] - np.asarray(res1.us))))
    frac = float(np.mean(oc < 1e-2))
    log(f"  card-0 shard vs alone on one card: max|dus|={d_us:.3e}; psum mean "
        f"constr={psum_mean:.6e} host mean={host_mean:.6e}; frac_feasible={frac:.4f}")  # fmt: skip
    if not d_us <= 1e-4 * max(1.0, float(np.max(np.abs(np.asarray(res1.us))))):
        raise AssertionError(f"card-0 shard differs from the one-card solve: {d_us}")
    if not abs(psum_mean - host_mean) <= 1e-5 * max(1.0, abs(host_mean)):
        raise AssertionError(f"psum aggregate {psum_mean} vs host mean {host_mean}")
    if frac < FEAS_MIN:
        raise AssertionError(f"four-card fleet frac_feasible={frac}")

    # fleet MPC: a few warm-started replans, sharded vs card 0's shard alone
    outs = {}
    for name, mesh, n in (("four", mesh4, B), ("one", mesh1, shard)):
        step = make_batch_mpc_step(cell.problem, cell.params, mesh, **kw)
        x = cell.x0s[:n]
        carry = init_batch_carry(cell.problem, n, x.dtype, x0s=x)
        t0 = time.perf_counter()
        for _ in range(FOUR_REPLANS):
            u0, carry, mc = step(x, carry)
        jax.block_until_ready(u0)
        outs[name] = (np.asarray(u0), float(mc))
        log(f"  make_batch_mpc_step on {name} card(s): {FOUR_REPLANS} replans "
            f"mean_constr={float(mc):.3e} wall_s_incl_compile={time.perf_counter() - t0:.1f}")  # fmt: skip
    d_u0 = float(np.max(np.abs(outs["four"][0][:shard] - outs["one"][0])))
    log(f"  replan u0, card-0 shard vs alone: max|du0|={d_u0:.3e}")
    if not np.isfinite(outs["four"][0]).all() or not d_u0 <= 1e-4 * max(
        1.0, float(np.max(np.abs(outs["one"][0])))
    ):
        raise AssertionError(f"fleet MPC card-0 shard differs: {d_u0}")


# ---------------------------------------------------------------- entry point


def child(which: str, small: bool) -> None:
    import faulthandler

    faulthandler.enable()  # a crash in native code still names its phase
    if small:
        os.environ["JAX_PLATFORMS"] = "cpu"
        if which == "four":
            os.environ["XLA_FLAGS"] = (
                os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=4"
            )
    sys.path.insert(0, ROOT)
    from benchmarks._common import require_gpu, setup_compile_cache, device_info

    setup_compile_cache()
    log("phase 1: device check")
    info = device_info() if small else require_gpu()
    log(f"  JAX devices: {info}")
    if which == "four":
        if info["count"] < 4:
            raise RuntimeError(f"--four needs 4 devices, JAX found {info['count']}")
        phase_four(small)
    else:
        phase_kernels(small)
        phase_cells(small)
    print(json.dumps({"ok": True, "device": info}), flush=True)


def run_child(args: list[str], env=None) -> str:
    """Run a child, echo its output, return its last stdout line."""
    proc = subprocess.Popen(
        [sys.executable, *args], cwd=ROOT, stdout=subprocess.PIPE, text=True, env=env
    )
    last = ""
    for line in proc.stdout:
        sys.stdout.write(line)
        sys.stdout.flush()
        if line.strip():
            last = line.strip()
    if proc.wait() != 0:
        raise SystemExit(f"chip_smoke: {' '.join(args)} exited {proc.returncode}")
    return last


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true", help="four cards: the sharded fleet only")
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="tiny sizes on the CPU, Pallas kernels in interpret mode")  # fmt: skip
    ap.add_argument("--child", choices=("main", "four"), help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child:
        child(a.child, a.cpu_rehearsal)
        return

    sys.path.insert(0, ROOT)
    from benchmarks._common import nvidia_smi  # stays off JAX

    log(f"nvidia-smi name, power.limit: {nvidia_smi() or 'not available'}")
    rehearsal = ["--cpu-rehearsal"] if a.cpu_rehearsal else []
    me = os.path.abspath(__file__)
    last = run_child([me, "--child", "four" if a.four else "main", *rehearsal])
    result = json.loads(last)
    if not a.four:
        log("phase 4: GPU-marked tests")
        env = dict(os.environ, JAX_PLATFORMS="cpu" if a.cpu_rehearsal else "cuda")
        run_child(["-m", "pytest", "tests/", "-m", "gpu", "-q", "-p", "no:cacheprovider"],
                  env=env)  # fmt: skip
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
