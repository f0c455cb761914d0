"""Benchmark: the five cells of the batched AL-DDP main path on one GPU.

    python bench.py        # all five cells; prints ONE JSON line
    python bench.py --ab [CELL ...]  # the Riccati kernel against the XLA
                                     # sweep, in turns

The line's headline is the batched pendulum fleet (BASELINE configs[1]:
B=4096, T=32, 8 AL iterations) in solves/s; the other cells ride along as
nested rows.  Every row names the device it ran on.  A missing GPU, a
failing row or a missing device plane in the MPC trace fails the run: no
row falls back or is dropped.  Cells are built in benchmarks/_common.py.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from benchmarks import _common as C  # noqa: E402

TARGET = 10_000.0  # solves/s per card (BASELINE.json north star)


def _timed(fn, args, n_rep):
    """Warm (compile) once, then the mean seconds per call over ``n_rep``
    back-to-back calls with one final block: real deployments keep the
    device queue full."""
    import jax

    r = fn(*args)
    jax.block_until_ready(r.us)
    t0 = time.perf_counter()
    outs = [fn(*args) for _ in range(n_rep)]
    jax.block_until_ready(outs[-1].us)
    return (time.perf_counter() - t0) / n_rep, outs[-1]


def fleet_row(cell, n_rep) -> dict:
    dt, r = _timed(C.solve_cell(cell), (cell.x0s, cell.us0), n_rep)
    oc = np.asarray(r.opt_constr)
    B = cell.x0s.shape[0]
    return {
        "solves_per_s": B / dt, "B": B, "T": cell.problem.horizon,
        "iters": cell.params.max_iterations,
        "frac_feasible_1e-2": float(np.mean(oc < C.FEAS_TOL)),
        "p99_constr": float(np.percentile(oc, 99)), "kw": cell.kw,
    }  # fmt: skip


def panda7_row() -> dict:
    """Main solve, then the rescue pass over its infeasible lanes; the timed
    window holds both."""
    import jax

    cell = C.panda7_cell()
    fn = C.solve_cell(cell)
    r = fn(cell.x0s, cell.us0)
    jax.block_until_ready(r.us)
    oc_main = np.asarray(r.opt_constr)
    oc, n_rescued, fr, rargs = C.rescue(cell, oc_main)
    t0 = time.perf_counter()
    r = fn(cell.x0s, cell.us0)
    if fr is not None:
        jax.block_until_ready(r.us)
        r = fr(*rargs)
    jax.block_until_ready(r.us)
    dt = time.perf_counter() - t0
    B = cell.x0s.shape[0]
    return {
        "solves_per_s": B / dt, "B": B, "T": cell.problem.horizon,
        "iters": cell.params.max_iterations, "n_rescued": n_rescued,
        "frac_main": float(np.mean(oc_main < C.FEAS_TOL)),
        "frac_feasible_1e-2": float(np.mean(oc < C.FEAS_TOL)),
        "p99_constr": float(np.percentile(oc, 99)), "kw": cell.kw,
    }  # fmt: skip


def spans_per_call(call_starts, k_start, k_end) -> tuple[np.ndarray, np.ndarray]:
    """Per call, in ms: the device span (first kernel start to last kernel
    end) and the device busy time (the union of the kernel intervals) of
    the kernels that start between the call's host start and the next
    call's.  The caller blocks on every call, so no call's kernels reach
    into the next window.  Raises where a call ran no kernel."""
    call_starts = np.asarray(call_starts, np.float64)
    k_start, k_end = np.asarray(k_start, np.float64), np.asarray(k_end, np.float64)
    order = np.argsort(k_start)
    k_start, k_end = k_start[order], k_end[order]
    which = np.searchsorted(call_starts, k_start, side="right") - 1
    spans, busy = [], []
    for i in range(len(call_starts)):
        s, e = k_start[which == i], k_end[which == i]
        if not len(s):
            raise RuntimeError(f"call {i} ran no kernel on the GPU")
        reach = np.maximum.accumulate(e)  # furthest end so far
        gap = np.maximum(s[1:] - reach[:-1], 0.0)  # idle before each kernel
        spans.append((reach[-1] - s[0]) / 1e6)
        busy.append((reach[-1] - s[0] - gap.sum()) / 1e6)
    return np.asarray(spans), np.asarray(busy)


def device_call_ms(xplane_path: str, fn_name: str, n_expected: int):
    """Device (span, busy) ms of each of the ``n_expected`` traced calls of
    the jitted function ``fn_name``: the host plane's
    ``PjitFunction(fn_name)`` events mark the calls, the GPU plane's
    kernels of module ``jit_<fn_name>`` are their device work
    (spans_per_call).  Raises where the trace has no
    GPU plane, the calls do not number ``n_expected``, or a call ran no
    kernel."""
    import jax

    planes = list(jax.profiler.ProfileData.from_file(xplane_path).planes)
    gpu = [p for p in planes if p.name.startswith("/device:GPU")]
    if not gpu:
        raise RuntimeError(
            f"no GPU device plane in the trace (planes: {[p.name for p in planes]})"
        )
    calls = sorted(
        (ev.start_ns, ev.end_ns)
        for p in planes if p.name.startswith("/host")
        for line in p.lines for ev in line.events
        if ev.name == f"PjitFunction({fn_name})"
    )  # fmt: skip
    outer = []  # a call can surface as nested events: keep the outermost
    for s, e in calls:
        if not outer or s >= outer[-1][1]:
            outer.append((s, e))
    if len(outer) != n_expected:
        raise RuntimeError(f"{len(outer)} calls of {fn_name} in the trace, expected {n_expected}")
    module = f"jit_{fn_name}"
    kernels = [
        (ev.start_ns, ev.end_ns)
        for p in gpu for line in p.lines for ev in line.events
        if dict(ev.stats).get("hlo_module") == module
    ]  # fmt: skip
    if not kernels:
        raise RuntimeError(f"no kernel of {module} on the GPU plane")
    ks, ke = np.asarray(kernels).T
    return spans_per_call([s for s, _ in outer], ks, ke)


def ur5_mpc_row(n_replans: int = 12) -> dict:
    """UR5 replan (H=16, 3 AL iterations): caller-side wall latency per
    replan (blocking on u0, as a controller in the loop does), untraced;
    then, from a profiler trace of as many replans, each replan's device
    busy time and its device span.  The profiler slows every kernel
    launch, and a replan issues thousands, so the traced span can exceed
    the untraced wall; the busy time is the card's own work."""
    import jax

    from ddp_jax.solver.mpc import init_carry, make_mpc_step

    problem, params, x0 = C.ur5_mpc()
    step = make_mpc_step(problem, params, **C.UR5_MPC_KW)
    carry = init_carry(problem, x0.dtype)
    out = step(x0, carry)  # compile
    jax.block_until_ready(out.u0)
    carry = out.carry
    wall = []
    for _ in range(n_replans):
        t0 = time.perf_counter()
        out = step(x0, carry)
        jax.block_until_ready(out.u0)
        wall.append((time.perf_counter() - t0) * 1e3)
        carry = out.carry
    trace_dir = tempfile.mkdtemp(prefix="bench-mpc-trace-")
    with jax.profiler.trace(trace_dir):
        for _ in range(n_replans):
            out = step(x0, carry)
            jax.block_until_ready(out.u0)
            carry = out.carry
    files = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True)
    if not files:
        raise RuntimeError(f"profiler wrote no trace under {trace_dir}")
    span, busy = device_call_ms(files[0], "step", n_replans)
    return {
        "H": problem.horizon, "iters": params.max_iterations, "n": n_replans,
        "wall_ms_p50": float(np.percentile(wall, 50)),
        "wall_ms_p99": float(np.percentile(wall, 99)),
        "device_busy_ms_p50": float(np.percentile(busy, 50)),
        "device_busy_ms_p99": float(np.percentile(busy, 99)),
        "traced_span_ms_p50": float(np.percentile(span, 50)),
        "traced_span_ms_p99": float(np.percentile(span, 99)),
        "last_opt_constr": float(out.opt_constr),
    }  # fmt: skip


AB_CELLS = {  # cell → (constructor, calls per timed window)
    "pendulum_T32": (C.pendulum_cell, 20),
    "pendulum_T200": (C.pendulum_t200_cell, 5),
    "quadrotor_state_eq": (C.quadrotor_cell, 3),
}


def kernel_ab(names, n_rounds: int = 2) -> list[dict]:
    """The Riccati kernel (backward="pallas") against the plain XLA sweep,
    end to end inside solve_batched at the cell's shapes, in turns
    (A B B A …) in one process on one card."""
    import jax

    rows = []
    for name in names:
        make, n_rep = AB_CELLS[name]
        cell = make()
        choices = ("pallas", "sweep")
        fns = {c: C.solve_cell(cell._replace(kw={**cell.kw, "backward": c})) for c in choices}
        first_call_s = {}
        for c in choices:  # compile each variant; a compile that never ends shows here
            t0 = time.perf_counter()
            jax.block_until_ready(fns[c](cell.x0s, cell.us0).us)
            first_call_s[c] = time.perf_counter() - t0
            print(f"{cell.name} backward={c}: first call {first_call_s[c]:.1f} s",
                  file=sys.stderr, flush=True)  # fmt: skip
        times = {c: [] for c in choices}
        for c in (list(choices) + list(choices)[::-1]) * n_rounds:
            dt, _ = _timed(fns[c], (cell.x0s, cell.us0), n_rep)
            times[c].append(dt)
        B = cell.x0s.shape[0]
        rows.append({
            "cell": cell.name,
            **{f"{c}_first_call_s": s for c, s in first_call_s.items()},
            **{f"{c}_solves_per_s": [B / t for t in ts] for c, ts in times.items()},
        })  # fmt: skip
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ab", nargs="*", choices=sorted(AB_CELLS), default=None,
                    help="Riccati kernel vs XLA sweep, in turns (default: every cell)")  # fmt: skip
    a = ap.parse_args()
    card = C.nvidia_smi()
    C.setup_compile_cache()
    device = C.require_gpu()
    stamp = {"device": device, "card": card}
    if a.ab is not None:
        for row in kernel_ab(a.ab or sorted(AB_CELLS)):
            print(json.dumps({**row, **stamp}), flush=True)
        return

    head = fleet_row(C.pendulum_cell(), n_rep=20)
    row = {
        "metric": "pendulum_ddp_solves_per_s_per_chip",
        "value": head["solves_per_s"],
        "unit": "solves/s",
        "vs_baseline": head["solves_per_s"] / TARGET,
        **{k: v for k, v in head.items() if k != "solves_per_s"},
        **stamp,
        "pendulum_T200": {**fleet_row(C.pendulum_t200_cell(), n_rep=5), **stamp},
        "panda7_spatial_eq": {**panda7_row(), **stamp},
        "quadrotor_state_eq": {**fleet_row(C.quadrotor_cell(), n_rep=3), **stamp},
        "ur5_mpc_replan": {**ur5_mpc_row(), **stamp},
    }
    print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
