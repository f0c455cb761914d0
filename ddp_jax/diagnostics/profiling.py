"""Phase timing + convergence traces.

≙ the reference runtime diagnostics: chronometer_t RAII wall-clock timer
appending to /tmp/chrono.log (utils.hpp:93-109, lib.cpp:206-222), the dedup
log_file_t registry (lib.cpp:181-204), and the per-problem convergence trace
files /tmp/<name>_primal.dat, _dual.dat (ddp.hpp:651-664).
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import jax

_LOG_FILES: dict[str, object] = {}  # dedup registry, ≙ log_file_t


def log_file(path: str):
    """Deduplicated append-mode file handle registry."""
    if path not in _LOG_FILES:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        _LOG_FILES[path] = open(path, "a")  # noqa: SIM115
    return _LOG_FILES[path]


@contextlib.contextmanager
def chronometer(message: str, path: str = "/tmp/chrono.log", sync=None):
    """RAII-style wall-clock timer (≙ chronometer_t).  Pass a jax array (or
    pytree) via ``sync`` to block on device completion before stopping the
    clock."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync is not None:
            jax.block_until_ready(sync)
        dt = time.perf_counter() - t0
        f = log_file(path)
        f.write(f"done [{message}] in {dt * 1e3:.3f} ms\n")
        f.flush()


class ConvergenceTrace:
    """Append per-iteration primal/dual optimality to trace files
    (≙ /tmp/<name>_primal.dat and _dual.dat, ddp.hpp:651-664)."""

    def __init__(self, name: str, directory: str = "/tmp"):
        self.primal = os.path.join(directory, f"{name}_primal.dat")
        self.dual = os.path.join(directory, f"{name}_dual.dat")

    def record(self, opt_constr, opt_obj) -> None:
        log_file(self.primal).write(f"{float(opt_constr)}\n")
        log_file(self.dual).write(f"{float(opt_obj)}\n")
        log_file(self.primal).flush()
        log_file(self.dual).flush()

    def record_history(self, history) -> None:
        """Append a whole ``SolveHistory`` (solve(..., history=True)) —
        one primal/dual line per executed iteration, stopping at the first
        converged row (the fixed-length scan repeats it afterwards)."""
        import numpy as np

        done = np.asarray(history.done)
        n = int(done.argmax()) + 1 if done.any() else done.shape[0]
        for oc, oo in zip(
            np.asarray(history.opt_constr)[:n], np.asarray(history.opt_obj)[:n]
        ):
            self.record(oc, oo)


def format_history(history) -> str:
    """Render a ``SolveHistory`` as the reference's per-iteration stdout
    block (μ/reg/w/n/step/‖eq‖ + optimality measures, ddp.hpp:807-838)."""
    import numpy as np

    done = np.asarray(history.done)
    n = int(done.argmax()) + 1 if done.any() else done.shape[0]
    lines = [
        f"{'it':>4} {'mu':>10} {'reg':>10} {'w':>10} {'n':>10} {'step':>8}"
        f" {'opt_obj':>10} {'opt_lag':>10} {'|eq|':>10} upd"
    ]
    for i in range(n):
        upd = (
            "p+=mu*eq"
            if bool(np.asarray(history.upd_success)[i])
            else ("mu*=10" if bool(np.asarray(history.upd_failure)[i]) else "-")
        )
        lines.append(
            f"{i:>4} {float(np.asarray(history.mu)[i]):>10.3e}"
            f" {float(np.asarray(history.reg)[i]):>10.3e}"
            f" {float(np.asarray(history.w)[i]):>10.3e}"
            f" {float(np.asarray(history.n)[i]):>10.3e}"
            f" {float(np.asarray(history.step)[i]):>8.4f}"
            f" {float(np.asarray(history.opt_obj)[i]):>10.3e}"
            f" {float(np.asarray(history.opt_lag)[i]):>10.3e}"
            f" {float(np.asarray(history.opt_constr)[i]):>10.3e}"
            f" {upd}"
        )
    return "\n".join(lines)


def device_profile(path: str = "/tmp/jax-trace"):
    """jax.profiler trace context for device timeline capture."""
    return jax.profiler.trace(path)


def timed_block_until_ready(fn, *args, n_rep: int = 5, **kw):
    """Measure steady-state wall time of a jitted callable (compile excluded).

    Returns (result, seconds_per_call)."""
    res = fn(*args, **kw)
    jax.block_until_ready(res)
    t0 = time.perf_counter()
    for _ in range(n_rep):
        res = fn(*args, **kw)
        jax.block_until_ready(res)
    return res, (time.perf_counter() - t0) / n_rep
