"""Profiling: analytic FLOP model, throughput timers, jax.profiler traces.

The reference reports MCells/s plus analytic GF/s from a lifting FLOP model
(Compute_FLOPS_Single_Dimension, CvxCompress.cpp:663-671) and optionally
PAPI hardware counters (:21-27,787-801).  Here: the same analytic model
(both the lifting form, for apples-to-apples GF/s numbers, and the matmul
form this framework actually executes) and jax.profiler traces for
hardware-level inspection.
"""

from __future__ import annotations

import contextlib
import statistics
import subprocess
import time


def lifting_flops_per_cell_1d(dim):
    """Reference lifting FLOP model: sum over levels of 23*n/2 per axis,
    normalized per cell (CvxCompress.cpp:663-671)."""
    flops = 0.0
    n = dim
    while n >= 2:
        flops += 23.0 * n / 2.0
        n -= n // 2
    return flops / dim


def lifting_flops_per_cell(block):
    """Forward-transform lifting FLOPs per cell for a (bx, by, bz) block."""
    bx, by, bz = block
    out = 0.0
    for d in (bx, by, bz):
        if d > 1:
            out += lifting_flops_per_cell_1d(d)
    return out


def matmul_flops_per_cell(block):
    """FLOPs per cell of the dense-operator (matmul) formulation."""
    bx, by, bz = block
    return 2 * (bx * (bx > 1) + by * (by > 1) + bz * (bz > 1))


class Timer:
    """Wall-clock stage timer accumulating MCells/s style stats."""

    def __init__(self):
        self.times = {}

    @contextlib.contextmanager
    def stage(self, name):
        t0 = time.perf_counter()
        yield
        self.times.setdefault(name, []).append(time.perf_counter() - t0)

    def best(self, name):
        return min(self.times[name])

    def report(self, name, cells, flops_per_cell=0.0):
        el = self.best(name)
        out = {
            "stage": name,
            "seconds": el,
            "mcells_s": cells / el / 1e6,
        }
        if flops_per_cell:
            out["gflop_s"] = cells * flops_per_cell / el / 1e9
        return out


@contextlib.contextmanager
def device_trace(logdir):
    """jax.profiler trace around a region (view with TensorBoard/XProf)."""
    import jax

    jax.profiler.start_trace(str(logdir))
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def timed(fn, reps=3, setup=None):
    """Wall time of fn() — or fn(setup()), setup untimed — after one warm
    call, over `reps` calls.  fn must return only when its work is done
    (end device work with jax.block_until_ready).  Returns (median, min,
    max) seconds."""
    def call():
        arg = () if setup is None else (setup(),)
        t0 = time.perf_counter()
        fn(*arg)
        return time.perf_counter() - t0

    call()
    ts = [call() for _ in range(reps)]
    return statistics.median(ts), min(ts), max(ts)


def card_line():
    """The GPU's name and power limit as nvidia-smi reports them (the
    first card); raises when nvidia-smi is absent or fails."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()
