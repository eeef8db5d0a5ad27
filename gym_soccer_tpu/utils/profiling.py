"""Tracing / profiling / throughput instrumentation (SURVEY.md §5.1).

The reference's only instrumentation is wall-clock prints in main()
(soccer_simultaneous_env.py:530-551).  Here:

* `phase(name)` — wall-clock phase timer with a structured summary;
* `Throughput` — env-steps/s counter for rollout/training loops;
* `trace(dir)` — jax.profiler trace context (view in TensorBoard/XProf/
  Perfetto) around hot sections;
* `time_window(fn)` — steady-state seconds per call of a device
  function, over a window of at least a second that ends in
  block_until_ready;
* `device_line()` — the platform, device kind and count every device
  measurement is reported beside.
"""
from __future__ import annotations

import contextlib
import json
import time
from typing import Dict, List

import jax

_PHASES: List[dict] = []


@contextlib.contextmanager
def phase(name: str, sync: bool = True):
    """Time a phase; optionally block on device work before stopping the
    clock (otherwise async dispatch makes timings meaningless)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync:
            (jax.device_put(0) + 0).block_until_ready()
        dt = time.perf_counter() - t0
        _PHASES.append({"phase": name, "seconds": round(dt, 4)})


def phase_report(clear: bool = True) -> List[dict]:
    out = list(_PHASES)
    if clear:
        _PHASES.clear()
    return out


class Throughput:
    """Steps/s counter: `tick(n_steps)` after each timed chunk."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.steps = 0

    def tick(self, n_env_steps: int) -> None:
        self.steps += int(n_env_steps)

    @property
    def per_second(self) -> float:
        dt = time.perf_counter() - self.t0
        return self.steps / dt if dt > 0 else 0.0

    def summary(self) -> Dict[str, float]:
        return {"env_steps": self.steps,
                "env_steps_per_s": round(self.per_second)}


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace around a hot region (host and device
    timelines)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def time_window(fn, min_seconds: float = 1.0):
    """Seconds per call of ``fn()`` (which returns device arrays) at
    steady state.  The first call warms up (compiles); then back-to-back
    calls are timed in windows that end in ``block_until_ready``, growing
    the call count until one window lasts ``min_seconds``.  Returns
    (seconds_per_call, calls, window_seconds)."""
    jax.block_until_ready(fn())
    n = 1
    while True:
        t0 = time.perf_counter()
        for _ in range(n):
            out = fn()
        jax.block_until_ready(out)
        dt = time.perf_counter() - t0
        if dt >= min_seconds:
            return dt / n, n, dt
        n = max(n + 1, int(n * 1.25 * min_seconds / max(dt, 1e-6)))


def device_line() -> dict:
    """Where a measurement ran: jax.devices()[0]'s platform and kind, and
    the device count."""
    d = jax.devices()
    return {"platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(d)}


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` prints them (a child process
    that stays off JAX).  A card may be set below its maximum power and
    then runs slower under load, so every rate is reported beside this."""
    import subprocess
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def log_json(**fields) -> None:
    """One structured log line (the framework's observability contract)."""
    print(json.dumps(fields, sort_keys=True))
