"""Device timing + runtime stopwatches.

:func:`time_device_fn` times a jitted call in steady state: it compiles
first, then waits for every call with ``block_until_ready`` (JAX dispatch
is asynchronous, so a timer without it measures the enqueue).

Also provides the reference-style host stopwatch/statistics
(``PointMatcherSupport::timer`` + ``Histogram``, SURVEY 5: Timer.h:36-60).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List

import numpy as np


def time_device_fn(fn: Callable, args: tuple, iters: int = 20) -> float:
    """Mean wall seconds per call of ``jax.jit(fn)(*args)``, compile
    excluded, each call waited for with ``block_until_ready``."""
    import jax

    f = jax.jit(fn)
    jax.block_until_ready(f(*args))  # compile
    t0 = time.perf_counter()
    for _ in range(iters):
        jax.block_until_ready(f(*args))
    return (time.perf_counter() - t0) / iters


class Timer:
    """Host stopwatch (≙ ``PointMatcherSupport::timer`` / open3d_slam
    ``Timer``): accumulates named durations for rolling statistics."""

    def __init__(self):
        self._t0: Dict[str, float] = {}
        self.durations: Dict[str, List[float]] = {}

    def start(self, name: str) -> None:
        self._t0[name] = time.perf_counter()

    def stop(self, name: str) -> float:
        dt = time.perf_counter() - self._t0.pop(name)
        self.durations.setdefault(name, []).append(dt)
        return dt

    def __call__(self, name: str):
        timer = self

        class _Ctx:
            def __enter__(self):
                timer.start(name)

            def __exit__(self, *exc):
                timer.stop(name)

        return _Ctx()

    def stats(self, name: str) -> dict:
        d = np.asarray(self.durations.get(name, []))
        if len(d) == 0:
            return dict(count=0)
        return dict(
            count=len(d),
            mean_ms=float(d.mean() * 1e3),
            p50_ms=float(np.median(d) * 1e3),
            max_ms=float(d.max() * 1e3),
            hz=float(1.0 / d.mean()),
        )

    def report(self) -> str:
        lines = []
        for name in sorted(self.durations):
            s = self.stats(name)
            lines.append(
                f"{name:32s} n={s['count']:5d} mean={s['mean_ms']:8.2f}ms "
                f"p50={s['p50_ms']:8.2f}ms max={s['max_ms']:8.2f}ms ({s['hz']:.1f} Hz)"
            )
        return "\n".join(lines)


class Histogram:
    """Value-distribution collector (≙ ``pointmatcher/Histogram.h``)."""

    def __init__(self, name: str = ""):
        self.name = name
        self.values: List[float] = []

    def add(self, v: float) -> None:
        self.values.append(float(v))

    def stats(self) -> dict:
        v = np.asarray(self.values)
        if len(v) == 0:
            return dict(count=0)
        return dict(
            count=len(v), mean=float(v.mean()), std=float(v.std()),
            min=float(v.min()), p25=float(np.percentile(v, 25)),
            p50=float(np.median(v)), p75=float(np.percentile(v, 75)),
            max=float(v.max()),
        )
