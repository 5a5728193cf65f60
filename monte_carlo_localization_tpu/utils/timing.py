"""Per-phase performance accounting.

Device-side analogue of the reference's utils::performance::TimingStats
(reference include/particle_filter_cpp/utils.hpp:49-61, src/utils.cpp:93-125):
same six accumulators and the same printed breakdown (avg ms/iter, achieved
Hz, per-phase %), plus wall-time helpers for timing jitted dispatches.

Note: with the whole MCL correction fused into one XLA computation the
per-phase split is only observable when running the phases as separate
(sub-jitted) calls; :class:`TimingStats` supports both modes.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable


@dataclass
class TimingStats:
    total_mcl_time: float = 0.0  # ms accumulators, as in the reference
    ray_casting_time: float = 0.0
    sensor_model_time: float = 0.0
    motion_model_time: float = 0.0
    resampling_time: float = 0.0
    query_prep_time: float = 0.0
    measurement_count: int = 0

    def reset(self) -> None:
        self.total_mcl_time = 0.0
        self.ray_casting_time = 0.0
        self.sensor_model_time = 0.0
        self.motion_model_time = 0.0
        self.resampling_time = 0.0
        self.query_prep_time = 0.0
        self.measurement_count = 0

    @property
    def avg_total_ms(self) -> float:
        if self.measurement_count == 0:
            return 0.0
        return self.total_mcl_time / self.measurement_count

    def print_stats(self, logger: Callable[[str], None] = print) -> None:
        """Same layout as reference src/utils.cpp:105-125."""
        if self.measurement_count == 0:
            return
        n = self.measurement_count
        avg_total = self.total_mcl_time / n
        rows = [
            ("Ray casting", self.ray_casting_time / n),
            ("Sensor eval", self.sensor_model_time / n),
            ("Query prep", self.query_prep_time / n),
            ("Motion model", self.motion_model_time / n),
            ("Resampling", self.resampling_time / n),
        ]
        logger(f"=== PERFORMANCE STATS (last {n} iterations) ===")
        hz = 1000.0 / avg_total if avg_total > 0 else float("inf")
        logger(f"Total MCL:        {avg_total:.6f} ms/iter ({hz:.2f} Hz)")
        for name, avg in rows:
            pct = 100.0 * avg / avg_total if avg_total > 0 else 0.0
            logger(f"{name + ':':<18}{avg:.6f} ms/iter ({pct:.2f}%)")
        logger("=====================================")


class device_trace:
    """Capture a ``jax.profiler`` device trace around a code block — the
    device-side deep dive behind :class:`TimingStats`'s wall-clock
    accounting (SURVEY §5 "tracing/profiling"). Writes a TensorBoard/
    Perfetto trace directory::

        with device_trace("/tmp/mcl_trace"):
            state, pose = pf.step(state, action, scan)

    View with ``tensorboard --logdir`` or ui.perfetto.dev. No-op (with a
    warning via ``log``) if profiling is unsupported on the backend.
    """

    def __init__(self, log_dir: str, log: Callable[[str], None] = print):
        self.log_dir = str(log_dir)
        self.log = log
        self._active = False

    def __enter__(self) -> "device_trace":
        import jax

        try:
            jax.profiler.start_trace(self.log_dir)
            self._active = True
        except Exception as e:  # pragma: no cover - backend dependent
            self.log(f"device trace unavailable: {e}")
        return self

    def __exit__(self, *exc) -> None:
        if self._active:
            import jax

            try:
                jax.profiler.stop_trace()
            finally:
                self._active = False
            self.log(f"device trace written to {self.log_dir}")


class Stopwatch:
    """Context manager accumulating wall ms into a TimingStats attribute."""

    def __init__(self, stats: TimingStats, attr: str):
        self.stats = stats
        self.attr = attr

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt_ms = (time.perf_counter() - self._t0) * 1000.0
        setattr(self.stats, self.attr, getattr(self.stats, self.attr) + dt_ms)
        return False
