"""Phase timers + profiler hooks.

The reference has no timing instrumentation at all (its only ``gettimeofday``
calls order output lines, ``BelosMueLuSolver.cpp:29-33``; SURVEY §5).  Here
tracing is first-class: nested phase timers with a report, and an optional
``jax.profiler`` trace context for device timeline capture.
"""

from __future__ import annotations

import contextlib
import time
from collections import OrderedDict
from typing import Dict, Iterator, Optional

import jax

__all__ = ["PhaseTimer", "trace_to"]


class PhaseTimer:
    """Accumulating named phase timer.

    >>> timer = PhaseTimer()
    >>> with timer.phase("assembly"):
    ...     ...
    >>> print(timer.report())
    """

    def __init__(self):
        self.totals: "OrderedDict[str, float]" = OrderedDict()
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        if not self.totals:
            return "(no phases timed)"
        width = max(len(k) for k in self.totals)
        lines = [
            f"{k:<{width}}  {v:9.3f}s  x{self.counts[k]}"
            for k, v in self.totals.items()
        ]
        return "\n".join(lines)

    def as_dict(self) -> Dict[str, float]:
        return dict(self.totals)


@contextlib.contextmanager
def trace_to(logdir: Optional[str]) -> Iterator[None]:
    """``jax.profiler`` trace context; no-op when logdir is None."""
    if logdir is None:
        yield
        return
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
