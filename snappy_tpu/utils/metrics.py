"""Structured per-run metrics (SURVEY.md §5: observability the reference lacks).

Collects throughput/ratio numbers and emits them as JSON for the benchmark
scripts and for humans, plus the one timing helper every measurement uses.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field


@dataclass
class Metrics:
    run: dict = field(default_factory=dict)
    results: list = field(default_factory=list)

    def add(self, **kv) -> None:
        self.results.append(kv)

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"run": self.run, "results": self.results, "ts": time.time()}, f, indent=2)


def time_fn(fn, args=(), iters: int = 7, warmup: int = 1) -> dict:
    """Wall seconds per call of ``fn(*args)``, each call ending in
    ``jax.block_until_ready`` on its result (JAX returns before the device
    finishes). Returns {"median", "min", "n", "spread"}, spread being
    (max - min) / median."""
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    med = times[len(times) // 2]
    return {"median": med, "min": times[0], "n": len(times), "spread": (times[-1] - times[0]) / med}
