"""Hierarchical named timers (the port's copy of sdpb_tpu/utils/timers.py).
Dotted names build the hierarchy; results serialize to JSON."""
from __future__ import annotations

import json
import time
from contextlib import contextmanager
from typing import Dict, List, Tuple


class Timers:
    def __init__(self):
        self.elapsed: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self._stack: List[str] = []

    @contextmanager
    def scope(self, name: str):
        full = ".".join(self._stack + [name])
        self._stack.append(name)
        t0 = time.monotonic()
        try:
            yield
        finally:
            dt = time.monotonic() - t0
            self._stack.pop()
            self.elapsed[full] = self.elapsed.get(full, 0.0) + dt
            self.counts[full] = self.counts.get(full, 0) + 1

    def items(self) -> List[Tuple[str, float]]:
        return sorted(self.elapsed.items())

    def to_json(self) -> str:
        return json.dumps(
            [{"name": k, "elapsed_s": v, "count": self.counts.get(k, 1)}
             for k, v in self.items()], indent=1)

    def write_profile(self, path) -> None:
        """The timers' JSON in a file (the -v2 profile,
        <checkpointDir>.profiling/profiling.<process>)."""
        with open(path, "w") as f:
            f.write(self.to_json())
