"""Per-frame metrics — port of `tpuslam/utils/metrics.py`.

Structured per-frame JSONL records and a wall-clock section timer, in
machine-readable form for the CLI's `--log-jsonl` and exit summary.
"""

from __future__ import annotations

import json
import time
from typing import IO, Optional


class JsonlLogger:
    """Append one JSON object per line; cheap enough for per-frame use."""

    def __init__(self, path: str):
        self.path = path
        self._f: Optional[IO] = open(path, "w")

    def write(self, **record) -> None:
        if self._f is None:
            raise RuntimeError("logger closed")
        json.dump(record, self._f)
        self._f.write("\n")

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Timer:
    """Wall-clock section timer collecting a latency distribution."""

    def __init__(self):
        self.samples_ms: list[float] = []
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.samples_ms.append((time.perf_counter() - self._t0) * 1e3)
        self._t0 = None

    def summary(self) -> dict:
        import numpy as np

        if not self.samples_ms:
            return {}
        a = np.asarray(self.samples_ms)
        return {
            "count": int(a.size),
            "mean_ms": float(a.mean()),
            "p50_ms": float(np.percentile(a, 50)),
            "p95_ms": float(np.percentile(a, 95)),
            "max_ms": float(a.max()),
        }
