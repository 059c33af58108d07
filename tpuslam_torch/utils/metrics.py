"""Per-frame metrics — port of `tpuslam/utils/metrics.py`.

Structured per-frame JSONL records, in machine-readable form for the
CLI's `--log-jsonl` and exit summary.
"""

from __future__ import annotations

import json
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
