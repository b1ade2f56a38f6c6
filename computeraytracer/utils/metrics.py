"""Observability: structured per-step render/train metrics (SURVEY.md §5).

The reference's only instrumentation is two console.log calls of buffer
sizes (reference/src/main.js:153,252). Here every render/train
loop can report throughput (paths/s and rays/s), progress, and losses as
structured records — printable, JSONL-appendable, and cheap (host-side
timestamps only; nothing synchronizes the device except an explicit
block at record time).
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class RenderMeter:
    """Accumulates path counts and wall time across steps.

    One "path" = one camera sample; each path casts about 2 rays per
    bounce (closest-hit + shadow), so rays/s ~ 2 * mean_depth * paths/s.
    """

    jsonl_path: Optional[str] = None
    total_paths: int = 0
    total_seconds: float = 0.0
    _t0: float = field(default=0.0, repr=False)

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, paths: int, **extra) -> dict:
        dt = time.perf_counter() - self._t0
        self.total_paths += paths
        self.total_seconds += dt
        rec = {
            "paths": paths,
            "seconds": round(dt, 6),
            "mpaths_per_s": round(paths / dt / 1e6, 4) if dt > 0 else None,
            **extra,
        }
        if self.jsonl_path:
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        return rec

    @property
    def mpaths_per_s(self) -> float:
        if self.total_seconds == 0:
            return 0.0
        return self.total_paths / self.total_seconds / 1e6
