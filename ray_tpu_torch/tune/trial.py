"""Trial state (reference: `python/ray/tune/experiment/trial.py`).

The port's copy of ray_tpu/tune/trial.py."""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, List, Optional


class TrialStatus(str, enum.Enum):
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    TERMINATED = "TERMINATED"  # completed or early-stopped
    ERROR = "ERROR"


@dataclasses.dataclass
class Trial:
    trial_id: str
    config: Dict[str, Any]
    status: TrialStatus = TrialStatus.PENDING
    results: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    checkpoint: Optional[Any] = None
    error: Optional[str] = None
    stopped_early: bool = False
    restarts: int = 0

    @property
    def last_result(self) -> Dict[str, Any]:
        return self.results[-1] if self.results else {}

    def metric(self, name: str, default=None):
        return self.last_result.get(name, default)

    def best_metric(self, name: str, mode: str = "max"):
        vals = [r[name] for r in self.results if name in r]
        if not vals:
            return None
        return max(vals) if mode == "max" else min(vals)
