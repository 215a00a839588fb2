"""Result of a training run (reference: `python/ray/train/result.py`).

The port's copy of ray_tpu/train/result.py.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from .checkpoint import Checkpoint


@dataclasses.dataclass
class Result:
    metrics: Dict[str, Any]
    checkpoint: Optional[Checkpoint]
    error: Optional[BaseException] = None
    metrics_history: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    path: str = ""

    @property
    def best_checkpoints(self) -> List[Checkpoint]:
        return [self.checkpoint] if self.checkpoint else []
