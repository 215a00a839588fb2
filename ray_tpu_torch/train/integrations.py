"""Experiment-tracking integrations (reference: `python/ray/air/
integrations/wandb.py`, `mlflow.py` — setup_wandb / MlflowLoggerCallback).

Callbacks for `RunConfig.callbacks`. Two protocols, both accepted by the
trainer: a plain callable receives the full metrics history once at the
end of fit(); objects exposing `on_report(metrics)` additionally stream
every rank-0 report as it arrives. Each integration degrades gracefully:
when the client library is absent (this image has no wandb/mlflow), the
same records land in a local JSONL run directory with the library's
layout conventions, so runs stay inspectable and the code path stays
tested.

The port's copy of ray_tpu/train/integrations.py, with the same local
layout (config.json, history.jsonl, summary.json under <dir>/<name>).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

from ..core.logging import get_logger

logger = get_logger("train.integrations")


class _TrackerBase:
    """Shared shape: stream per-report, flush a summary at end-of-run."""

    def __init__(self, project: str, name: Optional[str] = None,
                 dir: Optional[str] = None, config: Optional[dict] = None):
        self.project = project
        self.name = name or f"run_{int(time.time())}"
        self.dir = dir or os.path.join(
            os.path.expanduser("~"), "ray_tpu_results", project
        )
        self.config = dict(config or {})
        self._step = 0
        self._started = False

    # -- backend hooks (overridden when the real client is importable) ----
    def _start(self) -> None:
        raise NotImplementedError

    def _log(self, metrics: Dict[str, Any], step: int) -> None:
        raise NotImplementedError

    def _finish(self, history: List[Dict[str, Any]]) -> None:
        raise NotImplementedError

    # -- trainer protocol --------------------------------------------------
    def on_report(self, metrics: Dict[str, Any]) -> None:
        if not self._started:
            self._start()
            self._started = True
        self._log(dict(metrics), self._step)
        self._step += 1

    def __call__(self, history: List[Dict[str, Any]]) -> None:
        if not self._started:
            self._start()
            self._started = True
            # end-only invocation (plain-callable protocol): backfill
            for i, m in enumerate(history):
                self._log(dict(m), i)
            self._step = len(history)
        self._finish(history)


class _LocalJsonlMixin:
    """Fallback backend: one JSONL of step records + a summary json."""

    def _local_start(self) -> str:
        run_dir = os.path.join(self.dir, self.name)
        os.makedirs(run_dir, exist_ok=True)
        with open(os.path.join(run_dir, "config.json"), "w") as f:
            json.dump(self.config, f, indent=2, default=str)
        return run_dir

    def _local_log(self, run_dir: str, metrics: Dict[str, Any], step: int):
        rec = {"_step": step, "_timestamp": time.time(), **metrics}
        with open(os.path.join(run_dir, "history.jsonl"), "a") as f:
            f.write(json.dumps(rec, default=str) + "\n")

    def _local_finish(self, run_dir: str, history: List[Dict[str, Any]]):
        summary = dict(history[-1]) if history else {}
        summary["_num_reports"] = len(history)
        with open(os.path.join(run_dir, "summary.json"), "w") as f:
            json.dump(summary, f, indent=2, default=str)


class WandbLoggerCallback(_TrackerBase, _LocalJsonlMixin):
    """Streams reports to Weights & Biases; offline JSONL when wandb is
    not importable (reference: `air/integrations/wandb.py`)."""

    def _start(self) -> None:
        try:
            import wandb  # noqa: F401

            self._run = wandb.init(
                project=self.project, name=self.name, dir=self.dir,
                config=self.config,
            )
            self._mode = "wandb"
        except ImportError:
            self._run_dir = self._local_start()
            self._mode = "local"
            logger.info("wandb not installed; logging run %r to %s",
                        self.name, self._run_dir)

    def _log(self, metrics, step) -> None:
        if self._mode == "wandb":
            self._run.log(metrics, step=step)
        else:
            self._local_log(self._run_dir, metrics, step)

    def _finish(self, history) -> None:
        if self._mode == "wandb":
            self._run.finish()
        else:
            self._local_finish(self._run_dir, history)


class MLflowLoggerCallback(_TrackerBase, _LocalJsonlMixin):
    """Logs reports as MLflow metrics; offline JSONL when mlflow is not
    importable (reference: `air/integrations/mlflow.py`)."""

    def __init__(self, experiment_name: str = "ray_tpu",
                 tracking_uri: Optional[str] = None, **kw):
        super().__init__(project=experiment_name, **kw)
        self.tracking_uri = tracking_uri

    def _start(self) -> None:
        try:
            import mlflow

            if self.tracking_uri:
                mlflow.set_tracking_uri(self.tracking_uri)
            mlflow.set_experiment(self.project)
            self._run = mlflow.start_run(run_name=self.name)
            for k, v in self.config.items():
                mlflow.log_param(k, v)
            self._mode = "mlflow"
        except ImportError:
            self._run_dir = self._local_start()
            self._mode = "local"
            logger.info("mlflow not installed; logging run %r to %s",
                        self.name, self._run_dir)

    def _log(self, metrics, step) -> None:
        if self._mode == "mlflow":
            import mlflow

            numeric = {k: float(v) for k, v in metrics.items()
                       if isinstance(v, (int, float))}
            mlflow.log_metrics(numeric, step=step)
        else:
            self._local_log(self._run_dir, metrics, step)

    def _finish(self, history) -> None:
        if self._mode == "mlflow":
            import mlflow

            mlflow.end_run()
        else:
            self._local_finish(self._run_dir, history)
