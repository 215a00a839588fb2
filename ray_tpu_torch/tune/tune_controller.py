"""Trial execution loop (reference: `python/ray/tune/execution/
tune_controller.py :: TuneController`).

Trials run as actors (function trainables wrapped with the train-session
reporting machinery); the controller polls streamed reports, consults the
scheduler for early-stop decisions, enforces a concurrency cap, retries
failed trials, and drives PBT exploit/restart.

The port's copy of ray_tpu/tune/tune_controller.py, with two deliberate
differences. `resources_per_trial` names the card "GPU" (a fraction such
as {"GPU": 0.25} packs four trials on one card). And a trial the
controller stops (early, or to exploit another's checkpoint) stops
training: the controller stops its session first, through the runner's
second lane, so the trainable raises SessionStopped at its next report
and unwinds, freeing what it holds on the card; the controller waits for
that before it kills the actor. The reference only kills the actor, and a
killed actor's thread runs the trainable to its end.
"""

from __future__ import annotations

import threading
import uuid
from typing import Any, Callable, Dict, List, Optional

from .. import api
from ..core.logging import get_logger
from ..train.checkpoint import Checkpoint
from ..train.session import (SessionStopped, TrainContext, _Report, _TrainSession,
                             _set_session)
from .schedulers import COMPLETE, CONTINUE, STOP, FIFOScheduler
from .trial import Trial, TrialStatus

logger = get_logger("tune.controller")

# how long _stop_trial waits for a stopped trainable to reach its next
# report and return before it kills the actor regardless
STOP_WAIT_S = 60.0


@api.remote
class TrialRunner:
    """Runs one trial's trainable with session-based reporting."""

    def __init__(self, trial_id: str):
        self.trial_id = trial_id
        self.session: Optional[_TrainSession] = None

    def run(self, trainable: Callable, config: Dict[str, Any],
            resume_checkpoint: Optional[Checkpoint]) -> Any:
        ctx = TrainContext(experiment_name=self.trial_id, gang_name=self.trial_id)
        self.session = _TrainSession(ctx, resume_checkpoint)
        _set_session(self.session)
        try:
            out = trainable(config)
            if isinstance(out, dict):
                self.session.report(out, None)
            return None
        except SessionStopped:
            return None
        finally:
            self.session.finished = True
            _set_session(None)

    def poll(self) -> List[Any]:
        return self.session.drain() if self.session else []

    def stop(self) -> bool:
        """Stop the running trainable at its next report (second lane)."""
        if self.session is not None:
            self.session.stop()
        return True


class TuneController:
    def __init__(
        self,
        trainable: Callable,
        configs: List[Dict[str, Any]],
        scheduler=None,
        max_concurrent: int = 4,
        max_retries: int = 0,
        resources_per_trial: Optional[Dict[str, float]] = None,
        search_alg=None,
    ):
        self.trainable = trainable
        self.scheduler = scheduler or FIFOScheduler()
        self.search_alg = search_alg
        self.max_concurrent = max_concurrent
        self.max_retries = max_retries
        self.resources = resources_per_trial or {"CPU": 1.0}
        self.trials = [
            Trial(trial_id=f"trial_{i:04d}_{uuid.uuid4().hex[:6]}", config=cfg)
            for i, cfg in enumerate(configs)
        ]
        self._actors: Dict[str, Any] = {}
        self._run_refs: Dict[str, Any] = {}
        self._resume: Dict[str, Optional[Checkpoint]] = {}
        self._searcher_done = search_alg is None

    # ------------------------------------------------------------------

    def _launch(self, trial: Trial) -> None:
        actor = TrialRunner.options(
            max_concurrency=2, num_cpus=self.resources.get("CPU", 1.0),
            num_gpus=self.resources.get("GPU", 0.0),
        ).remote(trial.trial_id)
        ref = actor.run.remote(
            self.trainable, trial.config, self._resume.get(trial.trial_id)
        )
        self._actors[trial.trial_id] = actor
        self._run_refs[trial.trial_id] = ref
        trial.status = TrialStatus.RUNNING

    def _stop_trial(self, trial: Trial, *, early: bool, notify: bool = True) -> None:
        actor = self._actors.pop(trial.trial_id, None)
        run_ref = self._run_refs.pop(trial.trial_id, None)
        if actor is not None:
            try:
                api.get(actor.stop.remote(), timeout=10.0)
                if run_ref is not None:
                    api.wait([run_ref], timeout=STOP_WAIT_S)
            except Exception:
                pass
            try:
                api.kill(actor)
            except Exception:
                pass
        trial.status = TrialStatus.TERMINATED
        trial.stopped_early = early
        if notify:
            self._notify_searcher(trial)

    def _drain_reports(self, trial: Trial) -> List[_Report]:
        actor = self._actors.get(trial.trial_id)
        if actor is None:
            return []
        try:
            return api.get(actor.poll.remote(), timeout=10.0)
        except Exception:
            return []

    def _handle_reports(self, trial: Trial) -> None:
        for rep in self._drain_reports(trial):
            trial.results.append(rep.metrics)
            if rep.checkpoint is not None:
                trial.checkpoint = rep.checkpoint
            decision = self.scheduler.on_result(trial, rep.metrics, self.trials)
            if decision in (STOP, COMPLETE) and trial.status is TrialStatus.RUNNING:
                logger.info(
                    "scheduler %s %s at %s",
                    "stopped" if decision == STOP else "completed",
                    trial.trial_id, rep.metrics,
                )
                self._stop_trial(trial, early=decision == STOP)
                return
            exploit = self.scheduler.exploit(trial, self.trials)
            if exploit is not None:
                new_config, src_ckpt = exploit
                logger.info("PBT exploit: %s adopts %s", trial.trial_id, new_config)
                self._stop_trial(trial, early=False, notify=False)
                trial.config = new_config
                trial.status = TrialStatus.PENDING
                self._resume[trial.trial_id] = src_ckpt
                return

    def _ask_searcher(self, want: int) -> List[Trial]:
        """Pull up to `want` fresh trials from the search algorithm
        (sequential suggestion: TPE etc. see completed results first)."""
        fresh: List[Trial] = []
        while not self._searcher_done and want > 0:
            trial_id = f"trial_{len(self.trials):04d}_{uuid.uuid4().hex[:6]}"
            cfg = self.search_alg.suggest(trial_id)
            if cfg is None:
                self._searcher_done = True
                break
            t = Trial(trial_id=trial_id, config=cfg)
            self.trials.append(t)
            fresh.append(t)
            want -= 1
        return fresh

    def _notify_searcher(self, trial: Trial) -> None:
        if self.search_alg is not None and trial.last_result:
            self.search_alg.on_trial_complete(trial.trial_id, trial.last_result)

    def run(self) -> List[Trial]:
        while True:
            running = [t for t in self.trials if t.status is TrialStatus.RUNNING]
            pending = [t for t in self.trials if t.status is TrialStatus.PENDING]
            if len(running) + len(pending) < self.max_concurrent:
                pending.extend(self._ask_searcher(
                    self.max_concurrent - len(running) - len(pending)
                ))
            if not running and not pending:
                break
            while pending and len(running) < self.max_concurrent:
                t = pending.pop(0)
                self._launch(t)
                running.append(t)

            refs = {self._run_refs[t.trial_id]: t for t in running if t.trial_id in self._run_refs}
            done, _ = api.wait(list(refs), num_returns=len(refs), timeout=0.2)
            for t in list(running):
                if t.status is TrialStatus.RUNNING:
                    self._handle_reports(t)
            for ref in done:
                trial = refs[ref]
                if trial.status is not TrialStatus.RUNNING:
                    continue  # already stopped/exploited
                try:
                    api.get(ref)
                    self._handle_reports(trial)
                    self._stop_trial(trial, early=False)
                except (api.RayTaskError, api.RayActorError) as e:
                    trial.restarts += 1
                    if trial.restarts <= self.max_retries:
                        logger.warning("retrying %s after %s", trial.trial_id, e)
                        self._actors.pop(trial.trial_id, None)
                        self._run_refs.pop(trial.trial_id, None)
                        trial.status = TrialStatus.PENDING
                        if trial.checkpoint is not None:
                            self._resume[trial.trial_id] = trial.checkpoint
                    else:
                        trial.error = str(e)
                        self._stop_trial(trial, early=False)
                        trial.status = TrialStatus.ERROR
        return self.trials
