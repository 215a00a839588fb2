"""Job submission (reference: `python/ray/job_submission ::
JobSubmissionClient` + dashboard job manager's `JobSupervisor`).

A job = an entrypoint shell command supervised by a JobSupervisor actor:
submit/status/logs/stop, env passthrough, working_dir. The supervisor runs
the child process and captures output; job state lands in the control
plane's job table so the state API can list it.

The port's copy of ray_tpu/job_submission.py, in-process only:
``JobSubmissionClient(address=...)`` drives the dashboard's REST routes,
and the dashboard waits for ROADMAP A5c, so it raises NotImplementedError.
An entrypoint is a driver of its own: the supervisor's actor process marks
itself a pool worker (RAY_TPU_IN_POOL_WORKER), and the entrypoint does not
inherit that mark, so it may call ``ray_tpu_torch.init()``.
"""

from __future__ import annotations

import os
import subprocess
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

from . import api
from .core.logging import get_logger

logger = get_logger("job")


class JobStatus:
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    STOPPED = "STOPPED"


@api.remote
class JobSupervisor:
    def __init__(self, job_id: str, entrypoint: str,
                 runtime_env: Optional[Dict[str, Any]] = None):
        self.job_id = job_id
        self.entrypoint = entrypoint
        self.runtime_env = runtime_env or {}
        self.status = JobStatus.PENDING
        self.returncode: Optional[int] = None
        self._log: List[str] = []
        self._proc: Optional[subprocess.Popen] = None
        self._stop_requested = False
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        env = dict(os.environ)
        env.pop("RAY_TPU_IN_POOL_WORKER", None)  # the entrypoint is a driver
        env.update(self.runtime_env.get("env_vars", {}))
        cwd = self.runtime_env.get("working_dir") or None
        self.status = JobStatus.RUNNING
        try:
            with self._lock:
                # stop() can land before Popen on a loaded box: honor it
                # instead of silently racing it away
                if self._stop_requested:
                    self.status = JobStatus.STOPPED
                    return
                self._proc = subprocess.Popen(
                    self.entrypoint, shell=True, cwd=cwd, env=env,
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                )
            assert self._proc.stdout is not None
            for line in self._proc.stdout:
                self._log.append(line)
                if len(self._log) > 10_000:
                    self._log = self._log[-5_000:]
            self.returncode = self._proc.wait()
            if self.status != JobStatus.STOPPED:
                self.status = (
                    JobStatus.SUCCEEDED if self.returncode == 0 else JobStatus.FAILED
                )
        except Exception as e:  # pragma: no cover
            self._log.append(f"supervisor error: {e}\n")
            self.status = JobStatus.FAILED

    def get_status(self) -> str:
        return self.status

    def get_logs(self) -> str:
        return "".join(self._log)

    def stop(self) -> bool:
        with self._lock:
            self._stop_requested = True
            proc = self._proc
        if proc is None:
            # not launched yet: _run observes the flag and marks STOPPED
            return True
        if proc.poll() is None:
            self.status = JobStatus.STOPPED
            proc.terminate()
            try:
                proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                proc.kill()
            return True
        return False


class JobSubmissionClient:
    """Job client over this process's runtime (actor calls). The
    reference's ``address="http://host:port"`` drives a running session's
    dashboard over REST; the dashboard waits for ROADMAP A5c, so an
    address raises NotImplementedError."""

    def __init__(self, address: Optional[str] = None):
        if address:
            raise NotImplementedError(
                f"JobSubmissionClient(address={address!r}): the dashboard's "
                "job REST routes wait for ROADMAP A5c")
        api._auto_init()
        self._supervisors: Dict[str, Any] = {}

    def submit_job(
        self,
        *,
        entrypoint: str,
        runtime_env: Optional[Dict[str, Any]] = None,
        submission_id: Optional[str] = None,
        metadata: Optional[Dict[str, str]] = None,
    ) -> str:
        job_id = submission_id or f"raytpu-job-{uuid.uuid4().hex[:10]}"
        # num_cpus=0: the supervisor just babysits a subprocess (reference
        # JobSupervisor is likewise zero-CPU) — the entrypoint's own work
        # is accounted by whatever IT schedules
        sup = JobSupervisor.options(
            name=f"_job_supervisor:{job_id}", max_concurrency=4, num_cpus=0
        ).remote(job_id, entrypoint, runtime_env)
        self._supervisors[job_id] = sup
        rt = api._auto_init()
        from .core.ids import JobID

        rt.control_plane.register_job(
            JobID.next(), {"submission_id": job_id, "entrypoint": entrypoint,
                           **(metadata or {})},
        )
        return job_id

    def _sup(self, job_id: str):
        sup = self._supervisors.get(job_id)
        if sup is None:
            sup = api.get_actor(f"_job_supervisor:{job_id}")
            self._supervisors[job_id] = sup
        return sup

    def get_job_status(self, job_id: str) -> str:
        return api.get(self._sup(job_id).get_status.remote())

    def get_job_logs(self, job_id: str) -> str:
        return api.get(self._sup(job_id).get_logs.remote())

    def stop_job(self, job_id: str) -> bool:
        return api.get(self._sup(job_id).stop.remote())

    def wait_until_finish(self, job_id: str, timeout_s: float = 300.0) -> str:
        deadline = time.monotonic() + timeout_s
        terminal = {JobStatus.SUCCEEDED, JobStatus.FAILED, JobStatus.STOPPED}
        while time.monotonic() < deadline:
            status = self.get_job_status(job_id)
            if status in terminal:
                return status
            time.sleep(0.2)
        raise TimeoutError(f"job {job_id} still {status} after {timeout_s}s")
