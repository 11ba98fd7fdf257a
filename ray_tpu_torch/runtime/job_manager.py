"""Job submission: run driver entrypoints against the head daemon.

Reference parity: ``ray job submit`` — the dashboard's job module
(``python/ray/dashboard/modules/job/``) runs the entrypoint command as a
subprocess on the head node with ``RAY_ADDRESS`` exported, captures its
output to per-job logs under the session dir, and tracks
PENDING/RUNNING/SUCCEEDED/FAILED/STOPPED status with metadata
(SURVEY.md §1 layer 15; mount empty).

Here each job runs with ``RAY_TPU_TORCH_ADDRESS`` pointing back at this
daemon, so an entrypoint that calls ``ray_tpu_torch.init(address="auto")``
attaches to the shared cluster in client mode.
"""

from __future__ import annotations

import os
import shlex
import subprocess
import threading
from ..common import clock as _clk


class JobInfo:
    __slots__ = ("job_id", "entrypoint", "status", "metadata",
                 "start_time", "end_time", "log_path", "proc",
                 "return_code", "runtime_env")

    def __init__(self, job_id: str, entrypoint: str, metadata: dict,
                 log_path: str, runtime_env: dict | None = None):
        self.job_id = job_id
        self.entrypoint = entrypoint
        self.status = "PENDING"
        self.metadata = metadata
        self.runtime_env = runtime_env
        self.start_time = _clk.now()
        self.end_time: float | None = None
        self.log_path = log_path
        self.proc: subprocess.Popen | None = None
        self.return_code: int | None = None

    def to_dict(self) -> dict:
        return {"job_id": self.job_id, "entrypoint": self.entrypoint,
                "status": self.status, "metadata": self.metadata,
                "runtime_env": self.runtime_env,
                "start_time": self.start_time, "end_time": self.end_time,
                "return_code": self.return_code}


def _pid_runs_job(pid: int, job_id: str) -> bool:
    """Identity check before SIGKILLing a persisted driver pid: the OS
    may have recycled it for an unrelated process.  Drivers carry
    RAY_TPU_JOB_ID in their environment (set at submit)."""
    try:
        with open(f"/proc/{pid}/environ", "rb") as f:
            return f"RAY_TPU_JOB_ID={job_id}".encode() in f.read()
    except OSError:
        return False


class JobManager:
    def __init__(self, session_dir: str):
        self._log_dir = os.path.join(session_dir, "logs")
        os.makedirs(self._log_dir, exist_ok=True)
        self._jobs: dict[str, JobInfo] = {}
        self._lock = threading.Lock()
        self._counter = 0
        self.head_address: str | None = None    # set by HeadNode
        self._kv = None                 # GCS KV: job rows ride snapshots

    # -- persistence (head failover) ----------------------------------------
    def attach_kv(self, kv) -> None:
        """Persist job rows into the GCS KV so they ride its snapshots
        (reference: job table lives in the GCS — SURVEY.md §1 layer 3)."""
        # Single publish during head bootstrap, before any job thread
        # exists; _persist reading the slot unlocked is then safe.
        self._kv = kv  # rtlint: disable=W7

    def _persist(self, info: JobInfo) -> None:
        if self._kv is None:
            return
        import json
        row = info.to_dict()
        row["pid"] = info.proc.pid if info.proc is not None else None
        self._kv.put(info.job_id.encode(), json.dumps(row).encode(),
                     namespace="_jobs")

    def restore_jobs(self) -> list[str]:
        """After a head restart: re-run jobs that were PENDING/RUNNING
        when the old head died (their driver processes died with it, or
        are orphans we reap below).  Finished rows restore as history.
        Returns the re-submitted job ids.

        Divergence from upstream, documented: a Redis-FT GCS keeps
        raylets and drivers alive across the restart; here the runtime
        state lives in the head process, so interrupted jobs re-execute
        from their entrypoints."""
        import json
        import signal
        if self._kv is None:
            return []
        resubmitted = []
        for key in self._kv.keys(namespace="_jobs"):
            raw = self._kv.get(key, namespace="_jobs")
            if not raw:
                continue
            row = json.loads(raw)
            old_pid = row.pop("pid", None)
            if row["status"] in ("PENDING", "RUNNING"):
                if old_pid and _pid_runs_job(old_pid, row["job_id"]):
                    try:    # reap the orphaned driver of the old head
                        os.kill(old_pid, signal.SIGKILL)
                    except (OSError, ProcessLookupError):
                        pass
                self.submit(row["entrypoint"],
                            runtime_env=row.get("runtime_env"),
                            metadata=row["metadata"],
                            job_id=row["job_id"])
                resubmitted.append(row["job_id"])
            else:
                info = JobInfo(row["job_id"], row["entrypoint"],
                               row["metadata"], os.path.join(
                                   self._log_dir,
                                   f"job-{row['job_id']}.log"),
                               runtime_env=row.get("runtime_env"))
                info.status = row["status"]
                info.start_time = row["start_time"]
                info.end_time = row["end_time"]
                info.return_code = row["return_code"]
                with self._lock:
                    self._jobs.setdefault(row["job_id"], info)
        return resubmitted

    def submit(self, entrypoint: str, runtime_env: dict | None = None,
               metadata: dict | None = None,
               job_id: str | None = None) -> str:
        cmd = shlex.split(entrypoint)
        if not cmd:
            raise ValueError("empty job entrypoint")
        if job_id is None:
            from ..common.ids import fast_random_bytes
            with self._lock:
                self._counter += 1
                suffix = fast_random_bytes(4).hex()
                job_id = f"raysubmit_{self._counter:06d}_{suffix}"
        log_path = os.path.join(self._log_dir, f"job-{job_id}.log")
        info = JobInfo(job_id, entrypoint, metadata or {}, log_path,
                       runtime_env=runtime_env)
        with self._lock:
            self._jobs[job_id] = info
        env = dict(os.environ)
        env["RAY_TPU_JOB_ID"] = job_id
        if self.head_address:
            env["RAY_TPU_TORCH_ADDRESS"] = self.head_address
        # the entrypoint must resolve the SAME ray_tpu_torch package this
        # daemon runs, wherever its cwd is (jobs inherit the cluster's
        # environment in the reference)
        import ray_tpu_torch
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.abspath(ray_tpu_torch.__file__)))
        parts = [pkg_root] + [p for p in
                              env.get("PYTHONPATH", "").split(os.pathsep)
                              if p]
        env["PYTHONPATH"] = os.pathsep.join(dict.fromkeys(parts))
        if runtime_env and runtime_env.get("env_vars"):
            env.update(runtime_env["env_vars"])
        cwd = (runtime_env or {}).get("working_dir") or os.getcwd()
        log_f = open(log_path, "wb")
        try:
            info.proc = subprocess.Popen(
                cmd, stdout=log_f, stderr=log_f, env=env, cwd=cwd)
        except (OSError, ValueError) as e:
            log_f.write(f"failed to start: {e}\n".encode())
            log_f.close()
            info.status = "FAILED"
            info.end_time = _clk.now()
            self._persist(info)
            return job_id
        info.status = "RUNNING"
        self._persist(info)
        threading.Thread(target=self._reap, args=(info, log_f),
                         daemon=True, name=f"job-{job_id}").start()
        return job_id

    def _reap(self, info: JobInfo, log_f) -> None:
        rc = info.proc.wait()
        log_f.close()
        with self._lock:
            info.return_code = rc
            info.end_time = _clk.now()
            if info.status != "STOPPED":
                info.status = "SUCCEEDED" if rc == 0 else "FAILED"
        self._persist(info)

    def status(self, job_id: str) -> dict:
        with self._lock:
            info = self._jobs.get(job_id)
        if info is None:
            raise KeyError(f"no job {job_id!r}")
        return info.to_dict()

    def list(self) -> list[dict]:
        with self._lock:
            return [j.to_dict() for j in self._jobs.values()]

    def logs(self, job_id: str) -> str:
        with self._lock:
            info = self._jobs.get(job_id)
        if info is None:
            raise KeyError(f"no job {job_id!r}")
        try:
            with open(info.log_path, "rb") as f:
                return f.read().decode(errors="replace")
        except FileNotFoundError:
            return ""

    def stop(self, job_id: str) -> bool:
        with self._lock:
            info = self._jobs.get(job_id)
        if info is None:
            raise KeyError(f"no job {job_id!r}")
        if info.proc is not None and info.proc.poll() is None:
            info.status = "STOPPED"
            info.proc.terminate()
            return True
        return False

    def stop_all(self, wait: bool = False) -> None:
        with self._lock:
            jobs = list(self._jobs.values())
        for j in jobs:
            if j.proc is not None and j.proc.poll() is None:
                j.status = "STOPPED"
                j.proc.terminate()
                self._persist(j)
        if wait:
            # a final snapshot follows: terminal statuses must land in
            # the KV first, or the next start resurrects stopped jobs
            for j in jobs:
                if j.proc is not None:
                    try:
                        j.proc.wait(timeout=3.0)
                    except subprocess.TimeoutExpired:
                        j.proc.kill()

    def wait(self, job_id: str, timeout: float = 120.0) -> dict:
        """Block until the job leaves PENDING/RUNNING (test helper)."""
        deadline = _clk.monotonic() + timeout
        while _clk.monotonic() < deadline:
            st = self.status(job_id)
            if st["status"] not in ("PENDING", "RUNNING"):
                return st
            _clk.sleep(0.05)
        raise TimeoutError(f"job {job_id} still running after {timeout}s")
