"""Fleet-level fault-tolerance primitives (heartbeats, failure detection):
a copy of the stdlib-only ``repro.train.ft``.

On a real multi-host fleet these run against the cluster coordinator;
here they are file-based so the same logic is exercisable in tests: each
worker process writes a heartbeat JSON (`hb_<host>.json`) every
``interval`` seconds from a daemon thread; `FailureDetector.check`
classifies hosts as healthy / suspect / dead from heartbeat age.  The
trainer's recovery path on `dead`: stop, exclude the host and resume
from the newest checkpoint, the flow ``repro_torch.examples.fault_tolerance``
demonstrates end to end (on a device mesh the trainer resumes onto
whatever mesh the restarted run has: ``train.trainer.train_bsq(mesh=)``).
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List


class Heartbeat:
    def __init__(self, workdir: str, host_id: int, interval: float = 1.0):
        self.path = os.path.join(workdir, f"hb_{host_id}.json")
        self.host_id = host_id
        self.interval = interval
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.step = 0

    def beat(self):
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"host": self.host_id, "time": time.time(), "step": self.step}, f)
        os.replace(tmp, self.path)

    def start(self):
        def run():
            while not self._stop.is_set():
                self.beat()
                self._stop.wait(self.interval)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)


class FailureDetector:
    def __init__(self, workdir: str, suspect_after: float = 3.0, dead_after: float = 10.0):
        self.workdir = workdir
        self.suspect_after = suspect_after
        self.dead_after = dead_after

    def check(self, expected_hosts: List[int]) -> Dict[int, str]:
        now = time.time()
        status = {}
        for h in expected_hosts:
            path = os.path.join(self.workdir, f"hb_{h}.json")
            try:
                with open(path) as f:
                    age = now - json.load(f)["time"]
            except (OSError, ValueError, KeyError):
                status[h] = "dead"
                continue
            if age > self.dead_after:
                status[h] = "dead"
            elif age > self.suspect_after:
                status[h] = "suspect"
            else:
                status[h] = "healthy"
        return status

    def surviving(self, expected_hosts: List[int]) -> List[int]:
        return [h for h, s in self.check(expected_hosts).items() if s != "dead"]
