"""Run logging: stdout + persistent `run_log.log` in the checkpoint dir.
The port's copy of nerf_hugs_tpu/utils/record.py.

Reference observability parity: nerfacto's Recorder writes every printed
message through a logging.FileHandler alongside the TensorBoard writer
(nerfacto/utils/record_utils.py:5-23). Our TB writers live in the drivers;
this module carries the logfile twin. Multi-host: only host 0 opens the
file (enable_file=False elsewhere) — the same discipline as host-0-only TB.

A plain append-mode file handle, not the logging module: per-instance
loggers accumulate in logging's global manager and a recycled id() after a
crashed run would hand a new Recorder the old logger + handler, silently
double-appending into the previous run's file (drivers are invoked
repeatedly in one process by the e2e tests and validate_quality).
"""

from __future__ import annotations

import os
import time


class Recorder:
    """print() twin that also appends to {folder}/run_log.log."""

    def __init__(self, folder: str, enable_file: bool = True):
        self._file = None
        if enable_file:
            os.makedirs(folder, exist_ok=True)
            self._file = open(os.path.join(folder, "run_log.log"), "a")

    def print(self, message: str):
        print(message, flush=True)
        if self._file is not None:
            stamp = time.strftime("%Y-%m-%d %H:%M:%S")
            self._file.write(f"{stamp} - INFO # {message}\n")
            self._file.flush()

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = None
