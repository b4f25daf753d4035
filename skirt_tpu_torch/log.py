"""Console logging with scope timers.

Twin of skirt_tpu/log.py (the part a simulation run uses), kept here so
that a run imports no module of skirt_tpu.  ref: SKIRTcore/Log.hpp:18-109,
TimeLogger.hpp:14-40.
"""

from __future__ import annotations

import sys
import time
from contextlib import contextmanager


class Log:
    """A console logger: one time-stamped line per message."""

    def __init__(self, stream=None):
        self.stream = stream

    def _emit(self, message: str) -> None:
        stamp = time.strftime("%d/%m/%Y %H:%M:%S")
        print(f"{stamp}  {message}", file=self.stream or sys.stdout,
              flush=True)

    def info(self, message: str) -> None:
        self._emit(message)

    def warning(self, message: str) -> None:
        self._emit("Warning: " + message)

    def success(self, message: str) -> None:
        self._emit(message)

    @contextmanager
    def timer(self, scope: str):
        """'Starting <scope>... / Finished <scope> in N s' around a block."""
        self.info(f"Starting {scope}...")
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.success(f"Finished {scope} in "
                         f"{time.perf_counter() - t0:.1f} s.")


class SilentLog(Log):
    def _emit(self, message: str) -> None:
        pass
