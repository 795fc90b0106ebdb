"""Dual-sink logger: stdout + flushed ``log.maniac``.

Mirrors the reference's logging contract (reference: src/output_utils.f90:36-46
LogMessage, :535-602 AbortRun/WarnUser/InfoMessage, :50-142 ASCII banners) so
the black-box tests that grep the log keep working:

* normal completion writes a box containing "MANIAC-MC Simulation Completed"
* fatal errors write a "FATAL ERROR:" block (matches grep -E "Error|STOP")
"""

from __future__ import annotations

import io
import os
import sys

from ..constants import BOX_WIDTH
from .errors import ManiacError


class Logger:
    """stdout + file logger. If path is None, logs only to stdout."""

    def __init__(self, path: str | None = None, quiet: bool = False):
        self._file: io.TextIOBase | None = None
        self.quiet = quiet
        if path is not None:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._file = open(path, "w")

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None

    def log(self, msg: str = "") -> None:
        line = " " + msg.rstrip() if msg else ""
        if not self.quiet:
            print(line)
        if self._file is not None:
            self._file.write(line + "\n")
            self._file.flush()

    # --- boxed banners ---------------------------------------------------
    def box_border(self) -> None:
        self.log("+" + "-" * (BOX_WIDTH - 2) + "+")

    def box_line(self, text: str = "") -> None:
        padded = text.ljust(BOX_WIDTH - 4)[: BOX_WIDTH - 4]
        self.log("| " + padded + " |")

    def banner(self, *lines: str) -> None:
        self.log("")
        self.box_border()
        for line in lines:
            self.box_line(line)
        self.box_border()
        self.log("")

    # --- structured messages ---------------------------------------------
    def warn(self, msg: str) -> None:
        self.log("-" * 50)
        self.log("WARNING:")
        self.log(msg)
        self.log("Execution will continue.")
        self.log("-" * 50)

    def info(self, msg: str) -> None:
        self.log("INFO: " + msg)

    def abort(self, msg: str, exit_code: int = 1) -> None:
        """Log a fatal error block and raise ManiacError."""
        self.log("-" * 50)
        self.log("FATAL ERROR:")
        self.log(msg)
        self.log("Simulation will now terminate.")
        self.log("-" * 50)
        raise ManiacError(msg, exit_code)


class NullLogger(Logger):
    def __init__(self):
        super().__init__(None, quiet=True)


_default = NullLogger()


def default_logger() -> Logger:
    return _default


def print_and_exit_on_error(fn, logger: Logger):
    """Run fn(); on ManiacError exit the process with the stored code."""
    try:
        return fn()
    except ManiacError as e:
        sys.exit(e.exit_code)
