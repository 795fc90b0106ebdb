"""A silent logger with the reference's abort contract: ``abort`` raises
ManiacError with the exit code (reference: src/output_utils.f90:535-602).
The copy's parsers call it; the benchmark prints nothing of theirs."""

from __future__ import annotations

from .errors import ManiacError


class Logger:
    def log(self, msg: str = "") -> None:
        pass

    def warn(self, msg: str) -> None:
        pass

    def info(self, msg: str) -> None:
        pass

    def abort(self, msg: str, exit_code: int = 1) -> None:
        raise ManiacError(msg, exit_code)


NullLogger = Logger
_default = Logger()


def default_logger() -> Logger:
    return _default
