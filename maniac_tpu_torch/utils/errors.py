"""Typed errors mirroring the reference's AbortRun exit codes.

The reference aborts with `stop <code>` plus a "FATAL ERROR:" log block
(reference: src/output_utils.f90:535-562). We raise a ManiacError carrying the
exit code; the CLI converts it into the same log block + process exit code so
the black-box reader tests (grep Error|STOP) behave identically.
"""


class ManiacError(RuntimeError):
    """Fatal input/configuration error with a process exit code."""

    def __init__(self, message: str, exit_code: int = 1):
        super().__init__(message)
        self.exit_code = exit_code


class ManiacWarning(UserWarning):
    pass
