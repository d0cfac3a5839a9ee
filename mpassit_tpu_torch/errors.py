"""Fail-fast error surface with reference-matching messages.

Replaces ``utils.F90``: ``error_handler`` (:16-33, prints
"- FATAL ERROR: <msg>" then mpi_aborts) and ``netcdf_err`` (:39-58, prints
"FATAL ERROR: <context>: <NF90_STRERROR>" then "STOP." and mpi_aborts).
Here both raise exceptions carrying the same operator-facing wording; the
CLI driver catches them, prints the reference-format banner, and exits
nonzero (the single-process analog of mpi_abort).

FatalError subclasses ValueError so config-level call sites that
historically raised ValueError keep their contract.
"""

from __future__ import annotations


class FatalError(ValueError):
    """error_handler analog (utils.F90:16-33)."""

    def __init__(self, message: str, rc: int = -1):
        self.message = message
        self.rc = rc
        super().__init__(message)

    def banner(self) -> str:
        return f" - FATAL ERROR: \n{self.message}\n - IOSTAT IS: {self.rc}"


class NetCDFError(FatalError):
    """netcdf_err analog (utils.F90:39-58): context + library error text."""

    def __init__(self, context: str, errmsg: str, rc: int = -1):
        self.context = context
        self.errmsg = errmsg
        super().__init__(f"{context}: {errmsg}", rc=rc)

    def banner(self) -> str:
        return f"\nFATAL ERROR: {self.context}: {self.errmsg}\nSTOP."


def netcdf_guard(context: str):
    """Context manager converting raw reader errors (KeyError from a missing
    var/attr/dim, OSError from a bad file) into the reference's
    netcdf_err-style message for that read site, e.g.
    'reading field id - theta: NetCDF: Variable not found'."""
    return _NetCDFGuard(context)


class _NetCDFGuard:
    def __init__(self, context: str):
        self.context = context

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc is None or isinstance(exc, (FatalError, SystemExit)):
            return False
        if isinstance(exc, KeyError):
            raise NetCDFError(self.context,
                              "NetCDF: Variable not found") from exc
        if isinstance(exc, (OSError, ValueError)):
            raise NetCDFError(self.context, str(exc)) from exc
        return False
