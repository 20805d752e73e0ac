"""Logging setup (port of hairpt/utils/log.py): level-filtered logging to
stderr, an optional file appender, mitsuba's line layout and `-w`
warnings-as-errors. The logger is named 'hairpt', as the JAX package's."""
from __future__ import annotations

import logging
import sys

# mitsuba levels: ETrace < EDebug < EInfo < EWarn < EError
TRACE = 5
logging.addLevelName(TRACE, "TRAC")

_FMT = "%(asctime)s %(levelname).4s %(name)s: %(message)s"
_DATEFMT = "%Y-%m-%d %H:%M:%S"


class _WarnAsError(logging.Handler):
    def emit(self, record):
        if record.levelno >= logging.WARNING:
            raise RuntimeError(
                f"warning treated as error (-w): {record.getMessage()}")


def setup(verbosity: int = 0, quiet: bool = False,
          logfile: str | None = None,
          warnings_as_errors: bool = False) -> logging.Logger:
    """Configure the root 'hairpt' logger.

    verbosity 0 -> INFO, 1 -> DEBUG, >= 2 -> TRACE (mitsuba -v / -vv);
    quiet -> WARNING only; logfile adds a file appender."""
    log = logging.getLogger("hairpt")
    log.handlers.clear()
    if quiet:
        level = logging.WARNING
    else:
        level = {0: logging.INFO, 1: logging.DEBUG}.get(verbosity, TRACE)
    log.setLevel(level)
    fmt = logging.Formatter(_FMT, _DATEFMT)
    h = logging.StreamHandler(sys.stderr)
    h.setFormatter(fmt)
    log.addHandler(h)
    if logfile:
        fh = logging.FileHandler(logfile)
        fh.setFormatter(fmt)
        log.addHandler(fh)
    if warnings_as_errors:
        log.addHandler(_WarnAsError())
    log.propagate = False
    return log


def get(name: str = "") -> logging.Logger:
    return logging.getLogger(f"hairpt.{name}" if name else "hairpt")
