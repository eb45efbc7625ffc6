"""Module logger registry — parity with the reference's ``logger/`` package.

The reference exposes per-module loggers with settable levels
(logger/logger.go: GetLogger(pkgName) + SetLogLevel); this maps onto
Python's stdlib logging with a ``dragonboat_tpu.<module>`` namespace so
applications can route/filter with standard tooling.
"""

from __future__ import annotations

import logging

_ROOT = "dragonboat_tpu"

CRITICAL = logging.CRITICAL
ERROR = logging.ERROR
WARNING = logging.WARNING
INFO = logging.INFO
DEBUG = logging.DEBUG

_LEVELS = {
    "CRITICAL": CRITICAL,
    "ERROR": ERROR,
    "WARNING": WARNING,
    "INFO": INFO,
    "DEBUG": DEBUG,
}


def get_logger(pkg_name: str) -> logging.Logger:
    """GetLogger (logger/logger.go): the module logger for pkg_name."""
    return logging.getLogger(f"{_ROOT}.{pkg_name}")


def set_log_level(pkg_name: str, level: int | str) -> None:
    """SetLogLevel: adjust one module's verbosity at runtime."""
    if isinstance(level, str):
        level = _LEVELS[level.upper()]
    get_logger(pkg_name).setLevel(level)


def set_default_log_level(level: int | str) -> None:
    if isinstance(level, str):
        level = _LEVELS[level.upper()]
    logging.getLogger(_ROOT).setLevel(level)


# library convention: attach only a NullHandler and keep propagation on —
# the application routes dragonboat_tpu.* through its own logging config
# (the reference similarly lets callers install their own ILogger factory)
logging.getLogger(_ROOT).addHandler(logging.NullHandler())
