"""Shared cross-package constants (reference: ``pkg/consts/consts.go``).

The reference defines zap-convention numeric log levels consumed by its
``logr`` loggers (consts.go:24-29: Error=-2, Warning=-1, Info=0, Debug=1,
with the note that a non-zap logger would need different values).  Python's
``logging`` uses its own scale; this module carries both the
reference-compatible verbosity numbers and their stdlib mapping so
consumers embedding the library into a logr-style stack can translate.
"""

from __future__ import annotations

import logging

# Reference zap-convention verbosity levels (consts.go:24-29).
LOG_LEVEL_ERROR = -2
LOG_LEVEL_WARNING = -1
LOG_LEVEL_INFO = 0
LOG_LEVEL_DEBUG = 1

#: zap-style verbosity → stdlib logging level.
TO_STDLIB_LEVEL = {
    LOG_LEVEL_ERROR: logging.ERROR,
    LOG_LEVEL_WARNING: logging.WARNING,
    LOG_LEVEL_INFO: logging.INFO,
    LOG_LEVEL_DEBUG: logging.DEBUG,
}


def stdlib_level(zap_level: int) -> int:
    """Translate a reference-style verbosity to a stdlib logging level.
    More-severe-than-Error values clamp to ERROR; chattier-than-Debug
    values clamp to DEBUG (zap's 'higher V = chattier' convention)."""
    if zap_level <= LOG_LEVEL_ERROR:
        return logging.ERROR
    return TO_STDLIB_LEVEL.get(zap_level, logging.DEBUG)
