"""Leveled logger mirroring the reference's Logger singleton.

Reference: RayZen/include/Logger.h:6-38 — a 3-level (DEBUG/INFO/ERROR) mutex-guarded
stream logger controlled by --log= CLI flags (RayZen/src/main.cpp:141-145). Here we
wrap Python's logging with the same three-level surface.
"""

from __future__ import annotations

import logging
import sys

_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "error": logging.ERROR,
}

_logger = logging.getLogger("rayzen")
if not _logger.handlers:
    _handler = logging.StreamHandler(sys.stderr)
    _handler.setFormatter(logging.Formatter("[%(levelname)s] %(message)s"))
    _logger.addHandler(_handler)
    _logger.setLevel(logging.INFO)
    _logger.propagate = False


def set_level(level: str) -> None:
    """Set log level by name: "debug" | "info" | "error" (Logger.h:10)."""
    _logger.setLevel(_LEVELS[level.lower()])


def debug(msg: str) -> None:
    _logger.debug(msg)


def info(msg: str) -> None:
    _logger.info(msg)


def error(msg: str) -> None:
    _logger.error(msg)
