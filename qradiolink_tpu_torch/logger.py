"""Timestamped file+console logger (a copy of qradiolink_tpu/logger.py;
reference src/logger.{h,cpp}: 5 levels, qradiolink.log). A thin
configuration of the stdlib logging module with the reference's format."""

from __future__ import annotations

import logging
import sys
from pathlib import Path

_FMT = "[%(asctime)s] %(levelname)s: %(message)s"
_DATEFMT = "%Y-%m-%d %H:%M:%S"


def get_logger(name: str = "qradiolink_tpu_torch", logfile=None,
               level=logging.INFO, console: bool = True) -> logging.Logger:
    log = logging.getLogger(name)
    if log.handlers:
        return log
    log.setLevel(level)
    fmt = logging.Formatter(_FMT, _DATEFMT)
    if console:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(fmt)
        log.addHandler(h)
    if logfile:
        Path(logfile).parent.mkdir(parents=True, exist_ok=True)
        fh = logging.FileHandler(logfile)
        fh.setFormatter(fmt)
        log.addHandler(fh)
    return log
