"""Console logging on process 0 and a log file per process.

The port's copy of ``simpledepthestimation_tpu/utils/logger.py``: the package
logger (``simpledepthestimation_tpu_torch``) writes to standard output on
rank 0, coloured on a terminal, and to ``<output>/log.txt`` (``.rankN`` on
other ranks).
"""

from __future__ import annotations

import atexit
import functools
import logging
import os
import sys
import time
from typing import Optional

_LOG_TIMER: dict = {}


class _ColorFormatter(logging.Formatter):
    COLORS = {"WARNING": "\033[33m", "ERROR": "\033[31m", "CRITICAL": "\033[31m"}

    def format(self, record):
        out = super().format(record)
        color = self.COLORS.get(record.levelname)
        if color and sys.stdout.isatty():
            out = color + out + "\033[0m"
        return out


@functools.lru_cache(maxsize=None)
def _cached_stream(filename: str):
    os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
    io = open(filename, "a", buffering=1024)
    atexit.register(io.close)
    return io


def setup_logger(
    output: Optional[str] = None,
    distributed_rank: int = 0,
    *,
    name: str = "simpledepthestimation_tpu_torch",
) -> logging.Logger:
    """Attach the console and file handlers to logger ``name`` once. A later
    call with another ``output`` adds that file too."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False

    if distributed_rank == 0 and not any(getattr(h, "_sde_console", False) for h in logger.handlers):
        ch = logging.StreamHandler(stream=sys.stdout)
        ch.setLevel(logging.DEBUG)
        ch.setFormatter(_ColorFormatter("[%(asctime)s %(name)s]: %(message)s", datefmt="%m/%d %H:%M:%S"))
        ch._sde_console = True
        logger.addHandler(ch)

    if output is not None:
        filename = output if output.endswith((".txt", ".log")) else os.path.join(output, "log.txt")
        if distributed_rank > 0:
            filename = f"{filename}.rank{distributed_rank}"
        filename = os.path.abspath(filename)
        if not any(getattr(h, "_sde_file", None) == filename for h in logger.handlers):
            fh = logging.StreamHandler(_cached_stream(filename))
            fh.setLevel(logging.DEBUG)
            fh.setFormatter(logging.Formatter(
                "[%(asctime)s] %(name)s %(levelname)s: %(message)s", datefmt="%m/%d %H:%M:%S"))
            fh._sde_file = filename
            logger.addHandler(fh)
    return logger


def log_every_n_seconds(lvl: int, msg: str, n: float = 1, *, name: Optional[str] = None) -> None:
    """Log ``msg`` from one call site at most once every ``n`` seconds."""
    caller_module, key = _find_caller()
    last_logged = _LOG_TIMER.get(key)
    now = time.time()
    if last_logged is None or now - last_logged >= n:
        logging.getLogger(name or caller_module).log(lvl, msg)
        _LOG_TIMER[key] = now


def _find_caller():
    frame = sys._getframe(2)
    while frame:
        code = frame.f_code
        if os.path.join("utils", "logger.") not in code.co_filename:
            return frame.f_globals.get("__name__", "?"), (code.co_filename, frame.f_lineno, code.co_name)
        frame = frame.f_back
    return "?", ("?", 0, "?")
