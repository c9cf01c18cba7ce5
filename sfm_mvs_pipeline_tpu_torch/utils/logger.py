"""AppLogger equivalent: leveled, colored, mutex-serialized component logger.

Parity with the reference's logger (ref: src/photogrammetrie/util/AppLogger.{h,cpp}):
5 levels TRACE..ERROR, one global level, ANSI colors on ttys (forceable),
each line carrying elapsed seconds since process start + timestamp +
component name (AppLogger.cpp:40-94). In a process group of more than one
rank, each line also carries the rank (set_rank: "r1/2"); a line from a
shard thread of a mesh (parallel/distributed.py::Shards.run) carries its
shard index and its device instead (shard_tag: "c3/4 cuda:3").
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time
from datetime import datetime

TRACE, DEBUG, INFO, WARN, ERROR = range(5)
_NAMES = ["TRACE", "DEBUG", "INFO", "WARN", "ERROR"]
_COLORS = ["\033[90m", "\033[36m", "\033[32m", "\033[33m", "\033[31m"]
_RESET = "\033[0m"

_global_level = INFO
_force_color = False
_lock = threading.Lock()
_start = time.time()
_rank_tag = ""
_local = threading.local()  # the shard tag of a shard thread


def set_level(level: int) -> None:
    global _global_level
    _global_level = max(TRACE, min(ERROR, int(level)))


def get_level() -> int:
    return _global_level


def set_rank(rank: int, world_size: int) -> None:
    """Tag every line with "r<rank>/<world_size>" when world_size > 1."""
    global _rank_tag
    _rank_tag = f" r{rank}/{world_size}" if world_size > 1 else ""


@contextlib.contextmanager
def shard_tag(index: int, count: int, device):
    """Tag the calling thread's lines with "c<index>/<count> <device>",
    index the shard's place in a mesh of count."""
    _local.tag = f" c{index}/{count} {device}"
    try:
        yield
    finally:
        _local.tag = ""


def set_force_color(force: bool) -> None:
    global _force_color
    _force_color = bool(force)


class AppLogger:
    def __init__(self, component: str):
        self.component = component

    def _log(self, level: int, msg: str) -> None:
        if level < _global_level:
            return
        use_color = _force_color or sys.stdout.isatty()
        elapsed = time.time() - _start
        ts = datetime.now().strftime("%H:%M:%S")
        tag = getattr(_local, "tag", "") or _rank_tag
        line = f"[{elapsed:8.1f}s {ts} {_NAMES[level]:5s} {self.component}{tag}] {msg}"
        if use_color:
            line = _COLORS[level] + line + _RESET
        # one write a line: the ranks under torchrun share an unbuffered
        # stdout, where print's separate newline lets another rank's line in
        with _lock:
            sys.stdout.write(line + "\n")
            sys.stdout.flush()

    def trace(self, msg: str) -> None:
        self._log(TRACE, msg)

    def debug(self, msg: str) -> None:
        self._log(DEBUG, msg)

    def info(self, msg: str) -> None:
        self._log(INFO, msg)

    def warn(self, msg: str) -> None:
        self._log(WARN, msg)

    def error(self, msg: str) -> None:
        self._log(ERROR, msg)
