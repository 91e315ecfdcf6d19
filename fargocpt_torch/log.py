"""Leveled logging (reference src/logging.cpp + logging.h).

Re-derivation of the reference's syslog-style logger for a
single-process runtime: six levels (0 error .. 5 debug), a global
``print_level`` gate (messages with level <= print_level are shown, the
reference's ``logging::print_level``), an ``error_level`` split routing
low levels to stderr, per-run log files ``logs/log_0.txt`` /
``logs/err_0.txt`` (the reference's per-rank files; rank is always 0
here), and buffering of pre-init lines that is flushed into the log
file once the output directory exists (reference ``header_buffer``,
src/logging.cpp:40-73).
"""

from __future__ import annotations

import sys
import time as _time
from pathlib import Path

ERROR, WARNING, NOTICE, INFO, VERBOSE, DEBUG = range(6)
_NAMES = ["ERROR", "WARNING", "NOTICE", "INFO", "VERBOSE", "DEBUG"]

# messages with level <= print_level are printed (reference
# src/logging.cpp:25); -q sets 1, -v sets 4, -d sets 5 (src/options.cpp)
print_level: int = INFO
# messages with level <= error_level go to stderr (src/logging.cpp:28)
error_level: int = ERROR
# 0 none, 1 unix timestamp, 2 UTC, 3 local (src/logging.cpp:104-124)
time_format: int = 0

_logfile = None
_errfile = None
_header_buffer: list[str] = []


def set_print_level(level: int) -> None:
    global print_level
    print_level = int(level)


def _stamp() -> str:
    if time_format == 1:
        return f"[{int(_time.time())}] "
    if time_format == 2:
        return "[" + _time.strftime("%Y-%m-%d %H:%M:%S",
                                    _time.gmtime()) + "] "
    if time_format == 3:
        return "[" + _time.strftime("%Y-%m-%d %H:%M:%S %Z") + "] "
    return ""


def init_logfiles(outdir) -> None:
    """Open logs/log_0.txt + logs/err_0.txt under the run directory and
    flush the pre-init buffer (reference init_logfiles,
    src/logging.cpp:57-73)."""
    global _logfile, _errfile
    logs = Path(outdir) / "logs"
    logs.mkdir(parents=True, exist_ok=True)
    _logfile = open(logs / "log_0.txt", "a")
    _errfile = open(logs / "err_0.txt", "a")
    for line in _header_buffer:
        _logfile.write(line)
    _logfile.flush()
    _header_buffer.clear()


def finalize() -> None:
    global _logfile, _errfile
    for fh in (_logfile, _errfile):
        if fh is not None:
            fh.close()
    _logfile = _errfile = None


def log(level: int, msg: str) -> None:
    """Print ``msg`` at ``level`` (reference vprint,
    src/logging.cpp:85-160): gate on print_level, route by error_level,
    mirror into the open log/err file — pre-init lines are buffered."""
    if level > print_level:
        return
    line = _stamp() + msg
    if not line.endswith("\n"):
        line += "\n"
    is_err = level <= error_level
    stream = sys.stderr if is_err else sys.stdout
    stream.write(line)
    try:
        stream.flush()
    except Exception:
        pass
    if _logfile is None:
        if not is_err:
            _header_buffer.append(line)
        return
    fh = _errfile if is_err else _logfile
    fh.write(line)
    fh.flush()


def error(msg: str) -> None:
    log(ERROR, msg)


def warning(msg: str) -> None:
    log(WARNING, msg)


def notice(msg: str) -> None:
    log(NOTICE, msg)


def info(msg: str) -> None:
    log(INFO, msg)


def verbose(msg: str) -> None:
    log(VERBOSE, msg)


def debug(msg: str) -> None:
    log(DEBUG, msg)
