"""Logging: stdout + in-app console dual sink.

Analog of the reference's spdlog setup (reference:
CudaRayTracer/src/Core/Log.cpp:8-19 — a stdout color sink plus a custom
ImGui sink forwarding every record to the in-app Console,
Core/ImGuiSink.h:9-15), with the `RT_*` level macros (Core/Log.h:20-32).

The console sink is any callable taking the formatted line (an in-app
console registers itself here).  Pattern matches the reference's
``%^[%T] %v%$`` (time + message).
"""

from __future__ import annotations

import logging
import sys
import time
from typing import Callable

_LOGGER_NAME = "cudaraytracer_tpu_torch"
_console_sinks: list[Callable[[str, int], None]] = []

_COLORS = {
    logging.DEBUG: "\x1b[37m",  # trace: white
    logging.INFO: "\x1b[32m",  # green
    logging.WARNING: "\x1b[33m",
    logging.ERROR: "\x1b[31m",
    logging.CRITICAL: "\x1b[41m",
}
_RESET = "\x1b[0m"


class _Formatter(logging.Formatter):
    def __init__(self, color: bool):
        super().__init__()
        self.color = color

    def format(self, record: logging.LogRecord) -> str:
        msg = f"[{time.strftime('%H:%M:%S', time.localtime(record.created))}] {record.getMessage()}"
        if self.color:
            return f"{_COLORS.get(record.levelno, '')}{msg}{_RESET}"
        return msg


class _ConsoleSinkHandler(logging.Handler):
    """Forwards every record to registered in-app console sinks
    (the ImGuiSink pattern, ImGuiSink.h:9-15)."""

    def emit(self, record: logging.LogRecord):
        line = _Formatter(color=False).format(record)
        for sink in list(_console_sinks):
            try:
                sink(line, record.levelno)
            except Exception:
                pass


_logger: logging.Logger | None = None


def init(level: int = logging.DEBUG, stream=None) -> logging.Logger:
    """Log::Init analog (Log.cpp:8-19).  Idempotent."""
    global _logger
    if _logger is not None:
        return _logger
    logger = logging.getLogger(_LOGGER_NAME)
    logger.setLevel(level)
    logger.propagate = False
    sh = logging.StreamHandler(stream or sys.stdout)
    sh.setFormatter(_Formatter(color=(stream or sys.stdout).isatty() if hasattr(stream or sys.stdout, "isatty") else False))
    logger.addHandler(sh)
    logger.addHandler(_ConsoleSinkHandler())
    _logger = logger
    return logger


def get() -> logging.Logger:
    return init()


def add_console_sink(sink: Callable[[str, int], None]):
    _console_sinks.append(sink)


def remove_console_sink(sink: Callable[[str, int], None]):
    if sink in _console_sinks:
        _console_sinks.remove(sink)


# RT_* macro equivalents (Log.h:20-32)
def rt_trace(msg, *a):
    get().debug(msg, *a)


def rt_info(msg, *a):
    get().info(msg, *a)


def rt_warn(msg, *a):
    get().warning(msg, *a)


def rt_error(msg, *a):
    get().error(msg, *a)


def rt_fatal(msg, *a):
    get().critical(msg, *a)
