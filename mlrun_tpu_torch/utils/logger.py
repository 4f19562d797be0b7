"""Structured logging — the port's copy of ``mlrun_tpu/utils/logger.py``
(``Logger``, ``create_logger``, ``JSONFormatter``, ``HumanFormatter``: a
stdlib logger that takes ``key=value`` fields and renders them
human-readable or as JSON lines) and the package's own ``logger``, which
writes ``message key=value ...`` records to the ``mlrun_tpu_torch``
stdlib logger and leaves handlers and levels to the application."""

from __future__ import annotations

import json
import logging
import sys
from datetime import datetime, timezone
from typing import IO


class HumanFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        ts = datetime.fromtimestamp(record.created, tz=timezone.utc).strftime(
            "%Y-%m-%d %H:%M:%S.%f"
        )[:-3]
        more = ""
        extra = getattr(record, "with_", None)
        if extra:
            more = " " + json.dumps(extra, default=str, sort_keys=True)
        return (f"> {ts} [{record.levelname.lower()}] "
                f"{record.getMessage()}{more}")


class JSONFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        payload = {
            "datetime": datetime.fromtimestamp(
                record.created, tz=timezone.utc
            ).isoformat(),
            "level": record.levelname.lower(),
            "message": record.getMessage(),
            "with": getattr(record, "with_", {}) or {},
        }
        return json.dumps(payload, default=str)


class Logger:
    def __init__(self, name: str, level: str = "INFO",
                 stream: IO | None = None, fmt: str = "human"):
        self._logger = logging.getLogger(name)
        self._logger.propagate = False
        self._logger.setLevel(level.upper())
        handler = logging.StreamHandler(stream or sys.stdout)
        handler.setFormatter(JSONFormatter() if fmt == "json"
                             else HumanFormatter())
        self._logger.handlers = [handler]

    def set_level(self, level: str):
        self._logger.setLevel(level.upper())

    def _log(self, level: int, message: str, **kwargs):
        self._logger.log(level, message, extra={"with_": kwargs})

    def debug(self, message: str, **kwargs):
        self._log(logging.DEBUG, message, **kwargs)

    def info(self, message: str, **kwargs):
        self._log(logging.INFO, message, **kwargs)

    def warning(self, message: str, **kwargs):
        self._log(logging.WARNING, message, **kwargs)

    warn = warning

    def error(self, message: str, **kwargs):
        self._log(logging.ERROR, message, **kwargs)

    def exception(self, message: str, **kwargs):
        self._logger.error(message, exc_info=True, extra={"with_": kwargs})


def create_logger(level: str = "INFO", fmt: str = "human",
                  name: str = "mlrun-tpu", stream: IO | None = None) -> Logger:
    return Logger(name, level=level, stream=stream, fmt=fmt)


class _Logger:
    def __init__(self, name: str = "mlrun_tpu_torch"):
        self._log = logging.getLogger(name)

    def _emit(self, level: int, message: str, **fields):
        if fields:
            message = message + " " + " ".join(
                f"{k}={v}" for k, v in fields.items())
        self._log.log(level, message)

    def debug(self, message: str, **fields):
        self._emit(logging.DEBUG, message, **fields)

    def info(self, message: str, **fields):
        self._emit(logging.INFO, message, **fields)

    def warning(self, message: str, **fields):
        self._emit(logging.WARNING, message, **fields)

    def error(self, message: str, **fields):
        self._emit(logging.ERROR, message, **fields)


logger = _Logger()
