"""A small structured logger (the port's copy of the reference's
``utils.logger`` call style: ``logger.info("msg", key=value, ...)``)."""

from __future__ import annotations

import logging


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
