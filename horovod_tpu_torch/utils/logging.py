"""Leveled logging controlled by ``HOROVOD_LOG_LEVEL`` and
``HOROVOD_LOG_HIDE_TIME`` (counterpart of horovod_tpu/utils/logging.py,
with a TRACE level below DEBUG)."""

import logging
import os

TRACE = 5
logging.addLevelName(TRACE, "TRACE")

_LEVELS = {
    "trace": TRACE,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "fatal": logging.CRITICAL,
}


def get_logger(name="horovod_tpu_torch"):
    logger = logging.getLogger(name)
    if not getattr(logger, "_hvd_configured", False):
        level = os.environ.get("HOROVOD_LOG_LEVEL", "warning").lower()
        logger.setLevel(_LEVELS.get(level, logging.WARNING))
        handler = logging.StreamHandler()
        if os.environ.get("HOROVOD_LOG_HIDE_TIME", "") in ("", "0", "false",
                                                          "False"):
            fmt = "[%(asctime)s] [%(levelname)s] %(message)s"
        else:
            fmt = "[%(levelname)s] %(message)s"
        handler.setFormatter(logging.Formatter(fmt))
        logger.addHandler(handler)
        logger.propagate = False
        logger._hvd_configured = True
    return logger
