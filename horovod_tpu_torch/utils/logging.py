"""Leveled logging controlled by ``HOROVOD_LOG_LEVEL`` and
``HOROVOD_LOG_HIDE_TIME``, read through ``Config.from_env()``
(counterpart of horovod_tpu/utils/logging.py, with a TRACE level below
DEBUG)."""

import logging

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
        from ..config import Config
        cfg = Config.from_env()
        logger.setLevel(_LEVELS.get(cfg.log_level.lower(), logging.WARNING))
        handler = logging.StreamHandler()
        if not cfg.log_hide_time:
            fmt = "[%(asctime)s] [%(levelname)s] %(message)s"
        else:
            fmt = "[%(levelname)s] %(message)s"
        handler.setFormatter(logging.Formatter(fmt))
        logger.addHandler(handler)
        logger.propagate = False
        logger._hvd_configured = True
    return logger
