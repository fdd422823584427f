"""The port's root logger: a stream handler, plus a file handler for each
log file asked for (port of `ld_tpu/utils/logging.py`)."""
from __future__ import annotations

import logging
import os
from typing import Optional

_FORMAT = '%(asctime)s - %(name)s - %(levelname)s - %(message)s'


def get_root_logger(log_file: Optional[str] = None,
                    log_level=logging.INFO) -> logging.Logger:
    """The 'ld_tpu_torch' logger. The first call adds a stream handler;
    each call with a new `log_file` adds a file handler for it, so every
    training run writes its own `train.log`."""
    logger = logging.getLogger('ld_tpu_torch')
    logger.setLevel(log_level)
    fmt = logging.Formatter(_FORMAT)
    if not any(type(h) is logging.StreamHandler for h in logger.handlers):
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    if log_file:
        path = os.path.abspath(log_file)
        if not any(isinstance(h, logging.FileHandler) and
                   h.baseFilename == path for h in logger.handlers):
            fh = logging.FileHandler(path)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    return logger


def close_file_handler(logger: logging.Logger, log_file: str):
    """Detach and close the file handler of `log_file`, if there is one."""
    path = os.path.abspath(log_file)
    for h in list(logger.handlers):
        if isinstance(h, logging.FileHandler) and h.baseFilename == path:
            logger.removeHandler(h)
            h.close()
