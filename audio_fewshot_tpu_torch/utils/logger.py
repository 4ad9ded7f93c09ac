"""Logging: a named logger with a console handler and, on rank 0, a
rotating file handler in the result directory."""

from __future__ import annotations

import logging
import logging.handlers
import os
from typing import Optional

_LOGGER_NAME = "audio_fewshot_tpu_torch"


def init_logger(
    log_dir: Optional[str] = None,
    level: str = "info",
    file_name: Optional[str] = None,
    rank: int = 0,
) -> logging.Logger:
    logger = logging.getLogger(_LOGGER_NAME)
    logger.setLevel(getattr(logging, level.upper(), logging.INFO))
    for handler in logger.handlers:
        handler.close()
    logger.handlers.clear()
    logger.propagate = False
    fmt = logging.Formatter("[%(asctime)s] %(levelname)s %(message)s", datefmt="%m/%d %H:%M:%S")
    console = logging.StreamHandler()
    console.setFormatter(fmt)
    if rank != 0:  # the other ranks of a run print their warnings only
        console.setLevel(logging.WARNING)
    logger.addHandler(console)
    if rank == 0 and log_dir:
        os.makedirs(log_dir, exist_ok=True)
        fh = logging.handlers.RotatingFileHandler(
            os.path.join(log_dir, file_name or "test.log"),
            maxBytes=100 * 1024 * 1024, backupCount=3,
        )
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger
