"""The port's logger (counterpart of ``deepspeed_tpu/utils/logging.py``).

Writes to stderr so that a script's standard output stays its own.
"""

from __future__ import annotations

import logging
import sys


def create_logger(name: str = "DeepSpeedTorch",
                  level: int = logging.INFO) -> logging.Logger:
    logger_ = logging.getLogger(name)
    logger_.setLevel(level)
    logger_.propagate = False
    if not logger_.handlers:
        handler = logging.StreamHandler(stream=sys.stderr)
        handler.setFormatter(logging.Formatter(
            "[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s"))
        logger_.addHandler(handler)
    return logger_


logger = create_logger()
