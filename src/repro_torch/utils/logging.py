"""Minimal structured logger used across the port (a copy of
``repro/utils/logging.py`` under the ``repro_torch.`` logger names).

It avoids the stdlib logging global config (a library should not mutate
the root logger of the host application) and keeps a tiny wrapper that
callers can silence or redirect.
"""

from __future__ import annotations

import logging
import sys

_FORMAT = "%(asctime)s %(name)s %(levelname)s %(message)s"
_configured: set[str] = set()


def get_logger(name: str, level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(f"repro_torch.{name}")
    if name not in _configured:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
        logger.addHandler(handler)
        logger.setLevel(level)
        logger.propagate = False
        _configured.add(name)
    return logger
