"""Structured logging for the framework.

Standard library only; a copy of ``efa_xray_tpu/utils/logging.py:1-40``.

The reference communicates through bare ``print`` calls guarded by a
``verbose`` flag (``efa_xray/assimilation/assimilation.py:63-69,133-141``,
``ensrf.py:34,49-51``).  Here the same messages flow through a standard
:mod:`logging` logger (``efa_xray_tpu_torch``), so production deployments can
route/filter/structure them; ``verbose=True`` simply lowers the logger's
effective threshold so the familiar messages still appear on stderr.
"""

from __future__ import annotations

import logging
import sys

logger = logging.getLogger("efa_xray_tpu_torch")

_handler_installed = False


def _ensure_handler() -> None:
    global _handler_installed
    if _handler_installed or logger.handlers:
        return
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(
        logging.Formatter("%(asctime)s %(name)s %(levelname)s: %(message)s")
    )
    logger.addHandler(handler)
    _handler_installed = True


def verbose_logger(verbose: bool) -> logging.Logger:
    """Logger honoring the reference-style ``verbose`` flag: INFO messages
    are visible when verbose, suppressed otherwise (unless the application
    configured its own handlers/levels)."""
    _ensure_handler()
    if verbose and logger.level in (logging.NOTSET, logging.WARNING):
        logger.setLevel(logging.INFO)
    return logger
