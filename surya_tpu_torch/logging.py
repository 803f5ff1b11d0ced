"""The port's logger: one ``surya_tpu_torch`` namespace logger, configured
once on import (counterpart of surya_tpu/logging.py).

The level comes from ``settings.LOGLEVEL``; the port's modules log through
``get_logger()`` or ``logging.getLogger(__name__)``, a child of it.
FutureWarnings are silenced, as in the JAX package.
"""

import logging
import warnings

from surya_tpu_torch.settings import settings

_LOGGER_NAME = "surya_tpu_torch"
_LINE_FORMAT = "%(asctime)s [%(levelname)s] %(name)s: %(message)s"


def get_logger() -> logging.Logger:
    return logging.getLogger(_LOGGER_NAME)


def configure_logging() -> None:
    """Idempotent: attaches one stream handler and applies the configured
    level; safe to call again after changing settings.LOGLEVEL."""
    logger = get_logger()
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(_LINE_FORMAT))
        logger.addHandler(handler)
    logger.setLevel(settings.LOGLEVEL)
    warnings.simplefilter(action="ignore", category=FutureWarning)


configure_logging()
