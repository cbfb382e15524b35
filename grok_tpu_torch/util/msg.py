"""Three-level message handler surface (grk_set_msg_handlers analog;
upstream opj_set_{info,warning,error}_handler verified in SURVEY.md §1.1).

Library code reports through info/warn/error; applications install
callbacks with set_msg_handlers().  Defaults route to Python logging
(logger "grok_tpu_torch", where the port's other warnings go).  The
port's copy of grok_tpu/util/msg.py.
"""

from __future__ import annotations

import logging
from typing import Callable

_logger = logging.getLogger("grok_tpu_torch")

_info: Callable[[str], None] | None = None
_warn: Callable[[str], None] | None = None
_error: Callable[[str], None] | None = None


def set_msg_handlers(info: Callable[[str], None] | None = None,
                     warning: Callable[[str], None] | None = None,
                     error: Callable[[str], None] | None = None):
    """Install (or clear, with None) per-level message callbacks."""
    global _info, _warn, _error
    _info, _warn, _error = info, warning, error


def info(msg: str):
    (_info or _logger.info)(msg)


def warn(msg: str):
    (_warn or _logger.warning)(msg)


def error(msg: str):
    (_error or _logger.error)(msg)
