"""rt_printf-equivalent debug logging (reference inc/rt/rt.h:103-222).

The reference prefixes every debug line with ``file(line): function`` from a
thread-local buffer. Here: a stdlib logger whose formatter produces the same
prefix shape, resolved from the caller's frame — enable with
``SQZ_DEBUG=1`` (or ``configure(True)``), off by default exactly like the
reference's debug-build gating.
"""

from __future__ import annotations

import inspect
import logging
import os
import sys

_logger = logging.getLogger("sqz_tpu")
_configured = False


def configure(enabled: bool | None = None) -> logging.Logger:
    """Idempotent setup; ``enabled`` defaults to the SQZ_DEBUG env var
    and, once set explicitly, is not downgraded by later implicit calls."""
    global _configured
    explicit = enabled is not None
    if enabled is None:
        enabled = os.environ.get("SQZ_DEBUG", "") not in ("", "0")
    if not _configured:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter("%(message)s"))
        _logger.addHandler(h)
        _logger.propagate = False
        _configured = True
        explicit = True
    if explicit:
        _logger.setLevel(logging.DEBUG if enabled else logging.WARNING)
    return _logger


def debug(fmt: str, *args) -> None:
    """``rt_println`` analog: file(line): function prefix + message."""
    configure()
    if not _logger.isEnabledFor(logging.DEBUG):
        return
    # frame attributes only — inspect.getframeinfo would re-read and parse
    # the caller's source file on every call
    fr = inspect.currentframe().f_back
    code = fr.f_code
    msg = fmt % args if args else fmt
    _logger.debug("%s(%d): %s %s",
                  os.path.basename(code.co_filename), fr.f_lineno,
                  code.co_name, msg)
