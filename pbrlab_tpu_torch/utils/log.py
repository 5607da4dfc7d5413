"""Structured logging for pbrlab_tpu_torch (port of pbrlab_tpu.utils.log).

One stdlib logger tree under "pbrlab_tpu_torch", with an opt-in JSON-lines
mode for machine readers. The reference logs through ad-hoc std::cerr
prints and lists a logger as a TODO (README.md:202-203).

Env (its only settings; no image depends on them):
  PBRLAB_LOG=debug|info|warning|error   level (default warning)
  PBRLAB_LOG_JSON=1                     one JSON object per line
"""
from __future__ import annotations

import json
import logging
import os
import sys
import time

_LOGGER_NAME = "pbrlab_tpu_torch"


class _JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": round(time.time(), 3),
            "level": record.levelname.lower(),
            "name": record.name,
            "msg": record.getMessage(),
        }
        extra = getattr(record, "fields", None)
        if extra:
            out.update(extra)
        return json.dumps(out)


def get_logger(name: str = "") -> logging.Logger:
    """Module logger; configures the root pbrlab_tpu_torch handler once."""
    root = logging.getLogger(_LOGGER_NAME)
    if not root.handlers:
        handler = logging.StreamHandler(sys.stderr)
        if os.environ.get("PBRLAB_LOG_JSON"):
            handler.setFormatter(_JsonFormatter())
        else:
            handler.setFormatter(logging.Formatter(
                "[%(levelname)s %(name)s] %(message)s"))
        root.addHandler(handler)
        level = os.environ.get("PBRLAB_LOG", "warning").upper()
        root.setLevel(getattr(logging, level, logging.WARNING))
        root.propagate = False
    return root.getChild(name) if name else root


def event(logger: logging.Logger, msg: str, level: str = "info",
          **fields) -> None:
    """Log `msg` at `level` with structured fields (JSON keys in JSON
    mode)."""
    logger.log(getattr(logging, level.upper()),
               msg + (" " + json.dumps(fields) if fields else ""),
               extra={"fields": fields})
