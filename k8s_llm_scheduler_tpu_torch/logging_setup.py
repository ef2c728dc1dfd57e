"""Structured logging setup (a copy of the JAX package's, for the port's
logger tree).

Behavioral parity with the reference's module-level logging config (reference
scheduler.py:26-41): level and format chosen from config/env. The reference's
"json" format is just the bare message (scheduler.py:31-34); here json format
emits real JSON lines with timestamp/level/logger/message.
"""

from __future__ import annotations

import json
import logging
import sys
from typing import Any


class JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        payload: dict[str, Any] = {
            "ts": self.formatTime(record, "%Y-%m-%dT%H:%M:%S"),
            "level": record.levelname,
            "logger": record.name,
            "message": record.getMessage(),
        }
        if record.exc_info:
            payload["exc"] = self.formatException(record.exc_info)
        return json.dumps(payload)


def setup_logging(level: str = "INFO", fmt: str = "text", file: str | None = None) -> None:
    handlers: list[logging.Handler] = []
    stream = logging.StreamHandler(sys.stderr)
    handlers.append(stream)
    if file:
        handlers.append(logging.FileHandler(file))

    formatter: logging.Formatter
    if fmt == "json":
        formatter = JsonFormatter()
    else:
        formatter = logging.Formatter(
            "%(asctime)s - %(name)s - %(levelname)s - %(message)s"
        )
    root = logging.getLogger("k8s_llm_scheduler_tpu_torch")
    root.setLevel(getattr(logging, level.upper(), logging.INFO))
    root.handlers.clear()
    for handler in handlers:
        handler.setFormatter(formatter)
        root.addHandler(handler)
