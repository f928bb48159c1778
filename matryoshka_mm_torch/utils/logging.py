"""Logging utilities (reference: llava/utils.py:17-126); the port's own
copy of ``matryoshka_mm_tpu/utils/logging.py``.

``build_logger`` writes to stdout and a rotating per-day file; stdout and
stderr are redirected into the logger so serving components capture
everything.  The serving modules call it when they are imported, as the
reference's do: a program that imports one and must keep its own stdout
saves ``sys.stdout`` / ``sys.stderr`` first and puts them back after.
"""

from __future__ import annotations

import datetime
import logging
import logging.handlers
import os
import sys

from ..constants import LOGDIR

server_error_msg = ("**NETWORK ERROR DUE TO HIGH TRAFFIC. PLEASE REGENERATE "
                    "OR REFRESH THIS PAGE.**")
moderation_msg = ("YOUR INPUT VIOLATES OUR CONTENT MODERATION GUIDELINES. "
                  "PLEASE TRY AGAIN.")

handler = None


def build_logger(logger_name: str, logger_filename: str) -> logging.Logger:
    global handler

    formatter = logging.Formatter(
        fmt="%(asctime)s | %(levelname)s | %(name)s | %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S",
    )

    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO)
    logging.getLogger().handlers[0].setFormatter(formatter)

    stdout_logger = logging.getLogger("stdout")
    stdout_logger.setLevel(logging.INFO)
    sys.stdout = StreamToLogger(stdout_logger, logging.INFO)

    stderr_logger = logging.getLogger("stderr")
    stderr_logger.setLevel(logging.ERROR)
    sys.stderr = StreamToLogger(stderr_logger, logging.ERROR)

    logger = logging.getLogger(logger_name)
    logger.setLevel(logging.INFO)

    if handler is None:
        os.makedirs(LOGDIR, exist_ok=True)
        filename = os.path.join(LOGDIR, logger_filename)
        handler = logging.handlers.TimedRotatingFileHandler(
            filename, when="D", utc=True, encoding="utf-8")
        handler.setFormatter(formatter)
        for name, item in logging.root.manager.loggerDict.items():
            if isinstance(item, logging.Logger):
                item.addHandler(handler)

    return logger


class StreamToLogger:
    """Fake file-like stream that redirects writes to a logger."""

    def __init__(self, logger, log_level=logging.INFO):
        self.terminal = sys.stdout
        self.logger = logger
        self.log_level = log_level
        self.linebuf = ""

    def __getattr__(self, attr):
        return getattr(self.terminal, attr)

    def write(self, buf):
        temp_linebuf = self.linebuf + buf
        self.linebuf = ""
        for line in temp_linebuf.splitlines(True):
            if line[-1] == "\n":
                self.logger.log(self.log_level, line.rstrip())
            else:
                self.linebuf += line

    def flush(self):
        if self.linebuf != "":
            self.logger.log(self.log_level, self.linebuf.rstrip())
        self.linebuf = ""


def pretty_print_semaphore(semaphore) -> str:
    if semaphore is None:
        return "None"
    return (f"Semaphore(value={semaphore._value}, "
            f"locked={semaphore.locked()})")


def violates_moderation(text: str) -> bool:
    """Content-moderation hook (reference: llava/utils.py:96-115).  With
    OPENAI_API_KEY set, posts to the OpenAI moderation endpoint and returns
    its flagged verdict; offline (or on any API failure) returns False —
    fail-open like the reference."""
    import os

    api_key = os.environ.get("OPENAI_API_KEY")
    if not api_key:
        return False
    import requests

    base = os.environ.get("OPENAI_BASE_URL", "https://api.openai.com/v1")
    try:
        r = requests.post(
            f"{base}/moderations",
            headers={"Authorization": f"Bearer {api_key}"},
            json={"input": text.replace("\n", "")}, timeout=10)
        r.raise_for_status()
        return bool(r.json()["results"][0]["flagged"])
    except Exception:  # noqa: BLE001 — fail-open (reference behavior)
        return False
