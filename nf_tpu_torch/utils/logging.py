"""Coloured console logger (counterpart of ``nf_tpu/utils/logging.py``):
``[LEVEL] HH:MM:SS name: message`` on stdout, the tag coloured with ANSI
codes when stdout is a terminal."""
from __future__ import annotations

import os
import sys
import time

_COLORS = {
    "DEBUG": "\033[36m",
    "INFO": "\033[32m",
    "WARN": "\033[33m",
    "ERROR": "\033[31m",
}
_RESET = "\033[0m"


class Logging:
    def __init__(self, name: str):
        self.name = os.path.basename(name)
        self.use_color = sys.stdout.isatty()

    def _emit(self, level: str, msg: str):
        tag = f"[{level}]"
        if self.use_color:
            tag = f"{_COLORS[level]}{tag}{_RESET}"
        print(f"{tag} {time.strftime('%H:%M:%S')} {self.name}: {msg}", flush=True)

    def debug(self, msg):
        self._emit("DEBUG", msg)

    def info(self, msg):
        self._emit("INFO", msg)

    def warn(self, msg):
        self._emit("WARN", msg)

    def error(self, msg):
        self._emit("ERROR", msg)
