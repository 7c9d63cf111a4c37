"""Logging and metrics (a copy of uc2_tpu/utils/logger.py): the global
``LOGGER``, ``add_log_to_file``, ``TB_LOGGER`` (a TensorBoard wrapper with
its own global step that always appends its scalars to
``scalars.jsonl``, and writes TensorBoard events too when ``tensorboardX``
imports) and the EMA ``RunningMeter`` (smoothing 0.99).
"""

from __future__ import annotations

import json
import logging
import math
import os
from typing import Dict, Optional

_LOG_FMT = "%(asctime)s - %(levelname)s - %(name)s -   %(message)s"
_DATE_FMT = "%m/%d/%Y %H:%M:%S"
logging.basicConfig(format=_LOG_FMT, datefmt=_DATE_FMT, level=logging.INFO)
LOGGER = logging.getLogger("uc2_torch")
# INFO reaches the log file also where the root logger is set higher
LOGGER.setLevel(logging.INFO)


def add_log_to_file(log_path: str) -> logging.Handler:
    """Also write LOGGER's records to ``log_path``; returns the handler so a
    caller that runs several trainings in one process can remove it."""
    fh = logging.FileHandler(log_path)
    fh.setFormatter(logging.Formatter(_LOG_FMT, _DATE_FMT))
    LOGGER.addHandler(fh)
    return fh


class TensorboardLogger:
    """A TensorBoard writer carrying its own global step."""

    def __init__(self):
        self._logger = None
        self._jsonl = None
        # scalars logged without a step (validation) get step 0, as the
        # reference's wrapper, whose step nothing advances, gives them
        self._global_step = 0

    def create(self, path: str):
        """Start writing under ``path`` (closing an earlier target)."""
        self.close()
        os.makedirs(path, exist_ok=True)
        try:
            from tensorboardX import SummaryWriter
            self._logger = SummaryWriter(path)
        except ImportError:
            pass
        self._jsonl = open(os.path.join(path, "scalars.jsonl"), "a")

    def close(self):
        if self._logger is not None:
            self._logger.close()
            self._logger = None
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None

    def noop(self, *args, **kwargs):
        return

    def add_scalar(self, name: str, value, step: Optional[int] = None):
        if self._jsonl is None:
            return
        step = self._global_step if step is None else step
        if self._logger is not None:
            self._logger.add_scalar(name, value, step)
        self._jsonl.write(json.dumps(
            {"step": step, name: float(value)}) + "\n")

    def log_scalar_dict(self, log_dict: Dict, prefix: str = ""):
        if self._jsonl is None:
            return
        if prefix:
            prefix = f"{prefix}_"
        for name, value in log_dict.items():
            if isinstance(value, dict):
                self.log_scalar_dict(value, f"{prefix}{name}")
            else:
                self.add_scalar(f"{prefix}{name}", value)
        self._jsonl.flush()

    def flush(self):
        if self._jsonl is not None:
            self._jsonl.flush()

    def __getattr__(self, name):
        if self._logger is None:
            return self.noop
        return getattr(self._logger, name)


TB_LOGGER = TensorboardLogger()


class RunningMeter:
    """EMA loss meter, smooth = 0.99; NaN and inf readings are skipped."""

    def __init__(self, name: str, val: Optional[float] = None,
                 smooth: float = 0.99):
        self._name = name
        self._sm = smooth
        self._val = val

    def __call__(self, value: float):
        if math.isnan(value) or math.isinf(value):
            return
        self._val = (value if self._val is None
                     else value * (1 - self._sm) + self._val * self._sm)

    def __str__(self):
        return f"{self._name}: {self._val:.4f}"

    @property
    def val(self):
        return self._val

    @property
    def name(self):
        return self._name

