"""Run logger: timestamped file + stdout (replaces the MMLogger singleton,
reference ``train.py:64-68``) and a minimal scalar logger standing in for the
``WrappedTBWriter`` TensorBoard wrapper (``utils/tb_wrapper.py``) — scalars go
to a JSONL file the user can plot with any tool; if TensorBoard is available
it is used additionally.
"""
from __future__ import annotations

import importlib.util
import json
import logging
import os
import sys
import time
from typing import Optional


def get_logger(work_dir: Optional[str] = None, name: str = "selfocc") -> logging.Logger:
    logger = logging.getLogger(name)
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    logger.setLevel(logging.INFO)
    logger.propagate = False
    if not any(isinstance(h, logging.StreamHandler)
               and not isinstance(h, logging.FileHandler)
               for h in logger.handlers):
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    if work_dir:
        # a second driver in the same process must log into ITS work_dir —
        # add a file handler unless one already points there
        wd = os.path.abspath(work_dir)
        has = any(isinstance(h, logging.FileHandler)
                  and os.path.dirname(h.baseFilename) == wd
                  for h in logger.handlers)
        if not has:
            os.makedirs(work_dir, exist_ok=True)
            ts = time.strftime("%Y%m%d_%H%M%S")
            fh = logging.FileHandler(os.path.join(work_dir, f"{ts}.log"))
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    return logger


class ScalarWriter:
    """Append-only JSONL scalar log (+ optional TensorBoard)."""

    def __init__(self, work_dir: str):
        os.makedirs(work_dir, exist_ok=True)
        self._f = open(os.path.join(work_dir, "scalars.jsonl"), "a")
        self._tb = None
        # the port's one change to this copy: TensorBoard's writer imports
        # TensorFlow where it is installed, and TensorFlow imports JAX,
        # which the port must not load; there the JSONL log stands alone
        if importlib.util.find_spec("tensorflow") is not None:
            return
        try:
            from torch.utils.tensorboard import SummaryWriter
            self._tb = SummaryWriter(os.path.join(work_dir, "tb"))
        except Exception:
            pass

    def add_scalar(self, tag: str, value, step: int):
        self._f.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(step)}) + "\n")
        self._f.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()
