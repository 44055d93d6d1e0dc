"""Experiment provenance and metric logging, the minimal part.

Counterpart of ``ppt_tpu/utils/logging_utils.py``: the arguments go to
``provenance.json`` and each logged entry to ``metrics.jsonl`` (one JSON
object per line, the reference's format) under
``<output_dir>/<exp_name or task>``. The wandb fan-out is not ported.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from typing import Any, Dict, Optional


class ExperimentLogger:
    def __init__(self, args, task_name: str = ""):
        self.dir = os.path.join(args.output_dir, args.exp_name or task_name or "exp")
        os.makedirs(self.dir, exist_ok=True)
        self._jsonl = open(os.path.join(self.dir, "metrics.jsonl"), "a")
        fields = dataclasses.asdict(args) if dataclasses.is_dataclass(args) else vars(args)
        provenance = {
            "argv": sys.argv,
            "start_time": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "args": {k: v for k, v in fields.items()
                     if isinstance(v, (int, float, str, bool, list, tuple, type(None)))},
        }
        with open(os.path.join(self.dir, "provenance.json"), "w") as f:
            json.dump(provenance, f, indent=2, default=str)

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        record = {"step": step, **{k: v for k, v in metrics.items()
                                   if isinstance(v, (int, float, str))}}
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()

    def close(self) -> None:
        self._jsonl.close()
