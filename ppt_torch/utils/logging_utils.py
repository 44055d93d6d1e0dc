"""Experiment provenance and metric logging.

Counterpart of ``ppt_tpu/utils/logging_utils.py``: the arguments, the
argv and the git revision of the sources go to ``provenance.json``, and
each logged entry to ``metrics.jsonl`` (one JSON object per line, the
reference's format) under ``<output_dir>/<exp_name or task>``. With
``args.wandb`` the entries fan out to wandb too (project
``args.proj_name``), when the package is installed; without it a warning
says so and the files are written as before.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import subprocess
import sys
import time
from typing import Any, Dict, Optional

log = logging.getLogger(__name__)


def _git_rev() -> Optional[str]:
    """The checkout's commit, or None outside a git checkout."""
    try:
        return subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True, timeout=5,
            cwd=os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        ).stdout.strip() or None
    except Exception:
        return None


class ExperimentLogger:
    def __init__(self, args, task_name: str = ""):
        self.dir = os.path.join(args.output_dir, args.exp_name or task_name or "exp")
        os.makedirs(self.dir, exist_ok=True)
        self._jsonl = open(os.path.join(self.dir, "metrics.jsonl"), "a")
        self._wandb = None
        fields = dataclasses.asdict(args) if dataclasses.is_dataclass(args) else vars(args)
        provenance = {
            "git_rev": _git_rev(),
            "argv": sys.argv,
            "start_time": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "args": {k: v for k, v in fields.items()
                     if isinstance(v, (int, float, str, bool, list, tuple, type(None)))},
        }
        with open(os.path.join(self.dir, "provenance.json"), "w") as f:
            json.dump(provenance, f, indent=2, default=str)
        if getattr(args, "wandb", False):
            try:
                import wandb

                self._wandb = wandb.init(project=getattr(args, "proj_name", "PPT_TPU"),
                                         name=args.exp_name or task_name,
                                         config=provenance["args"])
            except ImportError:
                log.warning("--wandb requested but wandb is not installed")

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        record = {"step": step, **{k: v for k, v in metrics.items()
                                   if isinstance(v, (int, float, str))}}
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def close(self) -> None:
        self._jsonl.close()
        if self._wandb is not None:
            self._wandb.finish()


class NullLogger:
    """The logger of a rank other than 0: it writes nothing (``dir`` names
    rank 0's directory)."""

    def __init__(self, args, task_name: str = ""):
        self.dir = os.path.join(args.output_dir, args.exp_name or task_name or "exp")

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        pass

    def close(self) -> None:
        pass


def experiment_logger(args, task_name: str = ""):
    """An ``ExperimentLogger`` on rank 0 (or the one process), a
    ``NullLogger`` elsewhere: only rank 0 writes."""
    from ppt_torch.parallel.mesh import is_main

    return (ExperimentLogger if is_main() else NullLogger)(args, task_name)
