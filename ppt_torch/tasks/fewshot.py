"""Few-shot recognition task.

Counterpart of ``ppt_tpu/tasks/fewshot.py``: the loop is the recognition
loop; the only difference is the ``*_fs`` dataset, whose train split
subsamples ``nshots`` items per class. This script delegates to the cls
loop after normalising the dataset name and the task tag.

    python -m ppt_torch.tasks.fewshot --dataset_name modelnet40 --nshots 16 ...
"""

from __future__ import annotations

import sys
from typing import Dict, Optional, Sequence, Union

from ppt_torch.tasks import cls
from ppt_torch.tasks.args import TaskArgs, parse_args


def main(args: Optional[Union[TaskArgs, Sequence[str]]] = None) -> Dict[str, float]:
    if not isinstance(args, TaskArgs):
        args = parse_args(args)
    args.task = "fewshot"
    if not args.dataset_name.endswith("_fs") and args.dataset_name != "synthetic":
        args.dataset_name = args.dataset_name + "_fs"
    return cls.main(args)


if __name__ == "__main__":
    main(sys.argv[1:])
