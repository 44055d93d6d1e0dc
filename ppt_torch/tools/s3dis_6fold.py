"""S3DIS 6-fold cross-validation: the folds' confusion matrices summed.

Counterpart of ``ppt_tpu/tools/s3dis_6fold.py:28-64`` (the reference's
``examples/segmentation/test_s3dis_6fold.py``): train and evaluate six
times with ``--test_area 1..6``, each run saving its whole-scene
confusion matrix with ``--cm_out``, then sum the matrices here. The 6-fold
metrics are over the UNION of the folds' points, not the mean of the
folds' mIoUs.

    python -m ppt_torch.tasks.sceneseg --dataset_name s3dis --test_area 1 \\
        --eval_scene --cm_out outputs/s3dis_a1.npz
    ...
    python -m ppt_torch.tools.s3dis_6fold 'outputs/s3dis_a*.npz'
"""

from __future__ import annotations

import argparse
import glob
import json
from typing import Dict, Sequence

import numpy as np

from ppt_torch.utils.metrics import ConfusionMatrix


def aggregate(paths: Sequence[str]) -> Dict:
    """The summed matrix's fold count, OA, mean accuracy, mIoU and per-class
    IoUs, each rounded to 2 places, with the class names of the last file
    that has them."""
    total, classnames = None, None
    for p in paths:
        z = np.load(p, allow_pickle=True)
        total = z["matrix"] if total is None else total + z["matrix"]
        if "classnames" in z:
            classnames = list(z["classnames"])
    if total is None:
        raise ValueError("no confusion matrices given")
    cm = ConfusionMatrix(total.shape[0])
    cm.matrix = total.astype(np.int64)
    out = {
        "folds": len(paths),
        "overall_accuracy": round(cm.overall_accuracy, 2),
        "mean_accuracy": round(cm.mean_accuracy, 2),
        "miou": round(cm.miou, 2),
        "ious": [round(float(x), 2) for x in cm.ious],
    }
    if classnames:
        out["classnames"] = classnames
    return out


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("paths", nargs="+", help="per-fold .npz confusion matrices (globs expand)")
    args = ap.parse_args(argv)
    paths = []
    for p in args.paths:
        paths.extend(sorted(glob.glob(p)) or [p])
    out = aggregate(paths)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
