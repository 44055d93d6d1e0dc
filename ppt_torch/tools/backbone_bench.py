"""Point-backbone inference throughput on the card (the model-zoo anchor).

Counterpart of ``ppt_tpu/tools/backbone_bench.py``: the steady-state forward
clouds/sec of one point backbone at the reference's benchmark setting,
batch 128 x 1024 points, in bf16 (the JAX tool's dtype on its chip), weights
from a seed: ``pointnext`` (PointNeXt-S with the height as its 4th input
channel), ``pointnet2_ssg``, ``pointnet2_msg``, ``pointmlp`` and ``dgcnn``
(the DGCNN classifier, 3 channels, its FC trunk on, as the JAX tool builds
it). Each of ``--iters`` forward calls (after 3 warm-up calls) is timed on
the host clock closed by ``torch.cuda.synchronize()``; the line gives the
median and the spread. The V100 figures of ``BASELINE.md`` (PointNeXt's model zoo:
PointNeXt-S 2040, PointNet++ 1872 ins/sec, V100-32GB) are printed beside
the result under the V100's name, as another card's numbers.

    python -m ppt_torch.tools.backbone_bench --model pointnext
    python -m ppt_torch.tools.backbone_bench --model pointnet2_ssg --batch 128 --iters 16
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from ppt_torch.data.augment import append_height
from ppt_torch.nn.layers import init_dense_

MODELS = ("pointnext", "pointnet2_ssg", "pointnet2_msg", "pointmlp", "dgcnn")
# BASELINE.md: PointNeXt's docs/modelzoo.md, V100-32GB, 128 x 1024 points
V100_CLOUDS_PER_SEC = {"pointnext": 2040, "pointnet2_ssg": 1872}


def build(name: str, dtype: torch.dtype):
    """(tower, whether it takes the height channel), weights from seed 0."""
    from ppt_torch.nn.classic import DgcnnClassifier
    from ppt_torch.nn.pointmlp import PointMLP, PointMLPConfig
    from ppt_torch.nn.pointnet2 import PointNet2Msg, PointNet2Ssg
    from ppt_torch.nn.pointnext import PointNext, PointNextConfig

    if name == "pointnext":
        tower, height = PointNext(PointNextConfig(in_channels=4), dtype=dtype), True
    elif name == "pointnet2_ssg":
        tower, height = PointNet2Ssg(dtype=dtype), False
    elif name == "pointnet2_msg":
        tower, height = PointNet2Msg(dtype=dtype), False
    elif name == "pointmlp":
        tower, height = PointMLP(PointMLPConfig(), dtype=dtype), False
    elif name == "dgcnn":
        tower, height = DgcnnClassifier(3, trunk=True, dtype=dtype), False
    else:
        raise KeyError(name)
    with torch.no_grad():
        init_dense_(tower, torch.Generator().manual_seed(0))
    return tower, height


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="pointnext", choices=MODELS)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--npoints", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=16)
    return ap.parse_args(argv)


def bench(name: str, batch: int = 128, npoints: int = 1024, iters: int = 16) -> dict:
    dev = torch.device("cuda")
    tower, height = build(name, torch.bfloat16)
    tower = tower.to(dev).eval().requires_grad_(False)
    gen = torch.Generator().manual_seed(1)
    pc = torch.rand(batch, npoints, 3, generator=gen).to(dev)
    x = append_height(pc) if height else pc
    times = []
    with torch.no_grad():
        for i in range(3 + iters):
            t0 = time.perf_counter()
            tower(x, train=False)
            torch.cuda.synchronize()
            if i >= 3:
                times.append(time.perf_counter() - t0)
    times.sort()
    med = times[len(times) // 2]
    out = {"model": name, "batch": batch, "npoints": npoints, "dtype": "bfloat16",
           "device": torch.cuda.get_device_name(dev), "iters": iters,
           "fwd_ms": med * 1e3, "clouds_per_sec": batch / med,
           "spread_pct": 100 * (times[-1] - times[0]) / med}
    if name in V100_CLOUDS_PER_SEC:
        out["v100_32gb_clouds_per_sec"] = V100_CLOUDS_PER_SEC[name]
    return out


def main(argv=None) -> dict:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("backbone_bench: torch.cuda.is_available() is false; it times the "
                         "towers on a CUDA card and has no CPU fallback")
    out = bench(args.model, args.batch, args.npoints, args.iters)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
