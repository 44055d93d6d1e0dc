"""PointNeXt-S inference by piece at the model-zoo anchor shape, on the card.

Counterpart of ``ppt_tpu/tools/pointnext_profile.py``: at B=128 x 1024
points in bf16, the device time of PointNeXt-S's four FPS stages
(``fps1``..``fps4``: N -> N/2 from 1024), its four ball-query stages
(``bq1``..``bq4``: ``ball_query_gather_feats``, the one kernel each strided
stage runs, with the stage's radius, 32 neighbours and the bf16 features it
gathers, 32 to 256 wide) and the full forward (``fwd``, the height as the
4th channel, weights from a seed). The pieces' launches are queued behind a
sleeping kernel (``timing.queued_ms``); the forward, hundreds of library
launches a call, runs back to back between two events
(``timing.gpu_time_ms``). ``overhead`` is an empty kernel queued the same
way. One JSON line each; ``--only`` picks some. It needs a card.

    python -m ppt_torch.tools.pointnext_profile [--only fps1,bq1,fwd] [--batch 128]
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ppt_torch.kernels import group as kgroup
from ppt_torch.tools.timing import gpu_time_ms, queued_ms

# (N, S, radius, feature width) of the four strided stages
STAGES = ((1024, 512, 0.15, 32), (512, 256, 0.225, 64), (256, 128, 0.3375, 128),
          (128, 64, 0.50625, 256))
PIECES = ("overhead",) + tuple(f"fps{s}" for s in range(1, 5)) + tuple(
    f"bq{s}" for s in range(1, 5)) + ("fwd",)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=None, help=f"comma-separated, from {', '.join(PIECES)}")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--iters", type=int, default=8, help="calls a reading")
    args = ap.parse_args(argv)
    args.only = [p for p in args.only.split(",") if p] if args.only else list(PIECES)
    unknown = [p for p in args.only if p not in PIECES]
    if unknown:
        ap.error(f"unknown pieces {unknown}; have {list(PIECES)}")
    return args


def main(argv=None) -> list:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("pointnext_profile: torch.cuda.is_available() is false; it times "
                         "PointNeXt-S on a CUDA card and has no CPU fallback")
    dev = torch.device("cuda")
    B, K = args.batch, args.iters
    gen = torch.Generator().manual_seed(0)
    pc = torch.rand(B, 1024, 3, generator=gen).to(dev)
    lines = []

    def report(name, ms, timer="queued"):
        lines.append({"component": name, "ms": ms, "timer": timer, "batch": B})
        print(json.dumps(lines[-1]), flush=True)

    with torch.no_grad():
        for name in args.only:
            if name == "overhead":
                report(name, queued_ms(lambda: torch.cuda._sleep(0), reps=K))
            elif name.startswith("fps"):
                n, s = STAGES[int(name[3:]) - 1][:2]
                xyz = pc[:, :n].contiguous()
                report(name, queued_ms(lambda: kgroup.fps_batched(xyz, s), reps=K))
            elif name.startswith("bq"):
                n, s, r, f = STAGES[int(name[2:]) - 1]
                xyz = pc[:, :n].contiguous()
                q = xyz[:, :s].contiguous()
                feats = torch.randn(B, n, f, generator=gen).to(dev).to(torch.bfloat16)
                report(name, queued_ms(
                    lambda: kgroup.ball_query_gather_feats(r, 32, xyz, q, feats), reps=K))
            else:
                from ppt_torch.data.augment import append_height
                from ppt_torch.tools.backbone_bench import build

                tower, _ = build("pointnext", torch.bfloat16)
                tower = tower.to(dev).eval().requires_grad_(False)
                x = append_height(pc)
                report(name, gpu_time_ms(lambda: tower(x, train=False), reps=K), "events")
    return lines


if __name__ == "__main__":
    main(sys.argv[1:])
