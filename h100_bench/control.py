"""Readings that set a cell's limits, over many seeds in one process.

    python3 -m h100_bench.control --workload <cell> --seeds 1,2,3 [--out FILE]

For each seed, one JSON line with the numbers the cell compares:
``program`` (the port as the benchmark runs it, against the float32
reference: the lower readings), ``control`` (the reference itself in
fp8, the precision below the configuration's bfloat16, in the program's
place: the upper readings) and, for a training cell, ``half_batch`` (the
reference put in the program's place with half of each batch left out and
the mean taken over the rest; a step that returns its state unchanged
reads 1 on every number by construction). Each seed builds the cell as a
run does and, for recognition, serves one pass. Needs the card.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import time
from pathlib import Path

import torch

from h100_bench import cell
from h100_bench.loops import recognize, tune

ROOT = Path(__file__).resolve().parents[1]


def tune_readings(ctx) -> dict:
    loop = tune.Loop(ctx)
    b1 = loop.prog.args.betas[0]
    program = {"loss": [s["loss"] for s in loop.seen], "grad": loop.mu1 / (1 - b1),
               "change": loop.tokens_after - loop.tokens0}
    seen, tokens0, spe = loop.seen, loop.tokens0, loop.steps_per_epoch
    loop.check()  # frees the program
    f32 = tune.reference_steps(ctx, seen, tokens0, spe, "f32")
    return {"program": tune.gaps(program, f32),
            "control": tune.gaps(tune.reference_steps(ctx, seen, tokens0, spe, "fp8"), f32),
            "half_batch": tune.gaps(tune.reference_steps(ctx, seen, tokens0, spe, "f32", 0.5),
                                    f32)}


def recognize_readings(ctx) -> dict:
    loop = recognize.Loop(ctx)
    loop.window(0.0)  # one pass, its logits kept
    ds, B, per = loop.ds, loop.prog.args.batch_size, loop.batches_per_pass
    program = {k: v["value"] for k, v in loop.check().items()}
    rng = random.Random(ctx.seed)
    ids = sorted(set(rng.sample(range(per), min(ctx.traffic["checked_batches"] - 1, per))
                     + [per - 1]))
    valid = [min(B, len(ds) - b * B) for b in ids]
    f32 = recognize.reference_logits(ctx, ds, ids, B, "f32")
    fp8 = recognize.reference_logits(ctx, ds, ids, B, "fp8")
    control = recognize.gaps([g[:v] for g, v in zip(fp8, valid)],
                             [r[:v] for r, v in zip(f32, valid)])
    return {"program": program, "control": control}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--out", default="")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    out = open(a.out, "a") if a.out else None
    for seed in (int(s) for s in a.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = cell.load(ROOT, a.workload, seed, 0.0, False, "cuda:0")
        read = tune_readings if ctx.traffic["loop"] == "tune" else recognize_readings
        line = json.dumps({"workload": a.workload, "seed": seed, **read(ctx),
                           "seconds": time.perf_counter() - t0})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
