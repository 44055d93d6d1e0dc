"""The benchmark's model-FLOP counts equal ``FlopCounterMode`` over the plain
references at tiny widths: a recognition batch with its text encode, and a
prompt-tuning step's forward and backward."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from h100_bench import cell, clouds
from h100_bench.conftest import tiny_config
from h100_bench.loops import recognize, tune

torch.set_num_threads(2)


def _flops(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


@pytest.mark.parametrize("config", ["ppt_base", "ulip_pointnext_s"])
def test_recognition_batch_counts(tiny_root, config):
    ctx = cell.load(tiny_root, "ppt_base.tune", 5, 0.0, False, "cpu")
    ctx.cfg = tiny_config(config)
    B, N = ctx.cfg["batch_size"], ctx.cfg["npoints"]
    pts, labels = clouds.make(B, N, len(ctx.cfg["classnames"]), 5, "test", "cpu")
    from h100_bench import program

    ds = program.dataset(pts, labels, ctx.cfg["classnames"])
    got = _flops(lambda: recognize.reference_logits(ctx, ds, [0], B, "f32"))
    assert got == ctx.arch.model_flops(ctx.cfg, "recognize", B)


def test_tuning_step_counts(tiny_root):
    ctx = cell.load(tiny_root, "ppt_base.tune", 7, 0.0, False, "cpu")
    B, N = ctx.cfg["batch_size"], ctx.cfg["npoints"]
    pts, labels = clouds.make(B, N, len(ctx.cfg["classnames"]), 7, "train", "cpu")
    gen = torch.Generator().manual_seed(3)
    seen = [{"pc": pts, "label": labels.astype(np.int64), "aug": gen.get_state(),
             "gen": gen.get_state()}]
    tokens0 = torch.zeros(ctx.cfg["prompt"]["n_ctx"], ctx.cfg["text"]["width"])
    got = _flops(lambda: tune.reference_steps(ctx, seen, tokens0, 10, "f32"))
    assert got == ctx.arch.model_flops(ctx.cfg, "tune", B)
