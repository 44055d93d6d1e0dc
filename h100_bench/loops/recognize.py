"""Recognition: ``ppt_torch.tasks.cls.validate`` passes, back to back.

Each pass runs the cached text eval of ``train/eval.py:
make_cached_text_eval``: the text tower once, then every batch of the test
set through the point tower and one product, its predictions read on the
host. The last batch of a pass is padded, and only its valid clouds count.
The harness hands ``validate`` the eval step wrapped: the wrapper times
each call and keeps a reference to its logits, which the check compares
with the plain reference once the window has closed.

A batch's time runs from its model call to the next batch's model call,
or to the pass's end: its device work, the read of its predictions, and
the next batch's load and copy.
"""

from __future__ import annotations

import random
import time
from typing import Dict, List

import numpy as np
import torch

from h100_bench import clouds, program
from h100_bench import trace as tr
from h100_bench import weights as wt
from h100_bench.cell import Window, p95
from h100_bench.loops import check, profiled
from h100_bench.reference.clip_text import TextTower
from h100_bench.reference.pointnext import with_height
from h100_bench.reference.precision import Products, exact_f32


class Loop:
    def __init__(self, ctx):
        from ppt_torch.train.eval import make_cached_text_eval

        self.ctx, cfg, dev, mix = ctx, ctx.cfg, ctx.device, ctx.traffic
        W = wt.make(ctx.arch.shapes(cfg), ctx.seed, dev)
        self.prog = program.build(cfg, W, ctx.seed, dev)
        del W
        pts, labels = clouds.make(mix["clouds"], cfg["npoints"], len(cfg["classnames"]),
                                  ctx.seed, mix["split"], dev)
        self.ds = program.dataset(pts, labels, self.prog.classnames)
        embed_fn, step_fn = make_cached_text_eval(self.prog.model)
        self.eval_fn = (embed_fn, self._wrap(step_fn))
        self.traced = self.sync = False
        self.calls: List[float] = []
        self.call_s: List[float] = []
        self.logits: List[torch.Tensor] = []
        self.keep = False
        self._pass()  # warm-up: every shape of the pass

    def _wrap(self, step_fn):
        def step(state, batch, text_embed):
            t0 = time.perf_counter()
            with tr.span("model_call", self.traced):
                out = step_fn(state, batch, text_embed)
                if self.sync:
                    torch.cuda.synchronize(self.ctx.device)
            if self.ctx.fault == "altered_answer":
                out = torch.cat([out[:1].roll(1, -1), out[1:]])
            elif self.ctx.fault == "half_batch":
                half = out.shape[0] // 2
                out = torch.cat([out[:half], out[:out.shape[0] - half]])
            self.calls.append(t0)
            self.call_s.append(time.perf_counter() - t0)
            if self.keep:
                self.logits.append(out)
            return out

        return step

    def _pass(self) -> float:
        """One ``validate`` pass; the time it ended."""
        from ppt_torch.tasks import cls

        p = self.prog
        with tr.span("validate", self.traced):
            cls.validate(p.model, self.eval_fn, self.ds, p.prompts, p.args, self.ctx.device,
                         votes=self.ctx.traffic["votes"])
        return time.perf_counter()

    @property
    def batches_per_pass(self) -> int:
        return -(-len(self.ds) // self.prog.args.batch_size)

    def window(self, seconds: float) -> Window:
        self.calls, self.call_s, self.logits = [], [], []
        self.keep, self.traced = True, self.ctx.trace
        self.sync = self.ctx.trace and self.ctx.device.type == "cuda"
        unit_s, gap_s, passes = [], [], 0
        t0 = time.perf_counter()
        while True:
            first = len(self.calls)
            end = self._pass()
            starts = self.calls[first:] + [end]
            unit_s += [b - a for a, b in zip(starts, starts[1:])]
            gap_s += [u - c for u, c in zip(unit_s[first:], self.call_s[first:])]
            passes += 1
            if end - t0 >= seconds:
                break
        self.keep = self.traced = self.sync = False
        return Window(end - t0, passes * len(self.ds), len(unit_s), unit_s, gap_s, 0, passes)

    def end_to_end(self, w: Window) -> Dict[str, float]:
        return {"recog_clouds_per_s": w.clouds / w.elapsed_s,
                "recog_batch_ms_p95": p95(w.unit_s) * 1e3}

    def profile(self):
        def run():
            self.traced = True
            self._pass()
            self.traced = False

        return profiled(self.ctx, self.prog.model, self.batches_per_pass, run,
                        backward_text=False)

    def check(self) -> Dict:
        """The widest gap of a served logit from the reference's, over the
        valid rows of batches drawn from the seed, in units of the spread of
        the reference's logits."""
        ctx, B = self.ctx, self.prog.args.batch_size
        per = self.batches_per_pass
        n = len(self.logits)
        rng = random.Random(ctx.seed)
        pick = sorted(set(rng.sample(range(n), min(ctx.traffic["checked_batches"] - 1, n))
                          + [rng.randrange(n // per) * per + per - 1]))  # one padded batch
        got = [self.logits[j].float() for j in pick]
        self.prog = self.eval_fn = None
        self.logits = []
        if ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        ref = reference_logits(ctx, self.ds, [j % per for j in pick], B, "f32")
        valid = [self._valid(j % per, B) for j in pick]
        out = {}
        for name, value in gaps([g[:v] for g, v in zip(got, valid)],
                                [r[:v] for r, v in zip(ref, valid)]).items():
            if name in ctx.limits:
                out.update(check(name, value, ctx.limits))
        return out

    def _valid(self, b: int, B: int) -> int:
        return min(B, len(self.ds) - b * B)


def model_flops(ctx, w: Window) -> float:
    """Model FLOPs of the window's passes (valid clouds only)."""
    return w.passes * ctx.arch.model_flops(ctx.cfg, "recognize", ctx.traffic["clouds"])


def gaps(got: List[torch.Tensor], ref: List[torch.Tensor]) -> Dict[str, float]:
    """Served logits [rows, classes] against the reference's, over every
    sampled row: ``logit_gap``, the widest |got - ref| over the std of the
    reference's logits; ``answer_gap``, the worst row's RMS gap after each
    row's mean over the classes is taken out (the part that decides the
    answer), over the std of the reference's centred logits."""
    g, r = torch.cat(got).float(), torch.cat(ref).float()
    gc, rc = g - g.mean(1, keepdim=True), r - r.mean(1, keepdim=True)
    return {"logit_gap": float((g - r).abs().max() / r.std()),
            "answer_gap": float((gc - rc).pow(2).mean(1).sqrt().max() / rc.std())}


def reference_logits(ctx, ds, batch_ids: List[int], B: int, precision: str) -> List[torch.Tensor]:
    """The reference's logits of the test set's batches ``batch_ids`` (the
    last padded with its last cloud, as the loader pads it)."""
    cfg, dev = ctx.cfg, ctx.device
    P = Products(precision)
    out = []
    with exact_f32(), torch.no_grad():
        W = wt.make(ctx.arch.shapes(cfg), ctx.seed, dev)
        text = TextTower(W, cfg["classnames"], cfg["prompt"]["n_ctx"], cfg["text"]["layers"],
                         cfg["text"]["heads"], P)(W["prompt_learner.learnable_tokens"])
        tower = ctx.arch.reference(W, cfg, P)
        scale = torch.exp(W["logit_scale"])
        for b in batch_ids:
            idx = np.minimum(np.arange(b * B, (b + 1) * B), len(ds) - 1)
            pc = torch.from_numpy(ds.points[idx]).float().to(dev)
            if cfg["use_height"]:
                pc = with_height(pc)
            feat = tower(pc)
            out.append(scale * P.mm(P.mm(feat, W["pc_projection"]), text.t()))
    return out
