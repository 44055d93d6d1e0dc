"""Prompt tuning: the inner loop of ``ppt_torch.tasks.cls.train_loop``.

Each step: the next batch from ``data.loader.Loader`` (shuffled, epochs
cut at ``data_ratio`` and wrapping), ``cls.device_batch``,
``augment.train_augment`` from the augmentation's own generator, the step
of ``train.trainer.make_train_step``, then the loss and accuracy read on
the host, as ``train_loop`` reads them every step. One client, closed
loop. The set-up builds the one train state that the window then drives
and runs its first steps through the same calls; the reference follows the
first ``checked_steps`` of them.
"""

from __future__ import annotations

import math
import time
from typing import Dict, Iterator

import numpy as np
import torch

from h100_bench import clouds, program
from h100_bench import trace as tr
from h100_bench import weights as wt
from h100_bench.cell import Window
from h100_bench.loops import check, profiled, relative_gap
from h100_bench.reference.clip_text import TextTower
from h100_bench.reference.optim import AdamW, learning_rate, smoothed_ce
from h100_bench.reference.pointbert import droppath_scales
from h100_bench.reference.precision import Products, exact_f32

TOKENS = "prompt_learner.learnable_tokens"


class Loop:
    def __init__(self, ctx):
        from ppt_torch.data.loader import Loader
        from ppt_torch.tasks import cls
        from ppt_torch.train.trainer import make_train_step

        self.ctx, cfg, dev, mix = ctx, ctx.cfg, ctx.device, ctx.traffic
        W = wt.make(ctx.arch.shapes(cfg), ctx.seed, dev)
        self.prog = program.build(cfg, W, ctx.seed, dev)
        self.tokens0 = W[TOKENS].clone()
        del W
        args = self.prog.args
        pts, labels = clouds.make(mix["clouds"], cfg["npoints"], len(cfg["classnames"]),
                                  ctx.seed, mix["split"], dev)
        ds = program.dataset(pts, labels, self.prog.classnames)
        steps_per_epoch = max(len(ds) // args.batch_size, 1)
        self.steps_per_epoch = steps_per_epoch
        self.state, _ = cls.train_state(args, self.prog.model, steps_per_epoch)
        if set(self.state.trainable) != {TOKENS}:
            raise NotImplementedError(f"the check follows the prompt tokens alone; head_type "
                                      f"{args.head_type} trains {sorted(self.state.trainable)}")
        self.step_fn = make_train_step(smoothing=args.label_smoothing)
        self.loader = Loader(ds, batch_size=args.batch_size, shuffle=True, drop_last=True,
                             seed=args.seed, num_processes=1, process_index=0)
        self.aug_gen = torch.Generator(device=dev).manual_seed(args.seed + 2)
        self.batches = self._batches()
        self.traced, self.record = False, None
        self.failed = 0
        # the checked steps: their inputs, the generators' states before each,
        # the losses, the first moments after step 1, the tokens after the last
        self.seen = []
        for k in range(mix["checked_steps"]):
            self._step(keep=True)
            if k == 0:
                self.mu1 = self.state.optimizer.mu[TOKENS].clone()
        self.tokens_after = self.state.trainable[TOKENS].detach().clone()
        for _ in range(mix["warm_steps"]):
            self._step()

    def _batches(self) -> Iterator[Dict[str, np.ndarray]]:
        epoch, ratio = 0, self.prog.args.data_ratio
        while True:
            self.loader.set_epoch(epoch)
            n = len(self.loader)
            for it, batch in enumerate(self.loader):
                if it / max(n, 1) > ratio:  # the data-efficiency early break
                    break
                yield batch
            epoch += 1

    def _call(self, dbatch):
        """The program's step, or the fault a test asked for."""
        fault, state = self.ctx.fault, self.state
        if fault == "half_batch":
            half = dbatch["pc"].shape[0] // 2
            return self.step_fn(state, {k: v[:half] for k, v in dbatch.items()},
                                self.prog.prompts)
        if fault == "unchanged":
            opt = state.optimizer
            saved = [{k: t.clone() for k, t in d.items()} for d in (opt.params, opt.mu, opt.nu)]
            state, metrics = self.step_fn(state, dbatch, self.prog.prompts)
            with torch.no_grad():
                for d, s in zip((opt.params, opt.mu, opt.nu), saved):
                    for k in d:
                        d[k].copy_(s[k])
            return state, metrics
        if fault == "altered_answer":  # one prompt token moved where the step writes it
            state, metrics = self.step_fn(state, dbatch, self.prog.prompts)
            with torch.no_grad():
                state.trainable[TOKENS][0] += 0.1
            return state, metrics
        return self.step_fn(state, dbatch, self.prog.prompts)

    def _step(self, keep: bool = False) -> None:
        from ppt_torch.data.augment import train_augment
        from ppt_torch.tasks.cls import device_batch

        on, dev, args = self.traced, self.ctx.device, self.prog.args
        t0 = time.perf_counter()
        with tr.span("load", on):
            batch = next(self.batches)
        with tr.span("to_device", on):
            dbatch = device_batch(batch, dev)
        if keep:
            self.seen.append({"pc": batch["pc"].copy(), "label": batch["label"].copy(),
                              "aug": self.aug_gen.get_state(),
                              "gen": self.state.generator.get_state()})
        with tr.span("augment", on):
            dbatch["pc"] = train_augment(self.aug_gen, dbatch["pc"], use_height=args.use_height)
        t1 = time.perf_counter()
        with tr.span("step", on):
            self.state, metrics = self._call(dbatch)
        with tr.span("read", on):
            loss, acc = float(metrics["loss"]), float(metrics["acc"])
        t2 = time.perf_counter()
        if not (math.isfinite(loss) and math.isfinite(acc)):
            self.failed += 1
        if keep:
            self.seen[-1]["loss"] = loss
        if self.record is not None:
            self.record.append((t2 - t0, t1 - t0))

    def window(self, seconds: float) -> Window:
        self.record, self.traced, self.failed = [], self.ctx.trace, 0
        B = self.prog.args.batch_size
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self._step()
        elapsed = time.perf_counter() - t0
        steps = len(self.record)
        w = Window(elapsed, steps * B, steps, [r[0] for r in self.record],
                   [r[1] for r in self.record], self.failed)
        self.record, self.traced = None, False
        return w

    def end_to_end(self, w: Window) -> Dict[str, float]:
        return {"tune_clouds_per_s": w.clouds / w.elapsed_s}

    def profile(self):
        n = self.ctx.traffic["profiled_steps"]

        def run():
            self.traced = True
            for _ in range(n):
                self._step()
            self.traced = False

        return profiled(self.ctx, self.prog.model, n, run, backward_text=True)

    def check(self) -> Dict:
        """The numbers of ``gaps`` against the reference's steps; those that
        ``limits/<cell>.json`` names are compared."""
        ctx, prog = self.ctx, self.prog
        got = {"loss": [s["loss"] for s in self.seen],
               "grad": self.mu1 / (1 - prog.args.betas[0]),
               "change": self.tokens_after - self.tokens0}
        seen, tokens0 = self.seen, self.tokens0
        self.prog = self.state = self.step_fn = None  # free the program before the reference
        if ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        ref = reference_steps(ctx, seen, tokens0, self.steps_per_epoch, "f32")
        out = {}
        for name, value in gaps(got, ref).items():
            if name in ctx.limits:
                out.update(check(name, value, ctx.limits))
        return out


def row_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The worst prompt token's gap of norms: max over rows of |‖got_r‖ -
    ‖ref_r‖| over the larger of ‖ref_r‖ and the median row's norm."""
    g, r = got.float().norm(dim=-1), ref.float().norm(dim=-1)
    return float(((g - r).abs() / torch.maximum(r, r.median())).max())


def gaps(got: Dict, ref: Dict) -> Dict[str, float]:
    """``loss_gap``: the worst checked step's |loss - ref| / |ref|;
    ``grad_gap``: the first gradient's, ``change_gap``: the tokens' change
    over the checked steps, each by ``row_gap``."""
    return {"loss_gap": max(relative_gap(a, b) for a, b in zip(got["loss"], ref["loss"])),
            "grad_gap": row_gap(got["grad"], ref["grad"]),
            "change_gap": row_gap(got["change"], ref["change"])}


def model_flops(ctx, w: Window) -> float:
    """Model FLOPs of the window's steps."""
    return w.units * ctx.arch.model_flops(ctx.cfg, "tune", ctx.cfg["batch_size"])


def augment(pc: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """PPT's training augmentation from ``gen``: a per-cloud anisotropic
    scale U[2/3, 3/2] and shift U[-0.2, 0.2], then a random permutation of
    the points (argsort of uniform draws)."""
    B, N, C = pc.shape

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=gen, device=pc.device) * (hi - lo) + lo

    pc = pc * uniform((B, 1, 3), 2.0 / 3.0, 3.0 / 2.0) + uniform((B, 1, 3), -0.2, 0.2)
    perm = torch.rand(B, N, generator=gen, device=pc.device).argsort(dim=1)
    return torch.gather(pc, 1, perm[..., None].expand(-1, -1, C))


def reference_steps(ctx, seen, tokens0: torch.Tensor, steps_per_epoch: int,
                    precision: str, keep_batch: float = 1.0) -> Dict:
    """The reference's train steps on the checked steps' inputs: its losses,
    first gradient and the tokens' change. The augmentation and the
    DropPath draws are taken from the program's generators' states saved
    before each step; ``keep_batch`` < 1 keeps that share of each batch."""
    cfg, dev = ctx.cfg, ctx.device
    P = Products(precision)
    with exact_f32():
        W = wt.make(ctx.arch.shapes(cfg), ctx.seed, dev)
        text = TextTower(W, cfg["classnames"], cfg["prompt"]["n_ctx"], cfg["text"]["layers"],
                         cfg["text"]["heads"], P)
        tower = ctx.arch.reference(W, cfg, P)
        tokens = W[TOKENS].clone()
        opt, t = AdamW(cfg["train"]), cfg["train"]
        losses, grad = [], None
        for k, s in enumerate(seen):
            gen = torch.Generator(device=dev)
            gen.set_state(s["aug"])
            pc = augment(torch.from_numpy(s["pc"]).float().to(dev), gen)
            gen.set_state(s["gen"])
            u = torch.rand((cfg["point"]["depth"], pc.shape[0], 2), generator=gen, device=dev)
            dp = droppath_scales(u, cfg["point"]["drop_path_rate"])
            labels = torch.from_numpy(s["label"]).long().to(dev)
            n = max(1, int(round(pc.shape[0] * keep_batch)))
            pc, labels, dp = pc[:n], labels[:n], dp[:, :n]
            with torch.no_grad():
                pc_embed = P.mm(tower(pc, train=True, dp=dp), W["pc_projection"])
            leaf = tokens.clone().requires_grad_(True)
            logits = torch.exp(W["logit_scale"]) * P.mm(pc_embed, text(leaf).t())
            loss = smoothed_ce(logits, labels, t["label_smoothing"])
            (g,) = torch.autograd.grad(loss, [leaf])
            losses.append(float(loss.detach()))
            grad = g if grad is None else grad
            tokens = opt.step(tokens, g, learning_rate(k, t, steps_per_epoch))
    return {"loss": losses, "grad": grad, "change": tokens - tokens0}
