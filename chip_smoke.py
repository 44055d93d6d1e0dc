"""H100 smoke run of the PyTorch port: build every kernel, hold each
against its plain PyTorch version on the card, time it, then drive the
full-width ULIP-PointBERT recognition inference path and the
prompt-tuning train path.

    python3 chip_smoke.py            # one CUDA card, no arguments

Phases (any failed check raises, and the script exits non-zero):
  1. card name / power limit (nvidia-smi), torch and CUDA versions;
  2. build the kernels from ppt_torch/csrc (one nvcc per source, in
     parallel) and report the build time;
  3. each kernel entry point against its plain version, at a small shape
     and at the slice's shape, in f32 and bf16 (the grouping kernels take
     f32 coordinates in both; the five kernels of the inference path also
     at the train path's batch of 30): indices exact, f32 within 1e-4 and bf16
     within 2e-2 of the plain output's max magnitude; kernel, plain and
     library times with CUDA events;
  4. the recognition path at full width (ULIP-PointBERT, bf16, B=32,
     N=1024, 40 ModelNet40 class names, 32 prompt tokens "middle",
     weights from a seed): passes of ModelNet40's test-set size (2468
     synthetic clouds, text embedding once per pass) through
     ``validate``; the median clouds/sec of the timed passes with their
     spread, the text tower's share of a pass, each kernel's launch count
     in one pass (all must be > 0), and the logits against the same
     weights through the plain path on the card;
  5. the prompt-tuning train path at full width through ``cls.setup`` and
     the trainer (ULIP-PointBERT, bf16, head_type 0, batch 30, N=1024, the
     40 ModelNet40 names, 32 prompt tokens "middle", label smoothing 0.2,
     lr 3e-3, synthetic train split, DropPath and augmentation on): a
     warm-up, then 5 windows of 20 steps with the loss read every step as
     ``train_loop`` reads it, and between them 4 windows with the losses
     read once per window; median/min/max train clouds/sec of each kind,
     first and last loss, kernel launches per step (``mini_stats`` > 0);
     one epoch through ``cls.train_loop`` itself;
     frozen weights unchanged, prompt tokens and BatchNorm buffers moved;
     a fixed batch repeated with augmentation and DropPath off, whose loss
     must fall; one step's loss, prompt gradient and updated BatchNorm
     buffers against the same step through the plain path on the card
     (f32 and bf16); a head_type 3 step whose ``block_11`` gradients agree
     with the plain path; save -> load -> evaluate gives identical logits.
     Its numbers go on a line of their own ({"train": ...}).

The line before the last is a JSON object with the per-kernel numbers;
the last line is the contract line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import contextlib
import dataclasses
import json
import math
import shutil
import subprocess
import sys
import time

import torch

if not torch.cuda.is_available():
    print("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA card",
          file=sys.stderr)
    sys.exit(2)

import torch.nn.functional as F  # noqa: E402

from ppt_torch.data import datasets as pdata  # noqa: E402
from ppt_torch.data.augment import train_augment  # noqa: E402
from ppt_torch.data.datasets import ArrayDataset, make_synthetic  # noqa: E402
from ppt_torch.data.loader import Loader  # noqa: E402
from ppt_torch.kernels import _build  # noqa: E402
from ppt_torch.kernels import group as kgroup  # noqa: E402
from ppt_torch.kernels import mini as kmini  # noqa: E402
from ppt_torch.kernels import vitblock as kvit  # noqa: E402
from ppt_torch.models.ulip import PromptArrays, build_model  # noqa: E402
from ppt_torch.nn import pointbert as npb  # noqa: E402
from ppt_torch.prompt.learner import build_prompt_spec  # noqa: E402
from ppt_torch.tasks import cls  # noqa: E402
from ppt_torch.tasks.args import TaskArgs  # noqa: E402
from ppt_torch.models.losses import smoothed_cross_entropy  # noqa: E402
from ppt_torch.train.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402
from ppt_torch.train.eval import make_cached_text_eval  # noqa: E402
from ppt_torch.train.trainer import make_train_step  # noqa: E402

DEV = torch.device("cuda")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK = {"bf16": 989e12, "f32": 67e12}  # dense tensor-core bf16; f32 outside tensor cores
TOL = {"f32": 1e-4, "bf16": 2e-2}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# (shape..., tag): a small shape, the shape the train path gives the kernel
# (batch 30; checked only) and the shape the inference path gives it (batch
# 32; checked and timed). mini_stats runs on the train path alone.
GROUP_SHAPES = ((2, 256, 32, 8, "small"), (30, 1024, 512, 32, "train"),
                (32, 1024, 512, 32, "slice"))  # B, N, G, K
MINI_SHAPES = ((1, 7, 20, "small"), (30, 512, 32, "train"),
               (32, 512, 32, "slice"))  # B, G, M (small: padded groups)
STATS_SHAPES = ((1, 7, 20, "small"), (30, 512, 32, "slice"))
BLOCK_SHAPES = ((2, 33, 64, 2, "small"), (30, 513, 384, 6, "train"),
                (32, 513, 384, 6, "slice"))  # B, L, C, heads
SOURCES = {
    "fps_batched": ("ppt_torch/csrc/group.cu", "ppt_tpu/kernels/group.py:132"),
    "knn_gather": ("ppt_torch/csrc/group.cu", "ppt_tpu/kernels/group.py:336"),
    "mini_forward": ("ppt_torch/csrc/mini.cu", "ppt_tpu/kernels/mini.py:344"),
    "mini_stats": ("ppt_torch/csrc/mini.cu", "ppt_tpu/kernels/mini.py:316"),
    "fused_vit_block": ("ppt_torch/csrc/vitblock.cu", "ppt_tpu/kernels/vitblock.py:372"),
    "fused_vit_block_readout": ("ppt_torch/csrc/vitblock.cu",
                                "ppt_tpu/kernels/vitblock.py:526"),
}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {msg}")


def gpu_time_ms(fn, reps=10, warmup=2):
    """Mean device time per call (CUDA events around `reps` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes, nops, peak):
    """Least time for the work: max(bytes / HBM rate, operations / peak)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def rel_err(got, want):
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def cloud(B, N, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(B, N, 3, generator=g).to(DEV)


def check_grouping(results):
    for B, N, G, K, tag in GROUP_SHAPES:
        xyz = cloud(B, N, N + G)
        idx = kgroup.fps_batched(xyz, G)
        want = kgroup.fps_plain(xyz, G)
        torch.cuda.synchronize()
        n_bad = int((idx != want).sum())
        print(f"[kernel] fps_batched {tag} B={B} N={N} G={G}: index mismatches {n_bad}")
        check(n_bad == 0, f"fps_batched indices differ at {tag}")
        center = torch.gather(xyz, 1, want.long()[:, :, None].expand(-1, -1, 3))
        kidx, nb = kgroup.knn_gather(K, xyz, center)
        widx, wnb = kgroup.knn_gather_plain(K, xyz, center)
        torch.cuda.synchronize()
        n_bad = int((kidx != widx).sum())
        nb_err = float((nb - wnb).abs().max())
        print(f"[kernel] knn_gather {tag} B={B} N={N} S={G} k={K}: index mismatches {n_bad}, "
              f"max |d nbr| {nb_err:.3e}")
        check(n_bad == 0, f"knn_gather indices differ at {tag}")
        check(nb_err == 0.0, f"knn_gather coordinates differ at {tag}")
        if tag != "slice":
            continue
        fps_b = B * N * 12 + B * G * 4
        fps_ops = B * G * N * 10  # 3 sub, 3 mul, 2 add, min, compare per point per step
        bms, by = bound_ms(fps_b, fps_ops, PEAK["f32"])
        results["fps_batched"] = dict(
            max_abs_err=0.0, ms=gpu_time_ms(lambda: kgroup.fps_batched(xyz, G)),
            plain_ms=gpu_time_ms(lambda: kgroup.fps_plain(xyz, G), reps=3, warmup=1),
            bound_ms=bms, bound_by=by, library_ms=None)
        knn_b = B * N * 12 + B * G * 12 + B * G * K * 16
        knn_ops = B * G * N * 9  # distance (8) + one comparison per candidate
        bms, by = bound_ms(knn_b, knn_ops, PEAK["f32"])

        def library():
            d, i = torch.topk(torch.cdist(center, xyz), K, dim=-1, largest=False)
            return i

        results["knn_gather"] = dict(
            max_abs_err=nb_err, ms=gpu_time_ms(lambda: kgroup.knn_gather(K, xyz, center)),
            plain_ms=gpu_time_ms(lambda: kgroup.knn_gather_plain(K, xyz, center)),
            bound_ms=bms, bound_by=by, library_ms=gpu_time_ms(library))


def mini_weights(co, seed):
    g = torch.Generator().manual_seed(seed)

    def f(*s, sc):
        return (torch.randn(*s, generator=g) * sc).to(DEV)

    return [f(3, 128, sc=0.5), f(128, sc=0.1), f(128, 256, sc=128 ** -0.5), f(256, sc=0.1),
            f(256, 512, sc=0.05), f(256, 512, sc=0.05), f(512, sc=0.1),
            f(512, co, sc=512 ** -0.5), f(co, sc=0.1)]


def mini_library(M, dt, x, w):
    fw1, fb1, w2, b2, fwg, fwl, fbs, w3, b3 = [t.to(dt) for t in w]
    B, GM, _ = x.shape
    h = F.relu(F.linear(x.to(dt), fw1.t(), fb1))
    x2 = F.linear(h, w2.t(), b2).reshape(B, GM // M, M, -1)
    gh = F.linear(x2.amax(2), fwg.t())
    h = F.relu(F.linear(x2, fwl.t()) + gh[:, :, None] + fbs)
    return F.linear(h, w3.t(), b3).amax(2)


def check_mini(results):
    for B, G, M, tag in MINI_SHAPES:
        x = cloud(B, G * M, G) - 0.5
        w = mini_weights(256, G)
        for dname, dt in DTYPES.items():
            got = kmini.mini_forward(M, dt, x, *w)
            want = kmini.mini_forward_plain(M, dt, x, *w)
            torch.cuda.synchronize()
            err = rel_err(got, want)
            print(f"[kernel] mini_forward {tag} {dname} B={B} G={G} M={M}: max rel err "
                  f"{err:.3e} (tol {TOL[dname]})")
            check(torch.isfinite(got.float()).all(), "mini_forward non-finite")
            check(err <= TOL[dname], f"mini_forward {tag} {dname} error {err}")
            if tag == "slice" and dname == "bf16":
                n = B * G * M
                ops = 2 * n * (3 * 128 + 128 * 256 + 256 * 512 + 512 * 256) + 2 * B * G * 256 * 512
                wbytes = 2 * (3 * 128 + 128 + 128 * 256 + 256 + 2 * 256 * 512 + 512 + 512 * 256
                              + 256)
                bms, by = bound_ms(n * 12 + B * G * 256 * 2 + wbytes, ops, PEAK["bf16"])
                results["mini_forward"] = dict(
                    max_abs_err=float((got.float() - want.float()).abs().max()),
                    ms=gpu_time_ms(lambda: kmini.mini_forward(M, dt, x, *w)),
                    plain_ms=gpu_time_ms(lambda: kmini.mini_forward_plain(M, dt, x, *w)),
                    bound_ms=bms, bound_by=by,
                    library_ms=gpu_time_ms(lambda: mini_library(M, dt, x, w)))


def stats_library(M, dt, x, w):
    """One chain of library calls for the same function: form h, sum it."""
    fw1, fb1, w2, b2, wg, wl, bs = [t.to(dt) for t in w]
    B, GM, _ = x.shape
    x1 = F.relu(F.linear(x.to(dt), fw1.t(), fb1))
    x2 = F.linear(x1, w2.t(), b2).reshape(B, GM // M, M, -1)
    gh = F.linear(x2.amax(2), wg.t())
    h = (F.linear(x2, wl.t()) + gh[:, :, None] + bs).float().reshape(-1, wl.shape[1])
    return h.sum(0), (h * h).sum(0)


def check_mini_stats(results):
    for B, G, M, tag in STATS_SHAPES:
        x = cloud(B, G * M, G + 1) - 0.5
        w = mini_weights(256, G + 1)[:7]  # fw1, fb1, w2, b2, wg, wl, bsplit
        for dname, dt in DTYPES.items():
            got = kmini.mini_stats(M, dt, x, *w)
            want = kmini.mini_stats_plain(M, dt, x, *w)
            sweep = kmini.mini_stats_sweep(M, dt, x, *w[:4])
            sweep2 = kmini.mini_stats_sweep(M, dt, x, *w[:4])
            sweep_want = kmini.mini_stats_sweep_plain(M, dt, x, *w[:4])
            again = kmini.mini_stats(M, dt, x, *w)
            torch.cuda.synchronize()
            errs = [rel_err(g, t) for g, t in zip(got, want)]
            sweep_errs = [rel_err(g, t) for g, t in zip(sweep, sweep_want)]
            same = all(torch.equal(a, b) for a, b in zip(sweep + got, sweep2 + again))
            print(f"[kernel] mini_stats {tag} {dname} B={B} G={G} M={M}: max rel err sum_h "
                  f"{errs[0]:.3e}, sumsq_h {errs[1]:.3e} (tol {TOL[dname]}); sweep m2 "
                  f"{sweep_errs[0]:.3e}, sg {sweep_errs[1]:.3e}, gmax {sweep_errs[2]:.3e}; "
                  f"two runs bit-identical: {same}")
            check(all(torch.isfinite(t).all() for t in got), "mini_stats non-finite")
            check(max(errs + sweep_errs) <= TOL[dname], f"mini_stats {tag} {dname} error {errs}")
            check(same, f"mini_stats {tag} {dname} differs between two runs")
            if tag != "slice":
                continue
            sweep_ms = gpu_time_ms(lambda: kmini.mini_stats_sweep(M, dt, x, *w[:4]))
            whole_ms = gpu_time_ms(lambda: kmini.mini_stats(M, dt, x, *w))
            epilogue_ms = gpu_time_ms(lambda: kmini._stats_epilogue(M, *sweep, *w[4:]))
            print(f"[kernel] mini_stats slice {dname}: sweep kernels {sweep_ms:.3f} ms + f32 "
                  f"epilogue {epilogue_ms:.3f} ms; the wrapper {whole_ms:.3f} ms")
            if dname == "f32":
                f32_ms = {"f32_ms": whole_ms, "f32_sweep_ms": sweep_ms}
                continue
            # The sweep's operations: two products per point, and m2 = x2^T x2,
            # which is symmetric, so C2 (C2 + 1) / 2 of its entries are needed.
            # The epilogue's f32 products are left out: the bound errs low.
            n, C2 = B * G * M, 256
            ops = 2 * n * (3 * 128 + 128 * C2) + n * C2 * (C2 + 1)
            nbytes = n * 12 + 2 * B * G * C2 * 4 + C2 * C2 * 4 + 2 * (
                3 * 128 + 128 + 128 * C2 + C2)
            bms, by = bound_ms(nbytes, ops, PEAK["bf16"])
            results["mini_stats"] = dict(
                max_abs_err=max(float((g - t).abs().max()) for g, t in zip(got, want)),
                ms=whole_ms,
                plain_ms=gpu_time_ms(lambda: kmini.mini_stats_plain(M, dt, x, *w)),
                bound_ms=bms, bound_by=by,
                library_ms=gpu_time_ms(lambda: stats_library(M, dt, x, w)),
                sweep_ms=sweep_ms, epilogue_ms=epilogue_ms, **f32_ms)


def block_inputs(B, L, C, dt, seed):
    g = torch.Generator().manual_seed(seed)

    def f(*s, sc=1.0):
        return (torch.randn(*s, generator=g) * sc).to(DEV)

    x, pos = f(B, L, C).to(dt), f(B, L, C).to(dt)
    dp = torch.ones(B, 2, device=DEV)
    s = C ** -0.5
    weights = [1 + 0.1 * f(C), 0.1 * f(C), f(C, 3 * C, sc=s).to(dt), f(C, C, sc=s).to(dt),
               0.1 * f(C), 1 + 0.1 * f(C), 0.1 * f(C), f(C, 4 * C, sc=s).to(dt), 0.1 * f(4 * C),
               f(4 * C, C, sc=(4 * C) ** -0.5).to(dt), 0.1 * f(C)]
    lnf = [1 + 0.1 * f(C), 0.1 * f(C)]
    return x, pos, dp, weights, lnf


def block_library(x, pos, dp, w, heads, lnf=None):
    ln1s, ln1b, wqkv, wproj, bproj, ln2s, ln2b, wfc1, bfc1, wfc2, bfc2 = w
    B, L, C = x.shape
    dt = x.dtype
    x0 = x + pos
    h = F.layer_norm(x0, (C,), ln1s.to(dt), ln1b.to(dt), eps=1e-6)
    q, k, v = (t.reshape(B, L, heads, C // heads).transpose(1, 2)
               for t in F.linear(h, wqkv.t()).split(C, -1))
    a = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(B, L, C)
    x1 = x0 + F.linear(a, wproj.t(), bproj.to(dt)) * dp[:, None, 0:1].to(dt)
    h = F.layer_norm(x1, (C,), ln2s.to(dt), ln2b.to(dt), eps=1e-6)
    h = F.gelu(F.linear(h, wfc1.t(), bfc1.to(dt)), approximate="tanh")
    out = x1 + F.linear(h, wfc2.t(), bfc2.to(dt)) * dp[:, None, 1:2].to(dt)
    if lnf is None:
        return out
    xn = F.layer_norm(out.float(), (C,), lnf[0], lnf[1], eps=1e-6)
    return torch.stack([xn[:, 0], xn[:, 1:].amax(1)], 1)


def check_block(results):
    for B, L, C, H, tag in BLOCK_SHAPES:
        for dname, dt in DTYPES.items():
            x, pos, dp, w, lnf = block_inputs(B, L, C, dt, L)
            got = kvit.fused_vit_block(x, pos, dp, *w, H)
            want = kvit.vit_block_plain(x, pos, dp, *w, H)
            ro = kvit.fused_vit_block_readout(x, pos, dp, *w, *lnf, H)
            ro_want = kvit.vit_block_readout_plain(x, pos, dp, *w, *lnf, H)
            torch.cuda.synchronize()
            err, ro_err = rel_err(got, want), rel_err(ro, ro_want)
            print(f"[kernel] fused_vit_block {tag} {dname} B={B} L={L} C={C} H={H}: max rel "
                  f"err {err:.3e}; readout {ro_err:.3e} (tol {TOL[dname]})")
            check(torch.isfinite(got.float()).all() and torch.isfinite(ro).all(),
                  "vit block non-finite")
            check(err <= TOL[dname], f"fused_vit_block {tag} {dname} error {err}")
            check(ro_err <= TOL[dname], f"fused_vit_block_readout {tag} {dname} error {ro_err}")
            check(bool((ro[:, 2:] == 0).all()), "readout rows 2..7 not zero")
            if tag != "slice" or dname != "bf16":
                continue
            rows, hid = B * L, 4 * C
            ops = 2 * rows * (C * 3 * C + C * C + 2 * C * hid) + 4 * B * L * L * C
            wbytes = 2 * (C * 3 * C + C * C + 2 * C * hid) + 4 * (7 * C + hid)
            bms, by = bound_ms(3 * rows * C * 2 + B * 2 * 4 + wbytes, ops, PEAK["bf16"])
            results["fused_vit_block"] = dict(
                max_abs_err=float((got.float() - want.float()).abs().max()),
                ms=gpu_time_ms(lambda: kvit.fused_vit_block(x, pos, dp, *w, H)),
                plain_ms=gpu_time_ms(lambda: kvit.vit_block_plain(x, pos, dp, *w, H)),
                bound_ms=bms, bound_by=by,
                library_ms=gpu_time_ms(lambda: block_library(x, pos, dp, w, H)))
            bms, by = bound_ms(2 * rows * C * 2 + B * 2 * 4 + wbytes + 4 * 2 * C
                               + B * 8 * C * 4, ops + 8 * rows * C, PEAK["bf16"])
            results["fused_vit_block_readout"] = dict(
                max_abs_err=float((ro - ro_want).abs().max()),
                ms=gpu_time_ms(lambda: kvit.fused_vit_block_readout(x, pos, dp, *w, *lnf, H)),
                plain_ms=gpu_time_ms(
                    lambda: kvit.vit_block_readout_plain(x, pos, dp, *w, *lnf, H)),
                bound_ms=bms, bound_by=by,
                library_ms=gpu_time_ms(lambda: block_library(x, pos, dp, w, H, lnf)))


# ---------------------------------------------------------------------------
# phase 4: the recognition path at full width
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def plain_path():
    """Route the model's kernel calls to the plain PyTorch versions."""
    saved = (kgroup.fps_batched, kgroup.knn_gather, npb.mini_forward, npb.fused_vit_block,
             npb.fused_vit_block_readout, npb.mini_stats)
    kgroup.fps_batched = kgroup.fps_plain
    kgroup.knn_gather = kgroup.knn_gather_plain
    npb.mini_forward = kmini.mini_forward_plain
    npb.mini_stats = kmini.mini_stats_plain
    npb.fused_vit_block = kvit.vit_block_plain
    npb.fused_vit_block_readout = kvit.vit_block_readout_plain
    try:
        yield
    finally:
        (kgroup.fps_batched, kgroup.knn_gather, npb.mini_forward, npb.fused_vit_block,
         npb.fused_vit_block_readout, npb.mini_stats) = saved


MN40_TEST_CLOUDS = 2468  # ModelNet40's test split


def run_slice(passes=5, batch=32, npoints=1024, seed=0):
    args = TaskArgs(dataset_name="modelnet40", npoints=npoints, batch_size=batch,
                    num_learnable_prompt_tokens=32, class_name_position="middle",
                    compute_dtype="bfloat16", evaluate_3d=True, seed=seed, device="cuda")
    classnames = args.load_classnames()  # the 40 ModelNet40 names
    check(len(classnames) == 40, "ModelNet40 class names")
    spec = build_prompt_spec(classnames, n_ctx=32, class_name_position="middle")
    prompts = PromptArrays.from_spec(spec, device=DEV)
    model = build_model("ULIP_PointBERT", args, device=DEV).model
    n_params = sum(p.numel() for p in model.parameters())
    full = make_synthetic(num_classes=40, samples_per_class=-(-MN40_TEST_CLOUDS // 40),
                          npoints=npoints, seed=seed + 1, classnames=classnames)
    ds = ArrayDataset(full.points[:MN40_TEST_CLOUDS], full.labels[:MN40_TEST_CLOUDS],
                      full.classnames, name=full.name)
    eval_fn = make_cached_text_eval(model)
    embed_fn, step_fn = eval_fn
    n_batches = math.ceil(len(ds) / batch)
    print(f"[slice] ULIP_PointBERT bf16: {n_params / 1e6:.1f} M parameters, "
          f"{len(ds)} clouds x {npoints} points, batch {batch} ({n_batches} batches), "
          f"prompt length {prompts.perm_tokens.shape[1]}")

    cls.validate(model, eval_fn, ds, prompts, args, DEV)  # warm-up (allocator, libraries)
    torch.cuda.synchronize()
    walls, launches = [], None
    for _ in range(passes):
        _build.reset_launches()
        t0 = time.perf_counter()
        val = cls.validate(model, eval_fn, ds, prompts, args, DEV)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        got = dict(_build.LAUNCHES)
        check(launches is None or got == launches, f"launch counts differ between passes: {got}")
        launches = got
    rates = sorted(len(ds) / w for w in walls)
    rate = rates[len(rates) // 2]
    print(f"[slice] validate, {passes} passes of {len(ds)} clouds (text tower once + "
          f"{n_batches} batches each): median {rate:.1f} clouds/sec, min {rates[0]:.1f}, "
          f"max {rates[-1]:.1f}; pass walls ms {[round(w * 1e3, 2) for w in walls]}; "
          f"acc1 {val['acc1']:.2f} (random weights)")
    print(f"[slice] kernel launches in one pass: {json.dumps(launches, sort_keys=True)}")
    for name in SOURCES:
        if name != "mini_stats":  # the train path's kernel: phase 5 counts it
            check(launches.get(name, 0) > 0, f"{name} was not launched on the main path")

    text_ms = []
    for _ in range(passes):
        t0 = time.perf_counter()
        embed_fn(model, prompts)
        torch.cuda.synchronize()
        text_ms.append((time.perf_counter() - t0) * 1e3)
    text_med = sorted(text_ms)[len(text_ms) // 2]
    pass_med = sorted(walls)[len(walls) // 2] * 1e3
    print(f"[slice] text tower (40 prompts, once per pass): median {text_med:.2f} ms, "
          f"{100 * text_med / pass_med:.2f}% of the median pass ({pass_med:.1f} ms)")

    # the same weights and batch through the plain path on the card
    pc = torch.from_numpy(ds.points[:batch]).to(DEV)
    text_embed = embed_fn(model, prompts)
    logits = step_fn(model, {"pc": pc}, text_embed)
    with plain_path():
        want = step_fn(model, {"pc": pc}, text_embed)
    torch.cuda.synchronize()
    check(logits.shape == (batch, 40) and torch.isfinite(logits).all(), "slice logits")
    diff = float((logits - want).abs().max() / want.std())
    top1 = float((logits.argmax(-1) == want.argmax(-1)).float().mean())
    print(f"[slice] logits vs plain path on the card (bf16): max|diff|/std {diff:.3e}, "
          f"top-1 agreement {top1:.3f}")
    check(diff <= 0.25 and top1 >= 0.8, "bf16 slice logits disagree with the plain path")

    # f32 at full width: the kernels should follow the plain path closely
    args.compute_dtype = "float32"
    m32 = build_model("ULIP_PointBERT", args, device=DEV).model
    te32 = embed_fn(m32, prompts)
    l32 = step_fn(m32, {"pc": pc}, te32)
    with plain_path():
        w32 = step_fn(m32, {"pc": pc}, te32)
    torch.cuda.synchronize()
    diff32 = float((l32 - w32).abs().max() / w32.std())
    top1_32 = float((l32.argmax(-1) == w32.argmax(-1)).float().mean())
    print(f"[slice] logits vs plain path on the card (f32): max|diff|/std {diff32:.3e}, "
          f"top-1 agreement {top1_32:.3f}")
    check(diff32 <= 1e-3 and top1_32 >= 0.95, "f32 slice logits disagree with the plain path")
    return launches, {"clouds_per_sec": rate, "clouds_per_sec_min": rates[0],
                      "clouds_per_sec_max": rates[-1], "text_tower_ms": text_med,
                      "pass_ms": pass_med}


# ---------------------------------------------------------------------------
# phase 5: the prompt-tuning train path at full width
# ---------------------------------------------------------------------------

TRAIN_BATCH = 30  # configs/experiments/ppt_base_mn40.yaml
TRAIN_DIR = _build.BUILD_DIR.parent / "chip_smoke_train"


def synthetic_modelnet40(args, split):
    """ModelNet40's 40 class names over synthetic clouds (no dataset ships
    with the repository): 30 clouds per class to train on, 3 to test."""
    names = TaskArgs(dataset_name="modelnet40").load_classnames()
    ds = make_synthetic(num_classes=40, samples_per_class=30 if split == "train" else 3,
                        npoints=args.npoints, seed=0 if split == "train" else 1, classnames=names)
    return ArrayDataset(ds.points, ds.labels, ds.classnames, name="modelnet40_synthetic_clouds")


def train_args(dtype="bfloat16", head_type=0, batch=TRAIN_BATCH, **kw):
    return TaskArgs(dataset_name="modelnet40", npoints=1024, batch_size=batch,
                    num_learnable_prompt_tokens=32, class_name_position="middle",
                    compute_dtype=dtype, head_type=head_type, label_smoothing=0.2, lr=3e-3,
                    epochs=250, seed=0, device="cuda", pretrained_dir="",
                    output_dir=str(TRAIN_DIR), **kw)


def snapshot(tensors):
    return {k: v.detach().clone() for k, v in tensors.items()}


def one_step_quantities(ctx, batch, seed):
    """Loss, gradients of the trainable leaves and the BatchNorm buffers
    after one training-mode forward/backward (no optimizer step), with the
    state put back as it was."""
    state, model = ctx["state"], ctx["model"]
    before = snapshot(state.batch_stats())
    state.generator.manual_seed(seed)
    logits = model(batch["pc"], ctx["prompts"], train=True, generator=state.generator)
    loss = smoothed_cross_entropy(logits, batch["label"], 0.2)
    names = list(state.trainable)
    grads = dict(zip(names, torch.autograd.grad(loss, [state.trainable[k] for k in names])))
    after = snapshot(state.batch_stats())
    with torch.no_grad():
        for k, v in state.batch_stats().items():
            v.copy_(before[k])
    torch.cuda.synchronize()
    return float(loss.detach()), grads, after


def compare_with_plain(dtype, head_type, batch_size, tol_loss, tol_grad, tol_stats):
    """One step through the kernels against the same step through their
    plain versions on the card; returns the worst relative differences."""
    ctx = cls.setup(train_args(dtype, head_type, batch_size))
    b = cls.device_batch(next(iter(Loader(ctx["train_ds"], batch_size, shuffle=True, seed=3))),
                         DEV)
    loss, grads, stats = one_step_quantities(ctx, b, seed=11)
    with plain_path():
        loss_p, grads_p, stats_p = one_step_quantities(ctx, b, seed=11)
    d_loss = abs(loss - loss_p) / abs(loss_p)
    d_grad = {k: rel_err(grads[k], grads_p[k]) for k in grads}
    d_stats = max(rel_err(stats[k], stats_p[k]) for k in stats)
    tag = f"{dtype} head_type {head_type} B={batch_size}"
    print(f"[train] one step vs plain path on the card ({tag}): loss {loss:.6f} vs "
          f"{loss_p:.6f} (rel {d_loss:.3e}, tol {tol_loss}); BN buffers max rel "
          f"{d_stats:.3e} (tol {tol_stats}); gradient max rel per leaf (tol {tol_grad}): "
          + json.dumps({k: float(f"{v:.3e}") for k, v in d_grad.items()}))
    check(math.isfinite(loss) and all(torch.isfinite(g).all() for g in grads.values()),
          f"non-finite loss or gradient ({tag})")
    check(all(float(g.abs().max()) > 0 for g in grads.values()), f"a zero gradient ({tag})")
    check(d_loss <= tol_loss, f"loss disagrees with the plain path ({tag})")
    check(max(d_grad.values()) <= tol_grad, f"gradients disagree with the plain path ({tag})")
    check(d_stats <= tol_stats, f"BN buffers disagree with the plain path ({tag})")
    if head_type:
        check(any("block_11" in k for k in d_grad), "head_type 3 trains no block_11 leaf")
    return {"loss_rel": d_loss, "grad_rel": max(d_grad.values()), "stats_rel": d_stats}


def run_train_slice(windows=5, steps_per_window=20, warmup=5):
    saved_loader = pdata.DATASETS["modelnet40"]
    pdata.DATASETS["modelnet40"] = synthetic_modelnet40
    try:
        return _run_train_slice(windows, steps_per_window, warmup)
    finally:
        pdata.DATASETS["modelnet40"] = saved_loader
        shutil.rmtree(TRAIN_DIR, ignore_errors=True)


def _run_train_slice(windows, steps_per_window, warmup):
    args = train_args()
    ctx = cls.setup(args)
    state, model, prompts = ctx["state"], ctx["model"], ctx["prompts"]
    check(len(ctx["classnames"]) == 40 and ctx["classnames"][0] == "airplane",
          "ModelNet40 class names")
    check(sorted(state.trainable) == ["prompt_learner.learnable_tokens"], "head_type 0 partition")
    frozen0 = snapshot({k: p for k, p in model.named_parameters() if k not in state.trainable})
    check(not any(p.requires_grad for p in frozen0.values()), "a frozen leaf requires grad")
    tokens0 = snapshot(state.trainable)["prompt_learner.learnable_tokens"]
    stats0 = snapshot(state.batch_stats())
    step_fn = make_train_step(smoothing=args.label_smoothing)
    loader = Loader(ctx["train_ds"], TRAIN_BATCH, shuffle=True, drop_last=True, seed=args.seed)
    print(f"[train] ULIP_PointBERT bf16 head_type 0: {len(ctx['train_ds'])} train clouds x "
          f"{args.npoints} points, batch {TRAIN_BATCH} ({ctx['steps_per_epoch']} steps per "
          f"epoch), label smoothing {args.label_smoothing}, lr {args.lr}, DropPath "
          f"{model.point_encoder.config.drop_path_rate}, augmentation on")

    def batches():
        epoch = 0
        while True:
            loader.set_epoch(epoch)
            for batch in loader:
                yield batch
            epoch += 1

    stream = batches()

    def run(n, read_every_step=True):
        """`n` steps as the body of ``cls.train_loop`` takes them: the loss
        is read on the host after every step, which waits for the card.
        With ``read_every_step`` off the losses are read after the last."""
        nonlocal state
        losses = []
        for _ in range(n):
            b = cls.device_batch(next(stream), DEV)
            b["pc"] = train_augment(state.generator, b["pc"])
            state, metrics = step_fn(state, b, prompts)
            losses.append(float(metrics["loss"]) if read_every_step else metrics["loss"])
        torch.cuda.synchronize()
        return [float(x) for x in losses]

    # `windows` windows that read the loss every step, and between each two
    # of them one that reads its losses at its end, so a host that drifts
    # during the run slows both kinds alike
    losses = run(warmup)
    _build.reset_launches()
    in_order = []
    for i in range(2 * windows - 1):
        t0 = time.perf_counter()
        losses += run(steps_per_window, read_every_step=i % 2 == 0)
        in_order.append(steps_per_window * TRAIN_BATCH / (time.perf_counter() - t0))
    launches = dict(_build.LAUNCHES)
    n_steps = len(in_order) * steps_per_window
    per_step = {k: v / n_steps for k, v in sorted(launches.items())}
    rates, late = sorted(in_order[0::2]), sorted(in_order[1::2])
    rate, late_rate = rates[len(rates) // 2], late[len(late) // 2]
    print(f"[train] {warmup} warm-up steps, then {len(in_order)} windows of {steps_per_window} "
          f"steps, train clouds/sec in run order {[round(r, 1) for r in in_order]}; loss first "
          f"{losses[0]:.4f}, last {losses[-1]:.4f}")
    print(f"[train] {len(rates)} windows with the loss read every step, as train_loop reads it: "
          f"median {rate:.1f} train clouds/sec, min {rates[0]:.1f}, max {rates[-1]:.1f} "
          f"({1e3 * TRAIN_BATCH / rate:.2f} ms per step)")
    print(f"[train] {len(late)} windows between them with the losses read once per window (no "
          f"wait per step): median {late_rate:.1f} train clouds/sec, min {late[0]:.1f}, max "
          f"{late[-1]:.1f} ({1e3 * TRAIN_BATCH / late_rate:.2f} ms per step)")
    print(f"[train] kernel launches per step: {json.dumps(per_step)}")

    # one epoch through train_loop itself (epochs cut to 1; the schedule is setup's)
    steps_before = state.step
    loop_args = dataclasses.replace(args, start_epoch=0, epochs=1)
    epoch = cls.train_loop(loop_args, ctx)["history"][0]
    state = ctx["state"]
    loop_steps = state.step - steps_before
    loop_rate = loop_steps * TRAIN_BATCH / epoch["epoch_time"]
    print(f"[train] cls.train_loop, one epoch of {loop_steps} steps: {loop_rate:.1f} train "
          f"clouds/sec ({1e3 * epoch['epoch_time'] / loop_steps:.2f} ms per step), loss "
          f"{epoch['loss']:.4f}, val_acc1 {epoch['val_acc1']:.2f}")
    check(loop_steps == ctx["steps_per_epoch"] and math.isfinite(epoch["loss"]),
          "train_loop's epoch")
    check(all(math.isfinite(x) for x in losses), "non-finite training loss")
    check(steps_before == warmup + n_steps and n_steps >= 100, "step count")
    for name in SOURCES:
        check(launches.get(name, 0) >= n_steps, f"{name} was not launched on every train step")
    check(all(torch.equal(p, frozen0[k]) for k, p in model.named_parameters() if k in frozen0),
          "a frozen weight changed")
    moved = float((state.trainable["prompt_learner.learnable_tokens"].detach() - tokens0)
                  .abs().max())
    stats_moved = min(float((v - stats0[k]).abs().max()) for k, v in state.batch_stats().items())
    print(f"[train] frozen weights unchanged ({len(frozen0)} leaves); prompt tokens moved by up "
          f"to {moved:.3e}; every BatchNorm buffer moved (least max change {stats_moved:.3e})")
    check(moved > 0 and stats_moved > 0, "prompt tokens or BN buffers did not move")

    # save -> load into a fresh setup -> the evaluation step gives the same logits
    save_checkpoint(str(TRAIN_DIR / "cls"), state, meta={"epoch": 0})
    eval_args = train_args(evaluate_3d=True, test_ckpt_addr=str(TRAIN_DIR / "cls"))
    ctx2 = cls.setup(eval_args)
    ctx2["state"] = load_checkpoint(eval_args.test_ckpt_addr, ctx2["state"])
    embed_fn, step_fn2 = make_cached_text_eval(model)
    pc = torch.from_numpy(ctx["test_ds"].points[:TRAIN_BATCH]).to(DEV)
    want = step_fn2(model, {"pc": pc}, embed_fn(model, prompts))
    got = step_fn2(ctx2["model"], {"pc": pc}, embed_fn(ctx2["model"], ctx2["prompts"]))
    untrained = cls.setup(train_args())["model"]
    base = step_fn2(untrained, {"pc": pc}, embed_fn(untrained, prompts))
    val = cls.validate(ctx2["model"], (embed_fn, step_fn2), ctx2["test_ds"], ctx2["prompts"],
                       eval_args, DEV)
    torch.cuda.synchronize()
    print(f"[train] checkpoint round trip: logits identical {torch.equal(got, want)}; differ "
          f"from the untrained model's by up to {float((want - base).abs().max()):.3e}; "
          f"validate acc1 {val['acc1']:.2f} on {len(ctx2['test_ds'])} synthetic test clouds")
    check(torch.isfinite(want).all() and torch.equal(got, want),
          "logits differ after the checkpoint round trip")
    check(not torch.equal(want, base), "training left the logits unchanged")

    # a fixed batch, augmentation and DropPath off: the loss must fall
    fixed_args = train_args()
    fixed_args.pointbert_config = npb.PointBertConfig(drop_path_rate=0.0)
    fctx = cls.setup(fixed_args)
    fstep = make_train_step(smoothing=0.2)
    fb = cls.device_batch(next(iter(loader)), DEV)
    fstate, flosses = fctx["state"], []
    for _ in range(60):
        fstate, m = fstep(fstate, fb, fctx["prompts"])
        flosses.append(m["loss"])
    flosses = [float(x) for x in flosses]
    print(f"[train] fixed batch, 60 steps, augmentation and DropPath off: loss "
          f"{flosses[0]:.4f} -> {flosses[-1]:.4f} (lowest {min(flosses):.4f})")
    check(all(math.isfinite(x) for x in flosses) and flosses[-1] < flosses[0],
          "the loss did not fall on a fixed batch")

    agree = {
        "f32": compare_with_plain("float32", 0, TRAIN_BATCH, 1e-4, 1e-4, 1e-4),
        "bf16": compare_with_plain("bfloat16", 0, TRAIN_BATCH, 5e-2, 0.25, 2e-2),
        "f32_head3": compare_with_plain("float32", 3, 8, 1e-4, 1e-4, 1e-4),
        "bf16_head3": compare_with_plain("bfloat16", 3, 8, 5e-2, 0.25, 2e-2),
    }
    return launches, {
        "train_clouds_per_sec": rate, "train_clouds_per_sec_min": rates[0],
        "train_clouds_per_sec_max": rates[-1], "ms_per_step": 1e3 * TRAIN_BATCH / rate,
        "loss_read": "every step", "train_clouds_per_sec_loss_read_per_window": late_rate,
        "window_clouds_per_sec_in_run_order": in_order,
        "train_loop_clouds_per_sec": loop_rate,
        "steps": n_steps, "batch": TRAIN_BATCH, "loss_first": losses[0], "loss_last": losses[-1],
        "launches_per_step": per_step, "fixed_batch_loss": [flosses[0], flosses[-1]],
        "vs_plain": agree,
    }


def main():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[card] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"Python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    times = _build.build_all(force=True)
    print(f"[build] {len(times)} sources built in parallel in {time.perf_counter() - t0:.1f} s "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in sorted(times.items()))})")
    for name in _build.SOURCES:
        log = (_build.BUILD_DIR / f"{name}.log").read_text()
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        print(f"[build] {name}.cu ptxas: " + " | ".join(regs[:12]))

    results = {}
    check_grouping(results)
    check_mini(results)
    check_mini_stats(results)
    check_block(results)
    launches, slice_stats = run_slice()
    train_launches, train_stats = run_train_slice()
    launches["mini_stats"] = train_launches["mini_stats"]  # the train path's own kernel

    kernels = []
    for name, (source, replaces) in SOURCES.items():
        r = results[name]
        kernels.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                            launches=launches[name], **r))
        print(f"[time] {name}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
              f"library {r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 3)}"
              f" ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    print(json.dumps({"train": train_stats}))
    print(json.dumps({"kernels": kernels, **slice_stats}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
