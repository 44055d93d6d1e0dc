"""Per-component device time of the PPT-Base step's pieces, on the card.

Counterpart of ``ppt_tpu/tools/component_probe.py``, which times each piece
as a scan chain net of an empty chain; its ``knn_*`` and ``ball_*`` probes
pin Pallas settings the CUDA kernels do not have. This tool times the
port's own components instead, each call's launches queued behind a
sleeping kernel (``timing.queued_ms``) so that the host's time between them
does not show (the components of hundreds of library launches a call back to
back between two events instead, ``timing.gpu_time_ms``), at the shapes of
the main paths, bf16, weights and clouds from a seed:

- ``grouping``: ``fps_batched`` + ``knn_gather`` (B=32 x 1024 points, 512
  groups of 32), and ``grouping_single``: ``fps_single`` + ``knn_single``,
  its A/B;
- ``mini_forward`` (B=32) and ``mini_stats`` (B=30, the train step's);
- ``text_fwd_<route>`` and ``text_grad_<route>`` for each text route (40
  ModelNet40 prompts of 32 tokens "middle", CLIP's 12 layers): the tower
  forward, and its gradient into the prompt embeddings;
- ``vit12_<route>``: the 12 blocks and the readout on each trunk route
  (B=32, 513 tokens, 384 wide);
- ``ball_query_gather`` and ``ball_query_gather_feats`` at PointNeXt-S's
  four stages (B=128);
- ``flash_fwd`` and ``flash_bwd``: ``flash_mha`` on the long trunk
  ([32, 1025, 6, 64]), the forward with its lse and the backward kernels.

Each component prints one JSON line: its device ms a call and the timer
that read it, the port's kernel launches a call (``_build.LAUNCHES``; library kernels are not
counted) and the empty-kernel baseline (``torch.cuda._sleep(0)`` queued the
same way, ms a launch). It needs a card.

    python -m ppt_torch.tools.component_probe [--iters 16] \\
        [--components grouping,mini_forward,vit12_block,flash_bwd]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Callable, Dict, List, Tuple

import torch

from ppt_torch.kernels import _build
from ppt_torch.kernels import attention as kattn
from ppt_torch.kernels import fps as kfps
from ppt_torch.kernels import group as kgroup
from ppt_torch.kernels import knn as kknn
from ppt_torch.kernels import mini as kmini
from ppt_torch.nn.layers import drop_path_scales, init_dense_
from ppt_torch.nn.pointbert import POINT_ROUTES, PointBert, PointBertConfig
from ppt_torch.nn.text import TEXT_ROUTES, TextConfig, TextTransformer
from ppt_torch.tools.timing import gpu_time_ms, queued_ms

# PointNeXt-S's ball queries at B=128: (N, S, radius, nsample, feature width)
PN_NEXT_STAGES = ((1024, 512, 0.15, 32, 32), (512, 256, 0.225, 32, 64),
                  (256, 128, 0.3375, 32, 128), (128, 64, 0.50625, 32, 256))
DEV = torch.device("cuda")
BF16 = torch.bfloat16


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _cloud(B: int, N: int, seed: int) -> torch.Tensor:
    return torch.rand(B, N, 3, generator=_gen(seed)).to(DEV)


def _grouping(single: bool) -> Tuple[Callable, str]:
    xyz = _cloud(32, 1024, 0)

    def run():
        if single:
            idx = kfps.fps_single(xyz, 512)
        else:
            idx = kgroup.fps_batched(xyz, 512)
        ctr = torch.gather(xyz, 1, idx.long()[:, :, None].expand(-1, -1, 3))
        return kknn.knn_single(32, xyz, ctr) if single else kgroup.knn_gather(32, xyz, ctr)

    return run, "B=32 N=1024 -> 512 centres, k=32"


def _mini_weights(seed: int, stats: bool):
    g = _gen(seed)
    shapes = [(3, 128), (128,), (128, 256), (256,), (256, 512), (256, 512), (512,)]
    if not stats:
        shapes += [(512, 256), (256,)]
    return [(torch.randn(*s, generator=g) * (s[0] ** -0.5 if len(s) == 2 else 0.1)).to(DEV)
            for s in shapes]


def _mini(stats: bool) -> Tuple[Callable, str]:
    B = 30 if stats else 32
    x = (torch.rand(B, 512 * 32, 3, generator=_gen(1)) - 0.5).to(DEV)
    w = _mini_weights(2, stats)
    fn = kmini.mini_stats if stats else kmini.mini_forward
    return (lambda: fn(32, BF16, x, *w)), f"B={B} G=512 M=32 bf16"


def _text_model(route: str) -> Tuple[TextTransformer, torch.Tensor, torch.Tensor]:
    """CLIP's text tower on ``route`` (weights from a seed), the 40
    ModelNet40 prompts' embeddings and their EOT positions."""
    from ppt_torch.models.ulip import PromptArrays
    from ppt_torch.prompt.learner import build_prompt_spec
    from ppt_torch.tasks.args import TaskArgs

    text = TextTransformer(TextConfig(), dtype=BF16, fused=route)
    g = _gen(3)
    with torch.no_grad():
        init_dense_(text, g)
        for p in (text.token_embedding.weight, text.positional_embedding, text.text_projection):
            p.copy_(torch.randn(p.shape, generator=g) * 0.02)
    text = text.to(DEV).eval().requires_grad_(False)
    labels = TaskArgs(dataset_name="modelnet40").load_classnames()
    prompts = PromptArrays.from_spec(build_prompt_spec(labels, n_ctx=32,
                                                       class_name_position="middle"), device=DEV)
    with torch.no_grad():
        x0 = text.embed(prompts.perm_tokens)
    return text, x0, prompts.eot_pos


def _text(route: str, grad: bool) -> Tuple[Callable, str]:
    text, x0, eot = _text_model(route)
    if not grad:
        return (lambda: text(x0, eot)), f"C=40 L={x0.shape[1]} width 512, 12 layers"
    x = x0.detach().requires_grad_(True)
    cot = torch.randn(x0.shape[0], text.config.embed_dim, generator=_gen(4)).to(DEV)

    def run():
        with torch.enable_grad():
            return torch.autograd.grad(text(x, eot).float(), x, cot)

    return run, f"C=40 L={x0.shape[1]} width 512, 12 layers, forward + backward into the prompts"


def _trunk(route: str) -> Tuple[Callable, str]:
    cfg = PointBertConfig()
    model = PointBert(cfg, dtype=BF16, route=route)
    with torch.no_grad():
        init_dense_(model, _gen(5))
    model = model.to(DEV).eval().requires_grad_(False)
    g = _gen(6)
    B, L, C = 32, cfg.num_group + 1, cfg.trans_dim
    x = torch.randn(B, L, C, generator=g).to(DEV).to(BF16)
    pos = (0.1 * torch.randn(B, L, C, generator=g)).to(DEV).to(BF16)
    dp = drop_path_scales([0.0] * cfg.depth, B, False, None, DEV)
    return ((lambda: model.trunk(x, pos, dp, [0.0] * cfg.depth, route)),
            f"B={B} L={L} C={C}, 12 blocks + readout")


def _ball(feats: bool) -> Tuple[Callable, str]:
    args = []
    for i, (N, S, r, ns, F) in enumerate(PN_NEXT_STAGES):
        xyz = _cloud(128, N, 10 + i)
        f = torch.randn(128, N, F, generator=_gen(20 + i)).to(DEV).to(BF16)
        args.append((r, ns, xyz, xyz[:, :S].contiguous(), f))

    def run():
        for r, ns, xyz, q, f in args:
            if feats:
                kgroup.ball_query_gather_feats(r, ns, xyz, q, f)
            else:
                kgroup.ball_query_gather(r, ns, xyz, q)

    return run, "PointNeXt-S's 4 stages at B=128 (1024->512 ... 128->64), nsample 32" + (
        ", bf16 features 32-256 wide" if feats else "")


def _flash(bwd: bool) -> Tuple[Callable, str]:
    g = _gen(7)
    # q, k, v as the unfused block hands them over: column views of one qkv product
    qkv = (0.5 * torch.randn(32, 1025, 3 * 384, generator=g)).to(DEV).to(BF16)
    q, k, v = (t.reshape(32, 1025, 6, 64) for t in qkv.split(384, dim=-1))
    do = torch.randn(32, 1025, 6, 64, generator=g).to(DEV).to(BF16)
    if not bwd:
        return (lambda: kattn._flash_fwd(q, k, v)), "[32, 1025, 6, 64] bf16, with the lse"
    o, lse = kattn._flash_fwd(q, k, v)
    return (lambda: kattn._flash_bwd(q, k, v, o, lse, do)), "[32, 1025, 6, 64] bf16"


# name -> (maker of (call, shape), timer): "queued" for calls shorter than
# their launches; "events" (back to back between two events) for those with
# hundreds of library launches a call, which would fill the card's launch
# queue behind the sleep, and whose device time exceeds their enqueue
COMPONENTS: Dict[str, Tuple[Callable[[], Tuple[Callable, str]], str]] = {
    "grouping": (lambda: _grouping(False), "queued"),
    "grouping_single": (lambda: _grouping(True), "queued"),
    "mini_forward": (lambda: _mini(False), "queued"),
    "mini_stats": (lambda: _mini(True), "queued"),
    **{f"text_fwd_{r}": ((lambda r=r: _text(r, False)), "events") for r in TEXT_ROUTES},
    **{f"text_grad_{r}": ((lambda r=r: _text(r, True)), "events") for r in TEXT_ROUTES},
    **{f"vit12_{r}": ((lambda r=r: _trunk(r)), "queued" if r in ("block", "tower") else "events")
       for r in POINT_ROUTES},
    "ball_query_gather": (lambda: _ball(False), "queued"),
    "ball_query_gather_feats": (lambda: _ball(True), "queued"),
    "flash_fwd": (lambda: _flash(False), "queued"),
    "flash_bwd": (lambda: _flash(True), "queued"),
}


def probe(name: str, iters: int, baseline_ms: float) -> dict:
    """One component's line: device ms a call, the port's kernel launches a
    call, the baseline."""
    build, timer = COMPONENTS[name]
    fn, shape = build()
    with torch.no_grad():
        fn()  # warm: builds, caches, the allocator
        torch.cuda.synchronize()
        _build.reset_launches()
        fn()
        launches = dict(_build.LAUNCHES)
        if timer == "queued":
            ms = queued_ms(fn, reps=iters)
        else:
            ms = gpu_time_ms(fn, reps=iters, warmup=1)
    return {"component": name, "ms": ms, "timer": timer, "launches": launches,
            "baseline_ms_per_launch": baseline_ms, "iters": iters, "shape": shape}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=16, help="calls queued a reading")
    ap.add_argument("--components", default=",".join(COMPONENTS),
                    help=f"comma-separated, from {', '.join(COMPONENTS)}")
    args = ap.parse_args(argv)
    args.components = [c for c in args.components.split(",") if c]
    unknown = [c for c in args.components if c not in COMPONENTS]
    if unknown:
        ap.error(f"unknown components {unknown}; have {list(COMPONENTS)}")
    return args


def main(argv=None) -> List[dict]:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("component_probe: torch.cuda.is_available() is false; it times the "
                         "port's kernels on a CUDA card and has no CPU fallback")
    baseline = queued_ms(lambda: torch.cuda._sleep(0), reps=args.iters)
    lines = []
    for name in args.components:
        lines.append(probe(name, args.iters, baseline))
        print(json.dumps(lines[-1]), flush=True)
    return lines


if __name__ == "__main__":
    main(sys.argv[1:])
