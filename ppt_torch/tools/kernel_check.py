"""On-card check of every production kernel against its plain semantics.

Counterpart of ``ppt_tpu/tools/kernel_check.py``: the same checks, under
the same names, at the reference tool's shapes and limits. Each of the
port's hand-written kernels runs on the card and is held to the port's
plain PyTorch version of the same function, or to the reference tool's
own formulation where it writes one out (the FPS recurrence). Indices are
exact (the plain versions take the kernels' exact-difference distance);
floating-point results within the reference's limits. One name is
renamed: the reference's ``knn_gather.*_stacked_n2048`` pin a Pallas
gather option that the CUDA kernel does not have, so the port checks the
same shape as ``knn_gather.*_n2048``. Like the reference tool, it leaves
out the two entry points no module calls (``fps_single``, which launches
``fps_batched``'s kernel, and ``knn_single``, which runs ``knn_gather``'s
selection: the counterparts of ``fps_pallas`` and ``knn_pallas``) and the
ablation probe's kernel; ``chip_smoke.py`` holds those.

Prints one JSON line per check, then ``{"failures": n}``; exits 1 on any
failure. Needs a CUDA card.

    python -m ppt_torch.tools.kernel_check
"""

from __future__ import annotations

import contextlib
import copy
import json
import sys

import numpy as np
import torch

from ppt_torch.kernels import attention as kattn
from ppt_torch.kernels import chamfer as kchamfer
from ppt_torch.kernels import emd as kemd
from ppt_torch.kernels import group as kgroup
from ppt_torch.kernels import mini as kmini
from ppt_torch.kernels import textblock as ktextblock
from ppt_torch.kernels import vitblock as kvit
from ppt_torch.nn import pointbert as npb
from ppt_torch.nn.layers import init_dense_
from ppt_torch.nn.text import TextConfig, TextTransformer
from ppt_torch.ops import losses3d as plosses
from ppt_torch.ops.geometry import index_points

# the reference tool's shapes (its :42, :115, :139, :190, :202, :233, :283,
# :314-316, :378, :475-477)
B, N, G, K = 32, 1024, 512, 32
N_LONG, N_MID = 8192, 2048
CHAMFER = (8, 2048)
EMD = ((64, 32), (1024, 768))
TEXT = (40, 48, TextConfig())  # classes, positions, config
MHA = (32, 513, 6, 64)
BLOCK = (32, 513, 384, 6)
DEPTH = 12
TEXT_BLOCK = (40, 77, 512, 8)


def check_names():
    """The checks' names, in order, at the module's shapes."""
    n_cls, n_pos, tcfg = TEXT
    mha = ",".join(map(str, MHA))
    blk = ",".join(map(str, BLOCK[:3]))
    return (
        "fps_batched", "knn_gather.idx", "knn_gather.nbr", f"knn_gather.idx_n{N_LONG}",
        f"knn_gather.nbr_n{N_LONG}", f"knn_gather.idx_n{N_MID}", f"knn_gather.nbr_n{N_MID}",
        "ball_query_gather.idx", "ball_query_gather.grouped", "chamfer_pallas",
        *(f"emd_pallas{part}.N{n}xM{m}" for n, m in EMD for part in ("", ".mass")),
        f"text_tower[{n_cls}x{n_pos}x{tcfg.width},{tcfg.layers}L]",
        "ball_query_gather_feats.idx", "ball_query_gather_feats.fj",
        f"fused_mha[{mha}].padded", f"fused_mha[{mha}].pad_free", f"vit_block[{blk}]",
        f"vit_block_readout[{blk}]", f"vit_tower[{blk},{DEPTH}L]", "fused_mini.eval",
        "fused_mini.train_stats", "text_block[{},{},{}]".format(*TEXT_BLOCK[:3]),
    )


def fps_recurrence(x: torch.Tensor, npoint: int) -> torch.Tensor:
    """The reference tool's FPS formulation (its ``:51-66``): running min
    distance from 1e10, first argmax, start 0; the squared distance summed
    x, y, z in order."""
    Bn, Nn, _ = x.shape
    dist = torch.full((Bn, Nn), 1e10, device=x.device)
    far = torch.zeros(Bn, dtype=torch.long, device=x.device)
    out = torch.zeros(Bn, npoint, dtype=torch.int32, device=x.device)
    for i in range(npoint):
        out[:, i] = far.to(torch.int32)
        sq = (x - x[torch.arange(Bn, device=x.device), far][:, None]) ** 2
        dist = torch.minimum(dist, (sq[..., 0] + sq[..., 1]) + sq[..., 2])
        far = torch.argmax(dist, 1)
    return out


@contextlib.contextmanager
def plain_mini():
    """MiniPointNet's two kernels routed to their plain versions."""
    saved = npb.mini_forward, npb.mini_stats
    npb.mini_forward, npb.mini_stats = kmini.mini_forward_plain, kmini.mini_stats_plain
    try:
        yield
    finally:
        npb.mini_forward, npb.mini_stats = saved


def rel_max(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float(), want.float()
    return float((got - want).abs().max()) / (float(want.abs().max()) or 1.0)


def run_checks(dev: torch.device) -> int:
    """Every check on ``dev``; returns the number of failures."""
    rng = np.random.RandomState(0)
    failures = 0
    seen = []

    def check(name, ok, detail=""):
        nonlocal failures
        seen.append(name)
        print(json.dumps({"kernel": name, "ok": bool(ok), "detail": detail}), flush=True)
        failures += 0 if ok else 1

    def t(a, dt=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dt)

    xyz = t(rng.rand(B, N, 3))

    # --- fps_batched vs the FPS recurrence (exact indices) ---
    got = kgroup.fps_batched(xyz, G)
    want = fps_recurrence(xyz, G)
    check("fps_batched", torch.equal(got, want), f"{int((got != want).sum())} index mismatches")
    center = index_points(xyz, want)

    # --- knn_gather vs its plain version (exact, ties to the lowest index) ---
    def knn_checks(suffix, x, c):
        idx, nbr = kgroup.knn_gather(K, x, c)
        want_idx, _ = kgroup.knn_gather_plain(K, x, c)
        n_bad = int((idx != want_idx).sum())
        check(f"knn_gather.idx{suffix}", n_bad == 0,
              "exact" if n_bad == 0 else f"{n_bad} index mismatches")
        err = float((nbr - (index_points(x, idx) - c[:, :, None, :])).abs().max())
        check(f"knn_gather.nbr{suffix}", err < 1e-5, f"max abs err {err:.2e}")

    knn_checks("", xyz, center)
    # the reference-native N=8192, and N=2048
    for n in (N_LONG, N_MID):
        x = t(rng.rand(4, n, 3))
        knn_checks(f"_n{n}", x, x[:, :G].contiguous())

    # --- ball_query_gather vs its plain version (exact indices) ---
    radius = 0.2
    idx_b, grp_b = kgroup.ball_query_gather(radius, K, xyz, center)
    want_b, _ = kgroup.ball_query_gather_plain(radius, K, xyz, center)
    check("ball_query_gather.idx", torch.equal(idx_b, want_b),
          f"{int((idx_b != want_b).sum())} index mismatches")
    err = float((grp_b - (index_points(xyz, idx_b) - center[:, :, None, :])).abs().max())
    check("ball_query_gather.grouped", err < 1e-5, f"max abs err {err:.2e}")

    # --- chamfer kernel vs the plain Chamfer-L2 at reconstruction scale ---
    a, b = t(rng.rand(CHAMFER[0], CHAMFER[1], 3)), t(rng.rand(CHAMFER[0], CHAMFER[1], 3))
    got_c, want_c = float(kchamfer.chamfer(a, b)), float(plosses.chamfer_l2(a, b))
    rel = abs(got_c - want_c) / max(abs(want_c), 1e-9)
    check("chamfer_pallas", rel < 1e-4, f"rel err {rel:.2e}")

    # --- auction-EMD kernel vs the plain ten-level auction ---
    for n_e, m_e in EMD:
        ae, be = t(rng.rand(4, n_e, 3)), t(rng.rand(4, m_e, 3))
        got_e, want_e = kemd.emd_matchcost(ae, be), plosses.emd_matchcost(ae, be)
        rel = float(((got_e - want_e).abs() / want_e.abs().clamp_min(1e-9)).max())
        check(f"emd_pallas.N{n_e}xM{m_e}", rel < 1e-3, f"rel err {rel:.2e}")
        # shipped mass = min(total supply, total capacity) (emd_kernel.cu:43-44)
        m_sum = float(kemd.approx_match(ae, be).sum())
        want_mass = 4 * min(n_e * max(1, m_e // n_e), m_e * max(1, n_e // m_e))
        check(f"emd_pallas.mass.N{n_e}xM{m_e}", abs(m_sum - want_mass) / want_mass < 1e-2,
              f"total mass {m_sum:.1f} (want {want_mass})")

    # --- the whole text tower's kernels vs the plain modules (bf16) ---
    n_cls, n_pos, tcfg = TEXT
    gen = torch.Generator().manual_seed(3)
    tmodel = TextTransformer(tcfg, dtype=torch.bfloat16, fused="off")
    init_dense_(tmodel, gen)
    tmodel.text_projection.data.copy_(torch.randn(tcfg.width, tcfg.embed_dim, generator=gen)
                                      * tcfg.width ** -0.5)
    tmodel = tmodel.to(dev)
    tx = t(rng.randn(n_cls, n_pos, tcfg.width) * 0.1)
    teot = torch.from_numpy(rng.randint(4, n_pos, n_cls)).to(dev)
    want_t = tmodel(tx, teot).float()
    tmodel.fused = "tower"
    got_t = tmodel(tx, teot).float()
    rel, finite = rel_max(got_t, want_t), bool(torch.isfinite(got_t).all())
    check(f"text_tower[{n_cls}x{n_pos}x{tcfg.width},{tcfg.layers}L]", rel < 3e-2 and finite,
          f"max rel err {rel:.2e} vs the plain tower (bf16), finite={finite}")

    # --- ball_query_gather_feats vs its plain version ---
    feats = t(rng.rand(B, N, 64), torch.bfloat16)
    idx_f, _, fj = kgroup.ball_query_gather_feats(radius, K, xyz, center, feats)
    check("ball_query_gather_feats.idx", torch.equal(idx_f, want_b),
          f"{int((idx_f != want_b).sum())} index mismatches")
    err = float((fj.float() - index_points(feats, idx_f).float()).abs().max())
    check("ball_query_gather_feats.fj", err == 0.0,
          f"max abs err {err:.2e} (a gather is exact in any type)")

    # --- whole-row attention at the ViT shape: contiguous q, k, v ("padded")
    # and views of one qkv product, as the unfused block hands them over
    # ("pad_free"), against the f32-softmax reference ---
    Bm, Lm, Hm, Dm = MHA
    q, kk, vv = (t(rng.rand(Bm, Lm, Hm, Dm) - 0.5, torch.bfloat16) for _ in range(3))
    want_full = kattn.mha_reference(q, kk, vv).float()
    qkv = torch.cat([u.reshape(Bm, Lm, Hm * Dm) for u in (q, kk, vv)], -1)
    views = [u.reshape(Bm, Lm, Hm, Dm) for u in qkv.split(Hm * Dm, -1)]
    for name, args in (("padded", (q, kk, vv)), ("pad_free", views)):
        got_full = kattn.fused_mha(*args).float()
        err, finite = float((got_full - want_full).abs().max()), bool(
            torch.isfinite(got_full).all())
        check(f"fused_mha[{Bm},{Lm},{Hm},{Dm}].{name}", finite and err < 3e-2,
              f"max abs err {err:.2e} vs f32-softmax reference, finite={finite}")

    # --- the ViT block, block + readout and the whole trunk ---
    Bb, Lb, C, H = BLOCK
    xb, posb = (t(rng.rand(Bb, Lb, C) - 0.5, torch.bfloat16) for _ in range(2))
    dp = torch.ones(Bb, 2, device=dev)
    wq = t(rng.randn(C, 3 * C) * 0.05, torch.bfloat16)
    wp = t(rng.randn(C, C) * 0.05, torch.bfloat16)
    bp = t(rng.randn(C) * 0.05)
    w1 = t(rng.randn(C, 4 * C) * 0.05, torch.bfloat16)
    b1 = t(rng.randn(4 * C) * 0.05)
    w2 = t(rng.randn(4 * C, C) * 0.05, torch.bfloat16)
    b2 = t(rng.randn(C) * 0.05)
    ones, zeros = torch.ones(C, device=dev), torch.zeros(C, device=dev)
    bargs = (xb, posb, dp, ones, zeros, wq, wp, bp, ones, zeros, w1, b1, w2, b2)
    for name, got_b, want_bk in (
            (f"vit_block[{Bb},{Lb},{C}]", kvit.fused_vit_block(*bargs, H),
             kvit.vit_block_plain(*bargs, H)),
            (f"vit_block_readout[{Bb},{Lb},{C}]",
             kvit.fused_vit_block_readout(*bargs, ones, zeros, H)[:, :2],
             kvit.vit_block_readout_plain(*bargs, ones, zeros, H)[:, :2])):
        err, finite = rel_max(got_b, want_bk), bool(torch.isfinite(got_b.float()).all())
        check(name, finite and err < 3e-2, f"max rel err {err:.2e} vs plain, finite={finite}")

    def stk(*s):
        return t(rng.randn(DEPTH, *s) * 0.05)

    targs = (xb, posb, torch.ones(Bb, DEPTH, 2, device=dev),
             torch.ones(DEPTH, C, device=dev), torch.zeros(DEPTH, C, device=dev),
             stk(C, 3 * C).to(torch.bfloat16), stk(C, C).to(torch.bfloat16), stk(C),
             torch.ones(DEPTH, C, device=dev), torch.zeros(DEPTH, C, device=dev),
             stk(C, 4 * C).to(torch.bfloat16), stk(4 * C), stk(4 * C, C).to(torch.bfloat16),
             stk(C), ones, zeros)
    got_t2, want_t2 = kvit.fused_vit_tower(*targs, H), kvit.vit_tower_plain(*targs, H)
    err, finite = rel_max(got_t2, want_t2), bool(torch.isfinite(got_t2).all())
    check(f"vit_tower[{Bb},{Lb},{C},{DEPTH}L]", finite and err < 3e-2,
          f"max rel err {err:.2e} vs plain, finite={finite}")

    # --- MiniPointNet on its kernels vs on their plain versions: eval, and
    # train mode (the tokens and the updated bn2 statistics) ---
    mini = npb.MiniPointNet(256, dtype=torch.bfloat16)
    init_dense_(mini, torch.Generator().manual_seed(0))
    mini = mini.to(dev)
    nbrs = t(rng.rand(B, G, K, 3) - 0.5)
    got_m = mini(nbrs).float()
    with plain_mini():
        want_m = mini(nbrs).float()
    err = rel_max(got_m, want_m)
    check("fused_mini.eval", err < 5e-2, f"max rel err {err:.2e} (bf16 folded BN vs plain)")
    runs = []
    for route in (contextlib.nullcontext, plain_mini):
        m = copy.deepcopy(mini)
        with route():
            out = m(nbrs, train=True).float()
        runs.append((out, m.bn2.running_mean.float(), m.bn2.running_var.float()))
    rels = [rel_max(g, w) for g, w in zip(*runs)]
    finite = all(bool(torch.isfinite(g).all()) for g in runs[0])
    check("fused_mini.train_stats", finite and max(rels) < 5e-2,
          f"rel errs out/mean/var = {rels[0]:.2e}/{rels[1]:.2e}/{rels[2]:.2e}, finite={finite}")

    # --- the CLIP text block ---
    Bt, Lt, D, TH = TEXT_BLOCK
    xt = t(rng.rand(Bt, Lt, D) - 0.5, torch.bfloat16)

    def tw(*shape, dt=torch.float32):
        return t(rng.randn(*shape) * 0.05, dt)

    bf = torch.bfloat16
    targs = (xt, torch.ones(D, device=dev), torch.zeros(D, device=dev),
             tw(D, 3 * D, dt=bf), tw(3 * D), tw(D, D, dt=bf), tw(D),
             torch.ones(D, device=dev), torch.zeros(D, device=dev),
             tw(D, 4 * D, dt=bf), tw(4 * D), tw(4 * D, D, dt=bf), tw(D))
    got_t = ktextblock.fused_text_block(*targs, TH).float()
    want_t = ktextblock.text_block_plain(*targs, TH).float()
    err, finite = rel_max(got_t, want_t), bool(torch.isfinite(got_t).all())
    check(f"text_block[{Bt},{Lt},{D}]", finite and err < 3e-2,
          f"max rel err {err:.2e} vs plain, finite={finite}")

    if tuple(seen) != check_names():
        raise RuntimeError(f"kernel_check: ran {seen}, expected {check_names()}")
    return failures


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_check: no CUDA card (torch.cuda.is_available() is false); "
                           "the check runs the kernels on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(json.dumps({"backend": "cuda", "device": torch.cuda.get_device_name(dev)}))
    with torch.no_grad():
        failures = run_checks(dev)
    print(json.dumps({"failures": failures}))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
