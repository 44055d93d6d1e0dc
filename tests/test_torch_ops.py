"""Every kernel entry point as a registered operator (``torch.ops.ppt``).

On the CPU each operator runs its plain version; a meta or fake tensor takes
its fake implementation. Held here, for the recognition path's six and for
every other entry point (a case for each variant an argument selects:
``flash_mha`` with and without the lse, ``chamfer_nn_dists`` one way and
both, ``vit_variant`` in each mode): registered through ``_ops.register``;
``torch.library.opcheck``; each bit-equal to its plain version; each fake's
shapes and dtypes equal to the real outputs' at two batches; each FLOP
formula against a hand count (the six and the geometry kernels, by the
work ``PERF.md`` §6 bounds them by) or against ``FlopCounterMode`` of the
plain version (the product kernels); gradients through ``recompute_grad``
unchanged; and no ``autograd.Function`` where nothing needs a gradient.
"""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from ppt_torch.kernels import _autograd, _ops
from ppt_torch.kernels import attention as kattn
from ppt_torch.kernels import chamfer as kchamfer
from ppt_torch.kernels import emd as kemd
from ppt_torch.kernels import fps as kfps
from ppt_torch.kernels import group as kgroup
from ppt_torch.kernels import knn as kknn
from ppt_torch.kernels import mini as kmini
from ppt_torch.kernels import textblock as ktb
from ppt_torch.kernels import texttower as ktt
from ppt_torch.kernels import vitblock as kvit
from ppt_torch.models.ulip import build_model, trainable_mask
from ppt_torch.nn import pointbert as npb
from ppt_torch.nn.pointbert import PointBertConfig
from ppt_torch.nn.text import TextConfig
from ppt_torch.tasks.args import TaskArgs
from ppt_torch.tools import vitblock_probe as probe

torch.set_num_threads(1)  # one intra-op thread: the xdist workers share the cores

OPS = ("fps_batched", "knn_gather", "mini_forward", "mini_stats", "fused_vit_block",
       "fused_vit_block_readout")
# small widths the plain versions take in f32 (the bf16 kernels' widths are the card's)
C1, C2, H, CO = 16, 32, 64, 24
G, M = 4, 8
L, C, HEADS, HID = 9, 32, 4, 128


def _rand(gen, *shape, scale=1.0):
    return torch.from_numpy(gen.standard_normal(shape).astype(np.float32) * scale)


def op_args(name, B, seed=0):
    """The operator's arguments at batch ``B``, drawn from ``seed`` with numpy."""
    gen = np.random.default_rng(seed)
    if name == "fps_batched":
        return (torch.from_numpy(gen.random((B, 64, 3), dtype=np.float32)), 16)
    if name == "knn_gather":
        xyz = torch.from_numpy(gen.random((B, 64, 3), dtype=np.float32))
        return (8, xyz, xyz[:, :16].clone())
    if name in ("mini_forward", "mini_stats"):
        x = _rand(gen, B, G * M, 3)
        w = [_rand(gen, 3, C1, scale=0.5), _rand(gen, C1, scale=0.1), _rand(gen, C1, C2, scale=0.2),
             _rand(gen, C2, scale=0.1), _rand(gen, C2, H, scale=0.2), _rand(gen, C2, H, scale=0.2),
             _rand(gen, H, scale=0.1)]
        if name == "mini_forward":
            w += [_rand(gen, H, CO, scale=0.1), _rand(gen, CO, scale=0.1)]
        return (M, torch.float32, x, *w)
    x = _rand(gen, B, L, C)
    weights = (_rand(gen, B, L, C, scale=0.1), torch.ones(B, 2), 1 + _rand(gen, C, scale=0.1),
               _rand(gen, C, scale=0.1), _rand(gen, C, 3 * C, scale=0.2),
               _rand(gen, C, C, scale=0.2), _rand(gen, C, scale=0.1),
               1 + _rand(gen, C, scale=0.1), _rand(gen, C, scale=0.1),
               _rand(gen, C, HID, scale=0.2), _rand(gen, HID, scale=0.1),
               _rand(gen, HID, C, scale=0.1), _rand(gen, C, scale=0.1))
    if name == "fused_vit_block_readout":
        weights += (1 + _rand(gen, C, scale=0.1), _rand(gen, C, scale=0.1))
    return (x, *weights, HEADS)


PLAIN = {"fps_batched": kgroup.fps_plain, "knn_gather": kgroup.knn_gather_plain,
         "mini_forward": kmini.mini_forward_plain, "mini_stats": kmini.mini_stats_plain,
         "fused_vit_block": kvit.vit_block_plain,
         "fused_vit_block_readout": kvit.vit_block_readout_plain}


# the other entry points, one case per variant an argument selects: case ->
# (operator, the arguments' extra flags after the tensors)
EXTRA = ("fused_mha", "flash_mha", "flash_mha_lse", "flash_mha_bwd", "fused_vit_tower",
         "fused_text_block", "fused_text_tower", "fused_text_tower_res", "fused_text_tower_bwd",
         "ball_query_gather", "ball_query_gather_v2", "ball_query_gather_feats", "approx_match",
         "chamfer_nn_dists", "chamfer_nn_dists_one", "fps_single", "knn_single",
         "vit_variant", "vit_variant_mm_only", "vit_variant_no_gelu", "vit_variant_pv_ones",
         "vit_variant_qk_packed2")
CASES = OPS + EXTRA
OP_OF = {"flash_mha_lse": "flash_mha", "chamfer_nn_dists_one": "chamfer_nn_dists",
         **{c: "vit_variant" for c in EXTRA if c.startswith("vit_variant")}}
# the text tower's and the probe's sizes (the probe's heads are its module's)
TL, TD, THID, TE, TDEPTH, THEADS = 6, 32, 64, 16, 2, 4
VC = 8 * probe.HEADS


def op_of(case):
    return getattr(torch.ops.ppt, OP_OF.get(case, case))


def _text_weights(gen, depth=None):
    """The text block's 12 weights (stacked on ``depth`` when given), then
    with ``depth`` the tower's final LayerNorm and projection."""
    lead = () if depth is None else (depth,)
    shapes = [(TD,), (TD,), (TD, 3 * TD), (3 * TD,), (TD, TD), (TD,), (TD,), (TD,),
              (TD, THID), (THID,), (THID, TD), (TD,)]
    w = [(1 + _rand(gen, *lead, *sh, scale=0.1)) if i in (0, 6) else
         _rand(gen, *lead, *sh, scale=0.2 if len(sh) == 2 else 0.1) for i, sh in enumerate(shapes)]
    if depth is not None:
        w += [1 + _rand(gen, TD, scale=0.1), _rand(gen, TD, scale=0.1),
              _rand(gen, TD, TE, scale=0.2)]
    return w


def _eot(gen, B):
    pos = gen.integers(1, TL, B)
    return torch.from_numpy((np.arange(TL)[None, :] == pos[:, None]).astype(np.float32))


def extra_args(case, B, seed=0):
    """The arguments of an entry point outside the six at batch ``B``."""
    gen = np.random.default_rng(seed)
    if case in ("fused_mha", "flash_mha", "flash_mha_lse", "flash_mha_bwd"):
        q, k, v = (_rand(gen, B, L, 2, 8) for _ in range(3))
        if case == "fused_mha":
            return (q, k, v)
        if case != "flash_mha_bwd":
            return (q, k, v, case == "flash_mha_lse")
        o, lse = kattn.flash_fwd_plain(q, k, v, True)
        return (q, k, v, o, lse, _rand(gen, B, L, 2, 8))
    if case == "fused_vit_tower":
        x, pos, dp, *w, heads = op_args("fused_vit_block_readout", B, seed)
        depth = 2
        stacked = [torch.stack([t * (1 + 0.1 * i) for i in range(depth)]) for t in w[:11]]
        return (x, pos, torch.ones(B, depth, 2), *stacked, *w[11:], heads)
    if case == "fused_text_block":
        return (_rand(gen, B, TL, TD), *_text_weights(gen), THEADS)
    if case.startswith("fused_text_tower"):
        x0, eot, w = _rand(gen, B, TL, TD), _eot(gen, B), _text_weights(gen, TDEPTH)
        if case != "fused_text_tower_bwd":
            return (x0, eot, *w, THEADS)
        xs = ktt.text_tower_plain(x0, eot, *w, THEADS, return_blocks=True)[1]
        return (_rand(gen, B, TE), x0, xs, eot, *w, THEADS)
    if case.startswith("ball_query_gather"):
        xyz = torch.from_numpy(gen.random((B, 64, 3), dtype=np.float32))
        args = (0.3, 8, xyz, xyz[:, :16].clone())
        return args + ((_rand(gen, B, 64, 5),) if case.endswith("feats") else ())
    if case == "approx_match":
        return (kemd.match_d2(_rand(gen, B, 8, 3), _rand(gen, B, 12, 3)),)
    if case.startswith("chamfer_nn_dists"):
        return (_rand(gen, B, 20, 3), _rand(gen, B, 13, 3), case == "chamfer_nn_dists")
    if case == "fps_single":  # npoint past N, as fps_pallas takes it
        return (torch.from_numpy(gen.random((B, 48, 3), dtype=np.float32)), 56)
    if case == "knn_single":
        xyz = torch.from_numpy(gen.random((B, 64, 3), dtype=np.float32))
        return (8, xyz, xyz[:, :16].clone())
    mode = case[len("vit_variant_"):] or "full"
    x = _rand(gen, B, L, VC)
    w = (_rand(gen, B, L, VC, scale=0.1), torch.ones(B, 2), 1 + _rand(gen, VC, scale=0.1),
         _rand(gen, VC, scale=0.1), _rand(gen, VC, 3 * VC, scale=0.2),
         _rand(gen, VC, VC, scale=0.2), _rand(gen, VC, scale=0.1), 1 + _rand(gen, VC, scale=0.1),
         _rand(gen, VC, scale=0.1), _rand(gen, VC, 4 * VC, scale=0.2),
         _rand(gen, 4 * VC, scale=0.1), _rand(gen, 4 * VC, VC, scale=0.1),
         _rand(gen, VC, scale=0.1))
    return (x, *w, mode, 2 if B % 2 == 0 else 1)


def case_args(case, B, seed=0):
    return op_args(case, B, seed) if case in OPS else extra_args(case, B, seed)


def _probe_plain(*args):
    return probe.variant_block_plain(*args[:-2], mode=args[-2], rows=args[-1])


# each case's plain version, as its module defines it (the function the CPU
# branch of its wrapper called before the operator took its place)
PLAIN.update({
    "fused_mha": kattn.mha_plain,
    "flash_mha": lambda q, k, v, want: (kattn.flash_plain(q, k, v), None),
    "flash_mha_lse": lambda q, k, v, want: (kattn.flash_plain(q, k, v),
                                            kattn.flash_lse_plain(q, k)),
    "flash_mha_bwd": kattn.flash_bwd_plain, "fused_vit_tower": kvit.vit_tower_plain,
    "fused_text_block": ktb.text_block_plain, "fused_text_tower": ktt.text_tower_plain,
    "fused_text_tower_res": lambda *a: ktt.text_tower_plain(*a, return_blocks=True),
    "fused_text_tower_bwd": ktt.text_tower_bwd_plain,
    "ball_query_gather": kgroup.ball_query_gather_plain,
    "ball_query_gather_v2": kgroup.ball_query_gather_plain,
    "ball_query_gather_feats": kgroup.ball_query_gather_feats_plain,
    "approx_match": lambda d2: kemd.auction_plain(d2, *kemd.supplies(*d2.shape[1:])),
    "chamfer_nn_dists": lambda a, b, both: (kchamfer.nn_dists_plain(a, b),
                                            kchamfer.nn_dists_plain(b, a)),
    "chamfer_nn_dists_one": lambda a, b, both: (kchamfer.nn_dists_plain(a, b), None),
    "fps_single": kfps.fps_single_plain, "knn_single": kknn.knn_single_plain,
    **{c: _probe_plain for c in EXTRA if c.startswith("vit_variant")},
})


def _outs(x):
    return x if isinstance(x, tuple) else (x,)


def test_the_six_operators_are_registered():
    assert all(hasattr(torch.ops.ppt, name) for name in OPS)
    # the dtype argument is a ScalarType, widths and heads are ints
    assert "ScalarType dtype" in str(torch.ops.ppt.mini_forward.default._schema)
    assert str(torch.ops.ppt.fused_vit_block.default._schema).endswith("int heads) -> Tensor")


@pytest.mark.parametrize("name", CASES)
def test_opcheck(name):
    torch.library.opcheck(op_of(name).default, case_args(name, 2))


@pytest.mark.parametrize("name", CASES)
def test_op_on_the_cpu_is_its_plain_version_bit_for_bit(name):
    args = case_args(name, 3)
    for got, want in zip(_outs(op_of(name)(*args)), _outs(PLAIN[name](*args))):
        if want is None:  # an output the case does not ask for: empty
            assert got.numel() == 0
            continue
        assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("B", [2, 5])
@pytest.mark.parametrize("name", CASES)
def test_fake_shapes_and_dtypes_are_the_real_ones(name, B):
    args = case_args(name, B)
    real = _outs(op_of(name)(*args))
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    fake = _outs(op_of(name)(*meta))
    assert [(tuple(t.shape), t.dtype) for t in fake] == [(tuple(t.shape), t.dtype) for t in real]
    assert all(t.device.type == "meta" for t in fake)


# each operator's launch: the function its CUDA key runs, and the one the
# kernel-path tests (refusals, TMA guard, the stand-in library) call directly
LAUNCH = {
    "fps_batched": kgroup._fps_batched_cuda, "knn_gather": kgroup._knn_gather_cuda,
    "mini_forward": kmini._mini_forward_cuda, "mini_stats": kmini._mini_stats_cuda,
    "fused_vit_block": kvit._block_cuda, "fused_vit_block_readout": kvit._block_readout_cuda,
    "fused_mha": kattn._mha_run, "flash_mha": kattn._flash_cuda,
    "flash_mha_bwd": kattn._flash_bwd, "fused_vit_tower": kvit._tower_cuda,
    "fused_text_block": ktb._block_cuda, "fused_text_tower": ktt._tower_cuda,
    "fused_text_tower_res": ktt._tower_res_cuda, "fused_text_tower_bwd": ktt._tower_bwd_cuda,
    "ball_query_gather": kgroup._ball_cuda, "ball_query_gather_v2": kgroup._ball_v2_cuda,
    "ball_query_gather_feats": kgroup._ball_feats_run, "approx_match": kemd._auction_run,
    "chamfer_nn_dists": kchamfer._nn_cuda, "fps_single": kfps._fps_single_cuda,
    "knn_single": kknn._knn_single_cuda, "vit_variant": probe._variant_cuda,
}


@pytest.mark.parametrize("name", CASES)
def test_every_operator_is_registered_through_register(name):
    """Defined in the ``ppt`` library of ``_ops.register``, with a CPU and a
    CUDA kernel and a fake, and no Autograd key of its own; the CUDA key is
    the launch that the kernel-path tests call directly."""
    op = op_of(name).default
    qualified = op.name()
    assert qualified.startswith("ppt::") and _ops.LIB.ns == "ppt"
    for key in ("CPU", "CUDA", "Meta"):
        assert torch._C._dispatch_has_kernel_for_dispatch_key(qualified, key), key
    assert not torch._C._dispatch_has_kernel_for_dispatch_key(qualified, "Autograd")
    assert op.overloadpacket in torch.utils.flop_counter.flop_registry
    packet = op.overloadpacket.__name__
    assert _ops.CUDA_IMPL[packet] is LAUNCH[packet]


def test_the_launch_table_names_every_operator():
    assert set(LAUNCH) == set(_ops.CUDA_IMPL) == {OP_OF.get(c, c) for c in CASES}


# hand counts at op_args(name, 2), 2 a multiply-add:
#   fps: 10 operations a point a step, 2 clouds x 16 steps x 64 points;
#   knn: 9 a candidate, 2 x 16 queries x 64 points;
#   mini_forward: 2 x 2 x 32 points x (3*16 + 16*32 + 32*64 + 64*24 = 4144)
#     + 2 x 2 x 4 groups x 32 x 64 (the group maxima through fwg) = 530432 + 32768;
#   mini_stats: 2 x 64 points x (3*16 + 16*32) + 64 x 32 x 33 (m2's triangle)
#     = 71680 + 67584;
#   block: 2 x 18 rows x (32*96 + 32*32 + 2*32*128) + 4 x 2 x 9 x 9 x 32
#     = 442368 + 20736; readout: and 8 x 18 x 32 for its LayerNorm
HAND_FLOPS = {"fps_batched": 20480, "knn_gather": 18432, "mini_forward": 563200,
              "mini_stats": 139264, "fused_vit_block": 463104,
              "fused_vit_block_readout": 467712}


# the geometry and loss kernels, by the work PERF.md §6 bounds them by, at
# case_args(name, 2):
#   ball queries: 9 a point looked at, 2 clouds x 16 centres x 64 points;
#   approx_match: 10 a pair and level, 2 x 8 x 12 pairs x 10 levels;
#   chamfer_nn_dists: 9 a pair, 2 x 20 x 13 a direction;
#   fps_single: as fps_batched, 2 x 56 steps x 48 points; knn_single as knn_gather
HAND_FLOPS.update({"ball_query_gather": 18432, "ball_query_gather_v2": 18432,
                   "ball_query_gather_feats": 18432, "approx_match": 19200,
                   "chamfer_nn_dists": 9360, "chamfer_nn_dists_one": 4680,
                   "fps_single": 53760, "knn_single": 18432})


@pytest.mark.parametrize("name", tuple(HAND_FLOPS))
def test_flop_formula_matches_a_hand_count(name):
    args = case_args(name, 2)
    with FlopCounterMode(display=False) as counter:
        op_of(name)(*args)
    assert counter.get_total_flops() == HAND_FLOPS[name]


@pytest.mark.parametrize("B", [2, 5])
@pytest.mark.parametrize("name", [c for c in EXTRA if c not in HAND_FLOPS])
def test_flop_formula_is_flop_counter_mode_of_the_plain_version(name, B):
    """The product kernels: the operator's formula equals the integer
    ``FlopCounterMode`` counts of its plain version at the same shapes (the
    flash forward's with the lse, ``flash_fwd_plain``, takes the lse from
    the output's scores, as the kernel does)."""
    args = case_args(name, B)
    with FlopCounterMode(display=False) as op_count:
        op_of(name)(*args)
    with FlopCounterMode(display=False) as plain_count:
        (kattn.flash_fwd_plain if name == "flash_mha_lse" else PLAIN[name])(*args)
    assert op_count.get_total_flops() == plain_count.get_total_flops() > 0


def _tiny_model():
    args = TaskArgs(num_learnable_prompt_tokens=4, class_name_position="middle", seed=3)
    args.pointbert_config = PointBertConfig(trans_dim=32, depth=2, num_heads=4, group_size=8,
                                            num_group=16, encoder_dims=32, drop_path_rate=0.0)
    args.text_config = TextConfig(width=32, layers=1, heads=2, embed_dim=32)
    return build_model("ULIP_PointBERT", args, device="cpu").model


def _pretrain_grads():
    """One ULIP-pretraining loss's gradients on every point-tower leaf (the
    whole tower trains, so every op's gradient is asked for), in training
    mode (mini_stats runs)."""
    model = _tiny_model()
    mask = trainable_mask(model, task="pretrain")
    params = {k: p for k, p in model.named_parameters() if mask[k] and k != "logit_scale"}
    for k, p in model.named_parameters():
        p.requires_grad_(mask[k])
    pc = torch.from_numpy(np.random.default_rng(4).random((3, 64, 3), dtype=np.float32))
    emb = model.encode_pc(pc, train=True)
    loss = (emb * torch.linspace(-1, 1, emb.shape[-1])).sum() + emb.square().mean()
    grads = torch.autograd.grad(loss, list(params.values()))
    return dict(zip(params, grads))


def test_train_step_gradients_unchanged_through_recompute_grad(monkeypatch):
    """The operators' gradients (recompute_grad over the plain versions)
    against autograd straight through the plain versions."""
    through_ops = _pretrain_grads()
    monkeypatch.setattr(kgroup, "fps_batched", kgroup.fps_plain)
    monkeypatch.setattr(kgroup, "knn_gather", kgroup.knn_gather_plain)
    monkeypatch.setattr(npb, "mini_forward", kmini.mini_forward_plain)
    monkeypatch.setattr(npb, "mini_stats", kmini.mini_stats_plain)
    monkeypatch.setattr(npb, "fused_vit_block", kvit.vit_block_plain)
    monkeypatch.setattr(npb, "fused_vit_block_readout", kvit.vit_block_readout_plain)
    plain = _pretrain_grads()
    assert set(through_ops) == set(plain)
    assert any(k.startswith("point_encoder.encoder.") for k in plain)
    for k, g in plain.items():
        if k == "point_encoder.encoder.conv2a.kernel":
            # its two row blocks (wg, wl) feed both mini_stats and mini_forward:
            # the four contributions add up in another order through the ops
            err = (through_ops[k] - g).abs().max() / g.abs().max()
            assert err <= 1e-6, (k, float(err))
        else:
            assert torch.equal(through_ops[k], g), k


def test_recompute_grad_calls_the_op_directly_without_a_gradient(monkeypatch):
    """Grad mode off, or no argument that requires a gradient: no
    ``autograd.Function`` runs (the eval and export paths)."""
    def refuse(*args):
        raise AssertionError("autograd.Function applied where no gradient is asked for")

    monkeypatch.setattr(_autograd._Recompute, "apply", refuse)
    args = op_args("fused_vit_block", 2)
    want = kvit.vit_block_plain(*args)
    with torch.no_grad():
        assert torch.equal(kvit.fused_vit_block(*args), want)
    assert torch.equal(kvit.fused_vit_block(*args), want)  # grad mode on, no leaf needs one
    x = args[0].clone().requires_grad_(True)
    with pytest.raises(AssertionError, match="autograd.Function applied"):
        kvit.fused_vit_block(x, *args[1:])
