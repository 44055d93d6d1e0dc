"""The recognition path's kernels as registered operators (``torch.ops.ppt``).

On the CPU each operator runs its plain version; a meta or fake tensor takes
its fake implementation. Held here: ``torch.library.opcheck`` on each of the
six; each bit-equal to its plain version; each fake's shapes and dtypes
equal to the real outputs' at two batches; each FLOP formula against a hand
count; gradients through ``recompute_grad`` unchanged; and no
``autograd.Function`` where nothing needs a gradient.
"""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from ppt_torch.kernels import _autograd
from ppt_torch.kernels import group as kgroup
from ppt_torch.kernels import mini as kmini
from ppt_torch.kernels import vitblock as kvit
from ppt_torch.models.ulip import build_model, trainable_mask
from ppt_torch.nn import pointbert as npb
from ppt_torch.nn.pointbert import PointBertConfig
from ppt_torch.nn.text import TextConfig
from ppt_torch.tasks.args import TaskArgs

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


def _outs(x):
    return x if isinstance(x, tuple) else (x,)


def test_the_six_operators_are_registered():
    assert all(hasattr(torch.ops.ppt, name) for name in OPS)
    # the dtype argument is a ScalarType, widths and heads are ints
    assert "ScalarType dtype" in str(torch.ops.ppt.mini_forward.default._schema)
    assert str(torch.ops.ppt.fused_vit_block.default._schema).endswith("int heads) -> Tensor")


@pytest.mark.parametrize("name", OPS)
def test_opcheck(name):
    torch.library.opcheck(getattr(torch.ops.ppt, name).default, op_args(name, 2))


@pytest.mark.parametrize("name", OPS)
def test_op_on_the_cpu_is_its_plain_version_bit_for_bit(name):
    args = op_args(name, 3)
    for got, want in zip(_outs(getattr(torch.ops.ppt, name)(*args)), _outs(PLAIN[name](*args))):
        assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("B", [2, 5])
@pytest.mark.parametrize("name", OPS)
def test_fake_shapes_and_dtypes_are_the_real_ones(name, B):
    args = op_args(name, B)
    real = _outs(getattr(torch.ops.ppt, name)(*args))
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    fake = _outs(getattr(torch.ops.ppt, name)(*meta))
    assert [(tuple(t.shape), t.dtype) for t in fake] == [(tuple(t.shape), t.dtype) for t in real]
    assert all(t.device.type == "meta" for t in fake)


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


@pytest.mark.parametrize("name", OPS)
def test_flop_formula_matches_a_hand_count(name):
    with FlopCounterMode(display=False) as counter:
        getattr(torch.ops.ppt, name)(*op_args(name, 2))
    assert counter.get_total_flops() == HAND_FLOPS[name]


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
