"""The card's program traced on meta tensors at full width, with no card.

A meta tensor takes the route a CUDA tensor takes through every wrapper,
and each kernel entry point, a ``torch.ops.ppt`` operator, runs its fake
(``kernels/_ops.py``). So each path below is traced whole on the CPU, its
operators counted (``_ops.OpCounter``) and held to the launches that
``chip_smoke.py`` reads on the card (``PERF.md`` §6), with ``_build.load``
made to raise: no trace builds or loads a kernel.
"""

import collections

import numpy as np
import pytest
import torch

from ppt_torch.kernels import _build
from ppt_torch.kernels._ops import OpCounter
from ppt_torch.models.ulip import trainable_mask
from ppt_torch.nn.dvae import DiscreteVAE, DvaeConfig
from ppt_torch.tasks.args import TaskArgs
from ppt_torch.tasks.dvae_pretrain import make_dvae_step
from ppt_torch.tasks.pretrain import build_caption_bank, make_pretrain_step
from ppt_torch.tools import flops_audit as fa
from ppt_torch.train.optim import build_optimizer
from ppt_torch.train.trainer import create_train_state

torch.set_num_threads(1)  # one intra-op thread: the xdist workers share the cores

META = torch.device("meta")
POINTBERT_EVAL = {"fps_batched": 1, "knn_gather": 1, "mini_forward": 1, "fused_vit_block": 11,
                  "fused_vit_block_readout": 1}


@pytest.fixture(autouse=True)
def no_build(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a meta trace reached _build.load({name!r})")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "LAUNCHES", collections.Counter())
    yield
    assert not _build.LAUNCHES  # nothing launched, nothing counted as launched


def counted(run):
    with OpCounter() as ops:
        run()
    return dict(ops.counts)


def test_ppt_base_eval_forward():
    model, prompts = fa.ppt_base(META)
    assert counted(fa.forward(model, prompts, 32, 1024, META)) == POINTBERT_EVAL


def test_prompt_tuning_step_adds_the_statistics_sweep():
    model, prompts = fa.ppt_base(META)
    got = counted(fa.train_step(model, prompts, 32, 1024, META))
    assert got == {**POINTBERT_EVAL, "mini_stats": 1}


@pytest.mark.parametrize("route,want", [("tower", {"fused_vit_tower": 1}),
                                        ("unfused", {"fused_mha": 12})])
def test_trunk_routes(route, want):
    model, prompts = fa.ppt_base(META, point_route=route)
    grouping = {k: 1 for k in ("fps_batched", "knn_gather", "mini_forward")}
    assert counted(fa.forward(model, prompts, 32, 1024, META)) == {**grouping, **want}


def test_long_trunk_forward_runs_flash_mha():
    model, prompts = fa.ppt_base(META, num_group=1024)
    got = counted(fa.forward(model, prompts, 32, 8192, META))
    assert got == {"fps_batched": 1, "knn_gather": 1, "mini_forward": 1, "flash_mha": 12}


def test_long_trunk_pretraining_step_adds_the_flash_backward():
    """ULIP pretraining on the long trunk: the point tower trains, so each
    of the 12 blocks runs the flash forward with its lse and the backward
    kernels."""
    model, _ = fa.ppt_base(META, num_group=1024)
    state = create_train_state(model, trainable_mask(model, task="pretrain"),
                               lambda tr: build_optimizer("adamw", tr.items(), lambda s: 3e-3),
                               seed=1)
    step = make_pretrain_step(model, state.optimizer)
    names = TaskArgs(dataset_name="modelnet40").load_classnames()
    tokens = torch.from_numpy(build_caption_bank(names)[np.arange(32) % 40, 0]).to(META)
    got = counted(lambda: step(state, {"pc": fa.clouds(32, 8192, 3, META)}, tokens))
    assert got == {"fps_batched": 1, "knn_gather": 1, "mini_stats": 1, "mini_forward": 1,
                   "flash_mha": 12, "flash_mha_bwd": 12}


def test_text_block_route_encodes_on_twelve_blocks():
    model, prompts = fa.ppt_base(META, text_route="block")
    assert counted(lambda: model.encode_text(prompts)) == {"fused_text_block": 12}


def test_text_tower_route():
    """One tower launch an encode; a prompt-tuning step (the prompt needs
    ``d_x0``) runs the residual-saving forward and the backward kernel."""
    model, prompts = fa.ppt_base(META, text_route="tower")
    with torch.no_grad():
        assert counted(lambda: model.encode_text(prompts)) == {"fused_text_tower": 1}
    got = counted(fa.train_step(model, prompts, 32, 1024, META))
    assert got == {**POINTBERT_EVAL, "mini_stats": 1, "fused_text_tower_res": 1,
                   "fused_text_tower_bwd": 1}


def test_pointnext_s_forward():
    got = counted(fa.anchor(128, 1024, META))
    assert got == {"fps_batched": 4, "ball_query_gather_feats": 4}


def test_dvae_emd_step_runs_the_auction_twice():
    model = DiscreteVAE(DvaeConfig(), dtype=torch.bfloat16).to(META)
    state = create_train_state(model, {k: True for k, _ in model.named_parameters()},
                               lambda tr: build_optimizer("adamw", tr.items(), lambda s: 1e-4),
                               seed=1)
    step = make_dvae_step(model, state.optimizer, recon="emd")
    got = counted(lambda: step(state, {"pc": fa.clouds(64, 1024, 3, META)}, 1.0))
    assert got == {"fps_batched": 1, "knn_gather": 1, "mini_stats": 1, "mini_forward": 1,
                   "approx_match": 2}  # the encoder's grouping and MiniPointNet, then the EMD
