"""Port vs reference: the prompt-tuning train step, in lockstep.

Four steps of ``ppt_torch.train.trainer.make_train_step`` and of the
reference's ``make_train_step`` from the same weights (through
``convert.from_jax``) on the same batches (numpy seeds), head types 0 and
3, ``drop_path_rate=0`` (DropPath draws from another generator), f32, the
reference's MiniPointNet and block kernels forced on in interpret mode as
on its chip. Tiny config: 64 wide, G=16, M=8, N=128; text tower 2 layers,
64 wide; depth 2 for head type 0 and depth 12 for head type 3, whose
trainable leaves are those of ``block_11``.

Tolerances (f32 on both sides, other summation order): loss rel 1e-4 per
step; trainable leaves abs 1e-5 after four AdamW steps at a peak rate of
3e-3; running statistics abs 1e-5; frozen leaves bit-unchanged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppt_torch.convert import from_jax
from ppt_torch.models.ulip import PromptArrays, build_model, trainable_mask
from ppt_torch.nn.pointbert import PointBertConfig
from ppt_torch.nn.text import TextConfig
from ppt_torch.prompt.learner import build_prompt_spec
from ppt_torch.tasks.args import TaskArgs
from ppt_torch.train.optim import build_optimizer, build_schedule
from ppt_torch.train.trainer import (TrainState, create_train_state, make_eval_step,
                                     make_train_multi_step, make_train_step)

TINY = dict(trans_dim=64, drop_path_rate=0.0, num_heads=2, group_size=8, num_group=16,
            encoder_dims=64)
TEXT = dict(width=64, layers=2, heads=4, embed_dim=64)
CLASSES = ["airplane", "chair", "night stand", "flower pot", "lamp"]
SCHED = dict(final_lr=1e-5, warmup_epochs=1, warmup_start_lr=1e-6)
OPT = dict(weight_decay=0.1, betas=(0.9, 0.98), eps=1e-8)
EPOCHS, STEPS_PER_EPOCH, SMOOTHING = 3, 2, 0.2


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def make_batches(n, seed=0, batch=4, npoints=128):
    rng = np.random.RandomState(seed)
    return [{"pc": rng.rand(batch, npoints, 3).astype(np.float32),
             "label": rng.randint(0, len(CLASSES), batch).astype(np.int32)} for _ in range(n)]


def jax_side(head_type, depth, monkeypatch, text=None):
    """(state, step_fn, prompts) of the reference at the tiny config."""
    text = text or TEXT
    from ppt_tpu.models import PromptArrays as JaxPrompts
    from ppt_tpu.models import Ulip as JaxUlip
    from ppt_tpu.models import trainable_mask as jax_mask
    from ppt_tpu.nn import PointBert as JaxPointBert
    from ppt_tpu.nn import PointBertConfig as JaxBertConfig
    from ppt_tpu.nn import TextConfig as JaxTextConfig
    from ppt_tpu.prompt import build_prompt_spec as jax_spec
    from ppt_tpu.train.optim import build_optimizer as jax_optimizer
    from ppt_tpu.train.optim import build_schedule as jax_schedule
    from ppt_tpu.train.trainer import create_train_state as jax_create
    from ppt_tpu.train.trainer import make_train_step as jax_make_step

    monkeypatch.setenv("PPT_FORCE_FUSED_MINI", "1")
    monkeypatch.setenv("PPT_FUSED_BLOCK", "1")
    model = JaxUlip(point_encoder=JaxPointBert(JaxBertConfig(depth=depth, **TINY)),
                    pc_feat_dims=128, n_ctx=4, text_config=JaxTextConfig(**text))
    prompts = JaxPrompts.from_spec(jax_spec(CLASSES, n_ctx=4, class_name_position="middle"))
    # numpy copies: the reference's step donates its state's buffers
    variables = np_tree(model.init(jax.random.PRNGKey(0), jnp.zeros((1, 128, 3)) + 0.5, prompts))
    mask = jax_mask(variables["params"], head_type=head_type)
    opt = jax_optimizer("adamw", jax_schedule("cosine", 3e-3, EPOCHS, STEPS_PER_EPOCH, **SCHED),
                        **OPT)
    state = jax_create(jax.tree_util.tree_map(jnp.asarray, variables), mask, opt,
                       jax.random.PRNGKey(1))
    return state, jax_make_step(model, opt, smoothing=SMOOTHING), prompts, variables


def port_side(head_type, depth, variables, text=None, text_fused="off"):
    """(state, step_fn, prompts) of the port with the reference's weights."""
    args = TaskArgs(num_learnable_prompt_tokens=4, class_name_position="middle")
    args.pointbert_config = PointBertConfig(depth=depth, **TINY)
    args.text_config = TextConfig(**(text or TEXT))
    model = build_model("ULIP_PointBERT", args, device="cpu", text_fused=text_fused).model
    model.load_state_dict(from_jax(np_tree(variables["params"]),
                                   np_tree(variables["batch_stats"]), model))
    sched = build_schedule("cosine", 3e-3, EPOCHS, STEPS_PER_EPOCH, **SCHED)
    state = create_train_state(
        model, trainable_mask(model, head_type=head_type),
        lambda tr: build_optimizer("adamw", tr.items(), sched, **OPT), seed=1)
    prompts = PromptArrays.from_spec(
        build_prompt_spec(CLASSES, n_ctx=4, class_name_position="middle"), device="cpu")
    return state, make_train_step(smoothing=SMOOTHING), prompts


def torch_batch(b):
    return {"pc": torch.from_numpy(b["pc"]), "label": torch.from_numpy(b["label"]).long()}


def jax_batch(b):
    return {"pc": jnp.asarray(b["pc"]), "label": jnp.asarray(b["label"])}


def flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def port_name(path):
    *mods, leaf = path
    return ".".join(list(mods) + [{"scale": "weight", "mean": "running_mean",
                                   "var": "running_var"}.get(leaf, leaf)])


@pytest.mark.parametrize("head_type,depth", [(0, 2), (3, 12)])
def test_train_step_lockstep_with_reference(head_type, depth, monkeypatch):
    jstate, jstep, jprompts, variables = jax_side(head_type, depth, monkeypatch)
    state, step, prompts = port_side(head_type, depth, variables)
    want_trainable = {port_name(k) for k in flat(np_tree(jstate.trainable))}
    assert set(state.trainable) == want_trainable
    assert ("point_encoder.block_11.attn.qkv.kernel" in state.trainable) == (head_type == 3)
    frozen0 = {k: v.detach().clone() for k, v in state.model.named_parameters()
               if k not in state.trainable}
    assert not frozen0["text.token_embedding.weight"].requires_grad

    for i, b in enumerate(make_batches(4)):
        jstate, jm = jstep(jstate, jax_batch(b), jprompts)
        state, m = step(state, torch_batch(b), prompts)
        want = float(jm["loss"])
        assert abs(float(m["loss"]) - want) <= 1e-4 * abs(want), (i, float(m["loss"]), want)
        assert abs(float(m["acc"]) - float(jm["acc"])) <= 1e-4
    assert state.step == 4 == int(jstate.step) and state.optimizer.count == 4

    for path, want in flat(np_tree(jstate.trainable)).items():
        got = state.trainable[port_name(path)].detach().numpy()
        assert np.max(np.abs(got - want)) <= 1e-5, (path, np.max(np.abs(got - want)))
    tokens0 = np.asarray(variables["params"]["prompt_learner"]["learnable_tokens"])
    moved = state.trainable["prompt_learner.learnable_tokens"].detach().numpy() - tokens0
    assert np.max(np.abs(moved)) > 1e-4  # the prompt was tuned
    stats = dict(state.model.named_buffers())
    for path, want in flat(np_tree(jstate.batch_stats)).items():
        got = stats[port_name(path)].numpy()
        assert np.max(np.abs(got - want)) <= 1e-5, (path, np.max(np.abs(got - want)))
    for k, v in state.model.named_parameters():
        if k in frozen0:
            assert torch.equal(v, frozen0[k]), k
            assert v.grad is None


def test_train_step_lockstep_through_fused_text_tower(monkeypatch):
    """Three head-type-0 steps with the text tower on its fused route on
    both sides: the reference under ``PPT_FUSED_TEXT_TOWER=1`` (its forward
    and hand-written backward kernels interpreted), the port with
    ``text_fused="tower"`` (the plain versions of its kernels on the CPU).
    128 wide, the least the reference's route engages at."""
    text = dict(width=128, layers=2, heads=4, embed_dim=128)
    monkeypatch.setenv("PPT_FUSED_TEXT_TOWER", "1")
    jstate, jstep, jprompts, variables = jax_side(0, 2, monkeypatch, text=text)
    state, step, prompts = port_side(0, 2, variables, text=text, text_fused="tower")
    assert state.model.text.fused == "tower"
    assert sorted(state.trainable) == ["prompt_learner.learnable_tokens"]
    frozen0 = {k: v.detach().clone() for k, v in state.model.named_parameters()
               if k not in state.trainable}

    for i, b in enumerate(make_batches(3)):
        jstate, jm = jstep(jstate, jax_batch(b), jprompts)
        state, m = step(state, torch_batch(b), prompts)
        want = float(jm["loss"])
        assert abs(float(m["loss"]) - want) <= 1e-4 * abs(want), (i, float(m["loss"]), want)

    want = np.asarray(jstate.trainable["prompt_learner"]["learnable_tokens"])
    got = state.trainable["prompt_learner.learnable_tokens"].detach().numpy()
    assert np.max(np.abs(got - want)) <= 1e-5
    tokens0 = np.asarray(variables["params"]["prompt_learner"]["learnable_tokens"])
    assert np.max(np.abs(got - tokens0)) > 1e-4  # the prompt was tuned through d_x0
    for k, v in state.model.named_parameters():
        if k in frozen0:
            assert torch.equal(v, frozen0[k]), k
            assert v.grad is None


def test_logit_scale_is_clamped_only_when_trainable():
    args = TaskArgs(num_learnable_prompt_tokens=4, class_name_position="middle")
    args.pointbert_config = PointBertConfig(depth=2, **TINY)
    args.text_config = TextConfig(**TEXT)
    prompts = PromptArrays.from_spec(
        build_prompt_spec(CLASSES, n_ctx=4, class_name_position="middle"), device="cpu")
    b = torch_batch(make_batches(1)[0])
    for task, want in (("cls", 9.0), ("pretrain", 4.6052)):
        model = build_model("ULIP_PointBERT", args, device="cpu").model
        with torch.no_grad():
            model.logit_scale.fill_(9.0)
        mask = trainable_mask(model, head_type=0, task=task)
        assert mask["logit_scale"] == (task == "pretrain")
        assert mask["pc_projection"] == (task == "pretrain")
        assert mask["text.token_embedding.weight"] is False
        state = create_train_state(
            model, mask, lambda tr: build_optimizer("adamw", tr.items(), lambda s: 0.0), seed=0)
        make_train_step()(state, b, prompts)
        assert abs(float(model.logit_scale) - want) < 1e-6


def test_trainable_mask_head_types_and_partseg():
    args = TaskArgs(num_learnable_prompt_tokens=4)
    args.pointbert_config = PointBertConfig(depth=12, **TINY)
    args.text_config = TextConfig(**TEXT)
    model = build_model("ULIP_PointBERT", args, device="cpu").model
    counts = [sum(trainable_mask(model, head_type=h).values()) for h in range(4)]
    # prompt; + norm2 (2) + fc2 (2); + norm1 (2) + fc1 (2); + qkv (1) + proj (2)
    assert counts == [1, 5, 9, 12]
    # ported since this case was a refusal: a cls tower has none of the
    # segmentation heads, so the partseg partition is the prompt tuning one,
    # as the reference's mask gives (tests/test_torch_partseg.py holds the
    # partseg model's mask against it leaf for leaf)
    for h in range(4):
        assert trainable_mask(model, head_type=h, task="partseg") == trainable_mask(
            model, head_type=h)
    # ported since this case was a refusal: two steps in one multi-step
    # call leave the state where two single steps leave it, bit for bit
    # (the reference's lax.scan of its single step, trainer.py:216-251)
    args.pointbert_config = PointBertConfig(depth=2, **dict(TINY, drop_path_rate=0.1))
    prompts = PromptArrays.from_spec(
        build_prompt_spec(CLASSES, n_ctx=4, class_name_position="middle"), device="cpu")
    batches = [torch_batch(b) for b in make_batches(2)]
    states, losses = [], []
    for multi in (False, True):
        torch.manual_seed(0)
        model = build_model("ULIP_PointBERT", args, device="cpu").model
        state = create_train_state(
            model, trainable_mask(model, head_type=3),
            lambda tr: build_optimizer("adamw", tr.items(), lambda s: 1e-3), seed=4)
        if multi:
            stacked = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
            state, m = make_train_multi_step(SMOOTHING)(state, stacked, prompts)
            assert m["loss"].shape == (2,) and m["acc"].shape == (2,)
            losses.append(m["loss"].tolist())
        else:
            step = make_train_step(SMOOTHING)
            ms = [step(state, b, prompts)[1] for b in batches]
            losses.append([float(x["loss"]) for x in ms])
        states.append(state)
    assert losses[0] == losses[1] and states[0].step == states[1].step == 2
    for k, v in states[0].trainable.items():
        assert torch.equal(v, states[1].trainable[k]), k


def test_eval_step_uses_running_statistics_and_moves_nothing():
    args = TaskArgs(num_learnable_prompt_tokens=4, class_name_position="middle")
    args.pointbert_config = PointBertConfig(depth=2, **TINY)
    args.text_config = TextConfig(**TEXT)
    model = build_model("ULIP_PointBERT", args, device="cpu").model
    prompts = PromptArrays.from_spec(
        build_prompt_spec(CLASSES, n_ctx=4, class_name_position="middle"), device="cpu")
    state = create_train_state(
        model, trainable_mask(model),
        lambda tr: build_optimizer("adamw", tr.items(), lambda s: 1e-3), seed=0)
    assert isinstance(state, TrainState) and sorted(state.batch_stats()) == [
        f"point_encoder.encoder.{bn}.running_{s}" for bn in ("bn1", "bn2")
        for s in ("mean", "var")]
    before = {k: v.clone() for k, v in state.batch_stats().items()}
    b = torch_batch(make_batches(1)[0])
    logits = make_eval_step()(state, b, prompts)
    assert tuple(logits.shape) == (4, len(CLASSES)) and not logits.requires_grad
    assert all(torch.equal(v, before[k]) for k, v in state.batch_stats().items())
    assert torch.equal(logits, model(b["pc"], prompts))
