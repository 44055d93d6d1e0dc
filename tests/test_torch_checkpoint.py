"""The port's checkpoints, and carrying a reference run across.

Round trip: ``save_checkpoint`` then ``load_checkpoint`` restores the
trainable partition, the AdamW moments and count, the batch statistics
and the step bit for bit. ``train_state_from_jax``: two steps in the
reference, its ``save_checkpoint`` payload read back with flax's msgpack
and handed over as numpy, then one more step in both packages: loss rel
1e-4, prompt tokens abs 1e-5 (f32, other summation order), as in the
lockstep test.
"""

import json
import os

import numpy as np
import pytest
import torch
from flax import serialization

from ppt_torch.convert import train_state_from_jax
from ppt_torch.train.checkpoint import load_checkpoint, save_checkpoint, state_payload
from test_torch_trainer import (flat, jax_batch, jax_side, make_batches, np_tree, port_name,
                                port_side, torch_batch)

torch.set_num_threads(1)  # one intra-op thread: the xdist workers share the cores


def _fresh_port_state(head_type=0, depth=2, monkeypatch=None):
    _, _, _, variables = jax_side(head_type, depth, monkeypatch)
    return port_side(head_type, depth, variables)


def test_checkpoint_round_trip(tmp_path, monkeypatch):
    state, step, prompts = _fresh_port_state(monkeypatch=monkeypatch)
    for b in make_batches(2):
        state, _ = step(state, torch_batch(b), prompts)
    want = state_payload(state)
    save_checkpoint(str(tmp_path / "run"), state, meta={"epoch": 3, "best_acc": 12.5})
    assert sorted(os.listdir(tmp_path / "run")) == ["checkpoint_best.json", "checkpoint_best.pt"]
    assert json.load(open(tmp_path / "run" / "checkpoint_best.json"))["epoch"] == 3
    assert set(want["trainable"]) == {"prompt_learner.learnable_tokens"}
    assert want["step"] == 2 and want["opt_state"]["count"] == 2

    other, step2, _ = _fresh_port_state(monkeypatch=monkeypatch)
    assert not torch.equal(other.trainable["prompt_learner.learnable_tokens"],
                           want["trainable"]["prompt_learner.learnable_tokens"])
    other = load_checkpoint(str(tmp_path / "run"), other)  # a directory, or the file itself
    got = state_payload(other)
    assert got["step"] == 2 and got["opt_state"]["count"] == 2
    for part in ("trainable", "batch_stats"):
        for k, v in want[part].items():
            assert torch.equal(got[part][k], v), (part, k)
    for slot in ("mu", "nu"):
        for k, v in want["opt_state"][slot].items():
            assert torch.equal(got["opt_state"][slot][k], v), (slot, k)
    # both continue identically
    b = torch_batch(make_batches(1, seed=9)[0])
    _, m1 = step(state, b, prompts)
    _, m2 = step2(other, b, prompts)
    assert float(m1["loss"]) == float(m2["loss"])
    load_checkpoint(str(tmp_path / "run" / "checkpoint_best.pt"), other)


def test_checkpoint_of_another_partition_is_refused(tmp_path, monkeypatch):
    state, _, _ = _fresh_port_state(monkeypatch=monkeypatch)
    save_checkpoint(str(tmp_path), state)
    other, _, _ = _fresh_port_state(head_type=3, depth=12, monkeypatch=monkeypatch)
    with pytest.raises(ValueError, match="do not match"):
        load_checkpoint(str(tmp_path), other)


def test_train_state_from_jax_then_one_more_step(tmp_path, monkeypatch):
    from ppt_tpu.train.checkpoint import save_checkpoint as jax_save

    jstate, jstep, jprompts, variables = jax_side(0, 2, monkeypatch)
    state, step, prompts = port_side(0, 2, variables)
    batches = make_batches(3)
    for b in batches[:2]:
        jstate, _ = jstep(jstate, jax_batch(b), jprompts)
    jax_save(str(tmp_path), jstate)
    with open(tmp_path / "checkpoint_best.msgpack", "rb") as f:
        payload = serialization.msgpack_restore(f.read())
    assert set(payload) == {"trainable", "opt_state", "batch_stats", "step"}

    state = train_state_from_jax(payload, state)
    assert state.step == 2 and state.optimizer.count == 2
    tokens = np.asarray(payload["trainable"]["prompt_learner"]["learnable_tokens"])
    np.testing.assert_array_equal(
        state.trainable["prompt_learner.learnable_tokens"].detach().numpy(), tokens)
    stats = dict(state.model.named_buffers())
    for path, want in flat(payload["batch_stats"]).items():
        np.testing.assert_array_equal(stats[port_name(path)].numpy(), want)

    jstate, jm = jstep(jstate, jax_batch(batches[2]), jprompts)
    state, m = step(state, torch_batch(batches[2]), prompts)
    want = float(jm["loss"])
    assert abs(float(m["loss"]) - want) <= 1e-4 * abs(want)
    got = state.trainable["prompt_learner.learnable_tokens"].detach().numpy()
    want_tokens = np.asarray(np_tree(jstate.trainable)["prompt_learner"]["learnable_tokens"])
    assert np.max(np.abs(got - want_tokens)) <= 1e-5


def test_train_state_from_jax_needs_an_adam_state(monkeypatch):
    state, _, _ = _fresh_port_state(monkeypatch=monkeypatch)
    with pytest.raises(ValueError, match="no adam state"):
        train_state_from_jax({"trainable": {}, "opt_state": {"0": {}}, "batch_stats": {},
                              "step": 0}, state)
