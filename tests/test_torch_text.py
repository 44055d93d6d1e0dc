"""Port vs reference: tokenizer, prompt splice plan and the text tower.

Token ids and ``build_prompt_spec`` arrays must be identical for the 40
ModelNet40 class names, including with the port's ``re`` fallback (the
card's machine has no ``regex``). Text embeddings are held to 1e-5 at a
tiny ``TextConfig`` (f32; the two sides differ in summation order only).
"""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppt_tpu.prompt import ClipTokenizer as JaxTokenizer
from ppt_tpu.prompt import build_prompt_spec as jax_build_prompt_spec
from ppt_torch.prompt import tokenizer as ttok
from ppt_torch.prompt.learner import PromptLearner, build_prompt_spec

torch.set_num_threads(1)  # one intra-op thread: the xdist workers share the cores

LABELS = os.path.join(os.path.dirname(__file__), "..", "ppt_torch", "assets", "labels.json")


def _mn40():
    with open(LABELS) as f:
        return json.load(f)["modelnet40"]


@pytest.fixture(scope="module")
def tokenizers():
    return (JaxTokenizer(), ttok.ClipTokenizer(),
            ttok.ClipTokenizer(pattern=ttok.RE_PATTERN, re_module=re))


def test_tokenizer_ids_identical_for_mn40(tokenizers):
    ref, port, port_re = tokenizers
    names = _mn40()
    assert len(names) == 40
    texts = names + [f"{' '.join(['X'] * 32)} {n}." for n in names] + [
        "a point cloud of a night_stand.", "it's 3 chairs, 2 tables!"]
    want = ref(texts)
    np.testing.assert_array_equal(port(texts), want)
    np.testing.assert_array_equal(port_re(texts), want)
    for t in texts:
        assert port_re.encode(t) == ref.encode(t)


@pytest.mark.parametrize("position", ["end", "middle", "front"])
def test_prompt_spec_identical(tokenizers, position):
    ref, port, port_re = tokenizers
    want = jax_build_prompt_spec(_mn40(), n_ctx=32, class_name_position=position,
                                 tokenizer=ref)
    for tok in (port, port_re):
        got = build_prompt_spec(_mn40(), n_ctx=32, class_name_position=position,
                                tokenizer=tok)
        for field in ("tokens", "perm_tokens", "ctx_mask", "ctx_idx", "eot_pos",
                      "name_lengths"):
            np.testing.assert_array_equal(getattr(got, field), getattr(want, field), field)
        assert got.n_ctx == want.n_ctx


def test_text_tower_and_splice_match_flax(tokenizers):
    from ppt_tpu.nn.text import TextConfig as JaxTextConfig
    from ppt_tpu.nn.text import TextTransformer as JaxText
    from ppt_tpu.prompt import PromptLearner as JaxLearner
    from ppt_torch.convert import from_jax
    from ppt_torch.nn.text import TextConfig, TextTransformer

    kw = dict(width=64, layers=2, heads=4, embed_dim=32)
    spec = jax_build_prompt_spec(_mn40()[:6], n_ctx=8, class_name_position="middle",
                                 tokenizer=tokenizers[0])
    L = 32
    toks, mask, cidx = (spec.perm_tokens[:, :L], spec.ctx_mask[:, :L], spec.ctx_idx[:, :L])

    jtext = JaxText(JaxTextConfig(**kw))
    jlearn = JaxLearner(n_ctx=8, width=64)
    base0 = jnp.zeros((6, L, 64))
    tparams = jax.tree_util.tree_map(
        np.asarray, jtext.init(jax.random.PRNGKey(0), jnp.asarray(toks),
                               jnp.asarray(spec.eot_pos),
                               method=lambda m, t, e: m(m.embed(t), e))["params"])
    lparams = jax.tree_util.tree_map(
        np.asarray, jlearn.init(jax.random.PRNGKey(1), base0, jnp.asarray(mask),
                                jnp.asarray(cidx))["params"])
    base = jtext.apply({"params": tparams}, jnp.asarray(toks), method=jtext.embed)
    spliced = jlearn.apply({"params": lparams}, base, jnp.asarray(mask), jnp.asarray(cidx))
    want = jtext.apply({"params": tparams}, spliced, jnp.asarray(spec.eot_pos))

    text = TextTransformer(TextConfig(**kw))
    text.load_state_dict(from_jax(tparams, {}, text))
    learn = PromptLearner(8, 64)
    learn.load_state_dict(from_jax(lparams, {}, learn))
    with torch.no_grad():
        tbase = text.embed(torch.from_numpy(toks))
        tspliced = learn(tbase, torch.from_numpy(mask), torch.from_numpy(cidx))
        got = text(tspliced, torch.from_numpy(spec.eot_pos))
    np.testing.assert_allclose(tspliced.numpy(), np.asarray(spliced), rtol=0, atol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
