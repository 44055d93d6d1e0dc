"""Port vs reference: the recognition inference slice end to end.

``Ulip`` eval logits with weights from ``ppt_torch.convert.from_jax``
against the JAX package's ``make_cached_text_eval`` (MiniPointNet and ViT
block kernels forced on, as on the reference's chip) at a tiny config:
PointBERT depth 2, 64 wide, G=16, M=8, N=128; text tower 2 layers, 64
wide. Tolerance 1e-4 relative to the logits' scale in f32: each side
differs from the other in f32 summation order only, compounded over
about twenty layers. Also: the ``--evaluate_3d`` driver on the CPU, the
converter's leaf checks, the no-JAX import rule and the device rule.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import struct

from ppt_torch.convert import from_jax
from ppt_torch.models.ulip import PromptArrays, build_model
from ppt_torch.nn.pointbert import PointBertConfig
from ppt_torch.nn.text import TextConfig
from ppt_torch.prompt.learner import build_prompt_spec
from ppt_torch.tasks.args import TaskArgs
from ppt_torch.train.eval import make_cached_text_eval

torch.set_num_threads(1)  # one intra-op thread: the xdist workers share the cores

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(trans_dim=64, depth=2, drop_path_rate=0.0, num_heads=2, group_size=8,
            num_group=16, encoder_dims=64)
TEXT = dict(width=64, layers=2, heads=4, embed_dim=64)
CLASSES = ["airplane", "chair", "night stand", "flower pot", "lamp"]


@struct.dataclass
class _State:
    trainable: dict
    frozen: dict
    batch_stats: dict


def _tiny_args(**kw):
    args = TaskArgs(num_learnable_prompt_tokens=4, class_name_position="middle", **kw)
    args.pointbert_config = PointBertConfig(**TINY)
    args.text_config = TextConfig(**TEXT)
    return args


def _jax_reference(pc, rng):
    from ppt_tpu.models import PromptArrays as JaxPrompts
    from ppt_tpu.models import Ulip as JaxUlip
    from ppt_tpu.nn import PointBert as JaxPointBert
    from ppt_tpu.nn import PointBertConfig as JaxBertConfig
    from ppt_tpu.nn import TextConfig as JaxTextConfig
    from ppt_tpu.prompt import build_prompt_spec as jax_spec
    from ppt_tpu.train.trainer import make_cached_text_eval as jax_cached_eval

    model = JaxUlip(point_encoder=JaxPointBert(JaxBertConfig(**TINY)), pc_feat_dims=128,
                    n_ctx=4, text_config=JaxTextConfig(**TEXT))
    prompts = JaxPrompts.from_spec(jax_spec(CLASSES, n_ctx=4, class_name_position="middle"))
    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(pc[:1]), prompts)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
    enc_p, enc_s = params["point_encoder"]["encoder"], stats["point_encoder"]["encoder"]
    for bn in ("bn1", "bn2"):  # non-trivial BN state so the fold is exercised
        n = enc_p[bn]["scale"].shape[0]
        enc_p[bn] = {"scale": (1 + 0.1 * rng.randn(n)).astype(np.float32),
                     "bias": (0.1 * rng.randn(n)).astype(np.float32)}
        enc_s[bn] = {"mean": (0.1 * rng.randn(n)).astype(np.float32),
                     "var": (0.5 + rng.rand(n)).astype(np.float32)}
    embed_fn, step_fn = jax_cached_eval(model)
    state = _State(trainable=params, frozen={}, batch_stats=stats)
    text_embed = embed_fn(state, prompts)
    logits = step_fn(state, {"pc": jnp.asarray(pc)}, text_embed)
    return params, stats, np.asarray(text_embed), np.asarray(logits)


def test_ulip_eval_logits_match_jax(monkeypatch):
    monkeypatch.setenv("PPT_FORCE_FUSED_MINI", "1")
    monkeypatch.setenv("PPT_FUSED_BLOCK", "1")
    rng = np.random.RandomState(0)
    pc = rng.rand(3, 128, 3).astype(np.float32)
    params, stats, want_text, want_logits = _jax_reference(pc, rng)

    model = build_model("ULIP_PointBERT", _tiny_args(), device="cpu").model
    model.load_state_dict(from_jax(params, stats, model))
    prompts = PromptArrays.from_spec(
        build_prompt_spec(CLASSES, n_ctx=4, class_name_position="middle"), device="cpu")
    embed_fn, step_fn = make_cached_text_eval(model)
    text_embed = embed_fn(model, prompts)
    logits = step_fn(model, {"pc": torch.from_numpy(pc)}, text_embed)
    np.testing.assert_allclose(text_embed.numpy(), want_text, rtol=1e-5, atol=1e-5)
    scale = float(np.max(np.abs(want_logits)))
    assert np.max(np.abs(logits.numpy() - want_logits)) <= 1e-4 * scale
    np.testing.assert_array_equal(logits.argmax(-1).numpy(), want_logits.argmax(-1))


@pytest.mark.parametrize("name,channels,npoints", [
    ("ULIP_PN_NEXT", 4, 64), ("ULIP_PN_SSG", 3, 560), ("ULIP_PN_MSG", 3, 560)])
def test_ulip_eval_logits_match_jax_for_the_ball_query_towers(name, channels, npoints):
    """The three new factories at their full widths (PointNeXt-S on 64
    points with the height channel; PointNet++ needs 512 centres), tiny
    text tower, weights through ``from_jax``, clouds on a 1/64 lattice so
    that both packages pick the same neighbours
    (``test_torch_pointnet2.py``). f32: logits within 1e-4 of their scale,
    as for PointBERT above."""
    from ppt_tpu.models import PromptArrays as JaxPrompts
    from ppt_tpu.models import build_model as jax_build
    from ppt_tpu.nn import TextConfig as JaxTextConfig
    from ppt_tpu.prompt import build_prompt_spec as jax_spec
    from ppt_tpu.train.trainer import make_cached_text_eval as jax_cached_eval

    from test_torch_pointnet2 import lattice_cloud, randomise_bn

    rng = np.random.RandomState(1)
    pc = lattice_cloud(2, npoints, 2, channels=channels)
    jargs = TaskArgs(num_learnable_prompt_tokens=4)
    jargs.text_config = JaxTextConfig(**TEXT)
    jmodel = jax_build(name, jargs).model
    jprompts = JaxPrompts.from_spec(jax_spec(CLASSES, n_ctx=4, class_name_position="middle"))
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(pc[:1]), jprompts)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
    randomise_bn(params["point_encoder"], stats["point_encoder"], rng)
    embed_fn, step_fn = jax_cached_eval(jmodel)
    state = _State(trainable=params, frozen={}, batch_stats=stats)
    want = np.asarray(step_fn(state, {"pc": jnp.asarray(pc)}, embed_fn(state, jprompts)))

    args = TaskArgs(num_learnable_prompt_tokens=4, class_name_position="middle",
                    use_height=channels == 4)
    args.text_config = TextConfig(**TEXT)
    spec = build_model(name, args, device="cpu")
    assert spec.pc_feat_dims == 256 and spec.name == name
    model = spec.model
    model.load_state_dict(from_jax(params, stats, model))
    prompts = PromptArrays.from_spec(
        build_prompt_spec(CLASSES, n_ctx=4, class_name_position="middle"), device="cpu")
    embed_fn, step_fn = make_cached_text_eval(model)
    logits = step_fn(model, {"pc": torch.from_numpy(pc)}, embed_fn(model, prompts))
    scale = float(np.max(np.abs(want)))
    assert np.max(np.abs(logits.numpy() - want)) <= 1e-4 * scale
    np.testing.assert_array_equal(logits.argmax(-1).numpy(), want.argmax(-1))


def test_cls_main_evaluate_3d_on_cpu():
    from ppt_torch.tasks import cls

    args = _tiny_args(dataset_name="synthetic", npoints=128, batch_size=8, evaluate_3d=True,
                      device="cpu")
    args.num_classes = 4
    args.samples_per_class = 3  # 12 clouds: one full batch and one padded
    result = cls.main(args)
    assert 0.0 <= result["best_acc"] <= 100.0 and result["best_epoch"] == -1


def test_cls_main_parses_flags_and_requires_evaluate_3d(monkeypatch):
    """``--evaluate_3d`` selects evaluation; without it ``main`` trains."""
    from ppt_torch.tasks import cls
    from ppt_torch.tasks.args import parse_args

    args = parse_args(["--evaluate_3d", "--device", "cpu", "--npoints", "256",
                       "--compute_dtype", "bfloat16"])
    assert args.evaluate_3d and args.device == "cpu" and args.npoints == 256
    assert args.compute_dtype == "bfloat16"
    took = []
    monkeypatch.setattr(cls, "setup", lambda a: {"model": None, "test_ds": None,
                                                 "prompts": None, "device": None})
    monkeypatch.setattr(cls, "train_loop", lambda a, ctx: took.append("train") or {})
    monkeypatch.setattr(cls, "validate", lambda *a: took.append("eval") or {"acc1": 0.0})
    cls.main(["--device", "cpu"])
    cls.main(["--device", "cpu", "--evaluate_3d"])
    assert took == ["train", "eval"]


def test_from_jax_raises_on_missing_and_extra_leaves():
    from ppt_torch.nn.pointbert import MiniPointNet

    mini = MiniPointNet(64)
    params = {
        "conv1a": {"kernel": np.zeros((3, 128), np.float32), "bias": np.zeros(128, np.float32)},
        "conv1b": {"kernel": np.zeros((128, 256), np.float32), "bias": np.zeros(256, np.float32)},
        "conv2a": {"kernel": np.zeros((512, 512), np.float32), "bias": np.zeros(512, np.float32)},
        "conv2b": {"kernel": np.zeros((512, 64), np.float32), "bias": np.zeros(64, np.float32)},
        "bn1": {"scale": np.ones(128, np.float32), "bias": np.zeros(128, np.float32)},
        "bn2": {"scale": np.ones(512, np.float32), "bias": np.zeros(512, np.float32)},
    }
    stats = {"bn1": {"mean": np.zeros(128, np.float32), "var": np.ones(128, np.float32)},
             "bn2": {"mean": np.zeros(512, np.float32), "var": np.ones(512, np.float32)}}
    sd = from_jax(params, stats, mini)
    assert torch.equal(sd["conv1a.kernel"], torch.zeros(3, 128))
    with pytest.raises(ValueError, match="left unset"):
        from_jax(params, {"bn1": stats["bn1"]}, mini)
    extra = dict(params, conv3={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="left over"):
        from_jax(extra, stats, mini)
    bad = dict(params, conv1a={"kernel": np.zeros((3, 64), np.float32),
                               "bias": np.zeros(128, np.float32)})
    with pytest.raises(ValueError, match="shape"):
        from_jax(bad, stats, mini)


def test_port_imports_no_jax():
    """Every ppt_torch module imports without pulling in JAX, ppt_tpu or
    msgpack (the card's machine has none of them)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import ppt_torch\n"
        "for m in pkgutil.walk_packages(ppt_torch.__path__, 'ppt_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'flax',"
        " 'chex', 'ppt_tpu', 'msgpack'))\n"
        "n = sum(1 for k in sys.modules if k.startswith('ppt_torch.'))\n"
        "print(n, bad)\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr + out.stdout
    assert int(out.stdout.split()[0]) >= 20


def test_default_device_raises_without_cuda(monkeypatch):
    from ppt_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    for name in ("ULIP_PointBERT", "ULIP_PN_NEXT", "ULIP_PN_SSG", "ULIP_PN_MSG", "ULIP_PN_MLP"):
        with pytest.raises(RuntimeError):
            build_model(name, _tiny_args())
    with pytest.raises(RuntimeError):
        PromptArrays.from_spec(build_prompt_spec(CLASSES, n_ctx=4))
    assert resolve_device("cpu") == torch.device("cpu")
