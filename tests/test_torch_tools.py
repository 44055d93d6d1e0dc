"""The port's tools that need no card to be checked, on the CPU.

``tools/visualize.py`` against ``ppt_tpu``'s renderer byte for byte;
``backbone_bench`` taking ``dgcnn`` and refusing a name it does not know;
``profile --flops``' sections adding up to the step's total, and its
routes and group count passed through to the model it counts; and
``component_probe``, ``pointnext_profile``
and ``backbone_bench`` parsing their flags and refusing, by name, to run
without a card.
"""

import numpy as np
import pytest
import torch

from ppt_tpu.tools import visualize as jvis
from ppt_torch.kernels._ops import OpCounter
from ppt_torch.nn.pointbert import PointBertConfig
from ppt_torch.nn.text import TextConfig
from ppt_torch.tools import backbone_bench, component_probe, pointnext_profile
from ppt_torch.tools import profile as tprofile
from ppt_torch.tools import visualize

torch.set_num_threads(1)  # one intra-op thread: the xdist workers share the cores


@pytest.mark.parametrize("n,parts,radius", [(500, 6, 4.0), (2048, 50, 2.5)])
def test_render_partseg_is_the_jax_tools_image(n, parts, radius):
    rng = np.random.RandomState(n)
    pts = rng.randn(n, 3).astype(np.float32)
    labels = rng.randint(0, parts, n)
    got = visualize.render_partseg(pts, labels, radius=radius)
    want = jvis.render_partseg(pts, labels, radius=radius)
    assert got.dtype == np.uint8 and got.shape == (512, 512, 3)
    assert got.tobytes() == want.tobytes()
    assert len(np.unique(got.reshape(-1, 3), axis=0)) > 2  # balls drawn, not a blank frame
    np.testing.assert_array_equal(visualize.part_palette(50), jvis.part_palette(50))


def test_visualize_main_writes_one_image_a_cloud(tmp_path):
    rng = np.random.RandomState(3)
    npz = tmp_path / "parts.npz"
    np.savez(npz, points=rng.randn(3, 256, 3).astype(np.float32),
             labels=rng.randint(0, 4, (3, 256)))
    written = visualize.main(["--npz", str(npz), "--out", str(tmp_path / "viz"), "--limit", "2"])
    assert len(written) == 2 and all((tmp_path / "viz" / p).exists() for p in written)


def test_backbone_bench_refuses_dgcnn_by_name(capsys):
    """DGCNN is ported since this test was written (its name is the test's
    own): ``dgcnn`` parses and builds as the JAX tool builds it (3 channels,
    the FC trunk on), and a name the tool does not know is refused."""
    args = backbone_bench.parse_args(["--model", "dgcnn"])
    assert (args.model, args.batch, args.npoints, args.iters) == ("dgcnn", 128, 1024, 16)
    tower, height = backbone_bench.build("dgcnn", torch.float32)
    assert not height and tower.trunk and tower.edge0.kernel.shape == (6, 64)
    with pytest.raises(SystemExit):
        backbone_bench.parse_args(["--model", "pointtransformer"])
    assert "invalid choice: 'pointtransformer'" in capsys.readouterr().err
    args = backbone_bench.parse_args(["--model", "pointmlp", "--iters", "4"])
    assert (args.model, args.batch, args.npoints, args.iters) == ("pointmlp", 128, 1024, 4)


SHRINK = (PointBertConfig(trans_dim=48, depth=2, num_heads=4, group_size=8, num_group=16,
                          encoder_dims=32, drop_path_rate=0.1),
          TextConfig(width=64, layers=2, heads=4, embed_dim=64), 4)


@pytest.mark.parametrize("train", [False, True])
def test_profile_flops_sections_sum_to_the_total(train):
    out = tprofile.profile_flops(train, batch=4, npoints=128, compute_dtype="float32",
                                 device="cpu", shrink=SHRINK)
    sections = out["sections"]
    assert out["device"] == "cpu" and out["total"]["gflop"] > 0
    # the sections' counts and the whole step's, counted over a step of its own
    assert sum(s["gflop"] for s in sections.values()) == pytest.approx(out["total"]["gflop"],
                                                                       rel=1e-12)
    # off the card no time is measured
    assert all(s["ms"] is None and s["tflops"] is None for s in [*sections.values(),
                                                                 out["total"]])
    if train:
        assert list(sections) == ["augmentation", "point tower (train mode)",
                                  "text tower forward + loss", "backward", "optimizer"]
        assert sections["point tower (train mode)"]["gflop"] > 0
        assert sections["backward"]["gflop"] > 0
    else:
        assert list(sections) == ["recognition batch"]


@pytest.mark.parametrize("train,routes,op", [
    (False, {"point_route": "tower"}, "fused_vit_tower"),
    (False, {"point_route": "unfused"}, "fused_mha"),
    (True, {"text_route": "tower"}, "fused_text_tower_bwd"),
    (False, {"text_route": "block"}, "fused_text_block"),
])
def test_profile_flops_counts_the_routes_it_is_given(train, routes, op):
    """The kernels of the route asked for run, and count by their
    operators' formulas."""
    with OpCounter() as ops:
        out = tprofile.profile_flops(train, batch=4, npoints=128, compute_dtype="float32",
                                     device="cpu", shrink=SHRINK, **routes)
    assert ops.counts[op] > 0 and all(out[k] == v for k, v in routes.items())


def test_profile_flops_flag_passes_routes_and_group_count(monkeypatch):
    seen = {}
    monkeypatch.setattr(tprofile, "profile_flops", lambda *a, **kw: seen.update(kw) or {})
    tprofile.main(["--flops", "--train", "--text_route", "tower", "--point_route", "unfused",
                   "--num_group", "1024", "--npoints", "8192"])
    assert seen == {"text_route": "tower", "point_route": "unfused", "num_group": 1024}


def test_profile_flops_flag_takes_the_cls_step_alone(capsys):
    with pytest.raises(SystemExit):
        tprofile.main(["--flops", "--train", "dvae"])
    assert "--flops covers" in capsys.readouterr().err


@pytest.mark.parametrize("tool,argv,name", [
    (component_probe, ["--components", "grouping,flash_bwd", "--iters", "4"], "component_probe"),
    (pointnext_profile, ["--only", "fps1,bq4,fwd", "--iters", "4"], "pointnext_profile"),
    (backbone_bench, ["--model", "pointnext"], "backbone_bench"),
])
def test_card_tools_parse_their_flags_and_refuse_without_a_card(tool, argv, name, monkeypatch):
    args = tool.parse_args(argv)
    assert args.iters == 4 if "--iters" in argv else args.iters == 16
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match=f"{name}: torch.cuda.is_available\\(\\) is false"):
        tool.main(argv)


def test_probe_flags_refuse_unknown_pieces(capsys):
    assert component_probe.parse_args(["--components", "grouping,vit12_tower"]).components == [
        "grouping", "vit12_tower"]
    assert pointnext_profile.parse_args(["--only", "bq2"]).only == ["bq2"]
    assert len(component_probe.parse_args([]).components) == len(component_probe.COMPONENTS)
    for tool, argv in ((component_probe, ["--components", "knn_quad"]),
                       (pointnext_profile, ["--only", "gather1"])):
        with pytest.raises(SystemExit):
            tool.parse_args(argv)
    err = capsys.readouterr().err
    assert "knn_quad" in err and "gather1" in err
