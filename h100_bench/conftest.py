"""Shared fixtures of the benchmark's own tests (``python -m pytest h100_bench``).

Tests of the card carry the ``card`` marker and take the ``card`` fixture,
which skips where no CUDA device is found. The others run the harness on
the CPU over tiny configurations written to a temporary directory beside
the committed files, so that a test adds a configuration, a mix or a
metric without touching one.
"""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (run on the H100)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: run on the H100")
    return torch.device("cuda:0")


TINY_POINTBERT = {"trans_dim": 32, "depth": 2, "drop_path_rate": 0.1, "num_heads": 2,
                  "group_size": 8, "num_group": 16, "encoder_dims": 32}
TINY_POINTNEXT = {"in_channels": 4, "width": 8, "blocks": [1, 1, 1, 1], "strides": [1, 2, 2, 1],
                  "radius": 0.3, "radius_scaling": 1.5, "nsample": 8, "expansion": 4,
                  "sa_layers": 2, "sa_use_res": True, "head_mlps": [32, 16], "head_dropout": 0.5}
TINY_TEXT = {"vocab_size": 49408, "context_length": 77, "width": 32, "layers": 2, "heads": 2,
             "embed_dim": 16}


def tiny_config(name: str) -> dict:
    """The committed configuration ``name`` at tiny widths, f32, 6 classes."""
    with open(ROOT / "h100_bench" / "configs" / f"{name}.json") as f:
        cfg = json.load(f)
    cfg = copy.deepcopy(cfg)
    cfg.update(npoints=64, batch_size=4, compute_dtype="float32", text=dict(TINY_TEXT),
               classnames=cfg["classnames"][:6], prompt={"n_ctx": 4,
                                                         "class_name_position": "middle"})
    cfg["point"] = dict(TINY_POINTBERT if cfg["arch"] == "ulip_pointbert" else TINY_POINTNEXT)
    return cfg


@pytest.fixture
def tiny_root(tmp_path):
    """A checkout-shaped directory: the committed BENCHMARK.json with the
    configurations tiny and the mixes small, the metrics and limits as
    committed."""
    bench_dir = tmp_path / "h100_bench"
    for sub in ("metrics", "limits"):
        shutil.copytree(ROOT / "h100_bench" / sub, bench_dir / sub)
    (bench_dir / "configs").mkdir()
    (bench_dir / "traffic").mkdir()
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    for conf in bench["configs"]:
        with open(tmp_path / conf["file"], "w") as f:
            json.dump(tiny_config(conf["name"]), f)
    small = {"tune": {"clouds": 40, "checked_steps": 3, "warm_steps": 1, "profiled_steps": 2},
             "recognize": {"clouds": 14, "checked_batches": 3}}
    for mix, changes in small.items():
        with open(ROOT / "h100_bench" / "traffic" / f"{mix}.json") as f:
            params = json.load(f)
        params.update(changes)
        with open(bench_dir / "traffic" / f"{mix}.json", "w") as f:
            json.dump(params, f)
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    return tmp_path
