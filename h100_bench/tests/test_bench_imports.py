"""The harness loads no JAX and no JAX package, compared by whole top-level
module name; the references load nothing of the program; the command exits
without a result where it finds no card or no program."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from h100_bench import cell

ROOT = Path(__file__).resolve().parents[2]
ENV = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}


@pytest.mark.parametrize("loaded,bad", [
    (["ppt_torch", "ppt_torch.nn.text", "torch"], []),
    (["ppt_tpu.nn"], ["ppt_tpu"]),
    (["jax", "jaxlib.xla_client", "flax.linen"], ["flax", "jax", "jaxlib"]),
    (["jaxtyping", "flaxen", "ppt_tpu_x"], []),
])
def test_forbidden_modules_by_whole_top_level_name(monkeypatch, loaded, bad):
    modules = {m: object() for m in loaded}
    monkeypatch.setattr(sys, "modules", modules)
    assert cell.forbidden_modules() == bad


def _python(code: str, cwd: Path = ROOT) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=ENV, capture_output=True,
                          text=True, timeout=300)


def test_references_import_nothing_of_the_program():
    code = ("import sys, h100_bench.reference.clip_text, h100_bench.reference.pointbert, "
            "h100_bench.reference.pointnext, h100_bench.reference.optim; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'ppt_torch', 'ppt_tpu', 'jax', 'jaxlib', 'flax'}))")
    out = _python(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_harness_imports_no_jax():
    code = ("import sys, h100_bench.cell, h100_bench.loops.tune, h100_bench.loops.recognize, "
            "h100_bench.program, h100_bench.control, ppt_torch.tasks.cls, "
            "ppt_torch.train.eval; print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'ppt_tpu', 'jax', 'jaxlib', 'flax'}))")
    out = _python(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _run(cwd: Path) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-m", "h100_bench.run", "--workload",
                           "ppt_base.tune", "--seed", "2147483659", "--seconds", "1",
                           "--trace", "0"], cwd=cwd, env=dict(ENV, CUDA_VISIBLE_DEVICES=""),
                          capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for p in bench["paths"]:
        shutil.copytree(ROOT / p, tmp_path / p, ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
