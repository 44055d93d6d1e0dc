"""``python -m ppt_torch.tools.flops_audit`` against its committed file and
the JAX package's.

The committed ``ppt_torch/assets/flops.json`` must equal a fresh audit (the
counts are integers over meta tensors, so they repeat exactly), and each of
the four FLOPs a cloud must lie within 5% of ``ppt_tpu/assets/flops.json``,
which XLA's cost analysis of the same workloads wrote: the port counts the
products alone (``FlopCounterMode``) and the operators by their formulas,
XLA every elementwise operation too; the prompt-tuning steps also count the
port's statistics sweep (``mini_stats``), which recomputes the MiniPointNet's
first two layers. ``PERF.md`` §6 gives each ratio's sign.
"""

import json
from pathlib import Path

import pytest
import torch

from ppt_torch.kernels import _build
from ppt_torch.tools import flops_audit as fa

torch.set_num_threads(1)  # one intra-op thread: the xdist workers share the cores

REPO = Path(__file__).resolve().parent.parent
JAX_FLOPS = REPO / "ppt_tpu" / "assets" / "flops.json"


@pytest.fixture(scope="module")
def fresh(tmp_path_factory):
    out = tmp_path_factory.mktemp("audit") / "flops.json"

    def refuse(name):
        raise AssertionError(f"the audit reached _build.load({name!r})")

    load, _build.load = _build.load, refuse
    try:
        fa.main(["--out", str(out)])
    finally:
        _build.load = load
    return json.loads(out.read_text())


def test_the_committed_file_is_a_fresh_audit(fresh):
    assert json.loads(fa.OUT.read_text()) == fresh
    assert set(fresh) == {"_provenance", *fa.WORKLOADS}


@pytest.mark.parametrize("name", list(fa.WORKLOADS))
def test_each_count_lies_within_5_percent_of_the_jax_audit(fresh, name):
    want = json.loads(JAX_FLOPS.read_text())[name]
    ratio = fresh[name] / want
    print(f"{name}: port {fresh[name] / 1e9:.3f} GFLOP/cloud, JAX {want / 1e9:.3f}, "
          f"ratio {ratio:.4f}")
    assert abs(ratio - 1.0) <= 0.05, (name, ratio)


def test_the_audit_reads_nothing_of_the_jax_package():
    source = Path(fa.__file__).read_text()
    assert "ppt_tpu" not in source.replace("ppt_tpu/assets/flops.json", "")
    assert "import jax" not in source
