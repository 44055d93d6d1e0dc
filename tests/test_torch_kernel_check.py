"""The port's on-card kernel check (``ppt_torch/tools/kernel_check.py``).

Without a card the tool refuses, naming the card it needs. Its checks
carry the reference tool's names (``ppt_tpu/tools/kernel_check.py``, read
from its source, its loops expanded), with the one rename the port makes:
``knn_gather.*_stacked_n2048`` pins a Pallas gather option the CUDA
kernel lacks and becomes ``knn_gather.*_n2048`` at the same shape. On CPU
tensors, at small shapes, every check runs in order and holds: the
wrappers take their plain versions there, so this exercises the tool's
own code, not the kernels.
"""

import re
from pathlib import Path

import pytest
import torch

from ppt_torch.nn.text import TextConfig
from ppt_torch.tools import kernel_check as kc

REFERENCE = Path(__file__).resolve().parent.parent / "ppt_tpu" / "tools" / "kernel_check.py"


def reference_names():
    """The reference tool's check names, each once (two of them stand in
    both branches of an ``if``), its f-string loops expanded with the
    values its loops take (``:202``, ``:295``)."""
    names = []
    for name in re.findall(r'check\(\s*f?"([^"]+)"', REFERENCE.read_text()):
        if "{n_e}" in name:
            names += [name.format(n_e=n, m_e=m) for n, m in ((64, 32), (1024, 768))]
        elif "{name}" in name:
            names += [name.format(name=v) for v in ("padded", "pad_free")]
        else:
            names.append(name)
    return list(dict.fromkeys(names))


def test_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="kernel_check: no CUDA card"):
        kc.main()


def test_check_names_cover_the_reference_tool():
    ref = reference_names()
    assert len(ref) == 25
    renamed = {n: n.replace("_stacked", "") for n in ref if "_stacked_" in n}
    assert sorted(renamed.values()) == ["knn_gather.idx_n2048", "knn_gather.nbr_n2048"]
    assert sorted(renamed.get(n, n) for n in ref) == sorted(kc.check_names())


def test_every_check_runs_on_cpu_tensors_at_small_shapes(monkeypatch, capsys):
    for name, value in (("B", 2), ("N", 256), ("G", 32), ("K", 8), ("N_LONG", 512),
                        ("N_MID", 300), ("CHAMFER", (2, 100)), ("EMD", ((16, 8), (40, 30))),
                        ("MHA", (2, 33, 2, 32)), ("BLOCK", (2, 33, 64, 2)), ("DEPTH", 2),
                        ("TEXT_BLOCK", (2, 13, 64, 2)),
                        ("TEXT", (5, 12, TextConfig(vocab_size=100, width=64, layers=2,
                                                     heads=2, embed_dim=32)))):
        monkeypatch.setattr(kc, name, value)
    with torch.no_grad():
        assert kc.run_checks(torch.device("cpu")) == 0
    printed = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith('{"kernel"')]
    assert len(printed) == len(kc.check_names()) == 25
