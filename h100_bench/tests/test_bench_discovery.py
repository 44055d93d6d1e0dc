"""Cells, mixes, metrics and limits are found by name from files of their
own: a dummy configuration, mix and metric are added as new files beside
copies of the committed ones, and a run of the new cell reports them."""

from __future__ import annotations

import json
import time

import pytest
import torch

from h100_bench import cell
from h100_bench.conftest import tiny_config

torch.set_num_threads(2)

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_committed_cells_resolve():
    ctx = cell.load(cell.Path(__file__).resolve().parents[2], "ppt_base.tune", 1, 1.0, False,
                    "cpu")
    assert ctx.cfg["arch"] == "ulip_pointbert" and ctx.traffic["loop"] == "tune"
    assert {m["name"] for m in ctx.end_to_end()} == {"tune_clouds_per_s", "setup_s"}
    assert "text_tower_ms.tune" in {m["name"] for m in ctx.per_layer()}


def add_recognition_cell(root):
    """What a later PR adds for a recognition cell: a configuration, a mix,
    a metric and limits as new files, their entries in BENCHMARK.json."""
    bench_path = root / "BENCHMARK.json"
    bench = json.loads(bench_path.read_text())
    cfg = tiny_config("ulip_pointnext_s")
    cfg["name"] = "dummy_net"
    (root / "h100_bench" / "configs" / "dummy_net.json").write_text(json.dumps(cfg))
    (root / "h100_bench" / "traffic" / "small_passes.json").write_text(json.dumps(
        {"loop": "recognize", "split": "test", "clouds": 10, "votes": 1, "checked_batches": 2}))
    (root / "h100_bench" / "metrics" / "window_units.py").write_text(
        "def read(run):\n    return float(run.window.units)\n")
    (root / "h100_bench" / "limits" / "dummy_net.small_passes.json").write_text(
        json.dumps({"logit_gap": 0.5, "answer_gap": 0.5}))
    cell_name = "dummy_net.small_passes"
    bench["configs"].append({"name": "dummy_net", "source": "https://example.org/dummy",
                             "file": "h100_bench/configs/dummy_net.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": cell_name, "config": "dummy_net",
                               "traffic": "small_passes", "chips": 1, "why": "test"})
    bench["end_to_end"] += [
        {"name": "recog_clouds_per_s", "unit": "clouds/s", "better": "higher", "bound": 0.05,
         "source": "host_clock", "workloads": [cell_name]},
        {"name": "recog_batch_ms_p95", "unit": "ms", "better": "lower", "bound": 0.05,
         "source": "host_clock", "workloads": [cell_name]}]
    bench["per_layer"] += [
        {"name": "window_units", "unit": "batches", "better": "higher",
         "source": "program_counter", "layer": "harness", "moves": "recog_clouds_per_s",
         "workloads": [cell_name]},
        {"name": "point_tower_ms.recog", "unit": "ms", "better": "lower",
         "source": "device_trace", "layer": "point towers", "moves": "recog_clouds_per_s",
         "workloads": [cell_name]}]
    bench_path.write_text(json.dumps(bench))
    return cell_name


def test_a_new_cell_is_files_and_entries_only(tiny_root):
    name = add_recognition_cell(tiny_root)
    for trace in (False, True):
        ctx = cell.load(tiny_root, name, 11, 0.05, trace, "cpu")
        out = cell.execute(ctx, time.perf_counter())
        assert list(out)[:5] == RESULT_KEYS and list(out)[-1] == "checks"
        assert out["correct"], out["checks"]
        if trace:
            assert "breakdown" in out and out["metrics"]["window_units"]["value"] >= 2
            assert out["metrics"]["point_tower_ms.recog"]["value"] > 0
            assert {"busy_s", "window_s"} <= set(out["device"])
        else:
            assert set(out["metrics"]) == {"recog_clouds_per_s", "recog_batch_ms_p95",
                                           "setup_s"}
        json.dumps(out)


@pytest.mark.parametrize("fault", ["altered_answer", "half_batch"])
def test_recognition_faults_are_caught(tiny_root, fault):
    ctx = cell.load(tiny_root, add_recognition_cell(tiny_root), 12, 0.05, False, "cpu")
    ctx.fault = fault
    assert not cell.execute(ctx, time.perf_counter())["correct"]
