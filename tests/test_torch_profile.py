"""The device-time profiler's bookkeeping, on the CPU (it profiles only
on the card: there it must refuse to run without one)."""

import pytest
import torch

from ppt_torch.tools import profile


@pytest.mark.parametrize("intervals,want", [
    ([], 0.0),
    ([(0.0, 2.0), (1.0, 3.0), (5.0, 6.0)], 4.0),  # overlap, then a gap
    ([(4.0, 5.0), (0.0, 10.0), (2.0, 3.0)], 10.0),  # nested, out of order
])
def test_busy_us_is_the_union_of_intervals(intervals, want):
    assert profile.busy_us(intervals) == want


@pytest.mark.parametrize("name,part", [
    ("fps_kernel(float const*, int, int, int*)", "fps_batched"),
    ("tc::mini_forward_bf16_kernel(float const*, int, int)", "mini_forward"),
    ("tc::mini_stats_bf16_kernel(float const*, int, int)", "mini_stats"),
    ("st::m2_reduce_kernel(float const*, int, int, float*)", "mini_stats"),
    ("void gemm_bf16_kernel<1>(__nv_bfloat16 const*)", "vit block: GEMMs"),
    ("void attention_bf16_kernel<64>(__nv_bfloat16 const*)", "vit block: attention"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n", "other (library kernels)"),
])
def test_part_of_maps_kernel_names(name, part):
    assert profile.part_of(name) == part


def test_profile_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        profile.profile_step(batch=2, npoints=64, batches=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        profile.profile_train_step(batch=2, npoints=64, batches=1)
