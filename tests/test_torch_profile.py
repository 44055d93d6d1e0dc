"""The device-time profiler's bookkeeping, on the CPU (it profiles only
on the card: there it must refuse to run without one)."""

import re
from pathlib import Path

import pytest
import torch

from ppt_torch.tools import profile

torch.set_num_threads(1)  # one intra-op thread: the xdist workers share the cores


@pytest.mark.parametrize("intervals,want", [
    ([], 0.0),
    ([(0.0, 2.0), (1.0, 3.0), (5.0, 6.0)], 4.0),  # overlap, then a gap
    ([(4.0, 5.0), (0.0, 10.0), (2.0, 3.0)], 10.0),  # nested, out of order
])
def test_busy_us_is_the_union_of_intervals(intervals, want):
    assert profile.busy_us(intervals) == want


@pytest.mark.parametrize("name,part", [
    ("void fps_batched_kernel<4>(float const*, int, int, int*)", "fps_batched"),
    ("void knn_gather_kernel<1>(float const*, float const*, int, int, int, int, int*, float*)",
     "knn_gather"),
    ("wg::mini_forward_wgmma_kernel(CUtensorMap_st, CUtensorMap_st, float const*)",
     "mini_forward"),
    ("tc::mini_stats_bf16_kernel(float const*, int, int)", "mini_stats"),
    ("st::m2_reduce_kernel(float const*, int, int, float*)", "mini_stats"),
    ("void gemm_wgmma_kernel<192, 1>(CUtensorMap_st, CUtensorMap_st, int, int, int)",
     "vit block: GEMMs"),
    ("void attention_bf16_kernel<64>(__nv_bfloat16 const*)", "vit block: attention"),
    ("void attention_wgmma_kernel<64, 0, true>(CUtensorMap_st, CUtensorMap_st)",
     "vit block: attention"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n", "other (library kernels)"),
    ("void text::gemm_wgmma_kernel<64, true, 6>(CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, int, int, int, text::EpiArgs, void*)", "text: GEMMs"),
    ("void text::gemm_f32_kernel<false, 0>(float const*)", "text: GEMMs"),
    ("void text::ln_kernel<__nv_bfloat16>(__nv_bfloat16 const*)", "text: LayerNorm"),
    ("void text::ln_vjp_kernel<float>(float const*)", "text: LayerNorm backward"),
    ("void text::attn_bwd_bf16_kernel<64>(__nv_bfloat16 const*, __nv_bfloat16 const*)",
     "text: attention backward"),
    ("text::attn_bwd_f32_kernel(float const*, float const*, int, int, int, float, float*)",
     "text: attention backward"),
    ("void text::attn_fwd_bf16_kernel<32>(__nv_bfloat16 const*, int, int, float, int)",
     "text: attention"),
    ("text::attn_fwd_f32_kernel(float const*, int, int, int, float, int, float*)",
     "text: attention"),
    ("text::proj_bwd_kernel(float const*, float const*, int, int, float*)",
     "text: pooling + ln_final + projection"),
    ("ball_query_kernel(float const*, float const*, int, int, int, float, int*, float*)",
     "ball_query_gather"),
    ("ball_query_feats_kernel(float const*, float const*, char const*, int)",
     "ball_query_gather_feats"),
    ("void fps_batched_kernel<16>(float const*, int, int, int*)", "fps_batched"),
    ("void flash_fwd_wgmma_kernel<64>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st)",
     "flash_mha"),
    ("flash_f32_kernel(float const*, float const*)", "flash_mha"),
    ("void flash_bwd_dkv_wgmma_kernel<64>(CUtensorMap_st, CUtensorMap_st)", "flash_mha_bwd"),
    ("void flash_bwd_dq_wgmma_kernel<64>(CUtensorMap_st, CUtensorMap_st)", "flash_mha_bwd"),
    ("void flash_bwd_di_bf16_kernel<64>(__nv_bfloat16 const*)", "flash_mha_bwd"),
    ("flash_bwd_dkv_f32_kernel(float const*, float const*)", "flash_mha_bwd"),
    ("void flash_bwd_di_kernel<float>(float const*, float const*, int)", "flash_mha_bwd"),
    ("nn_dists_kernel(NnDir, NnDir, int)", "chamfer_nn_dists"),
    ("approx_match_kernel(float const*, int, int, float, float, int, float*, float*)",
     "approx_match"),
    ("void approx_match_warp_kernel<32, true>(float const*, int, int, int, float, float, float*)",
     "approx_match"),
    ("void approx_match_warp_kernel<8, false>(float const*, int, int, int, float, float, float*)",
     "approx_match"),
    ("nn_floor_kernel(NnDir, NnDir, int)", "chamfer_nn_dists: launch floor"),
    ("approx_match_floor_kernel()", "approx_match: launch floor"),
])
def test_part_of_maps_kernel_names(name, part):
    assert profile.part_of(name) == part


CSRC = Path(__file__).resolve().parent.parent / "ppt_torch" / "csrc"


def _kernels():
    """Every __global__ of the port's CUDA sources, named as a trace names
    it: with the namespace it is declared in."""
    bounds = r"(?:__launch_bounds__\((?:[^()]|\([^()]*\))*\)\s*)?"
    found = []
    for path in sorted(CSRC.glob("*.cu*")):
        text = path.read_text()
        spaces = [(m.start(), text.find("}  // namespace " + m.group(1), m.end()), m.group(1))
                  for m in re.finditer(r"^namespace (\w+) \{", text, re.M)]
        for m in re.finditer(r"__global__\s+void\s+" + bounds + r"(\w+)\s*\(", text):
            ns = [n for start, end, n in spaces if start < m.start() < end]
            found.append((path.name, "::".join(ns + [m.group(1)])))
    return found


def test_every_kernel_of_the_port_lands_in_a_named_part():
    """A kernel whose name matches no PARTS key would be counted as a
    library kernel: each __global__ in ppt_torch/csrc maps to a part."""
    kernels = _kernels()
    for want in [("attention.cuh", "attention_wgmma_kernel"),
                 ("attention.cu", "flash_bwd_dkv_wgmma_kernel"),
                 ("text.cu", "text::gemm_wgmma_kernel"), ("mini.cu", "st::m2_reduce_kernel")]:
        assert want in kernels
    other = [k for k in kernels if profile.part_of(k[1]) == "other (library kernels)"]
    assert not other, other


@pytest.mark.parametrize("intervals,want", [
    ([(0, 10), (20, 25)], [10, 5]),
    ([(0, 10), (5, 12), (20, 25)], [10, 2, 5]),  # a launch that waits on the one before
    ([(5, 12), (0, 10), (6, 8)], [2, 10, 0]),  # given out of order; one inside another
])
def test_exclusive_shares_sum_to_the_busy_time(intervals, want):
    got = profile.exclusive_us(intervals)
    assert got == want
    assert sum(got) == profile.busy_us(intervals)


def test_profile_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        profile.profile_step(batch=2, npoints=64, batches=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        profile.profile_train_step(batch=2, npoints=64, batches=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        profile.profile_pretrain_step(batch=2, npoints=64, batches=1, num_group=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        profile.profile_dvae_step(batch=2, npoints=64, batches=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        profile.profile_mpm_step(batch=2, npoints=64, batches=1)


def test_model_flag_and_tower_sections(monkeypatch):
    """``--model`` picks the tower (PointNeXt-S with its height channel) and
    the tower's time is summed by child module, the head's layers together."""
    assert profile.takes_height("ULIP_PN_NEXT") and not profile.takes_height("ULIP_PN_SSG")
    assert [profile.tower_section(n) for n in ("stem", "stage1_sa", "stage5_global", "head_fc0",
                                                "head_bn1", "sa2", "head")] == [
        "stem", "stage1_sa", "stage5_global", "head", "head", "sa2", "head"]
    seen = {}
    monkeypatch.setattr(profile, "profile_step",
                        lambda *a, **kw: seen.update(kw, batch=a[0]) or {})
    profile.main(["--model", "ULIP_PN_NEXT", "--batch", "128"])
    assert seen == {"model_name": "ULIP_PN_NEXT", "batch": 128, "point_route": "block",
                    "num_group": 512}
    with pytest.raises(SystemExit):
        profile.main(["--model", "ULIP_PointTransformer"])  # no registry's entry: not a choice


@pytest.mark.parametrize("argv,fn,want", [
    (["--train", "pretrain"], "profile_pretrain_step",
     {"batch": 32, "npoints": 8192, "num_group": 1024}),
    (["--train", "pretrain", "--num_group", "512"], "profile_pretrain_step",
     {"batch": 32, "npoints": 8192, "num_group": 512}),
    (["--train", "--num_group", "1024", "--npoints", "8192", "--head_type", "3"],
     "profile_train_step", {"batch": 30, "npoints": 8192, "num_group": 1024, "head_type": 3}),
    (["--train"], "profile_train_step", {"batch": 30, "npoints": 1024, "num_group": 512}),
    (["--train", "dvae"], "profile_dvae_step", {"batch": 64, "npoints": 1024, "recon": "chamfer"}),
    (["--train", "dvae", "--recon", "emd"], "profile_dvae_step", {"batch": 64, "recon": "emd"}),
    (["--train", "mpm", "--point_route", "tower"], "profile_mpm_step",
     {"batch": 32, "npoints": 1024, "point_route": "block"}),
])
def test_train_targets_reach_their_steps(argv, fn, want, monkeypatch):
    """``--train pretrain`` profiles ULIP pretraining's step (the long trunk
    by default); ``--train`` with 1024 groups over 8192 points and head
    type 3 is the long trunk's prompt-tuning step."""
    import inspect

    seen = {}
    names = list(inspect.signature(getattr(profile, fn)).parameters)

    def fake(*a, **kw):
        seen.update(dict(zip(names, a)), **kw)
        return {}

    monkeypatch.setattr(profile, fn, fake)
    profile.main(argv)
    assert {k: seen[k] for k in want} == want
