"""``fps_single`` and ``ball_query_gather_v2`` on the kernels they share.

Each computes the function of another wrapper (``fps_batched``,
``ball_query_gather``), so each launches that wrapper's CUDA kernel
through the same entry point of ``csrc/group.cu``, with its own launch
counter and refusals. On the CPU there is no card and no ``nvcc``: the
kernel paths (the operators' CUDA implementations: through the operator a
meta tensor takes the fake) run on meta tensors against a stand-in for the
built library that has exactly the entry points the sources export and
records each call. The CPU paths (the plain versions) are held to the
reference: ``fps_single`` past N against ``fps_pallas`` interpreted, and
``ball_query_gather_v2`` past the cloud size its old kernel refused.
"""

import collections
import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppt_tpu.kernels import fps_pallas
from ppt_torch.kernels import _build
from ppt_torch.kernels import fps as kfps
from ppt_torch.kernels import group as kgroup

torch.set_num_threads(1)  # one intra-op thread: the xdist workers share the cores

CSRC = Path(__file__).resolve().parent.parent / "ppt_torch" / "csrc"


def exports(source):
    """The C entry points ``csrc/<source>.cu`` exports."""
    return set(re.findall(r"PPT_EXPORT int (\w+)\(", (CSRC / f"{source}.cu").read_text()))


class _Entry:
    """One exported entry point: records its arguments (pointers by value),
    returns 0."""

    def __init__(self, name, calls):
        self.name, self.calls = name, calls

    def __call__(self, *args):
        self.calls.append((self.name, tuple(a.value if isinstance(a, ctypes.c_void_p) else a
                                            for a in args)))
        return 0


class _Lib:
    """A built library's stand-in: exactly the entry points its source
    exports; any other name raises as ``ctypes`` does."""

    def __init__(self, source):
        self.source, self.calls = source, []
        self._entries = {n: _Entry(n, self.calls) for n in exports(source)}

    def __getattr__(self, name):
        if name.startswith("_") or name not in self._entries:
            raise AttributeError(f"{self.source}.cu exports no {name}")
        return self._entries[name]


@pytest.fixture
def stub(monkeypatch):
    """The kernel paths against stand-in libraries: returns the libraries
    loaded, by source; launches counted in a fresh counter."""
    loaded = {}

    def load(name):
        return loaded.setdefault(name, _Lib(name))

    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(kgroup, "_lib_typed", None)
    monkeypatch.setattr(_build, "ptr", lambda t: ctypes.c_void_p(0))
    monkeypatch.setattr(_build, "stream_ptr", lambda t: ctypes.c_void_p(0))
    monkeypatch.setattr(_build, "LAUNCHES", collections.Counter())
    return loaded


def meta(*shape):
    return torch.empty(*shape, device="meta")


def test_the_stand_in_has_every_entry_point_the_grouping_wrappers_type():
    assert set(kgroup._ARGTYPES) <= exports("group")
    assert {"ppt_fps", "ppt_ball_query"} <= exports("group")
    assert "ppt_knn_single" in exports("cloud")


# the slice, npoint past N (as fps_pallas takes it), the cap (16 points a
# thread, coordinates in shared memory), bf16 coordinates
@pytest.mark.parametrize("B,N,npoint,dtype", [(32, 1024, 512, torch.float32),
                                              (2, 77, 100, torch.float32),
                                              (2, kfps.MAX_POINTS, 1024, torch.float32),
                                              (3, 300, 64, torch.bfloat16)])
def test_fps_single_launches_ppt_fps(stub, B, N, npoint, dtype):
    out = kfps._fps_single_cuda(meta(B, N, 3).to(dtype), npoint)
    assert out.dtype == torch.int32 and tuple(out.shape) == (B, npoint)
    assert list(stub) == ["group"]  # cloud.cu holds no FPS kernel
    (name, args), = stub["group"].calls
    assert name == "ppt_fps" and args[1:4] == (B, N, npoint)
    assert dict(_build.LAUNCHES) == {"fps_single": 1}
    # fps_batched's kernel path launches the same entry point with the same arguments
    if npoint <= N:
        kgroup._fps_batched_cuda(meta(B, N, 3).to(dtype), npoint)
        assert stub["group"].calls[1] == ("ppt_fps", args)


@pytest.mark.parametrize("B,N,npoint", [(0, 64, 8), (2, 64, 0)])
def test_fps_single_launches_nothing_for_an_empty_result(stub, B, N, npoint):
    assert tuple(kfps._fps_single_cuda(meta(B, N, 3), npoint).shape) == (B, npoint)
    assert not stub and not _build.LAUNCHES


@pytest.mark.parametrize("shape,npoint,msg", [
    ((1, kfps.MAX_POINTS + 1, 3), 8, f"fps_single: N={kfps.MAX_POINTS + 1} exceeds"),
    ((1, 64, 4), 8, r"fps_single: expects xyz \[B, N, 3\]"),
    ((1, 0, 3), 4, "fps_single: an empty cloud"),
])
def test_fps_single_refuses_by_name_before_any_build(stub, shape, npoint, msg):
    with pytest.raises(ValueError, match=msg):
        kfps._fps_single_cuda(meta(*shape), npoint)
    assert not stub


# PointNeXt-S's stage 1 (4 queries a warp), a small grid (1 a warp), a
# cloud past the old rank kernel's shared-memory cap of 19370 points
@pytest.mark.parametrize("B,N,S,nsample", [(128, 1024, 512, 32), (2, 300, 40, 7),
                                           (1, 20000, 100, 64)])
def test_ball_query_gather_v2_launches_the_walk_with_its_plan(stub, B, N, S, nsample):
    idx, rel = kgroup._ball_v2_cuda(0.2, nsample, meta(B, N, 3), meta(B, S, 3))
    assert tuple(idx.shape) == (B, S, nsample) and tuple(rel.shape) == (B, S, nsample, 3)
    assert list(stub) == ["group"]
    (name, args), = stub["group"].calls
    assert name == "ppt_ball_query" and args[2:6] == (B, N, S, nsample)
    assert args[6] == pytest.approx(0.2 * 0.2) and args[7:9] == kgroup._ball_plan(B, S)
    assert dict(_build.LAUNCHES) == {"ball_query_gather_v2": 1}
    # ball_query_gather launches the same entry point with the same arguments
    kgroup._ball_cuda(0.2, nsample, meta(B, N, 3), meta(B, S, 3))
    assert stub["group"].calls[1] == ("ppt_ball_query", args)
    assert dict(_build.LAUNCHES) == {"ball_query_gather_v2": 1, "ball_query_gather": 1}


def test_ball_query_gather_v2_refuses_by_name_before_any_build(stub):
    with pytest.raises(ValueError, match=r"ball_query_gather_v2: nsample=65 not in \[1, N=64\]"):
        kgroup._ball_v2_cuda(0.2, 65, meta(1, 64, 3), meta(1, 8, 3))
    assert not stub


def _cloud(b, n, seed, dup=False):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, n, 3).astype(np.float32)
    if dup:  # every fourth point repeats another: the cloud runs out of distinct points sooner
        x[:, 3::4] = x[:, : x[:, 3::4].shape[1]]
    return x


# npoint past N: once every distinct point is picked, each step picks index 0
@pytest.mark.parametrize("b,n,npoint,dup", [(2, 5, 9, False), (2, 77, 100, False),
                                            (2, 40, 64, True), (1, 1, 3, False)])
def test_fps_single_past_n_matches_fps_pallas(b, n, npoint, dup):
    x = _cloud(b, n, n + npoint, dup)
    want = np.asarray(fps_pallas(jnp.asarray(x), npoint, interpret=True))
    got = kfps.fps_single(torch.from_numpy(x), npoint)
    np.testing.assert_array_equal(got.numpy(), want)
    distinct = len(np.unique(x[0], axis=0))
    assert len(set(want[0, :distinct].tolist())) == distinct  # each position picked once
    assert (want[:, distinct:] == 0).all()


@pytest.mark.parametrize("radius,nsample", [(0.05, 64), (0.02, 16)])
def test_ball_query_gather_v2_past_the_old_cap_equals_ball_query_gather(radius, nsample):
    rng = np.random.RandomState(11)
    xyz = torch.from_numpy(rng.rand(1, 20000, 3).astype(np.float32))
    centres = torch.tensor(list(range(0, 20000, 1250)) + [19999])
    q = xyz[:, centres].contiguous()  # centres on cloud points: every ball holds a hit
    idx, rel = kgroup.ball_query_gather_v2(radius, nsample, xyz, q)
    want_idx, want_rel = kgroup.ball_query_gather(radius, nsample, xyz, q)
    assert torch.equal(idx, want_idx) and torch.equal(rel, want_rel)
    assert (idx[0, :, 0] <= centres).all() and (idx[0] == centres[:, None]).any(-1).all()
    assert int(idx.max()) > 19370  # picks past the old kernel's cap


def test_fps_single_cap_is_fps_batched_cap():
    assert kfps.MAX_POINTS == kgroup.FPS_MAX_POINTS == 16384
