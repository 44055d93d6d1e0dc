"""The port's msgpack reader and writer against flax and msgpack-python.

``ppt_torch.utils.msgpack`` must read what ``flax.serialization.
msgpack_serialize`` writes and write it byte for byte: every scalar type
and width (nil, bool, the fixint/uint/int encodings, float32/64),
strings and bins across each length boundary, arrays and maps across
theirs, ext in each fixext and ext8/16/32 form, f16/f32/f64/bf16/int32/
int64/bool arrays, 0-d arrays, numpy scalars, empty dicts and a chunked
array; random trees by hypothesis. What it does not read raises
``ValueError`` by name. msgpack-python (installed here, not on the card's
machine) is the oracle for the encodings flax itself never writes.
"""

import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from ppt_torch.utils import msgpack as pm


def flax_packb(obj):
    """What flax's ``msgpack_serialize`` hands msgpack, without its tree copy."""
    return msgpack.packb(obj, default=serialization._msgpack_ext_pack, strict_types=True)


def same(got, want):
    """Equal values, types and (for arrays) dtypes, shapes and bits."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want)
        for k in want:
            same(got[k], want[k])
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for a, b in zip(got, want):
            same(a, b)
    elif isinstance(want, (np.ndarray, np.generic)):
        want = np.asarray(want)
        if want.dtype == jnp.bfloat16:
            assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
            np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))
        else:
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)
    else:
        assert type(got) is type(want) and got == want


INTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1,
        -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63]
LENGTHS = [0, 15, 16, 31, 32, 255, 256, 65535, 65536]


@pytest.mark.parametrize("value", INTS + [None, True, False, 0.5, -1e300, float("inf")])
def test_scalars_pack_and_read_as_msgpack_does(value):
    data = flax_packb(value)
    assert pm.packb(value) == data
    same(pm.unpackb(data), value)


def test_float32_is_read():
    for v in (1.5, -0.0, 3.4e38):
        assert pm.unpackb(msgpack.packb(v, use_single_float=True)) == np.float32(v)


@pytest.mark.parametrize("n", LENGTHS)
def test_every_length_encoding(n):
    """fixstr/str8/16/32, bin8/16/32, fixarray/array16/32 and
    fixmap/map16/32 at each boundary, and ext8/16/32 by array size."""
    objs = ["é" * (n // 2) + "x" * (n % 2), b"\x01" * n, list(range(n % 300)) * (n // 300 or 1),
            {f"k{i}": i for i in range(n)}, np.arange(n, dtype=np.uint8)]
    for obj in objs:
        data = flax_packb(obj)
        assert pm.packb(obj) == data
        same(pm.unpackb(data), obj)


@pytest.mark.parametrize("size", [1, 2, 4, 8, 16, 3, 17, 255, 256, 65535, 65536])
def test_every_ext_form_is_read(size):
    """fixext1/2/4/8/16 and ext8/16/32 around an ndarray payload padded to
    ``size`` bytes (msgpack writes the header; the reader must find the
    payload's end by the header, not by the payload)."""
    data = msgpack.packb(msgpack.ExtType(7, b"\x00" * size))
    with pytest.raises(ValueError, match="unknown ext code 7"):
        pm.unpackb(data)
    arr = np.zeros(size, np.uint8)
    payload = serialization._ndarray_to_bytes(arr)
    data = msgpack.packb(msgpack.ExtType(1, payload))
    same(pm.unpackb(data), arr)


ARRAYS = [np.arange(6, dtype=np.float16).reshape(2, 3), np.linspace(-1, 1, 7, dtype=np.float32),
          np.arange(12, dtype=np.float64).reshape(2, 2, 3), np.arange(-3, 3, dtype=np.int32),
          np.arange(5, dtype=np.int64) * 2 ** 40, np.array([True, False, True]),
          np.asarray(np.float32(2.5)), np.zeros((0, 4), np.float32),
          np.asarray(jnp.linspace(-3, 3, 10, dtype=jnp.bfloat16)).reshape(2, 5),
          np.asarray(np.float32(1.0)).reshape(())]


@pytest.mark.parametrize("i", range(len(ARRAYS)))
def test_arrays_and_scalars_round_trip_with_flax(i):
    tree = {"z": {"a": ARRAYS[i], "s": np.float32(-1.25), "i": np.int64(3)}, "e": {},
            "b": True}
    data = serialization.msgpack_serialize(tree)
    got = pm.msgpack_restore(data)
    same(got, serialization.msgpack_restore(data))
    # the reader's arrays are writable copies; written back, the same bytes
    # (a bf16 leaf comes back as a torch.bfloat16 tensor)
    assert pm.msgpack_serialize(got) == data
    assert pm.msgpack_serialize(tree) == data


def test_chunked_arrays(monkeypatch):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(pm, "MAX_CHUNK_SIZE", 64)
    tree = {"w": np.arange(60, dtype=np.float32).reshape(3, 20), "small": np.ones(4, np.float32),
            "bf": np.asarray(jnp.arange(40, dtype=jnp.bfloat16))}
    data = serialization.msgpack_serialize(tree)
    assert pm.msgpack_serialize(tree) == data
    raw = pm.unpackb(data)
    assert raw["w"]["__msgpack_chunked_array__"] is True and len(raw["w"]["chunks"]) == 4
    same(pm.msgpack_restore(data), serialization.msgpack_restore(data))
    # a whole tree that is one chunked array
    top = serialization.msgpack_serialize(np.arange(40, dtype=np.float64))
    assert pm.msgpack_serialize(np.arange(40, dtype=np.float64)) == top
    same(pm.msgpack_restore(top), serialization.msgpack_restore(top))


def test_dict_order_is_flax_order():
    """``msgpack_serialize`` sorts keys as flax's tree copy does; ``packb``
    keeps the order given, as msgpack does."""
    tree = {"b": 1, "a": {"d": 2, "c": 3}}
    assert pm.msgpack_serialize(tree) == serialization.msgpack_serialize(tree)
    assert pm.packb(tree) == msgpack.packb(tree)
    assert list(pm.unpackb(pm.packb(tree))) == ["b", "a"]


def test_refusals_by_name():
    with pytest.raises(ValueError, match="ext code 2"):
        pm.unpackb(serialization.msgpack_serialize({"c": 1 + 2j}))
    with pytest.raises(ValueError, match="unknown ext code -1"):  # a timestamp's code
        pm.unpackb(b"\xd6\xff" + b"\x00" * 4)
    data = serialization.msgpack_serialize({"w": np.ones(5, np.float32)})
    for cut in (1, 5, len(data) - 1):
        with pytest.raises(ValueError, match="truncated"):
            pm.unpackb(data[:cut])
    with pytest.raises(ValueError, match="0xc1"):
        pm.unpackb(b"\xc1")
    with pytest.raises(ValueError, match="past the end"):
        pm.unpackb(data + b"\x00")
    with pytest.raises(TypeError, match="tuple"):
        pm.packb((1, 2))


def test_port_package_imports_no_msgpack():
    """The reader's module stands alone: no msgpack, flax or jax import."""
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(pm))
    names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert names.isdisjoint({"msgpack", "flax", "jax"}), names


_keys = st.text(min_size=0, max_size=40)
_leaves = st.one_of(
    st.none(), st.booleans(), st.integers(-2 ** 63, 2 ** 64 - 1),
    st.floats(allow_nan=False), st.text(max_size=300), st.binary(max_size=300),
    st.builds(lambda n, k: (np.arange(n) % 3).astype([np.float32, np.int64, np.float16,
                                                       np.bool_][k]),
              st.integers(0, 40), st.integers(0, 3)))
_trees = st.recursive(_leaves, lambda kids: st.one_of(
    st.lists(kids, max_size=20), st.dictionaries(_keys, kids, max_size=20)), max_leaves=60)


@settings(max_examples=60, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(_trees)
def test_random_trees_match_msgpack(tree):
    data = flax_packb(tree)
    assert pm.packb(tree) == data
    same(pm.unpackb(data), msgpack.unpackb(data, ext_hook=serialization._msgpack_ext_unpack,
                                           raw=False, strict_map_key=False))
