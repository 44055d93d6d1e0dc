"""Port vs reference: the OGB graph datasets and the molecule datasets.

``ppt_torch.data.graphs`` / ``molecules`` against ``ppt_tpu.data.graphs`` /
``molecules``: the cases of ``tests/test_graphs.py`` and the molecule cases
of ``tests/test_scenes.py``, each run through both packages on the same
injected records (the raw OGB and atom3d readers are not installed) and,
where the training split's SVD sign flips draw, the same seeded
``np.random.RandomState``. Every output is bit-equal: same keys, dtypes,
shapes and bytes. The readers' ImportErrors name ``ogb`` and ``atom3d`` in
both packages.
"""

import pickle

import numpy as np
import pytest
import torch

from ppt_tpu.data import graphs as jg
from ppt_tpu.data import molecules as jmol
from ppt_torch.data import graphs as tg
from ppt_torch.data import molecules as tmol

torch.set_num_threads(1)  # one intra-op thread: the xdist workers share the cores


def random_graph(rng, n, n_edges, fn=3, fe=2):
    edges = rng.randint(0, n, size=(n_edges, 2)).astype(np.int16)
    return {
        "num_nodes": np.array(n, np.int16),
        "edges": edges,
        "node_features": rng.randint(0, 50, size=(n, fn)).astype(np.int16),
        "edge_features": rng.randint(0, 5, size=(n_edges, fe)).astype(np.int16),
        "target": np.float32(rng.rand()),
    }


def same(got, want):
    """Bit-equal: arrays by dtype, shape and bytes; dicts key by key;
    sequences item by item."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), (list(got), list(want))
        for k in want:
            same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            same(g, w)
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, w.dtype, g.shape, w.shape)
        assert g.tobytes() == w.tobytes()


def test_constants_match():
    assert (tg.NODE_FEATURES_OFFSET, tg.EDGE_FEATURES_OFFSET, tg._FW_UNREACH) == (
        jg.NODE_FEATURES_OFFSET, jg.EDGE_FEATURES_OFFSET, jg._FW_UNREACH)
    assert tg.OGB_DATASET_NAMES == jg.OGB_DATASET_NAMES
    assert tmol.PROT_ATOMS == jmol.PROT_ATOMS


# ---------------------------------------------------------------------------
# SVD encodings, Floyd-Warshall, structural features
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,n_edges,dim,seed", [(7, 12, 7, 0), (10, 20, 4, 1), (3, 4, 8, 2),
                                                (1, 0, 8, 3)])
def test_svd_encodings_bit_equal(n, n_edges, dim, seed):
    edges = np.random.RandomState(seed).randint(0, n, size=(n_edges, 2))
    got = tg.svd_encodings(edges, n, calculated_dim=dim)
    same(got, jg.svd_encodings(edges, n, calculated_dim=dim))
    assert got.shape == (n, dim, 2)
    if dim == n:  # the factorisation is exact: enc0 @ enc1^T is the self-looped adjacency
        adj = np.zeros((n, n), np.float32)
        adj[edges[:, 0], edges[:, 1]] = 1.0
        np.fill_diagonal(adj, 1.0)
        np.testing.assert_allclose(got[..., 0] @ got[..., 1].T, adj, atol=1e-5)
    if dim > n:
        np.testing.assert_array_equal(got[:, n:, :], 0.0)


@pytest.mark.parametrize("seed,n,p", [(0, 6, 0.3), (1, 9, 0.15), (2, 12, 0.5), (3, 1, 0.5)])
def test_floyd_warshall_bit_equal(seed, n, p):
    adj = (np.random.RandomState(seed).rand(n, n) < p).astype(np.int16)
    same(tg.floyd_warshall(adj), jg.floyd_warshall(adj))


def test_floyd_warshall_caps_the_unreachable():
    adj = np.zeros((4, 4), np.int16)
    adj[0, 1] = adj[2, 3] = 1
    d = tg.floyd_warshall(adj)
    same(d, jg.floyd_warshall(adj))
    assert d[0, 1] == 1 and d[0, 2] == 510 and d[1, 0] == 510


@pytest.mark.parametrize("case", ["duplicate_edge", "random", "no_edges"])
def test_structural_features_bit_equal(case):
    if case == "duplicate_edge":  # the last write wins
        args = (3, np.array([[0, 1], [0, 1]], np.int16), np.array([[2, 5], [7, 0], [1, 3]],
                                                                  np.int16),
                np.array([[1, 2], [3, 4]], np.int16))
    elif case == "random":
        g = random_graph(np.random.RandomState(4), 9, 14)
        args = (g["num_nodes"], g["edges"], g["node_features"], g["edge_features"])
    else:
        args = (4, np.zeros((0, 2), np.int16), np.ones((4, 3), np.int16),
                np.zeros((0, 2), np.int16))
    got = tg.structural_features(*args)
    same(got, jg.structural_features(*args))
    if case == "duplicate_edge":
        np.testing.assert_array_equal(got[2][0, 1], args[3][1] + [1, 1 + tg.EDGE_FEATURES_OFFSET])


# ---------------------------------------------------------------------------
# stacking and collation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arrays", [
    [np.ones((2, 3), np.int16), np.ones((4, 1), np.int16)],
    [np.float32(1), np.float32(2)],
    [np.ones(3), np.arange(5.0)],
    [np.ones((2, 1, 3, 2), np.uint8), np.ones((1, 2, 1, 1), np.uint8)],
], ids=["2d", "scalars", "1d", "4d"])
def test_stack_with_pad_bit_equal(arrays):
    same(tg.stack_with_pad(arrays), jg.stack_with_pad(arrays))


def test_stack_with_pad_refuses_past_4d():
    for mod in (tg, jg):
        with pytest.raises(ValueError, match="4D"):
            mod.stack_with_pad([np.ones((1, 1, 1, 1, 1))])


@pytest.mark.parametrize("pad_nodes", [None, 16])
def test_collate_graphs_bit_equal(pad_nodes):
    rng = np.random.RandomState(3)
    recs = [random_graph(rng, 5, 8), random_graph(rng, 9, 14)]
    t = tg.OGBGraphDataset(records=recs, svd=True, structural=True, split="validation")
    j = jg.OGBGraphDataset(records=recs, svd=True, structural=True, split="validation")
    got = tg.collate_graphs([t[0], t[1]], pad_nodes=pad_nodes)
    same(got, jg.collate_graphs([j[0], j[1]], pad_nodes=pad_nodes))
    n = pad_nodes or 9
    assert got["distance_matrix"].shape == (2, n, n) and got["node_mask"].sum() == 14
    for mod, ds in ((tg, t), (jg, j)):
        with pytest.raises(ValueError, match="pad_nodes"):
            mod.collate_graphs([ds[0], ds[1]], pad_nodes=8)


def test_collate_keeps_the_edge_axis():
    rng = np.random.RandomState(4)
    batch = [random_graph(rng, 4, 6), random_graph(rng, 4, 10)]
    got = tg.collate_graphs(batch, pad_nodes=8)
    same(got, jg.collate_graphs(batch, pad_nodes=8))
    assert got["edges"].shape == (2, 10, 2)


# ---------------------------------------------------------------------------
# the dataset on injected records
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("svd,structural,split", [
    (True, True, "validation"), (False, False, "validation"), (True, False, "training"),
    (True, True, "training"), (False, True, "test"),
])
def test_dataset_items_bit_equal(svd, structural, split):
    """Each item twice (the training split draws fresh sign flips a read),
    from two datasets whose flips draw from the same seeded RandomState."""
    rng = np.random.RandomState(5)
    recs = [random_graph(rng, 6, 9), random_graph(rng, 11, 20), random_graph(rng, 2, 1)]
    kw = dict(records=recs, svd=svd, structural=structural, split=split)
    t = tg.OGBGraphDataset(rng=np.random.RandomState(7), **kw)
    j = jg.OGBGraphDataset(rng=np.random.RandomState(7), **kw)
    assert len(t) == len(j) == 3 and t.max_nodes == j.max_nodes == 11
    for _ in range(2):
        for i in range(3):
            same(t[i], j[i])
    same(t.max_batch(3), j.max_batch(3))


def test_sign_flips_only_on_the_training_split():
    rng = np.random.RandomState(6)
    recs = [random_graph(rng, 8, 12)]
    val = tg.OGBGraphDataset(records=recs, svd=True, split="validation")
    train = tg.OGBGraphDataset(records=recs, svd=True, split="training",
                               rng=np.random.RandomState(7))
    a, b = train[0]["svd_encodings"], train[0]["svd_encodings"]
    assert not np.array_equal(a, b)
    np.testing.assert_array_equal(np.abs(a), np.abs(val[0]["svd_encodings"]))
    flip = np.sign(a[0] / val[0]["svd_encodings"][0])
    np.testing.assert_array_equal(flip[0::2], flip[1::2])  # a (u, vh) pair flips together


def test_default_rng_is_seeded():
    """The port's default draws from ``RandomState(0)``: two datasets give
    the same flips, those of the reference handed that state."""
    recs = [random_graph(np.random.RandomState(11), 7, 10)]
    kw = dict(records=recs, svd=True, split="training")
    a, b = tg.OGBGraphDataset(**kw), tg.OGBGraphDataset(**kw)
    j = jg.OGBGraphDataset(rng=np.random.RandomState(0), **kw)
    for _ in range(3):
        want = j[0]
        same(a[0], want)
        same(b[0], want)


@pytest.mark.parametrize("calc,out", [(8, 4), (8, 8), (4, 2)])
def test_svd_output_dim_bit_equal(calc, out):
    recs = [random_graph(np.random.RandomState(8), 9, 15)]
    kw = dict(records=recs, svd=True, split="validation", calculated_dim=calc, output_dim=out)
    got = tg.OGBGraphDataset(**kw)[0]
    same(got, jg.OGBGraphDataset(**kw)[0])
    assert got["svd_encodings"].shape == (9, 2 * out)


def test_output_dim_past_calculated_dim_is_refused():
    for mod in (tg, jg):
        with pytest.raises(ValueError, match="output_dim"):
            mod.OGBGraphDataset(records=[], svd=True, calculated_dim=4, output_dim=8)


def test_record_cache_loads_without_ogb(tmp_path):
    recs = [random_graph(np.random.RandomState(9), 5, 7)]
    d = tmp_path / "molhiv" / "training"
    d.mkdir(parents=True)
    with open(d / "records.pkl", "wb") as f:
        pickle.dump(recs, f)
    kw = dict(name="molhiv", split="training", svd=True, cache_dir=str(tmp_path))
    t = tg.OGBGraphDataset(rng=np.random.RandomState(10), **kw)
    same(t[0], jg.OGBGraphDataset(rng=np.random.RandomState(10), **kw)[0])
    assert t[0]["svd_encodings"].shape == (5, 16)
    with pytest.raises(ImportError, match="ogb"):  # no cache: the reader, gated on ogb
        tg.OGBGraphDataset(name="molhiv", split="validation", cache_dir=str(tmp_path))


@pytest.mark.parametrize("name", ["molhiv", "molpcba", "pcqm4m", "pcqm4mv2"])
def test_ogb_readers_name_ogb(name):
    for mod in (tg, jg):
        with pytest.raises(ImportError, match="ogb"):
            mod.read_ogb_records(name, "/nonexistent", "training")
    with pytest.raises(ImportError, match="ogb"):
        tg.OGBGraphDataset(name=name, dataset_path="/nonexistent")


def test_unknown_ogb_name_is_refused():
    for mod in (tg, jg):
        with pytest.raises(KeyError, match="unknown OGB"):
            mod.read_ogb_records("nope", "/nonexistent", "training")


# ---------------------------------------------------------------------------
# molecules
# ---------------------------------------------------------------------------


class Frame:
    """A stand-in for the atom3d pandas frame: the two accesses
    ``load_atom_psr`` makes, ``frame[["x", "y", "z"]].to_numpy()`` and
    ``list(frame["element"])``."""

    def __init__(self, xyz, elements):
        self._xyz = np.asarray(xyz, np.float32)
        self._elements = list(elements)

    def __getitem__(self, key):
        if key == "element":
            return self._elements
        assert key == ["x", "y", "z"], key
        return self

    def to_numpy(self):
        return self._xyz


@pytest.mark.parametrize("elements", [["C", "ZN", "XX"], ["H", "F", "SE"], ["??", "??", "CA"]])
def test_atoms_to_points_bit_equal(elements):
    xyz = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    got = tmol.atoms_to_points(xyz, elements, 0.73)
    same(got, jmol.atoms_to_points(xyz, elements, 0.73))
    assert got["features"].shape == (3, 18) and got["features"].sum() == 3


@pytest.mark.parametrize("x", ["C", "FE", "XX", 7])
def test_one_of_k_encoding_unk_matches(x):
    got = tmol.one_of_k_encoding_unk(x, tmol.PROT_ATOMS)
    assert got == jmol.one_of_k_encoding_unk(x, jmol.PROT_ATOMS) and sum(got) == 1


def test_load_atom_psr_bit_equal():
    items = [{"atoms": Frame([[0, 0, 0], [1, 0, 0], [0, 1, 0]], ["C", "N", "XX"]),
              "scores": {"gdt_ts": 0.41}},
             {"atoms": Frame([[2, 2, 2], [3, 3, 3]], ["ZN", "H"]), "scores": {"gdt_ts": 0.92}}]
    got = tmol.load_atom_psr("/nonexistent", "val", items=items)
    same(got, jmol.load_atom_psr("/nonexistent", "val", items=items))
    assert got[0]["features"][2, -1] == 1  # an unknown element: the last bucket


def test_molecule_readers_name_their_packages():
    for mod in (tmol, jmol):
        with pytest.raises(ImportError, match="atom3d"):
            mod.load_atom_psr("/nonexistent", "val")
        with pytest.raises(ImportError, match="ogb"):
            mod.load_ogb_graphs("molhiv")


def test_load_ogb_graphs_is_the_ports_dataset():
    recs = [random_graph(np.random.RandomState(12), 4, 5)]
    ds = tmol.load_ogb_graphs("molhiv", records=recs, svd=True, split="validation")
    assert isinstance(ds, tg.OGBGraphDataset)
    same(ds[0], jmol.load_ogb_graphs("molhiv", records=recs, svd=True, split="validation")[0])
