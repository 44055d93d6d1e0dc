"""OGB molecular-graph datasets: the graph-transformer tier.

Counterpart of ``ppt_tpu/data/graphs.py``, numpy as there, so every array
equals the reference's bit for bit for the same records and sign-flip
draws (references in the upstream tree, ``openpoints/dataset/``):

  - ``graph_dataset/graph_dataset.py:12-93``: node masks, the max-nodes
    scan, zero-pad batch collation;
  - ``graph_dataset/svd_encodings_dataset.py:79-108``: positional encodings
    from the SVD of the self-looped adjacency, with random sign flips per
    component on the training split. ``np.linalg.svd`` stays:
    ``torch.linalg.svd`` may return other signs of the singular vectors;
  - ``graph_dataset/structural_dataset.py:9-72``: the Floyd-Warshall
    hop-distance matrix (unreachable pairs capped at 510), the dense
    edge-feature matrix, per-column vocabulary offsets;
  - ``graph_dataset/stack_with_pad.py:5-89``: ragged batch stacking;
  - ``molhiv/data.py:8-59`` / ``molpcba`` / ``pcqm4m{,v2}``: the raw OGB
    readers, gated on the ``ogb`` package (and rdkit for pcqm4m*).

Everything downstream of the raw reader runs without them on injected
records (``OGBGraphDataset(records=...)``). ``collate_graphs(pad_nodes=)``
pads every node-indexed axis to one fixed bucket, so a consumer sees one
shape across batches (the reference's ``max_batch`` warm-up served the
same end). The sign flips draw from ``rng``, a ``np.random.RandomState``
(seeded 0 unless one is given; the reference's default is the global
``np.random``). As in the reference, no dataset registry holds these:
graphs are another modality than the point-cloud ``ArrayDataset``s.
"""

from __future__ import annotations

import os
import pickle
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

# structural_dataset.py:6-7 — per-column vocabulary strides so distinct
# feature columns land in disjoint embedding-id ranges
NODE_FEATURES_OFFSET = 128
EDGE_FEATURES_OFFSET = 8
_FW_UNREACH = 510  # structural_dataset.py:19 — "no edge" distance cap

OGB_DATASET_NAMES = ("molhiv", "molpcba", "pcqm4m", "pcqm4mv2")


def svd_encodings(
    edges: np.ndarray, num_nodes: int, calculated_dim: int = 8
) -> np.ndarray:
    """``calculate_svd_encodings`` (svd_encodings_dataset.py:79-100),
    numba loop -> vectorized numpy; exact (same LAPACK SVD).

    Adjacency with self loops -> SVD -> per-node [n, dim, 2] stack of
    (u, vh.T) columns scaled by sqrt(s); zero-padded on the component
    axis when the graph has fewer than ``calculated_dim`` nodes."""
    n = int(num_nodes)
    adj = np.zeros((n, n), np.float32)
    e = np.asarray(edges, np.int64).reshape(-1, 2)
    if len(e):
        adj[e[:, 0], e[:, 1]] = 1.0
    np.fill_diagonal(adj, 1.0)
    u, s, vh = np.linalg.svd(adj)
    if calculated_dim < n:
        s, u, vh = s[:calculated_dim], u[:, :calculated_dim], vh[:calculated_dim]
    enc = np.stack((u, vh.T), axis=-1) * np.sqrt(s)[:, None]
    if calculated_dim > n:
        pad = np.zeros((n, calculated_dim - n, 2), np.float32)
        enc = np.concatenate((enc, pad), axis=1)
    return enc.astype(np.float32)


def floyd_warshall(adj: np.ndarray) -> np.ndarray:
    """Shortest-path matrix (structural_dataset.py:9-30): hop distance
    with unreachable pairs capped at 510, int16, zero diagonal. The
    reference's in-place scalar triple loop is the textbook algorithm;
    per-``k`` row/column broadcasting is equivalent (within pass ``k``,
    row ``k`` and column ``k`` are fixed points)."""
    n = adj.shape[0]
    d = np.where(adj != 0, 1, _FW_UNREACH).astype(np.int16)
    np.fill_diagonal(d, 0)
    for k in range(n):
        np.minimum(d, d[:, k : k + 1] + d[k : k + 1, :], out=d)
    return d


def structural_features(
    num_nodes: int,
    edges: np.ndarray,
    node_feats: np.ndarray,
    edge_feats: np.ndarray,
):
    """``preprocess_data`` (structural_dataset.py:32-47):
    (offset node features, distance matrix, dense edge-feature matrix).
    Feature columns are shifted into disjoint id ranges (1-based, stride
    128 / 8) for a single shared embedding table; duplicate edges keep
    the last write, as in the reference's write loop."""
    n = int(num_nodes)
    node_feats = np.asarray(node_feats, np.int16)
    edge_feats = np.asarray(edge_feats, np.int16)
    node_feats = node_feats + np.arange(
        1, node_feats.shape[-1] * NODE_FEATURES_OFFSET + 1,
        NODE_FEATURES_OFFSET, dtype=np.int16,
    )
    edge_feats = edge_feats + np.arange(
        1, edge_feats.shape[-1] * EDGE_FEATURES_OFFSET + 1,
        EDGE_FEATURES_OFFSET, dtype=np.int16,
    )
    a = np.zeros((n, n), np.int16)
    em = np.zeros((n, n, edge_feats.shape[-1]), np.int16)
    e = np.asarray(edges, np.int64).reshape(-1, 2)
    if len(e):
        a[e[:, 0], e[:, 1]] = 1
        em[e[:, 0], e[:, 1]] = edge_feats
    return node_feats, floyd_warshall(a), em


def stack_with_pad(inputs: Sequence[np.ndarray]) -> np.ndarray:
    """``stack_with_pad`` (stack_with_pad.py:76-89): zero-pad each array
    to the elementwise-max shape and stack. One rank-generic routine in
    place of the reference's four numba specializations; same >4-D
    error for parity."""
    if np.ndim(inputs[0]) == 0:
        return np.stack(inputs)
    if np.ndim(inputs[0]) > 4:
        raise ValueError("Only support up to 4D tensor")
    target = np.max([a.shape for a in inputs], axis=0)
    out = np.zeros((len(inputs), *target), inputs[0].dtype)
    for i, a in enumerate(inputs):
        out[i][tuple(slice(0, s) for s in a.shape)] = a
    return out


# Axes of each standard key that index NODES (and therefore pad to the
# ``pad_nodes`` bucket); anything absent falls back to a shape
# heuristic. ``edges``' leading axis counts EDGES — never node-padded.
_NODE_AXES: Dict[str, tuple] = {
    "node_features": (0,),
    "node_mask": (0,),
    "svd_encodings": (0,),
    "distance_matrix": (0, 1),
    "feature_matrix": (0, 1),
    "edges": (),
    "num_nodes": (),
    "target": (),
}


def collate_graphs(
    batch: Sequence[Dict[str, np.ndarray]], pad_nodes: Optional[int] = None
) -> Dict[str, np.ndarray]:
    """``graphdata_collate`` (graph_dataset.py:85-93), numpy-native.

    With ``pad_nodes`` every node-indexed axis is padded to that fixed
    bucket instead of the per-batch max, so a consumer sees one static
    shape across batches."""
    keys = batch[0].keys()
    nn = [int(b["num_nodes"]) for b in batch]
    out = {}
    for k in keys:
        arrs = [np.asarray(b[k]) for b in batch]
        if np.ndim(arrs[0]) == 0 or pad_nodes is None:
            out[k] = stack_with_pad(arrs)
            continue
        target = list(np.max([a.shape for a in arrs], axis=0))
        axes = _NODE_AXES.get(
            k,
            tuple(
                ax
                for ax in range(arrs[0].ndim)
                if all(a.shape[ax] == n for a, n in zip(arrs, nn))
            ),
        )
        for ax in axes:
            if target[ax] > pad_nodes:
                raise ValueError(
                    f"collate_graphs: {k} axis {ax} has {target[ax]} nodes "
                    f"> pad_nodes={pad_nodes}"
                )
            target[ax] = pad_nodes
        stacked = np.zeros((len(arrs), *target), arrs[0].dtype)
        for i, a in enumerate(arrs):
            stacked[i][tuple(slice(0, s) for s in a.shape)] = a
        out[k] = stacked
    return out


def read_ogb_records(name: str, dataset_path: str, split: str) -> List[dict]:
    """The raw OGB readers (molhiv/data.py:38-45, pcqm4m/data.py:40-48):
    fetch the split's graphs and normalize to this module's record dicts
    (``edges`` = edge_index.T, int16 features, float32 target). Gated on
    the ogb (+ rdkit for pcqm4m's smiles2graph) packages — absent here;
    inject ``records=`` to run the pipeline without them."""
    split_key = {"training": "train", "validation": "valid", "test": "test"}[split]
    try:
        if name in ("molhiv", "molpcba"):
            from ogb.graphproppred import GraphPropPredDataset

            ds = GraphPropPredDataset(name=f"ogbg-{name}", root=dataset_path)
            pairs = (ds[int(i)] for i in ds.get_idx_split()[split_key])
        elif name in ("pcqm4m", "pcqm4mv2"):
            if name == "pcqm4m":
                from ogb.lsc import PCQM4MDataset as _DS
            else:
                from ogb.lsc import PCQM4Mv2Dataset as _DS
            from ogb.utils import smiles2graph

            ds = _DS(root=dataset_path, only_smiles=True)
            pairs = (
                (smiles2graph(ds[int(i)][0]), ds[int(i)][1])
                for i in ds.get_idx_split()[split_key]
            )
        else:
            raise KeyError(f"unknown OGB dataset {name!r}; have {OGB_DATASET_NAMES}")
    except ImportError as exc:
        raise ImportError(
            f"{name} needs the 'ogb' package (and rdkit for pcqm4m*'s "
            "smiles2graph), not available in this environment; pass "
            "records=[...] to OGBGraphDataset to run the transform "
            "pipeline without them (ppt_torch/data/graphs.py docstring)"
        ) from exc
    records = []
    for graph, target in pairs:
        records.append(
            {
                "num_nodes": np.array(graph["num_nodes"], np.int16),
                "edges": np.asarray(graph["edge_index"]).T.astype(np.int16),
                "edge_features": np.asarray(graph["edge_feat"], np.int16),
                "node_features": np.asarray(graph["node_feat"], np.int16),
                "target": np.array(target, np.float32),
            }
        )
    return records


class OGBGraphDataset:
    """The reference's 16-class mixin zoo (``{MOLHIV,MOLPCBA,PCQM4M,
    PCQM4MV2}{,SVD,Structural,StructuralSVD}GraphDataset``) as one class
    with two switches. Transform order matches the reference MRO
    (molhiv/data.py:49-59): raw record -> node mask -> SVD encodings
    (memoized; fresh sign flips per access on the training split) ->
    structural features (pops edges/features, adds matrices).

    ``records`` injects pre-read raw records (dependency-free path, the
    same pattern as ``load_atom_psr(items=)``); otherwise the records
    are read via :func:`read_ogb_records` (ogb-gated) and optionally
    pickled to ``cache_dir`` like the reference's DatasetBase cache
    (dataset_base.py:62-94). ``rng`` draws the training split's sign
    flips (default ``np.random.RandomState(0)``)."""

    def __init__(
        self,
        name: str = "molhiv",
        dataset_path: Optional[str] = None,
        split: str = "training",
        records: Optional[List[dict]] = None,
        svd: bool = False,
        structural: bool = False,
        calculated_dim: int = 8,
        output_dim: int = 8,
        random_neg_splits: Sequence[str] = ("training",),
        include_node_mask: bool = True,
        cache_dir: Optional[str] = None,
        rng: Optional[np.random.RandomState] = None,
    ):
        if output_dim > calculated_dim:
            # svd_encodings_dataset.py:16-17
            raise ValueError("SVD: output_dim > calculated_dim")
        self.name = name
        self.split = split
        self.svd = svd
        self.structural = structural
        self.calculated_dim = calculated_dim
        self.output_dim = output_dim
        self.random_neg_splits = tuple(random_neg_splits)
        self.include_node_mask = include_node_mask
        self.rng = rng if rng is not None else np.random.RandomState(0)
        self._svd_cache: Dict[int, np.ndarray] = {}
        if records is not None:
            self.records = list(records)
            return
        cache_path = (
            os.path.join(cache_dir, name, split, "records.pkl")
            if cache_dir
            else None
        )
        if cache_path and os.path.exists(cache_path):
            with open(cache_path, "rb") as f:
                self.records = pickle.load(f)
            return
        self.records = read_ogb_records(name, dataset_path or ".", split)
        if cache_path:
            os.makedirs(os.path.dirname(cache_path), exist_ok=True)
            with open(cache_path, "wb") as f:
                pickle.dump(self.records, f)

    def __len__(self) -> int:
        return len(self.records)

    @property
    def max_nodes(self) -> int:
        # graph_dataset.py:38-54 (scan over raw records)
        return max(int(r["num_nodes"]) for r in self.records)

    def _svd_item(self, index: int) -> np.ndarray:
        try:
            enc = self._svd_cache[index]
        except KeyError:
            r = self.records[index]
            enc = svd_encodings(
                r["edges"], int(r["num_nodes"]), self.calculated_dim
            )
            self._svd_cache[index] = enc
        if self.output_dim < self.calculated_dim:
            enc = enc[:, : self.output_dim, :]
        if self.split in self.random_neg_splits:
            # svd_encodings_dataset.py:43-45 — random per-component sign
            flips = self.rng.randint(0, 2, size=(enc.shape[1], 1)) * 2 - 1
            enc = enc * flips.astype(enc.dtype)
        return enc.reshape(enc.shape[0], -1)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        item = dict(self.records[index])
        if self.include_node_mask:
            # graph_dataset.py:33-35
            item["node_mask"] = np.ones(int(item["num_nodes"]), np.uint8)
        if self.svd:
            item["svd_encodings"] = self._svd_item(index)
        if self.structural:
            # structural_dataset.py:59-72
            nf, dist, ef = structural_features(
                item["num_nodes"],
                item.pop("edges"),
                item.pop("node_features"),
                item.pop("edge_features"),
            )
            item["node_features"] = nf
            item["distance_matrix"] = dist
            item["feature_matrix"] = ef
        return item

    def max_batch(self, batch_size: int, collate_fn: Callable = collate_graphs):
        """graph_dataset.py:80-81 — the largest-graph batch, used by the
        reference to pre-trigger the worst-case compile."""
        idx = int(
            np.argmax([int(r["num_nodes"]) for r in self.records])
        )
        return collate_fn([self[idx]] * batch_size)
