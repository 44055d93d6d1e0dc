"""Molecule and protein datasets from the openpoints capability tier.

Counterpart of ``ppt_tpu/data/molecules.py``, numpy as there (references
in the upstream tree, ``openpoints/dataset/``):

  - ``atom3d/psr.py:7-37``: AtomPSR, protein structures from atom3d LMDB
    shards, atoms as point clouds with one-hot element features
    (``Atom2Points``) and the GDT-TS score as the regression target;
  - ``molhiv/``, ``molpcba/``, ``pcqm4m*/``: the OGB graph datasets.

:func:`atoms_to_points` is the Atom2Points transform itself: element
symbols one-hot over the 18 protein atom types (unknowns in the last
bucket), coordinates as they are, a float label. :func:`load_atom_psr`
reads the shards through the ``atom3d`` package, which is not installed,
and raises ImportError naming it; ``items=`` injects records already read.
:func:`load_ogb_graphs` is the OGB entry point, the port's
:class:`ppt_torch.data.graphs.OGBGraphDataset`.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

# psr.py:8 — 18 protein atom types; unknown elements hit the last bucket
PROT_ATOMS = [
    "C", "H", "O", "N", "S", "P", "ZN", "NA", "FE", "CA", "MN", "NI",
    "CO", "MG", "CU", "CL", "SE", "F",
]


def one_of_k_encoding_unk(x, allowable: Sequence) -> List[bool]:
    """(psr.py:10-14): 1-hot with unknowns mapped to the last element."""
    if x not in allowable:
        x = allowable[-1]
    return [x == s for s in allowable]


def atoms_to_points(
    xyz: np.ndarray, elements: Sequence[str], label: float
) -> Dict[str, np.ndarray]:
    """``Atom2Points`` (psr.py:17-30) without the pandas dependency:
    (atom coordinates, element symbols, gdt_ts score) -> point-cloud
    sample. Features come out channels-LAST ([N, 18]; the reference
    transposes to channels-first for torch convs)."""
    pos = np.asarray(xyz, np.float32)
    feats = np.array(
        [one_of_k_encoding_unk(e, PROT_ATOMS) for e in elements],
        dtype=np.float32,
    )
    return {"pos": pos, "features": feats, "label": np.float32(label)}


def load_atom_psr(data_dir: str, split: str, items=None):
    """AtomPSR (psr.py:33-37): atom3d LMDB shards under
    ``<data_dir>/<split>``. Requires the ``atom3d`` package for the
    shard reader; ``items`` injects an already-read iterable of
    atom3d-shaped records (``{"atoms": frame, "scores": {"gdt_ts": f}}``
    where ``frame[["x","y","z"]].to_numpy()`` / ``frame["element"]``
    work) — the whole transform pipeline downstream of LMDB is then
    exercised dependency-free."""
    assert split in ("train", "val", "test")
    if items is None:  # pragma: no cover - env dependent
        try:
            from atom3d.datasets import LMDBDataset  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "AtomPSR needs the 'atom3d' package (LMDB shard reader), "
                "not available in this environment"
            ) from e
        import os

        items = LMDBDataset(os.path.join(data_dir, split))
    out = []
    for item in items:
        atoms = item["atoms"]
        out.append(
            atoms_to_points(
                atoms[["x", "y", "z"]].to_numpy(),
                list(atoms["element"]),
                item["scores"]["gdt_ts"],
            )
        )
    return out


def load_ogb_graphs(name: str, *args, **kwargs):
    """molhiv / molpcba / pcqm4m(v2): OGB graph-transformer datasets
    (``openpoints/dataset/graph_dataset/`` + per-set ``data.py``).
    Delegates to :class:`ppt_torch.data.graphs.OGBGraphDataset` — the
    transform pipeline is dependency-free (inject ``records=``); only
    the raw OGB readers gate on the absent ogb/rdkit packages and raise
    ImportError naming them."""
    from ppt_torch.data.graphs import OGBGraphDataset

    return OGBGraphDataset(name, *args, **kwargs)
