"""Weight bridge: the JAX package's variables -> the port's ``state_dict``.

``from_jax(params, batch_stats, model)`` takes the flax variable trees as
nested dicts of numpy arrays and returns a ``state_dict`` for ``model``.
Rules, leaf by leaf:

- LayerNorm / BatchNorm ``scale`` -> ``weight``, ``bias`` -> ``bias``; the
  text tower's ``LayerNormF32`` wraps its LayerNorm as ``ln_*/norm/``,
  whose ``norm`` level the port does not have;
- ``Embed`` ``embedding`` -> ``weight``;
- ``batch_stats`` ``mean``/``var`` -> ``running_mean``/``running_var``;
- every other leaf (Dense ``kernel`` ``[in, out]``,
  ``positional_embedding``, ``text_projection``, ``cls_token``,
  ``pc_projection``, ``logit_scale``, ...) keeps its name and shape.

It raises on a leaf that has no counterpart in the port and on a port
parameter or buffer that no leaf sets.

``train_state_from_jax(payload, state)`` carries a reference training run
across: the payload of ``ppt_tpu/train/checkpoint.py:38-43`` (trainable
partition, ``optax.adamw`` state, batch statistics, step) as numpy trees
into the port's ``TrainState``, by the same leaf rules.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()) -> Iterator[
        Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v)


def _port_key(path: Tuple[str, ...], stats: bool) -> str:
    """The torch key of one flax leaf path."""
    *mods, leaf = path
    if len(mods) >= 2 and mods[-1] == "norm" and mods[-2].startswith("ln_"):
        mods = mods[:-1]  # LayerNormF32 -> its inner nn.LayerNorm
    if stats:
        names = {"mean": "running_mean", "var": "running_var"}
        if leaf not in names:
            raise ValueError(f"from_jax: unknown batch_stats leaf {'/'.join(path)}")
        return ".".join(mods + [names[leaf]])
    if leaf in ("scale", "embedding"):
        return ".".join(mods + ["weight"])
    return ".".join(mods + [leaf])


def from_jax(params: Mapping[str, Any], batch_stats: Mapping[str, Any],
             model: nn.Module) -> Dict[str, torch.Tensor]:
    """Map every leaf of the flax variables onto ``model``'s state_dict."""
    want = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for tree, stats in ((params, False), (batch_stats or {}, True)):
        for path, arr in _flatten(tree):
            key = _port_key(path, stats)
            if key not in want:
                raise ValueError(f"from_jax: leaf {'/'.join(path)} (-> {key}) is left over: "
                                 "the port has no such parameter")
            if key in out:
                raise ValueError(f"from_jax: two leaves map to {key}")
            t = torch.from_numpy(np.array(arr, order="C", copy=True))
            if tuple(t.shape) != tuple(want[key].shape):
                raise ValueError(f"from_jax: {'/'.join(path)} has shape {tuple(t.shape)}, "
                                 f"port {key} wants {tuple(want[key].shape)}")
            out[key] = t.to(want[key].dtype)
    unset = sorted(set(want) - set(out))
    if unset:
        raise ValueError(f"from_jax: port parameters left unset: {unset}")
    return out


def _find_adam(tree: Any) -> Mapping[str, Any]:
    """The ``ScaleByAdamState`` (count, mu, nu) inside an optax state given
    as nested mappings/sequences (a restored msgpack keys tuples "0", "1", ...)."""
    if isinstance(tree, Mapping):
        if {"count", "mu", "nu"} <= set(tree):
            return tree
        children = tree.values()
    elif isinstance(tree, (tuple, list)):
        children = tree
    else:
        return {}
    for child in children:
        found = _find_adam(child)
        if found:
            return found
    return {}


def train_state_from_jax(payload: Mapping[str, Any], state):
    """Load the reference's checkpoint payload ``{"trainable", "opt_state",
    "batch_stats", "step"}`` (numpy trees) into ``state``
    (``ppt_torch.train.trainer.TrainState``) in place."""
    from ppt_torch.train.checkpoint import restore_payload

    adam = _find_adam(payload["opt_state"])
    if not adam:
        raise ValueError("train_state_from_jax: no adam state (count, mu, nu) in opt_state")

    def leaves(tree, stats=False):
        return {_port_key(path, stats): torch.from_numpy(np.array(arr, order="C", copy=True))
                for path, arr in _flatten(tree)}

    return restore_payload({
        "trainable": leaves(payload["trainable"]),
        "opt_state": {"count": int(np.asarray(adam["count"])), "mu": leaves(adam["mu"]),
                      "nu": leaves(adam["nu"])},
        "batch_stats": leaves(payload["batch_stats"], stats=True),
        "step": int(np.asarray(payload["step"])),
    }, state)
