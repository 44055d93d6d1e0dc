"""One module a model family: its weight layout, its plain reference, the
ranges the trace attributes kernels by, and the benchmark's own work
counts. A configuration file names its family under ``arch``.

The counts are products only, two FLOPs a multiply-add, of the work the
model needs at the configuration's shapes: no recomputation, no weight
gradient of a frozen layer; elementwise work is left to the rooflines'
bytes. ``tests/test_bench_counts.py`` holds them equal to
``FlopCounterMode`` over the plain references.
"""

import dataclasses
from typing import Sequence, Tuple

PEAK_BF16 = 989e12  # H100 SXM dense bf16, FLOP/s
PEAK_F32 = 67e12  # H100 SXM float32 outside the tensor cores, FLOP/s
PEAK_BYTES = 3.35e12  # HBM3, bytes/s


@dataclasses.dataclass(frozen=True)
class Piece:
    """A piece of work the port's kernels carry, per unit (step or batch):
    where its kernels are found in the trace (``("range", name)``, its
    ``("range_only", name)`` without nested ranges, or ``("kernels",
    substrings)``), its operations against ``peak`` and its bytes read and
    written once."""

    name: str
    select: Tuple[Tuple[str, object], ...]
    ops: float
    peak: float
    bytes: float

    @property
    def bound_s(self) -> float:
        return max(self.ops / self.peak, self.bytes / PEAK_BYTES)


def text_macs(cfg, prompts: int, length: int, backward: bool) -> float:
    """The text tower over ``prompts`` prompts of ``length`` positions and
    its projection; with ``backward`` the input gradients instead (as many
    products in each Linear, twice the attention's)."""
    t = cfg["text"]
    W = t["width"]
    linear = prompts * length * 12 * W * W * t["layers"]
    attn = prompts * 2 * length * length * W * t["layers"]
    proj = prompts * W * t["embed_dim"]
    return linear + (2 * attn if backward else attn) + proj


def prompt_length(cfg) -> int:
    """Positions up to the last EOT of the prompt set (the reference's tokens)."""
    from h100_bench.reference.clip_text import prompt_tokens

    tokens, _ = prompt_tokens(cfg["classnames"], cfg["prompt"]["n_ctx"])
    return int(tokens.argmax(-1).max()) + 1


def logits_macs(cfg, clouds: int, feat_dims: int) -> float:
    E = cfg["text"]["embed_dim"]
    return clouds * (feat_dims * E + E * len(cfg["classnames"]))


def ranges_of(model, backward_text: bool) -> Sequence[Tuple[str, object, bool]]:
    """(range name, module, with backward) for the trace: the point tower
    and each of its children, the text tower."""
    out = [("point_tower", model.point_encoder, False)]
    out += [(f"point_tower.{n}", m, False) for n, m in model.point_encoder.named_children()]
    out.append(("text_tower", model.text, backward_text))
    return out
