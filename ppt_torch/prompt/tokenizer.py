"""CLIP byte-pair-encoding tokenizer (host side, numpy outputs).

A copy of ``ppt_tpu/prompt/tokenizer.py`` for the port, which imports
nothing of the JAX package: OpenAI CLIP's SimpleTokenizer with the
49408-token ``bpe_simple_vocab_16e6`` table (shipped in
``ppt_torch/assets``), lowercased input, ``</w>`` end-of-word marker,
<|startoftext|>/<|endoftext|> specials and a fixed 77-token context.

Without the ``regex`` package the splitter falls back to ``re`` with the
Unicode classes spelled in ``re``'s terms (letters ``[^\\W\\d_]``,
numbers ``\\d``), which gives the same ids for the class names and
prompts the system uses.
"""

from __future__ import annotations

import functools
import gzip
import html
import os
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np

try:
    import ftfy

    _HAS_FTFY = True
except ImportError:  # pragma: no cover
    _HAS_FTFY = False

# GPT-2 style splitter used by CLIP, in ``regex``'s terms and in ``re``'s
REGEX_PATTERN = (
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
    r"|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"
)
RE_PATTERN = (
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
    r"|[^\W\d_]+|\d|(?:[^\s\w]|_)+"
)

try:
    import regex as _re

    _TOKEN_PATTERN = REGEX_PATTERN
except ImportError:  # pragma: no cover
    import re as _re

    _TOKEN_PATTERN = RE_PATTERN

VOCAB_SIZE = 49408
CONTEXT_LENGTH = 77

_DEFAULT_BPE_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "assets", "bpe_simple_vocab_16e6.txt.gz"
)


@functools.lru_cache()
def _byte_unicode_table() -> Dict[int, str]:
    """GPT-2's reversible byte -> printable-unicode mapping."""
    printable = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    table = {b: chr(b) for b in printable}
    offset = 0
    for b in range(256):
        if b not in table:
            table[b] = chr(256 + offset)
            offset += 1
    return table


def _clean_text(text: str) -> str:
    if _HAS_FTFY:
        text = ftfy.fix_text(text)
    text = html.unescape(html.unescape(text))
    return _re.sub(r"\s+", " ", text).strip()


class ClipTokenizer:
    """BPE tokenizer with the CLIP merge table. ``encode`` returns raw BPE
    ids; calling the instance returns ``[n, 77]`` int32 with SOT/EOT."""

    def __init__(self, bpe_path: str = _DEFAULT_BPE_PATH, pattern: str = _TOKEN_PATTERN,
                 re_module=_re):
        self._byte_enc = _byte_unicode_table()
        self._byte_dec = {v: k for k, v in self._byte_enc.items()}
        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        n_merges = VOCAB_SIZE - 2 * 256 - 2
        merges: List[Tuple[str, str]] = [tuple(line.split()) for line in lines[1:1 + n_merges]]
        base = list(self._byte_enc.values())
        vocab = base + [tok + "</w>" for tok in base]
        vocab += ["".join(pair) for pair in merges]
        vocab += ["<|startoftext|>", "<|endoftext|>"]
        if len(vocab) != VOCAB_SIZE:
            raise ValueError(f"{bpe_path}: vocabulary of {len(vocab)} != {VOCAB_SIZE}")
        self.encoder: Dict[str, int] = {tok: i for i, tok in enumerate(vocab)}
        self.decoder: Dict[int, str] = {i: tok for tok, i in self.encoder.items()}
        self._merge_rank: Dict[Tuple[str, str], int] = {p: i for i, p in enumerate(merges)}
        self._cache: Dict[str, Tuple[str, ...]] = {}
        self._pattern = re_module.compile(pattern, re_module.IGNORECASE)

    @property
    def sot_token(self) -> int:
        return self.encoder["<|startoftext|>"]

    @property
    def eot_token(self) -> int:
        return self.encoder["<|endoftext|>"]

    def _apply_bpe(self, token: str) -> Tuple[str, ...]:
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        parts: List[str] = list(token[:-1]) + [token[-1] + "</w>"]
        while len(parts) > 1:
            best_rank, best_i = None, -1
            for i in range(len(parts) - 1):
                r = self._merge_rank.get((parts[i], parts[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_rank is None:
                break
            pair = (parts[best_i], parts[best_i + 1])
            merged = pair[0] + pair[1]
            out: List[str] = []
            i = 0
            while i < len(parts):
                if i < len(parts) - 1 and (parts[i], parts[i + 1]) == pair:
                    out.append(merged)
                    i += 2
                else:
                    out.append(parts[i])
                    i += 1
            parts = out
        result = tuple(parts)
        self._cache[token] = result
        return result

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        text = _clean_text(text).lower()
        for tok in self._pattern.findall(text):
            mapped = "".join(self._byte_enc[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[piece] for piece in self._apply_bpe(mapped))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.decoder[int(i)] for i in ids)
        raw = bytearray(self._byte_dec[ch] for ch in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")

    def __call__(self, texts: Union[str, Sequence[str]],
                 context_length: int = CONTEXT_LENGTH) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        result = np.zeros((len(texts), context_length), dtype=np.int32)
        for i, text in enumerate(texts):
            ids = ([self.sot_token] + self.encode(text) + [self.eot_token])[:context_length]
            result[i, : len(ids)] = ids
        return result
