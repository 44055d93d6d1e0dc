"""CLIP's text tower with CoOp's learnable prompt tokens, written plainly.

- Tokens: OpenAI CLIP's byte-pair encoding over its 49408-token table
  (the raw ``bpe_simple_vocab_16e6.txt.gz`` that CLIP publishes), lower
  case, ``<|startoftext|>``/``<|endoftext|>``, 77 positions.
- Prompts (CoOp, Zhou et al. 2022): the text ``"X X ... X <name>."`` with
  ``n_ctx`` placeholders is tokenised and embedded; with the class name in
  the "middle" the sequence is ``[SOT][ctx 1st half][name][ctx 2nd
  half][. EOT ...]``, the ``ctx`` rows being the learnable tokens.
- Tower (Radford et al. 2021): learned positions, pre-norm residual blocks
  (LayerNorm eps 1e-5, causal multi-head attention with one fused qkv
  projection, QuickGELU MLP), a final LayerNorm, the state at the EOT
  token (the largest id of the raw tokens) projected and L2-normalised.

The tower is causal and pools at EOT, so it runs over the positions up to
the last EOT of the prompt set; later positions cannot reach the output.
Weights are read from a dict in the layout the benchmark makes them
(``Dense`` kernels ``[in, out]``; see ``h100_bench/weights.py``).
"""

from __future__ import annotations

import functools
import gzip
import html
import re
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import torch

from h100_bench.reference.precision import Products

VOCAB_FILE = (Path(__file__).resolve().parents[2] / "ppt_torch" / "assets"
              / "bpe_simple_vocab_16e6.txt.gz")
CONTEXT = 77
# CLIP's splitter, with the unicode classes in ``re``'s terms
_SPLIT = re.compile(r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
                    r"|[^\W\d_]+|\d|(?:[^\s\w]|_)+", re.IGNORECASE)


def _bytes_to_unicode() -> Dict[int, str]:
    keep = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1))
            + list(range(ord("\xae"), ord("\xff") + 1)))
    table, extra = {b: chr(b) for b in keep}, 0
    for b in range(256):
        if b not in table:
            table[b] = chr(256 + extra)
            extra += 1
    return table


class BpeTokenizer:
    def __init__(self, path: Path = VOCAB_FILE):
        self.byte_map = _bytes_to_unicode()
        with gzip.open(path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = [tuple(m.split()) for m in lines[1:49152 - 256 - 2 + 1]]
        vocab = list(self.byte_map.values())
        vocab = vocab + [v + "</w>" for v in vocab] + ["".join(m) for m in merges]
        vocab += ["<|startoftext|>", "<|endoftext|>"]
        self.ids = {tok: i for i, tok in enumerate(vocab)}
        self.ranks = {m: i for i, m in enumerate(merges)}
        self.sot, self.eot = self.ids["<|startoftext|>"], self.ids["<|endoftext|>"]
        self._cache: Dict[str, Tuple[str, ...]] = {}

    def _bpe(self, word: str) -> Tuple[str, ...]:
        if word in self._cache:
            return self._cache[word]
        parts = list(word[:-1]) + [word[-1] + "</w>"]
        while len(parts) > 1:
            rank, first = min((self.ranks.get(p, 1 << 30), i)
                              for i, p in enumerate(zip(parts, parts[1:])))
            if rank == 1 << 30:
                break
            pair = (parts[first], parts[first + 1])
            merged, i = [], 0
            while i < len(parts):
                if i + 1 < len(parts) and (parts[i], parts[i + 1]) == pair:
                    merged.append(parts[i] + parts[i + 1])
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged
        self._cache[word] = tuple(parts)
        return self._cache[word]

    def encode(self, text: str) -> List[int]:
        text = re.sub(r"\s+", " ", html.unescape(html.unescape(text))).strip().lower()
        out = []
        for word in _SPLIT.findall(text):
            mapped = "".join(self.byte_map[b] for b in word.encode("utf-8"))
            out += [self.ids[p] for p in self._bpe(mapped)]
        return out

    def __call__(self, texts: Sequence[str]) -> torch.Tensor:
        """[n, 77] int64 with SOT and EOT, zero padded."""
        out = torch.zeros(len(texts), CONTEXT, dtype=torch.long)
        for i, t in enumerate(texts):
            ids = [self.sot] + self.encode(t) + [self.eot]
            out[i, :len(ids)] = torch.tensor(ids[:CONTEXT])
        return out


@functools.lru_cache(maxsize=None)
def tokenizer() -> BpeTokenizer:
    return BpeTokenizer()


def prompt_tokens(classnames: Sequence[str], n_ctx: int) -> Tuple[torch.Tensor, List[int]]:
    """The raw tokens of ``"X ... X <name>."`` [C, 77] and each name's length."""
    tok = tokenizer()
    names = [n.replace("_", " ") for n in classnames]
    tokens = tok([" ".join(["X"] * n_ctx) + f" {n}." for n in names])
    return tokens, [len(tok.encode(n)) for n in names]


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w + b


def attention(P: Products, q, k, v, heads: int, causal: bool) -> torch.Tensor:
    """[B, L, D] each -> [B, L, D]: softmax(q k^T / sqrt(d)) v per head."""
    B, L, D = q.shape
    hd = D // heads
    q, k, v = (t.reshape(B, L, heads, hd).transpose(1, 2) for t in (q, k, v))
    s = P.mm(q, k.transpose(-1, -2)) / hd ** 0.5
    if causal:
        s = s.masked_fill(torch.ones(L, L, dtype=torch.bool, device=s.device).triu(1),
                          float("-inf"))
    return P.mm(torch.softmax(s, -1), v).transpose(1, 2).reshape(B, L, D)


class TextTower:
    """The prompt splice and the tower over ``W`` (names as the benchmark
    makes them: ``text.*``, ``prompt_learner.learnable_tokens``)."""

    def __init__(self, W: Dict[str, torch.Tensor], classnames: Sequence[str], n_ctx: int,
                 layers: int, heads: int, P: Products):
        self.W, self.layers, self.heads, self.P, self.n_ctx = W, layers, heads, P, n_ctx
        dev = W["text.positional_embedding"].device
        tokens, self.name_lens = prompt_tokens(classnames, n_ctx)
        self.tokens = tokens.to(dev)
        self.eot = self.tokens.argmax(-1)
        self.length = int(self.eot.max()) + 1

    def spliced(self, ctx: torch.Tensor) -> torch.Tensor:
        """[C, L, width]: CoOp's "middle" prompts with the context rows ``ctx``."""
        emb = self.W["text.token_embedding.weight"][self.tokens]
        half, n = self.n_ctx // 2, self.n_ctx
        rows = []
        for i, ln in enumerate(self.name_lens):
            suffix = emb[i, 1 + n:]
            rows.append(torch.cat([emb[i, :1], ctx[:half], suffix[:ln], ctx[half:],
                                   suffix[ln:]], 0))
        return torch.stack(rows)[:, :self.length]

    def __call__(self, ctx: torch.Tensor) -> torch.Tensor:
        """L2-normalised prompt embeddings [C, embed_dim]."""
        W, P = self.W, self.P
        x = self.spliced(ctx) + W["text.positional_embedding"][:self.length]
        for i in range(self.layers):
            p = f"text.block_{i}."
            h = layer_norm(x, W[p + "ln_1.weight"], W[p + "ln_1.bias"], 1e-5)
            qkv = P.mm(h, W[p + "attn.in_proj.kernel"]) + W[p + "attn.in_proj.bias"]
            a = attention(P, *qkv.chunk(3, -1), self.heads, causal=True)
            x = x + P.mm(a, W[p + "attn.out_proj.kernel"]) + W[p + "attn.out_proj.bias"]
            h = layer_norm(x, W[p + "ln_2.weight"], W[p + "ln_2.bias"], 1e-5)
            h = P.mm(h, W[p + "c_fc.kernel"]) + W[p + "c_fc.bias"]
            h = h * torch.sigmoid(1.702 * h)
            x = x + P.mm(h, W[p + "c_proj.kernel"]) + W[p + "c_proj.bias"]
        x = layer_norm(x, W["text.ln_final.weight"], W["text.ln_final.bias"], 1e-5)
        pooled = x[torch.arange(x.shape[0], device=x.device), self.eot]
        e = P.mm(pooled, W["text.text_projection"])
        return e / e.norm(dim=-1, keepdim=True)
