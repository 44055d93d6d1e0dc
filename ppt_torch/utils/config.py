"""Experiment configs: YAML files with ``_base_`` inheritance, dotted
``--set`` overrides, the dataset catalog, and their projection onto
``TaskArgs``.

Counterpart of ``ppt_tpu/utils/config.py``. The reference reads its files
with ``yaml.safe_load``; the port brings its own reader for the subset of
YAML the repo's files use, so it needs no YAML package:

- ``#`` comments, block mappings nested by indentation, block sequences
  (``- item``, also of mappings), flow sequences (``[a, 'b', [1, 2]]``),
  plain, single-quoted and double-quoted scalars, one document (a leading
  ``---`` is allowed);
- plain scalars resolve as ``yaml.safe_load`` resolves them (YAML 1.1):
  ``yes``/``no``/``on``/``off`` in three capitalisations are booleans,
  ``~``, ``null`` and the empty scalar are None, ``017`` is octal, ``0x1f``,
  ``0b101``, ``1_000`` and ``190:20:30`` are ints, a float needs a dot
  (``3.0e-3`` is a float, ``1e-3`` and ``1.0e5`` are strings, ``0o17`` is a
  string), ``.inf`` and ``.nan`` are floats;
- anything else raises a ``ValueError`` that names the construct: anchors,
  aliases, tags, block scalars (``|``, ``>``), flow mappings, complex keys,
  merge keys, directives, several documents, multi-line plain scalars, tab
  indentation, and timestamps (which PyYAML turns into ``date``).
"""

from __future__ import annotations

import copy
import dataclasses
import os
import re
from typing import Any, Dict, List, Tuple

CONFIG_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "configs")

# PyYAML's implicit resolvers (yaml/resolver.py), in the order it tries them
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": " ", "P": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
# first characters of a plain scalar that YAML gives another meaning
_INDICATORS = {"&": "anchor", "*": "alias", "!": "tag", "|": "block scalar",
               ">": "block scalar", "{": "flow mapping", "?": "complex key",
               "@": "reserved indicator '@'", "`": "reserved indicator '`'",
               "%": "directive"}


def _sexagesimal(value: str, cast) -> Any:
    total, base = cast(0), 1
    for part in reversed(value.split(":")):
        total += cast(part) * base
        base *= 60
    return total


def resolve_plain(text: str) -> Any:
    """A plain (unquoted) scalar as ``yaml.safe_load`` resolves it."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _FLOAT.match(text):
        value = text.replace("_", "").lower()
        sign = -1.0 if value[0] == "-" else 1.0
        value = value[1:] if value[0] in "+-" else value
        if value == ".inf":
            return sign * float("inf")
        if value == ".nan":
            return float("nan")
        return sign * (_sexagesimal(value, float) if ":" in value else float(value))
    if _INT.match(text):
        value = text.replace("_", "")
        sign = -1 if value[0] == "-" else 1
        value = value[1:] if value[0] in "+-" else value
        if value == "0":
            return 0
        if value.startswith("0b"):
            return sign * int(value[2:], 2)
        if value.startswith("0x"):
            return sign * int(value[2:], 16)
        if value[0] == "0":
            return sign * int(value, 8)
        return sign * (_sexagesimal(value, int) if ":" in value else int(value))
    if _TIMESTAMP.match(text):
        raise ValueError(f"YAML timestamp {text!r} is not supported (PyYAML would make it a "
                         "date); quote it to keep a string")
    if text == "<<":
        raise ValueError("YAML merge key '<<' is not supported")
    if text == "=":
        raise ValueError("YAML value key '=' is not supported")
    return text


class _Reader:
    """One YAML document of the supported subset, line by line."""

    def __init__(self, text: str, where: str):
        self.where = where
        self.lines: List[List] = []  # [indent, content, line number]
        started = False
        for no, raw in enumerate(text.splitlines(), 1):
            body = self._strip_comment(raw, no).rstrip()
            if not body.strip():
                continue
            stripped = body.lstrip(" ")
            if stripped.startswith("\t") or body.startswith("\t"):
                raise self.error(no, "tab indentation")
            if stripped.startswith("%"):
                raise self.error(no, "directive")
            if stripped == "---" or stripped.startswith("--- "):
                if started:
                    raise self.error(no, "several documents")
                started = True
                if stripped.strip() != "---":
                    raise self.error(no, "content after '---'")
                continue
            if stripped == "...":
                raise self.error(no, "document end marker '...'")
            started = True
            self.lines.append([len(body) - len(stripped), stripped, no])

    def error(self, no: int, what: str) -> ValueError:
        return ValueError(f"{self.where}:{no}: YAML {what} is not supported by the port's "
                          "config reader")

    def _strip_comment(self, line: str, no: int) -> str:
        quote = None
        i = 0
        while i < len(line):
            c = line[i]
            if quote == "'":
                if c == "'":
                    if i + 1 < len(line) and line[i + 1] == "'":
                        i += 1
                    else:
                        quote = None
            elif quote == '"':
                if c == "\\":
                    i += 1
                elif c == '"':
                    quote = None
            elif c in "'\"" and (i == 0 or line[i - 1] in " \t[,:-"):
                quote = c
            elif c == "#" and (i == 0 or line[i - 1] in " \t"):
                return line[:i]
            i += 1
        return line

    # -- blocks --------------------------------------------------------------

    def document(self) -> Any:
        if not self.lines:
            return None
        indent, content, no = self.lines[0]
        if not self._is_item(content) and self._split_key(content, no) is None:
            value, i = self.inline(content, no), 1  # a scalar or flow document
            self._no_continuation(i, -1)
            return value
        value, i = self.block(0, indent)
        if i < len(self.lines):
            raise self.error(self.lines[i][2], "content at a lower indentation than the "
                                               "document's first line")
        return value

    def block(self, i: int, indent: int) -> Tuple[Any, int]:
        if self._is_item(self.lines[i][1]):
            return self.sequence(i, indent)
        return self.mapping(i, indent)

    @staticmethod
    def _is_item(content: str) -> bool:
        return content == "-" or content.startswith("- ")

    def sequence(self, i: int, indent: int) -> Tuple[List, int]:
        out = []
        while i < len(self.lines) and self.lines[i][0] == indent \
                and self._is_item(self.lines[i][1]):
            _, content, no = self.lines[i]
            rest = content[1:].lstrip(" ")
            if not rest:
                if i + 1 < len(self.lines) and self.lines[i + 1][0] > indent:
                    value, i = self.block(i + 1, self.lines[i + 1][0])
                else:
                    value, i = None, i + 1
            elif self._is_item(rest) or self._split_key(rest, no) is not None:
                # "- key: v" or "- - v": the rest is a block at its own column
                self.lines[i] = [indent + len(content) - len(rest), rest, no]
                value, i = self.block(i, self.lines[i][0])
            else:
                value, i = self.inline(rest, no), i + 1
                self._no_continuation(i, indent)
            out.append(value)
        return out, i

    def mapping(self, i: int, indent: int) -> Tuple[Dict, int]:
        out: Dict[Any, Any] = {}
        while i < len(self.lines) and self.lines[i][0] == indent:
            _, content, no = self.lines[i]
            if self._is_item(content):
                raise self.error(no, "sequence item inside a mapping")
            split = self._split_key(content, no)
            if split is None:
                raise self.error(no, f"line {content!r} (neither 'key: value' nor '- item')")
            key, rest = split
            i += 1
            if rest:
                value = self.inline(rest, no)
                self._no_continuation(i, indent)
            elif i < len(self.lines) and (
                    self.lines[i][0] > indent
                    or (self.lines[i][0] == indent and self._is_item(self.lines[i][1]))):
                value, i = self.block(i, self.lines[i][0])
            else:
                value = None
            out[key] = value
        if i < len(self.lines) and self.lines[i][0] > indent:
            raise self.error(self.lines[i][2], "indentation")
        return out, i

    def _no_continuation(self, i: int, indent: int) -> None:
        if i < len(self.lines) and self.lines[i][0] > indent:
            raise self.error(self.lines[i][2], "multi-line scalar")

    def _split_key(self, content: str, no: int):
        """(key, rest) when ``content`` is ``key: rest``, else None."""
        if content[0] in "'\"":
            text, end = self.quoted(content, 0, no)
            tail = content[end:].lstrip(" ")
            if tail == ":" or tail.startswith(": "):
                return text, tail[1:].strip()
            return None
        if content[0] in _INDICATORS and content[0] not in "%":
            if content[0] == "?" and (len(content) == 1 or content[1] == " "):
                raise self.error(no, "complex key")
            return None
        if content[0] == "[":
            return None
        m = re.search(r":(?: |$)", content)
        if m is None:
            return None
        key = content[:m.start()].rstrip()
        return resolve_plain(key), content[m.end():].strip()

    # -- scalars -------------------------------------------------------------

    def inline(self, text: str, no: int) -> Any:
        """A value on one line: a flow sequence, a quoted or a plain scalar."""
        c = text[0]
        if c == "[":
            value, end = self.flow(text, 0, no)
            if text[end:].strip():
                raise self.error(no, f"text after a flow sequence: {text[end:]!r}")
            return value
        if c in "'\"":
            value, end = self.quoted(text, 0, no)
            if text[end:].strip():
                raise self.error(no, f"text after a quoted scalar: {text[end:]!r}")
            return value
        if c in _INDICATORS or (c == "-" and text.startswith("- ")):
            raise self.error(no, _INDICATORS.get(c, "sequence item as a mapping value"))
        if text.startswith("]"):
            raise self.error(no, "unmatched ']'")
        return self.plain(text, no)

    def plain(self, text: str, no: int) -> Any:
        text = text.strip()
        if re.search(r":(?: |$)", text):
            raise self.error(no, f"nested mapping on one line ({text!r})")
        return resolve_plain(text)

    def quoted(self, text: str, i: int, no: int) -> Tuple[str, int]:
        q = text[i]
        out = []
        j = i + 1
        while j < len(text):
            c = text[j]
            if q == "'" and c == "'":
                if j + 1 < len(text) and text[j + 1] == "'":
                    out.append("'")
                    j += 2
                    continue
                return "".join(out), j + 1
            if q == '"' and c == '"':
                return "".join(out), j + 1
            if q == '"' and c == "\\":
                j += 1
                if j >= len(text):
                    break
                e = text[j]
                if e in _ESCAPES:
                    out.append(_ESCAPES[e])
                elif e in _HEX_ESCAPES:
                    n = _HEX_ESCAPES[e]
                    out.append(chr(int(text[j + 1:j + 1 + n], 16)))
                    j += n
                else:
                    raise self.error(no, f"escape '\\{e}'")
                j += 1
                continue
            out.append(c)
            j += 1
        raise self.error(no, "multi-line quoted scalar")

    def flow(self, text: str, i: int, no: int) -> Tuple[List, int]:
        """A flow sequence starting at ``text[i] == '['``."""
        out: List[Any] = []
        j = i + 1
        expect_item = True
        while j < len(text):
            c = text[j]
            if c in " \t":
                j += 1
            elif c == "]":
                return out, j + 1
            elif c == ",":
                if expect_item:
                    raise self.error(no, "empty entry in a flow sequence")
                expect_item = True
                j += 1
            elif not expect_item:
                raise self.error(no, f"missing ',' in a flow sequence at {text[j:]!r}")
            elif c == "[":
                value, j = self.flow(text, j, no)
                out.append(value)
                expect_item = False
            elif c in "'\"":
                value, j = self.quoted(text, j, no)
                out.append(value)
                expect_item = False
            elif c in _INDICATORS:
                raise self.error(no, _INDICATORS[c])
            else:
                m = re.compile(r"[^,\]\[{}]*").match(text, j)
                item = m.group(0).rstrip()
                if re.search(r":(?: |$)", item):
                    raise self.error(no, "flow mapping")
                out.append(resolve_plain(item))
                j = m.end()
                expect_item = False
        raise self.error(no, "multi-line flow sequence")


def loads(text: str, where: str = "<string>") -> Any:
    """One YAML document of the supported subset -> Python values."""
    return _Reader(text, where).document()


def _merge(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    out = copy.deepcopy(base)
    for key, value in override.items():
        if key in out and isinstance(out[key], dict) and isinstance(value, dict):
            out[key] = _merge(out[key], value)
        else:
            out[key] = copy.deepcopy(value)
    return out


def load_config(path: str) -> Dict[str, Any]:
    """YAML -> dict with recursive ``_base_`` inheritance (a path or a list
    of paths, each relative to the including file)."""
    with open(path) as f:
        cfg = loads(f.read(), path) or {}
    if not isinstance(cfg, dict):
        raise ValueError(f"{path}: a config is a mapping, not {type(cfg).__name__}")
    base_spec = cfg.pop("_base_", None)
    if base_spec is None:
        return cfg
    merged: Dict[str, Any] = {}
    for base in base_spec if isinstance(base_spec, list) else [base_spec]:
        base_path = base if os.path.isabs(base) else os.path.join(os.path.dirname(path), base)
        merged = _merge(merged, load_config(base_path))
    return _merge(merged, cfg)


def apply_overrides(cfg: Dict[str, Any], overrides: List[str]) -> Dict[str, Any]:
    """Apply ``key.path=value`` strings; each value reads as a YAML
    document, as the reference's ``yaml.safe_load(raw)`` reads it."""
    out = copy.deepcopy(cfg)
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override {item!r} is not of the form key=value")
        key, raw = item.split("=", 1)
        value = loads(raw, f"--set {key}")
        node = out
        parts = key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return out


def dataset_config(name: str) -> Dict[str, Any]:
    """The catalog: ``configs/datasets/<name>.yaml``."""
    path = os.path.join(CONFIG_ROOT, "datasets", f"{name}.yaml")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no dataset config {path}")
    return load_config(path)


def config_to_args(cfg: Dict[str, Any], args):
    """Project a (nested) config onto ``args``, a ``TaskArgs``: a key that
    is one of its fields sets it; a key that is no field of the reference's
    ``TaskArgs`` either (``num_category``) is skipped, as the reference
    skips it; a reference field the port lacks raises by name. A string
    given to a numeric field raises too (YAML 1.1 reads ``1e-3`` as a
    string: write ``1.0e-3``)."""
    from ppt_torch.tasks.args import REFERENCE_FIELDS

    fields = {f.name: f for f in dataclasses.fields(args)}
    for key, value in cfg.items():
        if isinstance(value, dict):
            config_to_args(value, args)
        elif key in fields and key != "classnames":
            default = fields[key].default
            if isinstance(value, str) and isinstance(default, (int, float)) \
                    and not isinstance(default, bool):
                raise ValueError(f"config key {key!r}: {value!r} is a string under YAML 1.1, "
                                 f"the field is {type(default).__name__} (a float needs a "
                                 "dot and a signed exponent: 1.0e-3)")
            setattr(args, key, value)
        elif key in REFERENCE_FIELDS:
            raise NotImplementedError(
                f"config key {key!r} is a field of the reference's TaskArgs that the port "
                "does not have yet")
    return args
