"""Hydra-style config composition over `configs/` (port of
`diffmusic_tpu/config.py`: `DotDict`, `_deep_merge`, `compose`).

The JAX package reads YAML with PyYAML; the port reads it with `load_yaml`,
a reader of the subset that the files under `configs/` use, with PyYAML's
(YAML 1.1) scalar rules, so both read the same values: block mappings and
`- ` lists by indentation, `# comments`, and scalars -- int, float, bool
(`true`, `False`, `yes`, `off`, ...), null (`null`, `~`, empty) and bare or
quoted strings. As in PyYAML, a float needs a dot: `1e-4` is the string
"1e-4" (a caller converts it with `float`). Anything outside the subset
(flow collections, anchors, tags, block scalars, documents) raises.
"""

import copy
import re
from pathlib import Path
from typing import Any, Dict, List, Optional


class DotDict(dict):
    """dict with attribute access, recursively (OmegaConf-lite)."""

    def __getattr__(self, name: str) -> Any:
        try:
            v = self[name]
        except KeyError as e:
            raise AttributeError(name) from e
        return v

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    @classmethod
    def wrap(cls, obj):
        if isinstance(obj, dict):
            return cls({k: cls.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [cls.wrap(v) for v in obj]
        return obj


# ------------------------------------------------------------------- YAML
# PyYAML's implicit resolvers (yaml/resolver.py), less sexagesimal numbers
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_NULL = re.compile(r"^(?:~|null|Null|NULL)?$")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_SEXAGESIMAL = re.compile(r"^[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?$")
_UNSUPPORTED = tuple("[]{}&*!|>%@`")


def _int(v: str) -> int:
    v = v.replace("_", "")
    sign = -1 if v[0] == "-" else 1
    v = v.lstrip("+-")
    if v.startswith("0b"):
        return sign * int(v[2:], 2)
    if v.startswith("0x"):
        return sign * int(v[2:], 16)
    if len(v) > 1 and v[0] == "0":
        return sign * int(v, 8)
    return sign * int(v)


def _float(v: str) -> float:
    v = v.replace("_", "").lower()
    sign = -1.0 if v[0] == "-" else 1.0
    v = v.lstrip("+-")
    if v == ".inf":
        return sign * float("inf")
    if v == ".nan":
        return float("nan")
    return sign * float(v)


def parse_scalar(text: str):
    """One plain or quoted YAML scalar, resolved as PyYAML resolves it."""
    v = text.strip()
    if len(v) >= 2 and v[0] == v[-1] == "'":
        return v[1:-1].replace("''", "'")
    if len(v) >= 2 and v[0] == v[-1] == '"':
        return re.sub(r'\\(["\\nt])', lambda m: {"n": "\n", "t": "\t"}.get(m[1], m[1]),
                      v[1:-1])
    if v[:1] in ("'", '"') or v.startswith(_UNSUPPORTED) or v in ("-", "---", "..."):
        raise ValueError(f"YAML outside the supported subset: {text!r}")
    if _NULL.match(v):
        return None
    if _BOOL.match(v):
        return v.lower() in ("yes", "true", "on")
    if _INT.match(v):
        return _int(v)
    if _FLOAT.match(v):
        return _float(v)
    if _SEXAGESIMAL.match(v):
        raise ValueError(f"YAML outside the supported subset (sexagesimal): {text!r}")
    return v


def _strip_comment(line: str) -> str:
    """The line without a `#` comment (at the start, or after a space and
    outside quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            quote = None if ch == quote else quote
        elif ch in ("'", '"') and (i == 0 or line[i - 1] in " :-"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _split_pair(text: str):
    """'key: value' or 'key:' -> (key, value text), else None."""
    m = re.match(r"^([^'\"\s:][^:]*?|'[^']*'|\"[^\"]*\"):(?:\s+(.*))?$", text)
    if m is None:
        return None
    return parse_scalar(m[1]), (m[2] or "").strip()


class _Lines:
    def __init__(self, text: str):
        self.items = []
        for n, raw in enumerate(text.splitlines(), 1):
            if "\t" in raw[:len(raw) - len(raw.lstrip())]:
                raise ValueError(f"YAML line {n}: tab indentation")
            line = _strip_comment(raw).rstrip()
            if line.strip():
                self.items.append((len(line) - len(line.lstrip(" ")), line.strip(), n))
        self.i = 0

    def peek(self):
        return self.items[self.i] if self.i < len(self.items) else None


def _is_item(content: str) -> bool:
    return content == "-" or content.startswith("- ")


def _block(lines: _Lines, indent: int):
    first = lines.peek()
    if _is_item(first[1]):
        return _sequence(lines, indent)
    return _mapping(lines, indent)


def _value(lines: _Lines, text: str, indent: int):
    """A pair's value: inline text, else the block indented under it (a list
    may also sit at the key's own indentation), else null."""
    if text:
        return parse_scalar(text)
    nxt = lines.peek()
    if nxt is not None and (nxt[0] > indent or (nxt[0] == indent and _is_item(nxt[1]))):
        return _block(lines, nxt[0])
    return None


def _mapping(lines: _Lines, indent: int) -> Dict:
    out: Dict = {}
    while True:
        line = lines.peek()
        if line is None or line[0] < indent:
            return out
        if line[0] > indent or _is_item(line[1]):
            raise ValueError(f"YAML line {line[2]}: unexpected indentation")
        _, content, n = line
        lines.i += 1
        pair = _split_pair(content)
        if pair is None:
            raise ValueError(f"YAML line {n}: expected 'key: value', got {content!r}")
        key, text = pair
        out[key] = _value(lines, text, indent)


def _sequence(lines: _Lines, indent: int) -> List:
    out: List = []
    while True:
        line = lines.peek()
        if line is None or line[0] < indent or not _is_item(line[1]):
            if line is not None and line[0] > indent:
                raise ValueError(f"YAML line {line[2]}: unexpected indentation")
            return out
        lines.i += 1
        item = line[1][1:].strip()
        if not item:
            nxt = lines.peek()
            out.append(_block(lines, nxt[0]) if nxt is not None and nxt[0] > indent
                       else None)
        elif _is_item(item) or _split_pair(item) is not None:
            # a list or mapping that starts on the dash's line: its first
            # line is the rest of this one, at the column the rest starts
            col = line[0] + len(line[1]) - len(item)
            lines.i -= 1
            lines.items[lines.i] = (col, item, line[2])
            out.append(_block(lines, col))
        else:
            out.append(parse_scalar(item))


def load_yaml(text: str):
    """A YAML document of the supported subset -> dicts, lists and scalars
    (None for an empty document)."""
    lines = _Lines(text)
    if lines.peek() is None:
        return None
    node = _block(lines, lines.peek()[0])
    if lines.peek() is not None:
        raise ValueError(f"YAML line {lines.peek()[2]}: unexpected indentation")
    return node


def _load_yaml(path: Path) -> Dict:
    return load_yaml(Path(path).read_text()) or {}


# ---------------------------------------------------------------- compose
def _deep_merge(base: Dict, extra: Dict) -> Dict:
    out = copy.deepcopy(base)
    for k, v in (extra or {}).items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def compose(config_name: str, overrides: Optional[List[str]] = None,
            config_path: str = "configs") -> DotDict:
    """Compose `configs/<config_name>.yaml` with its defaults + CLI overrides.

    overrides: ["data=moises", "model=musicldm", ...] select group files;
    dotted "a.b=c" overrides set leaf values (through `parse_scalar`).
    """
    root = Path(config_path)
    raw = _load_yaml(root / f"{config_name}.yaml")
    defaults = raw.pop("defaults", [])

    group_choice: Dict[str, str] = {}
    order: List[str] = []
    self_pos = len(defaults)
    for i, d in enumerate(defaults):
        if d == "_self_":
            self_pos = i
            continue
        if isinstance(d, dict):
            (group, name), = d.items()
            group_choice[group] = name
            order.append(group)

    leaf_overrides: List[str] = []
    for ov in overrides or []:
        k, _, v = ov.partition("=")
        if k in group_choice and "." not in k:
            group_choice[k] = v
        else:
            leaf_overrides.append(ov)

    composed: Dict = {}
    merged_self = False
    for i, group in enumerate(order):
        if not merged_self and i >= self_pos:
            composed = _deep_merge(composed, raw)
            merged_self = True
        gcfg = _load_yaml(root / group / f"{group_choice[group]}.yaml")
        composed = _deep_merge(composed, {group: gcfg})
    if not merged_self:
        composed = _deep_merge(composed, raw)

    for ov in leaf_overrides:
        k, _, v = ov.partition("=")
        node = composed
        parts = k.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = parse_scalar(v)

    return DotDict.wrap(composed)
