"""The snapshots' tokenizers, read from their own files with no
`transformers`, `tokenizers`, `sentencepiece` or `regex`.

The JAX package tokenizes text prompts through transformers'
`AutoTokenizer` (`diffmusic_tpu/models/checkpoint.py::_make_hf_tokenizer`);
these readers compute the same ids and masks for the kinds the supported
snapshots carry, chosen by `tokenizer_config.json`'s `tokenizer_class`:

- RoBERTa's byte-level BPE (the CLAP tokenizer in MusicLDM's and AudioLDM2's
  `tokenizer/`), from `vocab.json` and `merges.txt`: GPT-2's byte-to-unicode
  map and pre-tokenizer split (`byte_level_split`, its `\\p{L}` / `\\p{N}`
  classes from `unicodedata`), `<s> ... </s>`;
- T5's Unigram (AudioLDM2's `tokenizer_2/`, StableAudio's `tokenizer/`), from
  `tokenizer.json` where present (its normalizer, pre-tokenizer and
  post-processor interpreted), else from `spiece.model` (`read_spiece_model`,
  a small protobuf reader) with the pipeline transformers' converter builds
  from it: sentencepiece's precompiled charsmap (`Precompiled`: a darts-clone
  double-array trie over UTF-8, applied per grapheme as `tokenizers` applies
  it), right strip, runs of spaces to one "▁", Metaspace, Viterbi over the
  pieces with consecutive unknowns fused, `</s>` appended;
- VITS's characters (AudioLDM2-TTS's `tokenizer_2/`), from `vocab.json`:
  lowercased, characters outside the vocabulary dropped, a blank between
  characters; a config that asks for `phonemize` raises ImportError at
  encoding, as transformers does without `phonemizer`.

Special tokens in the text (`added_tokens`) are split out first, with their
lstrip / rstrip. Anything these readers do not compute (another tokenizer
class, another normalizer, a byte fallback) raises instead of producing other
ids.
"""

import base64
import json
import re
import struct
import unicodedata
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

SPIECE_UNDERLINE = "▁"
VERY_LARGE_INTEGER = int(1e30)   # transformers' model_max_length when none is set


# ----------------------------------------------------------- character classes

# Unicode White_Space (the `\s` of the regex engines the tokenizers use)
_WHITE_SPACE = frozenset(chr(c) for c in [*range(0x09, 0x0E), 0x20, 0x85, 0xA0, 0x1680,
                                          *range(0x2000, 0x200B), 0x2028, 0x2029, 0x202F,
                                          0x205F, 0x3000])


def is_space(c: str) -> bool:
    return c in _WHITE_SPACE


def is_letter(c: str) -> bool:
    return unicodedata.category(c)[0] == "L"


def is_number(c: str) -> bool:
    return unicodedata.category(c)[0] == "N"


# ------------------------------------------------------------ byte-level BPE

def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's map of the 256 bytes to printable characters."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")


def byte_level_split(text: str) -> List[str]:
    """GPT-2's pre-tokenizer pattern
    `'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+`
    as a scanner: at each position the first alternative that matches,
    each greedy."""
    out, i, n = [], 0, len(text)
    other = lambda c: not (is_space(c) or is_letter(c) or is_number(c))  # noqa: E731
    while i < n:
        c = text[i]
        if c == "'":
            tail = next((t for t in _CONTRACTIONS if text.startswith(t, i + 1)), None)
            if tail is not None:
                out.append(text[i:i + 1 + len(tail)])
                i += 1 + len(tail)
                continue
        start = i + 1 if c == " " and i + 1 < n else i
        matched = False
        for cls in (is_letter, is_number, other):
            if cls(text[start]):
                j = start + 1
                while j < n and cls(text[j]):
                    j += 1
                out.append(text[i:j])
                i, matched = j, True
                break
        if matched:
            continue
        # whitespace: \s+(?!\S) gives the run back one character before a
        # non-space (if that leaves at least one), else \s+ takes it all
        j = i
        while j < n and is_space(text[j]):
            j += 1
        if j < n and j - i > 1:
            j -= 1
        out.append(text[i:j])
        i = j
    return out


class ByteLevelBPE:
    """RoBERTa's model: byte-level symbols merged by rank."""

    def __init__(self, vocab: Dict[str, int], merges: Sequence[Tuple[str, str]]):
        self.vocab = vocab
        self.ranks = {pair: r for r, pair in enumerate(merges)}
        self.byte_map = bytes_to_unicode()
        missing = [c for c in self.byte_map.values() if c not in vocab]
        if missing:
            raise ValueError(f"byte-level BPE vocabulary lacks {len(missing)} of the 256 byte "
                             f"symbols (e.g. {missing[:4]})")
        self.cache: Dict[str, List[int]] = {}

    def _bpe(self, word: str) -> List[str]:
        symbols = list(word)
        while len(symbols) > 1:
            pairs = {(a, b) for a, b in zip(symbols, symbols[1:])}
            best = min(pairs, key=lambda p: self.ranks.get(p, float("inf")))
            if best not in self.ranks:
                break
            merged, i = [], 0
            while i < len(symbols):
                if i + 1 < len(symbols) and (symbols[i], symbols[i + 1]) == best:
                    merged.append(symbols[i] + symbols[i + 1])
                    i += 2
                else:
                    merged.append(symbols[i])
                    i += 1
            symbols = merged
        return symbols

    def encode(self, text: str) -> List[int]:
        ids = []
        for word in byte_level_split(text):
            if word not in self.cache:
                mapped = "".join(self.byte_map[b] for b in word.encode("utf-8"))
                self.cache[word] = [self.vocab[s] for s in self._bpe(mapped)]
            ids += self.cache[word]
        return ids


# ------------------------------------------------------ sentencepiece charsmap

def _hangul(cp: int) -> Optional[str]:
    if 0x1100 <= cp <= 0x115F or 0xA960 <= cp <= 0xA97C:
        return "L"
    if 0x1160 <= cp <= 0x11A7 or 0xD7B0 <= cp <= 0xD7C6:
        return "V"
    if 0x11A8 <= cp <= 0x11FF or 0xD7CB <= cp <= 0xD7FB:
        return "T"
    if 0xAC00 <= cp <= 0xD7A3:
        return "LV" if (cp - 0xAC00) % 28 == 0 else "LVT"
    return None


# Grapheme_Extend beyond the Mn and Me categories (Other_Grapheme_Extend)
_OTHER_EXTEND = frozenset([0x09BE, 0x09D7, 0x0B3E, 0x0B57, 0x0BBE, 0x0BD7, 0x0CC2, 0x0CD5,
                           0x0CD6, 0x0D3E, 0x0D57, 0x0DCF, 0x0DDF, 0x1B35, 0x200C, 0x302E,
                           0x302F, 0xFF9E, 0xFF9F, 0x1133E, 0x11357, 0x114B0, 0x114BD,
                           0x115AF, 0x11930, 0x1D165, 0x1D16E, 0x1D16F, 0x1D170, 0x1D171,
                           0x1D172] + list(range(0xE0020, 0xE0080)))


def _grapheme_class(c: str) -> str:
    """The character's Grapheme_Cluster_Break value (UAX #29), with
    Extended_Pictographic approximated by the emoji blocks."""
    cp = ord(c)
    if c == "\r":
        return "CR"
    if c == "\n":
        return "LF"
    if cp == 0x200D:
        return "ZWJ"
    if 0x1F1E6 <= cp <= 0x1F1FF:
        return "RI"
    cat = unicodedata.category(c)
    if cat in ("Mn", "Me") or cp in _OTHER_EXTEND or 0x1F3FB <= cp <= 0x1F3FF:
        return "Extend"
    if cat in ("Cc", "Zl", "Zp") or (cat == "Cf" and cp != 0x200C):
        return "Control"
    if cat == "Mc" or cp in (0x0E33, 0x0EB3):
        return "SpacingMark"
    hangul = _hangul(cp)
    if hangul:
        return hangul
    if (0x1F000 <= cp <= 0x1FAFF or 0x2600 <= cp <= 0x27BF
            or (cat == "So" and 0x2000 <= cp <= 0x2BFF) or cp in (0xA9, 0xAE)):
        return "Pict"
    return "Other"


def _after_pict(classes: List[str], i: int) -> bool:
    """classes[..i] ends in Extended_Pictographic Extend* (GB11's context)."""
    while i >= 0 and classes[i] == "Extend":
        i -= 1
    return i >= 0 and classes[i] == "Pict"


def _joined(classes: List[str], i: int) -> bool:
    """No grapheme boundary between characters i - 1 and i (UAX #29 rules
    GB3-GB13, without Prepend and the Indic conjuncts)."""
    a, b = classes[i - 1], classes[i]
    if a == "CR" and b == "LF":
        return True
    if a in ("Control", "CR", "LF") or b in ("Control", "CR", "LF"):
        return False
    if (a == "L" and b in ("L", "V", "LV", "LVT")) or (a in ("LV", "V") and b in ("V", "T")) \
            or (a in ("LVT", "T") and b == "T"):
        return True
    if b in ("Extend", "ZWJ", "SpacingMark"):
        return True
    if a == "ZWJ" and b == "Pict":
        return _after_pict(classes, i - 2)
    if a == "RI" and b == "RI":
        run = 0
        while i - 1 - run >= 0 and classes[i - 1 - run] == "RI":
            run += 1
        return run % 2 == 1
    return False


def graphemes(text: str) -> List[str]:
    """The text's extended grapheme clusters."""
    classes = [_grapheme_class(c) for c in text]
    cuts = [0] + [i for i in range(1, len(text)) if not _joined(classes, i)] + [len(text)]
    return [text[a:b] for a, b in zip(cuts, cuts[1:]) if b > a]


class Precompiled:
    """sentencepiece's precompiled charsmap: a uint32 trie size, the
    darts-clone double array (uint32 units), then the replacement strings,
    each ending in a zero byte. Applied as `tokenizers` applies it: per
    grapheme of under 6 UTF-8 bytes, the replacement of the shortest key that
    prefixes the grapheme replaces the whole grapheme; otherwise (or for a
    longer grapheme) per character, likewise; a character with no key stays."""

    def __init__(self, blob: bytes):
        (size,) = struct.unpack_from("<I", blob, 0)
        self.units = struct.unpack_from(f"<{size // 4}I", blob, 4)
        self.normalized = blob[4 + size:]

    def _first_match(self, key: bytes) -> Optional[int]:
        units = self.units
        pos = (units[0] >> 10) << ((units[0] & (1 << 9)) >> 6)
        for c in key:
            pos ^= c
            if pos >= len(units):
                return None
            unit = units[pos]
            if unit & ((1 << 31) | 0xFF) != c:
                return None
            pos ^= (unit >> 10) << ((unit & (1 << 9)) >> 6)
            if (unit >> 8) & 1:
                return units[pos] & ((1 << 31) - 1)
        return None

    def _transform(self, chunk: str) -> Optional[str]:
        at = self._first_match(chunk.encode("utf-8"))
        if at is None:
            return None
        end = self.normalized.index(b"\0", at)
        return self.normalized[at:end].decode("utf-8")

    def __call__(self, text: str) -> str:
        out = []
        for g in graphemes(text):
            if len(g.encode("utf-8")) < 6:
                rep = self._transform(g)
                if rep is not None:
                    out.append(rep)
                    continue
            for c in g:
                rep = self._transform(c)
                out.append(c if rep is None else rep)
        return "".join(out)


# ---------------------------------------------------------------- Unigram

class Unigram:
    """The Viterbi segmentation of `tokenizers`' Unigram model: the best sum
    of piece scores, an unknown character scored min - 10, runs of unknowns
    fused into one unknown token."""

    def __init__(self, pieces: Sequence[Tuple[str, float]], unk_id: int):
        self.ids = {}
        for i, (p, _) in enumerate(pieces):
            self.ids.setdefault(p, i)
        self.scores = [float(s) for _, s in pieces]
        self.unk_id = unk_id
        self.unk_score = min(self.scores) - 10.0
        self.max_len = max(len(p) for p, _ in pieces)

    def encode(self, text: str) -> List[int]:
        n = len(text)
        best: List[Optional[Tuple[float, int, int]]] = [None] * (n + 1)   # (score, start, id)
        best[0] = (0.0, 0, -1)
        for i in range(n):
            base = best[i][0] if best[i] is not None else 0.0
            single = False
            for j in range(i + 1, min(n, i + self.max_len) + 1):
                pid = self.ids.get(text[i:j])
                if pid is None:
                    continue
                cand = base + self.scores[pid]
                if best[j] is None or cand > best[j][0]:
                    best[j] = (cand, i, pid)
                single = single or j == i + 1
            if not single:
                cand = base + self.unk_score
                if best[i + 1] is None or cand > best[i + 1][0]:
                    best[i + 1] = (cand, i, self.unk_id)
        ids, end = [], n
        while end > 0:
            _, start, pid = best[end]
            if not (pid == self.unk_id and ids and ids[-1] == self.unk_id):
                ids.append(pid)
            end = start
        return ids[::-1]


def _proto(buf: bytes):
    """(field number, wire type, value) of a protobuf message: varints as
    ints, 32- and 64-bit fields as raw bytes, length-delimited as bytes."""
    i = 0
    while i < len(buf):
        key, i = _varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, i = _varint(buf, i)
        elif wire == 1:
            value, i = buf[i:i + 8], i + 8
        elif wire == 2:
            size, i = _varint(buf, i)
            value, i = buf[i:i + size], i + size
        elif wire == 5:
            value, i = buf[i:i + 4], i + 4
        else:
            raise ValueError(f"protobuf wire type {wire} is not supported")
        yield field, wire, value


def _varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = value = 0
    while True:
        b = buf[i]
        i += 1
        value |= (b & 0x7F) << shift
        if b < 0x80:
            return value, i
        shift += 7


def read_spiece_model(path) -> dict:
    """A sentencepiece ModelProto: pieces [(piece, score, type)] (type 1
    normal, 2 unknown, 3 control, 4 user-defined, 5 unused, 6 byte), and the
    trainer's model_type, unk_id and byte_fallback, the normalizer's
    precompiled_charsmap, add_dummy_prefix and remove_extra_whitespaces."""
    out = {"pieces": [], "model_type": 1, "unk_id": 0, "byte_fallback": False,
           "precompiled_charsmap": b"", "add_dummy_prefix": True,
           "remove_extra_whitespaces": True}
    for field, _, value in _proto(Path(path).read_bytes()):
        if field == 1:
            piece, score, kind = "", 0.0, 1
            for f, _, v in _proto(value):
                if f == 1:
                    piece = v.decode("utf-8")
                elif f == 2:
                    (score,) = struct.unpack("<f", v)
                elif f == 3:
                    kind = v
            out["pieces"].append((piece, score, kind))
        elif field == 2:
            for f, _, v in _proto(value):
                if f == 3:
                    out["model_type"] = v
                elif f == 40:
                    out["unk_id"] = v
                elif f == 35:
                    out["byte_fallback"] = bool(v)
        elif field == 3:
            for f, _, v in _proto(value):
                if f == 2:
                    out["precompiled_charsmap"] = bytes(v)
                elif f == 3:
                    out["add_dummy_prefix"] = bool(v)
                elif f == 4:
                    out["remove_extra_whitespaces"] = bool(v)
    return out


# -------------------------------------------------- tokenizer.json components

def _strip(text: str, left: bool, right: bool) -> str:
    i, j = 0, len(text)
    while left and i < j and is_space(text[i]):
        i += 1
    while right and j > i and is_space(text[j - 1]):
        j -= 1
    return text[i:j]


def make_normalizer(spec: Optional[dict]):
    """A `tokenizers` normalizer from its JSON, of the kinds T5's
    tokenizer.json files hold: Sequence, Precompiled, Replace (a string, or
    a regex for Python's `re`), Strip."""
    if spec is None:
        return lambda s: s
    kind = spec["type"]
    if kind == "Sequence":
        parts = [make_normalizer(s) for s in spec["normalizers"]]

        def seq(s):
            for p in parts:
                s = p(s)
            return s
        return seq
    if kind == "Precompiled":
        blob = base64.b64decode(spec.get("precompiled_charsmap") or "")
        return Precompiled(blob) if blob else (lambda s: s)
    if kind == "Replace":
        pattern, content = spec["pattern"], spec["content"]
        if "Regex" in pattern:
            rx = re.compile(pattern["Regex"])
            return lambda s: rx.sub(content.replace("\\", "\\\\"), s)
        return lambda s: s.replace(pattern["String"], content)
    if kind == "Strip":
        return lambda s: _strip(s, spec.get("strip_left", False), spec.get("strip_right", False))
    raise ValueError(f"tokenizer.json: normalizer {kind!r} is not supported")


def metaspace(replacement: str = SPIECE_UNDERLINE, prepend_scheme: str = "always",
              split: bool = True):
    """`tokenizers`' Metaspace: spaces to the replacement, the replacement
    prepended (always, or to the text's first split only), then a new piece
    at each replacement."""
    def pre(pieces: List[str], first: bool) -> List[str]:
        out = []
        for p in pieces:
            if not p:
                continue
            p = p.replace(" ", replacement)
            if (prepend_scheme == "always" or (prepend_scheme == "first" and first)) and \
                    not p.startswith(replacement):
                p = replacement + p
            first = False
            if not split:
                out.append(p)
                continue
            starts = [0] + [i for i, c in enumerate(p) if c == replacement and i > 0]
            out += [p[a:b] for a, b in zip(starts, starts[1:] + [len(p)])]
        return out
    return pre


def make_pre_tokenizer(spec: Optional[dict]):
    """A `tokenizers` pre-tokenizer from its JSON: Sequence, WhitespaceSplit,
    Metaspace (with `prepend_scheme` or the older `add_prefix_space`). The
    callable maps (pieces, first) to pieces; `first` marks the split that
    starts the text."""
    if spec is None:
        return lambda pieces, first: pieces
    kind = spec["type"]
    if kind == "Sequence":
        parts = [make_pre_tokenizer(s) for s in spec["pretokenizers"]]

        def seq(pieces, first):
            for p in parts:
                pieces = p(pieces, first)
            return pieces
        return seq
    if kind == "WhitespaceSplit":
        def ws(pieces, first):
            out = []
            for p in pieces:
                word = ""
                for c in p:
                    if is_space(c):
                        if word:
                            out.append(word)
                        word = ""
                    else:
                        word += c
                if word:
                    out.append(word)
            return out
        return ws
    if kind == "Metaspace":
        scheme = spec.get("prepend_scheme")
        if scheme is None:
            scheme = "always" if spec.get("add_prefix_space", True) else "never"
        return metaspace(spec.get("replacement", SPIECE_UNDERLINE), scheme,
                         spec.get("split", True))
    raise ValueError(f"tokenizer.json: pre-tokenizer {kind!r} is not supported")


# ----------------------------------------------------------------- pipeline

class AddedToken:
    def __init__(self, content: str, id: int, lstrip: bool = False, rstrip: bool = False):
        self.content, self.id, self.lstrip, self.rstrip = content, id, lstrip, rstrip


def split_added(text: str, added: Sequence[AddedToken]) -> List[Tuple[int, object]]:
    """The text cut at its added tokens (leftmost, then longest): a list of
    (start offset, str) for the text between and (start offset, AddedToken)
    for each token; an lstrip token takes the whitespace before it, an
    rstrip one the whitespace after."""
    out: List[Tuple[int, object]] = []
    if not added:
        return [(0, text)] if text else []
    by_len = sorted(added, key=lambda t: -len(t.content))
    i = seg = 0
    while i < len(text):
        tok = next((t for t in by_len if text.startswith(t.content, i)), None)
        if tok is None:
            i += 1
            continue
        left, right = i, i + len(tok.content)
        if tok.lstrip:
            while left > seg and is_space(text[left - 1]):
                left -= 1
        if tok.rstrip:
            while right < len(text) and is_space(text[right]):
                right += 1
        if left > seg:
            out.append((seg, text[seg:left]))
        out.append((left, tok))
        i = seg = right
    if seg < len(text):
        out.append((seg, text[seg:]))
    return out


class Pipeline:
    """Added tokens split out, then per remaining split the normalizer, the
    pre-tokenizer and the model, then the template's special ids around the
    whole (truncated first so that the template fits in `length`)."""

    def __init__(self, model, added: Sequence[AddedToken], prefix: Sequence[int] = (),
                 suffix: Sequence[int] = (), normalizer=None, pre_tokenizer=None):
        self.model, self.added = model, list(added)
        self.prefix, self.suffix = list(prefix), list(suffix)
        self.normalizer = normalizer or (lambda s: s)
        self.pre_tokenizer = pre_tokenizer or (lambda pieces, first: pieces)

    def encode(self, text: str, length: int) -> List[int]:
        ids: List[int] = []
        for start, part in split_added(text, self.added):
            if isinstance(part, AddedToken):
                ids.append(part.id)
                continue
            for piece in self.pre_tokenizer([self.normalizer(part)], start == 0):
                ids += self.model.encode(piece)
        keep = max(length - len(self.prefix) - len(self.suffix), 0)
        return self.prefix + ids[:keep] + self.suffix


class VitsTokenizer:
    """transformers' VitsTokenizer: `normalize` lowercases (vocabulary
    entries found at a position are kept as they are) and drops characters
    outside the vocabulary, `add_blank` puts id 0's token between characters
    and at both ends; with `phonemize` set encoding raises ImportError, as
    transformers does without `phonemizer`."""

    def __init__(self, vocab: Dict[str, int], cfg: dict, added: Sequence[AddedToken]):
        self.vocab, self.added = vocab, list(added)
        self.normalize = cfg.get("normalize", True)
        self.add_blank = cfg.get("add_blank", True)
        self.phonemize = cfg.get("phonemize", True)
        self.language = cfg.get("language")
        self.unk_id = vocab.get(_token_str(cfg.get("unk_token", "<unk>")))
        self.words = list(vocab) + [t.content for t in self.added if t.content not in vocab]

    def _normalize_text(self, text: str) -> str:
        out, i = "", 0
        while i < len(text):
            word = next((w for w in self.words if text.startswith(w, i)), None)
            if word is not None:
                out += word
                i += len(word)
            else:
                out += text[i].lower()
                i += 1
        return out

    def encode(self, text: str, length: int) -> List[int]:
        if self.normalize:
            text = self._normalize_text(text)
        if self.language == "ron":
            text = text.replace("ț", "ţ")
        if self.phonemize:
            raise ImportError("Please install the `phonemizer` Python package to use this "
                              "tokenizer.")
        if self.normalize:
            text = "".join(c for c in text if c in self.vocab).strip()
        ids: List[int] = []
        for _, part in split_added(text, self.added):
            if isinstance(part, AddedToken):
                ids.append(part.id)
                continue
            chars = [self.vocab.get(c, self.unk_id) for c in part]
            if self.add_blank and chars:   # id 0's token between and around
                chars = [x for c in chars for x in (0, c)] + [0]
            ids += chars
        return ids[:length]


# ------------------------------------------------------------------ loading

def _token_str(v) -> Optional[str]:
    """A special token as tokenizer_config.json / special_tokens_map.json
    write it: a string or an AddedToken dict."""
    return v.get("content") if isinstance(v, dict) else v


SPECIAL_KEYS = ("bos_token", "eos_token", "unk_token", "sep_token", "pad_token",
                "cls_token", "mask_token")


def _configs(d: Path) -> dict:
    """tokenizer_config.json with special_tokens_map.json's entries under it."""
    cfg = {}
    for name in ("special_tokens_map.json", "tokenizer_config.json"):
        f = d / name
        if f.exists():
            cfg.update(json.loads(f.read_text(encoding="utf-8")))
    return cfg


def _added_tokens(cfg: dict, vocab: Dict[str, int], listed=(), defaults=None):
    """The added tokens transformers matches in the text: those listed
    (tokenizer.json's `added_tokens`), tokenizer_config's
    `added_tokens_decoder`, and the special tokens and
    `additional_special_tokens` of the config, with their lstrip / rstrip
    (`defaults` for specials that carry none); a special token outside the
    vocabulary takes the next id, in transformers' order."""
    out: Dict[str, AddedToken] = {}
    defaults = defaults or {}
    entries = list(listed) + [dict(v, id=int(k)) for k, v in
                              cfg.get("added_tokens_decoder", {}).items()]
    for e in entries:
        if e.get("single_word"):
            raise ValueError(f"added token {e['content']!r}: single_word is not supported")
        out.setdefault(e["content"], AddedToken(e["content"], e["id"], e.get("lstrip", False),
                                                e.get("rstrip", False)))
    specials = [cfg.get(k) for k in SPECIAL_KEYS] + list(cfg.get("additional_special_tokens",
                                                                 []))
    next_id = max([len(vocab)] + [t.id + 1 for t in out.values()])
    for v in specials:
        name = _token_str(v)
        if name is None or name in out:
            continue
        flags = v if isinstance(v, dict) else defaults.get(name, {})
        if name in vocab:
            tid = vocab[name]
        else:
            tid, next_id = next_id, next_id + 1
        out[name] = AddedToken(name, tid, flags.get("lstrip", False), flags.get("rstrip", False))
    return list(out.values())


def _token_id(name, vocab: Dict[str, int], added: Sequence[AddedToken]) -> Optional[int]:
    name = _token_str(name)
    if name is None:
        return None
    hit = next((t.id for t in added if t.content == name), None)
    return hit if hit is not None else vocab.get(name)


def _roberta(d: Path, cfg: dict):
    vocab = json.loads((d / "vocab.json").read_text(encoding="utf-8"))
    merges = []
    for line in (d / "merges.txt").read_text(encoding="utf-8").splitlines():
        if line.startswith("#version") or not line.strip():
            continue
        a, b = line.split(" ")
        merges.append((a, b))
    added = _added_tokens(cfg, vocab, defaults={"<mask>": {"lstrip": True}})
    bos = _token_id(cfg.get("cls_token", cfg.get("bos_token", "<s>")), vocab, added)
    eos = _token_id(cfg.get("sep_token", cfg.get("eos_token", "</s>")), vocab, added)
    if cfg.get("add_prefix_space"):
        raise ValueError("RobertaTokenizer: add_prefix_space is not supported")
    return (Pipeline(ByteLevelBPE(vocab, merges), added, prefix=[bos], suffix=[eos]),
            _token_id(cfg.get("pad_token", "<pad>"), vocab, added))


def _template(spec: Optional[dict]) -> Tuple[List[int], List[int]]:
    """(prefix, suffix) special ids of a TemplateProcessing's single template."""
    if spec is None:
        return [], []
    if spec["type"] != "TemplateProcessing":
        raise ValueError(f"tokenizer.json: post-processor {spec['type']!r} is not supported")
    prefix, suffix, seen = [], [], False
    for item in spec["single"]:
        if "Sequence" in item:
            seen = True
            continue
        (suffix if seen else prefix).extend(
            spec["special_tokens"][item["SpecialToken"]["id"]]["ids"])
    return prefix, suffix


def _t5_from_json(d: Path, cfg: dict):
    tj = json.loads((d / "tokenizer.json").read_text(encoding="utf-8"))
    model = tj["model"]
    if model["type"] != "Unigram":
        raise ValueError(f"{d}/tokenizer.json: model {model['type']!r} is not supported for "
                         f"a T5 tokenizer")
    if model.get("byte_fallback"):
        raise ValueError(f"{d}/tokenizer.json: byte_fallback is not supported")
    pieces = [(p, s) for p, s in model["vocab"]]
    vocab = {p: i for i, (p, _) in reversed(list(enumerate(pieces)))}
    added = _added_tokens(cfg, vocab, listed=tj.get("added_tokens", []))
    prefix, suffix = _template(tj.get("post_processor"))
    pipe = Pipeline(Unigram(pieces, model["unk_id"]), added, prefix, suffix,
                    make_normalizer(tj.get("normalizer")),
                    make_pre_tokenizer(tj.get("pre_tokenizer")))
    return pipe, _token_id(cfg.get("pad_token", "<pad>"), vocab, added)


def _t5_from_spiece(d: Path, cfg: dict):
    """The pipeline transformers' T5Converter builds from `spiece.model`."""
    sp = read_spiece_model(d / "spiece.model")
    if sp["model_type"] != 1:
        raise ValueError(f"{d}/spiece.model: model_type {sp['model_type']} is not a Unigram")
    if sp["byte_fallback"]:
        raise ValueError(f"{d}/spiece.model: byte_fallback is not supported")
    extra = cfg.get("extra_ids", 100)
    pieces = [(p, s) for p, s, _ in sp["pieces"]]
    pieces += [(f"<extra_id_{i}>", 0.0) for i in range(extra - 1, -1, -1)]
    vocab = {p: i for i, (p, _) in reversed(list(enumerate(pieces)))}
    listed = [{"content": p, "id": i} for i, (p, _, kind) in enumerate(sp["pieces"])
              if kind in (3, 4)]
    listed += [{"content": f"<extra_id_{i}>", "id": vocab[f"<extra_id_{i}>"]}
               for i in range(extra)]
    added = _added_tokens(cfg, vocab, listed=listed)
    steps = ([Precompiled(sp["precompiled_charsmap"])] if sp["precompiled_charsmap"] else [])
    steps += [lambda s: _strip(s, False, True),
              lambda s: re.sub(" {2,}", SPIECE_UNDERLINE, s)]

    def normalizer(s):
        for step in steps:
            s = step(s)
        return s
    prepend = cfg.get("add_prefix_space", True)
    scheme = ("never" if not prepend else "always" if cfg.get("legacy", True) else "first")
    meta = metaspace(SPIECE_UNDERLINE, scheme)
    eos = _token_id(cfg.get("eos_token", "</s>"), vocab, added)
    pipe = Pipeline(Unigram(pieces, sp["unk_id"]), added, [], [eos], normalizer, meta)
    return pipe, _token_id(cfg.get("pad_token", "<pad>"), vocab, added)


def _vits(d: Path, cfg: dict):
    vocab = json.loads((d / "vocab.json").read_text(encoding="utf-8"))
    added = _added_tokens({k: v for k, v in cfg.items()
                           if k in ("added_tokens_decoder", "unk_token", "pad_token")}, vocab)
    return VitsTokenizer(vocab, cfg, added), _token_id(cfg.get("pad_token", "<pad>"), vocab,
                                                        added)


READERS = {"RobertaTokenizer": _roberta, "RobertaTokenizerFast": _roberta,
           "T5Tokenizer": None, "T5TokenizerFast": None, "VitsTokenizer": _vits}


def load_tokenizer(tok_dir, max_length: Optional[int] = 512):
    """The tokenizer of a snapshot directory as a callable texts -> numpy
    (ids, mask), both (len(texts), length) int64, padded on the right with
    the pad id to `length`: `model_max_length` of tokenizer_config.json capped
    at `max_length` (no cap for None), the text truncated so that its special
    tokens fit. A class these readers do not know raises ValueError naming it."""
    d = Path(tok_dir)
    cfg = _configs(d)
    cls = cfg.get("tokenizer_class")
    if cls not in READERS:
        raise ValueError(f"{d}: tokenizer class {cls!r} is not one the port reads "
                         f"(known: {', '.join(READERS)})")
    if cls.startswith("T5"):
        tok, pad = (_t5_from_json if (d / "tokenizer.json").exists() else _t5_from_spiece)(d, cfg)
    else:
        tok, pad = READERS[cls](d, cfg)
    if pad is None:
        raise ValueError(f"{d}: no pad token in the vocabulary")
    model_max = int(cfg.get("model_max_length", VERY_LARGE_INTEGER))
    length = model_max if max_length is None else min(model_max, max_length)
    if length >= VERY_LARGE_INTEGER:
        raise ValueError(f"{d}: tokenizer_config.json sets no model_max_length to pad to")

    def tokenizer(texts):
        texts = list(texts)
        ids = np.full((len(texts), length), pad, np.int64)
        mask = np.zeros((len(texts), length), np.int64)
        for row, text in enumerate(texts):
            seq = tok.encode(text, length)
            ids[row, :len(seq)] = seq
            mask[row, :len(seq)] = 1
        return ids, mask
    tokenizer.reader = f"{cls} (diffmusic_tpu_torch.models.tokenizers)"
    return tokenizer
