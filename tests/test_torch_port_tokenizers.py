"""The port's tokenizers (`models/tokenizers.py`, through
`models/checkpoint.py::_make_hf_tokenizer`) against the JAX package's
`_make_hf_tokenizer` (transformers' AutoTokenizer) on directories written
here, ids and masks equal:

- RoBERTa's byte-level BPE (`RobertaTokenizerFast` from vocab.json and
  merges.txt), capped at 512 and uncapped (MusicLDM's);
- T5's Unigram from a tokenizer.json: the one transformers' T5Converter
  makes of a `spiece.model` (written with transformers'
  sentencepiece_model_pb2; protobuf is installed, sentencepiece is not),
  with its legacy and non-legacy Metaspace; an older layout (Precompiled
  alone, WhitespaceSplit, Metaspace with add_prefix_space); the snapshot
  helper's hand-written one;
- T5 from the `spiece.model` alone, against the converter's tokenizer.json
  of the same file (transformers cannot read a spiece.model here without
  sentencepiece: JAX's `_make_hf_tokenizer` returns None for it);
- the charsmap against `tokenizers.normalizers.Precompiled`, the GPT-2 split
  against the `regex` package's pattern, on many strings;
- VITS's characters against `VitsTokenizer`, and its `phonemize` raising;
- with transformers, tokenizers, sentencepiece and regex blocked, the same
  ids; no module of the port imports any of them;
- an unknown tokenizer class raises naming it; a missing directory is None.
"""

import ast
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import test_torch_port_snapshot as snap
from diffmusic_tpu.models.checkpoint import _make_hf_tokenizer as jax_tokenizer
from diffmusic_tpu_torch.models import tokenizers as T
from diffmusic_tpu_torch.models.checkpoint import _make_hf_tokenizer

PORT = Path(__file__).resolve().parent.parent / "diffmusic_tpu_torch"

PROMPTS = [
    "a calm piano", "The  Jazz   guitar!!", "  leading spaces", "trailing   ",
    "Ｆｕｌｌｗｉｄｔｈ ﬁne…", "café au lait", "café", "tabs\tand\nnewlines\r\n x",
    "emoji \U0001F44D\U0001F3FD and \U0001F1EB\U0001F1F7", "ümlaut ß", "",
    "numbers 1/2 ½ 123 4567", "it's a drum's beat, isn't it? we'll", "MiXeD CaSe",
    "中文 字符", "a　b c", "slow soft jazz " * 20,
    "<mask> masked", "tail <mask>", "<s>start</s>", "<extra_id_0> fill </s> here <extra_id_3>",
    "x" * 300, "  ", "▁already ▁marked", "don'T 'S 're", "a‍b क्ष",
]


def same(tok_a, tok_b, prompts=PROMPTS):
    ids_a, mask_a = tok_a(prompts)
    ids_b, mask_b = tok_b(prompts)
    for i, p in enumerate(prompts):
        assert ids_a[i].tolist() == ids_b[i].tolist(), p
        assert mask_a[i].tolist() == mask_b[i].tolist(), p
    return ids_a


def test_roberta_matches_jax(tmp_path):
    d = snap.write_roberta_tokenizer(tmp_path / "tokenizer", model_max_length=77)
    jax_tok, tok = jax_tokenizer(d), _make_hf_tokenizer(d)
    ids = same(tok, jax_tok)
    assert ids.shape == (len(PROMPTS), 77) and ids.dtype == np.int64
    assert ids[0, 0] == 0 and 2 in ids[0] and ids[0, -1] == 1   # <s> ... </s> <pad>...


def test_roberta_uncapped_matches_transformers(tmp_path):
    """MusicLDM pads to the model's maximum length, uncapped."""
    from transformers import AutoTokenizer
    d = snap.write_roberta_tokenizer(tmp_path / "tokenizer", model_max_length=600)
    hf = AutoTokenizer.from_pretrained(str(d))
    tok = _make_hf_tokenizer(d, max_length=None)
    out = hf(PROMPTS, padding="max_length", max_length=600, truncation=True, return_tensors="np")
    ids, mask = tok(PROMPTS)
    assert ids.shape == (len(PROMPTS), 600)
    assert np.array_equal(ids, out["input_ids"]) and np.array_equal(mask, out["attention_mask"])


def write_spiece(path: Path, pieces, charsmap: bytes):
    """A sentencepiece ModelProto of `pieces` (<pad> and </s> control, <unk>
    unknown, the rest normal) with the charsmap."""
    from transformers.convert_slow_tokenizer import import_protobuf
    pb = import_protobuf()
    m = pb.ModelProto()
    for p, score in pieces:
        sp = m.pieces.add()
        sp.piece, sp.score = p, score
        sp.type = {"<pad>": 3, "</s>": 3, "<unk>": 2}.get(p, 1)
    m.trainer_spec.model_type = 1
    m.trainer_spec.unk_id = 2
    m.normalizer_spec.precompiled_charsmap = charsmap
    path.write_bytes(m.SerializeToString())
    return m


def t5_config(d: Path, extra_ids: int, legacy=None, model_max_length: int = 64):
    cfg = {"tokenizer_class": "T5Tokenizer", "model_max_length": model_max_length,
           "eos_token": "</s>", "unk_token": "<unk>", "pad_token": "<pad>",
           "extra_ids": extra_ids,
           "additional_special_tokens": [f"<extra_id_{i}>" for i in range(extra_ids)]}
    if legacy is not None:
        cfg["legacy"] = legacy
    (d / "tokenizer_config.json").write_text(json.dumps(cfg))


def converted_t5(d: Path, spiece: Path, extra_ids: int, legacy: bool):
    """tokenizer.json as transformers' T5Converter makes it of `spiece`."""
    from transformers.convert_slow_tokenizer import T5Converter
    pieces = [(p.piece, p.score) for p in
              __import__("transformers.convert_slow_tokenizer",
                         fromlist=["import_protobuf"]).import_protobuf().ModelProto.FromString(
                  spiece.read_bytes()).pieces]
    ids = {p: i for i, (p, _) in enumerate(pieces)}
    fake = SimpleNamespace(vocab_file=str(spiece), _extra_ids=extra_ids, legacy=legacy,
                           convert_tokens_to_ids=lambda t: ids[t])
    d.mkdir(parents=True, exist_ok=True)
    T5Converter(fake).converted().save(str(d / "tokenizer.json"))
    t5_config(d, extra_ids, legacy)
    return d


@pytest.fixture(scope="module")
def spiece(tmp_path_factory):
    root = tmp_path_factory.mktemp("spiece")
    pieces = snap.t5_pieces(extra_ids=0)
    write_spiece(root / "spiece.model", pieces, snap.charsmap(snap.NFKC_LIKE))
    return root / "spiece.model"


@pytest.mark.parametrize("legacy", [True, False])
def test_t5_converted_tokenizer_json_matches_jax(tmp_path, spiece, legacy):
    d = converted_t5(tmp_path / "tokenizer", spiece, extra_ids=4, legacy=legacy)
    jax_tok, tok = jax_tokenizer(d), _make_hf_tokenizer(d)
    ids = same(tok, jax_tok)
    assert ids.shape == (len(PROMPTS), 64) and 1 in ids[0]


@pytest.mark.parametrize("legacy", [True, False])
def test_t5_spiece_model_matches_the_converted_json(tmp_path, spiece, legacy):
    """The spiece.model alone: JAX's transformers cannot read it without
    sentencepiece (None); the port reads it, with the ids of the
    tokenizer.json the converter makes of the same file."""
    d = tmp_path / "tokenizer"
    d.mkdir()
    (d / "spiece.model").write_bytes(spiece.read_bytes())
    t5_config(d, 4, legacy)
    assert jax_tokenizer(d) is None
    ref = jax_tokenizer(converted_t5(tmp_path / "converted", spiece, 4, legacy))
    same(_make_hf_tokenizer(d), ref)


def test_t5_older_tokenizer_json_layout_matches_jax(tmp_path):
    """Precompiled alone, WhitespaceSplit then Metaspace with
    add_prefix_space (the layout of older hub snapshots)."""
    d = snap.write_t5_tokenizer_json(tmp_path / "tokenizer")
    tj = json.loads((d / "tokenizer.json").read_text(encoding="utf-8"))
    tj["normalizer"] = tj["normalizer"]["normalizers"][0]
    tj["pre_tokenizer"] = {"type": "Sequence", "pretokenizers": [
        {"type": "WhitespaceSplit"},
        {"type": "Metaspace", "replacement": "▁", "add_prefix_space": True}]}
    (d / "tokenizer.json").write_text(json.dumps(tj, ensure_ascii=False), encoding="utf-8")
    same(_make_hf_tokenizer(d), jax_tokenizer(d))


def test_t5_hand_written_tokenizer_json_matches_jax(tmp_path):
    d = snap.write_t5_tokenizer_json(tmp_path / "tokenizer")
    ids = same(_make_hf_tokenizer(d), jax_tokenizer(d))
    assert (ids[-1] == 0).sum() > 0 and ids[21, -1] == 1   # padded; "x" * 300 truncated


def test_charsmap_matches_tokenizers_precompiled(rng):
    from tokenizers import normalizers
    mapping = dict(snap.NFKC_LIKE, **{"e": "E", "\U0001F44D": "T", "ᄀ": "G",
                                      "‍": "", "\U0001F1EB": "F", "ä": "ä",
                                      "각": "K", "q": "QQ"})
    blob = snap.charsmap(mapping)
    ref, ours = normalizers.Precompiled(blob), T.Precompiled(blob)
    alphabet = list("aeqxy \t\r\n") + ["́", "̈", "‍", "\U0001F44D",
                                        "\U0001F3FD", "\U0001F1EB", "\U0001F1F7", "ᄀ",
                                        "ᅡ", "ᆨ", "각", "ａ", "ﬁ",
                                        "…", " ", "क", "्"]
    strings = ["".join(rng.choice(alphabet, size=rng.integers(1, 12))) for _ in range(400)]
    for s in strings:
        assert ours(s) == ref.normalize_str(s), repr(s)


def test_byte_level_split_matches_the_regex_pattern(rng):
    import regex
    pat = regex.compile(r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+""")
    alphabet = list("ab Z9'st \n\t.!,-") + ["re", "ll", "é", "中", "١", "　",
                                              " ", "\U0001F44D", "  "]
    for _ in range(400):
        s = "".join(rng.choice(alphabet, size=rng.integers(1, 16)))
        assert T.byte_level_split(s) == pat.findall(s), repr(s)


VITS_VOCAB = ["_", " ", "'", "-", *"abcdefghijklmnopqrstuvwxyz", "<unk>"]


def write_vits(d: Path, phonemize: bool):
    from transformers import VitsTokenizer
    d.mkdir(parents=True, exist_ok=True)
    (d / "v.json").write_text(json.dumps({t: i for i, t in enumerate(VITS_VOCAB)}))
    VitsTokenizer(str(d / "v.json"), phonemize=phonemize, model_max_length=48).save_pretrained(
        str(d))
    (d / "v.json").unlink()
    return d


def test_vits_matches_jax(tmp_path):
    d = write_vits(tmp_path / "tokenizer_2", phonemize=False)
    ids = same(_make_hf_tokenizer(d), jax_tokenizer(d))
    assert ids.shape == (len(PROMPTS), 48) and ids[0, 0] == 0 and ids[0, 1] == VITS_VOCAB.index("a")


def test_vits_phonemize_raises_as_jax(tmp_path):
    d = write_vits(tmp_path / "tokenizer_2", phonemize=True)
    with pytest.raises(ImportError, match="phonemizer"):
        jax_tokenizer(d)(["hello"])
    with pytest.raises(ImportError, match="phonemizer"):
        _make_hf_tokenizer(d)(["hello"])


def test_same_ids_with_the_packages_blocked(tmp_path, spiece, monkeypatch):
    dirs = [snap.write_roberta_tokenizer(tmp_path / "roberta"),
            snap.write_t5_tokenizer_json(tmp_path / "t5_json"),
            write_vits(tmp_path / "vits", phonemize=False)]
    spiece_dir = tmp_path / "t5_spiece"
    spiece_dir.mkdir()
    (spiece_dir / "spiece.model").write_bytes(spiece.read_bytes())
    t5_config(spiece_dir, 4)
    dirs.append(spiece_dir)
    want = [_make_hf_tokenizer(d)(PROMPTS) for d in dirs]
    for name in ("transformers", "tokenizers", "sentencepiece", "regex"):
        monkeypatch.setitem(sys.modules, name, None)
    for d, (ids, mask) in zip(dirs, want):
        got = _make_hf_tokenizer(d)(PROMPTS)
        assert np.array_equal(got[0], ids) and np.array_equal(got[1], mask)


def test_no_port_module_imports_the_tokenizer_packages():
    banned = {"transformers", "tokenizers", "sentencepiece", "regex"}
    for f in PORT.rglob("*.py"):
        for node in ast.walk(ast.parse(f.read_text(encoding="utf-8"))):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            assert not {n.split(".")[0] for n in names} & banned, (f, names)


def test_unknown_class_raises_and_missing_dir_is_none(tmp_path):
    assert _make_hf_tokenizer(tmp_path / "absent") is None
    d = tmp_path / "tokenizer"
    d.mkdir()
    (d / "tokenizer_config.json").write_text('{"tokenizer_class": "BertTokenizer"}')
    with pytest.raises(ValueError, match="BertTokenizer"):
        _make_hf_tokenizer(d)
