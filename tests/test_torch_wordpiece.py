"""The port's WordPiece tokenizer (BERT) against jlama_tpu's and `tokenizers`':
the WordPiece cases of tests/test_tokenizers.py, ids and decoded text equal,
and its decoder's clean-ups under the standard library's `re` against
`regex`."""

import json

import pytest
import regex
from hypothesis import given, settings, strategies as st

from jlama_tpu.tokenizers import Tokenizer as JTokenizer
from jlama_tpu.tokenizers import parse_tokenizer_json as jparse
from jlama_tpu_torch.tokenizers import Tokenizer, WordPieceTokenizer, load_tokenizer
from jlama_tpu_torch.tokenizers import parse_tokenizer_json
from tests.test_tokenizers import CORPUS, PROBES

tokenizers = pytest.importorskip("tokenizers")

# beyond tests/test_tokenizers.py's probes: accents BertNormalizer strips,
# CJK it spaces out, control characters it drops, unknown words, punctuation
# the decoder re-attaches, and a word past 100 characters
MORE = ["Café NAÏVE Über", "你好世界 mixed", "tab\there\x00null", "zzzq qqqz", "(a, b)! it's: x;",
        "x" * 120 + " fox", "   ", "über-straße.dot,case"]
UNK_SPEC = {
    "model": {"type": "WordPiece", "vocab": {"[UNK]": 0, "[CLS]": 1, "[SEP]": 2, "hello": 3,
                                             "wor": 4, "##ld": 5},
              "unk_token": "[UNK]", "continuing_subword_prefix": "##"},
    "added_tokens": [{"id": 0, "content": "[UNK]", "special": True},
                     {"id": 1, "content": "[CLS]", "special": True},
                     {"id": 2, "content": "[SEP]", "special": True}],
    "normalizer": {"type": "BertNormalizer", "lowercase": True},
    "post_processor": {"type": "TemplateProcessing", "single": [
        {"SpecialToken": {"id": "[CLS]", "type_id": 0}},
        {"Sequence": {"id": "A", "type_id": 0}},
        {"SpecialToken": {"id": "[SEP]", "type_id": 0}}]},
}


@pytest.fixture(scope="module")
def wordpiece(tmp_path_factory):
    """tests/test_tokenizers.py's wordpiece_style: a 500-word WordPiece
    trained on its corpus, as (hf, the port's, jlama_tpu's)."""
    from tokenizers import BertWordPieceTokenizer

    hf = BertWordPieceTokenizer(lowercase=True)
    hf.train_from_iterator(CORPUS * 10, vocab_size=500, show_progress=False)
    tmp = tmp_path_factory.mktemp("torch_wptok")
    hf.save(str(tmp / "tokenizer.json"))
    data = json.loads((tmp / "tokenizer.json").read_text())
    return hf, Tokenizer(parse_tokenizer_json(data)), JTokenizer(jparse(data)), tmp


def test_wordpiece_matches(wordpiece):
    """tests/test_tokenizers.py::test_wordpiece_matches: ids equal the
    library's and jlama_tpu's; decoded text equals jlama_tpu's."""
    hf, ours, jax_tok, _ = wordpiece
    assert isinstance(ours._impl, WordPieceTokenizer)
    for text in [p for p in PROBES if p] + MORE:
        got = ours.encode(text)
        assert got == jax_tok.encode(text), text
        if len(text) < 100:  # the library splits an over-long word otherwise
            assert got == hf.encode(text).ids, text
        assert ours.encode(text, add_special=False) == jax_tok.encode(text, add_special=False)
        for skip in (True, False):
            assert ours.decode(got, skip_special=skip) == jax_tok.decode(got, skip_special=skip)


def test_load_tokenizer_reads_wordpiece(wordpiece):
    _, ours, _, tmp = wordpiece
    tok = load_tokenizer(tmp)
    assert isinstance(tok._impl, WordPieceTokenizer)
    assert tok.encode("The quick brown fox") == ours.encode("The quick brown fox")


def test_wordpiece_unk():
    """tests/test_tokenizers.py::test_wordpiece_unk."""
    ours = Tokenizer(parse_tokenizer_json(UNK_SPEC))
    jax_tok = JTokenizer(jparse(UNK_SPEC))
    assert ours.encode("hello world", add_special=False) == [3, 4, 5]
    assert ours.encode("HELLO zzz", add_special=False) == [3, 0]
    assert ours.encode("hello world") == [1, 3, 4, 5, 2]
    for text in ("hello world", "HELLO zzz", "x" * 101, "world, hello!"):
        assert ours.encode(text) == jax_tok.encode(text)
        ids = ours.encode(text)
        assert ours.decode(ids) == jax_tok.decode(ids)


@settings(max_examples=300, deadline=None)
@given(st.lists(st.sampled_from(["a", "b", "##c", "##d", ".", ",", "!", "?", "'", ":", ";",
                                 ")", "(", " ", "é", "你"]), max_size=12))
def test_decode_cleanups_match_regex(toks):
    """The decoder's three punctuation clean-ups give under `re` what they
    give under `regex`, on texts made of the tokens' spellings."""
    from jlama_tpu_torch.tokenizers import wordpiece

    spec = parse_tokenizer_json({"model": {"type": "WordPiece", "vocab": {
        t: i for i, t in enumerate(sorted(set(toks) | {"[UNK]"}))}, "unk_token": "[UNK]"}})
    ours = WordPieceTokenizer(spec)
    ids = [spec.vocab[t] for t in toks]
    text = ours.decode(ids)
    joined = ""
    for t in toks:  # the decoder's join, then regex's clean-ups
        if t.startswith("##"):
            joined += t[2:]
        else:
            joined += (" " if joined else "") + t
    want = regex.sub(r" ([\.\,\!\?\'\:\;\)])", r"\1", joined)
    want = regex.sub(r"\( ", "(", want)
    want = regex.sub(r" ' ", "'", want)
    assert text == want
    assert wordpiece.re.__name__ == "re"
