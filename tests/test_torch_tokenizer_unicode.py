"""The port's tokenizer without `regex`: its Unicode classes against
`regex` over every code point, its pattern translator against `regex` on the
repo's patterns, and its ids against jlama_tpu's and `tokenizers`' (analogs
of tests/test_tokenizers.py's BPE cases and tests/test_tokenizer_llama3.py;
make_tiny_chat_model's tokenizer is held in tests/test_torch_server.py, which
builds that model)."""

import json

import pytest
import regex
from hypothesis import given, settings, strategies as st

from jlama_tpu_torch.tokenizers import _pattern, _uniclass
from jlama_tpu_torch.tokenizers.bpe import GPT2_SPLIT_PATTERN

tokenizers = pytest.importorskip("tokenizers")

EVERY = "".join(map(chr, range(0x110000)))
LLAMA3_PATTERN = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}"
    r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)
NEWER = "\u088f\u0c5c\u1c89\ua7cb"  # letters in `regex`'s tables, not in `tokenizers`'
# where `re`'s classes (and unicodedata's) differ from `regex`'s: the
# separators U+001C-U+001F, superscripts and fractions, a combining acute,
# letters newer than Unicode 15 (U+088F, U+0C5C, U+1C89, U+A7CB), CJK,
# Devanagari digits, and runs of CR LF and spaces
CORPUS = [
    "a\x1cb\x1dc\x1e d\x1f", "x² + y³ = z¹", "¼ ½ ¾ 1¼", "café cafe\u0301 ñ", NEWER,
    "你好，世界！ 日本語", "१२३४ ४५ numbers 12345678", "\r\n\r\n  \n\t  x  \r\n", "it's I'M we'LL",
    "😀🚀 emoji", "snake_case kebab-case 3.14 -17", "   trailing   ", "",
]
PATTERNS = {
    "gpt2": GPT2_SPLIT_PATTERN,
    "llama3": LLAMA3_PATTERN,
    "digits": r"(\p{N})",
    "digit_runs": r"(\p{N}+)",
    "punctuation": r"(\p{P})",
    "whitespace": r"\w+|[^\w\s]+",
    "bert": r"\S+|\s",
    "metaspace": "(?=▁)",
}


@pytest.mark.parametrize("name", sorted(_uniclass.CLASSES))
def test_classes_match_regex_on_every_code_point(name):
    """Each class and its complement, outside and inside brackets, matches the
    same runs of code points as `regex` does, over all 1,114,112."""
    cls = {"L": r"\p{L}", "N": r"\p{N}", "P": r"\p{P}"}.get(name, "\\" + name)
    neg = cls.replace("\\p", "\\P") if cls.startswith("\\p") else cls.upper()
    for pat in (cls + "+", neg + "+", f"[{cls}]+", f"[^{cls}]+"):
        want = [m.span() for m in regex.finditer(pat, EVERY)]
        got = [m.span() for m in _pattern.compile_pattern(pat).finditer(EVERY)]
        assert got == want, pat


@pytest.mark.parametrize("name", sorted(_uniclass.CLASSES))
def test_bert_pre_tokenize_matches_jax_on_every_code_point(name):
    """WordPiece's pre-tokenizer (whitespace split, then each punctuation
    character its own piece) on the code points of each class and of its
    complement, each between two letters, equals jlama_tpu's, which runs
    `regex`."""
    from jlama_tpu.tokenizers.bpe import _bert_pre_tokenize as jax_bert_pre_tokenize
    from jlama_tpu_torch.tokenizers.bpe import _bert_pre_tokenize

    cls = {"L": r"\p{L}", "N": r"\p{N}", "P": r"\p{P}"}.get(name, "\\" + name)
    for pat in (cls, f"[^{cls}]"):
        text = "a" + "a".join(regex.findall(pat, EVERY)) + "a"
        assert _bert_pre_tokenize(text) == jax_bert_pre_tokenize(text), pat


def test_generated_table_is_current():
    """The committed table is what the generator writes with this `regex`."""
    from pathlib import Path

    from jlama_tpu_torch.scripts import gen_uniclass

    assert gen_uniclass.render(regex) == Path(_uniclass.__file__).read_text()
    assert "\\" not in "".join(_uniclass.CLASSES.values()).replace("\\u", "").replace("\\U", "")


def test_stdlib_classes_never_reach_a_compiled_pattern():
    for pat in PATTERNS.values():
        out = _pattern.translate(pat)
        assert not regex.search(r"(?<!\\)(?:\\\\)*\\[sSwWdDpP]", out), (pat, out[:200])


@pytest.mark.parametrize("name", sorted(PATTERNS))
def test_translator_matches_regex_on_the_repo_patterns(name):
    pat = PATTERNS[name]
    rx = _pattern.compile_pattern(pat)
    for text in CORPUS + ["▁a▁b c", "".join(CORPUS)]:
        assert rx.findall(text) == regex.findall(pat, text), (name, text)
        assert rx.split(text) == regex.split(pat, text), (name, text)


@settings(max_examples=300, deadline=None)
@given(st.text(alphabet="ab Z9²¼\u0301\u088f你१\r\n\t\x1c\x1f'sS!,.-_😀▁\u3000\u00a0", max_size=24))
def test_translator_matches_regex_on_random_text(text):
    for pat in PATTERNS.values():
        assert _pattern.compile_pattern(pat).findall(text) == regex.findall(pat, text), pat


@pytest.mark.parametrize("pat,construct", [
    (r"\X", r"\X"), (r"\p{Script=Latin}", "Script=Latin"), (r"[[a-z]b]", "nested set"),
    (r"[a-z&&[aeiou]]", "set operation"), (r"(?<=a+)b", "look-behind"), (r"\p{Lu}", "Lu"),
    (r"\bword", r"\b"), (r"(?i:\p{L}+)", "i flag"), (r"(?x) a", "(?x)"), (r"[a-\s]", "range"),
    (r"\G", r"\G"),
])
def test_translator_raises_on_what_it_cannot_translate(pat, construct):
    with pytest.raises(ValueError, match=regex.escape(construct)):
        _pattern.compile_pattern(pat)


# ---------------------------------------------------------------------------
# tokenizers: the port's ids against jlama_tpu's and the `tokenizers` library's

BPE_CORPUS = [
    "The quick brown fox jumps over the lazy dog.",
    "Hello world! It's a beautiful day; isn't it?",
    "Numbers: 1234567890 42 3.14159 -17",
    "Unicode: café naïve über straße 你好世界 😀🚀",
    "    indented    and  spaced    text\n\nwith newlines\t and tabs",
    "CamelCase snake_case kebab-case dot.case",
    "Punctuation!!! ??? ;;; ... ---",
]
PROBES = [
    "Hello world", "hello", "  leading spaces", "trailing spaces   ",
    "It's the fox's den... isn't it?", "12345 abc 6.78", "café über", "mixed 你好 ascii",
    "😀 emoji 🚀 start", "new\nlines\n\nand\ttabs", "", "a", "The quick brown fox",
] + CORPUS


def _trained(tmp_path, pre_tokenizer, special, vocab_size=500, ignore_merges=False,
             corpus=BPE_CORPUS, normalizer=None):
    from tokenizers import Tokenizer as HFTok, decoders, pre_tokenizers
    from tokenizers.models import BPE
    from tokenizers.trainers import BpeTrainer

    tok = HFTok(BPE(unk_token=None, ignore_merges=ignore_merges))
    tok.pre_tokenizer = pre_tokenizer
    if normalizer is not None:
        tok.normalizer = normalizer
    tok.decoder = decoders.ByteLevel()
    trainer = BpeTrainer(vocab_size=vocab_size, special_tokens=special, show_progress=False,
                         initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    tok.train_from_iterator(corpus * 10, trainer)
    path = tmp_path / "tokenizer.json"
    tok.save(str(path))
    return tok, json.loads(path.read_text())


def _held(hf, data, probes, hf_decode=True):
    """Encode and decode each probe with the port, jlama_tpu and `tokenizers`:
    equal ids and texts (the texts against `tokenizers` only where the JAX
    package's decoding agrees with it)."""
    from jlama_tpu.tokenizers import Tokenizer as JaxTok, parse_tokenizer_json as jax_parse
    from jlama_tpu_torch.tokenizers import Tokenizer, parse_tokenizer_json

    ours, ref = Tokenizer(parse_tokenizer_json(data)), JaxTok(jax_parse(data))
    for text in probes:
        got, want = ours.encode(text), ref.encode(text)
        assert got == want, (text, got, want)
        if any(c in text for c in NEWER):  # `tokenizers`' tables predate them
            continue
        assert got == hf.encode(text).ids, (text, got)
        assert ours.decode(got) == ref.decode(got)
        assert ours.decode(got, skip_special=False) == ref.decode(got, skip_special=False)
        if hf_decode and got:
            assert ours.decode(got) == hf.decode(got)


def test_byte_level_bpe_matches(tmp_path):
    from tokenizers import pre_tokenizers

    hf, data = _trained(tmp_path, pre_tokenizers.ByteLevel(add_prefix_space=False),
                        ["<|endoftext|>"])
    _held(hf, data, PROBES + ["Hello<|endoftext|>world"])


def test_llama3_style_matches(tmp_path):
    from tokenizers import Regex, pre_tokenizers

    pre = pre_tokenizers.Sequence([
        pre_tokenizers.Split(pattern=Regex(LLAMA3_PATTERN), behavior="isolated"),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    corpus = ["The quick brown fox jumps over the lazy dog. It's 12345!",
              "Hello world,\nnew lines\r\nand  spaces   everywhere 678 90",
              "café über 你好 😀 punctuation!!! (parens) [brackets]"]
    hf, data = _trained(tmp_path, pre, ["<|begin_of_text|>", "<|eot_id|>"], vocab_size=600,
                        ignore_merges=True, corpus=corpus)
    probes = ["Hello world, it's 12345!", "numbers 1234567 split into threes",
              "\n\nleading newlines", "tabs\tand\r\nCRLF", "UPPER'S lower's", "a  b   c    d",
              "<|begin_of_text|>Hello<|eot_id|>"]
    _held(hf, data, probes + PROBES)


def test_pre_tokenizer_sequence_matches(tmp_path):
    """Whitespace, individual Digits and Punctuation, and a Replace
    normalizer with a pattern, through the translated classes."""
    from tokenizers import Regex, normalizers, pre_tokenizers

    pre = pre_tokenizers.Sequence([pre_tokenizers.Whitespace(),
                                   pre_tokenizers.Digits(individual_digits=True),
                                   pre_tokenizers.Punctuation()])
    norm = normalizers.Replace(Regex(r"\s+"), " ")
    hf, data = _trained(tmp_path, pre, ["<s>"], normalizer=norm)
    # a vocabulary of raw text behind a ByteLevel decoder: the JAX package
    # maps each character through the byte table, so non-ASCII text decodes
    # otherwise than in `tokenizers`
    _held(hf, data, [p for p in PROBES if p], hf_decode=False)


def test_sentencepiece_bpe_matches(tmp_path):
    """Metaspace pieces (Llama 2, Mistral), split before each '▁'."""
    from tokenizers import SentencePieceBPETokenizer

    tok = SentencePieceBPETokenizer()
    tok.train_from_iterator(BPE_CORPUS * 10, vocab_size=500,
                            special_tokens=["<unk>", "<s>", "</s>"], show_progress=False)
    path = tmp_path / "tokenizer.json"
    tok.save(str(path))
    _held(tok, json.loads(path.read_text()), [p for p in PROBES if p])


def test_chip_smoke_tokenizer_matches():
    """The tokenizer chip_smoke.py makes for the card (Llama 3's layout and
    Split pattern, 128,000 text ids): the port's ids and texts equal
    jlama_tpu's and `tokenizers`', specials included."""
    import chip_smoke as cs

    data = cs.front_tokenizer_json()
    assert len(data["model"]["vocab"]) == cs.FRONT_TEXT_IDS
    hf = tokenizers.Tokenizer.from_str(json.dumps(data))
    probes = PROBES + ["<|begin_of_text|><|start_header_id|>user<|end_header_id|>\n\nHi"
                       "<|eot_id|>", "the quick brown fox 42 cats and 3.5 birds"]
    _held(hf, data, probes)
    from jlama_tpu_torch.tokenizers import Tokenizer, parse_tokenizer_json

    tok = Tokenizer(parse_tokenizer_json(data, cs.FRONT_TOKENIZER_CONFIG))
    assert (tok.bos_id, tok.eos_id) == (128000, 128009)
    # every id decodes: a random model's draws all come back as text
    assert all(tok.decode([i]) for i in range(0, cs.FRONT_TEXT_IDS, 997))
