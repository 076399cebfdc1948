"""BPE tokenizer engine (byte-level and byte-fallback variants).

A copy of `jlama_tpu/tokenizers/bpe.py` (the port imports nothing of the JAX
package): greedy lowest-rank merges, byte-fallback encoding, GPT-2
byte↔codepoint remap, streaming-safe UTF-8 decode, driven by the
pre-tokenizer/normalizer/decoder configs found in HF tokenizer.json files.

The JAX package matches tokenizer.json's patterns with the `regex` module;
this one sends every pattern through `_pattern.compile_pattern`, which
translates it for the standard library's `re` with `regex`'s own Unicode
classes (`_uniclass.py`), so the ids are the same without `regex`.
"""

from __future__ import annotations

import functools
import re
import unicodedata

from ._pattern import compile_pattern
from .model import TokenizerSpec

# ---------------------------------------------------------------------------
# GPT-2 byte <-> unicode remap (cf. BPETokenizer.java:44-56)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def bytes_to_unicode() -> dict[int, str]:
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


@functools.lru_cache(maxsize=1)
def unicode_to_bytes() -> dict[str, int]:
    return {v: k for k, v in bytes_to_unicode().items()}


GPT2_SPLIT_PATTERN = (
    r"""'(?:[sdmt]|ll|ve|re)| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
)


# ---------------------------------------------------------------------------
# Normalizers
# ---------------------------------------------------------------------------


def apply_normalizer(cfg: dict | None, text: str) -> str:
    if cfg is None:
        return text
    t = cfg.get("type")
    if t == "Sequence":
        for sub in cfg.get("normalizers", []):
            text = apply_normalizer(sub, text)
        return text
    if t == "NFC":
        return unicodedata.normalize("NFC", text)
    if t == "NFD":
        return unicodedata.normalize("NFD", text)
    if t == "NFKC":
        return unicodedata.normalize("NFKC", text)
    if t == "NFKD":
        return unicodedata.normalize("NFKD", text)
    if t == "Lowercase":
        return text.lower()
    if t == "Replace":
        pat = cfg.get("pattern", {})
        if "String" in pat:
            return text.replace(pat["String"], cfg.get("content", ""))
        if "Regex" in pat:
            return compile_pattern(pat["Regex"]).sub(cfg.get("content", ""), text)
        return text
    if t == "Prepend":
        pre = cfg.get("prepend", "")
        return pre + text if text else text
    if t == "Strip":
        if cfg.get("strip_left", True) and cfg.get("strip_right", True):
            return text.strip()
        if cfg.get("strip_left", True):
            return text.lstrip()
        if cfg.get("strip_right", True):
            return text.rstrip()
        return text
    if t == "BertNormalizer":
        return _bert_normalize(
            text,
            clean_text=cfg.get("clean_text", True),
            handle_chinese=cfg.get("handle_chinese_chars", True),
            strip_accents=cfg.get("strip_accents"),
            lowercase=cfg.get("lowercase", True),
        )
    # unknown normalizer: pass through
    return text


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F
        or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )


def _bert_normalize(text, clean_text, handle_chinese, strip_accents, lowercase):
    out = []
    for ch in text:
        cp = ord(ch)
        if clean_text:
            if cp == 0 or cp == 0xFFFD or unicodedata.category(ch).startswith("C") and ch not in "\t\n\r":
                continue
            if ch in "\t\n\r" or unicodedata.category(ch) == "Zs":
                ch = " "
        if handle_chinese and _is_cjk(cp):
            out.append(" ")
            out.append(ch)
            out.append(" ")
            continue
        out.append(ch)
    text = "".join(out)
    if lowercase:
        text = text.lower()
    if strip_accents or (strip_accents is None and lowercase):
        text = "".join(
            c for c in unicodedata.normalize("NFD", text)
            if unicodedata.category(c) != "Mn"
        )
    return text


# ---------------------------------------------------------------------------
# Pre-tokenizers: text -> list of pieces (already byte-level-mapped if needed)
# ---------------------------------------------------------------------------


def pre_tokenize(cfg: dict | None, text: str, *, is_first: bool = True) -> list[str]:
    """Split text into pieces per the pre_tokenizer config.

    ByteLevel pieces come back byte→unicode remapped (ready for BPE over the
    remap alphabet); other pre-tokenizers return raw text pieces.
    """
    if cfg is None:
        return [text] if text else []
    t = cfg.get("type")
    if t == "Sequence":
        pieces = [text]
        for sub in cfg.get("pretokenizers", []):
            nxt: list[str] = []
            first = is_first
            for p in pieces:
                nxt.extend(pre_tokenize(sub, p, is_first=first))
                first = False
            pieces = nxt
        return pieces
    if t == "ByteLevel":
        if cfg.get("add_prefix_space", True) and is_first and text and not text[0].isspace():
            text = " " + text
        if cfg.get("use_regex", True):
            words = compile_pattern(GPT2_SPLIT_PATTERN).findall(text)
        else:
            words = [text] if text else []
        b2u = bytes_to_unicode()
        return ["".join(b2u[b] for b in w.encode("utf-8")) for w in words]
    if t == "Split":
        pat = cfg.get("pattern", {})
        rx = compile_pattern(pat.get("Regex") or re.escape(pat.get("String", "")))
        behavior = cfg.get("behavior", "Removed")
        if cfg.get("invert"):
            return rx.findall(text)
        if behavior == "Removed":
            return [p for p in rx.split(text) if p]
        if behavior == "Isolated":
            out, last = [], 0
            for m in rx.finditer(text):
                if m.start() > last:
                    out.append(text[last : m.start()])
                out.append(m.group())
                last = m.end()
            if last < len(text):
                out.append(text[last:])
            return out
        if behavior in ("MergedWithPrevious", "MergedWithNext"):
            out, last = [], 0
            for m in rx.finditer(text):
                if behavior == "MergedWithPrevious":
                    out.append(text[last : m.end()])
                    last = m.end()
                else:
                    if m.start() > last:
                        out.append(text[last : m.start()])
                    last = m.start()
            if last < len(text):
                out.append(text[last:])
            return [p for p in out if p]
        return [text]
    if t == "Metaspace":
        rep = cfg.get("replacement", "▁")
        scheme = cfg.get("prepend_scheme", "always" if cfg.get("add_prefix_space", True) else "never")
        s = text.replace(" ", rep)
        if scheme in ("always", "first") and is_first and not s.startswith(rep):
            s = rep + s
        # split so each piece starts at a word boundary (split on rep, keep it)
        pieces = compile_pattern(f"(?={re.escape(rep)})").split(s)
        return [p for p in pieces if p]
    if t == "Whitespace":
        return compile_pattern(r"\w+|[^\w\s]+").findall(text)
    if t == "WhitespaceSplit":
        return text.split()
    if t == "Digits":
        if cfg.get("individual_digits", False):
            return [p for p in compile_pattern(r"(\p{N})").split(text) if p]
        return [p for p in compile_pattern(r"(\p{N}+)").split(text) if p]
    if t == "Punctuation":
        return [p for p in compile_pattern(r"(\p{P})").split(text) if p]
    if t == "BertPreTokenizer":
        return compile_pattern(r"\S+|\s").findall(text) and _bert_pre_tokenize(text)
    return [text]


def _bert_pre_tokenize(text: str) -> list[str]:
    out = []
    for w in text.split():
        out.extend(p for p in compile_pattern(r"(\p{P})").split(w) if p)
    return out


# ---------------------------------------------------------------------------
# BPE merge loop (cf. BPETokenizer.java:147-183)
# ---------------------------------------------------------------------------


def bpe_merge(piece: str, spec: TokenizerSpec) -> list[str]:
    if spec.ignore_merges and piece in spec.vocab:
        return [piece]
    parts = list(piece)
    if not parts:
        return []
    ranks = spec.merge_ranks
    while len(parts) > 1:
        best_rank = None
        best_i = -1
        for i in range(len(parts) - 1):
            r = ranks.get((parts[i], parts[i + 1]))
            if r is not None and (best_rank is None or r < best_rank):
                best_rank = r
                best_i = i
        if best_rank is None:
            break
        parts[best_i : best_i + 2] = [parts[best_i] + parts[best_i + 1]]
    return parts


class BPETokenizer:
    """Full encode/decode pipeline over a TokenizerSpec (BPE models)."""

    def __init__(self, spec: TokenizerSpec):
        self.spec = spec
        self._added_rx = None
        if spec.added_tokens:
            pats = sorted((t.content for t in spec.added_tokens), key=len, reverse=True)
            self._added_rx = compile_pattern("(" + "|".join(re.escape(p) for p in pats) + ")")
        self._byte_level = self._uses_byte_level(spec.pre_tokenizer) or self._uses_byte_level(
            spec.decoder
        )

    @staticmethod
    def _uses_byte_level(cfg) -> bool:
        if cfg is None:
            return False
        if cfg.get("type") == "ByteLevel":
            return True
        for sub in cfg.get("pretokenizers", []) or cfg.get("decoders", []) or []:
            if BPETokenizer._uses_byte_level(sub):
                return True
        return False

    # -- encode ---------------------------------------------------------

    def encode(self, text: str, add_special: bool = True) -> list[int]:
        spec = self.spec
        segments: list[tuple[str, bool]] = []  # (text, is_added_token)
        if self._added_rx is not None:
            for part in self._added_rx.split(text):
                if not part:
                    continue
                segments.append((part, bool(self._added_rx.fullmatch(part))))
        else:
            segments = [(text, False)]

        ids: list[int] = []
        first = True
        for seg, is_added in segments:
            if is_added:
                ids.append(spec.vocab[seg])
                continue
            normed = apply_normalizer(spec.normalizer, seg)
            for piece in pre_tokenize(spec.pre_tokenizer, normed, is_first=first):
                for token in bpe_merge(piece, spec):
                    ids.extend(self._token_to_ids(token))
            first = False

        if add_special:
            ids = self._post_process(ids)
        return ids

    def _token_to_ids(self, token: str) -> list[int]:
        spec = self.spec
        tid = spec.vocab.get(token)
        if tid is not None:
            return [tid]
        if spec.byte_fallback:
            out = []
            for b in token.encode("utf-8"):
                bid = spec.vocab.get(f"<0x{b:02X}>")
                if bid is not None:
                    out.append(bid)
            if out:
                return out
        if spec.unk_token is not None and spec.unk_token in spec.vocab:
            return [spec.vocab[spec.unk_token]]
        return []

    def _post_process(self, ids: list[int]) -> list[int]:
        pp = self.spec.post_processor
        if pp is None:
            return ids
        t = pp.get("type")
        if t == "Sequence":
            for sub in pp.get("processors", []):
                ids = self._apply_template(sub, ids)
            return ids
        return self._apply_template(pp, ids)

    def _apply_template(self, pp: dict, ids: list[int]) -> list[int]:
        if pp.get("type") != "TemplateProcessing":
            return ids
        out: list[int] = []
        for item in pp.get("single", []):
            if "SpecialToken" in item:
                tok = item["SpecialToken"]["id"]
                tid = self.spec.vocab.get(tok)
                if tid is not None:
                    out.append(tid)
            elif "Sequence" in item:
                out.extend(ids)
        return out or ids

    # -- decode ---------------------------------------------------------

    def decode(self, ids: list[int], skip_special: bool = True) -> str:
        spec = self.spec
        parts: list[str] = []
        byte_buf = bytearray()

        def flush_bytes():
            if byte_buf:
                parts.append(byte_buf.decode("utf-8", errors="replace"))
                byte_buf.clear()

        u2b = unicode_to_bytes()
        for i in ids:
            if skip_special and i in spec.special_ids:
                continue
            tok = spec.id_to_token.get(i)
            if tok is None:
                continue
            if spec.byte_fallback and len(tok) == 6 and tok.startswith("<0x") and tok.endswith(">"):
                byte_buf.append(int(tok[3:5], 16))
                continue
            if self._byte_level and i not in spec.special_ids:
                byte_buf.extend(u2b.get(c, ord("?")) for c in tok)
                continue
            flush_bytes()
            parts.append(tok)
        flush_bytes()
        text = "".join(parts)
        text = self._apply_decoder(spec.decoder, text)
        return text

    def _apply_decoder(self, cfg: dict | None, text: str) -> str:
        if cfg is None:
            return text
        t = cfg.get("type")
        if t == "Sequence":
            for sub in cfg.get("decoders", []):
                text = self._apply_decoder(sub, text)
            return text
        if t == "Replace":
            pat = cfg.get("pattern", {})
            if "String" in pat:
                return text.replace(pat["String"], cfg.get("content", ""))
            if "Regex" in pat:
                return compile_pattern(pat["Regex"]).sub(cfg.get("content", ""), text)
            return text
        if t == "Metaspace":
            rep = cfg.get("replacement", "▁")
            text = text.replace(rep, " ")
            return text[1:] if text.startswith(" ") else text
        if t == "Strip":
            content = cfg.get("content", " ")
            n = cfg.get("start", 0)
            i = 0
            while n > 0 and text.startswith(content, i):
                i += len(content)
                n -= 1
            return text[i:]
        if t in ("ByteLevel", "ByteFallback", "Fuse"):
            return text  # handled inline during id→text assembly
        return text
