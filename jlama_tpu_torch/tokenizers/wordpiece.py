"""WordPiece tokenizer (BERT family): a copy of
`jlama_tpu/tokenizers/wordpiece.py`.

BertNormalizer text cleanup, BERT pre-tokenization, greedy longest-match
with the `##` continuation prefix, [CLS]/[SEP] wrapping via the
post-processor template. The decoder's three punctuation clean-ups match
ASCII only, so the standard library's `re` gives what `regex` gives there.
"""

from __future__ import annotations

import re

from .bpe import apply_normalizer, _bert_pre_tokenize
from .model import TokenizerSpec


class WordPieceTokenizer:
    def __init__(self, spec: TokenizerSpec):
        self.spec = spec
        self.prefix = spec.continuing_subword_prefix or "##"
        self.max_chars_per_word = 100

    def encode(self, text: str, add_special: bool = True) -> list[int]:
        spec = self.spec
        normed = apply_normalizer(spec.normalizer, text)
        words = _bert_pre_tokenize(normed)
        unk = spec.vocab.get(spec.unk_token or "[UNK]")
        ids: list[int] = []
        for w in words:
            if len(w) > self.max_chars_per_word:
                if unk is not None:
                    ids.append(unk)
                continue
            ids.extend(self._encode_word(w, unk))
        if add_special:
            ids = self._wrap(ids)
        return ids

    def _encode_word(self, word: str, unk: int | None) -> list[int]:
        spec = self.spec
        out: list[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = self.prefix + sub
                if sub in spec.vocab:
                    cur = spec.vocab[sub]
                    break
                end -= 1
            if cur is None:
                return [unk] if unk is not None else []
            out.append(cur)
            start = end
        return out

    def _wrap(self, ids: list[int]) -> list[int]:
        spec = self.spec
        pp = spec.post_processor or {}
        if pp.get("type") == "TemplateProcessing":
            out: list[int] = []
            for item in pp.get("single", []):
                if "SpecialToken" in item:
                    tid = spec.vocab.get(item["SpecialToken"]["id"])
                    if tid is not None:
                        out.append(tid)
                elif "Sequence" in item:
                    out.extend(ids)
            return out or ids
        return ids

    def decode(self, ids: list[int], skip_special: bool = True) -> str:
        spec = self.spec
        toks = []
        for i in ids:
            if skip_special and i in spec.special_ids:
                continue
            t = spec.id_to_token.get(i)
            if t is None:
                continue
            toks.append(t)
        text = ""
        for t in toks:
            if t.startswith(self.prefix):
                text += t[len(self.prefix):]
            else:
                if text:
                    text += " "
                text += t
        # re-attach punctuation like the canonical cleanup
        text = re.sub(r" ([\.\,\!\?\'\:\;\)])", r"\1", text)
        text = re.sub(r"\( ", "(", text)
        text = re.sub(r" ' ", "'", text)
        return text
