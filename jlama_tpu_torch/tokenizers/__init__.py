"""Tokenizers: tokenizer.json-driven BPE and WordPiece (copies of
`jlama_tpu.tokenizers`)."""

from pathlib import Path

from .model import TokenizerSpec, load_tokenizer_spec, parse_tokenizer_json
from .bpe import BPETokenizer
from .wordpiece import WordPieceTokenizer


class Tokenizer:
    """Facade with encode/decode and the BOS/EOS ids."""

    def __init__(self, spec: TokenizerSpec):
        self.spec = spec
        if spec.model_type == "WordPiece":
            self._impl = WordPieceTokenizer(spec)
        else:
            self._impl = BPETokenizer(spec)

    def encode(self, text: str, add_special: bool = True) -> list[int]:
        return self._impl.encode(text, add_special=add_special)

    def decode(self, ids, skip_special: bool = True) -> str:
        return self._impl.decode(list(ids), skip_special=skip_special)

    @property
    def bos_id(self):
        t = self.spec.bos_token
        return self.spec.vocab.get(t) if t else None

    @property
    def eos_id(self):
        t = self.spec.eos_token
        return self.spec.vocab.get(t) if t else None


def load_tokenizer(model_dir: str | Path) -> Tokenizer:
    return Tokenizer(load_tokenizer_spec(model_dir))


__all__ = [
    "Tokenizer",
    "TokenizerSpec",
    "BPETokenizer",
    "WordPieceTokenizer",
    "load_tokenizer",
    "load_tokenizer_spec",
    "parse_tokenizer_json",
]
