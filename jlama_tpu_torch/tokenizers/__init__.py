"""Tokenizers: tokenizer.json-driven BPE (copies of `jlama_tpu.tokenizers`).

WordPiece (BERT) comes with the BERT slice of the port.
"""

from pathlib import Path

from .model import TokenizerSpec, load_tokenizer_spec, parse_tokenizer_json
from .bpe import BPETokenizer


class Tokenizer:
    """Facade with encode/decode and the BOS/EOS ids."""

    def __init__(self, spec: TokenizerSpec):
        self.spec = spec
        if spec.model_type == "WordPiece":
            raise NotImplementedError(
                "WordPiece tokenizers are not ported yet (BERT slice)"
            )
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
    "load_tokenizer",
    "load_tokenizer_spec",
    "parse_tokenizer_json",
]
