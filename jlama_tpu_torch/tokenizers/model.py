"""tokenizer.json parsing → TokenizerSpec.

A copy of `jlama_tpu/tokenizers/model.py`: vocab/merges with ranks, added tokens + split regex, normalizer and
pre-tokenizer configs, byte-fallback and legacy flags, post-processor
templates, and chat-template discovery from tokenizer_config.json
(incl. `hasToolSupport` sniffing, TokenizerModel.java:190-197).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any


@dataclass
class AddedToken:
    id: int
    content: str
    special: bool = False
    lstrip: bool = False
    rstrip: bool = False
    normalized: bool = False
    single_word: bool = False


@dataclass
class TokenizerSpec:
    model_type: str  # "BPE" | "WordPiece" | "Unigram"
    vocab: dict[str, int]
    merges: list[tuple[str, str]] = field(default_factory=list)
    merge_ranks: dict[tuple[str, str], int] = field(default_factory=dict)
    unk_token: str | None = None
    continuing_subword_prefix: str | None = None
    byte_fallback: bool = False
    ignore_merges: bool = False
    fuse_unk: bool = False
    normalizer: dict | None = None
    pre_tokenizer: dict | None = None
    decoder: dict | None = None
    post_processor: dict | None = None
    added_tokens: list[AddedToken] = field(default_factory=list)
    # from tokenizer_config.json
    chat_template: str | dict[str, str] | None = None
    bos_token: str | None = None
    eos_token: str | None = None
    add_bos_token: bool | None = None
    add_eos_token: bool | None = None

    id_to_token: dict[int, str] = field(default_factory=dict)
    special_ids: set[int] = field(default_factory=set)

    @property
    def has_tool_support(self) -> bool:
        t = self.chat_template
        if t is None:
            return False
        if isinstance(t, dict):
            return "tool_use" in t or any("tools" in v for v in t.values())
        return "tools" in t

    def template_for(self, name: str) -> str | None:
        t = self.chat_template
        if t is None:
            return None
        if isinstance(t, str):
            return t
        return t.get(name, t.get("default"))


def _token_content(t: Any) -> str:
    return t if isinstance(t, str) else t.get("content")


def parse_tokenizer_json(data: dict, config: dict | None = None) -> TokenizerSpec:
    model = data.get("model", {})
    mtype = model.get("type", "BPE")
    vocab = dict(model.get("vocab", {}))

    merges_raw = model.get("merges", [])
    merges: list[tuple[str, str]] = []
    for m in merges_raw:
        if isinstance(m, str):
            a, _, b = m.partition(" ")
            merges.append((a, b))
        else:
            merges.append((m[0], m[1]))

    added = []
    for t in data.get("added_tokens", []):
        added.append(
            AddedToken(
                id=t["id"],
                content=t["content"],
                special=t.get("special", False),
                lstrip=t.get("lstrip", False),
                rstrip=t.get("rstrip", False),
                normalized=t.get("normalized", False),
                single_word=t.get("single_word", False),
            )
        )
        vocab.setdefault(t["content"], t["id"])

    spec = TokenizerSpec(
        model_type=mtype,
        vocab=vocab,
        merges=merges,
        merge_ranks={m: i for i, m in enumerate(merges)},
        unk_token=model.get("unk_token"),
        continuing_subword_prefix=model.get("continuing_subword_prefix"),
        byte_fallback=model.get("byte_fallback", False),
        ignore_merges=model.get("ignore_merges", False),
        fuse_unk=model.get("fuse_unk", False),
        normalizer=data.get("normalizer"),
        pre_tokenizer=data.get("pre_tokenizer"),
        decoder=data.get("decoder"),
        post_processor=data.get("post_processor"),
        added_tokens=added,
    )
    spec.id_to_token = {v: k for k, v in vocab.items()}
    spec.special_ids = {t.id for t in added if t.special}

    if config:
        spec.chat_template = config.get("chat_template")
        spec.bos_token = _token_content(config.get("bos_token"))
        spec.eos_token = _token_content(config.get("eos_token"))
        spec.add_bos_token = config.get("add_bos_token")
        spec.add_eos_token = config.get("add_eos_token")
    return spec


def load_tokenizer_spec(model_dir: str | Path) -> TokenizerSpec:
    """tokenizer.json (and tokenizer_config.json where present) of a model
    directory or of a model URL (`http(s)://`)."""
    from ..st.http_loader import fetch_json, is_url

    if is_url(model_dir):
        base = str(model_dir).rstrip("/")
        data = fetch_json(base + "/tokenizer.json")
        if data is None:
            raise FileNotFoundError(f"no tokenizer.json at {base}")
        return parse_tokenizer_json(data, fetch_json(base + "/tokenizer_config.json"))
    model_dir = Path(model_dir)
    data = json.loads((model_dir / "tokenizer.json").read_text(encoding="utf-8"))
    config = None
    cfg_path = model_dir / "tokenizer_config.json"
    if cfg_path.exists():
        config = json.loads(cfg_path.read_text(encoding="utf-8"))
    return parse_tokenizer_json(data, config)
