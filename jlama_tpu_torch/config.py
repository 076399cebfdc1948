"""Canonical model configuration parsed from HuggingFace config.json.

A copy of `jlama_tpu/config.py` (the port imports nothing of the JAX
package): one canonical dataclass covering all nine supported families, with
derived GQA fields, softcaps/multipliers and RoPE parameters (linear and
llama3 scaling). Differences from the original: gemma's bf16-rounded
embedding scale is rounded with torch instead of `ml_dtypes`, and
`load_config` reads local directories only.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

SUPPORTED_ARCHITECTURES = (
    "llama",
    "mistral",
    "mixtral",
    "gemma",
    "gemma2",
    "qwen2",
    "granite",
    "gpt2",
    "bert",
)


@dataclass
class RopeScaling:
    rope_type: str = "default"  # default | linear | llama3
    factor: float = 1.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position_embeddings: int = 8192


@dataclass
class ModelConfig:
    model_type: str
    context_length: int
    embedding_length: int  # hidden_size
    hidden_length: int  # intermediate (FFN) size
    n_heads: int
    n_kv_heads: int
    n_layers: int
    vocab_size: int
    head_size: int
    norm_eps: float = 1e-5
    activation: str = "silu"  # silu | gelu | gelu_pytorch_tanh | tanh
    rope_theta: float = 10000.0
    rope_scaling: RopeScaling = field(default_factory=RopeScaling)
    bos_token_id: int | None = None
    eos_token_ids: tuple[int, ...] = ()
    tie_word_embeddings: bool = False

    # attention details
    attn_qkv_bias: bool = False  # qwen2, gpt2, bert
    attn_out_bias: bool = False  # gpt2, bert
    mlp_bias: bool = False  # gpt2, bert
    causal: bool = True  # False for BERT
    learned_pos_embeddings: bool = False  # gpt2, bert
    sliding_window: int | None = None  # gemma2/mistral (alternating for gemma2)
    query_pre_attn_scalar: float | None = None  # gemma2

    # norm details
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm
    rmsnorm_weight_offset: float = 0.0  # 1.0 for gemma ("(1+w)*x")
    post_attn_norm: bool = False  # gemma2: extra norms around blocks
    pre_ff_norm: bool = True
    post_ff_norm: bool = False  # gemma2

    # scaling knobs (gemma / gemma2 / granite)
    embedding_scale: float | None = None  # gemma: bf16-rounded sqrt(hidden)
    final_logit_softcap: float | None = None
    attn_logit_softcap: float | None = None
    residual_multiplier: float | None = None  # granite
    attention_multiplier: float | None = None  # granite
    logit_multiplier: float | None = None  # granite logits_scaling (divides)

    # MoE (mixtral)
    n_experts: int = 0
    n_experts_per_token: int = 0

    # BERT / classification
    type_vocab_size: int = 0
    classification_labels: dict[int, str] | None = None
    pooling_type: str | None = None

    # runtime layout marker: >1 when fused qkv/gate-up rows were interleaved
    # per tp shard for the shard_map forward (models.base.fuse_params tp=N);
    # the standard forward then regroups the fused projection's output
    # columns before splitting (nn.layers). Inside shard_map the local cfg
    # resets this to 1 (each shard's block is a plain [q;k;v] concat).
    fused_tp: int = 1

    raw: dict[str, Any] = field(default_factory=dict, repr=False)

    # ---- derived (reference Config.java:254-268) ----
    @property
    def attention_length(self) -> int:
        return self.n_heads * self.head_size

    @property
    def kv_length(self) -> int:
        return self.n_kv_heads * self.head_size

    @property
    def head_group_size(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def is_gqa(self) -> bool:
        return self.n_kv_heads < self.n_heads


def _eos_list(v) -> tuple[int, ...]:
    if v is None:
        return ()
    if isinstance(v, int):
        return (v,)
    return tuple(int(x) for x in v)


def _bf16_round(x: float) -> float:
    """Round a float to bfloat16 precision (gemma's embedding scale is
    stored bf16-rounded). f32 first, then round-to-nearest-even to bf16,
    as `ml_dtypes` does."""
    import torch

    t = torch.tensor(x, dtype=torch.float32)
    return float(t.to(torch.bfloat16).to(torch.float32))


def _parse_rope_scaling(d: dict | None) -> RopeScaling:
    if not d:
        return RopeScaling()
    rope_type = d.get("rope_type", d.get("type", "default"))
    return RopeScaling(
        rope_type=rope_type,
        factor=float(d.get("factor", 1.0)),
        low_freq_factor=float(d.get("low_freq_factor", 1.0)),
        high_freq_factor=float(d.get("high_freq_factor", 4.0)),
        original_max_position_embeddings=int(
            d.get("original_max_position_embeddings", 8192)
        ),
    )


def from_hf_config(cfg: dict[str, Any]) -> ModelConfig:
    """Build the canonical config from a parsed HF config.json dict."""
    mt = cfg.get("model_type")
    if mt not in SUPPORTED_ARCHITECTURES:
        raise ValueError(f"unsupported model_type: {mt!r}")

    if mt == "gpt2":
        n_embd = cfg["n_embd"]
        return ModelConfig(
            model_type=mt,
            context_length=cfg.get("n_positions", 1024),
            embedding_length=n_embd,
            hidden_length=cfg.get("n_inner") or 4 * n_embd,
            n_heads=cfg["n_head"],
            n_kv_heads=cfg["n_head"],
            n_layers=cfg["n_layer"],
            vocab_size=cfg["vocab_size"],
            head_size=n_embd // cfg["n_head"],
            norm_eps=cfg.get("layer_norm_epsilon", 1e-5),
            activation=cfg.get("activation_function", "gelu"),
            bos_token_id=cfg.get("bos_token_id"),
            eos_token_ids=_eos_list(cfg.get("eos_token_id")),
            tie_word_embeddings=True,
            attn_qkv_bias=True,
            attn_out_bias=True,
            mlp_bias=True,
            norm_type="layernorm",
            learned_pos_embeddings=True,
            rope_theta=0.0,
            raw=cfg,
        )

    if mt == "bert":
        hidden = cfg["hidden_size"]
        id2label = cfg.get("id2label")
        return ModelConfig(
            model_type=mt,
            context_length=cfg.get("max_position_embeddings", 512),
            embedding_length=hidden,
            hidden_length=cfg["intermediate_size"],
            n_heads=cfg["num_attention_heads"],
            n_kv_heads=cfg["num_attention_heads"],
            n_layers=cfg["num_hidden_layers"],
            vocab_size=cfg["vocab_size"],
            head_size=hidden // cfg["num_attention_heads"],
            norm_eps=cfg.get("layer_norm_eps", 1e-12),
            activation=cfg.get("hidden_act", "gelu"),
            attn_qkv_bias=True,
            attn_out_bias=True,
            mlp_bias=True,
            norm_type="layernorm",
            causal=False,
            learned_pos_embeddings=True,
            rope_theta=0.0,
            type_vocab_size=cfg.get("type_vocab_size", 2),
            classification_labels=(
                {int(k): v for k, v in id2label.items()} if id2label else None
            ),
            raw=cfg,
        )

    # decoder families sharing the llama skeleton
    hidden = cfg["hidden_size"]
    n_heads = cfg["num_attention_heads"]
    head_size = cfg.get("head_dim") or hidden // n_heads
    mc = ModelConfig(
        model_type=mt,
        context_length=cfg.get("max_position_embeddings", 2048),
        embedding_length=hidden,
        hidden_length=cfg["intermediate_size"],
        n_heads=n_heads,
        n_kv_heads=cfg.get("num_key_value_heads", n_heads),
        n_layers=cfg["num_hidden_layers"],
        vocab_size=cfg["vocab_size"],
        head_size=head_size,
        norm_eps=cfg.get("rms_norm_eps", 1e-5),
        activation=cfg.get("hidden_act", cfg.get("hidden_activation", "silu")),
        rope_theta=float(cfg.get("rope_theta", 10000.0)),
        rope_scaling=_parse_rope_scaling(cfg.get("rope_scaling")),
        bos_token_id=cfg.get("bos_token_id"),
        eos_token_ids=_eos_list(cfg.get("eos_token_id")),
        tie_word_embeddings=cfg.get("tie_word_embeddings", False),
        sliding_window=cfg.get("sliding_window"),
        raw=cfg,
    )

    if mt == "qwen2":
        mc.attn_qkv_bias = True  # cf. Qwen2Model.java:75-77
    if mt in ("gemma", "gemma2"):
        mc.rmsnorm_weight_offset = 1.0  # cf. RMSNorm weightAdjustment
        mc.tie_word_embeddings = True
        mc.embedding_scale = _bf16_round(math.sqrt(hidden))
        mc.activation = cfg.get(
            "hidden_activation", cfg.get("hidden_act", "gelu_pytorch_tanh")
        )
    if mt == "gemma2":
        mc.post_attn_norm = True
        mc.post_ff_norm = True
        mc.final_logit_softcap = cfg.get("final_logit_softcapping")
        mc.attn_logit_softcap = cfg.get("attn_logit_softcapping")
        mc.query_pre_attn_scalar = cfg.get("query_pre_attn_scalar")
    if mt == "granite":
        mc.residual_multiplier = cfg.get("residual_multiplier")
        mc.attention_multiplier = cfg.get("attention_multiplier")
        mc.embedding_scale = cfg.get("embedding_multiplier")
        mc.logit_multiplier = cfg.get("logits_scaling")
        mc.tie_word_embeddings = cfg.get("tie_word_embeddings", True)
    if mt == "mixtral":
        mc.n_experts = cfg.get("num_local_experts", 8)
        mc.n_experts_per_token = cfg.get("num_experts_per_tok", 2)
    return mc


def load_config(model_dir: str | Path) -> ModelConfig:
    """The config.json of a model directory, or of a model URL (`http(s)://`)."""
    s = str(model_dir)
    if s.startswith("http://") or s.startswith("https://"):
        import urllib.request

        with urllib.request.urlopen(s.rstrip("/") + "/config.json", timeout=60) as r:
            return from_hf_config(json.loads(r.read()))
    p = Path(model_dir) / "config.json"
    return from_hf_config(json.loads(p.read_text()))
