"""Transformer forward pass over a per-layer parameter list (counterpart of
`jlama_tpu/models/base.py`, its "unrolled" layer mode; there is no scan).

Param tree layout (leaves are tensors or QArrays):
  params = {
    "embed": [V, D],                     # token embeddings
    "layers": [ {key: tensor} per layer ],  # MoE: router + experts.w1/w2/w3 [E, ...]
    "final_norm.weight": [D],
    "lm_head": [V, D],                   # absent when tied
  }
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import ModelConfig
from ..nn import layers as L
from ..nn.qarray import QArray
from ..nn.rope import rope_cos_sin, rope_frequencies
from ..ops.linear import linear


class KVCache(NamedTuple):
    """Dense per-layer KV cache: layers[l] = KVLayerCache(k, v), each
    [B, n_kv_heads, S, head_size]."""

    layers: list

    @staticmethod
    def init(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
             device="cpu") -> "KVCache":
        shape = (batch, cfg.n_kv_heads, max_len, cfg.head_size)
        return KVCache([
            L.KVLayerCache(torch.zeros(shape, dtype=dtype, device=device),
                           torch.zeros(shape, dtype=dtype, device=device))
            for _ in range(cfg.n_layers)
        ])

    @property
    def max_len(self) -> int:
        return self.layers[0].k.shape[2]


def _embed(params: dict, cfg: ModelConfig, tokens: torch.Tensor, dtype) -> torch.Tensor:
    emb = params["embed"]
    if isinstance(emb, QArray):
        # gather the rows FIRST, then dequantize only those
        x = emb[tokens].dequantize(torch.float32)
    else:
        x = emb[tokens].to(torch.float32)
    if cfg.embedding_scale is not None:
        x = x * cfg.embedding_scale
    return x.to(dtype)


def _block(x, layer_params: dict, cfg: ModelConfig, positions, cache, cos, sin,
           sliding_window, attn_window=None):
    """One pre-norm transformer block."""
    rm = cfg.residual_multiplier  # granite; None: 1 (no multiply launched)
    h = L.norm(x, layer_params, cfg, "attn_norm")
    attn_out, cache = L.self_attention_block(
        h, layer_params, cfg, positions, cache, cos, sin, sliding_window, attn_window,
    )
    if cfg.post_attn_norm:
        attn_out = L.norm(attn_out, layer_params, cfg, "post_attn_norm")
    x = x + (attn_out if rm is None else rm * attn_out)
    h = L.norm(x, layer_params, cfg, "ff_norm")
    ff = L.moe_block(h, layer_params, cfg) if cfg.n_experts else L.mlp_block(h, layer_params, cfg)
    if cfg.post_ff_norm:
        ff = L.norm(ff, layer_params, cfg, "post_ff_norm")
    x = x + (ff if rm is None else rm * ff)
    return x, cache


def rope_inv_freq(cfg: ModelConfig, device) -> torch.Tensor:
    return torch.from_numpy(rope_frequencies(cfg)).to(device)


def forward_hidden(
    params: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B, T]
    positions: torch.Tensor,  # [B, T] absolute positions
    kv_cache: KVCache | tuple[list, torch.Tensor] | None,
    dtype=torch.bfloat16,
    attn_window: int | None = None,
    inv_freq: torch.Tensor | None = None,
) -> tuple[torch.Tensor, KVCache | tuple[list, torch.Tensor] | None]:
    """Run embedding + all transformer layers. Returns (hidden [B,T,D], cache).

    kv_cache: None, a dense `KVCache`, or a paged cache `(states,
    page_tables)`: a per-layer list of `PagedKVState` pools (views of the
    stacked pool, see `kv.paged.PagedKVCache.layer_states`) and one [B, P]
    int32 page-table tensor. Every cache is written in place and returned as
    it came.

    inv_freq: the RoPE inverse frequencies on the tokens' device (see
    `rope_inv_freq`); a caller in a decode loop passes them so the step does
    no host-to-device copy, which would synchronize the stream.
    """
    if cfg.model_type in ("gpt2", "bert") or cfg.learned_pos_embeddings:
        raise NotImplementedError(
            f"{cfg.model_type}: only the Llama-family and Mixtral decoders are ported"
        )
    x = _embed(params, cfg, tokens, dtype)
    if cfg.rope_theta:
        if inv_freq is None:
            inv_freq = rope_inv_freq(cfg, tokens.device)
        cos, sin = rope_cos_sin(positions, inv_freq)
    else:
        cos = sin = None

    # per-layer static windows (gemma2 alternates sliding/global attention;
    # the mistral window is ignored, as in the JAX package)
    for l, layer in enumerate(params["layers"]):
        sw = None
        if cfg.sliding_window is not None and cfg.model_type == "gemma2" and l % 2 == 0:
            sw = cfg.sliding_window
        if kv_cache is None:
            cache_l = None
        elif isinstance(kv_cache, KVCache):
            cache_l = kv_cache.layers[l]
        else:
            states, page_tables = kv_cache
            cache_l = L.PagedLayerCache(states[l].k_pool, states[l].v_pool, page_tables)
        x, _ = _block(x, layer, cfg, positions, cache_l, cos, sin, sw, attn_window)
    return x, kv_cache


def _concat_rows(ws):
    """Concatenate weights along the output-row axis (tensors or q4/q8
    QArrays: block scales are per row along the input axis, so a row concat
    never crosses a block). q4s is refused: fuse first, then re-quantize
    (`ops/w8a8.py::prepare_params_for_w8a8`), as the JAX scheduler does."""
    if isinstance(ws[0], QArray):
        if any(w.fmt == "q4s" for w in ws):
            raise ValueError("q4s weights are not fused: fuse the q4 weights first, "
                             "then convert them with prepare_params_for_w8a8")
        return QArray(
            torch.cat([w.data for w in ws], dim=-2),
            torch.cat([w.scales for w in ws], dim=-2),
            ws[0].fmt,
        )
    return torch.cat(ws, dim=-2)


def _fuse_layer_dict(d: dict) -> dict:
    out = dict(d)
    qkv = [d.get("wq"), d.get("wk"), d.get("wv")]
    fmts = {w.fmt if isinstance(w, QArray) else None for w in qkv if w is not None}
    biases = [d.get("wq.bias"), d.get("wk.bias"), d.get("wv.bias")]
    n_bias = sum(b is not None for b in biases)
    # bias presence must be uniform (all three or none)
    if all(w is not None for w in qkv) and len(fmts) == 1 and n_bias in (0, 3):
        out["wqkv"] = _concat_rows(qkv)
        if n_bias == 3:
            out["wqkv.bias"] = torch.cat(biases, dim=-1)
        for k in ("wq", "wk", "wv", "wq.bias", "wk.bias", "wv.bias"):
            out.pop(k, None)
    w1, w3 = d.get("w1"), d.get("w3")
    if (
        w1 is not None
        and w3 is not None
        and "w1.bias" not in d
        and isinstance(w1, QArray) == isinstance(w3, QArray)
        and (not isinstance(w1, QArray) or w1.fmt == w3.fmt)
    ):
        out["w13"] = _concat_rows([w1, w3])
        out.pop("w1")
        out.pop("w3")
    return out


def fuse_params(params: dict) -> dict:
    """Fuse QKV into one [qdim+2*kvdim, D] matmul and gate/up into one
    [2H, D] matmul (one-time concat, tp=1; the same rows hit the same
    reduction, so the numbers do not change). MoE experts stay as they are:
    a concat of Mixtral-8x7B's w1 and w3 would copy 18.8 GB."""
    out = dict(params)
    out["layers"] = [_fuse_layer_dict(d) for d in params["layers"]]
    return out


def prepare_moe_ragged(params: dict) -> dict:
    """Float MoE experts transposed once into the grouped-matmul layout
    `experts.w*_t` [E, in, out] (`jlama_tpu/models/base.py:prepare_moe_ragged`).
    q4 experts stay as they are: K6 reads their [E, out, in] layout, whose
    block-32 quantization axis a transpose would move."""
    out = dict(params)
    layers = []
    for d in params["layers"]:
        if "experts.w1" in d and not isinstance(d["experts.w1"], QArray):
            d = dict(d)
            for k in ("experts.w1", "experts.w2", "experts.w3"):
                d[k + "_t"] = d.pop(k).transpose(-1, -2)
        layers.append(d)
    out["layers"] = layers
    return out


def check_moe_device(params: dict, device) -> None:
    """Raise where MoE experts that only the CPU runs would meet the card:
    float experts have no kernel there (ROADMAP: float experts on the card)."""
    if torch.device(device).type == "cpu":
        return
    for d in params["layers"]:
        w1 = d.get("experts.w1", d.get("experts.w1_t"))
        if w1 is not None and not isinstance(w1, QArray):
            raise NotImplementedError(
                "float MoE experts run on the CPU only; on the card quantize them to q4 "
                "(ROADMAP: float experts on the card)")


def final_hidden(params: dict, cfg: ModelConfig, hidden: torch.Tensor) -> torch.Tensor:
    """Apply the output norm."""
    return L.norm(hidden, params, cfg, "final_norm")


def lm_logits(params: dict, cfg: ModelConfig, hidden: torch.Tensor) -> torch.Tensor:
    """Project to f32 vocab logits with the multiplier/softcap semantics."""
    h = final_hidden(params, cfg, hidden)
    w = params.get("lm_head", params["embed"])
    logits = linear(h, w, out_dtype=torch.float32)
    if cfg.logit_multiplier is not None:
        logits = logits / cfg.logit_multiplier
    if cfg.final_logit_softcap is not None:
        logits = torch.tanh(logits / cfg.final_logit_softcap) * cfg.final_logit_softcap
    return logits


def forward_logits(params, cfg, tokens, positions, kv_cache=None, dtype=torch.bfloat16):
    hidden, cache = forward_hidden(params, cfg, tokens, positions, kv_cache, dtype)
    return lm_logits(params, cfg, hidden), cache


def params_to(params: dict, device) -> dict:
    """The param tree with every tensor and QArray moved to `device`."""
    def mv(v):
        if isinstance(v, list):
            return [mv(x) for x in v]
        if isinstance(v, dict):
            return {k: mv(x) for k, x in v.items()}
        return v.to(device)

    return mv(params)
