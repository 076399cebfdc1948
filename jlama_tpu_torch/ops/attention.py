"""K3: flash prefill attention (counterpart of
`jlama_tpu/ops/pallas_attention.py::flash_prefill`).

Replaces the TPU kernel `jlama_tpu/ops/pallas_attention.py:_flash_kernel`
(launched by `_flash_prefill_jit`) with the hand-written CUDA kernel in
`csrc/flash_prefill.cu`: T > 1 offset-causal GQA attention (query i of a
chunk starting at pos0[b] sees keys ≤ pos0[b] + i), optional softcap and
sliding window, online softmax in f32, no [B, H, T, S] score tensor.

What bounds it on the H100: the operations (4·T·S·hd per head, about half of
them skipped by causality). This first kernel runs them on the CUDA cores
(warp-per-8-query-rows, lane-per-key, shared-memory K/V tiles, causal tile
skipping); tensor cores come in a later PR.

`flash_prefill_plain` is the same function as dense masked attention in
PyTorch. `flash_prefill` runs it for tensors on the CPU only; a CUDA tensor
launches the kernel or raises. The paged decode kernel (K2) comes with the
serving slice.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

NEG_INF = -1e30

_C = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float
_SIGNATURES = {
    "flash_prefill": [_C, _C, _C, _C, _C, _I, _I, _I, _I, _I, _I, _I]
    + [_L] * 12
    + [_F, _F, _I, _I, _C]
}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_SIZES = (64, 128)


def flash_prefill_plain(q, k, v, pos0, scale, softcap=None, causal=True, window=None):
    """Dense reference: q [B,H,T,hd], k/v [B,n_kv,S,hd], pos0 [B] -> [B,H,T,hd]."""
    B, H, T, hd = q.shape
    n_kv, S = k.shape[1], k.shape[2]
    g = H // n_kv
    qg = q.reshape(B, n_kv, g, T, hd).to(torch.float32)
    s = torch.einsum("bkgth,bksh->bkgts", qg, k.to(torch.float32)) * scale
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    q_pos = pos0.to(torch.int64)[:, None] + torch.arange(T, device=q.device)[None, :]
    k_pos = torch.arange(S, device=q.device)[None, None, :]
    mask = torch.ones((B, T, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos[:, :, None]
    if window is not None:
        mask &= k_pos > q_pos[:, :, None] - window
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgts,bksh->bkgth", p, v.to(torch.float32))
    return out.reshape(B, H, T, hd).to(q.dtype)


def flash_prefill(q, k, v, pos0, scale, softcap=None, causal=True, window=None):
    """q [B,H,T,hd], k/v [B,n_kv,S,hd] (any batch/head/row strides, unit last
    stride), pos0 [B] int -> [B,H,T,hd] in q's dtype."""
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k, v, pos0, scale, softcap, causal, window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill: unsupported device {q.device}")
    B, H, T, hd = q.shape
    n_kv, S = k.shape[1], k.shape[2]
    if k.shape != (B, n_kv, S, hd) or v.shape != k.shape or H % n_kv:
        raise ValueError(f"flash_prefill: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if hd not in HEAD_SIZES:
        raise ValueError(f"flash_prefill: head size {hd} not in {HEAD_SIZES}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_prefill: dtypes {q.dtype}/{k.dtype}/{v.dtype}")
    for t in (q, k, v):
        if t.device != q.device or t.stride(-1) != 1:
            raise ValueError("flash_prefill: q/k/v on one device with a unit last stride")
    pos0 = pos0.to(device=q.device, dtype=torch.int32).contiguous()
    if pos0.shape != (B,):
        raise ValueError(f"flash_prefill: pos0 shape {tuple(pos0.shape)} != ({B},)")
    # [B, T, H, hd] storage seen as [B, H, T, hd]: the caller's transpose
    # back to token-major is then free
    out = torch.empty((B, T, H, hd), dtype=q.dtype, device=q.device).transpose(1, 2)
    lib = _build.load("flash_prefill", _SIGNATURES)
    err = lib.flash_prefill(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), pos0.data_ptr(),
        _DTYPE_CODE[q.dtype], B, H, n_kv, T, S, hd,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        float(scale), float(softcap or 0.0), int(window or 0), int(bool(causal)),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "flash_prefill")
    flash_prefill.launches += 1
    return out


flash_prefill.launches = 0
