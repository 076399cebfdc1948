"""Block-wise Q4/Q8 quantization numerics (the "JQ4" scheme).

A copy of `jlama_tpu/quant/blockq.py`. The numpy functions are the
bit-exact checkpoint path and are copied as they are; the jnp functions of
the original become torch functions here, and `q4_quantize` and
`q8_quantize_checkpoint` are the numpy quantizers' torch counterparts, on
any device and equal to them byte for byte (the quantizer runs them on the
card).

- Q4: blocks of 32 elements along the last axis. The block scale is
  ``signed_extreme / -8``. Each element quantizes to
  ``min(15, trunc(v / scale + 8.5))`` stored as a nibble; byte ``j`` of a
  block (j in [0,16)) packs element ``j`` in the low nibble and element
  ``j+16`` in the high nibble. Dequant is ``(nibble - 8) * scale``.
- Q8: blocks of 32, scale = amax/127, value = round_half_up(v * 127/amax),
  stored int8.

Scales are float32, shape ``[..., n/32]``.
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK_SIZE = 32
HALF_BLOCK = 16


def _check_last_dim(n: int) -> None:
    if n % BLOCK_SIZE != 0:
        raise ValueError(f"last dim {n} is not a multiple of {BLOCK_SIZE}")


# ---------------------------------------------------------------------------
# Q4 — NumPy (bit-exact checkpoint path)
# ---------------------------------------------------------------------------


def q4_quantize_np(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Quantize to JQ4. Returns (packed uint8 [..., n/2], scales f32 [..., n/32])."""
    _check_last_dim(x.shape[-1])
    shape = x.shape
    xb = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, BLOCK_SIZE)
    absx = np.abs(xb)
    idx = np.argmax(absx, axis=1)  # first max wins ties
    signed_extreme = xb[np.arange(xb.shape[0]), idx]
    scale = (signed_extreme / np.float32(-8.0)).astype(np.float32)
    nonzero = scale != 0
    iscale = np.divide(
        np.float32(1.0), scale, out=np.zeros_like(scale), where=nonzero
    ).astype(np.float32)
    scaled = (xb * iscale[:, None]).astype(np.float32) + np.float32(8.5)
    q = np.minimum(np.float32(15.0), np.trunc(scaled)).astype(np.uint8)
    lo, hi = q[:, :HALF_BLOCK], q[:, HALF_BLOCK:]
    packed = (lo | (hi << 4)).astype(np.uint8)
    return (
        packed.reshape(*shape[:-1], shape[-1] // 2),
        scale.reshape(*shape[:-1], shape[-1] // BLOCK_SIZE),
    )


def q4_dequantize_np(packed: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """Dequantize JQ4 back to float32 with the original shape."""
    n = packed.shape[-1] * 2
    pb = packed.reshape(-1, HALF_BLOCK)
    lo = (pb & 0x0F).astype(np.int8) - 8
    hi = ((pb >> 4) & 0x0F).astype(np.int8) - 8
    vals = np.concatenate([lo, hi], axis=1).astype(np.float32)  # [blocks, 32]
    out = vals * scales.reshape(-1, 1).astype(np.float32)
    return out.reshape(*packed.shape[:-1], n)


def q4_unpack_np(packed: np.ndarray) -> np.ndarray:
    """Unpack JQ4 nibbles to int8 values in [-8, 7], original element order."""
    n = packed.shape[-1] * 2
    pb = packed.reshape(-1, HALF_BLOCK)
    lo = (pb & 0x0F).astype(np.int8) - 8
    hi = ((pb >> 4) & 0x0F).astype(np.int8) - 8
    return np.concatenate([lo, hi], axis=1).reshape(*packed.shape[:-1], n)


def q4_pack_np(vals: np.ndarray) -> np.ndarray:
    """Pack int8 values in [-8,7] into the JQ4 nibble layout."""
    _check_last_dim(vals.shape[-1])
    vb = (vals.reshape(-1, BLOCK_SIZE).astype(np.int16) + 8).astype(np.uint8)
    packed = (vb[:, :HALF_BLOCK] | (vb[:, HALF_BLOCK:] << 4)).astype(np.uint8)
    return packed.reshape(*vals.shape[:-1], vals.shape[-1] // 2)


# ---------------------------------------------------------------------------
# Q8 — NumPy
# ---------------------------------------------------------------------------


def q8_quantize_np(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Quantize to block-32 int8. Returns (int8 [...], scales f32 [..., n/32])."""
    _check_last_dim(x.shape[-1])
    shape = x.shape
    xb = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, BLOCK_SIZE)
    amax = np.max(np.abs(xb), axis=1)
    nonzero = amax > 0
    iscale = np.divide(
        np.float32(127.0), amax, out=np.zeros_like(amax), where=nonzero
    ).astype(np.float32)
    scale = np.divide(
        np.float32(1.0), iscale, out=np.zeros_like(iscale), where=nonzero
    ).astype(np.float32)
    # round half up == floor(x + 0.5)
    q = np.floor((xb * iscale[:, None]).astype(np.float32) + np.float32(0.5))
    q = np.clip(q, -127, 127).astype(np.int8)
    return (
        q.reshape(shape),
        scale.reshape(*shape[:-1], shape[-1] // BLOCK_SIZE),
    )


def q8_dequantize_np(q: np.ndarray, scales: np.ndarray) -> np.ndarray:
    qb = q.reshape(-1, BLOCK_SIZE).astype(np.float32)
    out = qb * scales.reshape(-1, 1).astype(np.float32)
    return out.reshape(q.shape)


# ---------------------------------------------------------------------------
# torch versions (on any device)
# ---------------------------------------------------------------------------


def q4_unpack(packed: torch.Tensor) -> torch.Tensor:
    """JQ4 nibbles uint8 [..., n/2] -> int8 values in [-8, 7] [..., n]."""
    n = packed.shape[-1] * 2
    pb = packed.reshape(*packed.shape[:-1], -1, HALF_BLOCK)
    lo = (pb & 0x0F).to(torch.int8) - 8
    hi = (pb >> 4).to(torch.int8) - 8
    return torch.cat([lo, hi], dim=-1).reshape(*packed.shape[:-1], n)


def q4_dequantize(packed: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """JQ4 dequant. packed uint8 [..., n/2] -> float32 [..., n]."""
    vals = q4_unpack(packed)
    shape = vals.shape
    vb = vals.reshape(*shape[:-1], -1, BLOCK_SIZE).to(torch.float32)
    return (vb * scales[..., None].to(torch.float32)).reshape(shape)


def _blocks(x: torch.Tensor) -> torch.Tensor:
    _check_last_dim(x.shape[-1])
    return x.reshape(-1, BLOCK_SIZE).to(torch.float32)


def q4_quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """`q4_quantize_np` on x's device: (packed uint8 [..., n/2], scales f32
    [..., n/32]), the same bytes. Each step rounds as NumPy's does: the
    scale's 1/scale is a true division by a tensor (a division by a Python
    scalar would multiply by its reciprocal on the card), the product and
    the + 8.5 are two roundings (two kernels, no fused multiply-add), and
    `argmax` takes the first of tied magnitudes, as `np.argmax` does."""
    shape = x.shape
    xb = _blocks(x)
    extreme = xb.gather(1, xb.abs().argmax(dim=1, keepdim=True))[:, 0]
    scale = extreme / torch.full_like(extreme, -8.0)
    nonzero = scale != 0
    iscale = torch.where(nonzero, torch.ones_like(scale) / scale, torch.zeros_like(scale))
    scaled = xb * iscale[:, None]
    scaled = scaled + 8.5
    q = torch.clamp(torch.trunc(scaled), max=15.0).to(torch.uint8)
    packed = q[:, :HALF_BLOCK] | (q[:, HALF_BLOCK:] << 4)
    return (packed.reshape(*shape[:-1], shape[-1] // 2),
            scale.reshape(*shape[:-1], shape[-1] // BLOCK_SIZE))


def q8_quantize_checkpoint(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """`q8_quantize_np` on x's device (the checkpoint's I8 tensors): the
    same bytes, scale = 1 / (127 / amax) as NumPy computes it (the
    activation quantizer `q8_quantize` takes amax / 127)."""
    shape = x.shape
    xb = _blocks(x)
    amax = xb.abs().amax(dim=1)
    pos = amax > 0
    zero = torch.zeros_like(amax)
    iscale = torch.where(pos, torch.full_like(amax, 127.0) / amax, zero)
    scale = torch.where(pos, torch.ones_like(amax) / iscale, zero)
    q = xb * iscale[:, None]
    q = torch.floor(q + 0.5)
    q = torch.clamp(q, -127, 127).to(torch.int8)
    return q.reshape(shape), scale.reshape(*shape[:-1], shape[-1] // BLOCK_SIZE)


def q8_quantize(
    x: torch.Tensor, block: int = BLOCK_SIZE
) -> tuple[torch.Tensor, torch.Tensor]:
    """Activation quantization: amax/127 scale, floor(x·127/amax + 0.5),
    clip ±127. Returns (int8 [...], f32 scales [..., n/block])."""
    shape = x.shape
    xb = x.reshape(*shape[:-1], shape[-1] // block, block).to(torch.float32)
    amax = xb.abs().amax(dim=-1)
    pos = amax > 0
    # true divisions by a tensor: PyTorch's CUDA division by a Python scalar
    # multiplies by the reciprocal, which rounds differently from NumPy and XLA
    c127 = torch.full_like(amax, 127.0)
    iscale = torch.where(pos, c127 / amax, torch.zeros_like(amax))
    scale = torch.where(pos, amax / c127, torch.zeros_like(amax))
    q = torch.clamp(torch.floor(xb * iscale[..., None] + 0.5), -127, 127)
    return q.to(torch.int8).reshape(shape), scale


def q8_dequantize(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    shape = q.shape
    qb = q.reshape(*shape[:-1], shape[-1] // BLOCK_SIZE, BLOCK_SIZE).to(torch.float32)
    return (qb * scales[..., None].to(torch.float32)).reshape(shape)
