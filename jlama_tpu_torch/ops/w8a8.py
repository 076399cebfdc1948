"""K5: W4A8 matmul over the q4s weight format (counterpart of
`jlama_tpu/ops/pallas_w8a8.py`).

Replaces the TPU kernel `jlama_tpu/ops/pallas_w8a8.py:_w8a8_kernel`
(launched by `q4s_matmul_2d`) with the hand-written CUDA kernels in
`csrc/w8a8_matmul.cu`. y = q8(x) · q4s(W)ᵀ: activations quantized to int8 per
256-group (amax/127), exact int32 dots per group, f32 accumulation of the
group products in group order. Both routes quantize x once per call, mostly
by a pre-pass (`w8a8_quantize_kernel`) into scratch that the wrapper
allocates (xq int8, xs f32 [K/256, Mp], Mp = M rounded up to 4), and both
equal `q4s_matmul_plain` bit for bit. Two routes, by the token count M:

- M ≤ 16 (decode): `w8a8_decode_kernel`, launched as the pre-pass's
  programmatic dependent, streams the weights by TMA and each group's codes
  by bulk copies into per-warp mbarrier rings; its warps split the groups,
  run `mma.sync` s8 with the weights as the A operand from registers and the
  tokens on the n8 side, and sum the group products in group order through
  shared memory. At M ≤ `w8a8_inline_max_m()` (2) it quantizes x itself, in
  one launch and without scratch;
- M > 16 (prefill): `w8a8_wgmma_kernel` runs a TMA + mbarrier ring and
  `wgmma` s8 with the weights as the A operand from registers, and stores y
  by TMA. TMA needs y's row stride a 16-byte multiple: for any other N
  (GPT-2's 50,257-row lm_head) the wrapper pads the stride, the store drops
  the columns past N, and the wrapper returns a contiguous copy of the N
  columns.

One wrapper call counts one launch in `q4s_matmul.launches`, on either route.
The thresholds have one owner, the C source (`w8a8_decode_max_m`, read by
`decode_max_m()`, and `w8a8_inline_max_m`).

The q4s format (the JAX package's numbers, the port's own byte layout). JQ4
weights are re-quantized once, at load, over groups of 256 (8 JQ4 blocks):

    weight[n, c] = value[n, c] * sigma[n, c // 32] * swk[n, c // 256]

- swk   f32 [N, K/256]  = (8/7) · max|block scale| / 16 over the group;
- sigma u8  [N, K/32]   = ceil(16 · |block scale| / max|block scale|) ∈ [1, 16];
- value 4-bit, re-rounded against the block's effective scale sigma · swk;
  the 8/7 padding keeps it in [-7, 7], so the JQ4 scale signs fold into the
  values exactly. Stored as the nibble value + 8 ∈ [1, 15]. 4.375 bits/weight.

Layout: `data` is uint8 [N, K/2], row n's bytes contiguous. Within a row each
group's 128 bytes are the 8 blocks in JQ4's half-block order (byte j of a
block holds element j in the low nibble and j + 16 in the high nibble),
stored as [quad t (4)][block b (8)][byte i (4)]: byte j = 4t + i of block b
sits at 32t + 4b + i, so the thread of an `mma` fragment (the A operand of
both routes' products) that needs bytes 4t..4t+3 of every block of the
group reads 32 contiguous bytes. The TPU's group-major `[ngrp, N, 128]`
layout and its `_group_perm` column order serve only `pltpu.repeat` and the
TPU's sequential group axis, and are not carried over (`models/convert.py`
maps them).

`q4s_matmul_plain` is the same function in plain PyTorch; `q4s_matmul` runs it
for tensors on the CPU only, and a CUDA tensor launches the kernels or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..nn.qarray import QArray
from ..quant import blockq
from . import _build

GROUP = 256  # elements per scale group (8 JQ4 blocks)
BPG = GROUP // blockq.BLOCK_SIZE  # blocks per group (8)
BITS_PER_WEIGHT = 4 + 8 / blockq.BLOCK_SIZE + 32 / GROUP  # 4.375
_QUADS = 4  # 4-byte words per 16-byte block

_C = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "w8a8_matmul": [_C, _I, _C, _C, _C, _C, _I, _I, _I, _I, _I, _C, _C, _C],
    "w8a8_decode_max_m": [],
    "w8a8_inline_max_m": [],
}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2}
# rows of a weight converted at once: bounds to_q4s's f32 temporaries
_CONVERT_ELEMS = 1 << 25


def pack_q4s(nibbles: torch.Tensor) -> torch.Tensor:
    """Nibbles uint8 [..., N, K] (value + 8, element order) -> the port's
    packed q4s payload uint8 [..., N, K/2]."""
    *lead, n, k = nibbles.shape
    nb = nibbles.reshape(*lead, n, k // 32, 32)
    byte = nb[..., :16] | (nb[..., 16:] << 4)  # JQ4 half-block bytes [.., K/32, 16]
    byte = byte.reshape(*lead, n, k // GROUP, BPG, _QUADS, 4).transpose(-3, -2)
    return byte.reshape(*lead, n, k // 2).contiguous()


def q4s_unpack(data: torch.Tensor) -> torch.Tensor:
    """Packed q4s payload uint8 [..., N, K/2] -> int8 values (nibble - 8) in
    element order [..., N, K]."""
    *lead, n, kh = data.shape
    canon = data.reshape(*lead, n, 2 * kh // GROUP, _QUADS, BPG, 4).transpose(-3, -2)
    return blockq.q4_unpack(canon.reshape(*lead, n, kh))


def int8_operands(x: torch.Tensor, w: QArray) -> tuple[torch.Tensor, torch.Tensor]:
    """The int8 operands of K5's group dots: q8_quantize(x, 256)'s codes [M, K]
    and the weights' (nibble - 8) * sigma [N, K]. `torch._int_mm` on them is
    the library's int8 GEMM without the group scales: a yardstick for the
    card benches only, never called by `q4s_matmul`."""
    xq, _ = blockq.q8_quantize(x.float(), block=GROUP)
    sig = w.scales[0].repeat_interleave(blockq.BLOCK_SIZE, dim=1).to(torch.int16)
    return xq, (q4s_unpack(w.data).to(torch.int16) * sig).to(torch.int8)


def _to_q4s_rows(packed: torch.Tensor, scales: torch.Tensor):
    """to_q4s on a slice of rows, in the numpy reference's f32 operation
    order (`jlama_tpu/ops/pallas_w8a8.py:87-128`)."""
    n, k = packed.shape[0], packed.shape[1] * 2
    ngrp = k // GROUP
    vals = blockq.q4_unpack(packed).to(torch.float32)
    sb = scales.to(torch.float32).reshape(n, ngrp, BPG)
    absb = sb.abs()
    gmax = absb.amax(dim=2)
    gmax = torch.where(gmax == 0, torch.ones_like(gmax), gmax)
    swk = (8.0 / 7.0) * gmax / 16.0
    # sigma = ceil(16 r): eff = sigma * swk >= (8/7)|sb|, so |requant| <= 7
    sigma = torch.clamp(torch.ceil(16.0 * absb / gmax[:, :, None]), 1, 16)
    eff = sigma * swk[:, :, None]
    orig = vals.reshape(n, ngrp, BPG, blockq.BLOCK_SIZE) * sb[..., None]
    requant = torch.round(orig / eff[..., None])  # half to even, as np.rint
    if float(requant.abs().amax()) > 7.0:
        raise AssertionError("q4s range overflow")
    nib = (requant + 8.0).to(torch.uint8).reshape(n, k)
    return pack_q4s(nib), sigma.to(torch.uint8).reshape(n, ngrp * BPG), swk


def to_q4s(w: QArray) -> QArray:
    """Re-quantize a JQ4 QArray [N, K] into q4s, on the weight's device.

    Values, sigma and swk equal those of the JAX package's numpy `to_q4s`.
    Returns QArray(data uint8 [N, K/2], (sigma uint8 [N, K/32], swk f32
    [N, K/256]), "q4s")."""
    if w.fmt != "q4":
        raise ValueError(f"expected fmt q4, got {w.fmt}")
    if w.data.dim() != 2:
        raise ValueError(f"to_q4s takes a 2-D weight, got shape {tuple(w.shape)}")
    n, k = w.shape
    if k % GROUP:
        raise ValueError(f"k={k} not divisible by group={GROUP}")
    dev = w.data.device
    data = torch.empty((n, k // 2), dtype=torch.uint8, device=dev)
    sigma = torch.empty((n, k // blockq.BLOCK_SIZE), dtype=torch.uint8, device=dev)
    swk = torch.empty((n, k // GROUP), dtype=torch.float32, device=dev)
    rows = max(1, _CONVERT_ELEMS // k)
    for r0 in range(0, n, rows):
        sl = slice(r0, min(n, r0 + rows))
        data[sl], sigma[sl], swk[sl] = _to_q4s_rows(w.data[sl], w.scales[sl])
    return QArray(data, (sigma, swk), "q4s")


def q4s_dequantize(w: QArray, dtype=torch.float32) -> torch.Tensor:
    """Exact dequant of a q4s QArray -> [..., N, K]: (value · sigma) · swk."""
    sigma, swk = w.scales
    vals = q4s_unpack(w.data).to(torch.float32)
    *lead, n, k = vals.shape
    vb = vals.reshape(*lead, n, k // GROUP, BPG, blockq.BLOCK_SIZE)
    out = vb * sigma.to(torch.float32).reshape(*lead, n, k // GROUP, BPG)[..., None] \
        * swk[..., None, None]
    return out.reshape(*lead, n, k).to(dtype)


def prepare_params_for_w8a8(params: dict) -> dict:
    """The param tree with its 2-D q4 weights re-quantized to q4s (once, at
    load; counterpart of `jlama_tpu/ops/pallas_w8a8.py:prepare_params_for_w8a8`).

    Run it after `fuse_params`: q4s rows are never concatenated. The
    embedding table stays q4 (the row gather reads it); a tied model gets a
    q4s `lm_head` copy; weights whose K is not a multiple of 256 stay q4 and
    keep taking K1. Returns a new tree and leaves the input as it was, so the
    q4 and the q4s weights are both held until the caller drops the q4 tree
    (the scheduler does at once)."""

    def conv(leaf):
        if (isinstance(leaf, QArray) and leaf.fmt == "q4" and leaf.data.dim() == 2
                and leaf.shape[-1] % GROUP == 0):
            return to_q4s(leaf)
        return leaf

    out = dict(params)
    embed = out.get("embed")
    if isinstance(embed, QArray) and embed.fmt == "q4" and "lm_head" not in out \
            and embed.shape[-1] % GROUP == 0:
        out["lm_head"] = to_q4s(embed)
    for key, v in out.items():
        if key == "layers":
            out[key] = [{k: conv(x) for k, x in layer.items()} for layer in v]
        elif key != "embed":
            out[key] = conv(v)
    return out


def q4s_matmul_plain(x: torch.Tensor, w: QArray, out_dtype) -> torch.Tensor:
    """K5's function in plain PyTorch, as the TPU kernel computes it:
    `q8_quantize(x, 256)`, per group g the exact integer dot of the int8
    activations with the weights' (value · sigma), then `acc += (d · xs[m, g])
    · swk[n, g]` in f32 over g in order, and the cast to out_dtype. The
    integer dots run as an f32 matmul of integer-valued tensors: every partial
    sum is an integer below 2^24 (|d| <= 256 · 127 · 112), so it is exact."""
    sigma, swk = w.scales
    n, k = w.shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k)
    m, ngrp = x2.shape[0], k // GROUP
    xq, xs = blockq.q8_quantize(x2, block=GROUP)
    wv = q4s_unpack(w.data).to(torch.float32).reshape(n, ngrp * BPG, blockq.BLOCK_SIZE)
    wv = (wv * sigma.to(torch.float32)[..., None]).reshape(n, ngrp, GROUP)
    d = torch.bmm(xq.to(torch.float32).reshape(m, ngrp, GROUP).transpose(0, 1),
                  wv.permute(1, 2, 0))  # [ngrp, M, N]
    acc = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    for g in range(ngrp):
        acc = acc + d[g] * xs[:, g, None] * swk[None, :, g]
    return acc.to(out_dtype).reshape(*lead, n)


def decode_max_m() -> int:
    """The decode route's largest M, from the built kernel (needs nvcc); the
    prefill route takes every larger M."""
    return _build.load("w8a8_matmul", _SIGNATURES).w8a8_decode_max_m()


def q4s_matmul(x: torch.Tensor, w: QArray, out_dtype=None) -> torch.Tensor:
    """y = q8(x) @ q4s(w).T for arbitrary leading dims of x; w a q4s QArray
    [N, K]."""
    out_dtype = out_dtype or x.dtype
    if w.fmt != "q4s":
        raise ValueError(f"q4s_matmul takes fmt q4s, got {w.fmt!r}")
    if x.device.type == "cpu":
        return q4s_matmul_plain(x, w, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"q4s_matmul: unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"q4s_matmul: x dtype {x.dtype} not supported")
    k = x.shape[-1]
    if k % GROUP:
        raise ValueError(f"q4s_matmul: K {k} is not a multiple of {GROUP}")
    data, (sigma, swk) = w.data, w.scales
    if any(t.device != x.device for t in (data, sigma, swk)):
        raise ValueError("q4s_matmul: x and the weight must be on the same device")
    if data.dtype != torch.uint8 or data.dim() != 2 or not data.is_contiguous() \
            or data.shape[1] * 2 != k:
        raise ValueError(f"q4s_matmul: weight data must be contiguous uint8 [N, {k // 2}]")
    n = data.shape[0]
    if sigma.dtype != torch.uint8 or tuple(sigma.shape) != (n, k // 32) \
            or not sigma.is_contiguous():
        raise ValueError("q4s_matmul: sigma must be contiguous uint8 [N, K/32]")
    if swk.dtype != torch.float32 or tuple(swk.shape) != (n, k // GROUP) \
            or not swk.is_contiguous():
        raise ValueError("q4s_matmul: swk must be contiguous float32 [N, K/256]")
    if data.data_ptr() % 16 or sigma.data_ptr() % 8:
        raise ValueError("q4s_matmul: weight data must be 16-byte and sigma 8-byte aligned")
    if out_dtype not in _DTYPE_CODE:
        raise ValueError(f"q4s_matmul: out dtype {out_dtype} not supported")

    lead = x.shape[:-1]
    x2 = x.reshape(-1, k).contiguous()
    if x2.data_ptr() % 16:  # a view at an odd offset: the kernels load 16 bytes at a time
        x2 = x2.clone()
    m = x2.shape[0]
    if m == 0:
        return torch.empty((*lead, n), dtype=out_dtype, device=x.device)
    lib = _build.load("w8a8_matmul", _SIGNATURES)
    ldy, dmax = n, lib.w8a8_decode_max_m()
    if m > dmax:
        per_16 = 16 // _ELEM_BYTES[out_dtype]  # the TMA store's row stride: 16-byte multiples
        ldy = -(-n // per_16) * per_16
    xq = xs = None
    if m > lib.w8a8_inline_max_m():  # the pre-pass's scratch, in one allocation
        # xq: [M, K] codes, or at M <= dmax fragment tiles of 8 or 16 tokens;
        # then xs f32 [K/256, M rounded up to 4], 256-byte aligned
        xq_bytes = max(m, dmax) * k
        scratch = torch.empty(xq_bytes + k // GROUP * ((m + 3) // 4 * 4) * 4, dtype=torch.uint8,
                              device=x.device)
        xq = scratch.data_ptr()
        xs = xq + xq_bytes
    y = torch.empty((m, ldy), dtype=out_dtype, device=x.device)
    err = lib.w8a8_matmul(
        x2.data_ptr(), _DTYPE_CODE[x2.dtype], data.data_ptr(), sigma.data_ptr(),
        swk.data_ptr(), y.data_ptr(), _DTYPE_CODE[out_dtype], m, n, k, ldy, xq, xs,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "q4s_matmul")
    q4s_matmul.launches += 1
    if ldy != n:
        y = y[:, :n].contiguous()
    return y.reshape(*lead, n)


q4s_matmul.launches = 0
