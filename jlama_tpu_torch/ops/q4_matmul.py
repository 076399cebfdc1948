"""K1: fused JQ4 dequant + matmul (counterpart of `jlama_tpu/ops/pallas_q4.py`).

Replaces the TPU kernel `jlama_tpu/ops/pallas_q4.py:_q4_matmul_kernel`
(launched by `q4k_matmul_2d`) with the hand-written CUDA kernel in
`csrc/q4_matmul.cu`. y = x · deq(W)ᵀ with f32 accumulation.

- Layout: the checkpoint's JQ4 payload as it is (uint8 [N, K/2], half-block
  nibble order, f32 scales [N, K/32]). No one-time weight preparation: the
  q4k column permutation of the TPU kernel serves only Mosaic's 2-D tiling,
  and keeping the checkpoint layout lets a tied lm_head share the embedding
  table (the TPU path makes a second, permuted copy).
- What bounds it on the H100: decode (M ≤ 16) streams 0.625 bytes per weight
  (4-bit payload + f32 scale) against 3.35 TB/s, so the kernel is a
  weight-streaming GEMV with 128-bit loads and dequant in registers; prefill
  is tensor-core bound and dequantizes each W tile to bf16 in shared memory
  for `wmma` bf16 → f32.

`q4_matmul_plain` is the same function in plain PyTorch (f32 dequant, f32
matmul). `q4_matmul` runs it for tensors on the CPU only; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..nn.qarray import QArray
from ..quant import blockq
from . import _build

_C = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"q4_matmul": [_C, _I, _C, _C, _C, _I, _I, _I, _I, _C]}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def q4_matmul_plain(
    x: torch.Tensor, data: torch.Tensor, scales: torch.Tensor, out_dtype
) -> torch.Tensor:
    """y = x @ deq(data, scales).T in f32, cast to out_dtype."""
    w = blockq.q4_dequantize(data, scales)
    return torch.matmul(x.to(torch.float32), w.t()).to(out_dtype)


def q4_matmul(x: torch.Tensor, w: QArray, out_dtype=None) -> torch.Tensor:
    """y = x @ deq(w).T for arbitrary leading dims of x; w a q4 QArray [N, K]."""
    out_dtype = out_dtype or x.dtype
    if w.fmt != "q4":
        raise ValueError(f"q4_matmul takes fmt q4, got {w.fmt!r}")
    if x.device.type == "cpu":
        return q4_matmul_plain(x, w.data, w.scales, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"q4_matmul: unsupported device {x.device}")

    data, scales = w.data, w.scales
    if data.device != x.device or scales.device != x.device:
        raise ValueError("q4_matmul: x and the weight must be on the same device")
    if data.dtype != torch.uint8 or data.dim() != 2 or not data.is_contiguous():
        raise ValueError("q4_matmul: weight data must be contiguous uint8 [N, K/2]")
    n, k = data.shape[0], data.shape[1] * 2
    if scales.dtype != torch.float32 or tuple(scales.shape) != (n, k // 32) \
            or not scales.is_contiguous():
        raise ValueError("q4_matmul: scales must be contiguous float32 [N, K/32]")
    if k % 32 or x.shape[-1] != k:
        raise ValueError(f"q4_matmul: x last dim {x.shape[-1]} != K {k} (K % 32 == 0)")
    if data.data_ptr() % 16:
        raise ValueError("q4_matmul: weight data must be 16-byte aligned")
    if x.dtype not in _DTYPE_CODE or out_dtype not in _DTYPE_CODE:
        raise ValueError(f"q4_matmul: dtypes {x.dtype} -> {out_dtype} not supported")

    lead = x.shape[:-1]
    x2 = x.reshape(-1, k).contiguous()
    if x2.data_ptr() % 16:  # a view at an odd offset: the kernel loads 16 bytes at a time
        x2 = x2.clone()
    m = x2.shape[0]
    y = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0:
        return y.reshape(*lead, n)
    lib = _build.load("q4_matmul", _SIGNATURES)
    err = lib.q4_matmul(
        x2.data_ptr(), _DTYPE_CODE[x2.dtype], data.data_ptr(), scales.data_ptr(),
        y.data_ptr(), _DTYPE_CODE[out_dtype], m, n, k,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "q4_matmul")
    q4_matmul.launches += 1
    return y.reshape(*lead, n)


q4_matmul.launches = 0
