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
  (4-bit payload + f32 scale) against 3.35 TB/s; prefill is tensor-core
  bound. Three routes, each launched by the same `q4_matmul` call:
  - M = 1, and f32 x at M ≤ 16: a weight-streaming GEMV on the CUDA cores.
    Every weight row is read once in 16-byte loads, a warp's next loads in
    flight while it computes; as many blocks as the SMs hold, each walking
    tiles of rows; x's block is read once for a warp's rows; (n − 8) is made
    exactly without a conversion; warps split K into slices that meet in
    shared memory in order, and `gemv_plan` picks the rows a warp and the
    slices a row from N, K and the card's SM count, so that every SM gets a
    tile. x as given, products exact in f32, f32 sums: the plain version's
    numerics;
  - bf16 x at 2 ≤ M ≤ 16: `mma.sync` on the bf16 tensor cores, with the
    nibbles dequantized to exact bf16 (n − 8) in registers and each
    32-block's f32 partial scaled by its f32 scale (the GEMV's numerics);
  - M > 16 (prefill): a warp-specialised Hopper GEMM: TMA loads into a ring
    of shared-memory stages under mbarriers, one warpgroup dequantizing each
    W tile to bf16 in the 128-byte swizzle, `wgmma` bf16 → f32. It takes bf16
    x only, so f32 x (a perplexity window) is cast to bf16 here first, as the
    TPU wrapper casts x before its kernel.

`q4_matmul_plain` is the same function in plain PyTorch (f32 dequant, f32
matmul). `q4_matmul` runs it for tensors on the CPU only; a CUDA tensor
launches the kernel or raises. `q4_matmul_tiled_plain` models the M > 16
route's rounding (x and each weight rounded to bf16, exact products, f32
sums); the tests hold that route to it, and nothing on a serving path calls
it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..nn.qarray import QArray
from ..quant import blockq
from . import _build

_C = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"q4_matmul": [_C, _I, _C, _C, _C, _I, _I, _I, _I, _I, _I, _C]}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

GEMV_WARPS = 8  # warps a GEMV block (`kGemvWarps` in csrc/q4_matmul.cu)
# 32-blocks of each row a lane takes at least, where K has them: with fewer,
# a warp spends more on its reduction than on its loads
GEMV_LANE_BLOCKS = 2


def takes_gemv(m: int, x_dtype) -> bool:
    """Whether `q4_matmul` sends M rows of x to a GEMV route: M = 1, or f32 x
    at M ≤ 16 (bf16 x at M = 2–16 takes the `mma` route, M > 16 the wgmma
    route)."""
    return m == 1 or (x_dtype == torch.float32 and m <= 16)


@functools.lru_cache(maxsize=256)
def gemv_plan(m: int, n: int, k: int, sms: int) -> tuple[int, int, int]:
    """(rows a warp, slices a row, tiles) of the GEMV route
    (`q4_gemv_kernel` in csrc/q4_matmul.cu).

    A tile is rows · GEMV_WARPS / slices weight rows, one block's work: each
    of its `GEMV_WARPS` warps takes `rows` rows and one of `slices` runs of
    their K/32 blocks, whole multiples of 32 blocks (one a lane), none empty.
    Rows a warp are 4, 2 or 1 at M = 1 (x's block is read once for them), 1
    past M = 1. The first choice, most rows a warp first and then fewest
    slices, that gives every SM a tile and each lane at least
    `GEMV_LANE_BLOCKS` blocks a row wins; past all of them the one with the
    most tiles. The kernel runs as many blocks as the SMs hold at once, each
    walking tiles."""
    nb = k // 32
    units = -(-nb // 32)  # runs of 32 blocks: a slice holds whole runs
    best = None
    for rows in ((4, 2, 1) if m == 1 else (1,)):
        for slices in (1, 2, 4, 8):
            per = -(-units // slices)
            if (slices - 1) * per >= units:  # the last slice would be empty
                break
            tiles = -(-n // (rows * GEMV_WARPS // slices))
            if tiles >= sms and per * 32 >= min(nb, GEMV_LANE_BLOCKS * 32):
                return rows, slices, tiles
            if best is None or tiles > best[2]:
                best = (rows, slices, tiles)
    return best


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def q4_matmul_plain(
    x: torch.Tensor, data: torch.Tensor, scales: torch.Tensor, out_dtype
) -> torch.Tensor:
    """y = x @ deq(data, scales).T in f32, cast to out_dtype."""
    w = blockq.q4_dequantize(data, scales)
    return torch.matmul(x.to(torch.float32), w.t()).to(out_dtype)


def q4_matmul_tiled_plain(
    x: torch.Tensor, data: torch.Tensor, scales: torch.Tensor, out_dtype
) -> torch.Tensor:
    """The M > 16 route's numerics in plain PyTorch: x rounded to bf16, each
    weight bf16((n − 8) · s) with the product in f32, f32 products and sums,
    then out_dtype."""
    w = blockq.q4_dequantize(data, scales).to(torch.bfloat16).to(torch.float32)
    xb = x.to(torch.bfloat16).to(torch.float32)
    return torch.matmul(xb, w.t()).to(out_dtype)


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
    if scales.data_ptr() % 4:  # the kernels load them 4 bytes at a time
        raise ValueError("q4_matmul: weight scales must be 4-byte aligned")
    if x.dtype not in _DTYPE_CODE or out_dtype not in _DTYPE_CODE:
        raise ValueError(f"q4_matmul: dtypes {x.dtype} -> {out_dtype} not supported")

    lead = x.shape[:-1]
    x2 = x.reshape(-1, k).contiguous()
    if x2.data_ptr() % 16:  # a view at an odd offset: loads (and TMA) take 16-byte aligned x
        x2 = x2.clone()
    m = x2.shape[0]
    if m > 16 and x2.dtype == torch.float32:  # the M > 16 route takes bf16 x
        x2 = x2.to(torch.bfloat16)
    y = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0:
        return y.reshape(*lead, n)
    lib = _build.load("q4_matmul", _SIGNATURES)
    rows, slices = 0, 0
    if takes_gemv(m, x2.dtype):
        dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
        rows, slices, _ = gemv_plan(m, n, k, sm_count(dev))
    err = lib.q4_matmul(
        x2.data_ptr(), _DTYPE_CODE[x2.dtype], data.data_ptr(), scales.data_ptr(),
        y.data_ptr(), _DTYPE_CODE[out_dtype], m, n, k, rows, slices,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "q4_matmul")
    q4_matmul.launches += 1
    return y.reshape(*lead, n)


q4_matmul.launches = 0
