"""K6: the grouped expert q4 matmul (the MoE experts' projections).

Replaces two pieces of JAX code, neither a Pallas kernel of its own: the
per-selection `linear(xi, w[e])` calls of `jlama_tpu/nn/layers.py:_moe_gathered`
(taken at B·T·K ≤ 8) and `QArray.dequantize(bf16)` plus `jax.lax.ragged_dot`
in `_moe_ragged` (taken above that), with the hand-written CUDA kernel in
`csrc/moe_q4.cu`.

y[r] = x[row of r] · deq(W[e[r]])ᵀ for R selections r (a selection is one
(token, k) pair of the top-k routing):

- W: one stacked expert projection, a q4 QArray [E, N, K] (uint8 [E, N, K/2],
  f32 scales [E, N, K/32]) in the checkpoint's JQ4 layout, as K1 takes it;
- e: int expert ids on x's device, [T, k] (x [T, K], one row a token: each
  row goes through each of its k experts, y [T, k, N]) or [R] (x [R, K], one
  row a selection, y [R, N]);
- x: bf16 on the card (f32 x there raises: no path runs it), any float dtype
  on the CPU; y in `out_dtype` (x's by default).

On the card a call is one launch of `moe_q4_mma_kernel` with a static grid
(tiles of N) × E × ⌈R / rows-a-tile⌉, after the grouping pre-pass `moe_groups`
(one launch of `moe_group_kernel`, which a MoE layer runs once for its three
projections), so neither reads anything back to the host and a decode step
stays capturable in a CUDA graph. The kernel's numerics are K1's `mma` route:
exact bf16 (n − 8), exact f32 products, f32 sums, each 32-block's partial
times its f32 scale. `moe_q4_matmul_plain` is the same function in plain
PyTorch (f32 dequantization, one f32 matmul per expert group); the wrapper
runs it for tensors on the CPU only, and a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..nn.qarray import QArray
from ..quant import blockq
from . import _build

_C = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "moe_group": [_C, _I, _I, _C, _C, _C],
    "moe_q4_matmul": [_C, _I, _C, _C, _C, _C, _C, _I, _I, _I, _I, _I, _I, _C],
}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


class MoEGroups(NamedTuple):
    """The selections grouped by expert: order [R] (selection indices, a
    stable sort by expert) and offsets [E + 1] (expert x owns order[offsets[x]
    : offsets[x + 1]]), int32 on the ids' device."""

    order: torch.Tensor
    offsets: torch.Tensor


def row_tile(r: int) -> int:
    """Selections a row tile of the kernel (8, 16 or 32): one tile holds every
    row of an expert at decode (R ≤ 32), so each touched expert's weights are
    read once there."""
    return 8 if r <= 8 else 16 if r <= 16 else 32


def moe_groups_plain(e: torch.Tensor, n_experts: int) -> MoEGroups:
    ef = e.reshape(-1).long()
    order = torch.sort(ef, stable=True).indices.to(torch.int32)
    counts = torch.bincount(ef, minlength=n_experts)
    offsets = torch.zeros(n_experts + 1, dtype=torch.int64, device=e.device)
    offsets[1:] = torch.cumsum(counts, 0)
    return MoEGroups(order, offsets.to(torch.int32))


def moe_groups(e: torch.Tensor, n_experts: int) -> MoEGroups:
    """The grouping of the expert ids e (any shape, flattened in selection
    order): on the card one launch of `moe_group_kernel`, with no host sync."""
    if e.device.type == "cpu":
        return moe_groups_plain(e, n_experts)
    if e.device.type != "cuda":
        raise ValueError(f"moe_groups: unsupported device {e.device}")
    ef = e.reshape(-1).to(torch.int32).contiguous()
    r = ef.numel()
    order = torch.empty(r, dtype=torch.int32, device=e.device)
    offsets = torch.empty(n_experts + 1, dtype=torch.int32, device=e.device)
    lib = _build.load("moe_q4", _SIGNATURES)
    err = lib.moe_group(ef.data_ptr(), r, n_experts, order.data_ptr(), offsets.data_ptr(),
                        torch.cuda.current_stream(e.device).cuda_stream)
    _build.check(err, "moe_group")
    moe_groups.launches += 1
    return MoEGroups(order, offsets)


moe_groups.launches = 0


def _shapes(x: torch.Tensor, w: QArray, e: torch.Tensor):
    """(selections a row of x, R, E, N, K, the output shape)."""
    if w.fmt != "q4" or w.data.dim() != 3:
        raise ValueError(f"moe_q4_matmul takes a q4 QArray [E, N, K], got {w.fmt} "
                         f"{tuple(w.shape)}")
    n_exp, n, k = w.shape
    if x.dim() != 2 or x.shape[1] != k:
        raise ValueError(f"moe_q4_matmul: x {tuple(x.shape)} is not [rows, {k}]")
    if e.dim() == 2 and e.shape[0] == x.shape[0]:
        per = e.shape[1]
        out_shape = (x.shape[0], per, n)
    elif e.dim() == 1 and e.shape[0] == x.shape[0]:
        per = 1
        out_shape = (x.shape[0], n)
    else:
        raise ValueError(f"moe_q4_matmul: ids {tuple(e.shape)} do not match x "
                         f"{tuple(x.shape)} ([T, k] or [R])")
    return per, x.shape[0] * per, n_exp, n, k, out_shape


def moe_q4_matmul_plain(x: torch.Tensor, w: QArray, e: torch.Tensor,
                        out_dtype=None) -> torch.Tensor:
    """y[r] = x[row of r] @ deq(w[e[r]]).T in f32, cast to out_dtype: the
    weights of each chosen expert dequantized to f32 once, one f32 matmul per
    expert group (host-side grouping: ids are read back)."""
    out_dtype = out_dtype or x.dtype
    per, r, _, n, k, out_shape = _shapes(x, w, e)
    ef = e.reshape(-1).long()
    xr = x.to(torch.float32).repeat_interleave(per, dim=0) if per > 1 else x.to(torch.float32)
    y = torch.zeros((r, n), dtype=torch.float32, device=x.device)
    for ex in torch.unique(ef).tolist():
        idx = (ef == ex).nonzero()[:, 0]
        wd = blockq.q4_dequantize(w.data[ex], w.scales[ex])
        y[idx] = torch.matmul(xr[idx], wd.t())
    return y.to(out_dtype).reshape(out_shape)


def moe_q4_matmul(x: torch.Tensor, w: QArray, e: torch.Tensor, out_dtype=None,
                  groups: MoEGroups | None = None) -> torch.Tensor:
    """y = x · deq(w[e])ᵀ per selection (see the module docstring). groups:
    `moe_groups(e, E)` when the caller has them already (a MoE layer groups
    once for its three projections); else this call groups first."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return moe_q4_matmul_plain(x, w, e, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"moe_q4_matmul: unsupported device {x.device}")
    per, r, n_exp, n, k, out_shape = _shapes(x, w, e)
    data, scales = w.data, w.scales
    if data.device != x.device or scales.device != x.device or e.device != x.device:
        raise ValueError("moe_q4_matmul: x, the ids and the weight must be on the same device")
    if data.dtype != torch.uint8 or not data.is_contiguous():
        raise ValueError("moe_q4_matmul: weight data must be contiguous uint8 [E, N, K/2]")
    if scales.dtype != torch.float32 or tuple(scales.shape) != (n_exp, n, k // 32) \
            or not scales.is_contiguous():
        raise ValueError("moe_q4_matmul: scales must be contiguous float32 [E, N, K/32]")
    if k % 32:
        raise ValueError(f"moe_q4_matmul: K {k} is not a multiple of 32")
    # an expert's matrix starts every N·K/2 bytes and N·K/32 scales: with K a
    # multiple of 32 both strides keep the bases' alignment
    if data.data_ptr() % 16:
        raise ValueError("moe_q4_matmul: weight data must be 16-byte aligned")
    if scales.data_ptr() % 4:
        raise ValueError("moe_q4_matmul: weight scales must be 4-byte aligned")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"moe_q4_matmul: x must be bf16 on the card, got {x.dtype}")
    if out_dtype not in _DTYPE_CODE:
        raise ValueError(f"moe_q4_matmul: output dtype {out_dtype} not supported")
    y = torch.empty((r, n), dtype=out_dtype, device=x.device)
    if r == 0:
        return y.reshape(out_shape)
    if groups is None:
        groups = moe_groups(e, n_exp)
    if groups.order.numel() != r or groups.offsets.numel() != n_exp + 1:
        raise ValueError("moe_q4_matmul: groups do not match the ids")
    x2 = x.contiguous()
    if x2.data_ptr() % 16:  # a view at an odd offset: the kernel loads 8 bytes at a time
        x2 = x2.clone()
    lib = _build.load("moe_q4", _SIGNATURES)
    err = lib.moe_q4_matmul(
        x2.data_ptr(), per, data.data_ptr(), scales.data_ptr(), groups.order.data_ptr(),
        groups.offsets.data_ptr(), y.data_ptr(), _DTYPE_CODE[out_dtype], r, n_exp, n, k,
        row_tile(r), torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "moe_q4_matmul")
    moe_q4_matmul.launches += 1
    return y.reshape(out_shape)


moe_q4_matmul.launches = 0
