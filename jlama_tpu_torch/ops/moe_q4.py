"""K6: the grouped expert q4 matmul (the MoE experts' projections).

Replaces two pieces of JAX code, neither a Pallas kernel of its own: the
per-selection `linear(xi, w[e])` calls of `jlama_tpu/nn/layers.py:_moe_gathered`
(taken at B·T·K ≤ 8) and `QArray.dequantize(bf16)` plus `jax.lax.ragged_dot`
in `_moe_ragged` (taken above that), with the hand-written CUDA kernels in
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

`moe_groups` groups the ids once a MoE layer (one launch of
`moe_group_kernel`): the order by expert, the offsets, and the two routes'
work lists (row tiles of at most 128 rows for the prefill route, of at most
16 for the decode route: there, the touched experts), each with its count on
the device, in buffers whose sizes depend on R only. `moe_q4_matmul` (one projection) and `moe_q4_gate_up` (gate and
up, two weight stacks over the same x rows, in one launch) then take one
route by R, with the threshold `decode_max_r()` owned by the C source:

- decode (R ≤ the threshold): `moe_q4_decode_kernel`, persistent blocks
  walking (decode tile, projection, 16 weight rows) items, 16-byte weight
  loads kept in flight across items, `mma.sync` with the selections on n8. Numerics of
  `moe_q4_matmul_plain`: exact bf16 (n − 8), exact f32 products, f32 sums,
  each 32-block's partial times its f32 scale;
- prefill (above): `moe_gather` (one launch of `moe_gather_kernel`) writes
  x's rows in the grouping's order into a scratch copy, then
  `moe_q4_wgmma_kernel`, K1's TMA + mbarrier ring + dequantizing warpgroup +
  `wgmma` design over the row tiles. Numerics of
  `moe_q4_matmul_tiled_plain`, which is `_moe_ragged`'s function: x and each
  weight bf16((n − 8)·s) rounded to bf16, f32 products and sums.

Neither reads anything back to the host, so a decode step stays capturable
in a CUDA graph and a replay reads the new routing. Each counter counts the
launches of one kernel where it is launched: `moe_groups.launches` the
grouping, `moe_gather.launches` the gather, `moe_q4_matmul.launches` the
matmul launches of `moe_q4_matmul` and `moe_q4_gate_up` (one a call, on
either route); a CUDA tensor launches a kernel or raises. On the CPU
`moe_q4_matmul` runs `moe_q4_matmul_plain` at every R (and `moe_q4_gate_up`
two such calls). `moe_q4_compare` reaches the other kernels of the source
(the grid kernel `moe_q4_mma_kernel`, either route at any R) for timing
beside the main path; no model path calls it.
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
    "moe_group": [_C, _I, _I, _C, _C, _C, _C, _C, _C],
    "moe_gather": [_C, _I, _C, _C, _I, _I, _I, _C, _C],
    "moe_q4_matmul": [_C, _I, _C, _C, _C, _C, _C, _C, _C, _C, _C, _C, _I, _I, _I, _I, _I, _I,
                      _C, _C],
    "moe_q4_mma_matmul": [_C, _I, _C, _C, _C, _C, _C, _I, _I, _I, _I, _I, _I, _C],
    "moe_q4_decode_max_r": [],
    "moe_q4_tile_rows": [],
    "moe_q4_decode_tile_rows": [],
}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the C entry's routes (the prefill route reads x from moe_gather's copy)
_ROUTES = {"decode": 1, "prefill": 2}

TILE_ROWS = 128  # rows of a prefill row tile (`kBM` in csrc/moe_q4.cu)
DECODE_TILE_ROWS = 16  # rows of a decode tile (`kDecTileRows`)


class MoEGroups(NamedTuple):
    """The selections grouped by expert, int32 on the ids' device:

    - order [R]: selection indices, a stable sort by expert;
    - offsets [E + 1]: expert x owns order[offsets[x] : offsets[x + 1]];
    - tiles [⌈R / TILE_ROWS⌉ + E, 3]: the prefill route's row tiles (expert,
      first row in the order, rows), at most TILE_ROWS rows of one expert
      each, experts ascending;
    - dtiles [⌈R / DECODE_TILE_ROWS⌉ + E, 3]: the decode route's, the same
      with at most DECODE_TILE_ROWS rows: the touched experts, one tile each
      while an expert has at most 16 rows;
    - counts [2]: the number of tiles and of decode tiles.

    List entries past their count hold -1."""

    order: torch.Tensor
    offsets: torch.Tensor
    tiles: torch.Tensor
    dtiles: torch.Tensor
    counts: torch.Tensor


def max_tiles(r: int, n_experts: int, rows: int = TILE_ROWS) -> int:
    """Rows of `MoEGroups.tiles` (of `.dtiles` with rows=DECODE_TILE_ROWS):
    every expert's last tile may be short."""
    return -(-r // rows) + n_experts


def row_tile(r: int) -> int:
    """Selections a row tile of the grid kernel (8, 16 or 32), which
    `moe_q4_compare(variant="grid")` launches: one tile holds every row of
    an expert at decode (R ≤ 32)."""
    return 8 if r <= 8 else 16 if r <= 16 else 32


def moe_groups_plain(e: torch.Tensor, n_experts: int) -> MoEGroups:
    ef = e.reshape(-1).long()
    order = torch.sort(ef, stable=True).indices.to(torch.int32)
    counts = torch.bincount(ef, minlength=n_experts)
    offsets = torch.zeros(n_experts + 1, dtype=torch.int64, device=e.device)
    offsets[1:] = torch.cumsum(counts, 0)
    lists, n = [], []
    for rows in (TILE_ROWS, DECODE_TILE_ROWS):
        t = [(x, o + f, min(rows, c - f)) for x, (c, o) in
             enumerate(zip(counts.tolist(), offsets.tolist())) for f in range(0, c, rows)]
        full = torch.full((max_tiles(ef.numel(), n_experts, rows), 3), -1, dtype=torch.int32)
        if t:
            full[:len(t)] = torch.tensor(t, dtype=torch.int32)
        lists.append(full.to(e.device))
        n.append(len(t))
    return MoEGroups(order, offsets.to(torch.int32), *lists,
                     torch.tensor(n, dtype=torch.int32, device=e.device))


def moe_groups(e: torch.Tensor, n_experts: int) -> MoEGroups:
    """The grouping of the expert ids e (any shape, flattened in selection
    order): on the card one launch of `moe_group_kernel`, with no host sync."""
    if e.device.type == "cpu":
        return moe_groups_plain(e, n_experts)
    if e.device.type != "cuda":
        raise ValueError(f"moe_groups: unsupported device {e.device}")
    ef = e.reshape(-1).to(torch.int32).contiguous()
    r = ef.numel()
    mt, md = max_tiles(r, n_experts), max_tiles(r, n_experts, DECODE_TILE_ROWS)
    # one allocation: order, offsets, tiles, dtiles, counts
    buf = torch.empty(r + n_experts + 1 + 3 * mt + 3 * md + 2, dtype=torch.int32,
                      device=e.device)
    order, offsets, tiles, dtiles, counts = torch.split(
        buf, [r, n_experts + 1, 3 * mt, 3 * md, 2])
    lib = _build.load("moe_q4", _SIGNATURES)
    err = lib.moe_group(ef.data_ptr(), r, n_experts, order.data_ptr(), offsets.data_ptr(),
                        tiles.data_ptr(), dtiles.data_ptr(), counts.data_ptr(),
                        torch.cuda.current_stream(e.device).cuda_stream)
    _build.check(err, "moe_group")
    moe_groups.launches += 1
    return MoEGroups(order, offsets, tiles.view(mt, 3), dtiles.view(md, 3), counts)


moe_groups.launches = 0


def decode_max_r() -> int:
    """Selections up to which a call takes the decode route (card only: the
    C source owns the number)."""
    if decode_max_r.value is None:
        decode_max_r.value = _build.load("moe_q4", _SIGNATURES).moe_q4_decode_max_r()
    return decode_max_r.value


decode_max_r.value = None


def takes_decode(r: int) -> bool:
    """Whether `moe_q4_matmul` and `moe_q4_gate_up` send R selections to the
    decode route on the card."""
    return r <= decode_max_r()


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


def _grouped_plain(x, w, e, out_dtype, dequant):
    """One f32 matmul per expert group of `dequant(w[ex])` (host-side
    grouping: ids are read back)."""
    per, r, _, n, k, out_shape = _shapes(x, w, e)
    ef = e.reshape(-1).long()
    xr = x.to(torch.float32).repeat_interleave(per, dim=0) if per > 1 else x.to(torch.float32)
    y = torch.zeros((r, n), dtype=torch.float32, device=x.device)
    for ex in torch.unique(ef).tolist():
        idx = (ef == ex).nonzero()[:, 0]
        y[idx] = torch.matmul(xr[idx], dequant(w.data[ex], w.scales[ex]).t())
    return y.to(out_dtype).reshape(out_shape)


def moe_q4_matmul_plain(x: torch.Tensor, w: QArray, e: torch.Tensor,
                        out_dtype=None) -> torch.Tensor:
    """y[r] = x[row of r] @ deq(w[e[r]]).T in f32, cast to out_dtype: the
    weights of each chosen expert dequantized to f32 once, one f32 matmul per
    expert group (host-side grouping: ids are read back). The decode route's
    function, and the CPU path at every R."""
    return _grouped_plain(x, w, e, out_dtype or x.dtype, blockq.q4_dequantize)


def moe_q4_matmul_tiled_plain(x: torch.Tensor, w: QArray, e: torch.Tensor,
                              out_dtype=None) -> torch.Tensor:
    """The prefill route's numerics in plain PyTorch, `_moe_ragged`'s
    function: x rounded to bf16, each weight bf16((n − 8) · s) with the
    product in f32, f32 products and sums (one f32 matmul per expert group),
    then out_dtype. Nothing on a serving path calls it."""
    out_dtype = out_dtype or x.dtype
    xb = x.to(torch.bfloat16)

    def deq(data, scales):
        return blockq.q4_dequantize(data, scales).to(torch.bfloat16).to(torch.float32)

    return _grouped_plain(xb, w, e, out_dtype, deq)


def _check_card(x: torch.Tensor, w: QArray, e: torch.Tensor, out_dtype):
    """The card's argument checks for one weight stack; returns _shapes."""
    shapes = _shapes(x, w, e)
    n_exp, n, k = shapes[2:5]
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
    # multiple of 32 both strides keep the bases' alignment (TMA and 16-byte
    # loads take the packed bytes)
    if data.data_ptr() % 16:
        raise ValueError("moe_q4_matmul: weight data must be 16-byte aligned")
    if scales.data_ptr() % 4:
        raise ValueError("moe_q4_matmul: weight scales must be 4-byte aligned")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"moe_q4_matmul: x must be bf16 on the card, got {x.dtype}")
    if out_dtype not in _DTYPE_CODE:
        raise ValueError(f"moe_q4_matmul: output dtype {out_dtype} not supported")
    return shapes


def moe_gather(x: torch.Tensor, groups: MoEGroups, per: int) -> torch.Tensor:
    """The prefill route's copy of x [rows, K] in the grouping's order:
    row i is x[order[i] // per] (the JAX package's `jnp.repeat(xf, k)[order]`),
    for the rows i < offsets[E] that hold a selection (a selection with an id
    outside [0, E) has none: on the card the rows past offsets[E] are left
    unwritten). On the card one launch of `moe_gather_kernel` (bf16 x), with
    offsets[E] read on the device; on the CPU plain indexing of every row."""
    r = groups.order.numel()
    if x.device.type == "cpu":
        return x[groups.order.long() // per]
    if x.device.type != "cuda":
        raise ValueError(f"moe_gather: unsupported device {x.device}")
    if x.dtype != torch.bfloat16 or x.dim() != 2 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("moe_gather: x must be contiguous, 16-byte aligned bf16 [rows, K]")
    k = x.shape[1]
    xg = torch.empty((r, k), dtype=torch.bfloat16, device=x.device)
    if r == 0:
        return xg
    lib = _build.load("moe_q4", _SIGNATURES)
    err = lib.moe_gather(x.data_ptr(), per, groups.order.data_ptr(), groups.offsets.data_ptr(),
                         r, groups.offsets.numel() - 1, k, xg.data_ptr(),
                         torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "moe_gather")
    moe_gather.launches += 1
    return xg


moe_gather.launches = 0


def _launch(x, w, e, out_dtype, groups, w_up=None, route=None):
    """One call of the C entry `moe_q4_matmul` (uncounted: its caller counts
    it), after the prefill route's `moe_gather`: y for w, and for w_up when
    given. route None: by R."""
    per, r, n_exp, n, k, out_shape = _check_card(x, w, e, out_dtype)
    if w_up is not None:
        if tuple(w_up.shape) != tuple(w.shape):
            raise ValueError(f"moe_q4_gate_up: the stacks' shapes differ: {tuple(w.shape)} "
                             f"and {tuple(w_up.shape)}")
        _check_card(x, w_up, e, out_dtype)
    ys = [torch.empty((r, n), dtype=out_dtype, device=x.device)
          for _ in range(1 if w_up is None else 2)]
    if r == 0:
        return [y.reshape(out_shape) for y in ys]
    if groups is None:
        groups = moe_groups(e, n_exp)
    if groups.order.numel() != r or groups.offsets.numel() != n_exp + 1 \
            or groups.tiles.shape[0] != max_tiles(r, n_exp) \
            or groups.dtiles.shape[0] != max_tiles(r, n_exp, DECODE_TILE_ROWS):
        raise ValueError("moe_q4_matmul: groups do not match the ids")
    x2 = x.contiguous()
    if x2.data_ptr() % 16:  # a view at an odd offset: the kernels load 16 bytes at a time
        x2 = x2.clone()
    if route is None:
        route = "decode" if takes_decode(r) else "prefill"
    xg = moe_gather(x2, groups, per) if route == "prefill" else None
    up = w_up is not None
    lib = _build.load("moe_q4", _SIGNATURES)
    err = lib.moe_q4_matmul(
        x2.data_ptr(), per, w.data.data_ptr(), w.scales.data_ptr(),
        w_up.data.data_ptr() if up else None, w_up.scales.data_ptr() if up else None,
        groups.order.data_ptr(), groups.tiles.data_ptr(), groups.dtiles.data_ptr(),
        groups.counts.data_ptr(), ys[0].data_ptr(),
        ys[1].data_ptr() if up else None, _DTYPE_CODE[out_dtype], r, n_exp, n, k,
        _ROUTES[route], xg.data_ptr() if xg is not None else None,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "moe_q4_matmul")
    return [y.reshape(out_shape) for y in ys]


def moe_q4_matmul(x: torch.Tensor, w: QArray, e: torch.Tensor, out_dtype=None,
                  groups: MoEGroups | None = None) -> torch.Tensor:
    """y = x · deq(w[e])ᵀ per selection (see the module docstring). groups:
    `moe_groups(e, E)` when the caller has them already (a MoE layer groups
    once for its projections); else this call groups first."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return moe_q4_matmul_plain(x, w, e, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"moe_q4_matmul: unsupported device {x.device}")
    (y,) = _launch(x, w, e, out_dtype, groups)
    moe_q4_matmul.launches += 1
    return y


moe_q4_matmul.launches = 0


def moe_q4_gate_up(x: torch.Tensor, w_gate: QArray, w_up: QArray, e: torch.Tensor,
                   out_dtype=None, groups: MoEGroups | None = None):
    """(x · deq(w_gate[e])ᵀ, x · deq(w_up[e])ᵀ) per selection: the gate and
    up projections of a MoE layer (stacks of one shape) over the same x rows
    and grouping, in one K6 launch on the card (counted on
    `moe_q4_matmul.launches`); two `moe_q4_matmul_plain` calls on the CPU."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return moe_q4_matmul_plain(x, w_gate, e, out_dtype), \
            moe_q4_matmul_plain(x, w_up, e, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"moe_q4_gate_up: unsupported device {x.device}")
    gate, up = _launch(x, w_gate, e, out_dtype, groups, w_up=w_up)
    moe_q4_matmul.launches += 1
    return gate, up


def moe_q4_compare(x: torch.Tensor, w: QArray, e: torch.Tensor, out_dtype=None,
                   groups: MoEGroups | None = None, variant: str = "grid",
                   w_up: QArray | None = None):
    """The source's other kernels, for timing beside the main path (card
    only; no model path calls this): "grid" the grid kernel
    `moe_q4_mma_kernel` (one launch a weight stack); "decode" or "prefill"
    that route at any R (the prefill route's gather counted on
    `moe_gather.launches`). Returns y, or (gate, up) with w_up. Counts on
    `moe_q4_compare.launches`, one a matmul launch."""
    out_dtype = out_dtype or x.dtype
    if x.device.type != "cuda":
        raise ValueError(f"moe_q4_compare: unsupported device {x.device}")
    if variant in _ROUTES:
        ys = _launch(x, w, e, out_dtype, groups, w_up=w_up, route=variant)
        moe_q4_compare.launches += 1
        return ys[0] if w_up is None else tuple(ys)
    if variant != "grid":
        raise ValueError(f"moe_q4_compare: unknown variant {variant!r}")
    per, r, n_exp, n, k, out_shape = _check_card(x, w, e, out_dtype)
    if groups is None:
        groups = moe_groups(e, n_exp)
    x2 = x.contiguous()
    if x2.data_ptr() % 16:
        x2 = x2.clone()
    lib = _build.load("moe_q4", _SIGNATURES)
    ys = []
    for wt in (w,) if w_up is None else (w, w_up):
        y = torch.empty((r, n), dtype=out_dtype, device=x.device)
        err = lib.moe_q4_mma_matmul(
            x2.data_ptr(), per, wt.data.data_ptr(), wt.scales.data_ptr(),
            groups.order.data_ptr(), groups.offsets.data_ptr(), y.data_ptr(),
            _DTYPE_CODE[out_dtype], r, n_exp, n, k, row_tile(r),
            torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(err, "moe_q4_mma_matmul")
        moe_q4_compare.launches += 1
        ys.append(y.reshape(out_shape))
    return ys[0] if w_up is None else tuple(ys)


moe_q4_compare.launches = 0
