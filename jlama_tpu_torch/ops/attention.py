"""K3: flash prefill attention and K2: paged decode attention (counterparts
of `jlama_tpu/ops/pallas_attention.py::flash_prefill` and `::paged_decode`).

Replaces the TPU kernel `jlama_tpu/ops/pallas_attention.py:_flash_kernel`
(launched by `_flash_prefill_jit`) with the hand-written CUDA kernels in
`csrc/flash_prefill.cu`: T > 1 offset-causal GQA attention (query i of a
chunk starting at pos0[b] sees keys ≤ pos0[b] + i), optional softcap and
sliding window, online softmax in f32, no [B, H, T, S] score tensor.

What bounds it on the H100: the operations (4·T·S·hd per head, about half of
them skipped by causality). Two routes, by the inputs' type:

- bf16: the tensor cores. TMA loads K/V tiles of `KEY_TILE[hd]` keys into a
  ring of shared-memory stages under mbarriers; `wgmma` computes S = Q·Kᵀ
  and O += P·V with P from registers; the online softmax runs on the
  accumulator registers. P is rounded to bf16 against its tile's running
  max before P·V, as the TPU kernel rounds it (`p.astype(v.dtype)`);
  `flash_prefill_tiled_plain` is that rounding in plain PyTorch, the model
  the tests hold the route to (nothing on a serving path calls it). TMA needs
  16-byte aligned bases and batch/head/row strides: a view without them
  raises.
- f32 (a perplexity window, held to 2e-5): the CUDA cores (warp per 8 query
  rows, lane per key, shared-memory K/V tiles, causal tile skipping), P
  kept in f32.

`flash_prefill_plain` is the same function as dense masked attention in
PyTorch. `flash_prefill` runs it for tensors on the CPU only; a CUDA tensor
launches a kernel or raises.

K2 replaces the TPU kernel `jlama_tpu/ops/pallas_attention.py:
_paged_decode_kernel` (launched by `_paged_decode_jit`), and the library
`paged_attention` branch of the JAX package's layers, with the hand-written
CUDA kernel in `csrc/paged_decode.cu`: T = 1 GQA attention that reads K/V
through the page tables, q8 pools dequantized in the kernel, online softmax
in f32. Any head count takes it, at head size 64, 128 or 256 (the JAX gate
on head and head-count multiples is a Mosaic limit). The `Engine`'s dense cache is a
pool to it too (`ops/kv_write.py::dense_pool_view`): B pages of S slots.

What bounds K2 on the H100: the live KV bytes. The kernel splits each row's
keys over blocks (flash-decoding); a block holds all query rows of its KV
head, streams 64-key tiles through a ring of `cp.async` stages, each warp
taking 16 keys of a tile, and writes an f32 partial, which the last block of
the row to arrive merges in split order (so a repeat is bit-equal). Two
routes, by the inputs' type: bf16 q on a bf16 or q8 pool takes the tensor
cores (`mma.sync` for Q·Kᵀ and for P·V, P as two bf16 halves, so it keeps 16
bits more than bf16); f32 q or an f32 pool the CUDA cores (f32 FMAs, held to
2e-5). The split comes from static shapes (`page_tables.shape[1] × ps`, the
route, the card's SM count; `_plan`), the partials' scratch is a
`torch.empty` of that size, and the merge's tickets a zeroed buffer kept per
device that the kernel leaves zeroed: the wrapper never reads `lengths` on
the host, so a CUDA graph can capture the launch as it is.

`paged_decode_plain` gathers the row's pages and runs the same masked f32
softmax. Both follow the TPU kernel's q8 rounding (int8 times the f32 block
scale, rounded to bf16, before the dots) and keep the probabilities in f32
(the TPU kernel rounds them to the pool's value type). `paged_decode` runs
the plain version for tensors on the CPU only.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..kv.paged import gather_pool
from ..nn.qarray import QArray
from . import _build
from .kv_write import POOL_CODE, pool_parts

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
_PD_SIGNATURES = {
    "paged_decode": [_C, _L, _L, _C, _L, _L] + [_C, _L, _L, _L] * 4
    + [_C, _L, _I, _C, _I, _I, _I, _I, _I, _I, _F, _F, _I, _I, _I, _C, _C, _I, _I, _C],
    "paged_decode_plan": [_I] * 9 + [ctypes.POINTER(ctypes.c_int64)],
}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_SIZES = (64, 128, 256)
# keys per tile of the bf16 route (csrc/flash_prefill.cu: 8192 / hd, one 16
# KB K or V tile): the tile against whose running max P is rounded
KEY_TILE = {64: 128, 128: 64, 256: 32}


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


def flash_prefill_tiled_plain(q, k, v, pos0, scale, softcap=None, causal=True, window=None,
                              block_s=None):
    """The bf16 route's rounding in plain PyTorch: the online softmax over key
    tiles of `block_s` (default: the route's `KEY_TILE[hd]`) at multiples of
    it from key 0, f32 scores, max and sum, P cast to v's dtype before P·V
    (f32 products and sums). Masked keys get P = 0. Same shapes as
    `flash_prefill_plain`."""
    B, H, T, hd = q.shape
    block_s = block_s or KEY_TILE[hd]
    n_kv, S = k.shape[1], k.shape[2]
    g = H // n_kv
    qg = q.reshape(B, n_kv, g, T, hd).to(torch.float32)
    q_pos = pos0.to(device=q.device, dtype=torch.int64)[:, None] \
        + torch.arange(T, device=q.device)[None, :]
    m = torch.full((B, n_kv, g, T, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, n_kv, g, T, hd), dtype=torch.float32, device=q.device)
    for s0 in range(0, S, block_s):
        kt = k[:, :, s0:s0 + block_s].to(torch.float32)
        vt = v[:, :, s0:s0 + block_s]
        s = torch.einsum("bkgth,bksh->bkgts", qg, kt) * scale
        if softcap is not None:
            s = torch.tanh(s / softcap) * softcap
        k_pos = s0 + torch.arange(kt.shape[2], device=q.device)[None, None, :]
        mask = torch.ones((B, T, kt.shape[2]), dtype=torch.bool, device=q.device)
        if causal:
            mask &= k_pos <= q_pos[:, :, None]
        if window is not None:
            mask &= k_pos > q_pos[:, :, None] - window
        mask = mask[:, None, None]
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(mask, torch.exp(s - m_new), torch.zeros_like(s))
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bkgts,bksh->bkgth", p.to(v.dtype).to(torch.float32),
                                         vt.to(torch.float32))
        m = m_new
    out = acc / torch.where(l == 0, torch.ones_like(l), l)
    return out.reshape(B, H, T, hd).to(q.dtype)


def flash_prefill(q, k, v, pos0, scale, softcap=None, causal=True, window=None):
    """q [B,H,T,hd], k/v [B,n_kv,S,hd] (any batch/head/row strides, unit last
    stride; bf16: 16-byte aligned bases and strides), pos0 [B] int ->
    [B,H,T,hd] in q's dtype."""
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
    strides = []
    for t in (q, k, v):
        st = t.stride()
        if t.device != q.device or st[3] != 1:
            raise ValueError("flash_prefill: q/k/v on one device with a unit last stride")
        # the bf16 route loads by TMA: a 16-byte aligned base and batch/head/row
        # strides (those of a dimension of size 1 are never used)
        if q.dtype == torch.bfloat16 and (t.data_ptr() % 16 or any(
                x % 8 for x, n in zip(st[:3], t.shape[:3]) if n > 1)):
            raise ValueError("flash_prefill: the bf16 route loads q/k/v by TMA: 16-byte aligned "
                             f"base and batch/head/row strides (got offset {t.data_ptr() % 16}, "
                             f"strides {tuple(st)})")
        strides += st[:3]
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
        *strides, *out.stride()[:3],
        float(scale), float(softcap or 0.0), int(window or 0), int(bool(causal)),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "flash_prefill")
    flash_prefill.launches += 1
    return out


flash_prefill.launches = 0


# ---------------------------------------------------------------------------
# K2: paged decode
# ---------------------------------------------------------------------------


def _gather_pages(pool, page_tables) -> torch.Tensor:
    """Each row's pages [B, n_kv, P*ps, hd] in f32; q8 values rounded to bf16
    as the kernels round them."""
    dtype = torch.bfloat16 if isinstance(pool, QArray) else torch.float32
    return gather_pool(pool, page_tables, dtype).to(torch.float32).transpose(1, 2)


def paged_decode_plain(q, k_pool, v_pool, page_tables, lengths, scale, softcap=None,
                       window=None):
    """q [B, H, hd]; pools [n_kv, n_pages, ps, hd] (tensors or q8 QArrays);
    page_tables [B, P]; lengths [B] -> [B, H, hd] in q's dtype."""
    B, H, hd = q.shape
    k = _gather_pages(k_pool, page_tables)
    v = _gather_pages(v_pool, page_tables)
    n_kv, S = k.shape[1], k.shape[2]
    s = torch.einsum("bkgd,bksd->bkgs", q.reshape(B, n_kv, H // n_kv, hd).to(torch.float32),
                     k) * scale
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    kpos = torch.arange(S, device=q.device)[None, :]
    ln = lengths.to(device=q.device, dtype=torch.int64)[:, None]
    mask = kpos < ln
    if window is not None:
        mask &= kpos >= ln - window
    mask = mask[:, None, None, :]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.where(mask, torch.exp(s - s.amax(dim=-1, keepdim=True)), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgs,bksd->bkgd", p, v) / torch.where(l == 0, torch.ones_like(l), l)
    return out.reshape(B, H, hd).to(q.dtype)


def paged_decode(q, k_pool, v_pool, page_tables, lengths, scale, softcap=None, window=None):
    """q [B, H, hd] (any b/h strides, unit last stride); pools [n_kv,
    n_pages, ps, hd] (tensors or q8 QArrays; any head/page/slot strides);
    page_tables [B, P] int; lengths [B] int (live keys per row) -> [B, H, hd]
    in q's dtype."""
    if q.device.type == "cpu":
        return paged_decode_plain(q, k_pool, v_pool, page_tables, lengths, scale, softcap,
                                  window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode: unsupported device {q.device}")
    kd, ks, kind, blk = pool_parts(k_pool, "paged_decode")
    vd, vs, vkind, vblk = pool_parts(v_pool, "paged_decode")
    B, H, hd = q.shape
    n_kv, _, ps, _ = kd.shape
    if kind != vkind or kind not in POOL_CODE or vd.shape != kd.shape or kd.shape[-1] != hd \
            or vblk != blk:
        raise ValueError(f"paged_decode: pools {kind} {tuple(kd.shape)} / {vkind} "
                         f"{tuple(vd.shape)} for q {tuple(q.shape)}")
    if H % n_kv:
        raise ValueError(f"paged_decode: {H} heads over {n_kv} KV heads")
    if hd not in HEAD_SIZES:
        raise ValueError(f"paged_decode: head size {hd} not in {HEAD_SIZES}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"paged_decode: q dtype {q.dtype}")
    for t in [q, kd, vd] + ([ks, vs] if kind == "q8" else []):
        if t.device != q.device or t.stride(-1) != 1:
            raise ValueError("paged_decode: q and pools on one device, with a unit last stride")
    for t in (kd, vd):  # the kernel copies 16-byte units (a stride of a size-1 dim is unused)
        if t.data_ptr() % 16 or any(x * t.element_size() % 16
                                    for x, n in zip(t.stride()[:3], t.shape[:3]) if n > 1):
            raise ValueError("paged_decode: pool bases and head/page/slot strides must be "
                             f"16-byte multiples (got offset {t.data_ptr() % 16}, strides "
                             f"{tuple(t.stride())} of {t.element_size()}-byte elements)")
    if kind == "q8" and blk % 16:
        raise ValueError(f"paged_decode: q8 blocks of {blk}: the kernel takes multiples of 16")
    page_tables = page_tables.to(device=q.device, dtype=torch.int32)
    lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    if page_tables.dim() != 2 or page_tables.shape[0] != B or page_tables.stride(1) != 1 \
            or page_tables.shape[1] == 0 or lengths.shape != (B,):
        raise ValueError(f"paged_decode: page_tables {tuple(page_tables.shape)}, lengths "
                         f"{tuple(lengths.shape)} for B={B}")
    out = torch.empty((B, H, hd), dtype=q.dtype, device=q.device)
    if B == 0:
        return out

    def pool_args(data, scales):
        sc = scales if scales is not None else data
        return [data.data_ptr(), *data.stride()[:3]], \
            [sc.data_ptr() if scales is not None else None, *sc.stride()[:3]]

    (k_a, ks_a), (v_a, vs_a) = pool_args(kd, ks), pool_args(vd, vs)
    lib = _build.load("paged_decode", _PD_SIGNATURES)
    P = page_tables.shape[1]
    n_splits, split_keys, part_floats, n_tickets = _plan(
        B, H, n_kv, hd, P, ps, _DTYPE_CODE[q.dtype], POOL_CODE[kind], q.device.index)
    part = torch.empty(part_floats, dtype=torch.float32, device=q.device)
    err = lib.paged_decode(
        q.data_ptr(), q.stride(0), q.stride(1), out.data_ptr(), out.stride(0), out.stride(1),
        *k_a, *v_a, *ks_a, *vs_a,
        page_tables.data_ptr(), page_tables.stride(0), P,
        lengths.data_ptr(), B, H, n_kv, hd, ps, blk, float(scale), float(softcap or 0.0),
        int(window or 0), _DTYPE_CODE[q.dtype], POOL_CODE[kind],
        part.data_ptr(), _tickets(q.device, n_tickets).data_ptr(), n_splits, split_keys,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "paged_decode")
    paged_decode.launches += 1
    return out


paged_decode.launches = 0


@functools.lru_cache(maxsize=64)
def _plan(B, H, n_kv, hd, P, ps, q_code, pool_code, device_index) -> tuple[int, int, int, int]:
    """(n_splits, split_keys, floats of the partials, tickets) of a call, from
    `csrc/paged_decode.cu`'s own rule (static shapes, route and SM count)."""
    lib = _build.load("paged_decode", _PD_SIGNATURES)
    out = (ctypes.c_int64 * 4)()
    _build.check(lib.paged_decode_plan(B, H, n_kv, hd, P, ps, q_code, pool_code, device_index,
                                       out), "paged_decode_plan")
    return tuple(out)


# per device: the merge's tickets, zero between calls (each kernel resets the
# ones it took); grown, never shrunk. Calls on one stream at a time. A grown
# buffer's predecessor stays alive in _RETIRED: a captured decode graph
# still launches on it.
_TICKETS: dict[torch.device, torch.Tensor] = {}
_RETIRED: list[torch.Tensor] = []


def _tickets(device: torch.device, n: int) -> torch.Tensor:
    t = _TICKETS.get(device)
    if t is None or t.numel() < n:
        if t is not None:
            _RETIRED.append(t)
        t = torch.zeros(max(n, 2 * (0 if t is None else t.numel())), dtype=torch.int32,
                        device=device)
        _TICKETS[device] = t
    return t
