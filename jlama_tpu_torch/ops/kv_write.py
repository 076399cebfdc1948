"""K4: the KV write (counterpart of `jlama_tpu/ops/pallas_kv.py`, generalised
to the paged pool).

Replaces the TPU kernel `jlama_tpu/ops/pallas_kv.py:_kv_write_kernel`
(launched by `kv_write_dense1`, which writes one token's rows into the dense
cache in place) with the hand-written CUDA kernel in `csrc/kv_write.cu`. One
launch writes the rows [B, T, n_kv, hd] of both K and V: row (b, t, h) goes
to slot (page_tables[b, pos // ps], pos % ps) of head h of its pool, as
`jlama_tpu/kv/paged.py::write_kv_layer` scatters them. A bf16 or f32 pool
gets a plain store; a q8 pool (a QArray: int8 payload, f32 scales per block
of `blk` along hd) is quantized per block in the same pass, as
`quant/blockq.py::q8_quantize` does it.

The pools take any head/page/slot strides with a unit last stride, so one
layer's slice of the stacked [L, ...] pool needs no copy, and the `Engine`'s
dense cache [B, n_kv, S, hd] is a pool too: `dense_pool_view` gives it as B
pages of S slots, with the page table [[0], [1], ...]. That is
`kv_write_dense1` exactly, for every batch row and token at once.

What bounds it on the H100: the bytes (it reads the new rows once and
writes them once, with no arithmetic to speak of); at decode sizes it is a
launch of a few KB, and its cost is the launch.

`kv_write_plain` is the same write with `index_put_` (and `q8_quantize`
for q8 pools). `kv_write` runs it for tensors on the CPU only; a CUDA tensor
launches the kernel or raises. A row whose position lies past its page
table is not written: in the JAX package the table gather fills such an
index with an out-of-range page id, and the scatter drops it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..nn.qarray import QArray
from ..quant.blockq import q8_quantize
from . import _build

_C = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_SIGNATURES = {
    "kv_write": [_C, _L, _L, _L, _C, _L, _L, _L, _C, _L, _L, _L] * 2
    + [_C, _L, _I, _C, _L, _I, _I, _I, _I, _I, _I, _I, _I, _C]
}
_IN_CODE = {torch.float32: 0, torch.bfloat16: 1}
POOL_CODE = {torch.float32: 0, torch.bfloat16: 1, "q8": 2}  # as the kernels take it


def _slots(page_tables: torch.Tensor, positions: torch.Tensor, ps: int):
    """(pages, offsets, in_table) of the B*T rows, flattened."""
    P = page_tables.shape[1]
    pos = positions.long()
    col = pos // ps
    pages = torch.gather(page_tables.long(), 1, torch.clamp(col, max=P - 1))
    return pages.reshape(-1), (pos % ps).reshape(-1), (col < P).reshape(-1)


def _write_one_plain(pool, new: torch.Tensor, pages, offs, keep) -> None:
    B, T, n_kv, hd = new.shape
    rows = new.reshape(B * T, n_kv, hd).transpose(0, 1)[:, keep]  # [n_kv, rows, hd]
    pages, offs = pages[keep], offs[keep]
    if isinstance(pool, QArray):
        blk = hd // pool.scales.shape[-1]
        q, s = q8_quantize(rows, block=blk)
        pool.data[:, pages, offs] = q
        pool.scales[:, pages, offs] = s
    else:
        pool[:, pages, offs] = rows.to(pool.dtype)


def kv_write_plain(k_pool, v_pool, k_new, v_new, page_tables, positions) -> None:
    """In place: pools [n_kv, n_pages, ps, hd] (tensors or q8 QArrays), rows
    [B, T, n_kv, hd], page_tables [B, P], positions [B, T]."""
    ps = (k_pool.data if isinstance(k_pool, QArray) else k_pool).shape[2]
    slots = _slots(page_tables, positions, ps)
    _write_one_plain(k_pool, k_new, *slots)
    _write_one_plain(v_pool, v_new, *slots)


def dense_pool_view(cache: torch.Tensor) -> torch.Tensor:
    """The dense cache [B, n_kv, S, hd] seen as a pool [n_kv, B, S, hd]: B
    pages of S slots (a view)."""
    return cache.permute(1, 0, 2, 3)


@functools.lru_cache(maxsize=16)
def dense_page_table(batch: int, device: torch.device) -> torch.Tensor:
    """[[0], [1], ..., [batch-1]] int32 on `device`, made once per shape (a
    decode step then launches nothing to build it; callers only read it)."""
    return torch.arange(batch, dtype=torch.int32, device=device)[:, None]


def pool_parts(pool, what: str):
    """(data, scales or None, kind, blk) of a pool [n_kv, n_pages, ps, hd]:
    kind is its dtype, or "q8" with f32 scales [n_kv, n_pages, ps, hd/blk];
    blk is hd for a float pool."""
    if not isinstance(pool, QArray):
        return pool, None, pool.dtype, pool.shape[-1]
    d, s = pool.data, pool.scales
    if pool.fmt != "q8" or s.dtype != torch.float32 or s.dim() != 4 \
            or s.shape[:-1] != d.shape[:-1] or d.shape[-1] % s.shape[-1]:
        raise ValueError(f"{what}: a q8 pool needs f32 scales [n_kv, n_pages, ps, hd/blk], "
                         f"got {pool.fmt!r} {tuple(d.shape)} / {tuple(s.shape)} {s.dtype}")
    return d, s, "q8", d.shape[-1] // s.shape[-1]


def kv_write(k_pool, v_pool, k_new, v_new, page_tables, positions) -> None:
    """Write K/V rows into their pools in place (see the module docstring)."""
    if k_new.device.type == "cpu":
        return kv_write_plain(k_pool, v_pool, k_new, v_new, page_tables, positions)
    if k_new.device.type != "cuda":
        raise ValueError(f"kv_write: unsupported device {k_new.device}")
    kd, ks, kind, blk = pool_parts(k_pool, "kv_write")
    vd, vs, vkind, vblk = pool_parts(v_pool, "kv_write")
    if kind != vkind or kind not in POOL_CODE or vd.shape != kd.shape or vblk != blk:
        raise ValueError(f"kv_write: pools {kind} {tuple(kd.shape)} / {vkind} "
                         f"{tuple(vd.shape)}")
    n_kv, n_pages, ps, hd = kd.shape
    if k_new.dim() != 4 or k_new.shape[2:] != (n_kv, hd) or v_new.shape != k_new.shape:
        raise ValueError(f"kv_write: rows {tuple(k_new.shape)} / {tuple(v_new.shape)} for "
                         f"pools {tuple(kd.shape)}")
    B, T = k_new.shape[:2]
    if k_new.dtype not in _IN_CODE or v_new.dtype != k_new.dtype:
        raise ValueError(f"kv_write: row dtypes {k_new.dtype}/{v_new.dtype}")
    tensors = [kd, vd, k_new, v_new] + ([ks, vs] if kind == "q8" else [])
    for t in tensors:
        if t.device != k_new.device or t.stride(-1) != 1:
            raise ValueError("kv_write: pools and rows on one device, with a unit last stride")
    page_tables = page_tables.to(device=k_new.device, dtype=torch.int32)
    positions = positions.to(device=k_new.device, dtype=torch.int64)
    if page_tables.dim() != 2 or page_tables.shape[0] != B or page_tables.stride(1) != 1 \
            or positions.shape != (B, T) or positions.stride(1) != 1:
        raise ValueError(f"kv_write: page_tables {tuple(page_tables.shape)}, positions "
                         f"{tuple(positions.shape)} for rows [{B}, {T}]")
    if B * T == 0:
        return

    def side(new, data, scales):
        sc = scales if scales is not None else data  # unused unless q8
        return [new.data_ptr(), *new.stride()[:3], data.data_ptr(), *data.stride()[:3],
                sc.data_ptr() if scales is not None else None, *sc.stride()[:3]]

    lib = _build.load("kv_write", _SIGNATURES)
    err = lib.kv_write(
        *side(k_new, kd, ks), *side(v_new, vd, vs),
        page_tables.data_ptr(), page_tables.stride(0), page_tables.shape[1],
        positions.data_ptr(), positions.stride(0),
        B, T, n_kv, hd, ps, blk, _IN_CODE[k_new.dtype], POOL_CODE[kind],
        torch.cuda.current_stream(k_new.device).cuda_stream,
    )
    _build.check(err, "kv_write")
    kv_write.launches += 1


kv_write.launches = 0
