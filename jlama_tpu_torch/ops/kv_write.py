"""K4: the KV write with RoPE on q and k fused in (counterpart of
`jlama_tpu/ops/pallas_kv.py`, generalised to the paged pool, and of the
`jlama_tpu/nn/rope.py::apply_rope` calls that precede it).

Replaces the TPU kernel `jlama_tpu/ops/pallas_kv.py:_kv_write_kernel`
(launched by `kv_write_dense1`, which writes one token's rows into the dense
cache in place) with the hand-written CUDA kernel in `csrc/kv_write.cu`.
One launch per layer does all the work between the QKV projection and
attention, the JAX chain `apply_rope` on q and k followed by
`jlama_tpu/kv/paged.py::write_kv_layer`:
- with `cos`/`sin` [B, T, hd/2] (f32), it rotates q [B, T, H, hd] and k
  [B, T, n_kv, hd] with the HF rotate-half rule, rounded as
  `nn/rope.py::apply_rope` rounds it, and returns the rotated q as a new
  contiguous tensor;
- it writes the (rotated) k and v rows of both pools: row (b, t, h) goes to
  slot (page_tables[b, pos // ps], pos % ps) of head h, as `write_kv_layer`
  scatters them. A bf16 or f32 pool gets a plain store; a q8 pool (a
  QArray: int8 payload, f32 scales per block of `blk` along hd) is
  quantized per block in the same pass, as `quant/blockq.py::q8_quantize`
  does it, from k as the activation dtype holds it.
Without `cos` nothing is rotated and only K and V are written; `q` comes
back as it was given. q, k and v may be strided views with a unit last
stride, such as the split of a fused QKV output.

The pools take any head/page/slot strides with a unit last stride, so one
layer's slice of the stacked [L, ...] pool needs no copy, and the `Engine`'s
dense cache [B, n_kv, S, hd] is a pool too: `dense_pool_view` gives it as B
pages of S slots, with the page table [[0], [1], ...]. That is
`kv_write_dense1` exactly, for every batch row and token at once.

What bounds it on the H100: the bytes (q, k, v and cos/sin read once, q
and the pool slots written once, with little arithmetic); at decode sizes it
is a launch of a few hundred KB, and its cost is the launch. Fusing the
RoPE saves the 20 ATen launches per layer that the two `apply_rope` calls
made.

`kv_write_plain` is `apply_rope` on q and k followed by the same write with
`index_put_` (and `q8_quantize` for q8 pools), so its result is the unfused
chain's by construction. `kv_write` runs it for tensors on the CPU only; a
CUDA tensor launches the kernel or raises. A row whose position lies past
its page table is not written: in the JAX package the table gather fills
such an index with an out-of-range page id, and the scatter drops it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..nn.qarray import QArray
from ..nn.rope import apply_rope
from ..quant.blockq import q8_quantize
from . import _build

_C = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_SIGNATURES = {
    "kv_write": [_C, _L, _L, _L, _C]
    + [_C, _L, _L, _L, _C, _L, _L, _L, _C, _L, _L, _L] * 2
    + [_C, _L, _L] * 2
    + [_C, _L, _I, _C, _L, _I, _I, _I, _I, _I, _I, _I, _I, _I, _C]
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


def kv_write_plain(k_pool, v_pool, k_new, v_new, page_tables, positions, *, q=None, cos=None,
                   sin=None):
    """In place: pools [n_kv, n_pages, ps, hd] (tensors or q8 QArrays), rows
    [B, T, n_kv, hd], page_tables [B, P], positions [B, T]; with cos/sin
    [B, T, hd/2], q [B, T, H, hd] and k are rotated first (`apply_rope`).
    Returns q, rotated where cos/sin are given."""
    if cos is not None:
        q = None if q is None else apply_rope(q, cos, sin)
        k_new = apply_rope(k_new, cos, sin)
    ps = (k_pool.data if isinstance(k_pool, QArray) else k_pool).shape[2]
    slots = _slots(page_tables, positions, ps)
    _write_one_plain(k_pool, k_new, *slots)
    _write_one_plain(v_pool, v_new, *slots)
    return q


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


def kv_write(k_pool, v_pool, k_new, v_new, page_tables, positions, *, q=None, cos=None,
             sin=None):
    """Write K/V rows into their pools in place, after rotating q and k by
    cos/sin where they are given, in one launch (see the module docstring).
    Returns q: a new rotated tensor where cos/sin are given, else as it came."""
    if any(t is not None and t.device != k_new.device for t in (v_new, q, cos, sin)):
        raise ValueError("kv_write: rows, q and cos/sin on one device")
    if k_new.device.type == "cpu":
        return kv_write_plain(k_pool, v_pool, k_new, v_new, page_tables, positions, q=q,
                              cos=cos, sin=sin)
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
    if hd % 2 or hd > 256:
        raise ValueError(f"kv_write: head size {hd} (the kernel takes even sizes up to 256)")
    B, T = k_new.shape[:2]
    if k_new.dtype not in _IN_CODE or v_new.dtype != k_new.dtype:
        raise ValueError(f"kv_write: row dtypes {k_new.dtype}/{v_new.dtype}")
    if (cos is None) != (sin is None):
        raise ValueError("kv_write: cos and sin go together")
    rotate_q = cos is not None and q is not None
    tensors = [kd, vd, k_new, v_new] + ([ks, vs] if kind == "q8" else []) \
        + ([cos, sin] if cos is not None else []) + ([q] if rotate_q else [])
    for t in tensors:
        if t.device != k_new.device or t.stride(-1) != 1:
            raise ValueError("kv_write: pools, rows, q and cos/sin on one device, with a unit "
                             "last stride")
    if cos is not None:
        for name, t in (("cos", cos), ("sin", sin)):
            if t.dtype != torch.float32 or t.shape != (B, T, hd // 2):
                raise ValueError(f"kv_write: {name} {t.dtype} {tuple(t.shape)}, want f32 "
                                 f"[{B}, {T}, {hd // 2}]")
    if rotate_q and (q.dim() != 4 or q.shape[:2] != (B, T) or q.shape[3] != hd
                     or q.dtype != k_new.dtype):
        raise ValueError(f"kv_write: q {q.dtype} {tuple(q.shape)} for rows "
                         f"{k_new.dtype} {tuple(k_new.shape)}")
    page_tables = page_tables.to(device=k_new.device, dtype=torch.int32)
    positions = positions.to(device=k_new.device, dtype=torch.int64)
    if page_tables.dim() != 2 or page_tables.shape[0] != B or page_tables.stride(1) != 1 \
            or positions.shape != (B, T) or positions.stride(1) != 1:
        raise ValueError(f"kv_write: page_tables {tuple(page_tables.shape)}, positions "
                         f"{tuple(positions.shape)} for rows [{B}, {T}]")
    H = q.shape[2] if rotate_q else 0
    q_out = torch.empty((B, T, H, hd), dtype=q.dtype, device=q.device) if rotate_q else q
    if B * T == 0:
        return q_out

    def side(new, data, scales):
        sc = scales if scales is not None else data  # unused unless q8
        return [new.data_ptr(), *new.stride()[:3], data.data_ptr(), *data.stride()[:3],
                sc.data_ptr() if scales is not None else None, *sc.stride()[:3]]

    def table(t):
        return [t.data_ptr(), *t.stride()[:2]] if t is not None else [None, 0, 0]

    qs = [q.data_ptr(), *q.stride()[:3], q_out.data_ptr()] if rotate_q else [None, 0, 0, 0, None]
    lib = _build.load("kv_write", _SIGNATURES)
    err = lib.kv_write(
        *qs, *side(k_new, kd, ks), *side(v_new, vd, vs), *table(cos), *table(sin),
        page_tables.data_ptr(), page_tables.stride(0), page_tables.shape[1],
        positions.data_ptr(), positions.stride(0),
        B, T, H, n_kv, hd, ps, blk, _IN_CODE[k_new.dtype], POOL_CODE[kind],
        torch.cuda.current_stream(k_new.device).cuda_stream,
    )
    _build.check(err, "kv_write")
    kv_write.launches += 1
    return q_out


kv_write.launches = 0
