"""The weight bridge: a JAX-package parameter tree → the port's tree.

`from_jax_params(tree)` takes the tree of `jlama_tpu` (from its
`load_params` or `init_params`) with every leaf already turned into numpy
(the port imports nothing of JAX), a QArray leaf given as the tuple
`(data, scales, fmt)`. Every top-level leaf comes across as it is (GPT-2's
`wpe` and final-norm bias, BERT's token types, embedding norm, pooler and
classifier too). Layers may be stacked (`{key: [L, ...]}`) or a
per-layer list of dicts; a MoE layer's stacked expert QArrays [L, E, N, K/2]
and its router [L, E, D] become per-layer [E, ...] leaves like any other. Leaves are q4, q8, q4s or float; numpy arrays of the
`bfloat16` extension dtype are read through their 16-bit patterns. A q4s leaf
`(data, (sigma, swk), "q4s")` in the JAX layout (data [ngrp, N, 128] in the
`_group_perm` column order, sigma [ngrp, N, 8], swk [ngrp, 1, N]) is mapped
into the port's q4s layout (`ops/w8a8.py`): the same numbers.

`from_jax_kv_state(state)` does the same for a paged KV state
(`jlama_tpu.kv.paged.PagedKVState`): pools compare pool for pool with the
JAX package after the same writes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..nn.qarray import QArray
from ..ops.w8a8 import BPG, GROUP, pack_q4s


def _is_qleaf(v) -> bool:
    return isinstance(v, tuple) and len(v) == 3 and isinstance(v[2], str)


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes arrays from JAX, 2 bytes each
        t = torch.from_numpy(np.array(a.view(np.uint16))).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device)


def _jax_group_perm() -> np.ndarray:
    """The JAX q4s column order inside one nibble plane of a group: packed
    column c holds the element of block (c mod 4) at within-block index
    (c // 4) (a copy of `jlama_tpu/ops/pallas_w8a8.py:_group_perm`)."""
    c = np.arange(GROUP // 2)
    bpp = BPG // 2
    return (c % bpp) * 32 + c // bpp


def _q4s_leaf(data, sigma, swk, device) -> QArray:
    d = _tensor(data, device)  # [ngrp, N, 128]
    ngrp, n, _ = d.shape
    inv = torch.from_numpy(np.argsort(_jax_group_perm())).to(device)
    lo, hi = (d & 0x0F)[:, :, inv], (d >> 4)[:, :, inv]  # element order per half
    nib = torch.cat([lo, hi], dim=2).transpose(0, 1).reshape(n, ngrp * GROUP)
    sig = _tensor(sigma, device).transpose(0, 1).reshape(n, ngrp * BPG).contiguous()
    sw = _tensor(swk, device)[:, 0, :].t().contiguous().float()
    return QArray(pack_q4s(nib), (sig, sw), "q4s")


def _leaf(v, device):
    if _is_qleaf(v):
        data, scales, fmt = v
        if fmt == "q4s":
            return _q4s_leaf(data, *scales, device)
        if fmt not in ("q4", "q8"):
            raise ValueError(f"unsupported QArray format {fmt!r}")
        return QArray(_tensor(data, device), _tensor(scales, device).float(), fmt)
    return _tensor(v, device)


def _layer_slice(v, l):
    if _is_qleaf(v):
        scales = tuple(s[l] for s in v[1]) if isinstance(v[1], tuple) else v[1][l]
        return (v[0][l], scales, v[2])
    return v[l]


def from_jax_params(tree: dict, device=None) -> dict:
    """The port's param tree (per-layer list) from a numpy'd JAX tree, on
    `device` (CUDA unless the caller names one; raises without CUDA and
    without a device)."""
    device = resolve_device(device)
    out = {k: _leaf(v, device) for k, v in tree.items() if k != "layers"}
    layers = tree["layers"]
    if isinstance(layers, dict):  # stacked [L, ...]
        first = next(iter(layers.values()))
        n = len(first[0]) if _is_qleaf(first) else len(first)
        layers = [{k: _layer_slice(v, l) for k, v in layers.items()} for l in range(n)]
    out["layers"] = [{k: _leaf(v, device) for k, v in d.items()} for d in layers]
    return out


def from_jax_kv_state(state, device=None):
    """The port's `PagedKVState` from a numpy'd JAX `PagedKVState`: a pair
    (k_pool, v_pool), each an array [.., n_kv, n_pages, ps, hd] or a q8 pool
    as the tuple (int8 data, f32 scales, "q8"); on `device` (CUDA unless the
    caller names one)."""
    from ..kv.paged import PagedKVState

    device = resolve_device(device)
    k, v = state
    for pool in (k, v):
        if _is_qleaf(pool) and pool[2] != "q8":
            raise ValueError(f"KV pools are float or q8, got {pool[2]!r}")
    return PagedKVState(_leaf(k, device), _leaf(v, device))
