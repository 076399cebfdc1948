"""The weight bridge: a JAX-package parameter tree → the port's tree.

`from_jax_params(tree)` takes the tree of `jlama_tpu` (from its
`load_params` or `init_params`) with every leaf already turned into numpy
(the port imports nothing of JAX), a QArray leaf given as the tuple
`(data, scales, fmt)`. Layers may be stacked (`{key: [L, ...]}`) or a
per-layer list of dicts. Leaves are q4, q8 or float; numpy arrays of the
`bfloat16` extension dtype are read through their 16-bit patterns.

`from_jax_kv_state(state)` does the same for a paged KV state
(`jlama_tpu.kv.paged.PagedKVState`): pools compare pool for pool with the
JAX package after the same writes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..nn.qarray import QArray


def _is_qleaf(v) -> bool:
    return isinstance(v, tuple) and len(v) == 3 and isinstance(v[2], str)


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes arrays from JAX, 2 bytes each
        t = torch.from_numpy(np.array(a.view(np.uint16))).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device)


def _leaf(v, device):
    if _is_qleaf(v):
        data, scales, fmt = v
        if fmt not in ("q4", "q8"):
            raise ValueError(f"unsupported QArray format {fmt!r}")
        return QArray(_tensor(data, device), _tensor(scales, device).float(), fmt)
    return _tensor(v, device)


def _layer_slice(v, l):
    if _is_qleaf(v):
        return (v[0][l], v[1][l], v[2])
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
