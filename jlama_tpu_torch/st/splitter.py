"""Split a safetensors checkpoint into N part files plus an index.

A copy of `jlama_tpu/st/splitter.py`: tensors are distributed across parts
by size (a `.qb` scale stays with its tensor), and
`model.safetensors.index.json` is written so that any index-aware reader
(the port's `SafeTensorIndex`, the JAX package's) reads the result.
"""

from __future__ import annotations

import json
from pathlib import Path

from .reader import SafeTensorIndex
from .writer import SafeTensorWriter


def split_safetensors(model_dir: str | Path, out_dir: str | Path, n_parts: int) -> Path:
    model_dir, out = Path(model_dir), Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    idx = SafeTensorIndex(model_dir)

    names = sorted(idx.names())
    sizes = {n: idx.info(n).nbytes for n in names}
    # greedy size-balanced assignment; keep `.qb` scales with their tensor
    groups: dict[str, list[str]] = {}
    for n in names:
        base = n[:-3] if n.endswith(".qb") else n
        groups.setdefault(base, []).append(n)

    parts: list[list[str]] = [[] for _ in range(n_parts)]
    loads = [0] * n_parts
    for base in sorted(groups, key=lambda b: -sum(sizes[x] for x in groups[b])):
        i = loads.index(min(loads))
        parts[i].extend(groups[base])
        loads[i] += sum(sizes[x] for x in groups[base])

    weight_map: dict[str, str] = {}
    total = 0
    for i, part in enumerate(parts):
        fname = f"model-{i + 1:05d}-of-{n_parts:05d}.safetensors"
        w = SafeTensorWriter()
        for n in part:
            info = idx.info(n)
            w.add_raw(n, info.dtype, info.shape, idx.load(n))
            weight_map[n] = fname
            total += sizes[n]
        w.write(out / fname)
    (out / "model.safetensors.index.json").write_text(
        json.dumps(
            {"metadata": {"total_size": total}, "weight_map": weight_map},
            indent=1,
        )
    )
    idx.close()
    return out
