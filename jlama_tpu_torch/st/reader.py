"""SafeTensors reading: mmap-backed, multi-file index aware.

A copy of `jlama_tpu/st/reader.py`, numpy only: open `model.safetensors` or
`model.safetensors.index.json`, mmap the payloads, and hand tensors back as
numpy views over the mmap (no copy), plus the JQ4 convention where a
quantized tensor `w` has a companion block-scale tensor `w.qb`. The shard
(row/column range) loads of the original come with the tensor-parallel
slice of the port.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from pathlib import Path

import numpy as np

from .format import DTYPES, TensorInfo, parse_header


class SafeTensorFile:
    """One mmap'd .safetensors file."""

    def __init__(self, path: str | os.PathLike):
        self.path = Path(path)
        self._f = open(self.path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        (hlen,) = struct.unpack("<Q", bytes(self._mm[:8]))
        self.tensors, self.metadata, self.payload_start = parse_header(
            bytes(self._mm[: 8 + hlen])
        )

    def close(self) -> None:
        try:
            self._mm.close()
        except BufferError:
            # numpy views over the mmap are still alive; the mapping is
            # released when they are garbage collected.
            pass
        self._f.close()

    def names(self) -> list[str]:
        return list(self.tensors)

    def load(self, name: str) -> np.ndarray:
        """Zero-copy view of a tensor's raw payload as its storage dtype
        (Q4: packed uint8 [..., n/2]; BF16: uint16 bit patterns)."""
        ti = self.tensors[name]
        start = self.payload_start + ti.data_offsets[0]
        buf = np.frombuffer(self._mm, dtype=np.uint8, count=ti.nbytes, offset=start)
        arr = buf.view(DTYPES[ti.dtype][0])
        if ti.dtype == "Q4":
            return arr.reshape(*ti.shape[:-1], ti.shape[-1] // 2)
        return arr.reshape(ti.shape)

    def info(self, name: str) -> TensorInfo:
        return self.tensors[name]


class SafeTensorIndex:
    """Weight reader over a model directory.

    Resolves `model.safetensors.index.json` (multi-file) or any single
    `*.safetensors` file; exposes the union namespace.
    """

    def __init__(self, model_dir: str | os.PathLike):
        self.dir = Path(model_dir)
        self._files: dict[str, SafeTensorFile] = {}
        self.weight_map: dict[str, str] = {}
        self.metadata: dict = {}

        index = self.dir / "model.safetensors.index.json"
        if index.exists():
            idx = json.loads(index.read_text())
            self.metadata = idx.get("metadata", {})
            self.weight_map = dict(idx["weight_map"])
        else:
            candidates = sorted(self.dir.glob("*.safetensors"))
            if not candidates:
                raise FileNotFoundError(f"no safetensors files in {self.dir}")
            for c in candidates:
                for n in self._file(c.name).names():
                    self.weight_map[n] = c.name

    def _file(self, fname: str) -> SafeTensorFile:
        if fname not in self._files:
            self._files[fname] = SafeTensorFile(self.dir / fname)
        return self._files[fname]

    def names(self) -> list[str]:
        return list(self.weight_map)

    def __contains__(self, name: str) -> bool:
        return name in self.weight_map

    def info(self, name: str) -> TensorInfo:
        return self._file(self.weight_map[name]).info(name)

    def load(self, name: str) -> np.ndarray:
        return self._file(self.weight_map[name]).load(name)

    def load_quantized(self, name: str) -> tuple[np.ndarray, np.ndarray | None, str]:
        """Load a tensor plus its `.qb` block scales if present.

        Returns (data, scales_or_None, st_dtype)."""
        data = self.load(name)
        qb = name + ".qb"
        scales = self.load(qb) if qb in self.weight_map else None
        return data, scales, self.info(name).dtype

    def close(self) -> None:
        for f in self._files.values():
            f.close()
        self._files.clear()
