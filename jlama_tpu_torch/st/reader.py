"""SafeTensors reading: mmap-backed, multi-file index aware.

A copy of `jlama_tpu/st/reader.py`, numpy only: open `model.safetensors` or
`model.safetensors.index.json`, mmap the payloads, and hand tensors back as
numpy views over the mmap (no copy), plus the JQ4 convention where a
quantized tensor `w` has a companion block-scale tensor `w.qb`. Loads take
a row and a column range (the second-to-last and last dimensions), so a
tensor-parallel rank touches only its slice of the mmap
(`parallel/distributed.py::load_params_sharded`); `SafeTensorIndex.
bytes_loaded` counts the payload bytes read (`read_bytes`: a column range
reads its rows whole).
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from pathlib import Path

import numpy as np

from .format import DTYPES, TensorInfo, parse_header


def slice_payload(arr: np.ndarray, ti: TensorInfo, row_range=None, col_range=None):
    """The row and column range of a payload view (the JAX reader's
    semantics: ranges over the second-to-last and the last dimension; a Q4
    column range even, since two elements share a byte)."""
    if row_range is not None:
        if len(ti.shape) < 2:
            raise ValueError(f"row slicing needs >= 2 dims, got {ti.shape}")
        arr = arr[..., row_range[0]:row_range[1], :]
    if col_range is not None:
        c0, c1 = col_range
        if ti.dtype == "Q4":
            if c0 % 2 or c1 % 2:
                raise ValueError(f"Q4 column range {col_range} must be even (packed bytes)")
            c0, c1 = c0 // 2, c1 // 2
        arr = arr[..., c0:c1]
    return arr


def read_bytes(arr: np.ndarray, ti: TensorInfo, col_range=None) -> int:
    """The payload bytes a read of the slice `arr` covers: its own, or for a
    column range its rows whole. A row's kept columns are not contiguous
    with the next row's, so the read spans them (the mmap faults in whole
    pages, and a row of a JQ4 checkpoint is a page or less), as the HTTP
    loader fetches whole rows for a column range."""
    if col_range is None:
        return arr.nbytes
    row = ti.shape[-1] // 2 if ti.dtype == "Q4" else ti.shape[-1]
    return arr.size // max(arr.shape[-1], 1) * row * arr.itemsize


def scale_cols(col_range):
    """The block-32 scale columns of a quantized column range (which must
    start and end on a block)."""
    if col_range is None:
        return None
    if col_range[0] % 32 or col_range[1] % 32:
        raise ValueError(f"quantized column range {col_range} must be 32-aligned (whole "
                         "blocks of 32)")
    return col_range[0] // 32, col_range[1] // 32


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

    def load(self, name: str, row_range: tuple[int, int] | None = None,
             col_range: tuple[int, int] | None = None) -> np.ndarray:
        """Zero-copy view of (a slice of) a tensor's raw payload as its
        storage dtype (Q4: packed uint8 [..., n/2]; BF16: uint16 bit
        patterns). `row_range` and `col_range` cut the second-to-last and
        the last dimension, in elements; a Q4 column range must be even
        (two elements a byte)."""
        ti = self.tensors[name]
        start = self.payload_start + ti.data_offsets[0]
        buf = np.frombuffer(self._mm, dtype=np.uint8, count=ti.nbytes, offset=start)
        arr = buf.view(DTYPES[ti.dtype][0])
        if ti.dtype == "Q4":
            arr = arr.reshape(*ti.shape[:-1], ti.shape[-1] // 2)
        else:
            arr = arr.reshape(ti.shape)
        return slice_payload(arr, ti, row_range, col_range)

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
        # payload bytes read by load() (`read_bytes`): a tp rank's
        # shard-local load reads its rows, and whole rows for a column range
        self.bytes_loaded = 0

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

    def load(self, name: str, row_range=None, col_range=None) -> np.ndarray:
        arr = self._file(self.weight_map[name]).load(name, row_range, col_range)
        self.bytes_loaded += read_bytes(arr, self.info(name), col_range)
        return arr

    def load_quantized(self, name: str, row_range=None, col_range=None
                       ) -> tuple[np.ndarray, np.ndarray | None, str]:
        """Load (a slice of) a tensor plus its `.qb` block scales if present,
        the scales cut where the payload is (their columns the data's / 32).

        Returns (data, scales_or_None, st_dtype)."""
        qb = name + ".qb"
        quantized = qb in self.weight_map
        scol = scale_cols(col_range) if quantized else None
        data = self.load(name, row_range, col_range)
        scales = self.load(qb, row_range, scol) if quantized else None
        return data, scales, self.info(name).dtype

    def close(self) -> None:
        for f in self._files.values():
            f.close()
        self._files.clear()
