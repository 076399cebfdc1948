"""SafeTensors writing, including the JQ4 quantized-checkpoint convention.

A copy of `jlama_tpu/st/writer.py`, byte for byte the same files for the
same tensors and metadata (header order, padding, offsets): a Q4 tensor is
written with dtype "Q4", its logical (unpacked) shape, a packed-nibble
payload of n/2 bytes, and a companion F32 scale tensor `<name>.qb` of shape
[..., n/32]; I8 tensors likewise carry a `.qb` scale. NumPy only: a bf16
tensor goes in through `add_raw(name, "BF16", shape, uint16_view)`.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from .format import NUMPY_TO_ST, TensorInfo, serialize_header


class SafeTensorWriter:
    """Streaming writer: add tensors, then write(path)."""

    def __init__(self, metadata: dict | None = None):
        self._entries: list[tuple[str, str, tuple[int, ...], np.ndarray]] = []
        self.metadata = metadata or {}

    def add(self, name: str, array: np.ndarray, st_dtype: str | None = None) -> None:
        arr = np.ascontiguousarray(array)
        dtype = st_dtype or NUMPY_TO_ST[arr.dtype]
        self._entries.append((name, dtype, tuple(arr.shape), arr))

    def add_raw(
        self,
        name: str,
        st_dtype: str,
        logical_shape: tuple[int, ...],
        payload: np.ndarray,
    ) -> None:
        """Add with an explicit safetensors dtype + logical shape (Q4 tensors
        whose payload is packed, BF16 from its uint16 bit patterns)."""
        self._entries.append(
            (name, st_dtype, tuple(logical_shape), np.ascontiguousarray(payload))
        )

    def add_q4(self, name: str, packed: np.ndarray, scales: np.ndarray) -> None:
        """Add a JQ4 tensor: packed uint8 [..., n/2] + f32 scales [..., n/32]."""
        logical_shape = (*packed.shape[:-1], packed.shape[-1] * 2)
        arr = np.ascontiguousarray(packed, dtype=np.uint8)
        self._entries.append((name, "Q4", logical_shape, arr))
        self.add(name + ".qb", np.ascontiguousarray(scales, dtype=np.float32))

    def add_i8(self, name: str, values: np.ndarray, scales: np.ndarray) -> None:
        self.add(name, np.ascontiguousarray(values, dtype=np.int8))
        self.add(name + ".qb", np.ascontiguousarray(scales, dtype=np.float32))

    def write(self, path: str | os.PathLike) -> None:
        infos: dict[str, TensorInfo] = {}
        offset = 0
        for name, dtype, shape, arr in self._entries:
            n = arr.nbytes
            infos[name] = TensorInfo(name, dtype, shape, (offset, offset + n))
            offset += n
        header = serialize_header(infos, self.metadata or None)
        tmp = Path(str(path) + ".tmp")
        with open(tmp, "wb") as f:
            f.write(header)
            for _, _, _, arr in self._entries:
                f.write(arr.tobytes())
        os.replace(tmp, path)
