"""SafeTensors wire format: header parse/serialize, dtype table.

A copy of `jlama_tpu/st/format.py` (header = u64 LE length + JSON; dtype
names incl. the non-standard "Q4" extension with a half-size payload).
Difference: BF16 payloads are read as `uint16`, since the port has no
`ml_dtypes`; `bf16_to_f32` widens them exactly, and torch views them as
`torch.bfloat16`. So `NUMPY_TO_ST` has no BF16 entry: a bf16 tensor is
written through `SafeTensorWriter.add_raw` from its uint16 view.
"""

from __future__ import annotations

import json
import struct
from dataclasses import dataclass

import numpy as np

# safetensors dtype name -> (numpy dtype for raw storage, bytes per element)
# Q4 packs two elements per byte: raw payload is uint8 of size n/2.
# BF16 is stored as its raw 16-bit pattern (uint16).
DTYPES: dict[str, tuple[np.dtype, float]] = {
    "BOOL": (np.dtype(np.bool_), 1),
    "U8": (np.dtype(np.uint8), 1),
    "I8": (np.dtype(np.int8), 1),
    "I16": (np.dtype(np.int16), 2),
    "U16": (np.dtype(np.uint16), 2),
    "F16": (np.dtype(np.float16), 2),
    "BF16": (np.dtype(np.uint16), 2),
    "I32": (np.dtype(np.int32), 4),
    "U32": (np.dtype(np.uint32), 4),
    "F32": (np.dtype(np.float32), 4),
    "F64": (np.dtype(np.float64), 8),
    "I64": (np.dtype(np.int64), 8),
    "U64": (np.dtype(np.uint64), 8),
    # Jlama extension: 4-bit block-quantized, payload uint8 n/2
    "Q4": (np.dtype(np.uint8), 0.5),
}


NUMPY_TO_ST = {
    np.dtype(np.float32): "F32",
    np.dtype(np.float16): "F16",
    np.dtype(np.int8): "I8",
    np.dtype(np.uint8): "U8",
    np.dtype(np.int32): "I32",
    np.dtype(np.int64): "I64",
    np.dtype(np.bool_): "BOOL",
}


def bf16_to_f32(raw: np.ndarray) -> np.ndarray:
    """Exact widening of raw bf16 bit patterns (uint16) to float32."""
    return (raw.astype(np.uint32) << 16).view(np.float32)


@dataclass(frozen=True)
class TensorInfo:
    name: str
    dtype: str  # safetensors dtype string
    shape: tuple[int, ...]
    data_offsets: tuple[int, int]  # [start, end) relative to start of payload

    @property
    def nbytes(self) -> int:
        return self.data_offsets[1] - self.data_offsets[0]


def parse_header(buf: bytes) -> tuple[dict[str, TensorInfo], dict, int]:
    """Parse a safetensors header.

    Returns (tensors, metadata, payload_start) where payload_start is the byte
    offset of the data section within the file.
    """
    if len(buf) < 8:
        raise ValueError("file too small for safetensors header")
    (hlen,) = struct.unpack("<Q", buf[:8])
    header = json.loads(buf[8 : 8 + hlen].decode("utf-8"))
    meta = header.pop("__metadata__", {})
    tensors = {}
    for name, info in header.items():
        tensors[name] = TensorInfo(
            name=name,
            dtype=info["dtype"],
            shape=tuple(info["shape"]),
            data_offsets=tuple(info["data_offsets"]),
        )
    return tensors, meta, 8 + hlen


def serialize_header(
    tensors: dict[str, TensorInfo], metadata: dict | None = None
) -> bytes:
    header: dict = {}
    if metadata:
        header["__metadata__"] = metadata
    for name, ti in tensors.items():
        header[name] = {
            "dtype": ti.dtype,
            "shape": list(ti.shape),
            "data_offsets": list(ti.data_offsets),
        }
    raw = json.dumps(header).encode("utf-8")
    # pad to 8-byte alignment with spaces, like the canonical writers
    pad = (-(len(raw) + 8)) % 8
    raw += b" " * pad
    return struct.pack("<Q", len(raw)) + raw
