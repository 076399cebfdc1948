"""QArray: a block-quantized weight tensor (counterpart of
`jlama_tpu/nn/qarray.py`).

- fmt "q4": `data` is the JQ4 packed payload, uint8 [..., n/2] in the
  checkpoint's half-block layout (byte j of a 32-block holds element j in the
  low nibble and element j+16 in the high nibble). The CUDA q4 matmul
  (`ops/q4_matmul.py`) reads this layout as it is, so a checkpoint's payload
  is the runtime layout and one 16-byte load is one 32-block.
- fmt "q8": `data` is int8 [..., n].

`scales` is float32 [..., n/32] (block-32 along the reduction axis).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..quant import blockq

BLOCK = blockq.BLOCK_SIZE
HALF = blockq.HALF_BLOCK


@dataclass
class QArray:
    data: torch.Tensor  # q4: uint8 [..., n/2] packed; q8: int8 [..., n]
    scales: torch.Tensor  # float32 [..., n/32]
    fmt: str = "q4"

    @property
    def shape(self) -> tuple[int, ...]:
        """Logical (unpacked) shape."""
        if self.fmt == "q4":
            return (*self.data.shape[:-1], self.data.shape[-1] * 2)
        return tuple(self.data.shape)

    @property
    def ndim(self) -> int:
        return self.data.ndim

    @property
    def device(self) -> torch.device:
        return self.data.device

    def to(self, device) -> "QArray":
        return QArray(self.data.to(device), self.scales.to(device), self.fmt)

    def unpack(self) -> torch.Tensor:
        """Quantized integer values in original element order (int8)."""
        if self.fmt == "q4":
            return blockq.q4_unpack(self.data)
        return self.data

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        vals = self.unpack()
        shape = vals.shape
        v = vals.reshape(*shape[:-1], shape[-1] // BLOCK, BLOCK).to(torch.float32)
        out = v * self.scales[..., None].to(torch.float32)
        return out.reshape(shape).to(dtype)

    def __getitem__(self, idx) -> "QArray":
        return QArray(self.data[idx], self.scales[idx], self.fmt)


def quantize_q4(x: np.ndarray, device="cpu") -> QArray:
    packed, scales = blockq.q4_quantize_np(np.asarray(x, dtype=np.float32))
    return QArray(
        torch.from_numpy(packed).to(device), torch.from_numpy(scales).to(device), "q4"
    )
