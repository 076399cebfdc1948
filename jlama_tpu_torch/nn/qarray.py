"""QArray: a block-quantized weight tensor (counterpart of
`jlama_tpu/nn/qarray.py`).

- fmt "q4": `data` is the JQ4 packed payload, uint8 [..., n/2] in the
  checkpoint's half-block layout (byte j of a 32-block holds element j in the
  low nibble and element j+16 in the high nibble). The CUDA q4 matmul
  (`ops/q4_matmul.py`) reads this layout as it is, so a checkpoint's payload
  is the runtime layout and one 16-byte load is one 32-block.
- fmt "q8": `data` is int8 [..., n].
- fmt "q4s": the W4A8 kernel's format (`ops/w8a8.py`): `data` is uint8
  [..., n/2] in the port's q4s byte layout, and `scales` is the pair
  (sigma uint8 [..., n/32], swk float32 [..., n/256]), as in the JAX package.

`scales` is float32 [..., n/32] (block-32 along the reduction axis) for q4
and q8. Leading axes ride along: a MoE projection is one q4 QArray over its
experts, data [E, N, K/2] and scales [E, N, K/32], which `dequantize`,
`unpack` and indexing (`w[e]`, one expert's [N, K]) take as they are.
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
    data: torch.Tensor  # q4, q4s: uint8 [..., n/2] packed; q8: int8 [..., n]
    scales: torch.Tensor | tuple  # float32 [..., n/32]; q4s: (sigma, swk)
    fmt: str = "q4"

    @property
    def shape(self) -> tuple[int, ...]:
        """Logical (unpacked) shape."""
        if self.fmt in ("q4", "q4s"):
            return (*self.data.shape[:-1], self.data.shape[-1] * 2)
        return tuple(self.data.shape)

    @property
    def ndim(self) -> int:
        return self.data.ndim

    @property
    def device(self) -> torch.device:
        return self.data.device

    def _map_scales(self, fn):
        if isinstance(self.scales, tuple):
            return tuple(fn(s) for s in self.scales)
        return fn(self.scales)

    def to(self, device) -> "QArray":
        """On `device`; itself where it is there already (as Tensor.to), so
        that trees moved there share their leaves."""
        data, scales = self.data.to(device), self._map_scales(lambda s: s.to(device))
        same = scales is self.scales or (isinstance(scales, tuple) and all(
            a is b for a, b in zip(scales, self.scales)))
        if data is self.data and same:
            return self
        return QArray(data, scales, self.fmt)

    def unpack(self) -> torch.Tensor:
        """Quantized integer values in original element order (int8); for
        q4s the 4-bit values, without sigma."""
        if self.fmt == "q4":
            return blockq.q4_unpack(self.data)
        if self.fmt == "q4s":
            from ..ops.w8a8 import q4s_unpack

            return q4s_unpack(self.data)
        return self.data

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        if self.fmt == "q4s":
            from ..ops.w8a8 import q4s_dequantize

            return q4s_dequantize(self, dtype)
        vals = self.unpack()
        shape = vals.shape
        v = vals.reshape(*shape[:-1], shape[-1] // BLOCK, BLOCK).to(torch.float32)
        out = v * self.scales[..., None].to(torch.float32)
        return out.reshape(shape).to(dtype)

    def __getitem__(self, idx) -> "QArray":
        return QArray(self.data[idx], self._map_scales(lambda s: s[idx]), self.fmt)


def quantize_q4(x: np.ndarray, device="cpu") -> QArray:
    packed, scales = blockq.q4_quantize_np(np.asarray(x, dtype=np.float32))
    return QArray(
        torch.from_numpy(packed).to(device), torch.from_numpy(scales).to(device), "q4"
    )
