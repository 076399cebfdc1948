"""Linear/matmul dispatch over plain and quantized weights (counterpart of
`jlama_tpu/ops/linear.py`).

Weights follow the HF nn.Linear convention `[out, in]`; `y = x @ w.T`. A q4
QArray goes to the K1 wrapper (`ops/q4_matmul.py`): the CUDA kernel for a
CUDA tensor, its plain f32-dequant version for a CPU tensor, which is the
JAX package's reference path (`_quantized_matmul_xla`). q8 weights take the
f32 dequant path on any device, and float weights `torch.matmul` — in the
JAX package too those products lie outside any Pallas kernel.
"""

from __future__ import annotations

import torch

from ..nn.qarray import QArray
from .q4_matmul import q4_matmul


def linear(x: torch.Tensor, w, bias: torch.Tensor | None = None, out_dtype=None):
    """y = x @ w.T (+ bias). w: tensor [out, in] or QArray [out, in]."""
    out_dtype = out_dtype or x.dtype
    if isinstance(w, QArray):
        if w.fmt == "q4":
            y = q4_matmul(x, w, out_dtype=out_dtype)
        else:
            y = torch.matmul(x.to(torch.float32), w.dequantize(torch.float32).t())
            y = y.to(out_dtype)
    else:
        y = torch.matmul(x, w.to(x.dtype).t()).to(out_dtype)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y
