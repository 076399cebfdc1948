"""Linear/matmul dispatch over plain and quantized weights (counterpart of
`jlama_tpu/ops/linear.py`).

Weights follow the HF nn.Linear convention `[out, in]`; `y = x @ w.T`. A q4
QArray goes to the K1 wrapper (`ops/q4_matmul.py`): the CUDA kernel for a
CUDA tensor, its plain f32-dequant version for a CPU tensor, which is the
JAX package's reference path (`_quantized_matmul_xla`). A q4s QArray goes to
the K5 wrapper (`ops/w8a8.py`), which always computes the W4A8 kernel's
function, int8 activations included, on both devices; the JAX package's
`linear` takes an f32 dequant path for q4s unless `JLAMA_Q4S_KERNEL=1`, and
the port is held against its kernel. q8 weights take the f32 dequant path on
any device, and float weights `torch.matmul` (a 16-bit x with an f32 output,
the logits and tp's partial sums, on the card one tensor-core GEMM writing
f32, `_WideMM`) — in the JAX package too those products lie outside any
Pallas kernel.
"""

from __future__ import annotations

import torch

from ..nn.qarray import QArray
from .q4_matmul import q4_matmul
from .w8a8 import q4s_matmul


def linear(x: torch.Tensor, w, bias: torch.Tensor | None = None, out_dtype=None):
    """y = x @ w.T (+ bias). w: tensor [out, in] or QArray [out, in]."""
    out_dtype = out_dtype or x.dtype
    if isinstance(w, QArray):
        if w.fmt == "q4":
            y = q4_matmul(x, w, out_dtype=out_dtype)
        elif w.fmt == "q4s":
            y = q4s_matmul(x, w, out_dtype=out_dtype)
        else:
            y = torch.matmul(x.to(torch.float32), w.dequantize(torch.float32).t())
            y = y.to(out_dtype)
    elif out_dtype.itemsize > x.dtype.itemsize:
        # a wider output (bf16 x, f32 logits): the JAX package's dot with
        # preferred_element_type, products of x's dtype's values exact in
        # the output's dtype and summed there, never rounded to x's dtype
        wx = w.to(x.dtype)
        if x.device.type == "cuda" and out_dtype == torch.float32 \
                and x.dtype in (torch.bfloat16, torch.float16):
            y = _WideMM.apply(x.reshape(-1, x.shape[-1]), wx).reshape(*x.shape[:-1], -1)
        else:
            y = torch.matmul(x.to(out_dtype), wx.to(out_dtype).t())
    else:
        y = torch.matmul(x, w.to(x.dtype).t()).to(out_dtype)
    return y if bias is None else add_bias(y, bias)


class _WideMM(torch.autograd.Function):
    """x [N, K] @ w [M, K].T -> f32 on the card for 16-bit x and w: one
    tensor-core GEMM that accumulates in f32 and writes f32
    (`torch.mm(..., out_dtype=)`), with no f32 copy of w. Its backward is
    what autograd takes of the CPU's widened product: the f32 gradient
    times each operand's values in f32, rounded once to that operand's
    dtype."""

    @staticmethod
    def forward(fctx, x, w):
        fctx.save_for_backward(x, w)
        return torch.mm(x, w.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(fctx, g):
        x, w = fctx.saved_tensors
        gx = torch.mm(g, w.float()).to(x.dtype) if fctx.needs_input_grad[0] else None
        gw = torch.mm(g.t(), x.float()).to(w.dtype) if fctx.needs_input_grad[1] else None
        return gx, gw


class _BiasSteps(torch.autograd.Function):
    """y + b in y's dtype, whose backward sums b's gradient over y's rows
    one row at a time in that dtype, as the JAX package's broadcast
    transposes into a reduce in the activation dtype (XLA adds the rows in
    order, rounding each sum)."""

    @staticmethod
    def forward(fctx, y, b):
        return y + b

    @staticmethod
    def backward(fctx, g):
        rows = g.reshape(-1, g.shape[-1])
        acc = rows[0]
        for r in rows[1:]:
            acc = acc + r
        return g, acc


def add_bias(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """y + bias in y's dtype. Under autograd on the CPU, where that dtype is
    narrower than f32 (bf16 activations of the train step), the bias's
    gradient is summed over the rows as the JAX package sums it
    (`_BiasSteps`); on the card it is one reduction (f32 accumulation, one
    rounding)."""
    b = bias.to(y.dtype)
    if torch.is_grad_enabled() and b.requires_grad and y.dtype.itemsize < 4 \
            and y.device.type == "cpu":
        return _BiasSteps.apply(y, b)
    return y + b
