"""Float (bf16) MoE experts on the card: grouped products over K6's grouping.

The JAX package runs float experts through `jax.lax.ragged_dot`
(`jlama_tpu/nn/layers.py:_moe_ragged`), an XLA op and no Pallas body. The
port takes the card's own grouped product for it, `torch._grouped_mm` (bf16
x [R, K] against a bf16 stack [E, K, N], group ends read on the device), and
K6's grouping and gather around it (`ops/moe_q4.py`: `moe_groups` and
`moe_gather`, no host sync), so a decode step stays capturable in a CUDA
graph. `scripts/probe_grouped_mm.py` is the check that chose it on the card
(PERF.md §6, K6's row).

`moe_float_experts` computes `_moe_ragged`'s function for R = T·k selections:

- x rounded to bf16 (f32 x is cast first, as K6's wrapper does), the rows
  gathered in the grouping's order (`jnp.repeat(xf, k)[order]`);
- gate and up: bf16 products, f32 sums, rounded to bf16 (x's dtype in the
  JAX package); SiLU·up in bf16;
- down: bf16 products, f32 sums, rounded to bf16, then widened to f32: the
  card's `torch._grouped_mm` returns its inputs' dtype only, where the JAX
  package keeps this product in f32 (a deliberate difference, ROADMAP §3);
- scattered back to selection order ([R, D] f32; the caller weights and sums
  the k).

Under expert parallelism (`lo`) the stacks hold E_local of the model's
experts from `lo` on and the ids are the model's: the grouping puts the
foreign selections in no group (`moe_groups(e, E_local, lo)`), so the grouped
products read no weight for them, and their rows are set to exactly 0 by a
mask on the device (no host sync).

`grouped_mm` is the one library call; on a CPU tensor it runs
`grouped_mm_plain` (per-group f32 products of the bf16 values, rounded to
bf16), so on the CPU `moe_float_experts` is the plain model of
the card's route; the CPU's own MoE path stays `nn.layers._moe_float_plain`.
`grouped_mm.launches` counts its card calls.
"""

from __future__ import annotations

import torch

from .moe_q4 import moe_gather, moe_groups


def grouped_mm_plain(x: torch.Tensor, w: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """y[r] = x[r] @ w[g] for the rows r of group g (rows ends[g-1] to
    ends[g]), f32 products of x's and w's values, f32 sums, then bf16; rows
    past ends[-1] are zero."""
    y = torch.zeros((x.shape[0], w.shape[-1]), dtype=torch.float32, device=x.device)
    lo = 0
    for g, hi in enumerate(ends.tolist()):
        if hi > lo:
            y[lo:hi] = torch.matmul(x[lo:hi].to(torch.float32), w[g].to(torch.float32))
        lo = hi
    return y.to(torch.bfloat16)


def grouped_mm(x: torch.Tensor, w: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """Grouped product of bf16 x [R, K] (rows sorted by group) with a bf16
    stack w [E, K, N] over the int32 group ends [E], in bf16: on the card one
    `torch._grouped_mm` call, on the CPU `grouped_mm_plain`."""
    if x.device.type == "cpu":
        return grouped_mm_plain(x, w, ends)
    if x.device.type != "cuda":
        raise ValueError(f"grouped_mm: unsupported device {x.device}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"grouped_mm: x and w must be bf16 on the card, got {x.dtype}, "
                         f"{w.dtype}")
    y = torch._grouped_mm(x, w, offs=ends)
    grouped_mm.launches += 1
    return y


grouped_mm.launches = 0


def stack_in_out(w: torch.Tensor, transposed: bool) -> torch.Tensor:
    """An expert stack as [E, in, out]: `experts.w*_t` are that already; the
    loader's `experts.w*` [E, out, in] are viewed transposed (no copy)."""
    return w if transposed else w.transpose(-1, -2)


def moe_float_experts(xf: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor, w2: torch.Tensor,
                      e: torch.Tensor, n_experts: int, act, lo: int | None = None) -> torch.Tensor:
    """The experts' outputs of R = T·k selections, [R, D] f32 in selection
    order (see the module docstring). xf [T, D]; w1, w3 [E, D, H] and w2
    [E, H, D] as [E, in, out] (`stack_in_out`); e int [T, k]; act the gate's
    activation; lo the model's id of the stacks' first expert under expert
    parallelism (None: whole stacks), foreign rows then 0."""
    per = e.shape[-1]
    groups = moe_groups(e, n_experts, lo or 0)
    ends = groups.offsets[1:]
    xs = moe_gather(xf.to(torch.bfloat16).contiguous(), groups, per)
    bf = torch.bfloat16
    gate = grouped_mm(xs, w1.to(bf), ends)
    up = grouped_mm(xs, w3.to(bf), ends)
    ys = grouped_mm(act(gate) * up, w2.to(bf), ends)
    y = torch.empty((ys.shape[0], ys.shape[1]), dtype=torch.float32, device=ys.device)
    y.index_copy_(0, groups.order.long(), ys.to(torch.float32))
    if lo is None:
        return y
    el = e.reshape(-1, 1) - lo
    return torch.where((el >= 0) & (el < n_experts), y, torch.zeros((), dtype=y.dtype,
                                                                   device=y.device))
