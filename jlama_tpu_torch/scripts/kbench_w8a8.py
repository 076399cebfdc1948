"""P2: the int8 block-dot GEMV variants on the card (counterpart of
`scripts/kbench_w8a8.py`).

    python -m jlama_tpu_torch.scripts.kbench_w8a8 [VARIANT ...] [--m 1|16] [--device cpu]

The JAX bench asked how to keep JQ4's per-32-block scales while feeding an
int8 dot. Its Pallas kernels become `csrc/kbench_w8a8.cu` (the header says
what each computes): pb8 and pgb8 (one kernel: exact per-block int32 dots,
then (d − 8 asum) · xs · s in f32), pgbf (the same with bf16 x and f32
scales), pk4 (per-256-group unsigned nibble-plane dots × sg) and di8b (a
full-K int8 dot over int8 weights, × s[:, 0]). The activations are quantized
by the port's `q8_quantize` (block 32) in the wrapper, outside the kernel, as
the JAX bench does it; a caller that has them already passes `xq` and the
timed launch is the kernel's alone. The XLA candidates xb8, xb4, xb4f and
xb4K are plain torch here, timed as yardsticks only, and the q4s row is the
port's K5 (`ops/w8a8.py::q4s_matmul`).

The port reads its JQ4 bytes (uint8 [N, K/2]) directly: pb8's [nb, 16, N]
is their half-block order transposed, and pk4's group-major [ngrp, N, 128]
their rows cut in groups of 128 bytes. Wrappers run their plain version for
CPU tensors and launch for CUDA tensors (or raise), counting `.launches`;
`main()` runs on the card unless `--device cpu` is given (then at 256x512).
"""

from __future__ import annotations

import argparse
import ctypes
import sys

import torch

from ..device import resolve_device
from ..ops import _build
from ..quant import blockq
from . import _common as C
from .kbench_q4 import print_rows, shapes_from_env

BS, GROUP = 32, 256
BLOCKS, FLOAT, GROUPS, INT8 = range(4)
SHAPES = [(8192, 2048), (2048, 8192)]  # the JAX bench's

_V, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"kbench_w8a8": [_I, _V, _V, _V, _V, _V, _I, _I, _I, _V]}


# ---- plain versions ---------------------------------------------------------

def _planes(packed):
    """uint8 [N, K/2] -> unsigned nibble planes lo, hi [N, K/32, 16] as f64."""
    n = packed.shape[0]
    b = packed.reshape(n, -1, 16).to(torch.int32)
    return (b & 0x0F).double(), (b >> 4).double()


def blocks_plain(xq, xs, packed, s) -> torch.Tensor:
    """pb8 / pgb8: per 32-block the exact integer dot d of int8 x with the
    unsigned nibbles and the block's activation sum asum (f64 holds them
    exactly), then sum_b f32(d − 8 asum) · xs_b · s_b, bf16 out."""
    m, k = xq.shape
    nb = k // BS
    lo, hi = _planes(packed)
    a = xq.reshape(m, nb, BS).double()
    d = torch.einsum("mbj,nbj->mnb", a[..., :16], lo) \
        + torch.einsum("mbj,nbj->mnb", a[..., 16:], hi)
    df = (d - 8.0 * a.sum(dim=-1)[:, None, :]).float()
    return (df * xs[:, None, :] * s[None, :, :]).sum(dim=-1).to(torch.bfloat16)


def float_plain(x, packed, s) -> torch.Tensor:
    """pgbf: sum_b (x_b · n_b − 8 bsum_b) · s_b with bf16 x, f32 sums and
    scales, bf16 out."""
    m, k = x.shape
    nb = k // BS
    lo, hi = (p.float() for p in _planes(packed))
    xb = x.to(torch.bfloat16).float().reshape(m, nb, BS)
    d = torch.einsum("mbj,nbj->mnb", xb[..., :16], lo) \
        + torch.einsum("mbj,nbj->mnb", xb[..., 16:], hi)
    return ((d - 8.0 * xb.sum(dim=-1)[:, None, :]) * s[None]).sum(dim=-1).to(torch.bfloat16)


def _group_dots(xq, packed) -> torch.Tensor:
    """Per 256-group g the exact integer dots (f64) of xq[:, :K/2] with the
    low planes and xq[:, K/2:] with the high planes of the group's 128 byte
    columns: [M, N, K/256]."""
    m, k = xq.shape
    n, ngrp = packed.shape[0], k // GROUP
    p = packed.reshape(n, ngrp, 128).to(torch.int32)
    xl = xq[:, : k // 2].reshape(m, ngrp, 128).double()
    xh = xq[:, k // 2:].reshape(m, ngrp, 128).double()
    return torch.einsum("mgc,ngc->mng", xl, (p & 0x0F).double()) \
        + torch.einsum("mgc,ngc->mng", xh, (p >> 4).double())


def groups_plain(xq, packed, sg) -> torch.Tensor:
    """pk4: f32(d_g) · sg[g, n] summed over the groups g, bf16 out."""
    return (_group_dots(xq, packed).float() * sg.t()[None]).sum(dim=-1).to(torch.bfloat16)


def int8_plain(xq, w8, s) -> torch.Tensor:
    """di8b: the exact full-K integer dot (f64), to f32, × s[:, 0], bf16 out."""
    d = xq.double() @ w8.double().t()
    return (d.float() * s[:, 0][None, :]).to(torch.bfloat16)


# ---- wrappers ---------------------------------------------------------------

def _launch(fn, kind: int, x, xs, w, s) -> torch.Tensor:
    name = fn.__name__
    m, k = x.shape
    n = w.shape[0]
    if not 1 <= m <= 16 or k % BS or (kind == GROUPS and k % GROUP):
        raise ValueError(f"{name}: takes 1 <= M <= 16 and K % {GROUP if kind == GROUPS else BS}"
                         f" == 0 (M {m}, K {k})")
    C.need(name, x, torch.bfloat16 if kind == FLOAT else torch.int8, (m, k))
    if xs is not None:
        C.need(name, xs, torch.float32, (m, k // BS), align=4)
    if kind == INT8:
        C.need(name, w, torch.int8, (n, k))
    else:
        C.need(name, w, torch.uint8, (n, k // 2))
    C.need(name, s, torch.float32, (k // GROUP, n) if kind == GROUPS else (n, k // BS), align=4)
    y = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    lib = _build.load("kbench_w8a8", _SIGNATURES)
    err = lib.kbench_w8a8(kind, x.data_ptr(), xs.data_ptr() if xs is not None else None,
                          w.data_ptr(), s.data_ptr(), y.data_ptr(), m, n, k, C.stream(x))
    _build.check(err, name)
    fn.launches += 1
    return y


def pb8(x, packed, s, xq=None):
    """`_k_pb8`: exact per-block int8 dots, f32 combine. `xq`: (int8 x, f32
    scales) from q8_quantize(x), made here when not given."""
    xq, xs = xq if xq is not None else blockq.q8_quantize(x)
    if not C.on_cuda("pb8", x, packed, s):
        return blocks_plain(xq, xs, packed, s)
    return _launch(pb8, BLOCKS, xq, xs, packed, s)


def pgb(x, packed, s, dom="i8", xq=None):
    """`_k_pgb`: dom "i8" is pb8's function (one kernel serves both); dom
    "bf16" takes x unquantized, with f32 scales."""
    if dom == "bf16":
        if not C.on_cuda("pgb", x, packed, s):
            return float_plain(x, packed, s)
        return _launch(pgb, FLOAT, x.to(torch.bfloat16).contiguous(), None, packed, s)
    xq, xs = xq if xq is not None else blockq.q8_quantize(x)
    if not C.on_cuda("pgb", x, packed, s):
        return blocks_plain(xq, xs, packed, s)
    return _launch(pgb, BLOCKS, xq, xs, packed, s)


def pk4(x, packed, sg, xq=None):
    """`_k_pk4`: per-256-group nibble-plane dots × sg [K/256, N] (f32); the
    activation scales are dropped, as in the JAX kernel."""
    xq = xq if xq is not None else blockq.q8_quantize(x)[0]
    if not C.on_cuda("pk4", x, packed, sg):
        return groups_plain(xq, packed, sg)
    return _launch(pk4, GROUPS, xq, None, packed, sg)


def di8b(x, w8, s, xq=None):
    """`_k_di8b`: full-K int8 dot over int8 weights [N, K] (values −8..7),
    × s[:, 0]; the activation scales are dropped, as in the JAX kernel."""
    xq = xq if xq is not None else blockq.q8_quantize(x)[0]
    if not C.on_cuda("di8b", x, w8, s):
        return int8_plain(xq, w8, s)
    return _launch(di8b, INT8, xq, None, w8, s)


WRAPPERS = (pb8, pgb, pk4, di8b)
for _w in WRAPPERS:
    _w.launches = 0
REPLACES = {"pb8": "scripts/kbench_w8a8.py:163", "pgb": "scripts/kbench_w8a8.py:217",
            "di8b": "scripts/kbench_w8a8.py:319", "pk4": "scripts/kbench_w8a8.py:356"}


# ---- yardsticks: the XLA candidates in plain torch, timed only ---------------

def xb8(x, w3, s2):
    """XLA batched int8 dot over int8 weights [nb, 32, N] (2x the bytes)."""
    m, k = x.shape
    nb = k // BS
    xq, xs = blockq.q8_quantize(x)
    d = torch.bmm(xq.reshape(m, nb, BS).transpose(0, 1).float(), w3.float())  # [nb, M, N]
    return (d * xs.t()[:, :, None] * s2[:, None, :]).sum(dim=0).to(torch.bfloat16)


def xb4(x, p3, s2):
    """xb8 from 4-bit storage (packed nibbles [nb, 16, N]; torch has no int4)."""
    w3 = torch.cat([(p3 & 0x0F).to(torch.int8) - 8, (p3 >> 4).to(torch.int8) - 8], dim=1)
    return xb8(x, w3, s2)


def xb4f(x, packed, s):
    """Dequantize to bf16 and one full-K bf16 matmul."""
    wd = blockq.q4_dequantize(packed, s).to(torch.bfloat16)
    return torch.matmul(x.to(torch.bfloat16), wd.t())


def xb4K(x, w8, s):
    """Full-K int8 dot (as an f32 matmul of integers) × s[:, 0]."""
    xq, _ = blockq.q8_quantize(x)
    return ((xq.float() @ w8.float().t()) * s[:, 0][None, :]).to(torch.bfloat16)


def _q4s(x, w):
    from ..ops.w8a8 import q4s_matmul
    return q4s_matmul(x, w)


# name -> (fn, keyword arguments, weight form, rel limit against the exact
# reference or None, kind); the JAX bench's names
VARIANTS = {
    "q4s": (_q4s, {}, "q4s", None, "product"),
    "xb8": (xb8, {}, "int8_blocks", 2e-2, "yardstick"),
    "xb4": (xb4, {}, "packed_blocks", 2e-2, "yardstick"),
    "xb4f": (xb4f, {}, "jq4", 2e-2, "yardstick"),
    "xb4K": (xb4K, {}, "int8", None, "yardstick"),
    "pb8": (pb8, {}, "jq4", 2e-2, "variant"),
    "pgb8": (pgb, {"dom": "i8"}, "jq4", 2e-2, "variant"),
    "pgbf": (pgb, {"dom": "bf16"}, "jq4", 5e-2, "variant"),
    "di8b": (di8b, {}, "int8", None, "variant"),
    "pk4": (pk4, {}, "groups", 2e-2, "variant"),
}
EXACT = ("di8b",)  # one integer sum and one float multiply: equal to the plain version
_PLAIN = {BLOCKS: "blocks", FLOAT: "float", GROUPS: "groups", INT8: "int8"}


def make_inputs(n: int, k: int, m: int, device, seed: int = 0):
    """(x bf16 [M, K], packed uint8 [N, K/2], scales f32 [N, K/32] in
    [0.001, 0.021), sg f32 [K/256, N] in [0, 0.02)) from a seed, as the JAX
    bench draws them (its sg comes from default_rng(1) in _prep_pk4)."""
    g = torch.Generator(device=device).manual_seed(seed + n * k)
    packed = torch.randint(0, 256, (n, k // 2), generator=g, device=device, dtype=torch.uint8)
    scales = torch.rand((n, k // BS), generator=g, device=device) * 0.02 + 0.001
    sg = torch.rand((k // GROUP, n), generator=g, device=device) * 0.02
    x = torch.randn((m, k), generator=g, device=device).to(torch.bfloat16)
    return x, packed, scales, sg


def exact_w8a8(xq, xs, packed, s) -> torch.Tensor:
    """`ref_w8a8`: per-block integer dots of int8 x with the signed values
    (nibble − 8) times both scales, in f64."""
    m, k = xq.shape
    nb = k // BS
    vals = blockq.q4_unpack(packed).double().reshape(-1, nb, BS)
    d = torch.einsum("mbj,nbj->mnb", xq.reshape(m, nb, BS).double(), vals)
    return torch.einsum("mnb,mb,nb->mn", d, xs.double(), s.double())


def run(names, shapes, m: int, device, seed: int = 0, timer=None) -> list[dict]:
    """One row per (variant, shape) at M = m. On the card each kernel is held
    against its plain version (`limit_ratio` <= 1 passes) and every row is
    timed; on the CPU the wrappers run the plain versions, nothing is timed
    (ms None), and the yardsticks and q4s are skipped."""
    from ..utils.cuda_timer import INT8_OPS_PER_S

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda and timer is None:
        from ..utils.cuda_timer import Timer
        timer = Timer(dev)
    rows = []
    for n, k in shapes:
        x, packed, scales, sg = make_inputs(n, k, m, dev, seed)
        xq, xs = blockq.q8_quantize(x)
        exact = exact_w8a8(xq, xs, packed, scales)
        exact_pk4 = (_group_dots(xq, packed) * sg.t().double()[None]).sum(dim=-1)  # `ref_pk4`
        nb, ngrp = k // BS, k // GROUP
        weights = {"jq4": packed, "groups": packed}
        plain_ms = {}
        for name in names:
            fn, kw, form, tol, kind = VARIANTS[name]
            row = dict(variant=name, body=fn.__name__, N=n, K=k, M=m, kind=kind, ms=None,
                       plain_ms=None)
            if kind != "variant" and not cuda:
                continue
            if form not in weights:
                if form == "q4s":
                    from ..nn.qarray import QArray
                    from ..ops.w8a8 import to_q4s
                    weights[form] = to_q4s(QArray(packed, scales, "q4"))
                elif form in ("int8", "int8_blocks"):
                    vals = blockq.q4_unpack(packed)
                    weights["int8"] = vals
                    weights["int8_blocks"] = vals.reshape(n, nb, BS).permute(1, 2, 0).contiguous()
                elif form == "packed_blocks":
                    weights[form] = packed.reshape(n, nb, 16).permute(1, 2, 0).contiguous()
            w = weights[form]
            if form == "groups":
                s = sg
            elif form in ("int8_blocks", "packed_blocks"):
                s = scales.t().contiguous()
            else:
                s = scales
            if kind != "variant":
                call = (lambda: fn(x, w)) if form == "q4s" else (lambda: fn(x, w, s))
                row["ms"] = timer(call, sleep_cycles=C.SLEEP_CYCLES)
                if tol is not None:
                    y = call().double()
                    row["rel_err_exact"] = ((y - exact).abs().max() / exact.abs().max()).item()
                rows.append(row)
                continue
            pre = None if kw.get("dom") == "bf16" else ((xq, xs) if fn in (pb8, pgb) else xq)
            args = (x, w, s)
            kwargs = dict(kw, xq=pre) if pre is not None else dict(kw)
            y = fn(*args, **kwargs)
            if tol is not None:
                ref = exact_pk4 if name == "pk4" else exact
                row["rel_err_exact"] = ((y.double() - ref).abs().max() / ref.abs().max()).item()
                row["wrong"] = row["rel_err_exact"] > tol
            if cuda:
                kid = {"pb8": BLOCKS, "pgb8": BLOCKS, "pgbf": FLOAT, "pk4": GROUPS,
                       "di8b": INT8}[name]
                plain = {BLOCKS: lambda: blocks_plain(xq, xs, w, s),
                         FLOAT: lambda: float_plain(x, w, s),
                         GROUPS: lambda: groups_plain(xq, w, s),
                         INT8: lambda: int8_plain(xq, w, s)}[kid]
                out = m * n * 2
                nbytes = {BLOCKS: n * k // 2 + n * nb * 4 + m * k + m * nb * 4 + out,
                          FLOAT: n * k // 2 + n * nb * 4 + m * k * 2 + out,
                          GROUPS: n * k // 2 + ngrp * n * 4 + m * k + out,
                          INT8: n * k + n * 4 + m * k + out}[kid]
                C.card_row(row, timer, lambda: fn(*args, **kwargs), y, plain, plain_ms, _PLAIN[kid],
                           nbytes, 2.0 * m * n * k, name in EXACT,
                           None if kid == FLOAT else INT8_OPS_PER_S)
                row["gbps_q4"] = (n * k // 2 + n * nb * 2) / row["ms"] / 1e6
            rows.append(row)
    return rows


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", help=f"default: all of {list(VARIANTS)}")
    ap.add_argument("--m", type=int, default=1, help="activation rows (1..16)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    names = args.variants or list(VARIANTS)
    unknown = [v for v in names if v not in VARIANTS]
    if unknown:
        print(f"unknown variant(s) {unknown}; valid: {list(VARIANTS)}")
        sys.exit(2)
    dev = resolve_device(args.device)
    rows = run(names, shapes_from_env(SHAPES if dev.type == "cuda" else [(256, 512)]),
               args.m, dev)
    print_rows(rows)
    return rows


if __name__ == "__main__":
    main()
