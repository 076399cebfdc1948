"""P3, first half: the native-int4 probes on the card (counterpart of
`scripts/probe_int4.py`).

    python -m jlama_tpu_torch.scripts.probe_int4 [xla|pallas|bitcast ...] [--device cpu]

The JAX probe asked whether Mosaic takes a u4 → bf16 convert ("pallas") and
a u8 → 2 × u4 bitcast ("bitcast") inside a kernel, each a GEMV of unsigned
nibbles with no offset: y = x · (u4 · s[:, c mod NB])ᵀ, x bf16 [8, 4096],
W [4096, 4096], the scales tiled along K as `pltpu.repeat` tiles them. The
card has no 4-bit type, so both ports stream the same packed bytes (uint8
[N, K/2], element 2i in the low nibble of byte i, the order of JAX's
bitcast) and differ in how a nibble becomes bf16 (`csrc/probe_int4.cu`):
`u4_convert` converts each nibble as an integer, `u4_bitcast` splits a word
into bf16 pairs with one `lop3`. "xla" is a yardstick in plain torch (no
kernel): the XLA probe's int4 matmul with per-block signed values.

The wrappers run their plain version for tensors on the CPU and launch for
CUDA tensors (or raise), counting launches in `.launches`. `main()` runs on
the card unless `--device cpu` is given (then at N = K = 512).
"""

from __future__ import annotations

import argparse
import ctypes

import torch

from ..device import resolve_device
from ..ops import _build
from . import _common as C

N, K, M = 4096, 4096, 8  # the probe's shapes
CVT, MAGIC = 0, 1

_V, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"probe_int4": [_I, _V, _V, _V, _V, _I, _I, _I, _I, _V]}


def pack_u4(nibbles: torch.Tensor) -> torch.Tensor:
    """uint8 nibbles [N, K] (0..15) -> uint8 [N, K/2], element 2i in the low
    nibble of byte i."""
    return nibbles[:, 0::2] | (nibbles[:, 1::2] << 4)


def u4_plain(x, packed, s) -> torch.Tensor:
    """y = x · (u4 · s[:, c mod NB])ᵀ: the bf16 product of nibble and tiled
    scale, f32 sums, bf16 out."""
    n, kh = packed.shape
    nib = torch.stack([packed & 0x0F, packed >> 4], dim=-1).reshape(n, 2 * kh)
    st = s[:, torch.arange(2 * kh, device=s.device) % s.shape[1]]
    w = (nib.to(torch.bfloat16) * st).float()
    return (x.to(torch.bfloat16).float() @ w.t()).to(torch.bfloat16)


def _launch(fn, policy: int, x, packed, s) -> torch.Tensor:
    name = fn.__name__
    if not C.on_cuda(name, x, packed, s):
        return u4_plain(x, packed, s)
    m, k = x.shape
    n, nb = packed.shape[0], s.shape[1]
    if not 1 <= m <= 16 or k % 32 or nb % 32:
        raise ValueError(f"{name}: takes 1 <= M <= 16, K % 32 == 0 and NB % 32 == 0 "
                         f"(M {m}, K {k}, NB {nb})")
    C.need(name, x, torch.bfloat16, (m, k))
    C.need(name, packed, torch.uint8, (n, k // 2))
    C.need(name, s, torch.bfloat16, (n, nb))
    y = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    lib = _build.load("probe_int4", _SIGNATURES)
    err = lib.probe_int4(policy, x.data_ptr(), packed.data_ptr(), s.data_ptr(), y.data_ptr(),
                         m, n, k, nb, C.stream(x))
    _build.check(err, name)
    fn.launches += 1
    return y


def u4_convert(x, packed, s):
    """probe_pallas's kernel (`scripts/probe_int4.py:69`): per-nibble convert."""
    return _launch(u4_convert, CVT, x, packed, s)


def u4_bitcast(x, packed, s):
    """probe_bitcast's kernel (`scripts/probe_int4.py:103`): lop3 split of a word."""
    return _launch(u4_bitcast, MAGIC, x, packed, s)


u4_convert.launches = 0
u4_bitcast.launches = 0
WRAPPERS = (u4_convert, u4_bitcast)
REPLACES = {"u4_convert": "scripts/probe_int4.py:69", "u4_bitcast": "scripts/probe_int4.py:103"}
PROBES = {"pallas": u4_convert, "bitcast": u4_bitcast}


def xla_yardstick(x, vals, s) -> torch.Tensor:
    """probe_xla (no Pallas) in plain torch: signed values [N, K] (int8: torch
    has no int4) to bf16, times the block scale s[:, c // 32], one matmul."""
    n, k = vals.shape
    wf = (vals.to(torch.bfloat16).reshape(n, k // 32, 32) * s[..., None]).reshape(n, k)
    return x @ wf.t()


def make_inputs(n: int, k: int, m: int, device, seed: int = 0):
    """(x bf16 [M, K], packed uint8 [N, K/2] of nibbles 0..14 as the probe
    draws them, scales bf16 [N, K/32] that are not constant: the probe's
    constant 0.01 would hide the order of the tiled scales)."""
    g = torch.Generator(device=device).manual_seed(seed + n * k)
    nib = torch.randint(0, 15, (n, k), generator=g, device=device, dtype=torch.uint8)
    s = ((torch.rand((n, k // 32), generator=g, device=device) + 0.5) * 0.01).to(torch.bfloat16)
    x = torch.randn((m, k), generator=g, device=device).to(torch.bfloat16)
    return x, pack_u4(nib), s


def run(names, device, n: int = N, k: int = K, m: int = M, seed: int = 0,
        timer=None) -> list[dict]:
    """One row per probe at [M, K] x [N, K]. On the card each kernel is held
    against its plain version and timed; on the CPU nothing is timed."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda and timer is None:
        from ..utils.cuda_timer import Timer
        timer = Timer(dev)
    x, packed, s = make_inputs(n, k, m, dev, seed)
    nbytes = n * k // 2 + s.numel() * 2 + m * k * 2 + m * n * 2
    rows, plain_ms = [], {}
    for name in names:
        row = dict(variant=name, N=n, K=k, M=m, ms=None, plain_ms=None)
        if name == "xla":
            row.update(kind="yardstick", body="xla")
            vals = (torch.stack([packed & 0x0F, packed >> 4], -1).reshape(n, k).to(torch.int8) - 8)
            if cuda:
                row["ms"] = timer(lambda: xla_yardstick(x, vals, s), sleep_cycles=C.SLEEP_CYCLES)
        else:
            fn = PROBES[name]
            row.update(kind="variant", body=fn.__name__)
            y = fn(x, packed, s)
            row["finite"] = bool(torch.isfinite(y.float()).all())
            if cuda:
                C.card_row(row, timer, lambda: fn(x, packed, s), y,
                           lambda: u4_plain(x, packed, s), plain_ms, "u4_plain", nbytes,
                           2.0 * m * n * k, exact=False)
                row["gbps_q4"] = (n * k // 2 + s.numel() * 2) / row["ms"] / 1e6
        rows.append(row)
    if cuda:  # the library call on a bf16 weight dequantized once
        nib = torch.stack([packed & 0x0F, packed >> 4], -1).reshape(n, k)
        wd = nib.to(torch.bfloat16) * s[:, torch.arange(k, device=dev) % s.shape[1]]
        rows.append(dict(variant="torch.matmul bf16", N=n, K=k, M=m, kind="yardstick",
                         ms=timer(lambda: torch.matmul(x, wd.t()), sleep_cycles=C.SLEEP_CYCLES)))
    return rows


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("probes", nargs="*", help="xla, pallas, bitcast (default: all three)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    unknown = [p for p in args.probes if p not in ("xla", *PROBES)]
    if unknown:
        ap.error(f"unknown probe(s) {unknown}")
    dev = resolve_device(args.device)
    size = {} if dev.type == "cuda" else dict(n=512, k=512)
    rows = run(args.probes or ["xla", "pallas", "bitcast"], dev, **size)
    for r in rows:
        if r["variant"] not in ("xla", *PROBES):
            continue
        what = "ok" if r["ms"] is None else f"OK {r['ms']:.4f} ms"
        if r.get("gbps_q4"):
            what += f" -> {r['gbps_q4']:.0f} GB/s"
        print(f"{r['variant']} [{r['M']}x{r['K']}] x [{r['N']}x{r['K']}]: {what}", flush=True)
    return rows


if __name__ == "__main__":
    main()
