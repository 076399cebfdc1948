"""P3, second half: the q4s σ-product probes on the card (counterpart of
`scripts/probe_sigma_i16.py`).

    python -m jlama_tpu_torch.scripts.probe_sigma_i16 [NAME ...] [--m 1|16] [--device cpu]

The JAX probe asked which lowering of the q4s product w · σ (w u8 0..15, σ
u8 1..16, the product ≤ 240) Mosaic takes: widened to 16 or 32 bits, then
into a bf16 dot (A, A2) or an int32 dot (C, D). Each becomes a kernel of
`csrc/probe_sigma_i16.cu`; all compute y = x · (w · σ)ᵀ with x int8, f32
out, at the probe's N = 256, K = 512, and every output is an exact integer,
so each is held to equality with its plain version.

Wrappers run the plain version for CPU tensors and launch for CUDA tensors
(or raise), counting `.launches`; `main()` runs on the card unless
`--device cpu` is given.
"""

from __future__ import annotations

import argparse
import ctypes

import torch

from ..device import resolve_device
from ..ops import _build
from . import _common as C

N, K = 256, 512  # the probe's
_V, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"probe_sigma_i16": [_I, _V, _V, _V, _V, _I, _I, _I, _V]}


def sigma_plain(x, w, sigma) -> torch.Tensor:
    """y = x · (w · σ)ᵀ as an exact integer sum (f64), f32 out."""
    p = (w.to(torch.int32) * sigma.to(torch.int32)).double()
    return (x.double() @ p.t()).float()


def _launch(fn, policy: int, x, w, sigma) -> torch.Tensor:
    name = fn.__name__
    if not C.on_cuda(name, x, w, sigma):
        return sigma_plain(x, w, sigma)
    m, k = x.shape
    n = w.shape[0]
    if not 1 <= m <= 16 or k % 16:
        raise ValueError(f"{name}: takes 1 <= M <= 16 and K % 16 == 0 (M {m}, K {k})")
    C.need(name, x, torch.int8, (m, k))
    C.need(name, w, torch.uint8, (n, k))
    C.need(name, sigma, torch.uint8, (n, k))
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    lib = _build.load("probe_sigma_i16", _SIGNATURES)
    err = lib.probe_sigma_i16(policy, x.data_ptr(), w.data_ptr(), sigma.data_ptr(), y.data_ptr(),
                              m, n, k, C.stream(x))
    _build.check(err, name)
    fn.launches += 1
    return y


def a_i16mul_bf16dot(x, w, sigma):
    """`kA`: 16-bit product, bf16 convert, f32 dot."""
    return _launch(a_i16mul_bf16dot, 0, x, w, sigma)


def a2_i32mul_bf16dot(x, w, sigma):
    """`kA2`: 32-bit product, bf16 convert, f32 dot."""
    return _launch(a2_i32mul_bf16dot, 1, x, w, sigma)


def c_i16mul_i32dot(x, w, sigma):
    """`kC`: 16-bit products into __dp2a (an int32 dot)."""
    return _launch(c_i16mul_i32dot, 2, x, w, sigma)


def d_i32mul_i32dot(x, w, sigma):
    """`kD`: 32-bit products, repacked to u8 lanes, into dp4a (an int32 dot)."""
    return _launch(d_i32mul_i32dot, 3, x, w, sigma)


WRAPPERS = (a_i16mul_bf16dot, a2_i32mul_bf16dot, c_i16mul_i32dot, d_i32mul_i32dot)
for _w in WRAPPERS:
    _w.launches = 0
# the JAX probe's names -> wrapper
PROBES = {"A_i16mul_bf16dot": a_i16mul_bf16dot, "A2_i32mul_bf16dot": a2_i32mul_bf16dot,
          "C_i16mul_i32dot": c_i16mul_i32dot, "D_i32mul_i32dot": d_i32mul_i32dot}
REPLACES = {"a_i16mul_bf16dot": "scripts/probe_sigma_i16.py:73",
            "a2_i32mul_bf16dot": "scripts/probe_sigma_i16.py:85",
            "c_i16mul_i32dot": "scripts/probe_sigma_i16.py:96",
            "d_i32mul_i32dot": "scripts/probe_sigma_i16.py:108"}


def make_inputs(n: int, k: int, m: int, device, seed: int = 0):
    """(x int8 [M, K] in [-64, 64), w uint8 [N, K] in [0, 16), σ uint8 [N, K]
    in [1, 17)) from a seed, the probe's ranges."""
    g = torch.Generator(device=device).manual_seed(seed + n * k)
    w = torch.randint(0, 16, (n, k), generator=g, device=device, dtype=torch.uint8)
    sigma = torch.randint(1, 17, (n, k), generator=g, device=device, dtype=torch.uint8)
    x = torch.randint(-64, 64, (m, k), generator=g, device=device, dtype=torch.int8)
    return x, w, sigma


def run(names, device, n: int = N, k: int = K, m: int = 1, seed: int = 0,
        timer=None) -> list[dict]:
    """One row per probe. On the card each kernel must equal its plain
    version, and both are timed; on the CPU nothing is timed."""
    from ..utils.cuda_timer import INT8_OPS_PER_S

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda and timer is None:
        from ..utils.cuda_timer import Timer
        timer = Timer(dev)
    x, w, sigma = make_inputs(n, k, m, dev, seed)
    exact = sigma_plain(x, w, sigma)
    rows, plain_ms = [], {}
    for name in names:
        fn = PROBES[name]
        y = fn(x, w, sigma)
        row = dict(variant=name, body=fn.__name__, N=n, K=k, M=m, kind="variant",
                   equal=bool(torch.equal(y, exact)), ms=None, plain_ms=None)
        if cuda:
            C.card_row(row, timer, lambda: fn(x, w, sigma), y, lambda: sigma_plain(x, w, sigma),
                       plain_ms, "sigma_plain", 2 * n * k + m * k + 4 * m * n, 2.0 * m * n * k,
                       exact=True, ops_per_s=INT8_OPS_PER_S)
        rows.append(row)
    if cuda:  # the library call: one f32 matmul on the products, made once
        xf, pf = x.float(), (w.to(torch.int32) * sigma.to(torch.int32)).float()
        rows.append(dict(variant="torch.matmul f32", N=n, K=k, M=m, kind="yardstick",
                         ms=timer(lambda: torch.matmul(xf, pf.t()), sleep_cycles=C.SLEEP_CYCLES)))
    return rows


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("probes", nargs="*", help=f"default: all of {list(PROBES)}")
    ap.add_argument("--m", type=int, default=1, help="activation rows (1..16)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    unknown = [p for p in args.probes if p not in PROBES]
    if unknown:
        ap.error(f"unknown probe(s) {unknown}; valid: {list(PROBES)}")
    rows = run(args.probes or list(PROBES), resolve_device(args.device), m=args.m)
    for r in rows:
        if r["kind"] == "yardstick":
            print(f"{r['variant']}: {r['ms'] * 1e3:.1f}us", flush=True)
            continue
        status = "OK exact" if r["equal"] else "WRONG"
        if r["ms"] is not None:
            status += f" {r['ms'] * 1e3:.1f}us"
        print(f"{r['variant']}: {status}", flush=True)
    return rows


if __name__ == "__main__":
    main()
