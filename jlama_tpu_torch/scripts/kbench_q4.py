"""P1: the q4 GEMV design variants on the card (counterpart of
`scripts/kbench_q4.py`).

    python -m jlama_tpu_torch.scripts.kbench_q4 [VARIANT ...] [--m 1|16] [--device cpu]

Each variant of the JAX bench computes y = x · deq(W)ᵀ from JQ4 weights with
bf16 block scales, in its own way; `csrc/kbench_q4.cu` holds the Hopper form
of each (its header says which policy stands for which idea). The port reads
its own JQ4 layout (uint8 [N, K/2], byte j of a 32-block = element j low,
j + 16 high), so the TPU's q4k column permutation and x split are not needed.
Every kernel has its plain PyTorch version here, which rounds where the TPU
kernel rounds (bf16 scales, the bf16 product of plane value and scale, f32
sums and block sums, bf16 out), so the kernel is held to it tightly; each
row's error against the exact f32 product is reported apart (`WRONG(rel)`
above 2e-2, as the JAX bench prints it).

The wrappers take tensors on the CPU (the plain version runs) or on one CUDA
device (the kernel launches, or the wrapper raises), and count their
launches in `.launches`. `main()` runs on the card unless `--device cpu` is
given; shapes come from `JLAMA_KBENCH_SHAPES` ("NxK,NxK"), else the JAX
bench's Llama-3.2-1B shapes (on the CPU: 256x512).
"""

from __future__ import annotations

import argparse
import ctypes
import os
import sys

import torch

from ..device import resolve_device
from ..ops import _build
from ..quant import blockq
from . import _common as C

# the extraction policies of csrc/kbench_q4.cu
I32, SWAR8, SWAR8_MASK, SWAR16_MASK, I32_MASK, MAGIC_SUB, MAGIC, FLOOR, BYTE = range(9)
STREAM, DOT2, DI8 = range(3)
ROWS = 8  # output rows per thread block: one per warp, K1's GEMV
WDOM = {"u8": SWAR8_MASK, "i16": SWAR16_MASK, "i32": I32_MASK}  # v8b's lane domains

_V, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "kbench_q4_gemv": [_I, _I, _V, _V, _V, _V, _V, _I, _I, _I, _I, _V],
    "kbench_q4_diag": [_I, _V, _V, _V, _V, _I, _I, _I, _V],
}

SHAPES_1B = [(8192, 2048), (2048, 8192), (2048, 2048), (128256, 2048)]  # the JAX bench's
SHAPES_8B = [(14336, 4096), (4096, 14336)]  # Llama-3.1-8B's w1/w3 and w2, its env example


# ---- plain versions ---------------------------------------------------------

def _bf16_product(vals: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Integer-valued plane values (exact in bf16) times bf16 scales, rounded
    to bf16 as the TPU kernels' `plane * srep`, returned as f32."""
    return (vals.to(torch.bfloat16) * scales).float()


def variant_plain(policy: int, x, packed, s, srep=None) -> torch.Tensor:
    """The function of a GEMV variant: x bf16 [M, K], packed uint8 [N, K/2],
    s bf16 [N, K/32], srep bf16 [N, K/2] (pre-expanded scales, repeat order)
    or None. Returns bf16 [M, N]."""
    m, k = x.shape
    n, nb = packed.shape[0], k // 32
    xb = x.to(torch.bfloat16).float().reshape(m, nb, 32)
    xl, xh = xb[..., :16], xb[..., 16:]
    sc = (srep.reshape(n, nb, 16) if srep is not None
          else s.reshape(n, nb, 1).expand(n, nb, 16))
    byte = packed.reshape(n, nb, 16).to(torch.int32)
    lo, hi = byte & 0x0F, byte >> 4
    offset = 8.0
    if policy in (MAGIC_SUB, FLOOR):  # -8 in registers
        wl, wh, offset = _bf16_product(lo - 8, sc), _bf16_product(hi - 8, sc), 0.0
    elif policy == MAGIC:  # planes 128 + n, rank-1 136
        wl, wh, offset = _bf16_product(lo + 128, sc), _bf16_product(hi + 128, sc), 136.0
    elif policy == BYTE:  # byte . x_lo + hi . (x_hi - 16 x_lo), the latter in bf16
        wl, wh = _bf16_product(byte, sc), _bf16_product(hi, sc)
        xh = (xh - 16.0 * xl).to(torch.bfloat16).float()
    elif policy in (SWAR8_MASK, SWAR16_MASK, I32_MASK):  # hi plane x16, scale s/16
        wl, wh = _bf16_product(lo, sc), _bf16_product(hi * 16, sc * 0.0625)
    else:
        wl, wh = _bf16_product(lo, sc), _bf16_product(hi, sc)
    d = xl.reshape(m, -1) @ wl.reshape(n, -1).t() + xh.reshape(m, -1) @ wh.reshape(n, -1).t()
    if offset:
        d = d - offset * (xb.sum(dim=-1) @ s.float().t())
    return d.to(torch.bfloat16)


def _x_half(x) -> torch.Tensor:
    return x[:, : x.shape[1] // 2].to(torch.bfloat16).float()


def stream_plain(x, packed, s) -> torch.Tensor:
    """x[:, :K/2] · bytesᵀ + each row's scale sum, bf16 out."""
    return (_x_half(x) @ packed.float().t() + s.float().sum(dim=1)[None, :]).to(torch.bfloat16)


def dot2_plain(x, packed, s) -> torch.Tensor:
    """x[:, :K/2] · (bytes · s[:, c mod nb])ᵀ + x[:, :K/2] · bytesᵀ, bf16 out."""
    kh, nb = packed.shape[1], s.shape[1]
    st = s[:, torch.arange(kh, device=s.device) % nb]
    xh = _x_half(x)
    return (xh @ _bf16_product(packed, st).t() + xh @ packed.float().t()).to(torch.bfloat16)


def di8_plain(x, packed, s) -> torch.Tensor:
    """int8(clip(16 · x[:, :K/2], ±127)) · (bytes as s8)ᵀ as an exact integer
    sum (float64), to f32, + s[0, 0], bf16 out."""
    xq = torch.clamp(16.0 * _x_half(x), -127.0, 127.0).to(torch.int8)
    d = xq.double() @ packed.view(torch.int8).double().t()
    return (d.float() + s[0, 0].float()).to(torch.bfloat16)


# ---- wrappers ---------------------------------------------------------------

def _gemv(fn, policy: int, x, packed, s, srep, rows: int) -> torch.Tensor:
    name = fn.__name__
    extra = (srep,) if srep is not None else ()
    if not C.on_cuda(name, x, packed, s, *extra):
        return variant_plain(policy, x, packed, s, srep)
    m, k = x.shape
    n = packed.shape[0]
    if not 1 <= m <= 16 or k % 32 or rows <= 0:
        raise ValueError(f"{name}: takes 1 <= M <= 16, K % 32 == 0 (M {m}, K {k})")
    C.need(name, x, torch.bfloat16, (m, k))
    C.need(name, packed, torch.uint8, (n, k // 2))
    C.need(name, s, torch.bfloat16, (n, k // 32), align=2)
    if srep is not None:
        C.need(name, srep, torch.bfloat16, (n, k // 2))
    y = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    lib = _build.load("kbench_q4", _SIGNATURES)
    err = lib.kbench_q4_gemv(policy, int(srep is not None), x.data_ptr(), packed.data_ptr(),
                             s.data_ptr(), srep.data_ptr() if srep is not None else None,
                             y.data_ptr(), m, n, k, rows, C.stream(x))
    _build.check(err, name)
    fn.launches += 1
    return y


def v2(x, packed, s, rows=ROWS):
    """K1's body (`jlama_tpu/ops/pallas_q4.py:113`) as the bench runs it:
    32-bit shift and mask per byte, bf16 scales, rank-1 −8 (v2cur, v2p*)."""
    return _gemv(v2, I32, x, packed, s, None, rows)


def v3a(x, packed, s, rows=ROWS):
    """`_k_v3a`: lop3 magic bf16 planes 128 + n, −136 in registers."""
    return _gemv(v3a, MAGIC_SUB, x, packed, s, None, rows)


def v3b(x, packed, s, rows=ROWS):
    """`_k_v3b`: float-domain extraction (floor(b/16)), −8 in registers."""
    return _gemv(v3b, FLOOR, x, packed, s, None, rows)


def v4(x, packed, s, rows=ROWS):
    """`_k_v4`: magic planes 128 + n, no subtract, rank-1 136 · bsum."""
    return _gemv(v4, MAGIC, x, packed, s, None, rows)


def v7(x, packed, s, rows=ROWS):
    """`_k_v7`: the byte against x_lo, hi against bf16(x_hi − 16 x_lo)."""
    return _gemv(v7, BYTE, x, packed, s, None, rows)


def v8(x, packed, s, rows=ROWS):
    """`_k_v8`: mask and shift the whole word (four bytes), then convert."""
    return _gemv(v8, SWAR8, x, packed, s, None, rows)


def v8b(x, packed, s, wdom="u8", rows=ROWS):
    """`_k_v8b`: masks only (hi keeps ×16, scale s/16), in u8 (SWAR), i16
    (prmt into 16-bit lanes) or i32 lanes."""
    return _gemv(v8b, WDOM[wdom], x, packed, s, None, rows)


def v9(x, packed, s, srep, rows=ROWS):
    """`_k_v9`: v8's extraction with pre-expanded scales srep [N, K/2]."""
    return _gemv(v9, SWAR8, x, packed, s, srep, rows)


def v11(x, packed, s, srep, rows=ROWS):
    """`_k_v11`: 32-bit extraction with pre-expanded scales srep [N, K/2]."""
    return _gemv(v11, I32, x, packed, s, srep, rows)


_DIAG_PLAIN = {STREAM: stream_plain, DOT2: dot2_plain, DI8: di8_plain}


def _diag(fn, kind: int, x, packed, s) -> torch.Tensor:
    name = fn.__name__
    if not C.on_cuda(name, x, packed, s):
        return _DIAG_PLAIN[kind](x, packed, s)
    m, k = x.shape
    n = packed.shape[0]
    if not 1 <= m <= 16 or k % 32:
        raise ValueError(f"{name}: takes 1 <= M <= 16, K % 32 == 0 (M {m}, K {k})")
    C.need(name, x, torch.bfloat16, (m, k))
    C.need(name, packed, torch.uint8, (n, k // 2))
    C.need(name, s, torch.bfloat16, (n, k // 32), align=2)
    y = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    lib = _build.load("kbench_q4", _SIGNATURES)
    err = lib.kbench_q4_diag(kind, x.data_ptr(), packed.data_ptr(), s.data_ptr(), y.data_ptr(),
                             m, n, k, C.stream(x))
    _build.check(err, name)
    fn.launches += 1
    return y


def stream(x, packed, s):
    """`_k_stream`: the read roofline of these bytes."""
    return _diag(stream, STREAM, x, packed, s)


def dot2(x, packed, s):
    """`_k_dot2`: two dots on the bytes, one of them scaled; no extraction."""
    return _diag(dot2, DOT2, x, packed, s)


def di8(x, packed, s):
    """`_k_di8`: the int8 ingest probe, a __dp4a GEMV over the bytes as s8."""
    return _diag(di8, DI8, x, packed, s)


WRAPPERS = (v2, v3a, v3b, v4, v7, v8, v8b, v9, v11, stream, dot2, di8)
for _w in WRAPPERS:
    _w.launches = 0

# the Pallas body each wrapper replaces (v2: K1's, already ported as K1)
REPLACES = {
    "v2": "jlama_tpu/ops/pallas_q4.py:113", "v3a": "scripts/kbench_q4.py:46",
    "v3b": "scripts/kbench_q4.py:87", "v4": "scripts/kbench_q4.py:125",
    "v7": "scripts/kbench_q4.py:171", "v8": "scripts/kbench_q4.py:244",
    "v8b": "scripts/kbench_q4.py:348", "v9": "scripts/kbench_q4.py:295",
    "v11": "scripts/kbench_q4.py:404", "dot2": "scripts/kbench_q4.py:456",
    "di8": "scripts/kbench_q4.py:487", "stream": "scripts/kbench_q4.py:538",
}


def i4x_yardstick(x, vals, s) -> torch.Tensor:
    """`i4x` (XLA, no Pallas) in plain torch: int8 values [N, K] (torch has no
    int4) to bf16, times the bf16 block scales, one bf16 matmul. Timed as a
    yardstick only."""
    n, k = vals.shape
    wf = (vals.to(torch.bfloat16).reshape(n, k // 32, 32) * s[..., None]).reshape(n, k)
    return x @ wf.t()


# name -> (wrapper, keyword arguments, scales: "block" or "expanded", rel
# limit against the exact product or None for the diagnostics); the JAX
# bench's names. v2par and v7p differ from v2p512 and v7 at 1024 rows only
# by the TPU grid's semantics, which the card has not: they name the same
# kernel at their width.
VARIANTS = {
    "v2cur": (v2, {}, "block", 2e-2),
    "v2p1k": (v2, {"rows": 1024}, "block", 2e-2),
    "v3a": (v3a, {}, "block", 2e-2),
    "v8": (v8, {}, "block", 2e-2),
    "v8b": (v8b, {}, "block", 2e-2),
    "v8bi16": (v8b, {"wdom": "i16"}, "block", 2e-2),
    "v8bi32": (v8b, {"wdom": "i32"}, "block", 2e-2),
    "v8b1k": (v8b, {"rows": 1024}, "block", 2e-2),
    "v8p1k": (v8, {"rows": 1024}, "block", 2e-2),
    "v9": (v9, {}, "expanded", 2e-2),
    "v11": (v11, {}, "expanded", 2e-2),
    "v11p1k": (v11, {"rows": 1024}, "expanded", 2e-2),
    "v2p2k": (v2, {"rows": 2048}, "block", 2e-2),
    "v2p512": (v2, {"rows": 512}, "block", 2e-2),
    "v2p256": (v2, {"rows": 256}, "block", 2e-2),
    "v2p128": (v2, {"rows": 128}, "block", 2e-2),
    "v3b": (v3b, {}, "block", 2e-2),
    "v4": (v4, {}, "block", 2e-2),
    "v7": (v7, {}, "block", 2e-2),
    "v7p": (v7, {"rows": 1024}, "block", 2e-2),
    "i4x": (i4x_yardstick, {}, "values", 2e-2),
    "dot2": (dot2, {}, "block", None),
    "di8": (di8, {}, "block", None),
    "v2par": (v2, {"rows": 512}, "block", 2e-2),
    "stream": (stream, {}, "block", None),
}
EXACT = ("di8",)  # one integer sum and one float add: equal to the plain version


def _plain_of(wrapper, kw):
    """(key, fn) of the plain version of a variant: the GEMV variants share
    one function (timed once per shape), each diagnostic has its own."""
    if wrapper in (stream, dot2, di8):
        return wrapper.__name__, _DIAG_PLAIN[{stream: STREAM, dot2: DOT2, di8: DI8}[wrapper]]
    pol = {v2: I32, v3a: MAGIC_SUB, v3b: FLOOR, v4: MAGIC, v7: BYTE, v8: SWAR8, v9: SWAR8,
           v11: I32}.get(wrapper)
    if wrapper is v8b:
        pol = WDOM[kw.get("wdom", "u8")]
    return "gemv", lambda x, p, s, srep=None: variant_plain(pol, x, p, s, srep)


def q4_bytes(n: int, k: int) -> int:
    """The JAX bench's measure: packed payload + bf16 block scales."""
    return n * k // 2 + n * k // 32 * 2


def bytes_read(name: str, n: int, k: int, m: int) -> int:
    """The bytes a kernel variant reads and writes: each input once, the
    output once."""
    wrapper, _, scales, _ = VARIANTS[name]
    out = m * n * 2
    if wrapper in (stream, dot2):
        return q4_bytes(n, k) + m * k // 2 * 2 + out
    if wrapper is di8:
        return n * k // 2 + 2 + m * k // 2 * 2 + out
    if scales == "expanded":  # srep [N, K/2] bf16 and the block scales for the rank-1 term
        return n * k // 2 + n * k + n * k // 32 * 2 + m * k * 2 + out
    return q4_bytes(n, k) + m * k * 2 + out


def make_inputs(n: int, k: int, m: int, device, seed: int = 0):
    """(x bf16 [M, K], packed uint8 [N, K/2], scales f32 [N, K/32]) from a
    seed, on `device`: random bytes, scales uniform in [0, 0.02), as the JAX
    bench draws them."""
    g = torch.Generator(device=device).manual_seed(seed + n * k)
    packed = torch.randint(0, 256, (n, k // 2), generator=g, device=device, dtype=torch.uint8)
    scales = torch.rand((n, k // 32), generator=g, device=device) * 0.02
    x = torch.randn((m, k), generator=g, device=device).to(torch.bfloat16)
    return x, packed, scales


def run(names, shapes, m: int, device, seed: int = 0, timer=None) -> list[dict]:
    """One row per (variant, shape) at M = m, and on the card, beside each
    shape, torch.matmul on a bf16 weight, K1 and K5 (rows of kind
    "yardstick"). On the card each kernel is held against its plain version
    (`limit_ratio` <= 1 passes) and timed; on the CPU the wrappers run the
    plain versions and nothing is timed (ms None)."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda and timer is None:
        from ..utils.cuda_timer import Timer
        timer = Timer(dev)
    rows = []
    for n, k in shapes:
        x, packed, scales = make_inputs(n, k, m, dev, seed)
        s16 = scales.to(torch.bfloat16)
        srep = s16.repeat_interleave(16, dim=1)  # JQ4 repeat order: byte b*16+j -> s[b]
        exact = x.float() @ blockq.q4_dequantize(packed, s16.float()).t()
        ex_max = exact.abs().max().item()
        plain_ms = {}
        for name in names:
            wrapper, kw, scale_kind, tol = VARIANTS[name]
            if scale_kind == "values":
                args = (x, blockq.q4_unpack(packed), s16)
            elif scale_kind == "expanded":
                args = (x, packed, s16, srep)
            else:
                args = (x, packed, s16)
            y = wrapper(*args, **kw)
            row = dict(variant=name, body=wrapper.__name__, N=n, K=k, M=m,
                       rows=kw.get("rows", ROWS), ms=None, plain_ms=None,
                       kind="yardstick" if wrapper is i4x_yardstick else "variant")
            if tol is not None:
                rel = (y.float() - exact).abs().max().item() / (ex_max + 1e-9)
                row.update(rel_err_exact=rel, wrong=rel > tol)
            if cuda and wrapper is i4x_yardstick:
                row["ms"] = timer(lambda: wrapper(*args), sleep_cycles=C.SLEEP_CYCLES)
            elif cuda:
                key, pfn = _plain_of(wrapper, kw)
                C.card_row(row, timer, lambda: wrapper(*args, **kw), y, lambda: pfn(*args),
                           plain_ms, key, bytes_read(name, n, k, m), 2.0 * m * n * k, name in EXACT)
                row["gbps_q4"] = q4_bytes(n, k) / row["ms"] / 1e6
            rows.append(row)
            del y
        if cuda:
            rows += _yardsticks(x, packed, scales, n, k, m, timer)
        del exact
    return rows


def _yardsticks(x, packed, scales, n, k, m, timer) -> list[dict]:
    """torch.matmul on a bf16 weight, K1 (f32 scales) and K5 (q4s) at one
    shape: the card's library call and the port's product kernels."""
    from ..nn.qarray import QArray
    from ..ops.q4_matmul import q4_matmul
    from ..ops.w8a8 import q4s_matmul, to_q4s

    q4 = QArray(packed, scales, "q4")
    wd = blockq.q4_dequantize(packed, scales).to(torch.bfloat16)
    calls = {"torch.matmul bf16": lambda: torch.matmul(x, wd.t()),
             "K1 q4_matmul": lambda: q4_matmul(x, q4)}
    if k % 256 == 0:
        q4s = to_q4s(q4)
        calls["K5 q4s_matmul"] = lambda: q4s_matmul(x, q4s)
    return [dict(variant=name, N=n, K=k, M=m, kind="yardstick",
                 ms=timer(fn, sleep_cycles=C.SLEEP_CYCLES)) for name, fn in calls.items()]


def shapes_from_env(default):
    spec = os.environ.get("JLAMA_KBENCH_SHAPES")
    if not spec:
        return default
    return [tuple(int(v) for v in s.split("x")) for s in spec.split(",")]


def print_rows(rows) -> None:
    """One line per shape, as the JAX bench prints them."""
    by_shape: dict = {}
    for r in rows:
        by_shape.setdefault((r["N"], r["K"], r["M"]), []).append(r)
    for (n, k, m), rs in by_shape.items():
        cells = [f"[{n:>7}x{k} M={m}]"]
        for r in rs:
            if r.get("wrong"):
                cells.append(f"{r['variant']}: WRONG({r['rel_err_exact']:.1e})")
            elif r["ms"] is None:
                cells.append(f"{r['variant']} ok")
            elif r["kind"] == "yardstick":
                cells.append(f"{r['variant']} {r['ms'] * 1e3:7.1f}us")
            else:
                cells.append(f"{r['variant']} {r['ms'] * 1e3:7.1f}us {r['gbps_q4']:6.1f}GB/s")
        print("  ".join(cells), flush=True)


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
    shapes = shapes_from_env(SHAPES_1B if dev.type == "cuda" else [(256, 512)])
    rows = run(names, shapes, args.m, dev)
    print_rows(rows)
    return rows


if __name__ == "__main__":
    main()
