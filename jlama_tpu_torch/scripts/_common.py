"""What the card benches share: the limits a kernel is held to against its
plain version, the check itself, argument checks for the wrappers, and the
builds of a kernel source with parts cut out (the ablation scripts)."""

from __future__ import annotations

import ctypes
import subprocess

import torch

from ..ops import _build

# A float variant against its plain version: both round the same products to
# bf16, so they differ only by the f32 sums taken in another order. Each
# element may then round to the neighbouring bf16 value (one ulp: at most
# 2^-7 of it) plus the f32 reorder limit. The rank-1 variants subtract a
# correction up to ~30x the output (136 . bsum . s for v4), so the f32 limit
# is taken against max|plain| at 2e-4 and not at K1's 1e-5.
BF16_REL = 2.0 ** -7
F32_REORDER = 2e-4


def limit_ratio(got: torch.Tensor, plain: torch.Tensor, exact: bool) -> tuple[float, float]:
    """(max |got - plain|, worst |got - plain| over its limit): a ratio <= 1
    passes. `exact`: one integer sum and at most one float operation, so the
    two must be equal (ratio 0, or inf)."""
    g, p = got.float(), plain.float()
    d = (g - p).abs()
    err = d.max().item() if d.numel() else 0.0
    if exact:
        return err, 0.0 if torch.equal(g, p) else float("inf")
    lim = BF16_REL * p.abs() + F32_REORDER * p.abs().max()
    ratio = (d / lim.clamp_min(torch.finfo(torch.float32).tiny)).max().item() if d.numel() else 0.0
    return err, ratio


def on_cuda(name: str, *tensors: torch.Tensor) -> bool:
    """False when every tensor lies on the CPU (the plain version runs);
    True when all lie on one CUDA device (the kernel launches); raises on
    anything else."""
    devs = {t.device for t in tensors}
    if devs == {torch.device("cpu")}:
        return False
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"{name}: unsupported device(s) {sorted(map(str, devs))}")
    return True


def need(name: str, t: torch.Tensor, dtype, shape: tuple, align: int = 16) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name}: expected contiguous {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: tensor must be {align}-byte aligned")


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ~10 ms at H100 clocks: outlasts the host's enqueue of a bench wrapper's 10
# timed launches (the Timer's default, 50 ms, is sized for a decode step)
SLEEP_CYCLES = 20_000_000


def card_row(row: dict, timer, call, got: torch.Tensor, plain, plain_ms: dict, key: str,
             nbytes: float, ops: float, exact: bool, ops_per_s: float | None = None) -> dict:
    """On the card: hold `got` (the output of `call()`) against `plain()` on
    the same inputs, time both (the plain version once per `key`, kept in
    `plain_ms`), and add the bound for `nbytes` and `ops` to `row`."""
    from ..utils.cuda_timer import BF16_OPS_PER_S, bound

    ref = plain()
    row["max_abs_err"], row["limit_ratio"] = limit_ratio(got, ref, exact)
    del ref
    if key not in plain_ms:
        plain_ms[key] = timer(plain, sleep_cycles=SLEEP_CYCLES)
    row["plain_ms"] = plain_ms[key]
    row["ms"] = timer(call, sleep_cycles=SLEEP_CYCLES)
    row["bytes"] = nbytes
    row["bound_ms"], row["bound_by"] = bound(nbytes, ops, ops_per_s or BF16_OPS_PER_S)
    row["bound_share"] = row["bound_ms"] / row["ms"]
    return row


def build_cut_copies(name: str, cuts: dict[str, list[tuple[str, str]]],
                     signatures: dict[str, list], src: str | None = None,
                     tag: str = "") -> dict[str, ctypes.CDLL]:
    """For each entry of `cuts`, a copy of `csrc/<name>.cu` (or of the source
    text `src`) with its (old, new) text replacements, compiled in parallel
    with nvcc into `_build/ablate_<name><tag>/` and loaded with `signatures`.
    Raises when a cut no longer finds its text in the source, or when nvcc
    fails."""
    if src is None:
        src = (_build.CSRC / f"{name}.cu").read_text()
    out = _build.BUILD_DIR / f"ablate_{name}{tag}"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for cut, subs in cuts.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{cut} no longer applies to csrc/{name}.cu")
            text = text.replace(old, new)
        (out / f"{cut}.cu").write_text(text)
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out / f"lib{cut}.so"),
               str(out / f"{cut}.cu")]
        procs[cut] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)
    libs = {}
    for cut, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {cut} of csrc/{name}.cu:\n{log}")
        lib = ctypes.CDLL(str(out / f"lib{cut}.so"))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[cut] = lib
    return libs
