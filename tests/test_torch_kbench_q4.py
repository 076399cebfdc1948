"""P1 (jlama_tpu_torch.scripts.kbench_q4): each variant's plain version held
against the JAX bench's Pallas kernel (scripts/kbench_q4.py) in interpret
mode, on the same numpy inputs, at N = 256, K = 512, M = 1 and 3.

The JAX side runs in a subprocess with XLA_FLAGS=--xla_allow_excess_precision=false.
With XLA's default, the CPU backend keeps the bf16 product `plane * srep`
in f32 inside the interpreted kernel, which the TPU (and the port) round to
bf16 before the dot; with the flag every bf16 value is rounded where the
kernel's types say, so the interpreted kernel computes the TPU's function.
The port's plain versions round at the same places, so the limit is one bf16
ulp of max|ref| (the bf16 outputs of two f32 sums taken in another order may
round to neighbouring values); di8 is one integer sum and one float add, and
must be equal.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from jlama_tpu_torch.scripts import kbench_q4 as pk

ROOT = Path(__file__).resolve().parent.parent
N, K = 256, 512
MS = (1, 3)
BF16_ULP = 2.0 ** -7  # one bf16 ulp is at most 2^-7 of the value

JAX_SIDE = r"""
import sys
import numpy as np
root = sys.argv[3]
sys.path.insert(0, root + "/scripts")
sys.path.insert(0, root)
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
import kbench_q4 as jk
from jlama_tpu.ops.pallas_q4 import kernel_column_perm

d = np.load(sys.argv[1])
packed, scales = d["packed"], d["scales"]
k = packed.shape[1] * 2
pk = jnp.asarray(packed[:, kernel_column_perm(k)])  # the q4k kernel layout
raw, sj = jnp.asarray(packed), jnp.asarray(scales)
out = {}
with pltpu.force_tpu_interpret_mode():
    for m in (1, 3):
        x = jnp.asarray(d[f"x{m}"], jnp.bfloat16)
        runs = {
            "v2cur": lambda: jk.VARIANTS["v2cur"][1](x, pk, sj),
            "v3a": lambda: jk.v3a(x, pk, sj), "v3b": lambda: jk.v3b(x, pk, sj),
            "v4": lambda: jk.v4(x, pk, sj), "v7": lambda: jk.v7(x, pk, sj),
            "v8": lambda: jk.v8(x, pk, sj), "v8b": lambda: jk.v8b(x, pk, sj),
            "v8bi16": lambda: jk.v8b(x, pk, sj, wdom="i16"),
            "v8bi32": lambda: jk.v8b(x, pk, sj, wdom="i32"),
            # the body _k_v9 fed _prep_v11's tile-expanded scales (q4k order)
            "v9": lambda: jk.v9(x, *jk._prep_v11(pk, sj)),
            "v11": lambda: jk.v11(x, *jk._prep_v11(pk, sj)),
            # the diagnostics take the raw bytes as they are
            "dot2": lambda: jk.dot2(x, raw, sj), "di8": lambda: jk.di8(x, raw, sj),
            # one row per grid step: the kernel's sum of the tile's scales is
            # then the row's own
            "stream": lambda: jk.stream(x, raw, sj, block_n=1),
            # i4x fed canonical bytes, as its prep expects
            "i4x": lambda: jk.i4x(x, *jk._prep_i4(raw, sj)),
            # the faults of the reference, as the bench runs them
            "fault_v9_prep": lambda: jk.v9(x, *jk._prep_v9(pk, sj)),
            "fault_i4x_prep": lambda: jk.i4x(x, *jk._prep_i4(pk, sj)),
        }
        for name, fn in runs.items():
            out[f"{name}_{m}"] = np.asarray(fn()).astype(np.float32)
np.savez(sys.argv[2], **out)
"""


def _inputs():
    rng = np.random.default_rng(4)
    d = {"packed": rng.integers(0, 256, (N, K // 2), dtype=np.uint8),
         "scales": (rng.uniform(size=(N, K // 32)) * 0.02).astype(np.float32)}
    for m in MS:
        d[f"x{m}"] = rng.standard_normal((m, K)).astype(np.float32)
    return d


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("kbench_q4")
    np.savez(tmp / "in.npz", **_inputs())
    env = dict(os.environ, JAX_PLATFORMS="cpu", HOME=str(tmp),
               XLA_FLAGS="--xla_allow_excess_precision=false")
    r = subprocess.run([sys.executable, "-c", JAX_SIDE, str(tmp / "in.npz"),
                        str(tmp / "out.npz"), str(ROOT)], env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return dict(np.load(tmp / "out.npz"))


def _port_args(d, m):
    x = torch.from_numpy(d[f"x{m}"]).to(torch.bfloat16)
    packed = torch.from_numpy(d["packed"])
    s16 = torch.from_numpy(d["scales"]).to(torch.bfloat16)
    return x, packed, s16


def _port(name, d, m):
    x, packed, s16 = _port_args(d, m)
    wrapper, kw, scales, _ = pk.VARIANTS[name]
    if scales == "expanded":
        return wrapper(x, packed, s16, s16.repeat_interleave(16, dim=1), **kw)
    if scales == "values":
        from jlama_tpu_torch.quant.blockq import q4_unpack
        return wrapper(x, q4_unpack(packed), s16, **kw)
    return wrapper(x, packed, s16, **kw)


def _exact(d, m):
    """x · deq(W)ᵀ in f64 with the bf16 scales: the bench's exact reference."""
    x, packed, s16 = _port_args(d, m)
    from jlama_tpu_torch.quant.blockq import q4_dequantize
    w = q4_dequantize(packed, s16.float()).double()
    return (x.double() @ w.t()).numpy()


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("name", ["v2cur", "v3a", "v3b", "v4", "v7", "v8", "v8b", "v8bi16",
                                  "v8bi32", "v9", "v11", "dot2", "di8", "stream", "i4x"])
def test_variant_matches_jax_kernel(jax_out, name, m):
    d = _inputs()
    before = [w.launches for w in pk.WRAPPERS]
    got = _port(name, d, m).float().numpy()
    ref = jax_out[f"{name}_{m}"]
    assert got.shape == ref.shape == (m, N)
    if name == "di8":
        np.testing.assert_array_equal(got, ref)
    else:
        assert np.abs(got - ref).max() <= BF16_ULP * np.abs(ref).max(), name
    assert [w.launches for w in pk.WRAPPERS] == before  # the CPU runs the plain versions


@pytest.mark.parametrize("fault,limit", [("fault_v9_prep", 1.0), ("fault_i4x_prep", 1.0),
                                         ("v7", 2e-2), ("v4", 2e-2)])
def test_reference_faults_documented(jax_out, fault, limit):
    """Faults of the JAX bench, not of the port; a change of the reference
    shows here. v9's prep repeats the scales where the q4k column order needs
    them tiled (column c takes s[c // 16]; rel error 1.1-1.3); i4x's prep
    unpacks kernel-layout bytes as canonical ones (1.3-1.4); v7 rounds
    x_hi - 16 x_lo to bf16, and v4 rounds (128 + n) . s to bf16 before
    subtracting 136 . bsum, so both miss the bench's own 2e-2 limit against
    the exact product (4e-2 to 8e-2). Run with -s to see the errors."""
    d = _inputs()
    for m in MS:
        exact = _exact(d, m)
        rel = np.abs(jax_out[f"{fault}_{m}"] - exact).max() / np.abs(exact).max()
        print(f"{fault} M={m}: rel error against the exact product {rel:.3g}")
        assert rel > limit, (fault, m, rel)
    # the port's v9 and v11 take scales in the JQ4 repeat order and are right
    for name in ("v9", "v11", "v2cur"):
        exact = _exact(d, 1)
        got = _port(name, d, 1).double().numpy()
        assert np.abs(got - exact).max() / np.abs(exact).max() < 2e-2


def test_main_on_cpu_counts_no_launch(monkeypatch, capsys):
    monkeypatch.setenv("JLAMA_KBENCH_SHAPES", "64x256,32x1024")
    before = [w.launches for w in pk.WRAPPERS]
    rows = pk.main(["--device", "cpu", "v8", "v7", "di8", "v11p1k", "--m", "3"])
    assert [w.launches for w in pk.WRAPPERS] == before
    assert len(rows) == 8 and all(r["ms"] is None for r in rows)
    assert {(r["N"], r["K"], r["M"]) for r in rows} == {(64, 256, 3), (32, 1024, 3)}
    assert not any(r.get("wrong") for r in rows if r["variant"] in ("v8", "v11p1k"))
    out = capsys.readouterr().out
    assert "[     64x256 M=3]" in out and "v8 ok" in out


def test_bytes_and_variants():
    assert pk.q4_bytes(8192, 2048) == 8192 * 1024 + 8192 * 64 * 2
    # pre-expanded scales read n . k bytes beside the payload: twice the payload
    assert pk.bytes_read("v9", 8192, 2048, 1) - pk.bytes_read("v8", 8192, 2048, 1) == 8192 * 2048
    assert set(pk.REPLACES) == {w.__name__ for w in pk.WRAPPERS}
