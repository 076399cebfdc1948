"""P2 (jlama_tpu_torch.scripts.kbench_w8a8): each kernel's plain version held
against the JAX bench's Pallas kernel (scripts/kbench_w8a8.py) in interpret
mode, and each XLA yardstick's torch form against the JAX one, on the same
numpy inputs, at N = 256, K = 512, M = 1 and 3.

The JAX side runs in a subprocess (its bench module turns on a persistent
compilation cache when imported, which must not leak into the other tests),
with XLA_FLAGS=--xla_allow_excess_precision=false so that bf16 values are
rounded where the kernels' types say, as on the TPU. Limits: di8b is one
exact integer sum and one float multiply, so equal; the others take exact
int32 (or exact bf16-product) dots and an f32 combine over the blocks or
groups that may run in another order, so one bf16 ulp of max|ref| (at most
2^-7 of it).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from jlama_tpu_torch.scripts import kbench_w8a8 as kw

ROOT = Path(__file__).resolve().parent.parent
N, K = 256, 512
MS = (1, 3)
BF16_ULP = 2.0 ** -7

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
import kbench_w8a8 as jw
from jlama_tpu.quant.blockq import q8_quantize

d = np.load(sys.argv[1])
packed, scales, sg = d["packed"], d["scales"], d["sg"]
n, kh = packed.shape
p3, s2 = jw._prep_pb8(packed, scales)
w8, s8 = jw._prep_di8b(packed, scales)
pk3 = jnp.asarray(packed.reshape(n, kh // 128, 128).transpose(1, 0, 2))
sg3 = jnp.asarray(sg[:, :, None])
out = {}
with pltpu.force_tpu_interpret_mode():
    for m in (1, 3):
        x = jnp.asarray(d[f"x{m}"], jnp.bfloat16)
        xq, xs = q8_quantize(x)
        out[f"xq_{m}"], out[f"xs_{m}"] = np.asarray(xq), np.asarray(xs)
        runs = {
            "pb8": lambda: jw.pb8(x, p3, s2),
            "pgb8": lambda: jw.pgb(x, p3, s2, dom="i8"),
            "pgbf": lambda: jw.pgb(x, p3, s2, dom="bf16"),
            "di8b": lambda: jw.di8b(x, w8, s8),
            "pk4": lambda: jw.pk4(x, pk3, sg3),
            "xb8": lambda: jw.xb8(x, *jw._prep_xb8(packed, scales)),
            "xb4": lambda: jw.xb4(x, *jw._prep_xb4(packed, scales)),
            "xb4f": lambda: jw.xb4f(x, *jw._prep_xb4f(packed, scales)),
            "xb4K": lambda: jw.xb4K(x, *jw._prep_xb4K(packed, scales)),
        }
        for name, fn in runs.items():
            out[f"{name}_{m}"] = np.asarray(fn()).astype(np.float32)
        out[f"ref_pk4_{m}"] = np.asarray(jw.ref_pk4(x, pk3, sg3)).astype(np.float64)
        out[f"ref_w8a8_{m}"] = jw.ref_w8a8(np.asarray(xq), np.asarray(xs),
                                           jw.q4_unpack_np(packed), scales)
np.savez(sys.argv[2], **out)
"""


def _inputs():
    rng = np.random.default_rng(6)
    d = {"packed": rng.integers(0, 256, (N, K // 2), dtype=np.uint8),
         "scales": (rng.uniform(size=(N, K // 32)) * 0.02 + 0.001).astype(np.float32),
         # pk4's group scales, as _prep_pk4 draws them ([ngrp, N])
         "sg": np.random.default_rng(1).uniform(0, 0.02, (K // 256, N, 1))[:, :, 0]
         .astype(np.float32)}
    for m in MS:
        d[f"x{m}"] = rng.standard_normal((m, K)).astype(np.float32)
    return d


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("kbench_w8a8")
    np.savez(tmp / "in.npz", **_inputs())
    env = dict(os.environ, JAX_PLATFORMS="cpu", HOME=str(tmp),
               XLA_FLAGS="--xla_allow_excess_precision=false")
    r = subprocess.run([sys.executable, "-c", JAX_SIDE, str(tmp / "in.npz"),
                        str(tmp / "out.npz"), str(ROOT)], env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return dict(np.load(tmp / "out.npz"))


def _port(name, d, m, jax_out):
    """The port's function on the same inputs; the kernels take the JAX
    side's int8 activations, equal to the port's (test_activation_codes_within_one_of_jax)."""
    from jlama_tpu_torch.quant.blockq import q4_unpack

    x = torch.from_numpy(d[f"x{m}"]).to(torch.bfloat16)
    xq = torch.from_numpy(jax_out[f"xq_{m}"])
    xs = torch.from_numpy(jax_out[f"xs_{m}"])
    packed = torch.from_numpy(d["packed"])
    scales = torch.from_numpy(d["scales"])
    n, nb = packed.shape[0], K // 32
    if name == "pb8":
        return kw.pb8(x, packed, scales, xq=(xq, xs))
    if name == "pgb8":
        return kw.pgb(x, packed, scales, dom="i8", xq=(xq, xs))
    if name == "pgbf":
        return kw.pgb(x, packed, scales, dom="bf16")
    if name == "di8b":
        return kw.di8b(x, q4_unpack(packed), scales, xq=xq)
    if name == "pk4":
        return kw.pk4(x, packed, torch.from_numpy(d["sg"]), xq=xq)
    if name == "xb8":
        return kw.xb8(x, q4_unpack(packed).reshape(n, nb, 32).permute(1, 2, 0), scales.t())
    if name == "xb4":
        return kw.xb4(x, packed.reshape(n, nb, 16).permute(1, 2, 0), scales.t())
    if name == "xb4f":
        return kw.xb4f(x, packed, scales)
    return kw.xb4K(x, q4_unpack(packed), scales)


def test_activation_codes_within_one_of_jax(jax_out):
    """The port's q8_quantize against the JAX package's on the bench's
    inputs: codes and scales equal (both divide 127 / amax and amax / 127
    correctly rounded)."""
    from jlama_tpu_torch.quant.blockq import q8_quantize

    d = _inputs()
    for m in MS:
        xq, xs = q8_quantize(torch.from_numpy(d[f"x{m}"]).to(torch.bfloat16))
        np.testing.assert_array_equal(xq.numpy(), jax_out[f"xq_{m}"])
        np.testing.assert_array_equal(xs.numpy(), jax_out[f"xs_{m}"])


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("name", ["pb8", "pgb8", "pgbf", "di8b", "pk4",
                                  "xb8", "xb4", "xb4f", "xb4K"])
def test_variant_matches_jax(jax_out, name, m):
    d = _inputs()
    before = [w.launches for w in kw.WRAPPERS]
    got = _port(name, d, m, jax_out).float().numpy()
    ref = jax_out[f"{name}_{m}"]
    assert got.shape == ref.shape == (m, N)
    if name == "di8b":
        np.testing.assert_array_equal(got, ref)
    else:
        assert np.abs(got - ref).max() <= BF16_ULP * np.abs(ref).max(), name
    assert [w.launches for w in kw.WRAPPERS] == before


@pytest.mark.parametrize("m", MS)
def test_exact_references_match_jax(jax_out, m):
    """The port's f64 references (`exact_w8a8`, pk4's group dots) against the
    JAX bench's `ref_w8a8` and `ref_pk4`."""
    d = _inputs()
    xq, xs = torch.from_numpy(jax_out[f"xq_{m}"]), torch.from_numpy(jax_out[f"xs_{m}"])
    packed = torch.from_numpy(d["packed"])
    ref = jax_out[f"ref_w8a8_{m}"]
    got = kw.exact_w8a8(xq, xs, packed, torch.from_numpy(d["scales"])).numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    sg = torch.from_numpy(d["sg"]).double()
    got = (kw._group_dots(xq, packed) * sg.t()[None]).sum(dim=-1).numpy()
    np.testing.assert_allclose(got, jax_out[f"ref_pk4_{m}"], rtol=1e-12, atol=1e-12)


def test_main_on_cpu_counts_no_launch(monkeypatch, capsys):
    monkeypatch.setenv("JLAMA_KBENCH_SHAPES", "64x512")
    before = [w.launches for w in kw.WRAPPERS]
    rows = kw.main(["--device", "cpu", "--m", "3"])
    assert [w.launches for w in kw.WRAPPERS] == before
    # the yardsticks and q4s are card-only rows
    assert [r["variant"] for r in rows] == ["pb8", "pgb8", "pgbf", "di8b", "pk4"]
    assert not any(r.get("wrong") for r in rows) and all(r["ms"] is None for r in rows)
    assert "[     64x512 M=3]" in capsys.readouterr().out
