"""P3 (jlama_tpu_torch.scripts.probe_int4 and probe_sigma_i16): each probe
kernel's plain version held against the JAX probe's Pallas kernel in
interpret mode on the same inputs: probe_int4 at N = K = 512 (its module
globals N, K, NB set so), M = 8, with scales that are not constant (the
probe's 0.01 everywhere would hide the order of the tiled scales);
probe_sigma_i16 at its own N = 256, K = 512, M = 1.

The JAX probes build their kernels inside closures, so a subprocess runs them
with `probe_int4.bench` (which gets the inputs and returns the output) and
`probe_sigma_i16.run` patched to keep what they compute, and with
XLA_FLAGS=--xla_allow_excess_precision=false, so that the bf16 product of
nibble and scale is rounded as on the TPU. Limits: the u4 probes sum bf16
products in f32 and round the output to bf16, so one bf16 ulp of max|ref|
(at most 2^-7 of it); the σ probes sum integers below 2^24, so equal.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from jlama_tpu_torch.scripts import probe_int4 as pi
from jlama_tpu_torch.scripts import probe_sigma_i16 as ps

ROOT = Path(__file__).resolve().parent.parent
BF16_ULP = 2.0 ** -7

JAX_SIDE = r"""
import sys, types
import numpy as np
root = sys.argv[2]
sys.path.insert(0, root + "/scripts")
sys.path.insert(0, root)
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu
import probe_int4 as p4
import probe_sigma_i16 as p16

out = {}
p4.N, p4.K, p4.NB = 512, 512, 16
scales = (np.random.default_rng(3).uniform(0.5, 1.5, (512, 16)) * 0.01).astype(np.float32)
# the probes' scales: not the constant 0.01, so that their order shows
shim = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp) if not k.startswith("__")})
shim.full = lambda shape, value, dtype: jnp.asarray(scales, dtype)
p4.jnp = shim
for name in ("pallas", "bitcast"):
    def bench(fn, *args, iters=20, name=name):
        res = fn(*args)
        out[f"{name}_x"] = np.asarray(args[0]).astype(np.float32)
        out[f"{name}_w"] = np.asarray(args[1]).astype(np.uint8)
        out[f"{name}_s"] = np.asarray(args[2]).astype(np.float32)
        out[f"{name}_y"] = np.asarray(res).astype(np.float32)
        return res, 1.0
    p4.bench = bench
    with pltpu.force_tpu_interpret_mode():
        getattr(p4, "probe_" + name)()

def run(name, kernel, *args, check=None):
    res = pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((1, p16.N), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM) for _ in args],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM))(*args)
    out["sigma_w"], out["sigma_s"], out["sigma_x"] = (np.asarray(a) for a in args)
    out[name] = np.asarray(res)
p16.run = run
with pltpu.force_tpu_interpret_mode():
    p16.main()
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("probes")
    env = dict(os.environ, JAX_PLATFORMS="cpu", HOME=str(tmp),
               XLA_FLAGS="--xla_allow_excess_precision=false")
    r = subprocess.run([sys.executable, "-c", JAX_SIDE, str(tmp / "out.npz"), str(ROOT)],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return dict(np.load(tmp / "out.npz"))


def _u4_args(jax_out, name):
    x = torch.from_numpy(jax_out[f"{name}_x"]).to(torch.bfloat16)
    w = torch.from_numpy(jax_out[f"{name}_w"])
    s = torch.from_numpy(jax_out[f"{name}_s"]).to(torch.bfloat16)
    # "pallas" hands the kernel uint4 [N, K]; "bitcast" the bytes [N, K/2]
    packed = pi.pack_u4(w) if name == "pallas" else w
    return x, packed, s


@pytest.mark.parametrize("name", ["pallas", "bitcast"])
def test_u4_probe_matches_jax(jax_out, name):
    x, packed, s = _u4_args(jax_out, name)
    assert x.shape == (8, 512) and packed.shape == (512, 256) and s.shape == (512, 16)
    before = [w.launches for w in pi.WRAPPERS]
    got = pi.PROBES[name](x, packed, s).float().numpy()
    ref = jax_out[f"{name}_y"]
    assert np.abs(got - ref).max() <= BF16_ULP * np.abs(ref).max()
    assert [w.launches for w in pi.WRAPPERS] == before


def test_u4_orders_read_off_the_jax_run(jax_out):
    """What the port assumes, held against the interpreted kernels: the
    bitcast u8 -> 2 x u4 puts the low nibble first (element 2i of byte i),
    and the tiled scales give column c the scale s[c mod NB], not s[c // 32]
    (the non-constant scales tell them apart by far more than the limit)."""
    x, packed, s = _u4_args(jax_out, "bitcast")
    ref = jax_out["bitcast_y"]
    lim = BF16_ULP * np.abs(ref).max()
    swapped = (packed >> 4) | ((packed & 0x0F) << 4)
    assert np.abs(pi.u4_plain(x, swapped, s).float().numpy() - ref).max() > 10 * lim
    n, kh = packed.shape
    block = s.repeat_interleave(32, dim=1)  # s[c // 32] ...
    nib = torch.stack([packed & 0x0F, packed >> 4], dim=-1).reshape(n, 2 * kh)
    wrong = x.float() @ (nib.to(torch.bfloat16) * block[:, : 2 * kh]).float().t()
    assert np.abs(wrong.numpy() - ref).max() > 10 * lim


@pytest.mark.parametrize("name", list(ps.PROBES))
def test_sigma_probe_matches_jax(jax_out, name):
    w = torch.from_numpy(jax_out["sigma_w"])
    sigma = torch.from_numpy(jax_out["sigma_s"])
    x = torch.from_numpy(jax_out["sigma_x"])
    assert (x.shape, w.shape, sigma.shape) == ((1, 512), (256, 512), (256, 512))
    before = [f.launches for f in ps.WRAPPERS]
    got = ps.PROBES[name](x, w, sigma).numpy()
    np.testing.assert_array_equal(got, jax_out[name])
    assert [f.launches for f in ps.WRAPPERS] == before


def test_probe_mains_on_cpu_count_no_launch(capsys):
    before = [f.launches for f in pi.WRAPPERS + ps.WRAPPERS]
    rows = pi.main(["--device", "cpu"]) + ps.main(["--device", "cpu", "--m", "3"])
    assert [f.launches for f in pi.WRAPPERS + ps.WRAPPERS] == before
    assert [r["variant"] for r in rows] == ["xla", "pallas", "bitcast", *ps.PROBES]
    assert all(r["ms"] is None for r in rows)
    assert all(r["finite"] for r in rows[1:3]) and all(r["equal"] for r in rows[3:])
    assert "OK exact" in capsys.readouterr().out
