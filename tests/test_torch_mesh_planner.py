"""The port's mesh planner (parallel/mesh.py): the eight cases of
tests/test_mesh_planner.py, its answers against jlama_tpu's planner over a
grid of inputs, and the tp shard plan leaf by leaf against the local blocks
of jlama_tpu's specs."""

import itertools

import jax
import numpy as np
import pytest
import torch

from jlama_tpu.config import ModelConfig as JModelConfig
from jlama_tpu.models import base as jbase
from jlama_tpu.nn.qarray import QArray as JQArray
from jlama_tpu.parallel import mesh as jmesh
from jlama_tpu_torch.config import ModelConfig
from jlama_tpu_torch.models import base as tbase
from jlama_tpu_torch.parallel import mesh as tmesh
from jlama_tpu_torch.parallel.mesh import plan_mesh_axes
from tests.test_torch_tp_forward import TP, make_model

GB = 1 << 30


def cfg(n_heads=32, n_kv=8, layers=32, vocab=128256, config=ModelConfig):
    return config(model_type="llama", n_layers=layers, n_heads=n_heads, n_kv_heads=n_kv,
                  embedding_length=4096, hidden_length=14336, vocab_size=vocab,
                  context_length=8192, head_size=128)


def test_single_device():
    assert plan_mesh_axes(1, cfg()) == (1, 1, 1)


def test_tp_maximized_within_kv_heads():
    # 16 devices, 8 kv heads -> tp=8, dp absorbs the rest
    assert plan_mesh_axes(16, cfg(n_kv=8)) == (2, 1, 8)


def test_tp_capped_by_device_count():
    assert plan_mesh_axes(4, cfg(n_kv=8)) == (1, 1, 4)


def test_odd_device_count():
    # 6 devices: tp=2 (6 % 4 != 0), dp=3
    assert plan_mesh_axes(6, cfg(n_kv=8)) == (3, 1, 2)


def test_prime_device_count():
    assert plan_mesh_axes(7, cfg(n_kv=8)) == (7, 1, 1)


def test_memory_forces_pp():
    # 70B-class: 8 kv heads caps tp at 8; 140 GB of weights needs >8 shards
    dp, pp, tp = plan_mesh_axes(16, cfg(n_kv=8, layers=80), weight_bytes=140 * GB,
                                hbm_bytes_per_device=16 * GB)
    assert (dp, pp, tp) == (1, 2, 8)  # 80 layers % 2 == 0, 16 shards fit 140 GB


def test_does_not_fit_raises():
    with pytest.raises(MemoryError):
        plan_mesh_axes(2, cfg(n_kv=8), weight_bytes=200 * GB, hbm_bytes_per_device=16 * GB)


def test_fits_without_pp_stays_dp():
    # 8B q4 (~4.2 GB) on 8 devices: no pp needed
    assert plan_mesh_axes(8, cfg(n_kv=8), weight_bytes=4 * GB,
                          hbm_bytes_per_device=16 * GB) == (1, 1, 8)


GRID = list(itertools.product([1, 2, 3, 4, 6, 8, 16], [(32, 8), (4, 2), (12, 4)],
                              [128256, 50257], [None, 40 * GB, 150 * GB]))


@pytest.mark.parametrize("n,heads,vocab,wbytes", GRID)
def test_plan_equals_jax(n, heads, vocab, wbytes):
    """The same (dp, pp, tp) as jlama_tpu's planner, or the same MemoryError,
    at an H100's 80 GB (the port's default) and a v5e's 16 GB."""
    for hbm in (80 * GB, 16 * GB):
        args = dict(weight_bytes=wbytes, hbm_bytes_per_device=hbm)
        try:
            want = jmesh.plan_mesh_axes(n, cfg(*heads, vocab=vocab, config=JModelConfig), **args)
        except MemoryError:
            with pytest.raises(MemoryError):
                plan_mesh_axes(n, cfg(*heads, vocab=vocab), **args)
            continue
        assert plan_mesh_axes(n, cfg(*heads, vocab=vocab), **args) == want
    mesh = tmesh.plan_mesh(cfg(*heads, vocab=vocab), n) if wbytes is None else None
    if mesh is not None:
        assert mesh.dp * mesh.pp * mesh.tp == n and mesh.shape["tp"] == mesh.tp


def test_make_mesh():
    assert tmesh.make_mesh(4, dp=2) == tmesh.Mesh(2, 1, 2)
    with pytest.raises(ValueError, match="device count"):
        tmesh.make_mesh(4, dp=3, tp=1)
def _jax_rank_block(arr, rank):
    for shard in arr.addressable_shards:
        if shard.device == jax.devices()[rank]:
            return np.asarray(shard.data)
    raise AssertionError("no shard on that device")


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("arch,quantize", [("llama", "q4"), ("qwen2", None), ("gemma2", None)])
def test_shard_params_matches_jax_pspecs(arch, quantize):
    """Each rank's slice of every leaf is the local block that
    jlama_tpu.parallel.mesh's specs give on a tp = 2 mesh of the virtual
    CPU devices, leaf by leaf and exactly (the port's own interleaved fuse
    on one side, jlama_tpu's on the other)."""
    jparams, jcfg, tparams, tcfg = make_model(arch, quantize)
    mesh = jmesh.make_mesh(jax.devices()[:TP], dp=1, pp=1, tp=TP)
    jsharded = jmesh.shard_params(jbase.fuse_params(jparams, tp=TP), jcfg, mesh)
    fused = tbase.fuse_params(tparams, tp=TP)
    for rank in range(TP):
        local = tmesh.shard_params(fused, tcfg, TP, rank)
        assert local.keys() == jsharded.keys()
        for k, v in jsharded.items():
            if k == "layers":
                continue
            t = local[k]
            if isinstance(v, JQArray):
                np.testing.assert_array_equal(_np(t.data), _jax_rank_block(v.data, rank))
            else:
                np.testing.assert_array_equal(_np(t), _jax_rank_block(v, rank), err_msg=k)
        for k, v in jsharded["layers"].items():
            pairs = [(v.data, "data"), (v.scales, "scales")] if isinstance(v, JQArray) \
                else [(v, None)]
            for arr, part in pairs:
                block = _jax_rank_block(arr, rank)
                for l, lay in enumerate(local["layers"]):
                    t = getattr(lay[k], part) if part else lay[k]
                    np.testing.assert_array_equal(_np(t), block[l], err_msg=f"{k} {part} {l}")


