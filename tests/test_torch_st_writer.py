"""The port's safetensors writer and splitter (`jlama_tpu_torch/st/writer.py`,
`splitter.py`) against jlama_tpu's: the same tensors and metadata give the
same bytes (header order, padding, offsets), each package reads the other's
files, and a split checkpoint's index reads in both."""

import filecmp

import ml_dtypes
import numpy as np
import pytest

from jlama_tpu.quant import blockq as jblockq
from jlama_tpu.st import SafeTensorIndex as JIndex
from jlama_tpu.st import SafeTensorWriter as JWriter
from jlama_tpu.st.splitter import split_safetensors as jsplit
from jlama_tpu_torch.quant import blockq
from jlama_tpu_torch.st import SafeTensorIndex, SafeTensorWriter
from jlama_tpu_torch.st.splitter import split_safetensors


def _tensors(seed):
    rng = np.random.default_rng(seed)
    t = {
        "f32": rng.standard_normal((8, 64)).astype(np.float32),
        "f16": rng.standard_normal((3, 5)).astype(np.float16),
        "i32": rng.integers(-9, 9, (7,)).astype(np.int32),
        "i64": rng.integers(-9, 9, (2, 3)).astype(np.int64),
        "u8": rng.integers(0, 255, (5,)).astype(np.uint8),
        "flag": np.array([True, False, True]),
        "bf16": rng.standard_normal((4, 32)).astype(np.float32),
    }
    q = rng.standard_normal((6, 96)).astype(np.float32)
    return t, q


def _write_both(tmp_path, seed, metadata):
    t, q = _tensors(seed)
    jw, tw = JWriter(metadata), SafeTensorWriter(metadata)
    for name, a in t.items():
        if name == "bf16":
            jw.add(name, a.astype(ml_dtypes.bfloat16))
            tw.add_raw(name, "BF16", a.shape, a.astype(ml_dtypes.bfloat16).view(np.uint16))
        else:
            jw.add(name, a)
            tw.add(name, a)
    jw.add_q4("q4", *jblockq.q4_quantize_np(q))
    tw.add_q4("q4", *blockq.q4_quantize_np(q))
    jw.add_i8("i8", *jblockq.q8_quantize_np(q))
    tw.add_i8("i8", *blockq.q8_quantize_np(q))
    jw.write(tmp_path / "j.safetensors")
    tw.write(tmp_path / "t.safetensors")
    return t, q


@pytest.mark.parametrize("seed,metadata", [(0, None), (1, {"format": "pt"}),
                                           (2, {"format": "pt", "quantized_by": "jlama-tpu"})])
def test_writer_bytes_equal_jax(tmp_path, seed, metadata):
    _write_both(tmp_path, seed, metadata)
    assert filecmp.cmp(tmp_path / "j.safetensors", tmp_path / "t.safetensors", shallow=False)
    assert not list(tmp_path.glob("*.tmp"))


def test_each_package_reads_the_others_file(tmp_path):
    t, q = _write_both(tmp_path, 3, {"format": "pt"})
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    (tmp_path / "j.safetensors").rename(tmp_path / "a" / "model.safetensors")
    (tmp_path / "t.safetensors").rename(tmp_path / "b" / "model.safetensors")
    port, jax_ = SafeTensorIndex(tmp_path / "a"), JIndex(tmp_path / "b")
    for name, a in t.items():
        got_port, got_jax = port.load(name), jax_.load(name)
        if name == "bf16":  # the port reads bf16 bit patterns as uint16
            got_port = got_port.view(ml_dtypes.bfloat16)
            a = a.astype(ml_dtypes.bfloat16)
        np.testing.assert_array_equal(got_port, a)
        np.testing.assert_array_equal(got_jax, a)
    for idx in (port, jax_):
        data, scales, dtype = idx.load_quantized("q4")
        assert dtype == "Q4"
        np.testing.assert_array_equal(data, blockq.q4_quantize_np(q)[0])
        np.testing.assert_array_equal(scales, blockq.q4_quantize_np(q)[1])
        data, scales, dtype = idx.load_quantized("i8")
        assert dtype == "I8"
        np.testing.assert_array_equal(data, blockq.q8_quantize_np(q)[0])
        idx.close()


@pytest.mark.parametrize("n_parts", [1, 3])
def test_split_matches_jax_and_reads_in_both(tmp_path, n_parts):
    rng = np.random.default_rng(n_parts)
    src = tmp_path / "src"
    src.mkdir()
    w = SafeTensorWriter()
    tensors = {}
    for i in range(6):
        a = rng.standard_normal((8, 64 * (i + 1))).astype(np.float32)
        tensors[f"t{i}"] = a
        w.add(f"t{i}", a)
    packed, scales = blockq.q4_quantize_np(rng.standard_normal((4, 64)).astype(np.float32))
    w.add_q4("q", packed, scales)
    w.write(src / "model.safetensors")

    out = split_safetensors(src, tmp_path / "parts", n_parts=n_parts)
    ref = jsplit(src, tmp_path / "jparts", n_parts=n_parts)
    names = sorted(p.name for p in ref.iterdir())
    assert sorted(p.name for p in out.iterdir()) == names
    assert len([n for n in names if n.startswith("model-")]) == n_parts
    for n in names:
        assert filecmp.cmp(out / n, ref / n, shallow=False), n
    for idx in (SafeTensorIndex(out), JIndex(out)):
        assert idx.metadata["total_size"] > 0
        for name, a in tensors.items():
            np.testing.assert_array_equal(idx.load(name), a)
        data, sc, dtype = idx.load_quantized("q")
        assert dtype == "Q4"
        np.testing.assert_array_equal(data, packed)
        np.testing.assert_array_equal(sc, scales)
        assert idx.weight_map["q"] == idx.weight_map["q.qb"]  # scales ride along
        idx.close()
