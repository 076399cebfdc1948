"""Shard-local loading on the port (`parallel/distributed.py::
load_params_sharded`, the range loads of `st/reader.py` and
`st/http_loader.py`), held against the port's whole load cut by
`parallel/mesh.py::shard_params` and against jlama_tpu's forward, as
tests/test_shard_local_load.py and tests/test_http_shard_load.py hold the
JAX package's:

- a range load of a local or an HTTP index equals the slice of the whole
  tensor (Q4 payload and block scales cut together), an odd Q4 column range
  raises, and `bytes_loaded` counts the bytes read (a column range's rows
  whole);
- each tp rank's tree, from local files and over ranged HTTP, is bit-equal
  to `shard_params` of the whole fused tree, at tp = 2 and at dp = 2 x tp =
  2 (a dp group's ranks read their tp rank's slice), and each rank reads
  under 0.8 of the payload (GPT-2 and BERT read whole, then cut, as the JAX
  loader does);
- the two ranks' tp logits (threads standing in for the ranks) are within
  2e-3 of jlama_tpu's `forward_logits` on its `load_params`, in f32.

The HTTP server here is this file's own (127.0.0.1, port 0, Range
requests by seek)."""

import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jlama_tpu_torch.models.base import fuse_params
from jlama_tpu_torch.models.loader import load_params
from jlama_tpu_torch.nn.qarray import QArray
from jlama_tpu_torch.parallel import distributed as D
from jlama_tpu_torch.parallel import tp_forward as ttpf
from jlama_tpu_torch.parallel.mesh import Mesh, RankSlice, shard_params
from jlama_tpu_torch.st import SafeTensorIndex, open_weights
from tests.helpers import make_tiny_llama, save_torch_model
from tests.test_torch_gpt2_bert import bert, gpt2  # noqa: F401  (module fixtures)
from tests.test_torch_tp_forward import CONFIGS, run_ranks

TP = 2
LOGIT_TOL = 2e-3  # tests/test_shard_local_load.py's limit
READ_LIMIT = 0.8  # of the payload, a rank (tests/test_shard_local_load.py)
TOKENS = np.array([[1, 5, 9, 42, 7, 13, 2, 30]], np.int64)
# every q4 slice on whole blocks of 32 at tp = 2: wo's 128 inputs, w2's 256
WIDE = dict(hidden_size=128, intermediate_size=256, num_attention_heads=8,
            num_key_value_heads=4)


class RangeHandler(BaseHTTPRequestHandler):
    """GET of a file under the server's root, whole or one `Range: bytes=a-b`
    (read by seek: only those bytes)."""

    root = "."

    def log_message(self, *a):
        pass

    def do_GET(self):
        path = os.path.join(self.root, self.path.split("?")[0].lstrip("/"))
        if not os.path.isfile(path):
            self.send_response(404)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        size = os.path.getsize(path)
        rng = self.headers.get("Range")
        lo, hi = 0, size - 1
        if rng:
            a, _, b = rng.split("=", 1)[1].partition("-")
            lo, hi = int(a), min(int(b) if b else size - 1, size - 1)
        with open(path, "rb") as f:
            f.seek(lo)
            data = f.read(hi - lo + 1)
        self.send_response(206 if rng else 200)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    """A Range server over a directory; yields (root, base URL)."""
    root = tmp_path_factory.mktemp("range_root")
    handler = type("Handler", (RangeHandler,), {"root": str(root)})
    srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield root, f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()


def _build_hf(tmp, cls_prefix, seed, cfg):
    """A tiny random checkpoint through transformers, norms and biases
    perturbed off HF's ones and zeros (tests/test_torch_archs.py's)."""
    from tests.test_torch_archs import _build

    _build(tmp, cls_prefix, seed, cfg)
    return tmp


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory, server, gpt2, bert):  # noqa: F811
    """name -> a checkpoint directory: the tiny llama (f32 and JQ4), qwen2
    (q, k, v biases), gemma2 (tied, four norms), Mixtral (f32 and JQ4
    experts), GPT-2 (JQ4) and BERT; the JQ4 llama is also served over
    HTTP (its copy under the server's root)."""
    from jlama_tpu.quant.quantizer import quantize_model

    tmp = tmp_path_factory.mktemp("shard_ckpts")
    out = {}
    out["llama"], _ = make_tiny_llama(tmp / "llama", config_overrides=WIDE)
    out["llama_q4"] = quantize_model(out["llama"], tmp / "llama_q4")
    from tests.test_torch_archs import ARCHS

    for name in ("qwen2", "gemma2"):
        prefix, seed, cfg = ARCHS[name]
        out[name] = _build_hf(tmp / name, prefix, seed, dict(cfg, **WIDE))
    out["mixtral"] = _build_hf(tmp / "mixtral", "Mixtral", 8, dict(CONFIGS["mixtral"], **WIDE))
    out["mixtral_q4"] = quantize_model(out["mixtral"], tmp / "mixtral_q4")
    out["gpt2"] = gpt2[0] / "jq4"
    out["bert"] = bert[0]
    root, _ = server
    (root / "llama_q4").mkdir()
    for f in out["llama_q4"].iterdir():
        (root / "llama_q4" / f.name).write_bytes(f.read_bytes())
    return out


def _mesh(tp_rank, dp=1, dp_index=0):
    group = SimpleNamespace(rank=tp_rank, size=TP, device=torch.device("cpu"))
    return Mesh(dp, 1, TP, group, dp_index)


def _whole_cut(model_dir, rank):
    """shard_params of the whole fused f32 tree: the reference cut."""
    params, cfg = load_params(model_dir, device="cpu", float_dtype=torch.float32)
    return shard_params(fuse_params(params, TP), cfg, TP, rank), cfg


def assert_bit_equal(a, b, path="params"):
    if isinstance(a, dict):
        assert set(a) == set(b), f"{path}: {sorted(set(a) ^ set(b))}"
        for k in a:
            assert_bit_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_bit_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, QArray):
        assert isinstance(b, QArray) and a.fmt == b.fmt, path
        assert torch.equal(a.data, b.data) and a.data.dtype == b.data.dtype, path
        assert torch.equal(a.scales, b.scales) and a.scales.dtype == b.scales.dtype, path
    else:
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), path


def _payload(model_dir) -> int:
    idx = SafeTensorIndex(model_dir)
    try:
        return D.payload_bytes(idx)
    finally:
        idx.close()


# ---------------------------------------------------------------------------
# range loads
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("where", ["local", "http"])
def test_range_loads_equal_slices(ckpts, server, where):
    """load(name, row_range, col_range) of a local and an HTTP index equals
    the slice of the whole tensor: a Q4 payload ([N, K/2] bytes) and its
    block scales cut together, a float tensor, a 1-D bias; an odd Q4 column
    range and a column range off the 32-blocks raise; bytes_loaded counts
    what was read: a row range's rows and, for a column range, its rows
    whole (the HTTP index fetches them; the local rows of a JQ4 weight are
    narrower than a page)."""
    whole = SafeTensorIndex(ckpts["llama_q4"])
    idx = (SafeTensorIndex(ckpts["llama_q4"]) if where == "local"
           else open_weights(server[1] + "/llama_q4"))
    name = "model.layers.0.mlp.down_proj.weight"  # Q4 [128, 256]
    data, scales = np.asarray(whole.load(name)), np.asarray(whole.load(name + ".qb"))
    assert whole.info(name).dtype == "Q4" and data.shape == (128, 128)
    before = idx.bytes_loaded
    d, s, dt = idx.load_quantized(name, (32, 96), (128, 256))
    assert dt == "Q4"
    np.testing.assert_array_equal(d, data[32:96, 64:128])
    np.testing.assert_array_equal(s, scales[32:96, 4:8])
    # whole rows 32..95 of both tensors
    assert idx.bytes_loaded - before == 64 * (data.shape[1] + scales.nbytes // scales.shape[0])
    before = idx.bytes_loaded
    d, s, _ = idx.load_quantized(name, (0, 64), None)
    np.testing.assert_array_equal(d, data[:64])
    np.testing.assert_array_equal(s, scales[:64])
    assert idx.bytes_loaded - before == d.nbytes + s.nbytes
    norm = "model.layers.1.input_layernorm.weight"
    np.testing.assert_array_equal(idx.load(norm, None, (32, 96)), whole.load(norm)[32:96])
    with pytest.raises(ValueError, match="even"):
        idx.load(name, None, (1, 33))
    with pytest.raises(ValueError, match="32-aligned"):
        idx.load_quantized(name, None, (16, 48))
    idx.close()
    whole.close()


# ---------------------------------------------------------------------------
# the rank trees
# ---------------------------------------------------------------------------

TREES = ["llama", "llama_q4", "qwen2", "gemma2", "mixtral", "mixtral_q4", "gpt2", "bert"]


@pytest.mark.parametrize("name", TREES)
def test_rank_trees_equal_shard_params(ckpts, name):
    """Each tp rank's tree equals the cut of the whole fused tree bit for
    bit (its `RankSlice` flags too), and the rank read under 0.8 of the
    payload; GPT-2 and BERT are read whole and cut, as the JAX loader does
    (`_SHARDED_ARCHS`)."""
    model_dir = ckpts[name]
    payload = _payload(model_dir)
    for rank in range(TP):
        got, cfg = D.load_params_sharded(model_dir, None, _mesh(rank), float_dtype=torch.float32)
        want, _ = _whole_cut(model_dir, rank)
        assert isinstance(got, RankSlice) and (got.tp, got.rank) == (TP, rank)
        assert got.vocab == want.vocab
        assert_bit_equal(dict(got), dict(want))
        read = D.LOAD_STATS["bytes_loaded"]
        assert D.LOAD_STATS["payload"] == payload
        if cfg.model_type in D.SHARDED_ARCHS:
            assert read < READ_LIMIT * payload, (read, payload)
        else:  # every tensor read (GPT-2's c_attn once for each of q, k and v)
            assert read >= payload
    if name == "mixtral_q4":  # expert parallelism: the rank's E/2 experts
        assert got["layers"][0]["experts.w1"].data.shape[0] == cfg.n_experts // TP
    if name == "qwen2":
        assert "wqkv.bias" in got["layers"][0]


def test_dp_groups_read_their_tp_slice(ckpts):
    """dp = 2 x tp = 2: global rank r reads tp rank r % 2's slice, the same
    in both dp groups; tp = 1 (dp alone) reads the whole fused tree."""
    model_dir = ckpts["llama_q4"]
    trees = [D.load_params_sharded(model_dir, None, _mesh(r % TP, dp=2, dp_index=r // TP),
                                   float_dtype=torch.float32)[0] for r in range(4)]
    for r in range(4):
        assert trees[r].rank == r % TP
        assert_bit_equal(dict(trees[r]), dict(trees[r % TP]))
    assert not torch.equal(trees[0]["layers"][0]["wo"].data, trees[1]["layers"][0]["wo"].data)
    one = Mesh(2, 1, 1, None, 1)
    whole, cfg = D.load_params_sharded(model_dir, None, one, device="cpu",
                                       float_dtype=torch.float32)
    ref, _ = load_params(model_dir, device="cpu", float_dtype=torch.float32)
    assert_bit_equal(whole, fuse_params(ref))
    assert D.LOAD_STATS["bytes_loaded"] == _payload(model_dir)


def test_http_rank_trees_equal_local(ckpts, server):
    """Over ranged HTTP each rank gets the local rank tree, bit for bit, and
    fetches what the local index reads, under 0.8 of the payload (its rows
    of the column-parallel weights and vocabulary, the whole rows of wo and
    w2)."""
    url = server[1] + "/llama_q4"
    payload = _payload(ckpts["llama_q4"])
    for rank in range(TP):
        got, _ = D.load_params_sharded(url, None, _mesh(rank), float_dtype=torch.float32)
        fetched = D.LOAD_STATS["bytes_loaded"]
        local, _ = D.load_params_sharded(ckpts["llama_q4"], None, _mesh(rank),
                                         float_dtype=torch.float32)
        assert_bit_equal(dict(got), dict(local))
        assert D.LOAD_STATS["bytes_loaded"] == fetched < READ_LIMIT * payload


# ---------------------------------------------------------------------------
# the tp forward over the loaded slices
# ---------------------------------------------------------------------------


def _jax_logits(model_dir):
    from jlama_tpu.models.base import forward_logits
    from jlama_tpu.models.loader import load_params as jload

    params, cfg = jload(model_dir, float_dtype=jnp.float32)
    pos = np.arange(TOKENS.shape[1], dtype=np.int32)[None]
    logits, _ = forward_logits(params, cfg, jnp.asarray(TOKENS, jnp.int32), jnp.asarray(pos),
                               dtype=jnp.float32)
    return np.asarray(logits)


@pytest.mark.parametrize("where", ["local", "http"])
def test_tp_logits_of_loaded_slices_match_jax(ckpts, server, where):
    """The JQ4 llama's two rank slices, loaded shard-locally, run the tp
    forward (thread ranks) and give jlama_tpu's logits within 2e-3 (f32),
    both ranks the same."""
    src = ckpts["llama_q4"] if where == "local" else server[1] + "/llama_q4"
    trees = [D.load_params_sharded(src, None, _mesh(r), float_dtype=torch.float32)
             for r in range(TP)]
    cfg = ttpf.localize_cfg(trees[0][1], TP)
    toks = torch.from_numpy(TOKENS)
    pos = torch.arange(TOKENS.shape[1])[None]

    def rank_fn(group):
        from jlama_tpu_torch.models.base import forward_logits

        local = trees[group.rank][0]
        with ttpf.tp_context(ttpf.TPCtx(group, *local.vocab)):
            return forward_logits(local, cfg, toks, pos, dtype=torch.float32)[0].numpy()

    got = run_ranks(TP, rank_fn)
    np.testing.assert_array_equal(got[0], got[1])
    np.testing.assert_allclose(got[0], _jax_logits(ckpts["llama_q4"]), atol=LOGIT_TOL, rtol=0)
