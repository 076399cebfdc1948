"""The port's HTTP safetensors loader (`jlama_tpu_torch/st/http_loader.py`)
and its URL model paths (`models.loader.load_params`, `config.load_config`,
`tokenizers.load_tokenizer` on `http://`), against jlama_tpu's loader and
against local loads, over a local HTTP server with Range support (the
standard library's; nothing leaves 127.0.0.1)."""

import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

from jlama_tpu.st.http_loader import HTTPSafeTensorLoader as JLoader
from jlama_tpu_torch.quant import blockq
from jlama_tpu_torch.st import SafeTensorIndex, SafeTensorWriter
from jlama_tpu_torch.st.http_loader import (HTTPSafeTensorIndex, HTTPSafeTensorLoader, is_url,
                                            open_weights)


def serve_directory(root):
    """A thread serving the files under `root` on 127.0.0.1 with HTTP Range
    support. Returns (base_url, hits, server); hits lists the paths asked."""
    hits = []

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            hits.append(self.path)
            path = os.path.join(root, self.path.lstrip("/"))
            if not os.path.isfile(path):
                self.send_response(404)
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            with open(path, "rb") as f:
                data = f.read()
            rng = self.headers.get("Range")
            if rng:
                lo, hi = rng.split("=")[1].split("-")
                data = data[int(lo): int(hi) + 1 if hi else len(data)]
                self.send_response(206)
            else:
                self.send_response(200)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{srv.server_address[1]}", hits, srv


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    root = tmp_path_factory.mktemp("http_root")
    rng = np.random.default_rng(0)
    a = rng.standard_normal((16, 64)).astype(np.float32)
    packed, scales = blockq.q4_quantize_np(rng.standard_normal((8, 64)).astype(np.float32))
    w = SafeTensorWriter()
    w.add("a", a)
    w.add_q4("q", packed, scales)
    (root / "files").mkdir()
    w.write(root / "files" / "model.safetensors")
    base, hits, srv = serve_directory(str(root))
    yield dict(root=root, base=base, hits=hits, a=a, packed=packed, scales=scales)
    srv.shutdown()


def test_lazy_load_full_rows_and_columns_match_jax(served, tmp_path):
    url = served["base"] + "/files/model.safetensors"
    ld = HTTPSafeTensorLoader(url, cache_dir=tmp_path / "cache")
    ref = JLoader(url)
    assert set(ld.names()) == set(ref.names()) == {"a", "q", "q.qb"}
    a, packed, scales = served["a"], served["packed"], served["scales"]
    np.testing.assert_array_equal(ld.load("a"), a)
    np.testing.assert_array_equal(ld.load("a", row_range=(4, 12)), a[4:12])
    np.testing.assert_array_equal(ld.load("a", col_range=(8, 40)), a[:, 8:40])
    data, sc, dtype = ld.load_quantized("q", row_range=(2, 6), col_range=(0, 32))
    assert dtype == "Q4"
    np.testing.assert_array_equal(data, packed[2:6, :16])
    np.testing.assert_array_equal(sc, scales[2:6, :1])
    for args in ((None, None), ((1, 7), None), (None, (32, 64))):
        got, ref_ = ld.load_quantized("q", *args), ref.load_quantized("q", *args)
        np.testing.assert_array_equal(got[0], ref_[0])
        np.testing.assert_array_equal(got[1], ref_[1])
    with pytest.raises(ValueError, match="32-aligned"):
        ld.load_quantized("q", col_range=(0, 16))
    with pytest.raises(ValueError, match="even"):
        ld.load("q", col_range=(1, 3))
    assert ld.bytes_fetched > 0
    # cached parts are reused: a second loader over the same cache fetches
    # nothing but what it has not seen
    n = len(served["hits"])
    ld2 = HTTPSafeTensorLoader(url, cache_dir=tmp_path / "cache")
    np.testing.assert_array_equal(ld2.load("a", row_range=(4, 12)), a[4:12])
    assert len(served["hits"]) == n and ld2.bytes_fetched == 0


def test_index_reads_a_split_checkpoint(served, tmp_path):
    from jlama_tpu_torch.st.splitter import split_safetensors

    split_safetensors(served["root"] / "files", served["root"] / "split", n_parts=2)
    idx = open_weights(served["base"] + "/split/")
    assert isinstance(idx, HTTPSafeTensorIndex)
    local = SafeTensorIndex(served["root"] / "split")
    assert sorted(idx.names()) == sorted(local.names())
    assert idx.metadata == local.metadata
    for name in ("a", "q"):
        got, ref = idx.load_quantized(name), local.load_quantized(name)
        np.testing.assert_array_equal(got[0], ref[0])
        assert got[2] == ref[2]
    one = open_weights(served["base"] + "/files")  # no index: model.safetensors
    np.testing.assert_array_equal(one.load("a"), served["a"])
    assert idx.bytes_loaded > 0
    assert isinstance(open_weights(served["root"] / "split"), SafeTensorIndex)
    assert is_url("https://x/y") and is_url("http://x") and not is_url("/tmp/http:")


def test_load_params_config_and_tokenizer_over_http_equal_local(tmp_path):
    from jlama_tpu_torch.config import load_config
    from jlama_tpu_torch.models.loader import load_params
    from jlama_tpu_torch.quant.quantizer import quantize_model
    from jlama_tpu_torch.tokenizers import load_tokenizer
    from tests.helpers import make_tiny_chat_model
    from tests.test_torch_bridge import to_np

    src, _ = make_tiny_chat_model(tmp_path / "tinychat")
    jq4 = quantize_model(src, tmp_path / "root" / "tiny-JQ4", device="cpu")
    base, _, srv = serve_directory(str(tmp_path / "root"))
    try:
        url = base + "/tiny-JQ4"
        assert load_config(url) == load_config(jq4)
        got, cfg = load_params(url, device="cpu", float_dtype=torch.float32)
        ref, _ = load_params(jq4, device="cpu", float_dtype=torch.float32)
        assert cfg.n_layers == 2 and got["layers"][0]["wq"].fmt == "q4"

        def flat(tree, prefix=""):
            if isinstance(tree, (dict, list)):
                items = tree.items() if isinstance(tree, dict) else enumerate(tree)
                return {k2: v for k, x in items for k2, v in flat(x, f"{prefix}{k}.").items()}
            return {prefix: tree}

        fg, fr = flat(got), flat(ref)
        assert fg.keys() == fr.keys()
        for k in fr:
            np.testing.assert_array_equal(to_np(fg[k]), to_np(fr[k]), err_msg=k)
        tok, local = load_tokenizer(url), load_tokenizer(jq4)
        text = "Hello there, tell me a story about a fox."
        assert tok.encode(text) == local.encode(text)
        assert tok.spec.chat_template == local.spec.chat_template and tok.eos_id == local.eos_id
    finally:
        srv.shutdown()
