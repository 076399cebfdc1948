"""The port's hub downloader (`jlama_tpu_torch/hub.py`) against a fake Hub
on 127.0.0.1 (no network), beside jlama_tpu's on the same server: the same
files fetched, byte for byte; a resumed download; a byte range; the model
home and its listing shared with the JAX package."""

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest


@pytest.fixture()
def fake_hub(monkeypatch, tmp_path):
    files = {
        "config.json": json.dumps({"model_type": "llama"}).encode(),
        "tokenizer.json": b"{}",
        "model-00001-of-00002.safetensors": bytes(range(256)) * 16,
        "model-00002-of-00002.safetensors": b"B" * 2048,
        "model.safetensors.index.json": b"{}",
        "README.md": b"ignored",
    }
    hits = []

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            hits.append((self.path, self.headers.get("Range"),
                         self.headers.get("Authorization")))
            if self.path.startswith("/api/models/"):
                body = json.dumps([{"type": "file", "path": p} for p in files]
                                  + [{"type": "directory", "path": "sub"}]).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            name = self.path.rsplit("/", 1)[-1]
            if name not in files:
                self.send_response(404)
                self.end_headers()
                return
            data = files[name]
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
    from jlama_tpu import hub as jhub
    from jlama_tpu_torch import hub

    base = f"http://127.0.0.1:{srv.server_address[1]}"
    for mod in (hub, jhub):
        monkeypatch.setattr(mod, "HF_BASE", base)
    monkeypatch.setenv("JLAMA_MODEL_HOME", str(tmp_path / "home"))
    yield files, hits, tmp_path
    srv.shutdown()


@pytest.mark.parametrize("workers", [1, 4])
def test_download_model_matches_jax(fake_hub, tmp_path, workers):
    from jlama_tpu.hub import download_model as jdownload
    from jlama_tpu_torch.hub import download_model

    files, hits, _ = fake_hub
    done = []
    out = download_model("acme/tiny", out_dir=tmp_path / "m", workers=workers,
                         progress=lambda n, d, t: done.append((n, d, t)))
    ref = jdownload("acme/tiny", out_dir=tmp_path / "j", workers=workers)
    for name, data in files.items():
        if name == "README.md":  # not a model file
            assert not (out / name).exists() and not (ref / name).exists()
            continue
        assert (out / name).read_bytes() == data == (ref / name).read_bytes(), name
    assert not list(out.glob("*.part"))
    assert {n for n, d, t in done if d == t} == set(files) - {"README.md"}


def test_download_file_resumes_and_byte_range(fake_hub, tmp_path):
    from jlama_tpu_torch.hub import download_byte_range, download_file

    files, hits, _ = fake_hub
    name = "model-00001-of-00002.safetensors"
    dest = tmp_path / "r" / name
    dest.parent.mkdir()
    (tmp_path / "r" / (name + ".part")).write_bytes(files[name][:1000])
    download_file("acme/tiny", name, dest, token="tok")
    assert dest.read_bytes() == files[name]
    assert hits[-1] == (f"/acme/tiny/resolve/main/{name}", "bytes=1000-", "Bearer tok")
    assert download_byte_range("acme/tiny", name, 100, 300, branch="dev") == files[name][100:300]
    assert hits[-1][:2] == (f"/acme/tiny/resolve/dev/{name}", "bytes=100-299")


def test_maybe_download_model_list_and_home(fake_hub):
    from jlama_tpu import hub as jhub
    from jlama_tpu_torch.hub import (default_model_home, list_models, maybe_download_model,
                                     model_dir_name)

    files, hits, tmp_path = fake_hub
    assert default_model_home() == jhub.default_model_home() == tmp_path / "home"
    assert model_dir_name("acme/tiny") == "acme_tiny"
    assert list_models() == []
    out = maybe_download_model("acme/tiny")
    assert out == tmp_path / "home" / "acme_tiny" and (out / "config.json").exists()
    n_hits = len(hits)
    assert maybe_download_model("acme/tiny") == out  # found locally: no Hub traffic
    assert len(hits) == n_hits
    assert list_models() == jhub.list_models() == ["acme_tiny"]
    with pytest.raises(FileNotFoundError):
        maybe_download_model("not-a-repo-id")


def test_default_model_home_without_env(monkeypatch):
    from pathlib import Path

    from jlama_tpu import hub as jhub
    from jlama_tpu_torch.hub import default_model_home

    monkeypatch.delenv("JLAMA_MODEL_HOME", raising=False)
    assert default_model_home() == jhub.default_model_home() == \
        Path.home() / ".jlama" / "models"
