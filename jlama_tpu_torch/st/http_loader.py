"""Lazy per-tensor HTTP safetensors loading (ranged requests).

A copy of `jlama_tpu/st/http_loader.py` on `urllib` alone: fetch the header
with a small ranged request, then download each tensor's byte range on
demand, optionally only a slice of it (the shard a tensor-parallel rank
needs: a row range fetches only its rows' bytes, a column range fetches the
whole rows and cuts the columns locally, as the JAX loader does); parts are
cached on disk and reused. Tensors come back as numpy arrays of their
storage dtype, as the local `SafeTensorIndex` gives them (BF16 as uint16 bit
patterns). `bytes_loaded` counts the tensor payload bytes fetched over the
network (what was read, not what was kept: a column range counts its whole
rows; a memo or disk-cache hit counts nothing), as the local index counts
what it reads; a file loader's `bytes_fetched` adds the headers' bytes.
"""

from __future__ import annotations

import json
import struct
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np

from .format import DTYPES, TensorInfo, parse_header
from .reader import scale_cols, slice_payload


class HTTPSafeTensorLoader:
    def __init__(
        self,
        url: str,
        cache_dir: str | Path | None = None,
        token: str | None = None,
        header_probe_bytes: int = 8 * 1024 * 1024,
    ):
        self.url = url
        self.token = token
        self.cache = Path(cache_dir) if cache_dir else None
        if self.cache:
            self.cache.mkdir(parents=True, exist_ok=True)
        self.bytes_fetched = 0  # every byte fetched, headers included
        self.bytes_loaded = 0  # tensor payload bytes fetched
        # in-memory memo so column-sharded loads (full rows fetched, columns
        # cut locally) hit the network once per tensor, not once per shard
        self._memo: dict[tuple[int, int], bytes] = {}

        head = self._fetch_range(0, 8)
        (hlen,) = struct.unpack("<Q", head)
        raw = self._fetch_range(0, 8 + hlen)
        self.tensors, self.metadata, self.payload_start = parse_header(raw)

    # ------------------------------------------------------------------

    def _fetch_range(self, start: int, end: int, payload: bool = False) -> bytes:
        """[start, end) bytes of the remote file, disk-cached (`payload`: a
        tensor's bytes, counted in bytes_loaded when fetched)."""
        if (start, end) in self._memo:
            return self._memo[(start, end)]
        if self.cache:
            part = self.cache / f"{start}-{end}.part"
            if part.exists():
                return part.read_bytes()
        req = urllib.request.Request(self.url)
        req.add_header("Range", f"bytes={start}-{end - 1}")
        if self.token:
            req.add_header("Authorization", f"Bearer {self.token}")
        with urllib.request.urlopen(req, timeout=60) as r:
            data = r.read()
        if len(data) != end - start:
            raise IOError(
                f"ranged fetch returned {len(data)} bytes, wanted {end - start} "
                "(server may not support Range requests)"
            )
        self.bytes_fetched += len(data)
        if payload:
            self.bytes_loaded += len(data)
        if self.cache:
            part.write_bytes(data)
        self._memo[(start, end)] = data
        return data

    # ------------------------------------------------------------------

    def names(self) -> list[str]:
        return list(self.tensors)

    def __contains__(self, name: str) -> bool:
        return name in self.tensors

    def info(self, name: str) -> TensorInfo:
        return self.tensors[name]

    def load(
        self,
        name: str,
        row_range: tuple[int, int] | None = None,
        col_range: tuple[int, int] | None = None,
    ) -> np.ndarray:
        """Download (a slice of) a tensor, with the local reader's range
        semantics. A row range of a 2-D tensor fetches only those rows'
        bytes; a column range fetches whole rows and cuts the columns
        locally."""
        ti = self.tensors[name]
        np_dtype, _ = DTYPES[ti.dtype]
        start = self.payload_start + ti.data_offsets[0]
        shape = list(ti.shape)
        if ti.dtype == "Q4":
            shape[-1] //= 2
        if row_range is not None and len(shape) == 2:
            r0, r1 = row_range
            row_bytes = shape[-1] * np_dtype.itemsize
            data = self._fetch_range(start + r0 * row_bytes, start + r1 * row_bytes, True)
            arr = np.frombuffer(data, dtype=np_dtype).reshape(r1 - r0, shape[-1])
            row_range = None
        else:
            data = self._fetch_range(start, start + ti.nbytes, True)
            arr = np.frombuffer(data, dtype=np_dtype).reshape(shape)
        return slice_payload(arr, ti, row_range, col_range)

    def load_quantized(self, name: str, row_range=None, col_range=None):
        ti = self.tensors[name]
        quantized = name + ".qb" in self.tensors
        scol = scale_cols(col_range) if quantized else None
        data = self.load(name, row_range, col_range)
        scales = self.load(name + ".qb", row_range, scol) if quantized else None
        return data, scales, ti.dtype


class HTTPSafeTensorIndex:
    """SafeTensorIndex-compatible loader over a remote model directory URL.

    Resolves `model.safetensors.index.json` (multi-file checkpoints) or falls
    back to `model.safetensors`, exposing the union tensor namespace with the
    same load/load_quantized surface as the local mmap index, so a loader
    can range-fetch a remote checkpoint tensor by tensor.
    """

    def __init__(
        self,
        base_url: str,
        cache_dir: str | Path | None = None,
        token: str | None = None,
    ):
        self.base_url = base_url.rstrip("/")
        self.token = token
        self.cache = Path(cache_dir) if cache_dir else None
        self._files: dict[str, HTTPSafeTensorLoader] = {}
        self.weight_map: dict[str, str] = {}
        self.metadata: dict = {}

        idx = self._fetch_json("model.safetensors.index.json")
        if idx is not None:
            self.metadata = idx.get("metadata", {})
            self.weight_map = dict(idx["weight_map"])
        else:
            f = self._file("model.safetensors")
            for n in f.names():
                self.weight_map[n] = "model.safetensors"

    @property
    def bytes_loaded(self) -> int:
        """Tensor payload bytes fetched over the network (the local index's
        counter; a column range counts the whole rows it fetched)."""
        return sum(f.bytes_loaded for f in self._files.values())

    def _fetch_json(self, fname: str):
        return fetch_json(f"{self.base_url}/{fname}", self.token)

    def _file(self, fname: str) -> HTTPSafeTensorLoader:
        if fname not in self._files:
            sub = self.cache / fname if self.cache else None
            self._files[fname] = HTTPSafeTensorLoader(
                f"{self.base_url}/{fname}", cache_dir=sub, token=self.token
            )
        return self._files[fname]

    def names(self) -> list[str]:
        return list(self.weight_map)

    def __contains__(self, name: str) -> bool:
        return name in self.weight_map

    def info(self, name: str) -> TensorInfo:
        return self._file(self.weight_map[name]).info(name)

    def load(self, name: str, row_range=None, col_range=None) -> np.ndarray:
        return self._file(self.weight_map[name]).load(name, row_range, col_range)

    def load_quantized(self, name: str, row_range=None, col_range=None):
        return self._file(self.weight_map[name]).load_quantized(
            name, row_range, col_range
        )

    def close(self) -> None:
        self._files.clear()


def fetch_json(url: str, token: str | None = None):
    """The JSON document at a URL, or None where the server answers 404."""
    req = urllib.request.Request(url)
    if token:
        req.add_header("Authorization", f"Bearer {token}")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read())
    except urllib.error.HTTPError as e:
        if e.code == 404:
            return None
        raise


def is_url(path) -> bool:
    s = str(path)
    return s.startswith("http://") or s.startswith("https://")


def open_weights(model_dir, cache_dir=None, token=None):
    """SafeTensorIndex for a local dir, HTTPSafeTensorIndex for a URL."""
    if is_url(model_dir):
        import os

        cache_dir = cache_dir or os.environ.get("JLAMA_HTTP_CACHE")
        return HTTPSafeTensorIndex(str(model_dir), cache_dir=cache_dir, token=token)
    from .reader import SafeTensorIndex

    return SafeTensorIndex(model_dir)
