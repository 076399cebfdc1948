"""Lazy per-tensor HTTP safetensors loading (ranged requests).

A copy of `jlama_tpu/st/http_loader.py` on `urllib` alone: fetch the header
with a small ranged request, then download each tensor's byte range on
demand, optionally only a row slice of it (the shard a tensor-parallel
worker needs); parts are cached on disk and reused. Tensors come back as
numpy arrays of their storage dtype, as the local `SafeTensorIndex` gives
them (BF16 as uint16 bit patterns).
"""

from __future__ import annotations

import json
import struct
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np

from .format import DTYPES, TensorInfo, parse_header


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
        self.bytes_fetched = 0
        # in-memory memo so column-sharded loads (full rows fetched, columns
        # cut locally) hit the network once per tensor, not once per shard
        self._memo: dict[tuple[int, int], bytes] = {}

        head = self._fetch_range(0, 8)
        (hlen,) = struct.unpack("<Q", head)
        raw = self._fetch_range(0, 8 + hlen)
        self.tensors, self.metadata, self.payload_start = parse_header(raw)

    # ------------------------------------------------------------------

    def _fetch_range(self, start: int, end: int) -> bytes:
        """[start, end) bytes of the remote file, disk-cached."""
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
        """Download (a row-slice of) a tensor.

        Row slicing fetches only that byte range of the file; rows must be
        the second-to-last dim of a 2-D tensor. Column slicing fetches full
        rows and cuts the column shard locally.
        """
        ti = self.tensors[name]
        np_dtype, _ = DTYPES[ti.dtype]
        start = self.payload_start + ti.data_offsets[0]
        shape = list(ti.shape)
        if ti.dtype == "Q4":
            shape[-1] //= 2
        if row_range is not None:
            if len(shape) != 2:
                raise ValueError("row slicing requires 2-D tensors")
            r0, r1 = row_range
            row_bytes = shape[-1] * np_dtype.itemsize
            data = self._fetch_range(start + r0 * row_bytes, start + r1 * row_bytes)
            arr = np.frombuffer(data, dtype=np_dtype).reshape(r1 - r0, shape[-1])
        else:
            data = self._fetch_range(start, start + ti.nbytes)
            arr = np.frombuffer(data, dtype=np_dtype).reshape(shape)
        if col_range is not None:
            c0, c1 = col_range
            if ti.dtype == "Q4":
                if c0 % 2 or c1 % 2:
                    raise ValueError("Q4 column range must be even (packed bytes)")
                arr = arr[..., c0 // 2 : c1 // 2]
            else:
                arr = arr[..., c0:c1]
        return arr

    def load_quantized(self, name: str, row_range=None, col_range=None):
        ti = self.tensors[name]
        data = self.load(name, row_range, col_range)
        scales = None
        if name + ".qb" in self.tensors:
            scol = None
            if col_range is not None:
                if col_range[0] % 32 or col_range[1] % 32:
                    raise ValueError("quantized column range must be 32-aligned")
                scol = (col_range[0] // 32, col_range[1] // 32)
            scales = self.load(name + ".qb", row_range, scol)
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
        """Bytes actually fetched over the network (payload + headers)."""
        return sum(f.bytes_fetched for f in self._files.values())

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
