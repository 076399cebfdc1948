"""Hugging Face Hub model download with ranged, resumable fetches.

A copy of `jlama_tpu/hub.py` on `urllib` alone: list a repo's files through
the Hub's API, download the model's files (config, tokenizer, safetensors)
in parallel, each resumable through HTTP Range requests, with an auth token
and a branch; `download_byte_range` fetches one byte range of a file.
`default_model_home` is the JAX package's ($JLAMA_MODEL_HOME, else
~/.jlama/models), so both packages list the same models. `HF_ENDPOINT`
names another hub.
"""

from __future__ import annotations

import json
import os
import urllib.error
import urllib.request
from pathlib import Path
from typing import Callable

HF_BASE = os.environ.get("HF_ENDPOINT", "https://huggingface.co")

MODEL_FILES = (
    "config.json",
    "tokenizer.json",
    "tokenizer_config.json",
    "generation_config.json",
    "special_tokens_map.json",
    "vocab.json",
    "merges.txt",
)


def default_model_home() -> Path:
    """$JLAMA_MODEL_HOME or ~/.jlama/models."""
    home = os.environ.get("JLAMA_MODEL_HOME")
    return Path(home) if home else Path.home() / ".jlama" / "models"


def model_dir_name(owner_model: str) -> str:
    return owner_model.replace("/", "_")


def _request(url: str, token: str | None = None, range_hdr: str | None = None):
    req = urllib.request.Request(url)
    if token:
        req.add_header("Authorization", f"Bearer {token}")
    if range_hdr:
        req.add_header("Range", range_hdr)
    return urllib.request.urlopen(req, timeout=60)


def list_repo_files(repo: str, branch: str = "main", token: str | None = None) -> list[dict]:
    url = f"{HF_BASE}/api/models/{repo}/tree/{branch}?recursive=true"
    with _request(url, token) as r:
        return json.loads(r.read().decode())


def download_file(
    repo: str,
    filename: str,
    dest: Path,
    branch: str = "main",
    token: str | None = None,
    progress: Callable[[str, int, int], None] | None = None,
    chunk: int = 1 << 20,
) -> Path:
    """Ranged, resumable single-file download."""
    dest.parent.mkdir(parents=True, exist_ok=True)
    url = f"{HF_BASE}/{repo}/resolve/{branch}/{filename}"
    tmp = dest.with_suffix(dest.suffix + ".part")
    start = tmp.stat().st_size if tmp.exists() else 0
    range_hdr = f"bytes={start}-" if start else None
    try:
        resp = _request(url, token, range_hdr)
    except urllib.error.HTTPError as e:  # 416 = already complete
        if e.code == 416 and tmp.exists():
            os.replace(tmp, dest)
            return dest
        raise
    total = start + int(resp.headers.get("Content-Length", 0))
    mode = "ab" if start else "wb"
    done = start
    with open(tmp, mode) as f:
        while True:
            buf = resp.read(chunk)
            if not buf:
                break
            f.write(buf)
            done += len(buf)
            if progress:
                progress(filename, done, total)
    os.replace(tmp, dest)
    return dest


def download_byte_range(
    repo: str,
    filename: str,
    start: int,
    end: int,
    branch: str = "main",
    token: str | None = None,
) -> bytes:
    """Fetch only [start, end) of a file — a TP shard's slice of a tensor."""
    url = f"{HF_BASE}/{repo}/resolve/{branch}/{filename}"
    with _request(url, token, f"bytes={start}-{end - 1}") as r:
        return r.read()


def download_model(
    repo: str,
    out_dir: Path | None = None,
    branch: str = "main",
    token: str | None = None,
    progress: Callable[[str, int, int], None] | None = None,
    workers: int = 4,
) -> Path:
    """Download a model's config/tokenizer/weights into the model home.

    Files fetch in parallel (`workers` threads); each file still resumes
    via Range requests (download_file)."""
    from concurrent.futures import ThreadPoolExecutor

    out = out_dir or (default_model_home() / model_dir_name(repo))
    out.mkdir(parents=True, exist_ok=True)
    files = list_repo_files(repo, branch, token)
    names = [f["path"] for f in files if f.get("type") == "file"]
    wanted = [n for n in names if n in MODEL_FILES]
    st = [n for n in names if n.endswith(".safetensors")]
    index = [n for n in names if n.endswith("safetensors.index.json")]
    todo = wanted + index + st
    if workers <= 1 or len(todo) <= 1:
        for n in todo:
            download_file(repo, n, out / n, branch, token, progress)
        return out
    with ThreadPoolExecutor(max_workers=workers) as pool:
        futs = [
            pool.submit(
                download_file, repo, n, out / n, branch, token, progress
            )
            for n in todo
        ]
        for f in futs:
            f.result()  # surface the first failure
    return out


def maybe_download_model(
    name: str, branch: str = "main", token: str | None = None
) -> Path:
    """Resolve `name` to a local model dir, downloading from the Hub when it
    looks like a repo id and is not present (the CLI's --auto-download)."""
    p = Path(name)
    if p.exists():
        return p
    home = default_model_home()
    for cand in (home / name, home / model_dir_name(name)):
        if cand.exists():
            return cand
    if "/" not in name:
        raise FileNotFoundError(
            f"model not found locally and not a repo id: {name}"
        )
    return download_model(name, branch=branch, token=token)


def list_models(model_home: Path | None = None) -> list[str]:
    home = model_home or default_model_home()
    if not home.exists():
        return []
    return sorted(
        d.name for d in home.iterdir() if (d / "config.json").exists()
    )
