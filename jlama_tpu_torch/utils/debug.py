"""Per-layer tensor debug dumps (counterpart of `jlama_tpu/utils/debug.py`).

A globally gated `debug(name, tensor, layer)` hook that the attention block
calls on q, k and v; off by default, and then it does nothing: no copy, no
sync, no launch. Enabled by JLAMA_DEBUG=1 (read at import) or `enable()`.
While it is on, each call copies the tensor to the host (one copy, which
waits for the device) and hands the sink (name, layer, numpy array); bf16,
which numpy lacks, comes as float32. A host callback cannot run inside a
captured CUDA graph, so while the hook is on `runtime/graphs.py::StepGraphs`
runs every step eagerly: no capture, no replay.
"""

from __future__ import annotations

import os

import numpy as np
import torch

_enabled = os.environ.get("JLAMA_DEBUG", "0") == "1"
_sink = None  # callable(name, layer, np.ndarray) or None -> print summary


def enabled() -> bool:
    return _enabled


def enable(sink=None) -> None:
    global _enabled, _sink
    _enabled = True
    _sink = sink


def disable() -> None:
    global _enabled
    _enabled = False


def _default_sink(name: str, layer, arr: np.ndarray) -> None:
    a = np.asarray(arr, dtype=np.float32)
    print(
        f"[debug] L{layer} {name}: shape={a.shape} "
        f"sum={a.sum():.5f} absmax={np.abs(a).max():.5f}"
    )


def debug(name: str, tensor: torch.Tensor, layer=None) -> torch.Tensor:
    """Dump a named tensor (no-op unless enabled); returns the tensor."""
    if not _enabled:
        return tensor
    t = tensor.detach()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    (_sink or _default_sink)(name, layer, t.cpu().numpy())
    return tensor
