"""Chunked decode loop (counterpart of `jlama_tpu/runtime/device_loop.py`).

The JAX package runs N decode steps as one jitted `lax.while_loop` that exits
when every row has hit a stop id. Here one decode step reads its inputs from
the static tensors of a `DecodeInputs` and feeds its sampled token to the
next step in place (`runtime/graphs.py`); on the card it is a CUDA graph,
replayed N times with no host work between steps. Each step records its
token in the inputs' history at its step index; the chunk's tokens come to
the host in one copy, and each row is trimmed after its first stop id.
Steps issued after a stop write K/V only at slots past the row's final
position, which a later forward overwrites before it attends to them, and
their draws are keyed by their own step index, so the ids, `n_valid` and
the session position equal the JAX loop's.
"""

from __future__ import annotations

from typing import Callable

from .graphs import DecodeInputs, StepGraphs


def decode_loop(
    graphs: StepGraphs,
    key,
    step: Callable,
    inputs: DecodeInputs,
    first: int,
    n_steps: int,
    stop_ids: set[int],
) -> tuple[list[list[int]], list[int]]:
    """Run n_steps decode steps of `step` under `key`, the first at step
    index `first`. Returns (tokens per row up to and including its first
    stop id, n_valid per row)."""
    for _ in range(n_steps):
        graphs.run(key, step)
    ids = inputs.history[:, first:first + n_steps].cpu().tolist()  # the chunk's one sync
    rows, n_valid = [], []
    for row in ids:
        n = len(row)
        for i, t in enumerate(row):
            if t in stop_ids:
                n = i + 1
                break
        rows.append(row[:n])
        n_valid.append(n)
    return rows, n_valid
