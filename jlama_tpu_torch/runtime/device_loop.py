"""Chunked decode loop with an exit at a stop id (counterpart of
`jlama_tpu/runtime/device_loop.py`).

The JAX package runs N decode steps as one jitted `lax.while_loop` that exits
when every row has hit a stop id. Here one decode step reads its inputs from
the static tensors of a `DecodeInputs` and feeds its sampled token to the
next step in place (`runtime/graphs.py`); on the card it is a CUDA graph,
replayed with no host work between steps. Each step records its token in
the inputs' history at its step index and sets a row's `done` flag when the
token is one of the stop ids (a static buffer padded with -1, as the JAX
package's `pad_stop_ids` pads it).

The exit: the chunk's steps are issued in sub-chunks of `EXIT_EVERY`. Each
sub-chunk ends with a non-blocking copy of "every row is done" into pinned
host memory and an event; before issuing sub-chunk j + 2, the host waits for
sub-chunk j's event and stops if its flag is set. So one sub-chunk is always
queued behind the one the host reads, the device does not wait for the
host, and a stop in sub-chunk j runs at most the rest of sub-chunk j and
sub-chunk j + 1: `2 * EXIT_EVERY - 1` steps after the stop step. On the
CPU, where a read costs no wait, the flag is read after every step and the
loop stops after the step in which every row is done, as the JAX loop does.
The exact exit of the JAX loop, a conditional WHILE node around the
captured step, would need a graph built outside torch's capture; the
sub-chunks need nothing but the step's graph and cost a flag read every
`EXIT_EVERY` steps.

The chunk's tokens come to the host in one copy, and each row is trimmed
after its first stop id. Steps issued after a row's stop write K/V only at
slots past the row's final position, which a later forward overwrites before
it attends to them, and their draws are keyed by their own step index, so
the ids, `n_valid` and the session position equal the JAX loop's.
"""

from __future__ import annotations

from typing import Callable

from .graphs import DecodeInputs, StepGraphs

# steps between two reads of the done flag on the card (see the docstring)
EXIT_EVERY = 4


def steps_after_stop_bound() -> int:
    """The most steps the card runs after the step that finishes every row."""
    return 2 * EXIT_EVERY - 1


def decode_loop(
    graphs: StepGraphs,
    key,
    step: Callable,
    inputs: DecodeInputs,
    first: int,
    n_steps: int,
    stop_ids: set[int],
) -> tuple[list[list[int]], list[int]]:
    """Run at most n_steps decode steps of `step` under `key`, the first at
    step index `first`, stopping early once every row is done (the inputs'
    `done`, set against their stop buffer). Returns (tokens per row up to
    and including its first stop id, n_valid per row)."""
    on_card = inputs.tokens.is_cuda
    sub, behind = (EXIT_EVERY, 1) if on_card else (1, 0)
    flags = []  # per issued sub-chunk: (flag, event) of its done copy
    issued = 0
    while issued < n_steps:
        if len(flags) > behind:
            flag, ev = flags[-1 - behind]
            if ev is not None:
                ev.synchronize()
            if bool(flag):
                break
        k = min(sub, n_steps - issued)
        for _ in range(k):
            graphs.run(key, step)
        issued += k
        if issued < n_steps:
            flags.append(inputs.done_flag())
    ids = inputs.history[:, first:first + issued].cpu().tolist()  # the chunk's one copy
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
