"""Device timing and the roofline bound on one NVIDIA H100 (SXM).

`Timer` gives the median device milliseconds of a call on the card, each
launch after an L2 flush; `bound` the least time the card could take for a
given number of bytes and operations, from the H100 SXM data sheet's peaks
(at the full 700 W power limit). Both need a CUDA device; nothing here runs
on the CPU.
"""

from __future__ import annotations

import statistics
import time

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_OPS_PER_S = 989e12  # H100 SXM data sheet, dense bf16 tensor cores
INT8_OPS_PER_S = 1979e12  # H100 SXM data sheet, dense int8 tensor cores
SLEEP_CYCLES = 100_000_000  # ~50 ms at H100 clocks: the host queues every timed launch


def bound(nbytes: float, ops: float, ops_per_s: float = BF16_OPS_PER_S) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the larger of bytes over the memory
    rate and operations over the peak rate for their type."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


class Timer:
    """Median device ms of a call, each launch after an L2 flush (the main path
    finds its weights cold: a decode step streams ~0.65 GB between two uses).
    The flush reads a 128 MB buffer: a write would leave the L2 full of dirty
    lines whose write-back the timed launch would pay for. A device-side
    sleep ahead of the timed launches lets the host enqueue all of them
    first, so the events time the device's work and not the wrapper's host
    cost between two events."""

    def __init__(self, device="cuda"):
        if torch.device(device).type != "cuda":
            raise RuntimeError("Timer measures device time and needs a CUDA device")
        self.flush = torch.zeros(128 << 20, dtype=torch.uint8, device=device)
        # a quarter second of load first, so the first timed call does not
        # pay for the clocks ramping up from idle
        a = torch.randn((4096, 4096), device=device, dtype=torch.bfloat16)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 0.25:
            for _ in range(50):
                a @ a
            torch.cuda.synchronize()

    def __call__(self, fn, reps: int = 10, sleep_cycles: int = SLEEP_CYCLES) -> float:
        """`sleep_cycles` must outlast the host's enqueue of the `reps`
        launches; a light wrapper needs far less than the default."""
        fn()
        torch.cuda.synchronize()
        ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
        torch.cuda._sleep(sleep_cycles)
        for s, e in ev:
            self.flush.sum()
            s.record()
            fn()
            e.record()
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in ev)
