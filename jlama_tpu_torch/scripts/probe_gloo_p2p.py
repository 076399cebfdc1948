"""Probe: does gloo's point-to-point take a CUDA tensor? (card only)

    python -m jlama_tpu_torch.scripts.probe_gloo_p2p

Two spawned ranks on cuda:0 join a gloo world and exchange a CUDA tensor
directly (`batch_isend_irecv`, each rank sending to and receiving from the
other); a failure here breaks the ranks' connection as well as raising, so
the probe runs in processes of its own and reports their exit codes. Then
two more ranks exchange through `parallel/pipeline.py::StageRing`'s route
for gloo and CUDA (pinned host memory), each checking what it got exactly.
This is why the stage ring never tries the direct route under gloo with a
CUDA tensor: on the H100 with torch 2.11 the direct exchange failed on the
sender (`writev ... Bad address`) and closed the pair under its peer,
ending both ranks (by a raise or an abort, run to run). Prints one JSON
line.
"""

from __future__ import annotations

import json
import multiprocessing as mp
import sys
import tempfile
import time


def _direct(rank: int, store_path: str) -> None:
    import datetime

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, 2), rank=rank,
                            world_size=2, timeout=datetime.timedelta(seconds=30))
    x = torch.full((4, 8), float(rank + 1), device="cuda:0")
    y = torch.zeros_like(x)
    for w in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, 1 - rank),
                                     dist.P2POp(dist.irecv, y, 1 - rank)]):
        w.wait()
    torch.cuda.synchronize()
    if not bool((y == float(2 - rank)).all()):
        raise SystemExit(3)
    dist.destroy_process_group()


def _staged(rank: int, store_path: str) -> None:
    import datetime

    import torch
    import torch.distributed as dist

    from ..parallel.pipeline import StageRing

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, 2), rank=rank,
                            world_size=2, timeout=datetime.timedelta(seconds=30))
    ring = StageRing(rank, 2, 1 - rank, 1 - rank, "gloo", torch.device("cuda", 0))
    assert ring.route == "host"
    x = torch.randn((16, 4096), generator=torch.Generator().manual_seed(rank)).to(
        "cuda:0", torch.bfloat16)
    want = torch.randn((16, 4096), generator=torch.Generator().manual_seed(1 - rank)).to(
        torch.bfloat16)
    if rank == 0:  # stage 0: hands on, and takes the last stage's tensor back
        _, got = ring.exchange(send_next=x, recv_last=((16, 4096), torch.bfloat16))
    else:
        got, _ = ring.exchange(send_first=x, recv_prev=((16, 4096), torch.bfloat16))
    if got.device.type != "cuda" or not torch.equal(got.cpu(), want):
        raise SystemExit(3)
    dist.destroy_process_group()


def _run(target, deadline_s: float = 60.0) -> list:
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as d:
        procs = [ctx.Process(target=target, args=(r, f"{d}/store")) for r in range(2)]
        for p in procs:
            p.start()
        end = time.monotonic() + deadline_s
        for p in procs:
            p.join(max(0.0, end - time.monotonic()))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
        return [p.exitcode for p in procs]


def probe() -> dict:
    """{"direct": the exit codes of the direct exchange's ranks, "staged":
    the stage ring's}; 0 is an exact exchange."""
    return {"direct": _run(_direct), "staged": _run(_staged)}


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("probe_gloo_p2p needs a CUDA device")
    print(json.dumps(dict(probe(), torch=torch.__version__,
                          device=torch.cuda.get_device_name(0))))


if __name__ == "__main__":
    main()
