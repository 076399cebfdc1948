"""Joining a tp group over `torch.distributed` (counterpart of
`jlama_tpu/parallel/distributed.py:initialize_cluster`).

One process per rank. `init_tp_group` builds the rendezvous store itself (a
`FileStore` at a path every rank can read, or a `TCPStore` from
`tcp://host:port`, rank 0 its server), checks the devices against the
backend through that store, then calls `init_process_group` with the
backend, the store, the world size and the rank all explicit, and returns
the rank's `TPGroup`.

The backend follows the rank's device: NCCL on CUDA, gloo on the CPU. The
caller may name gloo on CUDA, which is how two ranks share one GPU (NCCL
refuses that). Every rank reads the whole checkpoint on the host and keeps
its own slice on the device; the JAX package's shard-local and HTTP shard
loading (`jlama_tpu/parallel/distributed.py:95-402`) is not ported yet
(ROADMAP queue 1 item 3).
"""

from __future__ import annotations

import datetime
import socket

import torch

from .tp_forward import TPGroup


def rank_device(rank: int, device=None, local_rank: int | None = None) -> torch.device:
    """A rank's device: the caller's, else cuda:{local_rank} (the rank by
    default); raises without CUDA and without a named device."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run the tp "
                           "ranks on the CPU (gloo)")
    return torch.device("cuda", rank if local_rank is None else local_rank)


def check_nccl_devices(devices: list[str], device_count: int) -> None:
    """Raise where NCCL cannot run: more ranks on a host than its GPUs, or
    two ranks on one device (`devices`: each rank's "host/device")."""
    hosts = {d.split("/")[0] for d in devices}
    per_host = max(sum(d.split("/")[0] == h for d in devices) for h in hosts)
    if per_host > device_count:
        raise ValueError(f"NCCL: {per_host} ranks on one host but torch sees {device_count} "
                         "CUDA device(s); two ranks on one GPU take backend='gloo'")
    dup = sorted({d for d in devices if devices.count(d) > 1})
    if dup:
        raise ValueError(f"NCCL: two ranks share {', '.join(dup)}; NCCL needs one GPU per "
                         "rank (two ranks on one GPU take backend='gloo')")


def make_store(world_size: int, rank: int, store_path: str | None = None,
               init_method: str | None = None, timeout_s: float = 300.0):
    """The rendezvous store: a FileStore at `store_path`, or a TCPStore from
    `init_method` = "tcp://host:port" (rank 0 serves it)."""
    import torch.distributed as dist

    if (store_path is None) == (init_method is None):
        raise ValueError("give exactly one of store_path and init_method")
    if store_path is not None:
        return dist.FileStore(store_path, world_size)
    if not init_method.startswith("tcp://"):
        raise ValueError(f"init_method {init_method!r}: expected tcp://host:port")
    host, port = init_method[len("tcp://"):].rsplit(":", 1)
    return dist.TCPStore(host, int(port), world_size, is_master=rank == 0,
                         timeout=datetime.timedelta(seconds=timeout_s))


def init_tp_group(world_size: int, rank: int, *, device=None, backend: str | None = None,
                  store_path: str | None = None, init_method: str | None = None,
                  local_rank: int | None = None, timeout_s: float = 300.0) -> TPGroup:
    """Join the tp group of `world_size` ranks as `rank`; returns its
    TPGroup (its `store` is the rendezvous store, which the step channel's
    port goes through)."""
    import torch.distributed as dist

    dev = rank_device(rank, device, local_rank)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"NCCL needs a CUDA device, not {dev}")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: expected 'nccl' or 'gloo'")
    store = make_store(world_size, rank, store_path, init_method, timeout_s)
    if backend == "nccl":
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        store.set(f"tp_device_{rank}", f"{socket.gethostname()}/cuda:{index}")
        devices = [store.get(f"tp_device_{r}").decode() for r in range(world_size)]
        check_nccl_devices(devices, torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return TPGroup(rank, world_size, None, backend, dev, store)


def shutdown() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
