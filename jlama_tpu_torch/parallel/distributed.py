"""Joining a dp × pp × tp mesh over `torch.distributed` (counterpart of
`jlama_tpu/parallel/distributed.py:initialize_cluster`).

One process per rank, a world of dp × pp × tp ranks: rank r is tp rank
r % tp of stage (r // tp) % pp of dp group r // (pp · tp) (the JAX device
order `reshape(dp, pp, tp)`; rank 0 leads). `init_mesh_group` builds the
rendezvous store itself (a `FileStore` at a path every rank can read, or a
`TCPStore` from `tcp://host:port`, rank 0 its server), checks the devices
against the backend through that store, then calls `init_process_group`
with the backend, the store, the world size and the rank all explicit.
Where the world is more than one tp group it then makes each (dp group,
stage)'s tp subgroup (`new_group`, the same backend; otherwise the tp
group is the world), where dp > 1 the group of the dp groups' first ranks
(stage 0, tp rank 0), which carries each group's sampled ids to the leader
(gloo: the ids go through the host), and where pp > 1 each (dp group, tp
rank)'s group of pp stages, the `StageRing`'s (`parallel/pipeline.py`); it
returns the rank's `parallel.mesh.Mesh`: its `TPGroup`, its dp index, that
group, its stage and its ring. `init_tp_group` is the dp = pp = 1 case.

The backend follows the rank's device: NCCL on CUDA, gloo on the CPU. The
caller may name gloo on CUDA, which is how two ranks share one GPU (NCCL
refuses that).

`load_params_sharded` is the shard-local load
(`jlama_tpu/parallel/distributed.py:95-402`): each rank reads only its
stage's layers, cut to its tp slice, from local files (mmap range reads) or from an
`http(s)://` model URL (ranged requests), and gets its `RankSlice`
directly, without the host ever holding the whole model. `LOAD_STATS
["bytes_loaded"]` is the payload this process read in its last call.
"""

from __future__ import annotations

import datetime
import socket
from pathlib import Path

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
    return init_mesh_group(1, world_size, rank, device=device, backend=backend,
                           store_path=store_path, init_method=init_method,
                           local_rank=local_rank, timeout_s=timeout_s).group


def init_mesh_group(dp: int, tp: int, rank: int, *, pp: int = 1, device=None,
                    backend: str | None = None, store_path: str | None = None,
                    init_method: str | None = None, local_rank: int | None = None,
                    timeout_s: float = 300.0):
    """Join the dp × pp × tp world as global `rank`; returns the rank's
    `parallel.mesh.Mesh` (module docstring). Its `group.store` is the
    rendezvous store, which the step channel's port goes through."""
    import torch.distributed as dist

    from .mesh import Mesh
    from .pipeline import StageRing

    if dp < 1 or pp < 1 or tp < 1:
        raise ValueError(f"mesh dp={dp}, pp={pp}, tp={tp}: each must be at least 1")
    world_size = dp * pp * tp
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} is outside the world of dp*pp*tp={world_size} ranks")
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
    timeout = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size,
                            timeout=timeout)
    g, rem = divmod(rank, pp * tp)
    stage, tp_rank = divmod(rem, tp)
    if dp == 1 and pp == 1:
        return Mesh(1, 1, tp, TPGroup(rank, tp, None, backend, dev, store))

    def place(d, s, t):
        return d * pp * tp + s * tp + t

    # every rank enters every new_group, in the same order
    tp_pg = None
    for d in range(dp):
        for s in range(pp):
            pg = dist.new_group([place(d, s, t) for t in range(tp)], timeout=timeout,
                                backend=backend)
            if (d, s) == (g, stage):
                tp_pg = pg
    rows = None
    if dp > 1:
        rows_pg = dist.new_group([place(d, 0, 0) for d in range(dp)], timeout=timeout,
                                 backend="gloo")
        if (stage, tp_rank) == (0, 0):
            rows = TPGroup(g, dp, rows_pg, "gloo", torch.device("cpu"), store)
    ring = None
    if pp > 1:
        for d in range(dp):
            for t in range(tp):
                pg = dist.new_group([place(d, s, t) for s in range(pp)], timeout=timeout,
                                    backend=backend)
                if (d, t) == (g, tp_rank):
                    pp_pg = pg
        ring = StageRing(stage, pp, place(g, (stage - 1) % pp, tp_rank),
                         place(g, (stage + 1) % pp, tp_rank), backend, dev,
                         TPGroup(stage, pp, pp_pg, backend, dev, store))
        if backend == "nccl":  # NCCL's first point-to-point call wants the group set up
            dist.barrier(group=pp_pg)
    return Mesh(dp, pp, tp, TPGroup(tp_rank, tp, tp_pg, backend, dev, store), g, rows, stage,
                ring)


# the architectures read shard-locally (the JAX package's _SHARDED_ARCHS);
# GPT-2 and BERT load whole and are then cut, as there: GPT-2's c_attn holds
# q, k and v in one [D, 3D] Conv1D matrix, and both models are small
SHARDED_ARCHS = ("llama", "mistral", "qwen2", "granite", "gemma", "gemma2", "mixtral")

# diagnostics from this process's last load_params_sharded call:
# {"bytes_loaded": payload bytes read, "payload": the checkpoint's payload bytes}
LOAD_STATS: dict = {}


def _cut_of(tp: int, rank: int):
    """Our key -> its tp Cut (`parallel/mesh.py`'s plan before fusing)."""
    from ..models.loader import Cut, WHOLE
    from .mesh import COLUMN_PARALLEL, EXPERT_STACKS, ROW_PARALLEL, SPLIT_BIASES

    def cut_of(key: str):
        if key in COLUMN_PARALLEL:
            return Cut("rows", tp, rank)
        if key in ROW_PARALLEL or key in SPLIT_BIASES:
            return Cut("cols", tp, rank)
        if key in EXPERT_STACKS:
            return Cut("experts", tp, rank)
        if key in ("embed", "lm_head"):
            return Cut("vocab", tp, rank)
        return WHOLE  # norms, the router, row-parallel biases

    return cut_of


def payload_bytes(idx) -> int:
    """The tensor payload of an open checkpoint index (every tensor's
    bytes, its block scales included)."""
    return sum(idx.info(n).nbytes for n in idx.names())


def load_params_sharded(model_dir, cfg=None, mesh=None, device=None,
                        float_dtype=torch.bfloat16):
    """This rank's tree of a dp × pp × tp `mesh`, read shard-locally:
    (params, cfg). `model_dir` is a directory or an `http(s)://` model URL
    (each rank then fetches only its ranges). Every rank of a dp group reads
    its stage's layers (`pipeline.stage_range`) and, of those, its tp rank's
    slice:

    - output rows of wq, wk, wv, w1, w3 and their biases (a JQ4 weight's
      data and block scales together);
    - input columns of wo and w2, on whole blocks of 32;
    - E/tp experts of each expert stack, tp rank · E/tp onward;
    - vocabulary rows of the embedding and the lm_head where tp divides
      them, else the whole table;
    - the norms, the router and the row-parallel biases whole.

    The top-level leaves are read on every stage, as the JAX loader places
    them (replicated over pp). The rank's q, k, v and gate, up rows come
    fused: the tree is the `RankSlice` that `mesh.shard_params` cuts from
    the stage's layers of the whole fused tree, bit for bit. GPT-2 and BERT
    (not in SHARDED_ARCHS) are read whole and cut. dp alone: the whole tree.
    On `device` (the mesh group's unless named; CUDA otherwise)."""
    from ..config import load_config
    from ..device import resolve_device
    from ..models.base import fuse_params
    from ..models.loader import read_tree
    from ..st import is_url, open_weights
    from .mesh import RankSlice, shard_params, vocab_flags
    from .pipeline import stage_cut, stage_range

    group = mesh.group if mesh is not None else None
    tp = mesh.tp if mesh is not None else 1
    pp, stage = (mesh.pp, mesh.stage) if mesh is not None else (1, 0)
    rank = group.rank if tp > 1 else 0
    if device is None and group is not None:
        device = group.device
    device = resolve_device(device)
    if not is_url(model_dir):
        model_dir = Path(model_dir)
    if cfg is None:
        cfg = load_config(model_dir)
    idx = open_weights(model_dir)
    try:
        local = cfg.model_type in SHARDED_ARCHS
        cut = _cut_of(tp, rank) if local and tp > 1 else None
        layers = stage_range(cfg.n_layers, pp, stage) if local else None
        params = read_tree(idx, cfg, device, float_dtype, cut, layers)
        LOAD_STATS.update(bytes_loaded=idx.bytes_loaded, payload=payload_bytes(idx))
        # the whole tables' rows: a "vocab" cut took rows where tp divides them
        vocab = {k: _whole_rows(idx, cfg, k) % tp == 0 for k in ("embed", "lm_head")
                 if k in params}
    finally:
        idx.close()
    if tp == 1 and pp == 1:
        return fuse_params(params), cfg
    if not local:  # read whole, then cut (the JAX loader's fall-back for these models)
        params = stage_cut(params, cfg, pp, stage)
        return RankSlice(shard_params(fuse_params(params, tp), cfg, tp, rank), tp, rank,
                         vocab_flags(params, tp), pp, stage), cfg
    flags = (vocab["embed"], vocab.get("lm_head", vocab["embed"])) if tp > 1 else (False,
                                                                                  False)
    return RankSlice(fuse_params(params), tp, rank, flags, pp, stage), cfg


def _whole_rows(idx, cfg, key: str) -> int:
    """The rows of the checkpoint's embedding or lm_head, whole."""
    from ..models.loader import TOPLEVEL_MAPS, _strip_prefix

    hf = TOPLEVEL_MAPS[cfg.model_type][key].rstrip("?")
    name = _strip_prefix(idx, cfg) + hf
    return idx.info(name if name in idx else hf).shape[0]


def shutdown() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
