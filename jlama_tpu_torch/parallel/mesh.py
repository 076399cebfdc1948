"""Mesh planning and the tensor-parallel shard plan (counterpart of
`jlama_tpu/parallel/mesh.py`).

A mesh has the JAX package's three axes:

  dp — data parallel (batch slots and the KV page pool)
  pp — pipeline parallel (the layers)
  tp — tensor parallel (heads and the FFN hidden size)

The torch idiom is one process per GPU, so a mesh here is its shape, this
rank's tp `TPGroup` (`parallel/tp_forward.py`), its dp index, its stage and
stage ring (`parallel/pipeline.py::StageRing`) and, on the first tp rank of
each dp group's stage 0, the group that carries the dp groups' sampled ids
to the leader (`parallel/distributed.py::init_mesh_group`). A world of dp ×
pp × tp ranks: rank r is tp rank r % tp of stage (r // tp) % pp of dp group
r // (pp · tp), the JAX device order `reshape(dp, pp, tp)`.

A rank's tree is a `RankSlice`: a dict that also says which slice it is (tp,
rank, and pp, stage: a stage's tree holds its L/pp layers and every
top-level leaf) and whether its embedding and lm_head are cut over the
vocabulary.
`shard_params` makes one from a whole tree, `parallel/distributed.py::
load_params_sharded` reads one from the checkpoint, and `rank_params`
takes either on the rank's device for the scheduler and the `Engine`.

`shard_params(params, cfg, tp, rank)` is the counterpart of `param_pspecs`
and `shard_params`: it slices a full, fused tree into rank `rank`'s tree,
by the JAX package's rules (`_LAYER_RULES` and `fit`):

- column-parallel (output rows): wqkv, w13 (interleaved by
  `models.base.fuse_params(params, tp)`, so rank i's rows are
  [q_i; k_i; v_i] and [gate_i; up_i]), wq, wk, wv, w1, w3, and their
  biases;
- row-parallel (input columns): wo and w2, a q4 or q8 weight's data
  [N, K/2] and block scales [N, K/32] cut together at block boundaries;
  their biases are replicated;
- vocabulary rows: the embedding and the lm_head, where tp divides the
  vocabulary (else replicated, as `fit` degrades a spec);
- expert stacks (`experts.w1/w2/w3`, and `experts.w*_t` after
  `prepare_moe_ragged`): expert parallelism, axis 0 cut into rank i's E/tp
  experts, i·E/tp onward (a q4 stack's data and scales together); the
  router stays replicated, so every rank routes over the model's experts;
- norms and every other leaf: replicated.

Each rank holds a contiguous JQ4 slice that K1 reads as it reads a whole
weight. The JAX package's `chunks=tp` kernel layout
(`jlama_tpu/ops/pallas_q4.py:55-84`), which repacks its TPU layout per
shard, has no counterpart here. Where a layer leaf does not divide, this
raises: the JAX package's spec would degrade to replicated and its
scheduler fall back to GSPMD, which the port does not have.
"""

from __future__ import annotations

from typing import NamedTuple

from ..config import ModelConfig
from ..nn.qarray import QArray


class Mesh(NamedTuple):
    """A mesh's shape and this rank's place in it: its tp group (None where
    the world is one rank), its dp index, `rows`, the group of the dp
    groups' first ranks that carries the sampled ids to the leader (None
    where dp = 1 and on the other ranks), its stage and its `StageRing`
    (None where pp = 1)."""

    dp: int = 1
    pp: int = 1
    tp: int = 1
    group: object | None = None
    dp_index: int = 0
    rows: object | None = None
    stage: int = 0
    ring: object | None = None

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "pp": self.pp, "tp": self.tp}


def make_mesh(n_devices: int | None = None, dp: int = 1, pp: int = 1,
              tp: int | None = None, group=None) -> Mesh:
    """The mesh (dp, pp, tp) over `n_devices` (default: dp·pp times the
    group's size); tp defaults to what dp and pp leave."""
    if n_devices is None:
        n_devices = dp * pp * (group.size if group is not None else (tp or 1))
    if tp is None:
        tp = n_devices // (dp * pp)
    if dp * pp * tp != n_devices:
        raise ValueError(f"dp*pp*tp={dp * pp * tp} != device count {n_devices}")
    if group is not None and group.size != tp:
        raise ValueError(f"tp={tp} but the tp group has {group.size} ranks")
    return Mesh(dp, pp, tp, group)


def plan_mesh_axes(
    n_devices: int,
    cfg: ModelConfig,
    weight_bytes: int | None = None,
    hbm_bytes_per_device: int = 80 << 30,  # one H100
    kv_reserve_frac: float = 0.35,
) -> tuple[int, int, int]:
    """Derive (dp, pp, tp) when no mesh is given (the JAX package's planner,
    its arithmetic unchanged; the default memory is an H100's):

    - tp first: the largest power of two that divides the device count,
      both head counts and the vocabulary (the embedding and lm_head are
      vocabulary-sharded over tp);
    - pp only when tp alone cannot fit the weights in one device's memory
      (less a KV reserve): the fewest stages that fit and divide the layers;
    - dp takes the remaining devices.
    """
    if n_devices < 1:
        raise ValueError("need at least one device")
    budget = int(hbm_bytes_per_device * (1.0 - kv_reserve_frac))
    min_shards = 1
    if weight_bytes:
        min_shards = max(1, -(-weight_bytes // budget))
    tp = 1
    while (
        tp * 2 <= n_devices
        and n_devices % (tp * 2) == 0
        and cfg.n_kv_heads % (tp * 2) == 0
        and cfg.n_heads % (tp * 2) == 0
        and cfg.vocab_size % (tp * 2) == 0
    ):
        tp *= 2
    rest = n_devices // tp
    pp = 1
    if tp < min_shards:
        # memory-forced pipeline stages: the smallest divisor of the
        # remaining devices that fits and divides the layer count
        for cand in range(2, rest + 1):
            if rest % cand or cfg.n_layers % cand:
                continue
            if tp * cand >= min_shards:
                pp = cand
                break
        else:
            if rest > 1 and cfg.n_layers % rest == 0:
                pp = rest  # best effort: every remaining device a stage
    dp = rest // pp
    if weight_bytes and tp * pp < min_shards:
        raise MemoryError(
            f"model ({weight_bytes / 1e9:.1f} GB) does not fit on {n_devices} "
            f"device(s) with {hbm_bytes_per_device / 1e9:.0f} GB each "
            f"(best mesh dp={dp},pp={pp},tp={tp})"
        )
    return dp, pp, tp


def plan_mesh(cfg: ModelConfig, n_devices: int, weight_bytes: int | None = None,
              hbm_bytes_per_device: int = 80 << 30, group=None) -> Mesh:
    dp, pp, tp = plan_mesh_axes(n_devices, cfg, weight_bytes, hbm_bytes_per_device)
    return make_mesh(n_devices, dp=dp, pp=pp, tp=tp, group=group)


# per-layer keys by the dimension they split on over tp (the JAX package's
# _LAYER_RULES: P("tp", None) is the output rows, P(None, "tp") the input
# columns, P("tp") a bias)
COLUMN_PARALLEL = ("wqkv", "w13", "wq", "wk", "wv", "w1", "w3")
ROW_PARALLEL = ("wo", "w2")
SPLIT_BIASES = tuple(k + ".bias" for k in COLUMN_PARALLEL)
# expert stacks [E, ...], cut on axis 0 over tp (the JAX package's experts.*
# rule, P("tp", ...)); the router [E, D] stays replicated
EXPERT_STACKS = tuple(f"experts.{w}{t}" for w in ("w1", "w2", "w3") for t in ("", "_t"))


class RankSlice(dict):
    """One rank's param tree: the dict of leaves, plus `tp`, `rank`, `pp`,
    `stage` and the vocabulary flags (`vocab`: embedding cut, lm_head cut),
    which the leaves' shapes alone cannot tell apart from a whole tree's."""

    def __init__(self, tree: dict, tp: int, rank: int, vocab: tuple[bool, bool], pp: int = 1,
                 stage: int = 0):
        super().__init__(tree)
        self.tp, self.rank, self.vocab = tp, rank, tuple(vocab)
        self.pp, self.stage = pp, stage

    def __reduce__(self):
        return RankSlice, (dict(self), self.tp, self.rank, self.vocab, self.pp, self.stage)


def vocab_sharded(leaf, tp: int) -> bool:
    """Whether an embedding or lm_head [V, D] is cut over tp (`fit`)."""
    return tp > 1 and leaf.shape[0] % tp == 0


def _block(t, dim: int, tp: int, rank: int, what: str):
    n = t.shape[dim]
    if n % tp:
        raise ValueError(f"{what}: dimension {dim} of size {n} does not divide over "
                         f"tp={tp} (the JAX package would replicate it and fall back "
                         "to GSPMD, which the port does not have)")
    per = n // tp
    return t.narrow(dim, rank * per, per).contiguous()


def _rows(w, tp, rank, what):
    if isinstance(w, QArray):
        if w.fmt not in ("q4", "q8"):
            raise ValueError(f"{what}: tp shards q4, q8 and float weights, not {w.fmt}")
        return QArray(_block(w.data, -2, tp, rank, what), _block(w.scales, -2, tp, rank, what),
                      w.fmt)
    return _block(w, -2, tp, rank, what)


def _cols(w, tp, rank, what):
    if isinstance(w, QArray):
        if w.fmt not in ("q4", "q8"):
            raise ValueError(f"{what}: tp shards q4, q8 and float weights, not {w.fmt}")
        if w.scales.shape[-1] % tp:
            # each rank's input slice must hold whole 32-element blocks
            raise ValueError(f"{what}: {w.scales.shape[-1]} blocks of 32 inputs do not "
                             f"divide over tp={tp}")
        return QArray(_block(w.data, -1, tp, rank, what), _block(w.scales, -1, tp, rank, what),
                      w.fmt)
    return _block(w, -1, tp, rank, what)


def _experts(w, tp, rank, what):
    if w.shape[0] % tp:
        raise ValueError(f"{what}: {w.shape[0]} experts do not divide over tp={tp} (expert "
                         "parallelism needs n_experts % tp == 0: the JAX package's "
                         "can_shard_map is false there and the port has no GSPMD)")
    if isinstance(w, QArray):
        if w.fmt != "q4":
            raise ValueError(f"{what}: expert parallelism shards q4 and float stacks, "
                             f"not {w.fmt}")
        return QArray(_block(w.data, 0, tp, rank, what), _block(w.scales, 0, tp, rank, what),
                      w.fmt)
    return _block(w, 0, tp, rank, what)


def shard_layer(d: dict, tp: int, rank: int, where: str = "layer") -> dict:
    out = {}
    for k, v in d.items():
        what = f"{where}.{k}"
        if k in EXPERT_STACKS:
            out[k] = _experts(v, tp, rank, what)
        elif k.startswith("experts."):
            raise ValueError(f"{what}: no shard rule for this expert leaf")
        elif k in COLUMN_PARALLEL:
            out[k] = _rows(v, tp, rank, what)
        elif k in ROW_PARALLEL:
            out[k] = _cols(v, tp, rank, what)
        elif k in SPLIT_BIASES:
            out[k] = _block(v, -1, tp, rank, what)
        else:  # norms, row-parallel biases, the router
            out[k] = v
    return out


def shard_params(params: dict, cfg: ModelConfig, tp: int, rank: int) -> dict:
    """Rank `rank`'s slice of a full, fused tree (see the module docstring),
    a `RankSlice` where tp > 1. Tensors come out contiguous (copies);
    replicated leaves are the input's."""
    if not 0 <= rank < tp:
        raise ValueError(f"rank {rank} is outside tp={tp}")
    if tp == 1:
        return params
    out = RankSlice({}, tp, rank, vocab_flags(params, tp))
    for k, v in params.items():
        if k == "layers":
            out[k] = [shard_layer(d, tp, rank, f"layers[{i}]") for i, d in enumerate(v)]
        elif k in ("embed", "lm_head") and vocab_sharded(v, tp):
            out[k] = _rows(v, tp, rank, k)
        else:
            out[k] = v
    return out


def vocab_flags(params: dict, tp: int) -> tuple[bool, bool]:
    """(embedding sharded, lm_head sharded) for a full tree at tp (a tied
    lm_head is the embedding), the JAX package's `specs_ok` flags."""
    embed = vocab_sharded(params["embed"], tp)
    return embed, vocab_sharded(params["lm_head"], tp) if "lm_head" in params else embed


def check_whole(params: dict, cfg: ModelConfig) -> None:
    """Raise for a tree that holds a tp rank's slice of the config's (a
    `RankSlice`, or a tree whose attention rows are a slice's) given
    without the rank's mesh: a single-device path would run it as if
    whole."""
    if isinstance(params, RankSlice):
        what = (f"tp rank {params.rank} of {params.tp}'s slice" if params.tp > 1
                else f"stage {params.stage} of {params.pp}'s layers")
        raise ValueError(f"these params are {what}: pass the rank's mesh (mesh=)")
    lay = params["layers"][0] if params.get("layers") else {}
    hd = cfg.head_size
    want = {"wqkv": (cfg.n_heads + 2 * cfg.n_kv_heads) * hd, "wq": cfg.n_heads * hd}
    for k, rows in want.items():
        if k in lay and lay[k].shape[-2] != rows:
            raise ValueError(f"{k} has {lay[k].shape[-2]} rows, the config {rows}: these "
                             "params hold a tp rank's slice; pass it as a RankSlice with the "
                             "rank's mesh (mesh=)")


def rank_params(params: dict, cfg: ModelConfig, mesh, device, fuse: bool = True):
    """A rank's tree on `device` and what its forward needs: (tree, TPCtx
    or None at tp = 1, the rank's config). `params` is either the whole
    tree, which is cut to the rank's stage (`pipeline.stage_cut`), fused
    with the rows interleaved per tp rank (with `fuse`), cut (`shard_params`)
    and then moved, or this rank's `RankSlice` (from `shard_params` or
    `distributed.load_params_sharded`, which fuses), which is moved as it
    is. The tree comes back a `RankSlice`."""
    from ..models.base import fuse_params, params_to
    from .pipeline import stage_cut
    from .tp_forward import TPCtx, localize_cfg

    tp, pp, stage = mesh.tp, mesh.pp, mesh.stage
    rank = mesh.group.rank if tp > 1 else 0
    if isinstance(params, RankSlice):
        if (params.tp, params.rank, params.pp, params.stage) != (tp, rank, pp, stage):
            raise ValueError(f"params are tp rank {params.rank} of {params.tp}, stage "
                             f"{params.stage} of {params.pp}; the mesh wants tp rank {rank} of "
                             f"{tp}, stage {stage} of {pp}")
        vocab = params.vocab
        local = params_to(dict(params), device)
    else:
        check_whole(params, cfg)
        params = stage_cut(params, cfg, pp, stage)
        if fuse:
            params = fuse_params(params, tp)
        vocab = vocab_flags(params, tp)
        local = params_to(dict(shard_params(params, cfg, tp, rank)), device)
    ctx = TPCtx(mesh.group, *vocab) if tp > 1 else None
    return RankSlice(local, tp, rank, vocab, pp, stage), ctx, localize_cfg(cfg, tp)


def check_q4s_rank(params: dict, tp: int) -> None:
    """Raise, naming the weight, where q4s under tp would not equal the cut
    of the whole converted tree: a row-parallel q4 weight (wo, w2) whose
    whole K is a multiple of K5's 256-group, so that one device converts
    it, but whose rank slice of K is not."""
    from ..ops.w8a8 import GROUP

    for i, d in enumerate(params["layers"]):
        for k in ROW_PARALLEL:
            w = d.get(k)
            if isinstance(w, QArray) and w.fmt == "q4" and w.data.dim() == 2:
                local = w.shape[-1]
                if (local * tp) % GROUP == 0 and local % GROUP:
                    raise ValueError(
                        f"layers[{i}].{k}: a rank's K of {local} (the whole {local * tp} over "
                        f"tp={tp}) is no multiple of {GROUP}: q4s under tp cuts K5's "
                        f"{GROUP}-groups of K over the ranks")
