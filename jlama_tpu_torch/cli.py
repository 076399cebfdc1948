"""jlama-tpu's command line on the port: chat, complete, serve, download,
quantize, list, rm, version.

    python -m jlama_tpu_torch.cli <command> [options]

The counterpart of `jlama_tpu/cli.py`, with its parser's options and
defaults, its prompt building and its printed lines. `JLAMA_MODEL_HOME`
selects the model directory root (the JAX package's, so both list the same
models). One option is the port's own: `--device` (chat, complete, serve,
quantize), the counterpart of `JAX_PLATFORMS`: CUDA by default, and without
a card and without `--device cpu` a command exits with `resolve_device`'s
message.

The port's differences, each an exit with a message rather than a quiet
fall-back:

- `--pallas`: auto and on run q4 weights through K1 (the checkpoint's JQ4
  layout; the JAX package's TPU layout "q4k" has no counterpart), w8a8
  serves q4s (`weight_format="q4s"`, K5); off exits, since the port has no
  dequantizing path on the card;
- `serve --mesh D,P,T` is data, pipeline and tensor parallelism over
  `torch.distributed`, one process per rank, D · P · T ranks (rank r is tp
  rank r % T of stage (r // T) % P of dp group r // (P · T); D > 1 splits
  the slots and the KV pages into D groups, P > 1 the layers into P stages,
  T > 1 the weights, a MoE model's experts over T): rank 0 serves HTTP, the
  others replay its steps (`BatchScheduler.run_follower`). P > 1 serves
  through the pp ring (`runtime/pipelined.py::PipelinedScheduler`; the
  slots are rounded to a multiple of P, and `--itl-budget-ms` is ignored
  there), or with `--no-pp-pipeline` through the stage-serial
  `BatchScheduler`. Every rank runs `serve` with `--mesh`,
  `--num-processes D·P·T`, its
  `--process-id` and the same `--coordinator`
  (`host:port`, a TCP store that rank 0 serves, as the JAX package's
  coordinator; or `file:///path`, a file store); rank 0 binds the step
  channel on `--step-port` (default: the coordinator's port + 1000, 0 with
  a file store) and hands the port it got to the others through the store.
  Rank 0 started alone with `--num-processes D·P·T` (no `--process-id`)
  starts the other ranks itself, on a file store in a temporary directory,
  and waits for them when it exits. `--device cpu` gives gloo ranks on the
  CPU, else rank r runs on cuda:r over NCCL (`--device cuda:0`: every rank
  on that one GPU, over gloo through the host, since NCCL refuses that).
  Each rank reads only its stage's layers, cut to its tp slice, of the
  checkpoint, from the model directory or, where the model is an
  `http(s)://` URL, by ranged requests
  (`parallel/distributed.py::load_params_sharded`). Every weight format
  (`--pallas w8a8` too) and architecture one device serves is served, and
  `/v1/embeddings` answers through an `Engine` over each rank's tree, its
  calls replayed by the other ranks of dp group 0. `--mesh auto` serves
  the mesh the planner picks, its pp too;
- `--layer-mode` is accepted and changes nothing: the port's layers are
  always separate tensors.

`build_server(args)` builds the serving stack without blocking (`cmd_serve`
runs it).
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
import tempfile
import uuid
from pathlib import Path


def _resolve_model(name: str, args=None) -> Path:
    from .hub import default_model_home, model_dir_name

    p = Path(name)
    if p.exists():
        return p
    home = default_model_home()
    for cand in (home / name, home / model_dir_name(name)):
        if cand.exists():
            return cand
    if args is not None and getattr(args, "auto_download", False):
        from .hub import maybe_download_model

        print(f"downloading {name} from the Hub ...")
        try:
            return maybe_download_model(
                name, branch=getattr(args, "branch", "main"),
                token=getattr(args, "auth_token", None),
            )
        except FileNotFoundError:
            pass  # not a repo id: fall through to the clean error
    raise SystemExit(f"model not found: {name} (looked in {home})")


def _device(args):
    """The command's device: `--device`, else CUDA; exits with
    `resolve_device`'s message where there is none."""
    from .device import resolve_device

    try:
        return resolve_device(getattr(args, "device", None))
    except RuntimeError as e:
        raise SystemExit(f"{e} (the command line takes --device cpu)") from None


def _check_pallas(args) -> None:
    if getattr(args, "pallas", "auto") == "off":
        raise SystemExit(
            "--pallas off: the port has no dequantizing path on the card; q4 weights run "
            "through its q4 kernel (auto or on), q4s through its w8a8 kernel (w8a8)")


def _load(args):
    """(params, cfg, tokenizer, model_dir, device) for a model command."""
    import torch

    from .models.loader import load_params
    from .tokenizers import load_tokenizer

    _check_pallas(args)
    device = _device(args)
    model_dir = _resolve_model(args.model, args)
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[args.working_dtype]
    params, cfg = load_params(model_dir, device=device, float_dtype=dtype)
    tokenizer = load_tokenizer(model_dir)
    return params, cfg, tokenizer, model_dir, device


def _engine(args):
    from .runtime.engine import Engine

    params, cfg, tokenizer, _, device = _load(args)
    return Engine(params, cfg, tokenizer, device=device, max_seq_len=args.context), tokenizer


def cmd_chat(args) -> None:
    from .prompt import PromptBuilder

    eng, tokenizer = _engine(args)
    session = str(uuid.uuid4())
    print("Chatting (ctrl-d to exit)")
    first = True
    while True:
        try:
            user = input("> ")
        except EOFError:
            break
        if not user.strip():
            continue
        b = PromptBuilder(tokenizer.spec)
        if first and args.system:
            b.add_system(args.system)
        b.add_user(user)
        prompt = b.build().prompt
        ids = tokenizer.encode(prompt)

        def stream(tok, ms):
            print(tokenizer.decode([tok]), end="", flush=True)

        resp = eng.generate_tokens(
            ids,
            max_new_tokens=args.max_tokens,
            temperature=args.temperature,
            top_p=args.top_p,
            session_id=session,
            on_token=stream,
        )
        print(
            f"\n[{resp.generated_tokens} tokens, "
            f"{resp.generate_time_ms / max(resp.generated_tokens, 1):.0f} ms/token]"
        )
        first = False


def cmd_complete(args) -> None:
    eng, tokenizer = _engine(args)
    ids = tokenizer.encode(args.prompt)
    resp = eng.generate_tokens(
        ids,
        max_new_tokens=args.max_tokens,
        temperature=args.temperature,
        top_p=args.top_p,
    )
    print(args.prompt + resp.response_text)
    print(
        f"\n[prompt {resp.prompt_tokens} tok {resp.prompt_time_ms:.0f} ms; "
        f"generated {resp.generated_tokens} tok "
        f"{resp.generate_time_ms:.0f} ms]",
        file=sys.stderr,
    )


_PARALLEL_OPTS = ("coordinator", "num_processes", "process_id", "step_port")
_QUEUE = "ROADMAP queue 1 item 3, module 10"


def _serve_mesh(args) -> tuple[int, int, int]:
    """The (dp, pp, tp) that `serve` runs at ((1, 1, 1): one device), from
    `--mesh`; exits where the mesh or the options ask for what cannot run."""
    if args.mesh is None:
        dp = pp = tp = 1
    elif args.mesh == "auto":
        from .config import load_config
        from .parallel.mesh import plan_mesh_axes

        model_dir = _resolve_model(args.model, args)
        import torch

        n = args.num_processes or (1 if args.device == "cpu"
                                   else max(1, torch.cuda.device_count()))
        wbytes = sum(f.stat().st_size for f in model_dir.glob("*.safetensors"))
        dp, pp, tp = plan_mesh_axes(n, load_config(model_dir), weight_bytes=wbytes or None)
        print(f"auto mesh over {n} devices: dp={dp} pp={pp} tp={tp}")
    else:
        try:
            dp, pp, tp = (int(x) for x in args.mesh.split(","))
        except ValueError:
            raise SystemExit(f"--mesh {args.mesh!r}: expected DP,PP,TP or auto") from None
    if dp < 1 or pp < 1 or tp < 1:
        raise SystemExit(f"--mesh {args.mesh!r}: each axis must be at least 1")
    from .st import is_url

    if pp > 1 and not is_url(args.model):
        from .config import load_config

        n_layers = load_config(_resolve_model(args.model, args)).n_layers
        if n_layers % pp:  # the JAX pipeline's check, before any rank starts
            raise SystemExit(f"--mesh dp={dp},pp={pp},tp={tp}: n_layers must divide by pp "
                             f"(n_layers={n_layers})")
    world = dp * pp * tp
    given = [o for o in _PARALLEL_OPTS if getattr(args, o, None) is not None]
    if world == 1 and given:
        flags = ", ".join("--" + o.replace("_", "-") for o in given)
        raise SystemExit(f"{flags}: multi-process serving is mesh serving; give --mesh D,P,T "
                         f"with D * P * T > 1 ({_QUEUE})")
    if world > 1 and (args.num_processes or world) != world:
        raise SystemExit(f"--num-processes {args.num_processes} != dp * pp * tp = {world}: one "
                         "process a rank")
    return dp, pp, tp


def rank_argv(argv: list[str], rank: int, world: int, coordinator: str) -> list[str]:
    """The command line of rank `rank` as rank 0 starts it (argparse keeps
    the last of a repeated option)."""
    return list(argv) + ["--num-processes", str(world), "--process-id", str(rank),
                         "--coordinator", coordinator]


def _mesh_stack(args, dp: int, pp: int, tp: int):
    """Join the dp × pp × tp world (rank r: tp rank r % tp of stage
    (r // tp) % pp of dp group r // (pp · tp)), read this rank's slice of
    the checkpoint, open the step channel, and build this rank's scheduler
    (the `PipelinedScheduler` where pp > 1, unless `--no-pp-pipeline`) with
    its embeddings `Engine` over the same tree. Returns (sched, tokenizer,
    model_dir, channel)."""
    import torch

    from .parallel.distributed import LOAD_STATS, init_mesh_group, load_params_sharded
    from .runtime.coordination import StepChannel, coordinator_host, default_step_port
    from .runtime.engine import Engine
    from .runtime.scheduler import BatchScheduler
    from .st import is_url
    from .tokenizers import load_tokenizer

    _check_pallas(args)
    world = dp * pp * tp
    rank, coord = args.process_id, args.coordinator
    if rank is None or coord is None:
        raise SystemExit(f"--mesh {dp},{pp},{tp}: every rank takes --process-id and the same "
                         "--coordinator (host:port or file:///path); or start rank 0 alone "
                         f"with --num-processes {world}")
    if not 0 <= rank < world:
        raise SystemExit(f"--process-id {rank}: expected 0..{world - 1}")
    local = coord.startswith("file://")
    backend = _shared_gpu_backend(args.device)
    if backend == "gloo":
        _say(rank, f"warning: every rank of this host shares {args.device} over gloo: each "
                   "collective and stage hand-over goes through host memory, many times "
                   "slower than NCCL with one GPU a rank (leave out --device for that)",
             err=True)
    try:
        mesh = init_mesh_group(dp, tp, rank, pp=pp, device=args.device, backend=backend,
                               store_path=coord[len("file://"):] if local else None,
                               init_method=None if local else f"tcp://{coord}")
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"rank {rank}: {e}") from None
    group = mesh.group
    where = f"dp group {mesh.dp_index}" + (f", stage {mesh.stage}" if pp > 1 else "")
    print(f"rank {rank}/{world}: {group.backend} on {group.device} ({where}, tp rank "
          f"{group.rank})", flush=True)
    # a model URL is read by ranged requests, each rank its ranges
    model_dir = args.model if is_url(args.model) else _resolve_model(args.model, args)
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[args.working_dtype]
    # each rank reads only its stage's layers of its tp slice, on the host, then moves it
    try:
        params, cfg = load_params_sharded(model_dir, None, mesh, device="cpu",
                                          float_dtype=dtype)
    except (NotImplementedError, ValueError) as e:
        raise SystemExit(f"rank {rank}: {e}") from None
    print(f"rank {rank}: read {LOAD_STATS['bytes_loaded']} of the checkpoint's "
          f"{LOAD_STATS['payload']} payload bytes", flush=True)
    tokenizer = load_tokenizer(model_dir)
    if rank == 0:
        port = args.step_port if args.step_port is not None else (
            0 if local else default_step_port(coord))
        chan = StepChannel.serve(
            port, world - 1, on_bound=lambda p: group.store.set("jlama_step_port", str(p)))
    else:
        host = "127.0.0.1" if local else coordinator_host(coord)
        chan = StepChannel.connect(host, int(group.store.get("jlama_step_port")))
    kv_dtype = {"bf16": torch.bfloat16, "f32": torch.float32, "q8": "q8"}[args.kv_dtype]
    kw = dict(n_pages=args.kv_pages, page_size=args.page_size, max_seq_len=args.context,
              kv_dtype=kv_dtype, weight_format="q4s" if args.pallas == "w8a8" else None,
              mesh=mesh, step_channel=chan, device=group.device)
    try:
        if pp > 1 and not args.no_pp_pipeline:
            from .runtime.pipelined import PipelinedScheduler

            slots = args.batch_slots
            if slots % (dp * pp):
                slots = dp * pp * max(1, slots // (dp * pp))
                _say(rank, f"batch-slots rounded to {slots} (divisible by pp)")
            _say(rank, f"pp={pp} pipeline decode enabled ({slots // (dp * pp)} "
                       "rows/microbatch)")
            if args.itl_budget_ms:
                _say(rank, "warning: --itl-budget-ms is ignored on the pp pipeline path "
                           "(fixed tick window); use --no-pp-pipeline for the budgeted "
                           "scheduler", err=True)
                args.itl_budget_ms = 0.0
            sched = PipelinedScheduler(params, cfg, tokenizer, n_slots=slots, **kw)
        else:
            sched = BatchScheduler(params, cfg, tokenizer, n_slots=args.batch_slots, **kw)
    except (NotImplementedError, ValueError) as e:
        chan.close()
        raise SystemExit(f"rank {rank}: {e}") from None
    del params
    # one copy of the layer weights: the scheduler's rank tree, which the
    # embeddings Engine shares (its calls go over the step channel)
    sched.embed_engine = Engine(
        sched.params, cfg, tokenizer, device=sched.device, max_seq_len=args.context,
        fuse=False, moe_ragged=False, mesh=mesh, step_channel=chan,
        step_lock=sched._lock)
    return sched, tokenizer, model_dir, chan


def _shared_gpu_backend(device, device_count: int | None = None) -> str | None:
    """gloo where every rank is told to run on one GPU (`--device cuda:N`)
    on a host that has only that one (`device_count`, torch's count unless
    given), which NCCL refuses; None (the device's default) otherwise, so
    that on a host of several GPUs NCCL's device check refuses two ranks on
    one GPU rather than the mesh quietly running through host memory."""
    import torch

    dev = torch.device(device) if device is not None else None
    if dev is None or dev.type != "cuda" or dev.index is None:
        return None
    count = torch.cuda.device_count() if device_count is None else device_count
    return "gloo" if count == 1 else None


def _say(rank: int, msg: str, err: bool = False) -> None:
    """A message of the JAX CLI, printed by rank 0 only."""
    if rank == 0:
        print(msg, file=sys.stderr if err else sys.stdout, flush=True)


def build_server(args):
    """The serving stack of `serve` without starting it: the scheduler over
    the fused tree (q4s with `--pallas w8a8`), its `embed_engine` sharing
    that tree, pre-warmed to `--prewarm` tokens, behind an `OpenAIServer`.
    Returns (server, model_dir). With `--mesh D,P,T` (D · P · T > 1), rank 0
    gets the mesh scheduler's server (its embeddings engine's calls replayed
    by the ranks of dp group 0); a rank > 0 replays rank 0's steps until it
    stops, and gets (None, model_dir)."""
    import torch

    from .runtime.engine import Engine
    from .runtime.scheduler import BatchScheduler
    from .server.openai_api import OpenAIServer

    dp, pp, tp = _serve_mesh(args)
    if dp * pp * tp > 1:
        from .parallel.distributed import shutdown

        sched, tokenizer, model_dir, chan = _mesh_stack(args, dp, pp, tp)
        if args.process_id > 0:
            print(f"follower {args.process_id} ready", flush=True)
            try:
                sched.run_follower()
            except ConnectionError as e:
                # rank 0 is gone: exit non-zero so that the set is restarted
                raise SystemExit(f"follower {args.process_id}: {e}") from None
            finally:
                chan.close()
                shutdown()
            return None, model_dir
        _tune(sched, args)
        server = OpenAIServer(sched, tokenizer, model_name=Path(str(model_dir)).name)
        server.step_channel = chan  # closed by cmd_serve: the followers' stop
        return server, model_dir
    params, cfg, tokenizer, model_dir, device = _load(args)
    kv_dtype = {"bf16": torch.bfloat16, "f32": torch.float32, "q8": "q8"}[args.kv_dtype]
    sched = BatchScheduler(
        params,
        cfg,
        tokenizer,
        n_slots=args.batch_slots,
        n_pages=args.kv_pages,
        page_size=args.page_size,
        max_seq_len=args.context,
        kv_dtype=kv_dtype,
        weight_format="q4s" if args.pallas == "w8a8" else None,
        device=device,
    )
    # one copy of the layer weights stays live: the scheduler's fused tree,
    # which the embeddings Engine shares (fuse=False: already fused)
    del params
    sched.embed_engine = Engine(
        sched.params, sched.cfg, tokenizer, device=sched.device, max_seq_len=args.context,
        fuse=False, moe_ragged=False,
    )
    _tune(sched, args)
    return OpenAIServer(sched, tokenizer, model_name=model_dir.name), model_dir


def _tune(sched, args) -> None:
    """The serving knobs, then the pre-warm (under tp its steps go to every
    rank)."""
    if args.itl_budget_ms:
        sched.itl_budget_ms = args.itl_budget_ms
    if args.prefill_fair_rows:
        sched.prefill_fair_rows = args.prefill_fair_rows
    if args.prewarm:
        import time as _time

        t0 = _time.perf_counter()
        print(f"pre-warming serving shapes to {args.prewarm} tokens ...")
        sched.warmup(max_context=args.prewarm)
        print(f"pre-warm done in {_time.perf_counter() - t0:.1f}s")


def cmd_serve(args) -> None:
    ranks, store_dir = [], None
    if args.mesh is not None and args.process_id is None and (args.num_processes or 0) > 1:
        # rank 0 started alone: it starts the other ranks on a file store
        dp, pp, tp = _serve_mesh(args)
        world = dp * pp * tp
        coord = args.coordinator
        if coord is None:
            store_dir = tempfile.mkdtemp(prefix="jlama_tp_")
            coord = "file://" + str(Path(store_dir) / "store")
        for r in range(1, world):
            ranks.append(subprocess.Popen([sys.executable, "-m", "jlama_tpu_torch.cli",
                                           *rank_argv(args.argv, r, world, coord)]))
            print(f"started rank {r}/{world} (pid {ranks[-1].pid})", flush=True)
        args.process_id, args.coordinator = 0, coord
    try:
        server, model_dir = build_server(args)
        if server is None:  # a follower rank whose leader has stopped
            return
        print(f"Serving {Path(str(model_dir)).name} on http://{args.host}:{args.port}")
        try:
            server.run(host=args.host, port=args.port)
        finally:
            chan = getattr(server, "step_channel", None)
            if chan is not None:
                chan.close()  # publishes stop: the followers return
    finally:
        for p in ranks:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
        if store_dir is not None:
            shutil.rmtree(store_dir, ignore_errors=True)


def cmd_download(args) -> None:
    from .hub import download_model

    def progress(name, done, total):
        # files download in parallel threads: only completion lines print
        if total > 0 and done >= total:
            print(f"{name}: done ({total // (1 << 20)} MiB)", flush=True)

    out = download_model(
        args.model, branch=args.branch, token=args.auth_token, progress=progress
    )
    print(f"\nDownloaded to {out}")


def cmd_quantize(args) -> None:
    from .quant.quantizer import quantize_model

    device = _device(args)
    model_dir = _resolve_model(args.model)

    def progress(name, i, n):
        print(f"\r[{i}/{n}] {name[:60]:60s}", end="", flush=True)

    out = quantize_model(
        model_dir,
        out_dir=args.output,
        quantize_to=args.quantize_to,
        skip_prefixes=tuple(args.skip_prefix or ()),
        drop_prefixes=tuple(args.drop_prefix or ()),
        progress=progress,
        device=device,
    )
    print(f"\nQuantized model written to {out}")


def cmd_list(args) -> None:
    from .hub import default_model_home, list_models

    for name in list_models():
        print(name)
    if not list_models():
        print(f"(no models in {default_model_home()})", file=sys.stderr)


def cmd_rm(args) -> None:
    from .hub import default_model_home, model_dir_name

    home = default_model_home()
    for cand in (home / args.model, home / model_dir_name(args.model)):
        if cand.exists():
            shutil.rmtree(cand)
            print(f"Removed {cand}")
            return
    raise SystemExit(f"model not found: {args.model}")


def cmd_version(args) -> None:
    from . import __version__

    print(f"jlama-tpu {__version__}")


def _add_device_opt(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu: the plain PyTorch versions of the "
                        "kernels, for small models")


def _add_model_opts(p: argparse.ArgumentParser) -> None:
    p.add_argument("model", help="model directory or HF id (under model home)")
    p.add_argument("--working-dtype", choices=["bf16", "f32"], default="bf16")
    p.add_argument("--context", type=int, default=4096)
    p.add_argument("--pallas", choices=["auto", "on", "off", "w8a8"],
                   default="auto",
                   help="auto and on: q4 weights through the q4 kernel (K1); w8a8: "
                        "serve the q4s W4A8 format through the w8a8 kernel (K5), on one "
                        "device or a mesh; off exits (no dequantizing path on the card)")
    p.add_argument("--layer-mode", choices=["scan", "unrolled"], default="scan",
                   help="accepted for the JAX package's command line; the port's layers "
                        "are always separate tensors")
    p.add_argument("--auto-download", action="store_true",
                   help="fetch the model from the HF Hub when the name is a "
                        "repo id not present locally (parallel ranged download)")
    p.add_argument("--branch", default="main")
    p.add_argument("--auth-token", default=None)
    _add_device_opt(p)


def _add_gen_opts(p: argparse.ArgumentParser) -> None:
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top-p", type=float, default=1.0)
    p.add_argument("--max-tokens", type=int, default=512)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="jlama-tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("chat", help="interactive chat with KV session reuse")
    _add_model_opts(p)
    _add_gen_opts(p)
    p.add_argument("--system", default=None)
    p.set_defaults(fn=cmd_chat)

    p = sub.add_parser("complete", help="one-shot text completion")
    _add_model_opts(p)
    _add_gen_opts(p)
    p.add_argument("prompt")
    p.set_defaults(fn=cmd_complete)

    p = sub.add_parser("serve", help="OpenAI-compatible REST API server")
    _add_model_opts(p)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--batch-slots", type=int, default=16)
    p.add_argument("--kv-pages", type=int, default=512)
    p.add_argument("--page-size", type=int, default=64)
    p.add_argument(
        "--kv-dtype",
        choices=["bf16", "f32", "q8"],
        default="bf16",
        help="KV cache storage dtype; q8 halves the memory per cached token "
        "(block-32 int8, dequantized in attention)",
    )
    p.add_argument("--mesh", default=None, metavar="DP,PP,TP",
                   help="data, pipeline and tensor parallelism over one process a rank, "
                        "D,P,T (each rank reads only its stage's layers of its slice of the "
                        "checkpoint, locally or by ranged HTTP), or auto (the planner)")
    p.add_argument("--coordinator", default=None,
                   help="the ranks' rendezvous: host:port (a TCP store rank 0 serves) or "
                        "file:///path (a file store)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="ranks in all (dp * pp * tp); rank 0 alone with it starts the others")
    p.add_argument("--process-id", type=int, default=None, help="this process's rank")
    p.add_argument("--step-port", type=int, default=None,
                   help="rank 0's TCP port for the step channel (default: the "
                        "coordinator's port + 1000; 0 with a file store: any free port)")
    p.add_argument("--no-pp-pipeline", action="store_true",
                   help="with pp>1: run each step stage by stage (the BatchScheduler over "
                        "the layer-sharded stages) instead of the pipelined tick windows")
    p.add_argument("--prewarm", type=int, default=0, metavar="TOKENS",
                   help="run every serving shape up to this many context tokens once "
                        "before accepting requests (on the card: capture the decode graphs)")
    p.add_argument("--itl-budget-ms", type=float, default=0.0,
                   help="inter-token latency budget: caps the chained decode window "
                        "depth so token delivery intervals stay under this many ms "
                        "(0 = throughput-first)")
    p.add_argument("--prefill-fair-rows", type=int, default=0,
                   help="cap how many requests each batched prefill call "
                        "advances (FIFO), bounding TTFT at high concurrency for "
                        "some prefill-throughput cost (0 = unlimited batching)")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("download", help="download a model from HuggingFace")
    p.add_argument("model")
    p.add_argument("--branch", default="main")
    p.add_argument("--auth-token", default=None)
    p.set_defaults(fn=cmd_download)

    p = sub.add_parser("quantize", help="offline quantization to JQ4/I8")
    p.add_argument("model")
    p.add_argument("--output", default=None)
    p.add_argument("--quantize-to", choices=["q4", "i8"], default="q4")
    p.add_argument("--skip-prefix", action="append")
    p.add_argument("--drop-prefix", action="append")
    _add_device_opt(p)
    p.set_defaults(fn=cmd_quantize)

    p = sub.add_parser("list", help="list downloaded models")
    p.set_defaults(fn=cmd_list)

    p = sub.add_parser("rm", help="remove a downloaded model")
    p.add_argument("model")
    p.set_defaults(fn=cmd_rm)

    p = sub.add_parser("version", help="print version")
    p.set_defaults(fn=cmd_version)
    return ap


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    args.argv = argv
    args.fn(args)


if __name__ == "__main__":
    main()
