"""The captured decode steps and prefills (`jlama_tpu_torch/runtime/
graphs.py`) against the same steps run eagerly, on the card: ids, logits and
caches bit for bit, the kernels' launch counts per replay, a recycled cache
slot, the warm-up's captures, a failed capture, and the decode loop's exit
at a stop id within its bound.

Marked `cuda`: each test skips where torch has no CUDA device (as on the CPU
test runs); on a machine with an NVIDIA GPU run them with
`python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_graphs.py -m cuda -q`
after tests/test_torch_cuda_kernels.py or alone. The model is Llama-3.2-1B's
width cut to 2 layers, random JQ4 weights from a seed.
"""

import dataclasses

import pytest
import torch

pytestmark = pytest.mark.cuda

PROMPT_LEN = 100


@pytest.fixture(scope="module")
def model():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs and the kernels run only there)")
    torch.backends.cuda.matmul.allow_tf32 = False
    from jlama_tpu_torch.models.init import llama_1b_config, random_q4_params

    cfg = dataclasses.replace(llama_1b_config(), n_layers=2)
    return random_q4_params(cfg, seed=0, device="cuda"), cfg


def _launches():
    from jlama_tpu_torch.runtime.graphs import kernel_wrappers

    return {fn.__name__: fn.launches for fn in kernel_wrappers()}


def _recorded(monkeypatch, module, rows, vocab, n=96):
    """Record every decode step's logits on the device, captured with the
    step: `module.lm_logits` wrapped to copy its [rows, V] output into the
    next row of a [n, rows, V] buffer, through a device-side counter."""
    rec = torch.full((n, rows, vocab), float("nan"), device="cuda")
    ctr = torch.zeros(1, dtype=torch.int64, device="cuda")
    inner = module.lm_logits

    def lm_logits(params, cfg, hidden):
        out = inner(params, cfg, hidden)
        rec.index_copy_(0, ctr, out[:, 0][None])
        ctr.add_(1)
        return out

    monkeypatch.setattr(module, "lm_logits", lm_logits)
    return rec, ctr


def _prompt(cfg, n, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist()


@pytest.mark.parametrize("sampled", [False, True])
def test_engine_replay_equals_eager(model, monkeypatch, sampled):
    """64 tokens after a 100-token prompt in two chunks of 32 (one window,
    256: the key's first step runs eagerly, the other 63 are replays),
    greedy and seeded: ids, logits and launch counts of the graphs equal the
    eager run's."""
    from jlama_tpu_torch.runtime import engine as engine_mod
    from jlama_tpu_torch.runtime.engine import Engine

    params, cfg = model
    kw = dict(temperature=0.8, top_k=40, top_p=0.95, seed=3) if sampled else {}
    prompt = _prompt(cfg, PROMPT_LEN, 1)
    out = {}
    for graphs in (True, False):
        eng = Engine(params, cfg, device="cuda", max_seq_len=512, decode_graphs=graphs)
        rec, ctr = _recorded(monkeypatch, engine_mod, 1, cfg.vocab_size)
        before = _launches()
        r = eng.generate_tokens(prompt, max_new_tokens=64, stop_ids=set(), **kw)
        torch.cuda.synchronize()
        launches = {k: v - before[k] for k, v in _launches().items()}
        out[graphs] = (r.token_ids, rec[:64].cpu(), launches, eng.graphs.stats(), int(ctr))
        monkeypatch.undo()
    (ids_g, lg_g, n_g, st_g, c_g), (ids_e, lg_e, n_e, st_e, c_e) = out[True], out[False]
    assert len(ids_g) == 64 and ids_g == ids_e
    assert c_g == c_e == 64 and torch.equal(lg_g, lg_e) and torch.isfinite(lg_g).all()
    assert n_g == n_e and n_g["q4_matmul"] == 64 * (4 * cfg.n_layers + 1) \
        + 4 * cfg.n_layers  # the 99-token prefill's four per layer too
    assert st_e["graphs"] == 0 and st_e["eager_steps"] == 64
    assert st_g["eager_steps"] == st_g["keys"] >= 1 and st_g["graphs"] == st_g["keys"]
    assert st_g["replays"] == 64 - st_g["eager_steps"] and st_g["pool_bytes"] > 0


def test_engine_recycled_slot_captures_nothing_new(model):
    from jlama_tpu_torch.runtime.engine import Engine

    params, cfg = model
    eng = Engine(params, cfg, device="cuda", max_seq_len=512)
    a = eng.generate_tokens(_prompt(cfg, PROMPT_LEN, 1), max_new_tokens=40, session_id="a",
                            stop_ids=set())
    slot, st = eng.sessions["a"].slot, eng.graphs.stats()
    eng.drop_session("a")
    b = eng.generate_tokens(_prompt(cfg, PROMPT_LEN, 1), max_new_tokens=40, session_id="b",
                            stop_ids=set())
    st2 = eng.graphs.stats()
    assert eng.sessions["b"].slot == slot and b.token_ids == a.token_ids
    assert (st2["graphs"], st2["keys"], st2["eager_steps"]) == \
        (st["graphs"], st["keys"], st["eager_steps"])
    assert st2["replays"] == st["replays"] + 40


@pytest.mark.parametrize("fmt,sampled", [(None, False), ("q4s", False), (None, True)])
def test_scheduler_replay_equals_eager(model, monkeypatch, fmt, sampled):
    """16 slots, chained windows of 4, 16 requests of 40 tokens after
    prompts of 40-120: the windows cross the 128-token bucket. Driven
    inline, graphs against eager: ids, per-step logits and launch counts
    equal bit for bit (q4s: K5's decode route, a programmatic dependent
    launch, inside the graph). sampled: seeded draws with top-k and top-p,
    and a frequency penalty on one request (its steps run one at a time)."""
    from jlama_tpu_torch.runtime import scheduler as sched_mod
    from jlama_tpu_torch.runtime.scheduler import BatchScheduler, GenRequest, RequestState

    params, cfg = model
    g = torch.Generator().manual_seed(5)
    lens = torch.randint(40, 121, (16,), generator=g).tolist()
    assert max(lens) + 40 > 128 + 4  # the last windows lie past 128
    prompts = [_prompt(cfg, n, 10 + i) for i, n in enumerate(lens)]
    out = {}
    for graphs in (True, False):
        sched = BatchScheduler(params, cfg, device="cuda", n_slots=16, n_pages=64,
                               page_size=64, max_seq_len=512, decode_lag=4,
                               weight_format=fmt, decode_graphs=graphs)
        rec, ctr = _recorded(monkeypatch, sched_mod, 16, cfg.vocab_size)
        kw = [dict(temperature=0.8, top_k=40, top_p=0.95, seed=20 + i,
                   frequency_penalty=0.5 if i == 3 else 0.0) if sampled else {}
              for i in range(len(prompts))]
        reqs = [GenRequest(prompt_ids=p, max_new_tokens=40, **k) for p, k in zip(prompts, kw)]
        before = _launches()
        for r in reqs:
            sched.submit(r)
        for _ in range(400):
            if all(r.state == RequestState.DONE for r in reqs):
                break
            sched.step()
        torch.cuda.synchronize()
        n = int(ctr)
        launches = {k: v - before[k] for k, v in _launches().items()}
        out[graphs] = ([r.out_ids for r in reqs], rec[:n].cpu(), n, launches,
                       sched.graphs.stats(), sched.n_decode_steps, sched.n_prefill_calls)
        monkeypatch.undo()
        del sched
    (ids_g, lg_g, n_g, l_g, st_g, dec_g, pf_g), (ids_e, lg_e, n_e, l_e, st_e, dec_e, pf_e) = \
        out[True], out[False]
    # a seeded draw may hit an end-of-sequence id before 40 tokens
    assert all(len(x) == 40 or sampled and 1 <= len(x) < 40 for x in ids_g) and ids_g == ids_e
    assert n_g == n_e == dec_g == dec_e and torch.equal(lg_g, lg_e)
    assert torch.isfinite(lg_g).all()
    mm, other = ("q4s_matmul", "q4_matmul") if fmt else ("q4_matmul", "q4s_matmul")
    L = cfg.n_layers
    assert l_g == l_e and l_g[other] == 0
    assert l_g[mm] == pf_g * 4 * L + dec_g * (4 * L + 1)
    assert l_g["paged_decode"] == dec_g * L and l_g["kv_write"] == (pf_g + dec_g) * L
    assert st_g["eager_steps"] == st_g["keys"] >= 2 and st_g["graphs"] >= 2
    assert st_g["replays"] == dec_g - st_g["eager_steps"]
    assert st_e["graphs"] == 0 and st_e["eager_steps"] == dec_e


def test_scheduler_warmup_captures_every_window(model):
    from jlama_tpu_torch.runtime.scheduler import BatchScheduler

    params, cfg = model
    sched = BatchScheduler(params, cfg, device="cuda", n_slots=16, n_pages=64, page_size=64,
                           max_seq_len=512, decode_lag=4)
    wins = sched._window_buckets(512)
    sched.warmup(prefill_rows=(1,))
    st = sched.graphs.stats()
    # the 10 decode variants of every window (greedy and sampled, top-k,
    # top-p and penalties): first use, capture
    assert st["graphs"] == st["keys"] == 10 * len(wins)
    assert st["eager_steps"] == st["replays"] == 10 * len(wins)
    # every prefill key at one row: chunk 256 and the shorter buckets, each
    # in every window that holds it, once eager and once captured
    pf = sched.prefill_graphs.stats()
    n_pf = sum(w >= b for b in (16, 32, 64, 128, 256) for w in wins)
    assert pf["graphs"] == pf["keys"] == pf["eager_steps"] == pf["replays"] == n_pf


def test_failed_capture_raises_and_runs_no_eager_step(model, monkeypatch):
    """A host sync inside the step: the eager first use runs it, the capture
    at the second use raises, and nothing runs the step eagerly instead."""
    from jlama_tpu_torch.runtime import engine as engine_mod
    from jlama_tpu_torch.runtime.engine import Engine

    params, cfg = model
    eng = Engine(params, cfg, device="cuda", max_seq_len=512)
    inner = engine_mod.sample_token

    def sample_token(*a, **kw):
        out = inner(*a, **kw)
        out.sum().item()  # a host sync: illegal while the stream is capturing
        return out

    monkeypatch.setattr(engine_mod, "sample_token", sample_token)
    with pytest.raises(RuntimeError):
        eng.generate_tokens(_prompt(cfg, 20, 2), max_new_tokens=8, stop_ids=set())
    st = eng.graphs.stats()
    assert (st["eager_steps"], st["replays"], st["graphs"]) == (1, 0, 0)


@pytest.mark.parametrize("n", [100, 300])
def test_engine_prefill_replay_equals_eager(model, monkeypatch, n):
    """An n-token prompt (buckets 128 and 512) in three fresh sessions on one
    cache slot: the prefill key's first use runs eagerly, the second captures
    and replays, the third replays. After each, the slot's cache and the
    first token's logits equal an eager Engine's bit for bit."""
    from jlama_tpu_torch.runtime import engine as engine_mod
    from jlama_tpu_torch.runtime.engine import Engine

    params, cfg = model
    prompt = _prompt(cfg, n, 7)
    out = {}
    for graphs in (True, False):
        eng = Engine(params, cfg, device="cuda", max_seq_len=512, decode_graphs=graphs)
        rec, ctr = _recorded(monkeypatch, engine_mod, 1, cfg.vocab_size)
        runs = []
        for sid in ("a", "b", "c"):
            r = eng.generate_tokens(prompt, max_new_tokens=1, stop_ids=set(), session_id=sid)
            torch.cuda.synchronize()
            runs.append((r.token_ids, eng._slot_bufs[eng.sessions[sid].slot].clone()))
            eng.drop_session(sid)
        out[graphs] = (runs, rec[:3].cpu(), int(ctr), eng.prefill_graphs.stats())
        monkeypatch.undo()
    (runs_g, lg_g, c_g, st_g), (runs_e, lg_e, c_e, st_e) = out[True], out[False]
    assert c_g == c_e == 3 and torch.equal(lg_g, lg_e) and torch.isfinite(lg_g).all()
    for (ids_g, buf_g), (ids_e, buf_e) in zip(runs_g, runs_e):
        assert ids_g == ids_e and torch.equal(buf_g, buf_e)
    assert (st_g["keys"], st_g["eager_steps"], st_g["graphs"], st_g["replays"]) == (1, 1, 1, 2)
    assert st_g["pool_bytes"] > 0 and (st_e["graphs"], st_e["eager_steps"]) == (0, 3)


def test_engine_stop_exit_within_bound(model):
    """A greedy request whose continuation reaches a stop id in the first six
    steps of a 32-step chunk: the ids equal a run without stop ids up to the stop,
    and the chunk ran at most `steps_after_stop_bound()` steps past it."""
    from jlama_tpu_torch.runtime.device_loop import steps_after_stop_bound
    from jlama_tpu_torch.runtime.engine import Engine

    params, cfg = model
    prompt = _prompt(cfg, PROMPT_LEN, 3)
    eng = Engine(params, cfg, device="cuda", max_seq_len=512)
    free = eng.generate_tokens(prompt, max_new_tokens=32, stop_ids=set(), session_id="f")
    eng.drop_session("f")
    ids = free.token_ids
    # the last of the first six tokens that no earlier one repeats (the first
    # token at least: random weights may repeat one token throughout)
    k = max(i for i in range(6) if ids[i] not in ids[:i])
    before = eng.graphs.stats()
    r = eng.generate_tokens(prompt, max_new_tokens=32, stop_ids={ids[k]}, session_id="s")
    st = eng.graphs.stats()
    steps = st["eager_steps"] + st["replays"] - before["eager_steps"] - before["replays"]
    assert r.token_ids == ids[:k + 1] and r.finish_reason.name == "STOP_TOKEN"
    assert int(eng._in.steps[0]) == steps
    assert k + 1 <= steps <= k + 1 + steps_after_stop_bound() < 32
    assert eng.sessions["s"].position == PROMPT_LEN - 1 + k + 1


@pytest.fixture(scope="module")
def moe_model():
    """Mixtral-8x7B's layout at a narrow width: 2 layers, hidden 1024, head
    size 128, 8 experts of intermediate 1792, top-2; random JQ4 weights."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs and the kernels run only there)")
    torch.backends.cuda.matmul.allow_tf32 = False
    from jlama_tpu_torch.models.init import mixtral_8x7b_config, random_q4_params

    cfg = dataclasses.replace(mixtral_8x7b_config(), n_layers=2, embedding_length=1024,
                              hidden_length=1792, n_heads=8, n_kv_heads=2)
    return random_q4_params(cfg, seed=0, device="cuda"), cfg


def test_moe_engine_replay_equals_eager(moe_model, monkeypatch):
    """The MoE decode step (router, top-k, K6's grouping and two matmul
    launches a layer: gate and up in one, down) is captured: 48 greedy
    tokens after a 100-token prompt, ids, logits and launch counts of the
    graphs equal the eager run's."""
    from jlama_tpu_torch.runtime import engine as engine_mod
    from jlama_tpu_torch.runtime.engine import Engine

    params, cfg = moe_model
    prompt = _prompt(cfg, PROMPT_LEN, 1)
    out = {}
    for graphs in (True, False):
        eng = Engine(params, cfg, device="cuda", max_seq_len=512, decode_graphs=graphs)
        rec, ctr = _recorded(monkeypatch, engine_mod, 1, cfg.vocab_size)
        before = _launches()
        r = eng.generate_tokens(prompt, max_new_tokens=48, stop_ids=set())
        torch.cuda.synchronize()
        launches = {k: v - before[k] for k, v in _launches().items()}
        out[graphs] = (r.token_ids, rec[:48].cpu(), launches, eng.graphs.stats(), int(ctr))
        monkeypatch.undo()
    (ids_g, lg_g, n_g, st_g, c_g), (ids_e, lg_e, n_e, st_e, c_e) = out[True], out[False]
    L = cfg.n_layers
    assert len(ids_g) == 48 and ids_g == ids_e
    assert c_g == c_e == 48 and torch.equal(lg_g, lg_e) and torch.isfinite(lg_g).all()
    assert n_g == n_e
    assert n_g["moe_q4_matmul"] == (48 + 1) * 2 * L and n_g["moe_groups"] == (48 + 1) * L
    assert n_g["moe_gather"] == 2 * L  # the prefill (R = 200) only: decode steps take no gather
    assert n_g["q4_matmul"] == 48 * (2 * L + 1) + 2 * L  # wqkv, wo a layer; the lm_head
    assert st_g["eager_steps"] == st_g["keys"] >= 1 and st_g["replays"] == 48 - st_g["keys"]


def test_moe_scheduler_replay_equals_eager(moe_model, monkeypatch):
    """16 slots, chained windows of 4, 12 greedy requests of 24 tokens after
    prompts of 30-150 (decode R = 32 selections, prefill chunks of several
    rows): ids, per-step logits and launch counts of the graphs equal the
    eager run's bit for bit."""
    from jlama_tpu_torch.runtime import scheduler as sched_mod
    from jlama_tpu_torch.runtime.scheduler import BatchScheduler, GenRequest, RequestState

    params, cfg = moe_model
    g = torch.Generator().manual_seed(6)
    lens = torch.randint(30, 151, (12,), generator=g).tolist()
    prompts = [_prompt(cfg, n, 30 + i) for i, n in enumerate(lens)]
    out = {}
    for graphs in (True, False):
        sched = BatchScheduler(params, cfg, device="cuda", n_slots=16, n_pages=64,
                               page_size=64, max_seq_len=512, decode_lag=4,
                               decode_graphs=graphs)
        rec, ctr = _recorded(monkeypatch, sched_mod, 16, cfg.vocab_size)
        reqs = [GenRequest(prompt_ids=p, max_new_tokens=24) for p in prompts]
        before = _launches()
        for r in reqs:
            sched.submit(r)
        for _ in range(400):
            if all(r.state == RequestState.DONE for r in reqs):
                break
            sched.step()
        torch.cuda.synchronize()
        n = int(ctr)
        launches = {k: v - before[k] for k, v in _launches().items()}
        out[graphs] = ([r.out_ids for r in reqs], rec[:n].cpu(), n, launches,
                       sched.graphs.stats(), sched.n_decode_steps, sched.n_prefill_calls)
        monkeypatch.undo()
        del sched
    (ids_g, lg_g, n_g, l_g, st_g, dec_g, pf_g), (ids_e, lg_e, n_e, l_e, st_e, dec_e, _) = \
        out[True], out[False]
    L = cfg.n_layers
    assert all(len(x) == 24 for x in ids_g) and ids_g == ids_e
    assert n_g == n_e == dec_g == dec_e and torch.equal(lg_g, lg_e)
    assert l_g == l_e and l_g["moe_q4_matmul"] == (pf_g + dec_g) * 2 * L
    assert l_g["moe_groups"] == (pf_g + dec_g) * L
    # a gather before each matmul of a prefill chunk past the decode route's
    # threshold (R = 32 decode steps take none)
    assert 0 < l_g["moe_gather"] <= pf_g * 2 * L and l_g["moe_gather"] % (2 * L) == 0
    assert l_g["q4_matmul"] == pf_g * 2 * L + dec_g * (2 * L + 1)
    assert st_g["eager_steps"] == st_g["keys"] >= 1 and st_g["replays"] == dec_g - st_g["keys"]


@pytest.fixture(scope="module")
def float_moe_model(moe_model):
    """The same model with every weight dequantized to bf16 (float experts,
    as a bf16 checkpoint loads): the experts take the card's grouped
    product (`ops/moe_float.py`), the other projections a bf16 matmul."""
    from jlama_tpu_torch.models.init import random_float_params

    _, cfg = moe_model
    return random_float_params(cfg, seed=0, device="cuda"), cfg


def test_float_moe_engine_replay_equals_eager(float_moe_model, monkeypatch):
    """bf16 experts: the decode step (router, top-k, the grouping, one
    gather and three grouped products a layer, the scatter) is captured:
    48 greedy tokens after a 100-token prompt, ids, logits and launch counts
    of the graphs equal the eager run's bit for bit; no K1 or K6 matmul."""
    from jlama_tpu_torch.runtime import engine as engine_mod
    from jlama_tpu_torch.runtime.engine import Engine

    params, cfg = float_moe_model
    prompt = _prompt(cfg, PROMPT_LEN, 1)
    out = {}
    for graphs in (True, False):
        eng = Engine(params, cfg, device="cuda", max_seq_len=512, decode_graphs=graphs)
        rec, ctr = _recorded(monkeypatch, engine_mod, 1, cfg.vocab_size)
        before = _launches()
        r = eng.generate_tokens(prompt, max_new_tokens=48, stop_ids=set())
        torch.cuda.synchronize()
        launches = {k: v - before[k] for k, v in _launches().items()}
        out[graphs] = (r.token_ids, rec[:48].cpu(), launches, eng.graphs.stats(), int(ctr))
        monkeypatch.undo()
    (ids_g, lg_g, n_g, st_g, c_g), (ids_e, lg_e, n_e, st_e, c_e) = out[True], out[False]
    L = cfg.n_layers
    assert len(ids_g) == 48 and ids_g == ids_e
    assert c_g == c_e == 48 and torch.equal(lg_g, lg_e) and torch.isfinite(lg_g).all()
    assert n_g == n_e
    assert n_g["grouped_mm"] == (48 + 1) * 3 * L and n_g["moe_groups"] == (48 + 1) * L
    assert n_g["moe_gather"] == (48 + 1) * L
    assert n_g["moe_q4_matmul"] == n_g["q4_matmul"] == 0
    assert st_g["eager_steps"] == st_g["keys"] >= 1 and st_g["replays"] == 48 - st_g["keys"]


def test_float_moe_scheduler_replay_equals_eager(float_moe_model, monkeypatch):
    """bf16 experts through 16 slots, chained windows of 4, 12 greedy
    requests of 24 tokens after prompts of 30-150: ids, per-step logits and
    launch counts of the graphs equal the eager run's bit for bit."""
    from jlama_tpu_torch.runtime import scheduler as sched_mod
    from jlama_tpu_torch.runtime.scheduler import BatchScheduler, GenRequest, RequestState

    params, cfg = float_moe_model
    g = torch.Generator().manual_seed(6)
    lens = torch.randint(30, 151, (12,), generator=g).tolist()
    prompts = [_prompt(cfg, n, 30 + i) for i, n in enumerate(lens)]
    out = {}
    for graphs in (True, False):
        sched = BatchScheduler(params, cfg, device="cuda", n_slots=16, n_pages=64,
                               page_size=64, max_seq_len=512, decode_lag=4,
                               decode_graphs=graphs)
        rec, ctr = _recorded(monkeypatch, sched_mod, 16, cfg.vocab_size)
        reqs = [GenRequest(prompt_ids=p, max_new_tokens=24) for p in prompts]
        before = _launches()
        for r in reqs:
            sched.submit(r)
        for _ in range(400):
            if all(r.state == RequestState.DONE for r in reqs):
                break
            sched.step()
        torch.cuda.synchronize()
        n = int(ctr)
        launches = {k: v - before[k] for k, v in _launches().items()}
        out[graphs] = ([r.out_ids for r in reqs], rec[:n].cpu(), n, launches,
                       sched.n_decode_steps, sched.n_prefill_calls)
        monkeypatch.undo()
        del sched
    (ids_g, lg_g, n_g, l_g, dec_g, pf_g), (ids_e, lg_e, n_e, l_e, dec_e, _) = \
        out[True], out[False]
    L = cfg.n_layers
    assert all(len(x) == 24 for x in ids_g) and ids_g == ids_e
    assert n_g == n_e == dec_g == dec_e and torch.equal(lg_g, lg_e)
    assert l_g == l_e and l_g["grouped_mm"] == (pf_g + dec_g) * 3 * L
    assert l_g["moe_groups"] == l_g["moe_gather"] == (pf_g + dec_g) * L
    assert l_g["moe_q4_matmul"] == l_g["q4_matmul"] == 0
