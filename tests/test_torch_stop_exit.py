"""The decode loop's exit at a stop id (`jlama_tpu_torch/runtime/
device_loop.py`) against jlama_tpu's `make_decode_loop` (`lax.while_loop`
until every row is done) on the tiny Llama in f32, greedy: the ids and
n_valid of each row, a stop on the first step, a row that never stops, and
on the CPU the loop ending after the step in which every row is done; then
the `Engine`'s ids, finish and session position against jlama_tpu's
`Engine`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import make_tiny_llama
from tests.test_torch_bridge import port_tree

B, S, N = 3, 64, 12
PROMPTS = np.array([[1, 5, 9, 42, 7, 13], [1, 80, 3, 3, 61, 2], [1, 17, 120, 44, 9, 30]])


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    from jlama_tpu.models.loader import load_params
    from jlama_tpu_torch.config import load_config

    model_dir, _ = make_tiny_llama(tmp_path_factory.mktemp("tstop"))
    jp, jcfg = load_params(model_dir, float_dtype=jnp.float32)
    return jp, jcfg, port_tree(jp), load_config(model_dir)


def jax_loop(tiny, stops, n_steps=N):
    from jlama_tpu.models.base import KVCache, forward_hidden
    from jlama_tpu.runtime.device_loop import make_decode_loop, pad_stop_ids

    jp, jcfg, _, _ = tiny
    toks = jnp.asarray(PROMPTS, jnp.int32)
    pos = jnp.broadcast_to(jnp.arange(PROMPTS.shape[1], dtype=jnp.int32), PROMPTS.shape)
    cache = KVCache.init(jcfg, B, S, jnp.float32)
    _, cache = forward_hidden(jp, jcfg, toks[:, :-1], pos[:, :-1], cache, dtype=jnp.float32,
                              attn_window=S)
    loop = make_decode_loop(jcfg, jnp.float32)
    out, nval, _, _ = loop(jp, cache, toks[:, -1:], pos[:, -1:], jax.random.PRNGKey(0),
                           jnp.float32(0.0), jnp.int32(0), jnp.float32(1.0),
                           pad_stop_ids(stops), n_steps, S, True, True)
    out, nval = np.asarray(out), np.asarray(nval)
    return [out[b, :nval[b]].tolist() for b in range(B)], nval.tolist()


def port_loop(tiny, stops, n_steps=N):
    """The port's loop over B rows of a dense cache: (rows, n_valid, steps
    run, positions after the loop, the stop buffer's width)."""
    from jlama_tpu_torch.models.base import KVCache, forward_hidden, lm_logits
    from jlama_tpu_torch.nn.sampling import sample_token
    from jlama_tpu_torch.runtime.device_loop import decode_loop
    from jlama_tpu_torch.runtime.graphs import DecodeInputs, StepGraphs

    _, _, tp, tcfg = tiny
    toks = torch.from_numpy(PROMPTS)
    pos = torch.arange(PROMPTS.shape[1]).expand(B, -1)
    cache = KVCache.init(tcfg, B, S, torch.float32, "cpu")
    with torch.inference_mode():
        forward_hidden(tp, tcfg, toks[:, :-1], pos[:, :-1], cache, dtype=torch.float32,
                       attn_window=S)
    inp = DecodeInputs(B, "cpu", history=S, stops=True)
    inp.load(tokens=PROMPTS[:, -1:], positions=pos[:, -1:].numpy())
    width = inp.set_stops(stops)
    graphs = StepGraphs("cpu")

    def step():
        hidden, _ = forward_hidden(tp, tcfg, inp.tokens, inp.positions, cache,
                                   dtype=torch.float32, attn_window=S)
        nxt = sample_token(lm_logits(tp, tcfg, hidden[:, -1:, :])[:, 0], None, 0.0)
        inp.advance(nxt, width)
        return nxt

    with torch.inference_mode():
        rows, nval = decode_loop(graphs, "k", step, inp, 0, n_steps, set(stops))
    return rows, nval, graphs.stats()["eager_steps"], inp.positions[:, 0].tolist(), width


def _first_stop(row, stops):
    return next((i + 1 for i, t in enumerate(row) if t in stops), len(row))


@pytest.fixture(scope="module")
def free_run(tiny):
    rows, nval = jax_loop(tiny, [])
    assert nval == [N] * B
    return rows


def test_no_stop_runs_every_step(tiny, free_run):
    rows, nval, steps, positions, width = port_loop(tiny, set())
    assert rows == free_run and nval == [N] * B and steps == N and width == 8
    assert positions == [PROMPTS.shape[1] - 1 + N] * B


def test_first_step_stop_and_a_row_that_never_stops(tiny, free_run):
    r0, r1, r2 = free_run
    stops = {r0[0]}  # row 0 stops at its first step
    stops.add(next(t for t in r1[1:] if t not in r2 and t not in stops))
    assert not stops & set(r2)  # row 2 never stops
    want = [_first_stop(r, stops) for r in free_run]
    assert want[0] == 1 and 1 < want[1] and want[2] == N
    jrows, jnval = jax_loop(tiny, sorted(stops))
    rows, nval, steps, _, _ = port_loop(tiny, stops)
    assert jnval == nval == want and rows == jrows
    assert rows == [r[:n] for r, n in zip(free_run, want)]
    assert steps == N  # a row still runs: the loop does not exit


def test_loop_exits_after_the_step_that_finishes_every_row(tiny, free_run):
    """Every row stops: the loop ends after the last row's stop step, as the
    JAX loop does, and the positions advanced by the steps run."""
    stops = {free_run[0][0]}
    for r in free_run[1:]:
        if _first_stop(r, stops) == N:
            stops.add(r[N // 2])
    want = [_first_stop(r, stops) for r in free_run]
    assert max(want) < N and want[0] == 1
    jrows, jnval = jax_loop(tiny, sorted(stops))
    rows, nval, steps, positions, _ = port_loop(tiny, stops)
    assert jnval == nval == want and rows == jrows
    assert steps == max(want)
    assert positions == [PROMPTS.shape[1] - 1 + max(want)] * B


def test_wide_stop_sets_double_the_buffer(tiny, free_run):
    """Nine stop ids take a buffer of 16 (the JAX package's pad_stop_ids)."""
    from jlama_tpu.runtime.device_loop import pad_stop_ids

    stops = {free_run[0][0]} | set(range(1000, 1008))
    assert pad_stop_ids(stops).shape == (16,)
    jrows, jnval = jax_loop(tiny, sorted(stops))
    rows, nval, _, _, width = port_loop(tiny, stops)
    assert width == 16 and nval == jnval and rows == jrows


@pytest.mark.parametrize("stop_at", [0, 2, None])
def test_engine_stop_matches_jax(tiny, stop_at, monkeypatch):
    """The Engine's ids, finish reason and session position against
    jlama_tpu's Engine, with a stop id at the first step, at the third, or
    none; on the CPU the chunk runs exactly the steps up to the stop."""
    from jlama_tpu.runtime.engine import Engine as JEngine
    from jlama_tpu_torch.runtime.engine import Engine

    monkeypatch.setenv("JLAMA_DEVICE_CHUNK", "8")
    jp, jcfg, tp, tcfg = tiny
    prompt = PROMPTS[1].tolist()
    kw = dict(max_seq_len=S)
    free = JEngine(jp, jcfg, kv_dtype=jnp.float32, compute_dtype=jnp.float32, **kw) \
        .generate_tokens(prompt, max_new_tokens=20, stop_ids=set()).token_ids
    if stop_at is None:
        stops = {-1}
    else:
        stops = {free[stop_at]}
        assert free.index(free[stop_at]) == stop_at
    jeng = JEngine(jp, jcfg, kv_dtype=jnp.float32, compute_dtype=jnp.float32, **kw)
    eng = Engine(tp, tcfg, device="cpu", kv_dtype=torch.float32, compute_dtype=torch.float32,
                 **kw)
    ref = jeng.generate_tokens(prompt, max_new_tokens=20, stop_ids=stops, session_id="s")
    got = eng.generate_tokens(prompt, max_new_tokens=20, stop_ids=stops, session_id="s")
    assert got.token_ids == ref.token_ids and got.finish_reason.value == ref.finish_reason.value
    assert eng.sessions["s"].position == jeng.sessions["s"].position
    assert eng.sessions["s"].pending == jeng.sessions["s"].pending
    assert eng.graphs.stats()["eager_steps"] == len(got.token_ids)
    n = 20 if stop_at is None else stop_at + 1
    assert len(got.token_ids) == n
