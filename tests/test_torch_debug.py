"""The per-layer debug hook (`jlama_tpu_torch/utils/debug.py`) against
jlama_tpu's (`jlama_tpu/utils/debug.py`): the sink's (name, layer, array)
sequence on the tiny Llama, the default sink's line, JLAMA_DEBUG=1 at
import, and the graphs' rule that a step runs eagerly while the hook is on."""

import contextlib
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import make_tiny_llama
from tests.test_torch_bridge import port_tree

TOKENS = np.array([[1, 5, 9, 42, 7, 13]], dtype=np.int64)
TOL = 1e-4  # tests/test_torch_forward.py's logits tolerance


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    from jlama_tpu.models.loader import load_params
    from jlama_tpu_torch.config import load_config

    model_dir, _ = make_tiny_llama(tmp_path_factory.mktemp("tdebug"))
    jp, jcfg = load_params(model_dir, float_dtype=jnp.float32)
    return jp, jcfg, load_config(model_dir)


@pytest.fixture
def hooks():
    """Both packages' hooks, switched off again after the test."""
    from jlama_tpu.utils import debug as jdebug
    from jlama_tpu_torch.utils import debug

    yield jdebug, debug
    jdebug.disable()
    debug.disable()


def _grouped(calls):
    out: dict = {}
    for name, layer, arr in calls:
        out.setdefault(name, []).append((layer, np.asarray(arr, dtype=np.float32)))
    return out


@pytest.mark.parametrize("fused", [False, True])
def test_sink_sequence_matches_jax(tiny, hooks, fused):
    """One forward without a cache: q, k and v of every layer reach the
    sink, with no layer argument (None), as in the JAX package."""
    from jlama_tpu.models.base import forward_logits as jforward
    from jlama_tpu_torch.models.base import forward_logits, fuse_params

    jdebug, debug = hooks
    jp, jcfg, tcfg = tiny
    tp = port_tree(jp)
    if fused:
        tp = fuse_params(tp)
    jcalls, tcalls = [], []
    jdebug.enable(lambda n, l, a: jcalls.append((n, l, np.array(a))))
    pos = np.arange(TOKENS.shape[1])[None, :]
    jforward(jp, jcfg, jnp.asarray(TOKENS, jnp.int32), jnp.asarray(pos, jnp.int32),
             dtype=jnp.float32)[0].block_until_ready()
    jdebug.disable()
    debug.enable(lambda n, l, a: tcalls.append((n, l, a)))
    with torch.inference_mode():
        forward_logits(tp, tcfg, torch.from_numpy(TOKENS), torch.from_numpy(pos), None,
                       dtype=torch.float32)
    debug.disable()
    assert len(tcalls) == len(jcalls) == 3 * tcfg.n_layers
    assert all(isinstance(a, np.ndarray) for _, _, a in tcalls)
    got, ref = _grouped(tcalls), _grouped(jcalls)
    # the JAX package's callbacks are unordered across names (no ordering
    # effect), so the sequences are held name by name
    assert list(got) == ["query", "key", "value"] and sorted(ref) == sorted(got)
    for name in ref:
        assert [l for l, _ in got[name]] == [l for l, _ in ref[name]] == [None] * tcfg.n_layers
        for (_, a), (_, b) in zip(got[name], ref[name]):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)


def test_default_sink_line_matches_jax(hooks, capsys):
    jdebug, debug = hooks
    arr = np.arange(-6, 6, dtype=np.float32).reshape(3, 4) / 7
    jdebug._default_sink("key", 3, arr)
    debug._default_sink("key", 3, arr)
    jline, tline = capsys.readouterr().out.splitlines()
    assert tline == jline == "[debug] L3 key: shape=(3, 4) sum=-0.85714 absmax=0.85714"
    # the port's debug() with no sink prints that line for a tensor
    debug.enable()
    t = torch.from_numpy(arr).to(torch.bfloat16)
    assert debug.debug("key", t, 3) is t
    bf = t.to(torch.float32).numpy()
    assert capsys.readouterr().out == (f"[debug] L3 key: shape=(3, 4) sum={bf.sum():.5f} "
                                       f"absmax={np.abs(bf).max():.5f}\n")


def test_off_hook_returns_the_tensor_and_calls_nothing(hooks):
    _, debug = hooks
    calls = []
    debug.enable(lambda *a: calls.append(a))
    debug.disable()
    t = torch.ones(2, 3)
    assert not debug.enabled() and debug.debug("query", t) is t and not calls


def test_env_switch_read_at_import():
    code = "from jlama_tpu_torch.utils import debug; print(debug.enabled())"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for value, want in (("1", "True"), ("0", "False")):
        env = dict(os.environ, JLAMA_DEBUG=value, PYTHONPATH=root)
        out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                             text=True, timeout=120, check=True)
        assert out.stdout.strip() == want


class _Counter:
    def __init__(self):
        self.launches = 0


class _FakeGraph:
    def capture_begin(self, *pool, capture_error_mode="global"):
        pass

    def capture_end(self):
        pass

    def replay(self):
        pass


@pytest.fixture
def fake_cuda(monkeypatch):
    """torch.cuda's graph calls replaced, as in tests/test_torch_graphs.py
    (the fake begins and ends the capture on the object it is given)."""
    captured = []

    @contextlib.contextmanager
    def graph(g, pool=None, capture_error_mode="global"):
        captured.append(pool)
        g.capture_begin(pool, capture_error_mode=capture_error_mode)
        try:
            yield
        finally:
            g.capture_end()

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: ("pool",))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device=None: 0)
    return captured


def test_graphs_run_eagerly_while_the_hook_is_on(hooks, fake_cuda):
    """Under the hook every step runs fn: no capture, no replay, and the
    step is no key's use; after disable() the key's first use is eager, its
    second captures, and a graph captured before the hook replays again
    after it."""
    from jlama_tpu_torch.runtime.graphs import StepGraphs

    _, debug = hooks
    a = _Counter()
    g = StepGraphs("cpu", counters=(a,))
    g.capture = True  # as on the card
    runs = []

    def step():
        a.launches += 1
        runs.append(1)
        return torch.zeros(1)

    g.run("old", step)
    g.run("old", step)  # captured
    debug.enable(lambda *x: None)
    for key in ("old", "new", "new", "new"):
        g.run(key, step)
    assert len(runs) == 6 and len(fake_cuda) == 1
    assert g.stats() | {"capture_s": 0} == dict(graphs=1, keys=1, segments=1, eager_steps=5,
                                                replays=1, capture_s=0, pool_bytes=0)
    debug.disable()
    for key in ("old", "new", "new"):
        g.run(key, step)
    assert len(runs) == 8 and len(fake_cuda) == 2  # an eager first use, a capture
    assert (g.stats()["graphs"], g.stats()["replays"], g.stats()["eager_steps"]) == (2, 3, 6)


def test_engine_under_the_hook(tiny, hooks):
    """A CPU Engine.generate_tokens with the hook on gives the sink 3 x
    n_layers calls a forward (one prefill, then one per decode step), and
    the ids of a run with the hook off."""
    from jlama_tpu_torch.runtime.engine import Engine

    _, debug = hooks
    jp, _, tcfg = tiny
    eng = Engine(port_tree(jp), tcfg, device="cpu", max_seq_len=64, kv_dtype=torch.float32,
                 compute_dtype=torch.float32)
    ref = eng.generate_tokens([1, 5, 9, 42, 7], max_new_tokens=4, stop_ids=set())
    calls = []
    debug.enable(lambda n, l, a: calls.append((n, l, a.shape)))
    got = eng.generate_tokens([1, 5, 9, 42, 7], max_new_tokens=4, stop_ids=set())
    debug.disable()
    assert got.token_ids == ref.token_ids
    L, D = tcfg.n_layers, tcfg.n_heads * tcfg.head_size
    assert len(calls) == 3 * L * (1 + 4)
    assert calls[0] == ("query", None, (1, 16, D))  # the 4-token prefill, bucket 16
    assert calls[3 * L] == ("query", None, (1, 1, D))
