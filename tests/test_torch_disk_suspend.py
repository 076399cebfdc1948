"""Suspending a session to disk (`BatchScheduler.suspend_session(...,
to_dir=...)`) in the port, against jlama_tpu's scheduler: the file is the JAX
scheduler's file (`{to_dir}/{session_id}.kv.npz`, each pool leaf a uint8
view), the round trip is bit-equal for bf16, f32 and q8 pools, and a file
written by either package resumes in the other with the greedy ids of a run
that never suspended. Tiny Llama, 2 slots, pages of 8, on the CPU."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import make_tiny_llama

FIRST, SECOND = [1, 3, 7, 9, 11, 40, 2, 5, 6], [12, 30, 4]
POOLS = {"bf16": (torch.bfloat16, jnp.bfloat16), "f32": (torch.float32, jnp.float32),
         "q8": ("q8", "q8")}
NO_STOP = {-1}  # no stop id: every continuation runs its full length
KW = dict(n_slots=2, n_pages=32, page_size=8, max_seq_len=48)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    from jlama_tpu.models.loader import load_params as jload
    from jlama_tpu_torch.models.loader import load_params

    model_dir, _ = make_tiny_llama(tmp_path_factory.mktemp("tdisk"))
    jp, jcfg = jload(model_dir, float_dtype=jnp.float32)
    tp, tcfg = load_params(model_dir, device="cpu", float_dtype=torch.float32)
    return jp, jcfg, tp, tcfg


def port_sched(ckpt, pool):
    from jlama_tpu_torch.runtime.scheduler import BatchScheduler

    _, _, tp, tcfg = ckpt
    return BatchScheduler(tp, tcfg, kv_dtype=POOLS[pool][0], compute_dtype=torch.float32,
                          device="cpu", **KW)


def jax_sched(ckpt, pool):
    from jlama_tpu.runtime.scheduler import BatchScheduler

    jp, jcfg, _, _ = ckpt
    return BatchScheduler(jp, jcfg, kv_dtype=POOLS[pool][1], compute_dtype=jnp.float32, **KW)


def _leaves(sched, pages):
    """The pool leaves at `pages`, in the JAX package's tree order, as numpy."""
    from jlama_tpu_torch.runtime.scheduler import _pool_leaves

    idx = torch.tensor(pages)
    return [a[:, :, idx].contiguous().view(torch.uint8).numpy().copy()
            for a in _pool_leaves(sched.kv.state.k_pool, sched.kv.state.v_pool)]


def _jgenerate(sched, prompt, n, sid):
    from jlama_tpu.runtime.scheduler import GenRequest

    req = GenRequest(prompt_ids=list(prompt), max_new_tokens=n, session_id=sid,
                     stop_ids=NO_STOP)
    sched.submit(req)
    while req.state.value != "DONE":
        sched.step()
    return req.out_ids


@pytest.mark.parametrize("pool", list(POOLS))
def test_disk_round_trip_is_bit_equal(ckpt, pool, tmp_path):
    sched = port_sched(ckpt, pool)
    sched.generate(FIRST, max_new_tokens=4, session_id="s", stop_ids=NO_STOP)
    pages = sched.kv.alloc.pages_for("s")
    before = _leaves(sched, pages)
    free = sched.kv.alloc.n_free
    assert sched.suspend_session("s", to_dir=str(tmp_path / "kv"))
    path = tmp_path / "kv" / "s.kv.npz"
    assert sched.kv.alloc.n_free == free + len(pages) and "s" not in sched.session_state
    with np.load(path) as z:
        members = [z[f] for f in z.files]
    # the JAX scheduler's members: arr_0.. in leaf order, contiguous uint8
    # views of [L, n_kv, pages, ps, hd * itemsize]
    assert len(members) == (4 if pool == "q8" else 2)
    for got, want in zip(members, before):
        assert got.dtype == np.uint8 and got.shape == want.shape and got.shape[2] == len(pages)
        assert np.array_equal(got, want)
    # another session takes the freed pages, so the resume lands elsewhere
    sched.generate(list(range(1, 11)), max_new_tokens=2, session_id="other", stop_ids=NO_STOP)
    assert sched.resume_session("s")
    new_pages = sched.kv.alloc.pages_for("s")
    assert new_pages != pages
    for got, want in zip(_leaves(sched, new_pages), before):
        assert np.array_equal(got, want)
    assert path.exists()  # a resume reads the file and deletes nothing


@pytest.mark.parametrize("pool", list(POOLS))
def test_disk_suspend_continues_as_if_never_suspended(ckpt, pool, tmp_path):
    sched = port_sched(ckpt, pool)
    sched.generate(FIRST, max_new_tokens=4, session_id="s", stop_ids=NO_STOP)
    assert sched.suspend_session("s", to_dir=str(tmp_path))
    # the resume comes with the request's admission
    cont = sched.generate(SECOND, max_new_tokens=6, session_id="s", stop_ids=NO_STOP)
    ref = port_sched(ckpt, pool)
    ref.generate(FIRST, max_new_tokens=4, session_id="s", stop_ids=NO_STOP)
    want = ref.generate(SECOND, max_new_tokens=6, session_id="s", stop_ids=NO_STOP)
    assert cont.token_ids == want.token_ids and len(cont.token_ids) == 6
    assert sched.session_state["s"] == ref.session_state["s"]


@pytest.mark.parametrize("pool", list(POOLS))
def test_jax_file_resumes_in_the_port(ckpt, pool, tmp_path):
    """jlama_tpu's scheduler suspends a session to disk; the port takes its
    file and the session's (position, pending token), resumes, and
    continues with the ids of a port run that never suspended."""
    js = jax_sched(ckpt, pool)
    first = _jgenerate(js, FIRST, 4, "s")
    assert js.suspend_session("s", to_dir=str(tmp_path))
    payload, state, _ = js._suspended["s"]
    assert payload == ("disk", str(tmp_path))
    ref = port_sched(ckpt, pool)
    assert ref.generate(FIRST, max_new_tokens=4, session_id="s",
                        stop_ids=NO_STOP).token_ids == first
    want = ref.generate(SECOND, max_new_tokens=6, session_id="s", stop_ids=NO_STOP).token_ids

    sched = port_sched(ckpt, pool)
    sched._suspended["s"] = (("disk", str(tmp_path)), tuple(state))
    got = sched.generate(SECOND, max_new_tokens=6, session_id="s", stop_ids=NO_STOP).token_ids
    assert got == want
    if pool == "f32":
        assert got == _jgenerate(js, SECOND, 6, "s")


@pytest.mark.parametrize("pool", list(POOLS))
def test_port_file_resumes_in_jax(ckpt, pool, tmp_path):
    """The port suspends a session to disk; jlama_tpu's scheduler takes its
    file and state, resumes, and continues with the ids of a JAX run that
    never suspended."""
    sched = port_sched(ckpt, pool)
    first = sched.generate(FIRST, max_new_tokens=4, session_id="s", stop_ids=NO_STOP).token_ids
    assert sched.suspend_session("s", to_dir=str(tmp_path))
    payload, state = sched._suspended["s"]
    assert payload == ("disk", str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["s.kv.npz"]

    ref = jax_sched(ckpt, pool)
    assert _jgenerate(ref, FIRST, 4, "s") == first
    want = _jgenerate(ref, SECOND, 6, "s")
    js = jax_sched(ckpt, pool)
    js._suspended["s"] = (("disk", str(tmp_path)), state, 0)
    assert _jgenerate(js, SECOND, 6, "s") == want
    if pool == "f32":
        assert sched.generate(SECOND, max_new_tokens=6, session_id="s",
                              stop_ids=NO_STOP).token_ids == want
