"""Randomized stress of the port's BatchScheduler (the counterpart of
tests/test_scheduler_stress.py): the background loop serves the same seeded
mix of requests (sampling parameters, sessions, penalties, top_p, sleeps)
while the submitting thread suspends sessions, half of the suspends to disk,
and drops sessions. Every request completes with sane bookkeeping (no stuck
slot, no leaked page), the files on disk stay where the suspends wrote them
(a resume deletes nothing, as in the JAX scheduler), and no traffic creates a
decode or prefill graph key that `warmup()` did not create."""

import time

import numpy as np
import torch

from tests.helpers import make_tiny_llama

DEADLINE_S = 120


def test_scheduler_stress_mixed_traffic(tmp_path):
    from jlama_tpu_torch.models.loader import load_params
    from jlama_tpu_torch.runtime.engine import FinishReason
    from jlama_tpu_torch.runtime.scheduler import BatchScheduler, GenRequest

    t0 = time.time()
    model_dir, _ = make_tiny_llama(tmp_path)
    params, cfg = load_params(model_dir, device="cpu", float_dtype=torch.float32)
    sched = BatchScheduler(
        params, cfg, n_slots=4, n_pages=48, page_size=8, max_seq_len=64,
        kv_dtype=torch.float32, compute_dtype=torch.float32, max_sessions=4,
        prefill_chunk=16, device="cpu",
    )
    sched.warmup()
    keys = (sched.graphs.stats()["keys"], sched.prefill_graphs.stats()["keys"])
    disk = tmp_path / "kv"
    sched.start()
    rng = np.random.default_rng(7)
    reqs, n_suspends, on_disk = [], 0, set()
    try:
        for i in range(40):
            n = int(rng.integers(1, 30))
            kw = dict(
                prompt_ids=list(rng.integers(1, 200, n)),
                max_new_tokens=int(rng.integers(1, 8)),
                temperature=float(rng.choice([0.0, 0.8])),
                seed=int(rng.integers(0, 1 << 30)),
            )
            r = rng.random()
            if r < 0.3:
                kw["session_id"] = f"sess{int(rng.integers(0, 6))}"
            elif r < 0.4:
                kw["presence_penalty"] = 0.5
            elif r < 0.5:
                kw["top_p"] = 0.9
            req = GenRequest(**kw)
            reqs.append(req)
            sched.submit(req)
            if rng.random() < 0.2:
                # every other suspend goes to disk (no draw of its own, so the
                # mix is the JAX test's)
                sid, to_dir = f"sess{int(rng.integers(0, 6))}", None
                n_suspends += 1
                if n_suspends % 2:
                    to_dir = str(disk)
                if sched.suspend_session(sid, to_dir=to_dir) and to_dir:
                    on_disk.add(sid)
            if rng.random() < 0.1:
                sched.drop_session(f"sess{int(rng.integers(0, 6))}")
            if rng.random() < 0.3:
                time.sleep(0.01)

        deadline = t0 + DEADLINE_S
        for req in reqs:
            assert req.done_event.wait(max(1, deadline - time.time())), (
                req.state, req.prompt_ids
            )
    finally:
        sched.stop()

    # every request completed with a terminal reason and plausible output
    for req in reqs:
        assert req.finish is not None
        if req.finish != FinishReason.ERROR:
            assert 0 < len(req.out_ids) <= req.max_new_tokens
    # no leaked slots; pages only held by remembered sessions
    assert all(s is None for s in sched.slots)
    live_keys = set(sched.kv.alloc.by_seq)
    known = set(sched.session_state) | {"__empty__"}
    leaked = {
        k for k in live_keys
        if k not in known and sched.kv.alloc.pages_for(k)
    }
    assert not leaked, leaked
    # a disk suspend leaves its file, and a resume or drop deletes none
    assert n_suspends >= 2 and on_disk
    assert {p.name for p in disk.iterdir()} == {f"{sid}.kv.npz" for sid in on_disk}
    # the warm-up knew every shape the traffic reached
    assert (sched.graphs.stats()["keys"], sched.prefill_graphs.stats()["keys"]) == keys
    assert time.time() - t0 < DEADLINE_S
