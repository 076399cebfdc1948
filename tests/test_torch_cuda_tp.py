"""The tp group's collectives on CUDA tensors over gloo (two ranks on
cuda:0, as chip_smoke.py's tensor-parallel phase runs them): each of
all-reduce, all-gather and broadcast on f32 (the dtype the tp forward's
collectives carry), by the route that `TPGroup`'s first-use check picks
and again staged through pinned host memory (`TPGroup.routes` set to
"host"), every result exact against the sum, concatenation or copy of the
ranks' seeded inputs and back on the card
(`jlama_tpu_torch/scripts/tp_check.py::route_check`).

Marked `cuda`: it skips where torch has no CUDA device (as on the CPU test
runs); on a machine with an NVIDIA GPU run it with
`python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_tp.py -m cuda -q`.
The two rank processes start with `spawn`, meet through a FileStore in
tmp_path and have a deadline of their own (90 s)."""

import pickle

import pytest
import torch

from jlama_tpu_torch.scripts import tp_check

pytestmark = pytest.mark.cuda

WORLD, DEADLINE = 2, 90


def test_gloo_collectives_direct_and_staged_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the collectives on CUDA tensors)")
    procs, end = tp_check.start_ranks(tp_check.routes_main,
                                      lambda r: (r, WORLD, str(tmp_path / "store"),
                                                 str(tmp_path / f"rank{r}.pkl")),
                                      WORLD, DEADLINE)
    err = tp_check.wait_ranks(procs, end)
    assert err is None, err
    for r in range(WORLD):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            res = pickle.load(f)
        assert set(res) == {"all_reduce", "all_gather", "broadcast"}, res
        for op, (route, err, err_staged) in res.items():
            assert route in ("direct", "host") and (err, err_staged) == (0.0, 0.0), (r, op, res)
        print(f"rank {r}: {res}")


# dp = 2 at tp = 1 on the card: two dp groups of one rank each on cuda:0, a
# tiny Llama (head size 64, so that K2 and K3 run) from seed 0 through the
# rank program of chip_smoke.py's mesh phases (tp_check.rank_main, 4 slots);
# its checks (tp_check.check_ranks: launches, rows, pages, the session in
# group 1, greedy ids equal to one device's), and the ranks' decode steps
# and prefills on CUDA graphs, the ids gathered outside them
DP_SPEC = dict(hf_config=dict(model_type="llama", hidden_size=256, intermediate_size=512,
                              num_attention_heads=4, num_key_value_heads=2,
                              num_hidden_layers=2, rms_norm_eps=1e-5, vocab_size=512,
                              max_position_embeddings=4096, rope_theta=500000.0,
                              bos_token_id=1, eos_token_id=2, hidden_act="silu",
                              tie_word_embeddings=False),
               dp=2, device="cuda:0", backend="gloo", timeout_s=DEADLINE, seed=0, n_pages=64,
               n_slots=4, prefill=64, logit_rows=8, requests=4, new_tokens=6, timed_steps=4,
               profile=2, greedy=4)


def test_dp_ranks_replay_graphs_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels and their graphs)")
    procs, end = tp_check.start_ranks(tp_check.rank_main,
                                      lambda r: (r, 2, str(tmp_path / "store"),
                                                 str(tmp_path / f"rank{r}.pkl"), DP_SPEC),
                                      2, DEADLINE)
    err = tp_check.wait_ranks(procs, end)
    assert err is None, err
    ranks = []
    for r in range(2):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    assert tp_check.check_ranks(ranks, DP_SPEC) == []
    for res in ranks:
        g = res["graphs"]
        assert "eager_reason" not in g and g["graphs"] > 0 and g["replays"] > 0, g
    assert ranks[0]["disk_files"] == ["disk.kv.p1.npz"]
