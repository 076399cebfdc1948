"""chip_smoke.py's pp phase (phase 20, run (a)) rehearsed on the CPU: the
rank program (jlama_tpu_torch/scripts/pp_check.py) on two gloo ranks at a
tiny Llama (head size 64, so that K2's and K3's plain versions run, 4 layers,
2 a stage), started with `spawn` through a FileStore in tmp_path, and its
checks (`check_ranks`), which the card run applies at Llama-3.1-8B's widths
and depth: the prefill's logits against one device's, the ring's and the
stage-serial scheduler's ids against one device's, the last stage's samples
against what stage 0 got, the per-rank disk files."""

import pickle

from jlama_tpu_torch.scripts import pp_check
from tests.test_torch_tp_check import SPEC as TP_SPEC
from tests.torch_tp_ranks import start_ranks, wait_ranks

HF = dict(TP_SPEC["hf_config"], num_hidden_layers=4)
# the train step (scripts/train_check.py) on a tied model: the embedding is
# used on both stages and must take one update on both
SPEC = dict(TP_SPEC, hf_config=HF, n_slots=4, timed=2, profile=0, disk_prompt=48,
            max_seq_len=256, train=dict(hf_config=dict(HF, tie_word_embeddings=True), batch=4,
                                        seq=16, lr=0.5, seed=0))


def test_pp_phase_rank_program_on_the_cpu(tmp_path):
    procs, end = start_ranks(pp_check.rank_main,
                             lambda r: (r, 2, str(tmp_path / "store"),
                                        str(tmp_path / f"rank{r}.pkl"), SPEC))
    wait_ranks(procs, end)
    ranks = []
    for r in range(2):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    assert pp_check.check_ranks(ranks, SPEC) == []
    lead = ranks[0]
    assert lead["logits_bit_equal"], lead["logits_rel_l2"]
    t = lead["pipe_timed"]
    # a window of W = 4 at pp = 2: 1 + 2 * 4 ticks; stage 0 exchanges at
    # every tick's end (its first tick receives nothing, its last hands on
    # nothing but takes the last ids back)
    assert t["ticks"] == 9 * t["steps"] and t["p2p_calls"] == t["ticks"]
    assert lead["serial_timed"]["decode_steps"] > 0
    # the train step: the tied embedding held by both stages, bit-equal
    assert all(("top", "embed", "all") in r["train"]["digests"] for r in ranks)
    # a wrong expectation is caught
    broken = [dict(ranks[0], pipe_ids=[]), ranks[1]]
    assert any("pipe: the ids differ" in b for b in pp_check.check_ranks(broken, SPEC))
