"""chip_smoke.py's mesh phases rehearsed on the CPU: the rank program
(jlama_tpu_torch/scripts/tp_check.py) on gloo ranks at a tiny Llama (head
size 64, so that K2's and K3's plain versions run) and a tiny Mixtral,
started with `spawn` through a FileStore in tmp_path, and its checks
(`check_ranks`), which the card runs apply at Llama-3.1-8B's widths (phase
16, tp = 2), Llama-3.2-1B's (phase 17, dp = 2 x tp = 2) and Mixtral-8x7B's
(phase 18, expert parallelism at tp = 2)."""

import pickle

import pytest

from jlama_tpu_torch.scripts import tp_check
from tests.torch_tp_ranks import start_ranks, wait_ranks

SPEC = dict(hf_config=dict(model_type="llama", hidden_size=256, intermediate_size=512,
                           num_attention_heads=4, num_key_value_heads=2, num_hidden_layers=2,
                           rms_norm_eps=1e-5, vocab_size=512, max_position_embeddings=4096,
                           rope_theta=500000.0, bos_token_id=1, eos_token_id=2,
                           hidden_act="silu", tie_word_embeddings=False),
            device="cpu", backend="gloo", timeout_s=60, seed=0, n_pages=64, prefill=64,
            logit_rows=8, requests=4, new_tokens=6, timed_steps=4, profile=0, threads=2)


def test_tp_phase_rank_program_on_the_cpu(tmp_path):
    procs, end = start_ranks(tp_check.rank_main,
                             lambda r: (r, 2, str(tmp_path / "store"),
                                        str(tmp_path / f"rank{r}.pkl"), SPEC))
    wait_ranks(procs, end)
    ranks = []
    for r in range(2):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    assert tp_check.check_ranks(ranks, SPEC) == []
    lead = ranks[0]
    assert lead["logits_rel_l2"] < 1e-2 and lead["decode_ms_per_step"] > 0
    assert lead["collectives_per_step"] == 2 * 2 + 2  # wo, w2 a layer; embed; lm_head
    # a wrong expectation is caught
    broken = [dict(ranks[0], disk_ids=[]), ranks[1]]
    assert any("disk suspend" in b for b in tp_check.check_ranks(broken, SPEC))


TIED = dict(SPEC["hf_config"], tie_word_embeddings=True)
MIXTRAL = dict(SPEC["hf_config"], model_type="mixtral", num_local_experts=4,
               num_experts_per_tok=2)
MESH_SPECS = {
    # phase 17's path: dp = 2 x tp = 2, four ranks, greedy ids against one
    # device; a tied lm_head, as Llama-3.2-1B's; then the train step
    # (scripts/train_check.py) on the same mesh
    "dp_tp": (4, dict(SPEC, dp=2, n_slots=4, greedy=4, hf_config=TIED,
                      train=dict(hf_config=TIED, batch=4, seq=16, lr=0.5, seed=0))),
    # phase 18's: expert parallelism, 2 of 4 experts a rank, K6 over its
    # range; then the train step on float experts, with the witness of the
    # plain experts and the bf16 readings, which the card runs
    "ep": (2, dict(SPEC, k6=True, hf_config=MIXTRAL,
                   train=dict(hf_config=MIXTRAL, batch=4, seq=16, lr=0.5, seed=0,
                              witness=True, bf16_reading=True))),
}


@pytest.mark.parametrize("name", list(MESH_SPECS))
def test_mesh_phase_rank_programs_on_the_cpu(tmp_path, name):
    """The dp x tp and EP specs of the rank program pass `check_ranks` on
    the CPU: each rank's shapes (n_kv/tp heads of n_pages/dp pages, n_slots/dp
    rows; E/tp experts), the session suspended in dp group 1 (that group's
    files only), the greedy ids against one device, K6 over each rank's
    expert range (foreign rows 0, a bit-equal repeat)."""
    world, spec = MESH_SPECS[name]
    procs, end = start_ranks(tp_check.rank_main,
                             lambda r: (r, world, str(tmp_path / "store"),
                                        str(tmp_path / f"rank{r}.pkl"), spec), world=world)
    wait_ranks(procs, end)
    ranks = []
    for r in range(world):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    assert tp_check.check_ranks(ranks, spec) == []
    lead = ranks[0]
    if name == "dp_tp":
        assert lead["disk_files"] == ["disk.kv.p2.npz", "disk.kv.p3.npz"]
        assert len(lead["greedy_ids"]) == 4 and lead["greedy_ids"] == lead["greedy_single_ids"]
        # a wrong expectation is caught
        broken = [dict(lead, greedy_single_ids=[[]] * 4)] + ranks[1:]
        assert any("greedy" in b for b in tp_check.check_ranks(broken, spec))
    else:
        assert [r["k6"]["lo"] for r in ranks] == [0, 2]
        assert all(r["k6"][n]["foreign_rows"] > 0 for r in ranks for n in tp_check.K6_RS)
        broken = [dict(lead, k6=dict(lead["k6"], lo=2)), ranks[1]]
        assert any("K6" in b for b in tp_check.check_ranks(broken, spec))
    # the train step: every rank's f32 composition against one device's, the
    # replicated leaves bit-equal; a wrong expectation is caught
    assert all(r["train"]["k3_launches"] == 0 for r in ranks)
    key = next(k for k in ranks[0]["train"]["digests"] if k[-1] == "all")
    broken = [dict(ranks[0], train=dict(ranks[0]["train"], digests={
        **ranks[0]["train"]["digests"], key: "0"}))] + ranks[1:]
    assert any("differs across ranks" in b for b in tp_check.check_ranks(broken, spec))
    # the f32 loss is held to F32_LIMIT on every mesh
    tr = ranks[0]["train"]
    broken = [dict(ranks[0], train=dict(tr, loss=tr["one_device_loss"] * (1 + 1e-3)))]
    assert any("f32 loss" in b for b in tp_check.check_ranks(broken + ranks[1:], spec))
    if name == "ep":
        # the witness (the plain experts) runs and is held to F32_LIMIT too
        w = tr["witness"]
        assert max(w["grad_rel_l2"].values()) <= 1e-4
        assert max(tr["bf16_reading"].values()) > 1e-4
        leaf = next(iter(w["grad_rel_l2"]))
        broken = [dict(ranks[0], train=dict(tr, witness=dict(
            w, grad_rel_l2={**w["grad_rel_l2"], leaf: 1e-3})))] + ranks[1:]
        assert any("witness" in b for b in tp_check.check_ranks(broken, spec))
