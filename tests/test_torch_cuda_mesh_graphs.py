"""Graphs of the mesh steps on the card (`jlama_tpu_torch/runtime/
graphs.py`: a step's collectives and hand-overs cut its capture into
segments): the rank programs of chip_smoke.py's phases 16 and 20
(scripts/tp_check.py, scripts/pp_check.py) at small widths on two gloo ranks
of cuda:0, whose checks hold the graphed steps' logits bit-equal to the
eager yardstick's (`tp_check.LogitsPrints`), their launches equal, their
greedy ids one device's and their graphs captured and replayed on every
rank, for the scheduler, the pipelined and the stage-serial schedulers and
`Engine(mesh=)`.

Marked `cuda`: each test skips where torch has no CUDA device (as on the CPU
test runs); on a machine with an NVIDIA GPU run them with
`python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_mesh_graphs.py -m cuda -q`
(build K1-K4 first, or let the first rank build them). The CPU tests of the
same machinery are tests/test_torch_mesh_graphs.py.
"""

import pickle

import pytest
import torch

pytestmark = pytest.mark.cuda

DEADLINE = 300  # both rank processes, start to exit


CARD_HF = dict(model_type="llama", hidden_size=256, intermediate_size=512,
               num_attention_heads=4, num_key_value_heads=2, num_hidden_layers=2,
               rms_norm_eps=1e-5, vocab_size=512, max_position_embeddings=4096,
               rope_theta=500000.0, bos_token_id=1, eos_token_id=2, hidden_act="silu",
               tie_word_embeddings=False)
CARD_SPEC = dict(hf_config=CARD_HF, device="cuda:0", backend="gloo", timeout_s=240, seed=0,
                 n_pages=64, prefill=64, logit_rows=8, requests=4, new_tokens=6,
                 timed_steps=4, profile=0)


def _card_ranks(tmp_path, module, spec):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs and the kernels run only there)")
    from jlama_tpu_torch.ops import _build
    from jlama_tpu_torch.scripts import tp_check

    _build.build(("q4_matmul", "flash_prefill", "paged_decode", "kv_write"))
    procs, end = tp_check.start_ranks(module.rank_main, lambda r: (
        r, 2, str(tmp_path / "store"), str(tmp_path / f"rank{r}.pkl"), spec), 2, DEADLINE)
    err = tp_check.wait_ranks(procs, end)
    assert err is None, err
    out = []
    for r in range(2):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def test_card_tp_graphs_equal_eager(tmp_path):
    """tp = 2 on two gloo ranks of cuda:0: the scheduler's and the Engine's
    graphed steps (chains of segments) against the eager yardstick, logits
    bit for bit, launches equal, graphs captured and replayed on each rank
    (tp_check.check_ranks)."""
    from jlama_tpu_torch.scripts import tp_check

    ranks = _card_ranks(tmp_path, tp_check, CARD_SPEC)
    assert tp_check.check_ranks(ranks, CARD_SPEC) == []
    for r in ranks:
        assert r["graphs"]["segments"] > r["graphs"]["graphs"] > 0


def test_card_pp_graphs_equal_eager(tmp_path):
    """pp = 2 on two gloo ranks of cuda:0: the pipelined and the stage-serial
    schedulers' graphed steps and the Engine's against their eager
    yardsticks (pp_check.check_ranks)."""
    from jlama_tpu_torch.scripts import pp_check

    spec = dict(CARD_SPEC, hf_config=dict(CARD_HF, num_hidden_layers=4), n_slots=4, timed=2,
                profile=0, disk_prompt=48, max_seq_len=256)
    ranks = _card_ranks(tmp_path, pp_check, spec)
    assert pp_check.check_ranks(ranks, spec) == []
    for r in ranks:
        assert r["pipe_graphs"]["segments"] > r["pipe_graphs"]["graphs"] > 0
