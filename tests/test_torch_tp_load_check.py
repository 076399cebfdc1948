"""chip_smoke.py phase 19's rank program (jlama_tpu_torch/scripts/
tp_load_check.py) on the CPU: two spawned gloo ranks meeting through a
FileStore in tmp_path, at tiny widths and in f32, every check of
`check_ranks` held (its rehearsal before the card). The JQ4 llama is wide
enough for q4s under tp (each rank's K a multiple of 256) and is read from
disk and over ranged HTTP (tests/test_torch_shard_load.py's Range server);
GPT-2 and BERT are tests/test_torch_gpt2_bert.py's configs, BERT with its
trained WordPiece tokenizer. A deadline for the ranks, start to exit."""

import json
import pickle
import threading
from http.server import ThreadingHTTPServer

import pytest

from jlama_tpu_torch.scripts import tp_load_check as L
from jlama_tpu_torch.scripts.tp_check import start_ranks, wait_ranks
from tests.helpers import make_tiny_llama
from tests.test_torch_gpt2_bert import GPT2, TEXTS, bert  # noqa: F401  (module fixture)
from tests.test_torch_shard_load import RangeHandler

WORLD = 2
DEADLINE = 150
WIDE = dict(hidden_size=512, intermediate_size=1024, num_attention_heads=8,
            num_key_value_heads=4, vocab_size=512, max_position_embeddings=64)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, bert):  # noqa: F811
    from jlama_tpu.quant.quantizer import quantize_model

    tmp = tmp_path_factory.mktemp("load_check")
    src, _ = make_tiny_llama(tmp / "src", config_overrides=WIDE)
    model_dir = quantize_model(src, tmp / "web" / "llama")
    handler = type("Handler", (RangeHandler,), {"root": str(tmp / "web")})
    srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    spec = dict(device="cpu", backend="gloo", timeout_s=60, seed=0, threads=2, f32=True,
                model_dir=str(model_dir), url=f"http://127.0.0.1:{srv.server_address[1]}/llama",
                gpt2=GPT2, bert=json.loads((bert[0] / "config.json").read_text()),
                bert_tokenizer=str(bert[0] / "tokenizer.json"), texts=TEXTS, n_slots=2,
                n_pages=32, page_size=8, max_seq_len=64, requests=2, prompt_len=(6, 12),
                new_tokens=4, prefill=16, logit_rows=4, k5_m=(1, 20))
    try:
        procs, end = start_ranks(L.rank_main, lambda r: (r, WORLD, str(tmp / "store"),
                                                         str(tmp / f"rank{r}.pkl"), spec),
                                 WORLD, DEADLINE)
        err = wait_ranks(procs, end)
    finally:
        srv.shutdown()
    assert err is None, f"{err} ({DEADLINE} s)"
    out = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out, spec


def test_rank_program_checks_hold(ranks):
    """Every check of the card's phase holds on the CPU: each rank's disk
    and HTTP trees its slice of a whole load, under 0.8 of the payload
    read from disk and the same fetched over HTTP; every Llama run's q4
    and q4s ids and GPT-2's equal one device's; every tp logits within
    tp_check.REL_L2_LIMIT of one device's; the mesh server's BERT vectors within
    1e-4 of one device's embed_batch; K5 on each rank's weights equal to
    its plain version."""
    results, spec = ranks
    assert L.check_ranks(results, spec, embed_limit=1e-4) == []


def test_rank_program_reads_and_serves_its_slice(ranks):
    """What the checks rest on: rank r's K5 shapes are its slice (wo's and
    w2's K halved, wqkv's and w13's rows), the disk read and the HTTP
    fetch the same bytes (whole rows of wo and w2), less than the payload,
    and the leader served every request."""
    results, spec = ranks
    for res in results:
        sh = res["q4s_shapes"]
        assert sh["wo"] == (512, 256) and sh["w2"] == (512, 512)
        assert sh["wqkv"] == ((512 + 2 * 256) // 2, 512) and sh["w13"] == (1024, 512)
        assert sh["lm_head"] == (256, 512)  # the vocabulary-sharded head
        assert res["local"]["bytes_loaded"] == res["http"]["bytes_loaded"] \
            < res["http"]["payload"]
    lead = results[0]
    for name in L.LLAMA_RUNS + ("gpt2",):
        assert [len(ids) for ids in lead[name]["ids"]] == [spec["new_tokens"]] * 2
    for name in L.LLAMA_RUNS:  # the served ids of the disk slice too, at f32 here
        assert lead[name]["ids"] == lead[name]["single_ids"]
    assert lead["bert"]["vectors"].shape == (len(TEXTS), 64)
