"""The port's serving metrics (jlama_tpu_torch.utils.metrics) against
jlama_tpu's, on the same responses."""

import numpy as np
import pytest

from jlama_tpu.utils.metrics import ServingMetrics as JServingMetrics
from jlama_tpu_torch.runtime.engine import FinishReason, Response
from jlama_tpu_torch.utils.metrics import ServingMetrics


def _responses(n, seed):
    rng = np.random.default_rng(seed)
    return [Response(response_text="", response_text_with_special_tokens="",
                     finish_reason=FinishReason.MAX_TOKENS,
                     prompt_tokens=int(rng.integers(1, 100)),
                     generated_tokens=int(rng.integers(0, 50)),
                     prompt_time_ms=float(rng.uniform(1, 500)),
                     generate_time_ms=float(rng.choice([0.0, rng.uniform(1, 900)])))
            for _ in range(n)]


@pytest.mark.parametrize("n", [0, 1, 37, 10_050])
def test_snapshot_matches_jax(n):
    ours, ref = ServingMetrics(), JServingMetrics()
    for r in _responses(n, seed=n):
        ours.record(r)
        ref.record(r)
    assert ours.snapshot() == ref.snapshot()
    assert (ours.ttft_ms, ours.decode_tok_s) == (ref.ttft_ms, ref.decode_tok_s)
    assert len(ours.ttft_ms) <= 10_000
