"""The port's sampling (jlama_tpu_torch.nn.sampling) with per-row parameters:
the top-k/top-p masks equal jlama_tpu's `sample_token` masks, and the
counter-based seeded draws follow the filtered softmax (JAX's threefry bits
cannot be reproduced, so draws are held to the distribution only)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from jlama_tpu_torch.nn.sampling import _filter, counter_uniform, sample_token


def _jax_scaled(monkeypatch, logits, temps, top_ks, top_ps):
    """The masked, scaled logits jlama_tpu's sample_token draws from: its
    categorical draw is replaced by one that records them."""
    from jlama_tpu.nn import sampling as jsampling

    seen = {}

    def record(key, scaled, axis=-1):
        seen["scaled"] = np.asarray(scaled)
        return jnp.zeros(scaled.shape[0], jnp.int32)

    monkeypatch.setattr(jax.random, "categorical", record)
    jsampling.sample_token(jnp.asarray(logits), jax.random.PRNGKey(0), jnp.asarray(temps),
                           top_k=jnp.asarray(top_ks), top_p=jnp.asarray(top_ps))
    return seen["scaled"]


@pytest.mark.parametrize("V", [16, 50])
def test_per_row_masks_match_jax(monkeypatch, V):
    rng = np.random.default_rng(V)
    B = 6
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    temps = np.array([0.7, 1.0, 1.3, 0.5, 2.0, 1.0], np.float32)
    top_ks = np.array([0, 3, V, 1, 7, -1], np.int32)
    top_ps = np.array([1.0, 0.9, 0.5, 0.95, 0.3, 0.8], np.float32)
    ref = _jax_scaled(monkeypatch, logits, temps, top_ks, top_ps)
    scaled = torch.from_numpy(logits) / torch.from_numpy(temps)[:, None]
    got = _filter(scaled, torch.from_numpy(top_ks), torch.from_numpy(top_ps)).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    np.testing.assert_allclose(got[np.isfinite(got)], ref[np.isfinite(ref)], rtol=1e-6)
    # scalar parameters take the same masks as rows that all carry them
    one = _filter(scaled, 3, 0.9)
    rows = _filter(scaled, torch.full((B,), 3), torch.full((B,), 0.9))
    assert torch.equal(torch.isfinite(one), torch.isfinite(rows))


def test_seeded_draws_follow_the_filtered_softmax():
    """Chi-square of 8000 seeded draws (one (seed, step) stream per row)
    against the filtered softmax: 14 degrees of freedom at most, and the
    0.1 % critical value of chi2(15) is 37.7."""
    rng = np.random.default_rng(1)
    V, n = 16, 8000
    logits = torch.from_numpy((rng.standard_normal((1, V)) * 1.5).astype(np.float32))
    for top_k, top_p in ((0, 1.0), (5, 1.0), (0, 0.8)):
        rows = logits.expand(n, V)
        seeds = torch.arange(n) * 7919 + 13
        steps = torch.arange(n) % 5
        draws = sample_token(rows, None, torch.full((n,), 1.0), top_k, top_p, seeds=seeds,
                             steps=steps)
        p = torch.softmax(_filter(logits.clone(), top_k, top_p), -1)[0].numpy()
        counts = np.bincount(draws.numpy(), minlength=V)
        assert counts[p == 0].sum() == 0
        live = p > 0
        chi2 = (((counts[live] - n * p[live]) ** 2) / (n * p[live])).sum()
        assert chi2 < 37.7, (top_k, top_p, chi2)


def test_seeded_draws_do_not_depend_on_the_batch():
    rng = np.random.default_rng(2)
    logits = torch.from_numpy(rng.standard_normal((5, 64)).astype(np.float32))
    seeds = torch.tensor([3, 3, 9, 1234, 3])
    steps = torch.tensor([0, 1, 0, 7, 0])
    temps = torch.tensor([0.9, 0.9, 1.2, 0.0, 0.9])
    full = sample_token(logits, None, temps, 10, 0.9, seeds=seeds, steps=steps)
    for i in range(5):
        alone = sample_token(logits[i:i + 1], None, temps[i:i + 1], 10, 0.9,
                             seeds=seeds[i:i + 1], steps=steps[i:i + 1])
        assert int(alone[0]) == int(full[i])
    assert int(full[3]) == int(torch.argmax(logits[3]))  # temperature 0: greedy
    u = counter_uniform(seeds, steps, 64)
    assert torch.equal(u[0], u[4]) and not torch.equal(u[0], u[1])
    assert float(u.min()) > 0.0 and float(u.max()) < 1.0


def test_static_greedy_skips_the_draw(monkeypatch):
    logits = torch.randn((3, 32))
    monkeypatch.setattr(torch, "rand", lambda *a, **k: pytest.fail("drew"))
    assert torch.equal(sample_token(logits, None, 0.0, 5, 0.5), torch.argmax(logits, -1))
