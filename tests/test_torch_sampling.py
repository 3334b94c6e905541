"""The port's sampler against ``dynamo_tpu.engine.sampling`` on the same
logits (numpy, seeded).

Greedy tokens, logprobs, penalties and penalty counts must match JAX
(logprobs at 1e-5: the same f32 log-softmax, summed in another order).
Sampled tokens cannot: JAX draws from threefry keys, the port from a
counter-based hash of (seed, draw, token). So the top-k/top-p keep sets
are compared exactly, the sampled distribution statistically, and seeded
streams for repetition within the port.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import sampling as js
from dynamo_tpu_torch.engine import sampling as ts


def _state(b, v, temp, top_k, top_p, fp=0.0, pp=0.0, rp=1.0, counts=None, seed=0):
    counts = np.zeros((b, v), np.int32) if counts is None else counts
    arr = lambda x, dt: np.broadcast_to(np.asarray(x, dt), (b,)).copy()  # noqa: E731
    vals = dict(temperature=arr(temp, np.float32), top_k=arr(top_k, np.int32),
                top_p=arr(top_p, np.float32), frequency_penalty=arr(fp, np.float32),
                presence_penalty=arr(pp, np.float32), repetition_penalty=arr(rp, np.float32))
    jst = js.SamplingState(
        **{k: jnp.asarray(x) for k, x in vals.items()},
        keys=jax.vmap(jax.random.key_data)(jax.random.split(jax.random.key(seed), b)),
        token_counts=jnp.asarray(counts))
    tst = ts.SamplingState(
        **{k: torch.from_numpy(x) for k, x in vals.items()},
        seeds=torch.arange(b, dtype=torch.int64) + seed,
        draws=torch.zeros(b, dtype=torch.int64), token_counts=torch.from_numpy(counts))
    return jst, tst


def test_greedy_tokens_and_logprobs_match_jax():
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((6, 300))).astype(np.float32)
    jt, jl = js.greedy_sample(jnp.asarray(logits))
    tt, tl = ts.greedy_sample(torch.from_numpy(logits))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=1e-5)
    # The general sampler with temperature 0 and penalties on: same tokens.
    counts = rng.integers(0, 3, size=(6, 300)).astype(np.int32)
    jst, tst = _state(6, 300, 0.0, 0, 1.0, fp=0.3, pp=0.2, rp=1.3, counts=counts)
    jt, jl, _ = js.sample(jnp.asarray(logits), jst)
    tt, tl = ts.sample(torch.from_numpy(logits), tst)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=1e-5)


def test_penalties_and_counts_match_jax():
    rng = np.random.default_rng(1)
    logits = (2 * rng.standard_normal((4, 64))).astype(np.float32)
    counts = rng.integers(0, 4, size=(4, 64)).astype(np.int32)
    jst, tst = _state(4, 64, 0.7, 0, 1.0, fp=[0.0, 0.5, 0.1, 0.0],
                      pp=[0.0, 0.0, 0.4, 0.2], rp=[1.0, 1.0, 1.2, 0.8], counts=counts)
    np.testing.assert_allclose(ts.apply_penalties(torch.from_numpy(logits), tst).numpy(),
                               np.asarray(js.apply_penalties(jnp.asarray(logits), jst)),
                               atol=1e-6, rtol=1e-6)
    toks = np.array([3, 9, 3, 63], np.int32)
    active = np.array([True, False, True, True])
    np.testing.assert_array_equal(
        ts.record_tokens(torch.from_numpy(counts), torch.from_numpy(toks),
                         torch.from_numpy(active)).numpy(),
        np.asarray(js.record_tokens(jnp.asarray(counts), jnp.asarray(toks),
                                    jnp.asarray(active))))


@pytest.mark.parametrize("top_k,top_p", [(3, 1.0), (0, 0.6), (5, 0.8), (1, 1.0), (8, 0.95)])
def test_keep_masks_match_jax_support(top_k, top_p):
    """The set of tokens JAX's sampler can draw (over 2000 keys) equals the
    port's keep set."""
    rng = np.random.default_rng(top_k * 10 + int(top_p * 10))
    v = 24
    row = rng.standard_normal(v).astype(np.float32)
    n = 2000
    logits = np.broadcast_to(row, (n, v)).copy()
    jst, tst = _state(n, v, 1.0, top_k, top_p)
    jt, _, _ = js.sample(jnp.asarray(logits), jst)
    drawn = set(np.asarray(jt).tolist())
    _, idx, keep = ts.top_k_top_p_keep(torch.from_numpy(row[None]),
                                       torch.tensor([top_k]), torch.tensor([top_p]))
    kept = set(idx[0][keep[0]].tolist())
    assert drawn <= kept
    probs = np.exp(row - row.max())
    probs /= probs[list(kept)].sum()
    if all(probs[i] > 0.02 for i in kept):
        assert drawn == kept


def test_sampled_distribution_follows_softmax():
    """Gumbel-max over the counter-hash noise draws tokens with the softmax
    probabilities: 20000 draws of one row, each frequency within 5 sigma."""
    row = np.log(np.array([0.4, 0.25, 0.15, 0.1, 0.06, 0.04], np.float32))
    n = 20000
    st = ts.SamplingState(
        temperature=torch.ones(n), top_k=torch.zeros(n, dtype=torch.int32),
        top_p=torch.ones(n), frequency_penalty=torch.zeros(n),
        presence_penalty=torch.zeros(n), repetition_penalty=torch.ones(n),
        seeds=torch.full((n,), 1234, dtype=torch.int64),
        draws=torch.arange(n, dtype=torch.int64),
        token_counts=torch.zeros((n, 6), dtype=torch.int32))
    toks, lps = ts.sample(torch.from_numpy(np.broadcast_to(row, (n, 6)).copy()), st)
    freq = np.bincount(toks.numpy(), minlength=6) / n
    p = np.exp(row)
    assert (np.abs(freq - p) < 5 * np.sqrt(p * (1 - p) / n)).all(), freq
    np.testing.assert_allclose(lps.numpy(), row[toks.numpy()], atol=1e-5)


def test_seeded_streams_repeat_whatever_the_batch():
    rng = np.random.default_rng(3)
    v = 50
    logits = rng.standard_normal((5, v)).astype(np.float32)

    def draw(order, seeds, draws):
        st = ts.SamplingState(
            temperature=torch.full((5,), 0.9), top_k=torch.zeros(5, dtype=torch.int32),
            top_p=torch.full((5,), 0.95), frequency_penalty=torch.zeros(5),
            presence_penalty=torch.zeros(5), repetition_penalty=torch.ones(5),
            seeds=torch.tensor(seeds)[order], draws=torch.tensor(draws)[order],
            token_counts=torch.zeros((5, v), dtype=torch.int32))
        toks, _ = ts.sample(torch.from_numpy(logits[order]), st)
        out = np.empty(5, np.int64)
        out[order] = toks.numpy()
        return out

    seeds, draws = [7, 7, 8, 9, 2**40 + 7], [0, 1, 0, 0, 0]
    a = draw(np.arange(5), seeds, draws)
    b = draw(np.array([3, 0, 4, 2, 1]), seeds, draws)
    np.testing.assert_array_equal(a, b)
    many = [draw(np.arange(5), [7] * 5, [d] * 5)[0] for d in range(40)]
    assert len(set(many)) > 3  # the draw counter moves the stream
