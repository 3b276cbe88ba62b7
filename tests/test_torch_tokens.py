"""Port parity: the synthetic token pipeline (``repro_torch.data.tokens``).

Twins of the reference's token tests (``tests/test_parallel.py``): the
stream replays, resumes at ``start_step``, has a heavy head and shifts its
labels.  The port draws from a ``torch.Generator`` seeded from (seed, step),
the reference from ``jax.random``: the streams differ in their bits (a
deliberate difference), so the reference is held to the same properties,
not to the same numbers.
"""

import jax
import numpy as np
import pytest
import torch

from repro.data.tokens import synthetic_token_batch as jax_batch
from repro_torch.data import tokens


def _take(stream, n):
    return [next(stream) for _ in range(n)]


def test_token_batches_replayable():
    a = _take(tokens.synthetic_token_batches(0, batch=2, seq=16, vocab=100), 3)
    b = _take(tokens.synthetic_token_batches(0, batch=2, seq=16, vocab=100), 3)
    for x, y in zip(a, b):
        assert torch.equal(x.tokens, y.tokens)
        assert torch.equal(x.labels, y.labels)
    # resume mid-stream: start_step=2 reproduces batch 2
    c = next(tokens.synthetic_token_batches(0, batch=2, seq=16, vocab=100,
                                            start_step=2))
    assert torch.equal(c.tokens, a[2].tokens)


def test_steps_and_seeds_give_different_batches():
    a = _take(tokens.synthetic_token_batches(0, batch=2, seq=64, vocab=1000),
              2)
    b = next(tokens.synthetic_token_batches(1, batch=2, seq=64, vocab=1000))
    assert not torch.equal(a[0].tokens, a[1].tokens)
    assert not torch.equal(a[0].tokens, b.tokens)


@pytest.mark.parametrize("vocab", [2, 100, 1000, 50304])
def test_token_batch_is_zipfian(vocab):
    tb = tokens.synthetic_token_batch(tokens.step_generator(0, 0), batch=8,
                                      seq=512, vocab=vocab)
    ids = tb.tokens.numpy().ravel()
    assert tb.tokens.dtype == torch.int64
    assert (ids >= 0).all() and (ids < vocab).all()
    counts = np.bincount(ids, minlength=vocab)
    if vocab >= 100:
        # heavy head: token 0 much more frequent than the median token
        assert counts[0] > 10 * max(1, int(np.median(counts)))


def test_head_share_matches_reference():
    """The same power law: the share of token 0 (the inverse CDF gives
    p(0) = (1/V)^(1/skew)) in both packages' draws, within sampling
    noise."""
    vocab, n = 1000, (16, 1024)
    port = tokens.synthetic_token_batch(tokens.step_generator(3, 0),
                                        batch=n[0], seq=n[1], vocab=vocab)
    ref = jax_batch(jax.random.PRNGKey(3), batch=n[0], seq=n[1], vocab=vocab)
    share_port = float((port.tokens == 0).float().mean())
    share_ref = float((np.asarray(ref.tokens) == 0).mean())
    expected = (1.0 / vocab) ** 0.25
    for share in (share_port, share_ref):
        assert abs(share - expected) < 0.02, (share, expected)


def test_labels_are_tokens_shifted_left():
    tb = tokens.synthetic_token_batch(tokens.step_generator(5, 7), batch=3,
                                      seq=10, vocab=50)
    assert torch.equal(tb.labels[:, :-1], tb.tokens[:, 1:])
    assert torch.equal(tb.labels[:, -1], tb.tokens[:, 0])
    ref = jax_batch(jax.random.PRNGKey(0), batch=3, seq=10, vocab=50)
    rt, rl = np.asarray(ref.tokens), np.asarray(ref.labels)
    np.testing.assert_array_equal(rl, np.concatenate([rt[:, 1:], rt[:, :1]],
                                                     axis=1))


def test_fold_in_is_stable_and_spread():
    assert tokens.fold_in(0, 0) == tokens.fold_in(0, 0)
    seeds = {tokens.fold_in(s, t) for s in range(4) for t in range(64)}
    assert len(seeds) == 256
    assert all(0 <= s < 2**63 for s in seeds)
