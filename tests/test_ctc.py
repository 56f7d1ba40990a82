"""CTC loss tests (the analogue of warp-ctc's own test suite).

Checks, in increasing strength:
  1. brute-force path enumeration on tiny cases,
  2. an independent numpy DP implementation on random batches,
  3. alpha-beta gradient vs autodiff of the forward-only loss,
  4. parity with optax.ctc_loss,
  5. infeasible-utterance masking, greedy collapse.
"""

import itertools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from kaldi_ctc_tpu.ops.ctc import (
    ctc_loss,
    ctc_loss_and_grad,
    ctc_loss_forward_only,
    extend_labels,
    greedy_collapse,
)


def brute_force_ctc(log_probs, labels, blank=0):
    """Sum over all alignments by enumeration. log_probs: [T, A]."""
    t, a = log_probs.shape
    total = -np.inf
    for path in itertools.product(range(a), repeat=t):
        # collapse path
        collapsed = []
        prev = -1
        for p in path:
            if p != prev and p != blank:
                collapsed.append(p)
            prev = p
        if collapsed == list(labels):
            lp = sum(log_probs[i, p] for i, p in enumerate(path))
            total = np.logaddexp(total, lp)
    return -total


def numpy_ctc(log_probs, labels, blank=0):
    """Independent forward DP in numpy. log_probs: [T, A]."""
    ext = [blank]
    for l in labels:
        ext += [l, blank]
    s = len(ext)
    t = log_probs.shape[0]
    alpha = np.full((t, s), -np.inf)
    alpha[0, 0] = log_probs[0, ext[0]]
    if s > 1:
        alpha[0, 1] = log_probs[0, ext[1]]
    for i in range(1, t):
        for j in range(s):
            cand = alpha[i - 1, j]
            if j > 0:
                cand = np.logaddexp(cand, alpha[i - 1, j - 1])
            if j > 1 and ext[j] != blank and ext[j] != ext[j - 2]:
                cand = np.logaddexp(cand, alpha[i - 1, j - 2])
            alpha[i, j] = cand + log_probs[i, ext[j]]
    res = alpha[t - 1, s - 1]
    if s > 1:
        res = np.logaddexp(res, alpha[t - 1, s - 2])
    return -res


def _random_case(rng, b, t, a, lmax):
    logits = rng.standard_normal((b, t, a)).astype(np.float32) * 2
    label_lens = rng.integers(1, lmax + 1, size=b)
    labels = np.zeros((b, lmax), dtype=np.int32)
    for i in range(b):
        labels[i, : label_lens[i]] = rng.integers(1, a, size=label_lens[i])
    input_lens = rng.integers(2 * lmax + 1, t + 1, size=b)
    return logits, labels, input_lens.astype(np.int32), label_lens.astype(np.int32)


def test_vs_brute_force():
    rng = np.random.default_rng(0)
    for labels in ([1], [1, 2], [2, 2], [1, 2, 1]):
        t, a = 5, 3
        logits = rng.standard_normal((1, t, a)).astype(np.float32)
        log_probs = np.asarray(jax.nn.log_softmax(jnp.asarray(logits[0])))
        want = brute_force_ctc(log_probs, labels)
        got = np.asarray(ctc_loss(
            jnp.asarray(logits),
            jnp.asarray([labels + [0] * (3 - len(labels))], dtype=jnp.int32),
            jnp.asarray([t], dtype=jnp.int32),
            jnp.asarray([len(labels)], dtype=jnp.int32)))[0]
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_vs_numpy_dp_batch():
    rng = np.random.default_rng(1)
    logits, labels, input_lens, label_lens = _random_case(rng, 8, 30, 12, 6)
    got = np.asarray(ctc_loss(*map(jnp.asarray, (logits, labels, input_lens,
                                                 label_lens))))
    for i in range(8):
        lp = np.asarray(jax.nn.log_softmax(
            jnp.asarray(logits[i, : input_lens[i]]))).astype(np.float64)
        want = numpy_ctc(lp, list(labels[i, : label_lens[i]]))
        np.testing.assert_allclose(got[i], want, rtol=1e-4, atol=1e-4)


def test_alpha_beta_grad_vs_autodiff():
    rng = np.random.default_rng(2)
    logits, labels, input_lens, label_lens = _random_case(rng, 4, 20, 8, 4)
    args = tuple(map(jnp.asarray, (labels, input_lens, label_lens)))
    _, grad_ab = ctc_loss_and_grad(jnp.asarray(logits), *args)
    grad_auto = jax.grad(
        lambda x: jnp.sum(ctc_loss_forward_only(x, *args)))(jnp.asarray(logits))
    np.testing.assert_allclose(np.asarray(grad_ab), np.asarray(grad_auto),
                               rtol=1e-3, atol=1e-4)


def test_custom_vjp_grad_vs_finite_diff():
    rng = np.random.default_rng(3)
    b, t, a = 2, 8, 4
    logits = rng.standard_normal((b, t, a)).astype(np.float64)
    labels = jnp.asarray([[1, 2], [3, 0]], dtype=jnp.int32)
    input_lens = jnp.asarray([8, 6], dtype=jnp.int32)
    label_lens = jnp.asarray([2, 1], dtype=jnp.int32)

    def f(x):
        return jnp.sum(ctc_loss(x.astype(jnp.float32), labels, input_lens,
                                label_lens))

    grad = np.asarray(jax.grad(lambda x: f(x))(jnp.asarray(logits,
                                                           dtype=jnp.float32)))
    eps = 1e-3
    for _ in range(10):
        i, j, k = rng.integers(b), rng.integers(t), rng.integers(a)
        lp = logits.copy(); lp[i, j, k] += eps
        lm = logits.copy(); lm[i, j, k] -= eps
        fd = (float(f(jnp.asarray(lp, dtype=jnp.float32)))
              - float(f(jnp.asarray(lm, dtype=jnp.float32)))) / (2 * eps)
        np.testing.assert_allclose(grad[i, j, k], fd, rtol=2e-2, atol=2e-3)


def test_vs_optax():
    import optax
    rng = np.random.default_rng(4)
    logits, labels, input_lens, label_lens = _random_case(rng, 6, 25, 10, 5)
    got = np.asarray(ctc_loss(*map(jnp.asarray, (logits, labels, input_lens,
                                                 label_lens))))
    t = logits.shape[1]
    logit_pad = (np.arange(t)[None, :] >= input_lens[:, None]).astype(np.float32)
    label_pad = (np.arange(labels.shape[1])[None, :]
                 >= label_lens[:, None]).astype(np.float32)
    want = np.asarray(optax.ctc_loss(
        jnp.asarray(logits), jnp.asarray(logit_pad),
        jnp.asarray(labels), jnp.asarray(label_pad), blank_id=0))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_infeasible_masked():
    rng = np.random.default_rng(5)
    logits = jnp.asarray(rng.standard_normal((2, 5, 4)).astype(np.float32))
    labels = jnp.asarray([[1, 1, 1], [1, 0, 0]], dtype=jnp.int32)
    # utt0: [1,1,1] needs >= 5 frames (3 emissions + 2 separator blanks) but
    # has only 4 -> zero probability; utt1 feasible
    loss, grad = ctc_loss_and_grad(
        logits, labels, jnp.asarray([4, 5]), jnp.asarray([3, 1]))
    assert float(loss[0]) == 0.0
    np.testing.assert_array_equal(np.asarray(grad[0]), 0.0)
    assert float(loss[1]) > 0.0
    assert np.abs(np.asarray(grad[1])).max() > 0.0
    assert np.isfinite(np.asarray(grad)).all()


def test_grad_zero_past_input_len():
    rng = np.random.default_rng(6)
    logits = jnp.asarray(rng.standard_normal((1, 10, 4)).astype(np.float32))
    _, grad = ctc_loss_and_grad(
        logits, jnp.asarray([[1, 2]], dtype=jnp.int32),
        jnp.asarray([6]), jnp.asarray([2]))
    np.testing.assert_array_equal(np.asarray(grad[0, 6:]), 0.0)
    assert np.abs(np.asarray(grad[0, :6])).max() > 0


def test_extend_labels():
    ext = np.asarray(extend_labels(jnp.asarray([[1, 2, 3]], dtype=jnp.int32)))
    np.testing.assert_array_equal(ext[0], [0, 1, 0, 2, 0, 3, 0])


def test_greedy_collapse():
    ids = jnp.asarray([[0, 1, 1, 0, 2, 2, 2, 0],
                       [3, 3, 0, 3, 0, 0, 1, 9]], dtype=jnp.int32)
    lens = jnp.asarray([8, 7])  # second utt: last frame masked out
    out, out_lens = greedy_collapse(ids, lens)
    out = np.asarray(out); out_lens = np.asarray(out_lens)
    assert list(out[0][: out_lens[0]]) == [1, 2]
    assert list(out[1][: out_lens[1]]) == [3, 3, 1]


def test_loss_decreases_when_training_tiny():
    # one gradient-descent sanity loop on a single utterance
    rng = np.random.default_rng(7)
    logits = jnp.asarray(rng.standard_normal((1, 12, 5)).astype(np.float32))
    labels = jnp.asarray([[1, 2, 3]], dtype=jnp.int32)
    il = jnp.asarray([12]); ll = jnp.asarray([3])

    @jax.jit
    def step(x):
        loss, grad = ctc_loss_and_grad(x, labels, il, ll)
        return x - 0.5 * grad, loss

    losses = []
    x = logits
    for _ in range(50):
        x, loss = step(x)
        losses.append(float(loss[0]))
    assert losses[-1] < losses[0] * 0.2
    # greedy decode of the trained logits recovers the labels
    ids = jnp.argmax(x, axis=-1)
    out, out_lens = greedy_collapse(ids, il)
    assert list(np.asarray(out)[0][: int(out_lens[0])]) == [1, 2, 3]


# ---------------------------------------------------------------------------
# ctc_loss_and_grad against the float64 numpy alpha-beta reference
# ---------------------------------------------------------------------------

def _vs_reference(logits, labels, input_lens, label_lens, tol=1e-4):
    from kaldi_ctc_tpu import reference
    loss, grad = ctc_loss_and_grad(*map(jnp.asarray, (
        logits, labels, input_lens, label_lens)))
    want_loss, want_grad = reference.ctc_loss_and_grad(
        logits, labels, input_lens, label_lens)
    np.testing.assert_allclose(np.asarray(loss), want_loss, rtol=1e-5,
                               atol=tol)
    np.testing.assert_allclose(np.asarray(grad), want_grad, rtol=0,
                               atol=tol)
    return np.asarray(loss)


@pytest.mark.parametrize("seed", [0, 1])
def test_loss_and_grad_match_reference(seed):
    rng = np.random.default_rng(seed)
    _vs_reference(*_random_case(rng, b=6, t=24, a=10, lmax=5))


def test_infeasible_and_short_utts_match_reference():
    logits = np.random.default_rng(2).standard_normal((3, 9, 5)).astype(
        np.float32)
    labels = np.asarray([[1, 1, 1, 0], [2, 3, 0, 0], [4, 0, 0, 0]], np.int32)
    # utt0 infeasible ([1,1,1] needs 5 frames), utt2 only 3 frames long
    loss = _vs_reference(logits, labels, np.asarray([4, 9, 3]),
                         np.asarray([3, 2, 1]))
    assert loss[0] == 0.0 and loss[1] > 0.0 and loss[2] > 0.0


def test_empty_label_batch_matches_reference():
    """All-empty transcripts: extended width S=1 (blank only)."""
    logits = np.random.default_rng(0).standard_normal((2, 6, 5)).astype(
        np.float32)
    _vs_reference(logits, np.zeros((2, 0), np.int32),
                  np.asarray([6, 4]), np.zeros((2,), np.int32))
