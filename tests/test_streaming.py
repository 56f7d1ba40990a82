"""Streaming recognition: chunked forward with state carry must match
offline full-utterance greedy decoding exactly (unidirectional models)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from kaldi_ctc_tpu.decoding.greedy import greedy_decode
from kaldi_ctc_tpu.decoding.streaming import StreamingRecognizer
from kaldi_ctc_tpu.models.acoustic import AmConfig, am_forward, init_am_params
from kaldi_ctc_tpu.ops.rnn import (
    RnnMode,
    init_stream_state,
    rnn_forward,
    rnn_forward_stream,
)

T, D, H = 37, 6, 12


def _cfg(mode):
    return AmConfig(input_dim=D, num_targets=5, hidden_dim=H, num_layers=2,
                    mode=mode, bidirectional=False)


@pytest.mark.parametrize("mode", [RnnMode.LSTM, RnnMode.GRU, RnnMode.TANH])
def test_stream_forward_matches_full(mode):
    cfg = _cfg(mode)
    params = init_am_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((T, 1, D)).astype(np.float32))

    y_full = rnn_forward(params["rnn"], x, cfg.rnn,
                         jnp.full((1,), T, jnp.int32))
    states = init_stream_state(cfg.rnn, 1)
    outs = []
    for lo in range(0, T, 10):
        y, states = rnn_forward_stream(params["rnn"], x[lo:lo + 10],
                                       cfg.rnn, states)
        outs.append(y)
    y_stream = jnp.concatenate(outs, axis=0)
    np.testing.assert_allclose(np.asarray(y_stream), np.asarray(y_full),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("chunk", [7, 10, 37])
def test_recognizer_matches_offline_greedy(chunk):
    cfg = _cfg(RnnMode.LSTM)
    params = init_am_params(jax.random.PRNGKey(1), cfg)
    rng = np.random.default_rng(1)
    # peaky features so argmax labels vary across frames
    feats = (rng.standard_normal((T, D)) * 2).astype(np.float32)

    logits = am_forward(params, jnp.asarray(feats)[None], cfg,
                        input_lens=jnp.full((1,), T, jnp.int32))
    scores = jax.nn.log_softmax(logits, axis=-1)
    labels, lens = greedy_decode(scores, jnp.full((1,), T, jnp.int32))
    offline = list(np.asarray(labels)[0][: int(np.asarray(lens)[0])])

    rec = StreamingRecognizer(params, cfg)
    for lo in range(0, T, chunk):
        rec.process(feats[lo:lo + chunk])
    assert rec.finalize() == offline


def test_recognizer_rejects_bidirectional():
    cfg = AmConfig(input_dim=D, num_targets=5, hidden_dim=H, num_layers=1,
                   mode=RnnMode.LSTM, bidirectional=True)
    params = init_am_params(jax.random.PRNGKey(0), cfg)
    with pytest.raises(ValueError):
        StreamingRecognizer(params, cfg)


def test_reset():
    cfg = _cfg(RnnMode.GRU)
    params = init_am_params(jax.random.PRNGKey(2), cfg)
    rng = np.random.default_rng(3)
    feats = (rng.standard_normal((20, D)) * 2).astype(np.float32)
    rec = StreamingRecognizer(params, cfg)
    rec.process(feats)
    first = rec.finalize()
    rec.reset()
    rec.process(feats)
    assert rec.finalize() == first


def test_batch_streaming_matches_single():
    """Each slot of the batched recognizer matches the single-stream one,
    including ragged chunk lengths and a mid-run slot reset."""
    from kaldi_ctc_tpu.decoding.streaming import BatchStreamingRecognizer

    cfg = _cfg(RnnMode.LSTM)
    params = init_am_params(jax.random.PRNGKey(5), cfg)
    rng = np.random.default_rng(7)
    n_streams, chunk = 3, 10
    utts = [(rng.standard_normal((25 + 6 * i, D)) * 2).astype(np.float32)
            for i in range(n_streams)]

    # single-stream references
    singles = []
    for f in utts:
        rec = StreamingRecognizer(params, cfg)
        rec.process(f)
        singles.append(rec.finalize())

    batch_rec = BatchStreamingRecognizer(params, cfg, n_streams, chunk)
    pos = [0] * n_streams
    done = [False] * n_streams
    while not all(done):
        block = np.zeros((n_streams, chunk, D), np.float32)
        valid = np.zeros(n_streams, np.int64)
        for s in range(n_streams):
            if done[s]:
                continue
            take = min(chunk, utts[s].shape[0] - pos[s])
            block[s, :take] = utts[s][pos[s]:pos[s] + take]
            valid[s] = take
            pos[s] += take
            if pos[s] >= utts[s].shape[0]:
                done[s] = True
        batch_rec.process(block, valid)
    for s in range(n_streams):
        assert batch_rec.finalize(s) == singles[s], s

    # slot reset: re-stream utt 0 through slot 1 and match again
    batch_rec.reset_slot(1)
    pos1 = 0
    while pos1 < utts[0].shape[0]:
        block = np.zeros((n_streams, chunk, D), np.float32)
        valid = np.zeros(n_streams, np.int64)
        take = min(chunk, utts[0].shape[0] - pos1)
        block[1, :take] = utts[0][pos1:pos1 + take]
        valid[1] = take
        pos1 += take
        batch_rec.process(block, valid)
    assert batch_rec.finalize(1) == singles[0]


def test_stream_forward_masks_outputs():
    """Frames past lens[b] produce zero output (documented contract)."""
    import jax
    import jax.numpy as jnp
    from kaldi_ctc_tpu.ops.rnn import (
        RnnConfig, RnnMode, init_rnn_params, init_stream_state,
        rnn_forward_stream)
    cfg = RnnConfig(input_dim=4, hidden_dim=6, num_layers=2,
                    mode=RnnMode.LSTM, bidirectional=False)
    params = init_rnn_params(jax.random.PRNGKey(0), cfg)
    states = init_stream_state(cfg, batch=3)
    x = jnp.asarray(np.random.default_rng(1)
                    .standard_normal((5, 3, 4)).astype(np.float32))
    lens = jnp.array([5, 2, 0], jnp.int32)
    y, _ = rnn_forward_stream(params, x, cfg, states, lens=lens)
    y = np.asarray(y)
    assert np.abs(y[2:, 1]).max() == 0.0
    assert np.abs(y[:, 2]).max() == 0.0
    assert np.abs(y[:, 0]).max() > 0.0


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 0.0)])
def test_five_layer_chunked_stream_matches_offline(dtype, tol):
    """5-layer unidirectional LSTM (the serving depth): ragged chunked
    streaming with per-stream lengths equals the offline forward.  In
    bf16 both paths round the same values the same way, so they agree
    exactly."""
    from kaldi_ctc_tpu.ops.rnn import RnnConfig, init_rnn_params

    cfg = RnnConfig(input_dim=D, hidden_dim=H, num_layers=5,
                    mode=RnnMode.LSTM, bidirectional=False,
                    compute_dtype=dtype)
    params = init_rnn_params(jax.random.PRNGKey(2), cfg)
    b, t = 3, 23
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.standard_normal((t, b, D)).astype(np.float32))
    lens = jnp.asarray([t, t - 4, 5], np.int32)
    offline = rnn_forward(params, x, cfg, lens)
    states = init_stream_state(cfg, b)
    outs = []
    for lo in range(0, t, 7):
        chunk_lens = jnp.clip(lens - lo, 0, min(7, t - lo))
        y, states = rnn_forward_stream(params, x[lo:lo + 7], cfg, states,
                                       lens=chunk_lens)
        outs.append(y)
    streamed = jnp.concatenate(outs, axis=0)
    assert streamed.dtype == offline.dtype == jnp.dtype(dtype)
    np.testing.assert_allclose(np.asarray(streamed, np.float32),
                               np.asarray(offline, np.float32),
                               rtol=tol, atol=tol)
