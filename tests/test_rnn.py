"""Recurrent stack tests.

Analogue of nnet2/nnet-component-test.cc's derivative checks plus parity
against an independent per-timestep numpy implementation.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from kaldi_ctc_tpu.ops.rnn import (
    RnnConfig,
    RnnMode,
    init_rnn_params,
    rnn_forward,
)


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _naive_lstm(x, lens, p, h_dim, reverse=False):
    """Per-timestep numpy LSTM, one direction. x: [T, B, D]."""
    t_max, b, _ = x.shape
    w_x, w_h, bias = (np.asarray(p["w_x"], np.float64),
                      np.asarray(p["w_h"], np.float64),
                      np.asarray(p["b"], np.float64))
    h = np.zeros((b, h_dim))
    c = np.zeros((b, h_dim))
    out = np.zeros((t_max, b, h_dim))
    order = range(t_max - 1, -1, -1) if reverse else range(t_max)
    for t in order:
        gates = x[t].astype(np.float64) @ w_x + h @ w_h + bias
        i, f, g, o = np.split(gates, 4, axis=-1)
        i, f, o = _sigmoid(i), _sigmoid(f), _sigmoid(o)
        g = np.tanh(g)
        c_new = f * c + i * g
        h_new = o * np.tanh(c_new)
        v = (t < lens)[:, None]
        h = np.where(v, h_new, h)
        c = np.where(v, c_new, c)
        out[t] = np.where(v, h, 0.0)
    return out


def test_lstm_matches_naive():
    cfg = RnnConfig(input_dim=6, hidden_dim=5, num_layers=1,
                    mode=RnnMode.LSTM, bidirectional=False)
    params = init_rnn_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((7, 3, 6)).astype(np.float32)
    lens = np.asarray([7, 5, 3])
    got = np.asarray(rnn_forward(params, jnp.asarray(x), cfg,
                                 jnp.asarray(lens)))
    want = _naive_lstm(x, lens, params[0]["dirs"][0], 5)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)


def test_blstm_matches_naive_both_directions():
    cfg = RnnConfig(input_dim=4, hidden_dim=3, num_layers=1,
                    mode=RnnMode.LSTM, bidirectional=True)
    params = init_rnn_params(jax.random.PRNGKey(1), cfg)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((6, 2, 4)).astype(np.float32)
    lens = np.asarray([6, 4])
    got = np.asarray(rnn_forward(params, jnp.asarray(x), cfg,
                                 jnp.asarray(lens)))
    fwd = _naive_lstm(x, lens, params[0]["dirs"][0], 3)
    bwd = _naive_lstm(x, lens, params[0]["dirs"][1], 3, reverse=True)
    np.testing.assert_allclose(got[..., :3], fwd, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(got[..., 3:], bwd, rtol=2e-3, atol=2e-4)


def test_backward_direction_ignores_pad_frames():
    """Masked recurrence: pad frames must not affect the backward pass."""
    cfg = RnnConfig(input_dim=4, hidden_dim=3, num_layers=2,
                    mode=RnnMode.LSTM, bidirectional=True)
    params = init_rnn_params(jax.random.PRNGKey(2), cfg)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((8, 2, 4)).astype(np.float32)
    lens = jnp.asarray([8, 5])
    y1 = rnn_forward(params, jnp.asarray(x), cfg, lens)
    x2 = x.copy()
    x2[5:, 1, :] = 99.0  # garbage in utt1's pad region
    y2 = rnn_forward(params, jnp.asarray(x2), cfg, lens)
    np.testing.assert_allclose(np.asarray(y1), np.asarray(y2),
                               rtol=1e-5, atol=1e-6)
    # outputs at pad frames are zero
    np.testing.assert_array_equal(np.asarray(y1)[5:, 1, :], 0.0)


@pytest.mark.parametrize("mode", [RnnMode.RELU, RnnMode.TANH, RnnMode.GRU,
                                  RnnMode.LSTM])
def test_modes_run_and_differentiate(mode):
    cfg = RnnConfig(input_dim=5, hidden_dim=4, num_layers=2, mode=mode,
                    bidirectional=True)
    params = init_rnn_params(jax.random.PRNGKey(3), cfg)
    x = jax.random.normal(jax.random.PRNGKey(4), (6, 3, 5))
    lens = jnp.asarray([6, 4, 2])

    def loss_fn(p):
        return jnp.sum(rnn_forward(p, x, cfg, lens) ** 2)

    val, grads = jax.value_and_grad(loss_fn)(params)
    assert np.isfinite(float(val))
    leaves = jax.tree_util.tree_leaves(grads)
    assert all(np.isfinite(np.asarray(l)).all() for l in leaves)
    assert any(np.abs(np.asarray(l)).max() > 0 for l in leaves)


def test_gru_finite_difference():
    cfg = RnnConfig(input_dim=3, hidden_dim=2, num_layers=1,
                    mode=RnnMode.GRU, bidirectional=False,
                    param_stddev=0.5)
    params = init_rnn_params(jax.random.PRNGKey(5), cfg)
    x = jax.random.normal(jax.random.PRNGKey(6), (4, 2, 3))
    lens = jnp.asarray([4, 3])

    def loss_fn(w_h):
        p = [{"dirs": [{**params[0]["dirs"][0], "w_h": w_h}]}]
        return jnp.sum(rnn_forward(p, x, cfg, lens) ** 2)

    w_h = params[0]["dirs"][0]["w_h"]
    grad = np.asarray(jax.grad(loss_fn)(w_h))
    rng = np.random.default_rng(3)
    eps = 1e-3
    for _ in range(5):
        i, j = rng.integers(w_h.shape[0]), rng.integers(w_h.shape[1])
        wp = np.asarray(w_h).copy(); wp[i, j] += eps
        wm = np.asarray(w_h).copy(); wm[i, j] -= eps
        fd = (float(loss_fn(jnp.asarray(wp)))
              - float(loss_fn(jnp.asarray(wm)))) / (2 * eps)
        np.testing.assert_allclose(grad[i, j], fd, rtol=2e-2, atol=1e-4)


def test_stack_shapes():
    cfg = RnnConfig(input_dim=40, hidden_dim=16, num_layers=3,
                    mode=RnnMode.LSTM, bidirectional=True)
    params = init_rnn_params(jax.random.PRNGKey(7), cfg)
    x = jnp.zeros((10, 4, 40))
    y = rnn_forward(params, x, cfg)
    assert y.shape == (10, 4, 32)
    # parameter shapes: layer 0 input 40, layers 1-2 input 32
    assert params[0]["dirs"][0]["w_x"].shape == (40, 64)
    assert params[1]["dirs"][0]["w_x"].shape == (32, 64)
    assert params[1]["dirs"][0]["w_h"].shape == (16, 64)


# ---------------------------------------------------------------------------
# lax.scan stacks against the float64 numpy reference (kaldi_ctc_tpu.reference)
# ---------------------------------------------------------------------------

from kaldi_ctc_tpu import reference  # noqa: E402


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _case(mode, bidirectional, *, h=8, layers=1, t=12, b=3, d=5, seed=0,
          dtype="float32", stddev=0.3):
    cfg = RnnConfig(input_dim=d, hidden_dim=h, num_layers=layers, mode=mode,
                    bidirectional=bidirectional, param_stddev=stddev,
                    compute_dtype=dtype)
    params = init_rnn_params(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, b, d)).astype(np.float32)
    lens = np.asarray([t] + [max(1, t - 3 * i - 2) for i in range(1, b)])
    dy = rng.standard_normal((t, b, cfg.output_dim)).astype(np.float32)
    return cfg, params, x, lens, dy


def _grad(params, x, cfg, lens, dy):
    def loss(p):
        y = rnn_forward(p, jnp.asarray(x), cfg, jnp.asarray(lens))
        return jnp.sum(y.astype(jnp.float32) * dy)
    return jax.grad(loss)(params)


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("what", ["values", "grads"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("mode", [RnnMode.LSTM, RnnMode.GRU])
def test_scan_direction_matches_reference(mode, reverse, what):
    """Each scan direction, in values and gradients, against the float64
    numpy recursion (f32 on CPU: agreement to float32 rounding)."""
    cfg, params, x, lens, dy = _case(mode, bidirectional=True)
    half = slice(cfg.hidden_dim, None) if reverse else slice(
        0, cfg.hidden_dim)
    mask = np.zeros_like(dy)
    mask[..., half] = dy[..., half]      # loss sees one direction only
    want_y, want_g, _ = reference.rnn_stack_grad(
        _np_tree(params), x, lens, int(mode), True, mask)
    d = 1 if reverse else 0
    if what == "values":
        got = np.asarray(rnn_forward(params, jnp.asarray(x), cfg,
                                     jnp.asarray(lens)))
        assert _rel_err(got[..., half], want_y[..., half]) < 1e-5
        return
    got_g = _grad(params, x, cfg, lens, mask)
    for k in ("w_x", "w_h", "b"):
        assert _rel_err(got_g[0]["dirs"][d][k],
                        want_g[0]["dirs"][d][k]) < 1e-5, k
        # the other direction does not reach the loss
        assert np.abs(np.asarray(got_g[0]["dirs"][1 - d][k])).max() == 0.0


def _reverse_valid(x, lens):
    """Reverse each sequence's valid prefix in time, leaving pad in place."""
    out = np.array(x, copy=True)
    for i, n in enumerate(lens):
        out[:n, i] = x[:n, i][::-1]
    return out


@pytest.mark.parametrize("what", ["forward", "gradient"])
@pytest.mark.parametrize("mode,h", [(RnnMode.LSTM, 8), (RnnMode.GRU, 8),
                                    (RnnMode.LSTM, 128)])
def test_bidirectional_stack_is_two_unidirectional_passes(mode, h, what):
    """A bidirectional layer equals a forward pass plus a forward pass
    over the time-reversed valid frames, reversed back — the reverse
    scan's masking checked against an independent formulation."""
    cfg, params, x, lens, dy = _case(mode, bidirectional=True, h=h,
                                     layers=2, stddev=0.1)

    def composed(p, x):
        out = x
        for lp in p:
            u = RnnConfig(input_dim=out.shape[-1], hidden_dim=h, mode=mode,
                          bidirectional=False)
            fwd = rnn_forward([{"dirs": [lp["dirs"][0]]}], out, u,
                              jnp.asarray(lens))
            rev_in = jnp.asarray(_reverse_valid(np.asarray(out), lens))
            bwd = rnn_forward([{"dirs": [lp["dirs"][1]]}], rev_in, u,
                              jnp.asarray(lens))
            bwd = jnp.asarray(_reverse_valid(np.asarray(bwd), lens))
            out = jnp.concatenate([fwd, bwd], axis=-1)
        return out

    if what == "forward":
        got = rnn_forward(params, jnp.asarray(x), cfg, jnp.asarray(lens))
        want = composed(params, jnp.asarray(x))
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
        return
    # gradient: compare against the f64 reference of the same stack
    # (the numpy reversal above is not differentiable)
    got_g = _grad(params, x, cfg, lens, dy)
    _, want_g, _ = reference.rnn_stack_grad(_np_tree(params), x, lens,
                                            int(mode), True, dy)
    for layer in range(2):
        for d in range(2):
            for k in ("w_x", "w_h", "b"):
                assert _rel_err(got_g[layer]["dirs"][d][k],
                                want_g[layer]["dirs"][d][k]) < 1e-4, (
                    layer, d, k)


def _scan_carries(jaxpr):
    """Avals of every lax.scan carry in a (closed) jaxpr, recursively."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "scan":
            nc, nk = eqn.params["num_consts"], eqn.params["num_carry"]
            out += [v.aval for v in eqn.invars[nc:nc + nk]]
        for sub in jax.core.jaxprs_in_params(eqn.params):
            out += _scan_carries(sub)
    return out


@pytest.mark.parametrize("mode", [RnnMode.LSTM, RnnMode.GRU, RnnMode.RELU,
                                  RnnMode.TANH])
def test_bf16_recurrent_weight_grad_accumulates_in_f32(mode):
    """bfloat16 mode: the w_h cotangent is f32, summed over T in an f32
    carry (no bf16 scan accumulator), and matches the float64 reference.

    Tolerance 1e-2 of the largest entry: the bf16 forward (projections
    and per-step operands rounded to 8 mantissa bits) leaves ~2e-3 here;
    summing the T=256 per-step contributions in a bf16 carry instead
    costs 3e-2 to 6e-2 at these shapes."""
    cfg, params, x, lens, _ = _case(mode, bidirectional=False, h=16, t=256,
                                    b=4, d=6, dtype="bfloat16", stddev=0.1)
    lens = np.asarray([256, 251, 236, 216])
    dy = np.ones((256, 4, 16), np.float32)   # coherent per-step terms
    got = _grad(params, x, cfg, lens, dy)[0]["dirs"][0]["w_h"]
    assert got.dtype == jnp.float32
    _, want, _ = reference.rnn_stack_grad(_np_tree(params), x, lens,
                                          int(mode), False, dy)
    assert _rel_err(got, want[0]["dirs"][0]["w_h"]) < 1e-2

    def loss(p):
        y = rnn_forward(p, jnp.asarray(x), cfg, jnp.asarray(lens))
        return jnp.sum(y.astype(jnp.float32))
    carries = _scan_carries(jax.make_jaxpr(jax.grad(loss))(params).jaxpr)
    assert carries, "no scan in the gradient"
    assert all(a.dtype != jnp.bfloat16 for a in carries), carries


@pytest.mark.parametrize("mode", [RnnMode.LSTM, RnnMode.GRU, RnnMode.RELU,
                                  RnnMode.TANH])
def test_ragged_lengths_mask_outputs_states_and_grads(mode):
    """Past lens[b]: outputs are zero, the carried state stops changing,
    and pad-frame contents reach neither outputs nor weight gradients."""
    from kaldi_ctc_tpu.ops.rnn import init_stream_state, rnn_forward_stream

    cfg, params, x, lens, dy = _case(mode, bidirectional=False, layers=2,
                                     stddev=0.3)
    x2 = x.copy()
    for i, n in enumerate(lens):
        x2[n:, i] = 50.0                     # garbage in the pad region
    y, states = rnn_forward_stream(params, jnp.asarray(x), cfg,
                                   init_stream_state(cfg, len(lens)),
                                   lens=jnp.asarray(lens))
    y2, states2 = rnn_forward_stream(params, jnp.asarray(x2), cfg,
                                     init_stream_state(cfg, len(lens)),
                                     lens=jnp.asarray(lens))
    y = np.asarray(y)
    for i, n in enumerate(lens):
        assert np.abs(y[n:, i]).max(initial=0.0) == 0.0
    np.testing.assert_array_equal(y, np.asarray(y2))
    for s1, s2 in zip(jax.tree_util.tree_leaves(states),
                      jax.tree_util.tree_leaves(states2)):
        np.testing.assert_array_equal(np.asarray(s1), np.asarray(s2))
    # the final state is the state after each stream's last valid frame
    short = [{"dirs": [lp["dirs"][0]]} for lp in params]
    last = int(lens[-1])
    _, st_short = rnn_forward_stream(short, jnp.asarray(x[:last]), cfg,
                                     init_stream_state(cfg, len(lens)))
    h_top = (states[-1][0] if mode == RnnMode.LSTM else states[-1])
    h_short = (st_short[-1][0] if mode == RnnMode.LSTM else st_short[-1])
    np.testing.assert_allclose(np.asarray(h_top)[-1],
                               np.asarray(h_short)[-1], rtol=1e-6,
                               atol=1e-7)
    g1 = _grad(params, x, cfg, lens, dy)
    g2 = _grad(params, x2, cfg, lens, dy)
    for a, b in zip(jax.tree_util.tree_leaves(g1),
                    jax.tree_util.tree_leaves(g2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
