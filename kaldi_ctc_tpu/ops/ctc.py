"""CTC loss: log-space alpha-beta over the blank-interleaved label lattice.

This is the replacement for warp-ctc (called by the reference at
``ctc/ctc-nnet-update.cc:200-248``): same contract — takes pre-softmax
activations, returns per-utterance negative log-likelihood and the gradient
w.r.t. the activations — with ``blank = 0``
(``ctc/ctc-nnet-update.cc:205``).  Deviations from the reference, by design:

- batch-major ``[B, T, A]`` activations (warp-ctc is time-major ``[T,N,A]``
  for cuDNN; batch-major is the natural XLA layout here),
- gradient sign: this returns d(loss)/d(activations) directly (the reference
  receives warp-ctc's gradient and applies ``deriv->Scale(-1)`` at
  ``ctc-nnet-update.cc:323`` because nnet2 maximizes; our trainer minimizes).

Utterances where ``T < 2L+1`` have zero probability; their loss contribution
and gradient are masked to 0 and flagged (the reference skips such egs —
``ctc/ctc-nnet-train.cc:86-94``).

Layout notes: the recursion is a ``lax.scan`` over time with the state
``alpha [B, S]`` as the carry; per-frame work is a gather from the
``[B, A]`` frame posteriors to ``[B, S]`` plus a 3-way shifted logaddexp —
elementwise, batched over B.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

__all__ = ["ctc_loss", "ctc_loss_and_grad", "extend_labels",
           "greedy_collapse", "ctc_loss_forward_only",
           "ctc_viterbi_align"]

_NEG_INF = -1e30  # finite stand-in for log(0); avoids inf-inf NaNs


def extend_labels(labels: jnp.ndarray, blank: int = 0) -> jnp.ndarray:
    """[B, L] labels → [B, 2L+1] blank-interleaved extended sequence.

    ext[2i] = blank, ext[2i+1] = labels[i].
    """
    b, l = labels.shape
    ext = jnp.full((b, 2 * l + 1), blank, dtype=labels.dtype)
    return ext.at[:, 1::2].set(labels)


def _transition_masks(ext: jnp.ndarray, blank: int) -> jnp.ndarray:
    """Mask [B, S] of states allowed to take the s-2 (skip) transition."""
    # pad-then-slice stays [B, S] even when S < 2 (empty label batches)
    s2 = jnp.pad(ext, ((0, 0), (2, 0)),
                 constant_values=-1)[:, :ext.shape[1]]
    return (ext != blank) & (ext != s2)


def _forward_alphas(log_probs, ext, skip_ok, input_lens, lp_ext=None):
    """Run the alpha recursion.

    Args:
      log_probs: [B, T, A] log-softmax activations.
      ext: [B, S] extended labels.
      skip_ok: [B, S] skip-transition mask.
      input_lens: [B].
      lp_ext: optional pre-gathered [T, B, S] extended-label log-probs
        (callers that already materialized it avoid a second gather).
    Returns:
      (alphas [T, B, S], log_z [B]) — log_z = total log-likelihood.
    """
    b, t_max, _ = log_probs.shape
    s_max = ext.shape[1]

    if lp_ext is None:
        # per-frame label log-probs, gathered once: [T, B, S]
        lp_ext = jnp.take_along_axis(
            log_probs, ext[:, None, :].astype(jnp.int32), axis=2)
        lp_ext = jnp.moveaxis(lp_ext, 1, 0)

    alpha0 = jnp.full((b, s_max), _NEG_INF)
    alpha0 = alpha0.at[:, 0].set(lp_ext[0, :, 0])
    if s_max > 1:
        alpha0 = alpha0.at[:, 1].set(lp_ext[0, :, 1])

    def shift1(x):
        # pad-then-slice stays shape-correct even when S < shift
        return jnp.pad(x, ((0, 0), (1, 0)),
                       constant_values=_NEG_INF)[:, :x.shape[1]]

    def shift2(x):
        return jnp.pad(x, ((0, 0), (2, 0)),
                       constant_values=_NEG_INF)[:, :x.shape[1]]

    def step(alpha, inputs):
        lp_t, t = inputs
        prev = jnp.logaddexp(alpha, shift1(alpha))
        prev = jnp.logaddexp(prev, jnp.where(skip_ok, shift2(alpha), _NEG_INF))
        new = jnp.maximum(prev, _NEG_INF) + lp_t
        new = jnp.maximum(new, _NEG_INF)
        # frames past the true length leave alpha unchanged
        new = jnp.where((t < input_lens)[:, None], new, alpha)
        return new, new

    ts = jnp.arange(1, t_max)
    _, alphas_rest = jax.lax.scan(step, alpha0, (lp_ext[1:], ts))
    alphas = jnp.concatenate([alpha0[None], alphas_rest], axis=0)

    final = alphas[-1]  # [B, S]; frames ≥ input_len left it unchanged
    return alphas, final


def _log_z(final_alpha: jnp.ndarray, label_lens: jnp.ndarray) -> jnp.ndarray:
    """logsumexp of the two terminal states S-1 = 2L, S-2 = 2L-1."""
    idx_last = 2 * label_lens  # ext index of trailing blank
    a_last = jnp.take_along_axis(final_alpha, idx_last[:, None], axis=1)[:, 0]
    idx_prev = jnp.maximum(idx_last - 1, 0)
    a_prev = jnp.take_along_axis(final_alpha, idx_prev[:, None], axis=1)[:, 0]
    a_prev = jnp.where(label_lens > 0, a_prev, _NEG_INF)
    return jnp.logaddexp(a_last, a_prev)


def _backward_betas(lp_ext_t, ext, skip_down, input_lens, label_lens):
    """Beta recursion (suffix probabilities), scanned in reverse.

    Args:
      lp_ext_t: [T, B, S] gathered label log-probs.
      ext: [B, S].
      skip_down: [B, S] mask for the s+2 transition out of state s.
      input_lens, label_lens: [B].
    Returns:
      betas [T, B, S].
    """
    t_max, b, s_max = lp_ext_t.shape
    s_idx = jnp.arange(s_max)[None, :]
    idx_last = (2 * label_lens)[:, None]

    # init at each utterance's own last frame: beta = lp at terminal states
    def init_row(lp_t):
        init = jnp.where((s_idx == idx_last) | (s_idx == idx_last - 1),
                         lp_t, _NEG_INF)
        return init

    def shift_up1(x):
        return jnp.pad(x, ((0, 0), (0, 1)),
                       constant_values=_NEG_INF)[:, 1:]

    def shift_up2(x):
        return jnp.pad(x, ((0, 0), (0, 2)),
                       constant_values=_NEG_INF)[:, 2:]

    beta_init = jnp.full((b, s_max), _NEG_INF)

    def step(beta, inputs):
        lp_t, t = inputs
        nxt = jnp.logaddexp(beta, shift_up1(beta))
        nxt = jnp.logaddexp(
            nxt, jnp.where(skip_down, shift_up2(beta), _NEG_INF))
        new = jnp.maximum(nxt, _NEG_INF) + lp_t
        new = jnp.maximum(new, _NEG_INF)
        is_last = (t == input_lens - 1)[:, None]
        new = jnp.where(is_last, init_row(lp_t), new)
        # frames past the end (t >= input_len): stay -inf until init fires
        new = jnp.where((t < input_lens)[:, None], new, beta)
        return new, new

    ts = jnp.arange(t_max - 1, -1, -1)
    _, betas_rev = jax.lax.scan(step, beta_init, (lp_ext_t[::-1], ts))
    return betas_rev[::-1]


def _ctc_forward(logits, labels, input_lens, label_lens, blank):
    log_probs = jax.nn.log_softmax(logits, axis=-1)
    ext = extend_labels(labels, blank)
    skip_ok = _transition_masks(ext, blank)
    _, final = _forward_alphas(log_probs, ext, skip_ok, input_lens)
    log_z = _log_z(final, label_lens)
    # Infeasible (zero-probability) utterances — e.g. T too short for the
    # label sequence — have log_z at the -inf stand-in; mask them to 0.
    # (The reference's stricter 2L+1 skip rule lives in the data pipeline,
    # ctc/ctc-nnet-train.cc:86-94.)
    feasible = log_z > 0.5 * _NEG_INF
    loss = jnp.where(feasible, -log_z, 0.0)
    return loss, feasible


@functools.partial(jax.custom_vjp, nondiff_argnums=(4,))
def ctc_loss(logits, labels, input_lens, label_lens, blank=0):
    """Per-utterance CTC negative log-likelihood.

    Args:
      logits: [B, T, A] pre-softmax activations.
      labels: [B, L] padded label ids (values in [1, A); 0 is blank).
      input_lens: [B] frames per utterance.
      label_lens: [B] labels per utterance.
      blank: blank id (static; 0 by the framework convention).
    Returns:
      loss [B] (0 for infeasible utterances where T < 2L+1).
    """
    loss, _ = _ctc_forward(logits, labels, input_lens, label_lens, blank)
    return loss


def _ctc_fwd(logits, labels, input_lens, label_lens, blank):
    loss, grad = ctc_loss_and_grad(
        logits, labels, input_lens, label_lens, blank)
    return loss, grad


def _ctc_bwd(blank, grad_residual, g):
    # g: [B] cotangent of per-utterance losses
    dlogits = grad_residual * g[:, None, None]
    return dlogits, None, None, None


ctc_loss.defvjp(_ctc_fwd, _ctc_bwd)


def ctc_loss_and_grad(
    logits, labels, input_lens, label_lens, blank: int = 0,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Loss [B] and d(loss)/d(logits) [B, T, A] via the alpha-beta sweep.

    The gradient is the classic warp-ctc formula:
      d(-log Z)/d(logit[t,a]) = softmax(logit)[t,a]
          - (1/Z) * sum_{s: ext[s]=a} exp(alpha[t,s] + beta[t,s] - lp[t,a])
    """
    b, t_max, a_dim = logits.shape
    log_probs = jax.nn.log_softmax(logits, axis=-1)
    ext = extend_labels(labels, blank)
    s_max = ext.shape[1]
    skip_ok = _transition_masks(ext, blank)
    # skip_down[s]: transition s -> s+2 allowed == skip_ok at s+2
    skip_down = jnp.concatenate(
        [skip_ok[:, 2:], jnp.zeros((b, 2), dtype=bool)],
        axis=1)[:, :skip_ok.shape[1]]

    lp_ext = jnp.take_along_axis(
        log_probs, ext[:, None, :].astype(jnp.int32), axis=2)
    lp_ext_t = jnp.moveaxis(lp_ext, 1, 0)  # [T, B, S]

    alphas, final = _forward_alphas(log_probs, ext, skip_ok, input_lens,
                                    lp_ext=lp_ext_t)
    log_z = _log_z(final, label_lens)
    betas = _backward_betas(lp_ext_t, ext, skip_down, input_lens, label_lens)

    # state posteriors: gamma = alpha + beta - lp (lp counted twice)
    gamma = alphas + betas - lp_ext_t  # [T, B, S]
    post = jnp.exp(jnp.minimum(gamma - log_z[None, :, None], 0.0))
    # mask states/frames outside the valid region
    t_idx = jnp.arange(t_max)[:, None, None]
    s_idx = jnp.arange(s_max)[None, None, :]
    valid_t = t_idx < input_lens[None, :, None]
    valid_s = s_idx <= 2 * label_lens[None, :, None]
    post = jnp.where(valid_t & valid_s, post, 0.0)

    # Sum posteriors back to the alphabet dim: [T, B, S] -> [B, T, A],
    # as a batched matmul against a one-hot of the extended labels (a
    # dense contraction instead of a serializing scatter-add).
    post_bt = jnp.moveaxis(post, 0, 1)  # [B, T, S]
    onehot = jax.nn.one_hot(ext.astype(jnp.int32), a_dim,
                            dtype=post.dtype)  # [B, S, A]
    label_post = jnp.einsum("bts,bsa->bta", post_bt, onehot,
                            preferred_element_type=jnp.float32,
                            precision=jax.lax.Precision.HIGHEST)

    feasible = (log_z > 0.5 * _NEG_INF)[:, None, None]
    valid_bt = jnp.moveaxis(valid_t, 0, 1)  # [B, T, 1]
    probs = jnp.exp(log_probs)
    grad = jnp.where(feasible & valid_bt, probs - label_post, 0.0)
    loss = jnp.where(feasible[:, 0, 0], -log_z, 0.0)
    return loss, grad


def ctc_loss_forward_only(logits, labels, input_lens, label_lens, blank=0):
    """Loss without the custom vjp (differentiable via XLA autodiff).

    Used in tests as an independent gradient check against the
    alpha-beta gradient.
    """
    loss, _ = _ctc_forward(logits, labels, input_lens, label_lens, blank)
    return loss


def ctc_viterbi_align(logits, labels, input_lens, label_lens, blank=0):
    """CTC forced alignment: the Viterbi path through the
    blank-interleaved label lattice.

    The CTC-native replacement for the reference's realignment flow
    (``steps/nnet2/align.sh`` + ``steps/ctc/relabel_egs2.sh``; left as a
    TODO in ``steps/ctc/train.sh:111-115``): instead of a GMM/HMM
    Viterbi over compiled training graphs, the best path through the
    same 2L+1 lattice the loss uses — batched, static-shape, one
    ``lax.scan`` forward + one for the backtrace.

    Args:
      logits: [B, T, A] pre-softmax activations.
      labels: [B, L] padded label ids (values in [1, A); `blank` free).
      input_lens, label_lens: [B].
    Returns:
      (frame_labels [B, T] int32 — per-frame emitted symbol in the
       model's output space (blank at pad frames and blank states),
       path_logprob [B], feasible [B] — False when T < 2L+1).
    """
    log_probs = jax.nn.log_softmax(logits, axis=-1)
    b, t_max, _ = log_probs.shape
    ext = extend_labels(labels, blank)  # [B, S]
    s_max = ext.shape[1]
    skip_ok = _transition_masks(ext, blank)
    lp_ext = jnp.take_along_axis(
        log_probs, ext[:, None, :].astype(jnp.int32), axis=2)
    lp_ext_t = jnp.moveaxis(lp_ext, 1, 0)  # [T, B, S]

    def shift1(x):
        return jnp.pad(x, ((0, 0), (1, 0)),
                       constant_values=_NEG_INF)[:, :x.shape[1]]

    def shift2(x):
        return jnp.pad(x, ((0, 0), (2, 0)),
                       constant_values=_NEG_INF)[:, :x.shape[1]]

    delta0 = jnp.full((b, s_max), _NEG_INF)
    delta0 = delta0.at[:, 0].set(lp_ext_t[0, :, 0])
    if s_max > 1:
        delta0 = delta0.at[:, 1].set(lp_ext_t[0, :, 1])

    def step(delta, inputs):
        lp_t, t = inputs
        cands = jnp.stack([
            delta,
            shift1(delta),
            jnp.where(skip_ok, shift2(delta), _NEG_INF),
        ])  # [3, B, S]
        choice = jnp.argmax(cands, axis=0).astype(jnp.int8)
        best = jnp.max(cands, axis=0)
        new = jnp.maximum(best + lp_t, _NEG_INF)
        active = (t < input_lens)[:, None]
        new = jnp.where(active, new, delta)
        choice = jnp.where(active, choice, jnp.int8(0))
        return new, choice

    ts = jnp.arange(1, t_max)
    delta_last, bps = jax.lax.scan(step, delta0, (lp_ext_t[1:], ts))
    # bps: [T-1, B, S] back-pointers (0: stay, 1: s-1, 2: s-2)

    # terminal state: better of ext indices 2L (trailing blank) / 2L-1
    idx_last = 2 * label_lens
    d_last = jnp.take_along_axis(delta_last, idx_last[:, None], axis=1)[:, 0]
    idx_prev = jnp.maximum(idx_last - 1, 0)
    d_prev = jnp.take_along_axis(delta_last, idx_prev[:, None], axis=1)[:, 0]
    d_prev = jnp.where(label_lens > 0, d_prev, _NEG_INF)
    s_final = jnp.where(d_last >= d_prev, idx_last, idx_prev).astype(jnp.int32)
    path_logprob = jnp.maximum(d_last, d_prev)
    feasible = path_logprob > 0.5 * _NEG_INF

    # backtrace: s[t-1] = s[t] - bp[t, s[t]] while t-1 is a real frame
    def back(s, inputs):
        bp_t, t = inputs
        step_back = jnp.take_along_axis(
            bp_t, s[:, None].astype(jnp.int32), axis=1)[:, 0]
        s_prev = jnp.where(t < input_lens, s - step_back, s)
        return s_prev.astype(jnp.int32), s_prev.astype(jnp.int32)

    _, states_rev = jax.lax.scan(
        back, s_final, (bps[::-1], jnp.arange(t_max - 1, 0, -1)))
    states = jnp.concatenate(
        [states_rev[::-1], s_final[None]], axis=0)  # [T, B]

    frame_labels = jnp.take_along_axis(
        ext, jnp.moveaxis(states, 0, 1).astype(jnp.int32), axis=1)
    valid = jnp.arange(t_max)[None, :] < input_lens[:, None]
    frame_labels = jnp.where(valid & feasible[:, None],
                             frame_labels, blank).astype(jnp.int32)
    return frame_labels, path_logprob, feasible


def greedy_collapse(
    argmax_ids: jnp.ndarray, input_lens: jnp.ndarray, blank: int = 0,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Collapse framewise argmax ids: drop repeats, then blanks.

    The decode rule of ComputeTotAccuracy (ctc-nnet-update.cc:261-317) and
    of greedy best-path decoding.  Vectorized: keep positions where the id
    differs from its predecessor and is not blank, then compact left.

    Args:
      argmax_ids: [B, T] framewise argmax.
      input_lens: [B].
    Returns:
      (collapsed [B, T] padded with `blank`, lengths [B]).
    """
    b, t = argmax_ids.shape
    prev = jnp.concatenate(
        [jnp.full((b, 1), -1, dtype=argmax_ids.dtype), argmax_ids[:, :-1]],
        axis=1)
    in_range = jnp.arange(t)[None, :] < input_lens[:, None]
    keep = (argmax_ids != prev) & (argmax_ids != blank) & in_range
    # stable compaction: position of each kept element in the output
    pos = jnp.cumsum(keep, axis=1) - 1
    scatter_pos = jnp.where(keep, pos, t)  # dropped → out-of-range column t
    out_padded = jnp.zeros((b, t + 1), dtype=argmax_ids.dtype)
    out = out_padded.at[jnp.arange(b)[:, None], scatter_pos].set(
        jnp.where(keep, argmax_ids, 0))[:, :t]
    lens = jnp.sum(keep, axis=1)
    return out, lens
