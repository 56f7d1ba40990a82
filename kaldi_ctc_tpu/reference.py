"""Plain float64 numpy references for the device code paths.

Each function here is a straightforward, loop-level implementation of
the same semantics as a jitted path in the package, written
independently of it, so tests on the CPU and the GPU smoke check
(``chip_smoke.py``) can compare the device results against it:

- ``rnn_stack_grad``: the masked multi-layer (B)LSTM/GRU/ReLU/Tanh
  recurrence of ``ops/rnn.py`` (``rnn_forward``) with hand-written
  backpropagation through time;
- ``ctc_loss_and_grad``: the alpha-beta CTC loss and its gradient with
  respect to the logits, as ``ops/ctc.py`` defines them;
- ``fbank`` / ``mfcc``: the per-frame Kaldi feature computations of
  ``features/fbank.py`` and ``features/mfcc.py`` (snip_edges framing, no
  dither).
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

__all__ = ["rnn_stack_grad", "ctc_loss_and_grad", "fbank", "mfcc"]

_LSTM, _GRU, _RELU = 2, 3, 0   # RnnMode values (TANH = 1)


def _sigmoid(x):
    return 0.5 * (1.0 + np.tanh(0.5 * x))


def _layer_forward(x, lens, p, mode, reverse):
    """One direction of one layer. x [T, B, D] → (ys [T, B, H], tape)."""
    t_max, b, _ = x.shape
    w_x, w_h, bias = (np.asarray(p[k], np.float64)
                      for k in ("w_x", "w_h", "b"))
    h_dim = w_h.shape[0]
    xp = x @ w_x + bias
    h = np.zeros((b, h_dim))
    c = np.zeros((b, h_dim))
    ys = np.zeros((t_max, b, h_dim))
    tape: List[Any] = [None] * t_max
    for t in (range(t_max - 1, -1, -1) if reverse else range(t_max)):
        v = (t < lens)[:, None]
        hp = h @ w_h
        if mode == _LSTM:
            i, f, g, o = np.split(xp[t] + hp, 4, axis=-1)
            i, f, g, o = _sigmoid(i), _sigmoid(f), np.tanh(g), _sigmoid(o)
            c_new = f * c + i * g
            tc = np.tanh(c_new)
            h_new = o * tc
            tape[t] = (h, c, i, f, g, o, tc)
            c = np.where(v, c_new, c)
        elif mode == _GRU:
            xr, xz, xn = np.split(xp[t], 3, axis=-1)
            hr, hz, hn = np.split(hp, 3, axis=-1)
            r, z = _sigmoid(xr + hr), _sigmoid(xz + hz)
            n = np.tanh(xn + r * hn)
            h_new = (1.0 - z) * n + z * h
            tape[t] = (h, r, z, n, hn)
        else:
            a = xp[t] + hp
            h_new = np.maximum(a, 0.0) if mode == _RELU else np.tanh(a)
            tape[t] = (h, a, h_new)
        h = np.where(v, h_new, h)
        ys[t] = np.where(v, h, 0.0)
    return ys, (x, w_x, w_h, lens, mode, reverse, tape)


def _layer_backward(dys, saved):
    """Backpropagation through time → (dx, {'w_x','w_h','b'} grads)."""
    x, w_x, w_h, lens, mode, reverse, tape = saved
    t_max, b, h_dim = dys.shape
    dh = np.zeros((b, h_dim))
    dc = np.zeros((b, h_dim))
    dxp = np.zeros((t_max, b, w_h.shape[1]))
    dw_h = np.zeros_like(w_h)
    for t in (range(t_max) if reverse else range(t_max - 1, -1, -1)):
        v = (t < lens)[:, None]
        d_state = dh + np.where(v, dys[t], 0.0)
        d_new = np.where(v, d_state, 0.0)     # into this step's cell
        dh = np.where(v, 0.0, d_state)        # carried past a pad frame
        if mode == _LSTM:
            h_prev, c_prev, i, f, g, o, tc = tape[t]
            dc_new = np.where(v, dc, 0.0) + d_new * o * (1.0 - tc * tc)
            dc = np.where(v, 0.0, dc) + dc_new * f
            dgates = np.concatenate([
                dc_new * g * i * (1.0 - i),
                dc_new * c_prev * f * (1.0 - f),
                dc_new * i * (1.0 - g * g),
                d_new * tc * o * (1.0 - o)], axis=-1)
            dxp[t] = dgates
            dhp = dgates
        elif mode == _GRU:
            h_prev, r, z, n, hn = tape[t]
            dan = d_new * (1.0 - z) * (1.0 - n * n)
            dar = dan * hn * r * (1.0 - r)
            daz = d_new * (h_prev - n) * z * (1.0 - z)
            dh = dh + d_new * z
            dxp[t] = np.concatenate([dar, daz, dan], axis=-1)
            dhp = np.concatenate([dar, daz, dan * r], axis=-1)
        else:
            h_prev, a, h_new = tape[t]
            slope = (a > 0.0) if mode == _RELU else 1.0 - h_new * h_new
            dhp = d_new * slope
            dxp[t] = dhp
        dw_h += h_prev.T @ dhp
        dh = dh + dhp @ w_h.T
    d_in = x.shape[-1]
    grads = {"w_x": x.reshape(-1, d_in).T @ dxp.reshape(t_max * b, -1),
             "w_h": dw_h, "b": dxp.sum(axis=(0, 1))}
    return dxp @ w_x.T, grads


def _stack_forward(params, x, lens, mode, bidirectional):
    out = np.asarray(x, np.float64)
    lens = np.asarray(lens)
    saved = []
    for layer in params:
        outs = []
        for d in range(2 if bidirectional else 1):
            ys, tape = _layer_forward(out, lens, layer["dirs"][d], int(mode),
                                      reverse=d == 1)
            outs.append(ys)
            saved.append(tape)
        out = np.concatenate(outs, axis=-1)
    return out, saved


def rnn_stack_grad(params, x, lens, mode: int, bidirectional: bool,
                   dy) -> Tuple[np.ndarray, List[Dict[str, Any]], np.ndarray]:
    """The stack of ``ops.rnn.rnn_forward`` (x [T, B, D] → y [T, B,
    H*dirs]) and the gradient of ``sum(y * dy)``.

    → (y, grads shaped like ``params``, dx)."""
    y, saved = _stack_forward(params, x, lens, mode, bidirectional)
    n_dir = 2 if bidirectional else 1
    grads: List[Dict[str, Any]] = [{"dirs": [None] * n_dir} for _ in params]
    d_out = np.asarray(dy, np.float64)
    for li in range(len(params) - 1, -1, -1):
        h_dim = np.asarray(params[li]["dirs"][0]["w_h"]).shape[0]
        d_in = 0.0
        for d in range(n_dir):
            dx, g = _layer_backward(d_out[..., d * h_dim:(d + 1) * h_dim],
                                    saved[li * n_dir + d])
            grads[li]["dirs"][d] = g
            d_in = d_in + dx
        d_out = d_in
    return y, grads, d_out


def ctc_loss_and_grad(logits, labels, input_lens, label_lens, blank: int = 0):
    """Per-utterance CTC loss [B] and d(loss)/d(logits) [B, T, A].

    Infeasible utterances (no alignment fits in T frames) get loss 0 and
    a zero gradient, as ``ops.ctc`` defines them."""
    logits = np.asarray(logits, np.float64)
    b_dim, t_max, a_dim = logits.shape
    m = logits.max(axis=-1, keepdims=True)
    lp = logits - m - np.log(np.exp(logits - m).sum(axis=-1, keepdims=True))
    loss = np.zeros(b_dim)
    grad = np.zeros_like(logits)
    with np.errstate(divide="ignore"):
        for bi in range(b_dim):
            t_n, l_n = int(input_lens[bi]), int(label_lens[bi])
            ext = [blank]
            for lab in np.asarray(labels[bi])[:l_n]:
                ext += [int(lab), blank]
            ext = np.asarray(ext)
            s_n = len(ext)
            skip = np.zeros(s_n, bool)
            skip[2:] = (ext[2:] != blank) & (ext[2:] != ext[:-2])
            lpe = lp[bi, :t_n][:, ext]                  # [T, S]
            alpha = np.full((t_n, s_n), -np.inf)
            alpha[0, :min(2, s_n)] = lpe[0, :min(2, s_n)]
            for t in range(1, t_n):
                prev = alpha[t - 1].copy()
                prev[1:] = np.logaddexp(prev[1:], alpha[t - 1, :-1])
                prev[2:] = np.where(
                    skip[2:], np.logaddexp(prev[2:], alpha[t - 1, :-2]),
                    prev[2:])
                alpha[t] = prev + lpe[t]
            beta = np.full((t_n, s_n), -np.inf)
            beta[t_n - 1, s_n - 1] = lpe[t_n - 1, s_n - 1]
            if s_n > 1:
                beta[t_n - 1, s_n - 2] = lpe[t_n - 1, s_n - 2]
            for t in range(t_n - 2, -1, -1):
                nxt = beta[t + 1].copy()
                nxt[:-1] = np.logaddexp(nxt[:-1], beta[t + 1, 1:])
                nxt[:-2] = np.where(
                    skip[2:], np.logaddexp(nxt[:-2], beta[t + 1, 2:]),
                    nxt[:-2])
                beta[t] = nxt + lpe[t]
            log_z = alpha[t_n - 1, s_n - 1]
            if s_n > 1:
                log_z = np.logaddexp(log_z, alpha[t_n - 1, s_n - 2])
            if not np.isfinite(log_z):
                continue
            post = np.exp(alpha + beta - lpe - log_z)    # [T, S]
            occ = np.zeros((t_n, a_dim))
            for s in range(s_n):
                occ[:, ext[s]] += post[:, s]
            loss[bi] = -log_z
            grad[bi, :t_n] = np.exp(lp[bi, :t_n]) - occ
    return loss, grad


def _frames(wave, fo) -> np.ndarray:
    shift, length = fo.window_shift, fo.window_size
    n = 0 if len(wave) < length else 1 + (len(wave) - length) // shift
    idx = np.arange(n)[:, None] * shift + np.arange(length)[None, :]
    return np.asarray(wave, np.float64)[idx]


def _log_mel(wave, fo, mel_opts, use_power=True, energy=None):
    """Log mel energies [F, bins] and the log frame energy (raw or
    windowed, per ``energy``) of a dither-free waveform."""
    from kaldi_ctc_tpu.features.mel import mel_banks
    from kaldi_ctc_tpu.features.window import feature_window

    eps = float(np.finfo(np.float32).eps)
    fr = _frames(wave, fo)
    if fo.remove_dc_offset:
        fr = fr - fr.mean(axis=1, keepdims=True)
    log_e = None
    if energy == "raw":
        log_e = np.log(np.maximum((fr * fr).sum(axis=1), eps))
    if fo.preemph_coeff:
        fr = fr - fo.preemph_coeff * np.concatenate([fr[:, :1], fr[:, :-1]],
                                                    axis=1)
    fr = fr * feature_window(fo).astype(np.float64)
    if energy == "windowed":
        log_e = np.log(np.maximum((fr * fr).sum(axis=1), eps))
    spec = np.abs(np.fft.rfft(fr, n=fo.padded_window_size, axis=1)) ** 2
    if not use_power:
        spec = np.sqrt(spec)
    mel = mel_banks(mel_opts, fo).astype(np.float64)
    return np.log(np.maximum(spec[:, :-1] @ mel.T, eps)), log_e


def _energy_mode(opts):
    if not opts.use_energy:
        return None
    return "raw" if opts.raw_energy else "windowed"


def fbank(wave: Sequence[float], opts) -> np.ndarray:
    """FbankComputer::Compute for ``FbankOptions`` with use_log_fbank,
    no dither and no htk_mode: [F, dim]."""
    feats, log_e = _log_mel(wave, opts.frame_opts, opts.mel_opts,
                            use_power=opts.use_power,
                            energy=_energy_mode(opts))
    if log_e is None:
        return feats
    if opts.energy_floor > 0.0:
        log_e = np.maximum(log_e, np.log(opts.energy_floor))
    cols = [feats, log_e[:, None]] if opts.htk_compat else [log_e[:, None],
                                                             feats]
    return np.concatenate(cols, axis=1)


def mfcc(wave: Sequence[float], opts) -> np.ndarray:
    """MfccComputer::Compute for ``MfccOptions`` without htk_compat or
    htk_mode: [F, num_ceps]."""
    import math

    log_mel, log_e = _log_mel(wave, opts.frame_opts, opts.mel_opts,
                              energy=_energy_mode(opts))
    bins = opts.mel_opts.num_bins
    k = np.arange(opts.num_ceps)[:, None]
    n = np.arange(bins)[None, :]
    dct = math.sqrt(2.0 / bins) * np.cos(math.pi / bins * (n + 0.5) * k)
    dct[0] = math.sqrt(1.0 / bins)
    feats = log_mel @ dct.T
    if opts.cepstral_lifter:
        q = opts.cepstral_lifter
        feats = feats * (1.0 + 0.5 * q * np.sin(math.pi * np.arange(
            opts.num_ceps) / q))
    if log_e is not None:
        if opts.energy_floor > 0.0:
            log_e = np.maximum(log_e, np.log(opts.energy_floor))
        feats[:, 0] = log_e
    return feats
