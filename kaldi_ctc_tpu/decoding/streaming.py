"""Online (streaming) CTC recognition with carried recurrent state.

The online-decoding parity piece (the reference ships online decoder
variants next to LatticeFasterDecoder — ``src/decoder/``'s
lattice-faster-online-decoder / online-faster-decoder with their
AdvanceDecoding idiom).  CTC + a unidirectional stack makes this
simple: per-chunk forward with explicit (h, c) carry is exactly
equivalent to the full-utterance forward, so results match offline
greedy decoding bit-for-bit while latency is one chunk.

Usage:
    rec = StreamingRecognizer(params, cfg, priors=...)
    for chunk in feature_chunks:          # [T_chunk, D] each
        new_labels = rec.process(chunk)   # incremental emissions
    labels = rec.finalize()
"""

from __future__ import annotations

from typing import Any, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from kaldi_ctc_tpu.models.acoustic import AmConfig
from kaldi_ctc_tpu.ops.rnn import init_stream_state, rnn_forward_stream

__all__ = ["StreamingRecognizer", "BatchStreamingRecognizer"]


class StreamingRecognizer:
    """Single-stream greedy CTC recognizer over feature chunks."""

    def __init__(
        self,
        params: Any,
        cfg: AmConfig,
        priors: Optional[np.ndarray] = None,
        acoustic_scale: float = 1.0,
        blank: int = 0,
    ):
        if cfg.bidirectional:
            raise ValueError(
                "streaming requires a unidirectional model "
                "(--bidirectional 0); a bidirectional stack needs the "
                "whole utterance")
        if cfg.splice_left or cfg.splice_right:
            raise ValueError(
                "streaming does not support input splicing (frame "
                "context crosses chunk boundaries); train without "
                "--splice-left/--splice-right for streaming serving")
        if cfg.conv_layers:
            raise ValueError(
                "streaming does not support the DS2 conv front end "
                "(the time kernel crosses chunk boundaries)")
        self._params = params
        self._cfg = cfg
        self._blank = blank
        self._state = init_stream_state(cfg.rnn, batch=1)
        self._last = blank          # last argmax label (collapse carry)
        self._labels: List[int] = []
        log_priors = (jnp.log(jnp.asarray(priors, jnp.float32))
                      if priors is not None else None)

        def chunk_fn(params, x, states):
            # x: [T, 1, D] time-major single stream
            cd = (jnp.bfloat16 if cfg.compute_dtype == "bfloat16"
                  else jnp.float32)
            if cfg.front_affine_dim:
                h = jax.nn.relu(jnp.dot(
                    x.astype(cd), params["front_w"].astype(cd),
                    preferred_element_type=jnp.float32)
                    + params["front_b"])
                rms = jnp.sqrt(jnp.mean(h * h, axis=-1, keepdims=True)
                               + 1e-20)
                x = h / rms
            y, new_states = rnn_forward_stream(
                params["rnn"], x, cfg.rnn, states)
            t, b, h = y.shape
            # same operand dtype as am_forward's output projection,
            # keeping the bit-for-bit offline/streaming parity claim
            # true for bfloat16 models too
            logits = (jnp.dot(y.reshape(t * b, h).astype(cd),
                              params["out_w"].astype(cd),
                              preferred_element_type=jnp.float32)
                      + params["out_b"]).reshape(t, b, -1)
            scores = jax.nn.log_softmax(logits, axis=-1)
            if log_priors is not None:
                scores = scores - log_priors[None, None, :]
            scores = acoustic_scale * scores
            return jnp.argmax(scores[:, 0, :], axis=-1), new_states

        self._chunk_fn = jax.jit(chunk_fn)

    def process(self, feats: np.ndarray) -> List[int]:
        """Feed one chunk [T, D]; returns labels newly emitted."""
        if feats.shape[0] == 0:
            return []
        x = jnp.asarray(feats, jnp.float32)[:, None, :]
        ids, self._state = self._chunk_fn(self._params, x, self._state)
        new: List[int] = []
        for lab in np.asarray(ids).tolist():
            if lab != self._blank and lab != self._last:
                new.append(int(lab))
            self._last = lab
        self._labels.extend(new)
        return new

    def finalize(self) -> List[int]:
        """Full collapsed label sequence seen so far."""
        return list(self._labels)

    def reset(self) -> None:
        self._state = init_stream_state(self._cfg.rnn, batch=1)
        self._last = self._blank
        self._labels = []


class BatchStreamingRecognizer:
    """Serving-oriented batched streaming: N independent streams decoded
    per chunk with one compiled program (fixed slot count and chunk
    length → exactly one XLA compile; the per-stream state lives in
    batched arrays so slot resets are row updates)."""

    def __init__(
        self,
        params: Any,
        cfg: AmConfig,
        max_streams: int,
        chunk_frames: int,
        priors: Optional[np.ndarray] = None,
        acoustic_scale: float = 1.0,
        blank: int = 0,
    ):
        if cfg.bidirectional:
            raise ValueError("streaming requires a unidirectional model")
        if cfg.splice_left or cfg.splice_right:
            raise ValueError(
                "streaming does not support input splicing (frame "
                "context crosses chunk boundaries); train without "
                "--splice-left/--splice-right for streaming serving")
        if cfg.conv_layers:
            raise ValueError(
                "streaming does not support the DS2 conv front end "
                "(the time kernel crosses chunk boundaries)")
        self._params = params
        self._cfg = cfg
        self._blank = blank
        self._b = max_streams
        self._t = chunk_frames
        self._dim = cfg.input_dim
        self._state = init_stream_state(cfg.rnn, batch=max_streams)
        self._last = [blank] * max_streams
        self._labels: List[List[int]] = [[] for _ in range(max_streams)]
        log_priors = (jnp.log(jnp.asarray(priors, jnp.float32))
                      if priors is not None else None)

        def chunk_fn(params, x, lens, states):
            # x: [T, B, D]; lens: [B] valid frames per slot this chunk
            cd = (jnp.bfloat16 if cfg.compute_dtype == "bfloat16"
                  else jnp.float32)
            if cfg.front_affine_dim:
                # FT front layer is frame-local, so it streams exactly
                h = jax.nn.relu(jnp.dot(
                    x.astype(cd), params["front_w"].astype(cd),
                    preferred_element_type=jnp.float32)
                    + params["front_b"])
                rms = jnp.sqrt(jnp.mean(h * h, axis=-1, keepdims=True)
                               + 1e-20)
                x = h / rms
            y, new_states = rnn_forward_stream(
                params["rnn"], x, cfg.rnn, states, lens=lens)
            t, b, h = y.shape
            # same operand dtype as am_forward's output projection,
            # keeping the bit-for-bit offline/streaming parity claim
            # true for bfloat16 models too
            logits = (jnp.dot(y.reshape(t * b, h).astype(cd),
                              params["out_w"].astype(cd),
                              preferred_element_type=jnp.float32)
                      + params["out_b"]).reshape(t, b, -1)
            scores = jax.nn.log_softmax(logits, axis=-1)
            if log_priors is not None:
                scores = scores - log_priors[None, None, :]
            scores = acoustic_scale * scores
            return jnp.argmax(scores, axis=-1), new_states  # [T, B]

        self._chunk_fn = jax.jit(chunk_fn)

    def process(self, chunks: np.ndarray,
                valid_frames: np.ndarray) -> List[List[int]]:
        """Feed one [B, T_chunk, D] block (idle slots: valid_frames 0).

        Returns per-slot newly emitted labels."""
        b, t, d = chunks.shape
        if (b, t, d) != (self._b, self._t, self._dim):
            raise ValueError(
                f"expected [{self._b}, {self._t}, {self._dim}] chunks, "
                f"got {chunks.shape}")
        x = jnp.asarray(np.swapaxes(chunks, 0, 1), jnp.float32)  # [T,B,D]
        lens = jnp.asarray(valid_frames, jnp.int32)
        ids, self._state = self._chunk_fn(self._params, x, lens,
                                          self._state)
        ids_np = np.asarray(ids)  # [T, B]
        out: List[List[int]] = []
        for s in range(self._b):
            new: List[int] = []
            for ti in range(int(valid_frames[s])):
                lab = int(ids_np[ti, s])
                if lab != self._blank and lab != self._last[s]:
                    new.append(lab)
                self._last[s] = lab
            self._labels[s].extend(new)
            out.append(new)
        return out

    def finalize(self, slot: int) -> List[int]:
        return list(self._labels[slot])

    def reset_slot(self, slot: int) -> None:
        """Free a slot for a new stream (row-zeroing the carried state)."""
        def zero_row(a):
            return a.at[slot].set(0.0)
        new_states = []
        for st in self._state:
            if isinstance(st, tuple):
                new_states.append(tuple(zero_row(x) for x in st))
            else:
                new_states.append(zero_row(st))
        self._state = new_states
        self._last[slot] = self._blank
        self._labels[slot] = []
