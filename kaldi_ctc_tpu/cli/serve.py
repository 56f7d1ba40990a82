"""HTTP serving front-end: streaming + full-utterance recognition.

The production-serving layer the reference leaves to the user (its
online decoders are library code only): one process owns the device and a
:class:`BatchStreamingRecognizer` — N stream slots decoded per chunk by
a single compiled program — plus a full-utterance endpoint that runs the
offline forward + (optionally) the native WFST decoder for word output.

Endpoints (JSON responses; audio is 16-bit little-endian PCM unless a
WAV container is posted):

  POST /recognize            body = WAV or raw s16le PCM
                             → {"labels": [...], "words": [...]?,
                                "text": "..."?, "rtf": ...}
  POST /stream/start         → {"slot": k}
  POST /stream/<k>/chunk     body = raw s16le PCM → {"labels": [new...]}
  POST /stream/<k>/end       → {"labels": [all...], "text": "..."?}

Run:  python -m kaldi_ctc_tpu.cli.serve --dir exp [--graph TLG.fst
      --words TLG.fst.words.txt] --port 8057
"""

from __future__ import annotations

import argparse
import io
import json
import re
import threading
from contextlib import nullcontext as _nullcontext
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

import numpy as np


def parse_args(argv=None):
    from kaldi_ctc_tpu.utils.options import expand_config_args
    argv = expand_config_args(argv)
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dir", default=None, help="training/exp dir")
    p.add_argument("--model", default=None,
                   help="inference artifact (.npz from copy_model)")
    p.add_argument("--port", type=int, default=8057)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--sample-rate", type=float, default=16000.0)
    p.add_argument("--feat-type", choices=["mfcc", "fbank"], default="mfcc")
    p.add_argument("--feat-config", choices=["default", "hires"],
                   default="hires")
    p.add_argument("--cmvn", default=None,
                   help="global CMVN stats matrix (ark with one key "
                        "'global' or a .npy [2, D+1] stats array)")
    p.add_argument("--graph", default=None,
                   help="CTC TLG graph for word output on /recognize "
                        "and /stream end")
    p.add_argument("--words", default=None, help="words.txt for --graph")
    p.add_argument("--use-priors", type=int, default=1)
    p.add_argument("--acoustic-scale", type=float, default=1.0)
    p.add_argument("--blank-threshold", type=float, default=0.98)
    p.add_argument("--beam", type=float, default=16.0)
    p.add_argument("--max-streams", type=int, default=8,
                   help="streaming slot count (one compiled program)")
    p.add_argument("--chunk-frames", type=int, default=20,
                   help="decode tick size in frames (200 ms at 10 ms "
                        "shift)")
    return p.parse_args(argv)


def _pcm_from_body(body: bytes, default_rate: float):
    """WAV container or raw s16le PCM → (float32 samples, rate)."""
    if body[:4] == b"RIFF":
        from kaldi_ctc_tpu.features.wave import read_wave
        import tempfile, os
        with tempfile.NamedTemporaryFile(suffix=".wav", delete=False) as f:
            f.write(body)
            path = f.name
        try:
            samples, rate = read_wave(path)
            return samples[0].astype(np.float32), rate
        finally:
            os.unlink(path)
    pcm = np.frombuffer(body, dtype="<i2").astype(np.float32)
    return pcm, default_rate


class Engine:
    """Owns the model, feature extractor, streaming slots, and decoder."""

    def __init__(self, args):
        from kaldi_ctc_tpu.features import (
            FbankOptions, MfccOptions, compute_fbank, compute_mfcc)
        from kaldi_ctc_tpu.models import AmConfig, am_forward

        self.args = args
        from kaldi_ctc_tpu.models.artifact import load_acoustic_model
        try:
            self.params, self.cfg, self.priors, _ = load_acoustic_model(
                args.model, args.dir)
        except ValueError as e:
            raise SystemExit(f"serve: {e}")
        if not args.use_priors:
            self.priors = None

        if args.feat_type == "mfcc":
            self.fopts = (MfccOptions.hires()
                          if args.feat_config == "hires" else MfccOptions())
            self._compute = compute_mfcc
        else:
            self.fopts = FbankOptions()
            self._compute = compute_fbank
        if args.sample_rate != self.fopts.frame_opts.samp_freq:
            # the extractor must frame at the served rate, or window
            # sizes and the mel bank are computed for the wrong
            # frequency while the stream buffers slice at the user rate
            import dataclasses as _dc
            self.fopts = _dc.replace(
                self.fopts,
                frame_opts=_dc.replace(self.fopts.frame_opts,
                                       samp_freq=float(args.sample_rate)))
        fr = self.fopts.frame_opts
        self.win = int(args.sample_rate * fr.frame_length_ms / 1000.0)
        self.shift = int(args.sample_rate * fr.frame_shift_ms / 1000.0)

        self.cmvn_stats = None
        if args.cmvn:
            if args.cmvn.endswith(".npy"):
                self.cmvn_stats = np.load(args.cmvn)
            else:
                from kaldi_ctc_tpu.utils.kaldi_io import (
                    SequentialMatrixReader)
                for _, m in SequentialMatrixReader(args.cmvn):
                    self.cmvn_stats = np.asarray(m)
                    break

        self.graph = None
        self.word_syms = None
        if args.graph:
            from kaldi_ctc_tpu.decoding.wfst import NativeFst
            self.graph = NativeFst.load(args.graph)
            if args.words:
                from kaldi_ctc_tpu.utils.kaldi_io import \
                    read_symbol_table
                self.word_syms = read_symbol_table(args.words)

        # Jitted full-utterance scorer: one compiled call per length
        # bucket instead of hundreds of eager per-op dispatches.
        # Features are padded to a geometric length bucket so recompiles
        # are O(log T) over a server's lifetime, and the true length
        # rides input_lens exactly like training.
        import functools as _ft

        import jax as _jax

        @_ft.lru_cache(maxsize=None)
        def _scorer(t_pad: int):
            @_jax.jit
            def run(params, feats, lens, priors):
                logits = am_forward(params, feats, self.cfg,
                                    input_lens=lens)
                from kaldi_ctc_tpu.decoding.scores import (
                    acoustic_scores as _ac)
                sc, skip = _ac(logits, priors=priors,
                               acoustic_scale=self.args.acoustic_scale,
                               blank_threshold=self.args.blank_threshold)
                raw, _ = _ac(logits, priors=priors,
                             acoustic_scale=self.args.acoustic_scale,
                             blank_threshold=1.0)
                return sc, skip, raw
            return run

        def _score_utt(feats_np):
            t = feats_np.shape[0]
            t_pad = 32
            while t_pad < t:
                t_pad = int(t_pad * 1.5)
            pad = np.zeros((t_pad, feats_np.shape[1]), np.float32)
            pad[:t] = feats_np
            import jax.numpy as _jnp
            sc, skip, raw = _scorer(t_pad)(
                self.params, _jnp.asarray(pad[None]),
                _jnp.asarray([t], np.int32),
                self.priors)
            n_out = int(self.cfg.output_lens(np.asarray([t]))[0])
            return (np.asarray(sc)[0][:n_out],
                    np.asarray(skip)[0][:n_out],
                    np.asarray(raw)[0][:n_out])

        self._score_utt = _score_utt
        self._am_forward = am_forward  # kept for tests/direct use
        self.lock = threading.RLock()

        # streaming (only for unidirectional models)
        self.stream = None
        if not self.cfg.bidirectional:
            from kaldi_ctc_tpu.decoding.streaming import (
                BatchStreamingRecognizer)
            self.stream = BatchStreamingRecognizer(
                self.params, self.cfg, max_streams=args.max_streams,
                chunk_frames=args.chunk_frames, priors=self.priors,
                acoustic_scale=args.acoustic_scale)
        self.slots: Dict[int, dict] = {}
        self._next_slot = 0
        self.free: List[int] = list(range(args.max_streams))

    # ---- features ----

    def feats_for(self, samples: np.ndarray) -> np.ndarray:
        # Feature extraction is pinned to the host cpu backend: the
        # acoustic model owns the accelerator, and a 200 ms chunk's DSP
        # is too little work to pay a device dispatch and transfer for
        # (ROADMAP A6 measures that choice).  Falls back to the default
        # device when no cpu backend exists.
        import jax
        import jax.numpy as jnp
        try:
            cpu = jax.local_devices(backend="cpu")[0]
        except RuntimeError:
            cpu = None
        ctx = jax.default_device(cpu) if cpu is not None else _nullcontext()
        with ctx:
            f = np.asarray(self._compute(jnp.asarray(samples), self.fopts))
            if self.cmvn_stats is not None:
                from kaldi_ctc_tpu.features.cmvn import apply_cmvn
                f = np.asarray(apply_cmvn(f, self.cmvn_stats))
        return f.astype(np.float32)

    # ---- full utterance ----

    def recognize(self, samples: np.ndarray) -> dict:
        import time

        t0 = time.time()
        feats = self.feats_for(samples)
        if feats.shape[0] == 0:
            return {"labels": [], "num_frames": 0}
        with self.lock:
            # one jitted call: forward + canonical score prep
            # (CtcDecodableAmNnet semantics: blank threshold on the
            # softmax blank posterior before priors/acoustic scale) +
            # the unforced scores for greedy labels (same formula as
            # the streaming path, so /recognize == /stream exactly)
            scores, skip, raw = self._score_utt(feats)
        out: dict = {"num_frames": int(feats.shape[0])}
        # greedy labels always
        ids = np.argmax(raw, axis=-1)
        labels = []
        last = 0
        for lab in ids:
            if lab != 0 and lab != last:
                labels.append(int(lab))
            last = int(lab)
        out["labels"] = labels
        if self.graph is not None:
            out.update(self._wfst_words(scores, skip))
        dur = feats.shape[0] * self.shift / self.args.sample_rate
        out["rtf"] = round((time.time() - t0) / max(dur, 1e-9), 4)
        return out

    def _wfst_words(self, scores: np.ndarray, skip: np.ndarray) -> dict:
        """Native WFST best-path over prepared acoustic scores →
        {"words": [...]} (+ "text" with a symbol table)."""
        from kaldi_ctc_tpu.decoding.wfst import decode_best_path
        keep = scores[~skip]
        use = keep if keep.shape[0] else scores
        words, align, cost, final = decode_best_path(
            self.graph, use, beam=self.args.beam)
        out = {"words": [int(w) for w in words]}
        if self.word_syms:
            out["text"] = " ".join(
                self.word_syms.get(int(w), str(int(w))) for w in words)
        return out

    # ---- streaming ----

    def stream_start(self) -> Optional[int]:
        if self.stream is None:
            return None
        with self.lock:
            if not self.free:
                return -1
            slot = self.free.pop(0)
            self.stream.reset_slot(slot)
            self.slots[slot] = {"buf": np.zeros(0, np.float32),
                                "buf_off": 0,
                                "frames_done": 0,
                                "ready": [],
                                "hist": [],
                                "pending": np.zeros(
                                    (0, self.cfg.input_dim), np.float32)}
        return slot

    def _new_frames(self, st: dict) -> np.ndarray:
        """Extract frames completed by the samples buffered so far.

        `buf` holds only un-consumed samples; `buf_off` is the absolute
        sample index of buf[0], so consumed audio is trimmed and memory
        stays O(chunk) for arbitrarily long streams."""
        n = st["buf_off"] + st["buf"].shape[0]
        total = 0 if n < self.win else 1 + (n - self.win) // self.shift
        k = total - st["frames_done"]
        if k <= 0:
            return np.zeros((0, self.cfg.input_dim), np.float32)
        start = st["frames_done"] * self.shift
        end = (st["frames_done"] + k - 1) * self.shift + self.win
        f = self.feats_for(st["buf"][start - st["buf_off"]:
                                     end - st["buf_off"]])[:k]
        st["frames_done"] += f.shape[0]
        # drop samples no future frame can touch
        next_start = st["frames_done"] * self.shift
        if next_start > st["buf_off"]:
            st["buf"] = st["buf"][next_start - st["buf_off"]:]
            st["buf_off"] = next_start
        return f

    def stream_chunk(self, slot: int, samples: np.ndarray) -> List[int]:
        # ThreadingHTTPServer handles requests concurrently: the slot
        # buffers and the shared batched recognizer state must not be
        # touched outside the engine lock (the lock is reentrant, so
        # _drain's own acquisition nests)
        with self.lock:
            st = self.slots[slot]
            st["buf"] = np.concatenate([st["buf"], samples])
            frames = self._new_frames(st)
            if self.graph is not None and frames.shape[0]:
                # keep the feature history for the WFST word decode at
                # stream end (~16 KB per audio-second at 40 dims)
                st["hist"].append(frames)
            st["pending"] = np.concatenate([st["pending"], frames])
            return self._drain(slot)

    def _drain(self, slot: int, flush: bool = False) -> List[int]:
        """Feed complete chunk_frames ticks.

        Each tick batches EVERY stream with a full chunk pending (plus
        the driving slot's flush remainder) into ONE process() call —
        concurrent streams share the compiled batch program instead of
        each request paying a full-batch forward for a single row.
        Labels produced for other slots are queued on their "ready"
        lists and delivered by their own next request."""
        cf = self.args.chunk_frames
        st = self.slots[slot]
        with self.lock:
            while st["pending"].shape[0] >= (1 if flush else cf):
                chunks = np.zeros((self.args.max_streams, cf,
                                   self.cfg.input_dim), np.float32)
                valid = np.zeros(self.args.max_streams, np.int64)
                ticked = []
                for s, other in self.slots.items():
                    take = min(cf, other["pending"].shape[0])
                    if s != slot and take < cf:
                        continue   # partial chunks only flush themselves
                    if take == 0:
                        continue
                    chunks[s, :take] = other["pending"][:take]
                    valid[s] = take
                    other["pending"] = other["pending"][take:]
                    ticked.append(s)
                if not ticked:
                    break
                out = self.stream.process(chunks, valid)
                for s in ticked:
                    self.slots[s]["ready"].extend(out[s])
                if flush and st["pending"].shape[0] == 0:
                    break
            new = st["ready"]
            st["ready"] = []
        return new

    def stream_end(self, slot: int) -> dict:
        with self.lock:
            new = self._drain(slot, flush=True)
            labels = self.stream.finalize(slot)
            hist = self.slots[slot]["hist"]
            del self.slots[slot]
            self.free.append(slot)
            out = {"labels": labels, "new": new}
            if self.graph is not None and hist:
                # WFST word decode over the whole stream's features (the
                # /stream end "text" contract): for a unidirectional
                # model the offline forward equals the chunked one
                feats = np.concatenate(hist)
                sc, skip, _raw = self._score_utt(feats)
                out.update(self._wfst_words(sc, skip))
        return out


def make_handler(engine: Engine):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"ok": True,
                                 "streaming": engine.stream is not None})
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            n = int(self.headers.get("Content-Length", "0"))
            body = self.rfile.read(n)
            try:
                if self.path == "/recognize":
                    pcm, rate = _pcm_from_body(body,
                                               engine.args.sample_rate)
                    if rate != engine.args.sample_rate:
                        from kaldi_ctc_tpu.features.resample import (
                            resample)
                        pcm = resample(pcm, rate,
                                       engine.args.sample_rate)
                    self._json(200, engine.recognize(pcm))
                    return
                if self.path == "/stream/start":
                    slot = engine.stream_start()
                    if slot is None:
                        self._json(400, {"error": "streaming needs a "
                                         "unidirectional model"})
                    elif slot < 0:
                        self._json(503, {"error": "no free slots"})
                    else:
                        self._json(200, {"slot": slot})
                    return
                m = re.match(r"^/stream/(\d+)/(chunk|end)$", self.path)
                if m:
                    slot = int(m.group(1))
                    if slot not in engine.slots:
                        self._json(404, {"error": f"unknown slot {slot}"})
                        return
                    if m.group(2) == "chunk":
                        pcm, _ = _pcm_from_body(
                            body, engine.args.sample_rate)
                        self._json(200,
                                   {"labels": engine.stream_chunk(slot,
                                                                  pcm)})
                    else:
                        self._json(200, engine.stream_end(slot))
                    return
                self._json(404, {"error": "not found"})
            except Exception as e:  # noqa: BLE001 — report to client
                self._json(500, {"error": str(e)})

    return Handler


def main(argv=None):
    from kaldi_ctc_tpu.utils import get_logger

    args = parse_args(argv)
    log = get_logger("serve")
    engine = Engine(args)
    server = ThreadingHTTPServer((args.host, args.port),
                                 make_handler(engine))
    log.info("serving on %s:%d (streaming slots: %s)", args.host,
             args.port,
             args.max_streams if engine.stream is not None else "n/a")
    server.serve_forever()


if __name__ == "__main__":
    main()
