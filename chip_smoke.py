"""Smoke check of the system's main paths on one GPU.

Drives, in this one process and through the entry points a user calls,
the flagship librispeech 'google' model (5-layer BLSTM, cell 320 per
direction, 40-d input, 72 targets, minibatch 48) with seeded random data:

  card    nvidia-smi's name and power limit, JAX's device
  train   train_ctc, bf16 (the recipe default), then DS2 with two convs
  decode  compute_prob, then decode_ctc greedy / beam / wfst
  serve   a unidirectional 5x320 LSTM behind cli.serve: /recognize and
          concurrent /stream sessions, streamed labels == offline labels
  parity  rnn_forward + gradient (BLSTM in f32 and bf16, a GRU stack),
          ctc_loss_and_grad, fbank and mfcc at real widths, against the
          float64 references of kaldi_ctc_tpu.reference
  ops     XLA's time for the operations the removed hand-written kernels
          covered: one BLSTM layer fwd+bwd, CTC loss+grad, fbank

Each phase prints one JSON line; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failed phase, or a JAX that finds no GPU, exits non-zero without it.

  python chip_smoke.py                # all phases, one card
  python chip_smoke.py --four-cards   # only data-parallel train_ctc over
                                      # four cards vs the same global
                                      # batch on one card
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

NVIDIA_SMI = ["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"]


@dataclasses.dataclass(frozen=True)
class Sizes:
    hidden: int = 320
    layers: int = 5
    input_dim: int = 40
    targets: int = 72
    batch: int = 48
    raw_frames: int = 720        # 240 frames at --frame-subsampling-factor 3
    fs: int = 3
    labels: int = 30             # per training utterance
    train_steps: int = 6
    ds2_steps: int = 3
    conv_channels: int = 32
    decode_utts: int = 8
    utt_seconds: float = 3.0     # serve requests
    ctc_labels: int = 70
    audio_seconds: float = 10.0  # feature parity and timing
    gru_layers: int = 2
    reps: int = 20               # timed repetitions per op
    dp_steps: int = 3            # four-card check


FULL = Sizes()
TINY = Sizes(hidden=8, layers=2, targets=8, batch=4, raw_frames=60,
             labels=4, train_steps=3, ds2_steps=2, conv_channels=4,
             decode_utts=4, utt_seconds=0.6, ctc_labels=5,
             audio_seconds=1.0, gru_layers=1, reps=2)


class CompileClock:
    """Seconds XLA spends compiling, summed from JAX's monitoring events."""

    EVENT = "/jax/core/compile/backend_compile_duration"

    def __init__(self):
        import jax
        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **_):
        if event == self.EVENT:
            self.total += duration

    @contextlib.contextmanager
    def measure(self, out: dict, key: str = "compile_s"):
        start = self.total
        try:
            yield
        finally:
            out[key] = round(self.total - start, 3)


def _peak_bytes(device=None):
    import jax
    stats = (device or jax.devices()[0]).memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def _rel_err(got, want):
    import numpy as np
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = float(np.abs(got - want).max())
    return err, err / max(float(np.abs(want).max()), 1e-30)


def _check(name, got, want, tol, why):
    """One parity line: max abs error, and max abs error over the largest
    reference magnitude, against the stated relative tolerance."""
    abs_err, rel_err = _rel_err(got, want)
    return {"check": name, "max_abs": abs_err, "max_rel": rel_err,
            "tol_rel": tol, "why": why, "ok": rel_err <= tol}


def _run_cli(main, argv):
    """Run a CLI's main(argv) here; → the last JSON line it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    return json.loads(lines[-1]) if lines else None


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def make_data(out_dir, sz: Sizes, n_utts: int, seed: int) -> dict:
    """Seeded Kaldi-format corpus: each label paints a fixed random code
    onto the features for a span of frames.  → rspecifiers + text path."""
    import numpy as np

    from kaldi_ctc_tpu.utils import kaldi_io

    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    codes = np.random.default_rng(1234).choice(
        [-1.0, 1.0], size=(sz.targets - 1, sz.input_dim))
    span = sz.raw_frames // sz.labels
    feats_p = os.path.join(out_dir, "feats.ark")
    ali_p = os.path.join(out_dir, "ali.ark")
    lines = []
    with kaldi_io.MatrixWriter(f"ark:{feats_p}") as fw, \
            kaldi_io.IntVectorWriter(f"ark:{ali_p}") as aw:
        for i in range(n_utts):
            pdfs = rng.integers(0, sz.targets - 1, size=sz.labels)
            for j in range(1, sz.labels):      # no merged neighbours
                if pdfs[j] == pdfs[j - 1]:
                    pdfs[j] = (pdfs[j] + 1) % (sz.targets - 1)
            ali = np.repeat(pdfs, span)
            ali = np.concatenate(
                [ali, np.full(sz.raw_frames - ali.size, pdfs[-1])])
            feats = (rng.standard_normal((sz.raw_frames, sz.input_dim))
                     * 0.3 + codes[ali]).astype(np.float32)
            fw[f"u{i:04d}"] = feats
            aw[f"u{i:04d}"] = ali.astype(np.int32)
            lines.append(f"u{i:04d} " + " ".join(str(p + 1) for p in pdfs))
    text = os.path.join(out_dir, "text")
    with open(text, "w") as f:
        f.write("\n".join(lines) + "\n")
    return {"feats": f"ark:{feats_p}", "ali": f"ark:{ali_p}", "text": text}


def _pcm(seconds: float, seed: int) -> bytes:
    import numpy as np
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.standard_normal(int(16000 * seconds)))
    x = (x - x.mean()) / (np.abs(x).max() + 1e-6)
    return (x * 20000).astype("<i2").tobytes()


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def card_line(cmd=NVIDIA_SMI) -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(cmd, capture_output=True, text=True, check=True,
                         timeout=60)
    line = out.stdout.strip().splitlines()[0].strip()
    if "," not in line:
        raise RuntimeError(f"unexpected nvidia-smi output: {line!r}")
    return line


def phase_card(line: str) -> dict:
    import jax
    import jaxlib
    dev = jax.devices()[0]
    name, limit = (s.strip() for s in line.split(",", 1))
    return {"phase": "card", "name": name, "power_limit": limit,
            "jax": jax.__version__, "jaxlib": jaxlib.__version__,
            "platform": dev.platform, "device_kind": dev.device_kind,
            "device_count": len(jax.devices())}


def _train(work, name, data, sz: Sizes, steps: int, extra, clock,
           devices, batch=None):
    """One train_ctc run of `steps` steps over a mesh of `devices`, at a
    global batch of `batch` (default sz.batch) → (summary, losses)."""
    import numpy as np

    from kaldi_ctc_tpu import parallel
    from kaldi_ctc_tpu.cli import train_ctc

    exp = os.path.join(work, f"exp_{name}")
    argv = ["--feats", data["feats"], "--ali", data["ali"],
            "--num-targets", str(sz.targets),
            "--hidden-dim", str(sz.hidden), "--num-layers", str(sz.layers),
            "--compute-dtype", "bfloat16", "--epochs", "1",
            "--minibatch-size", str(batch or sz.batch),
            "--frame-subsampling-factor", str(sz.fs),
            "--initial-learning-rate", "5e-4",
            "--final-learning-rate", "5e-4",
            "--checkpoint-period", "100000", "--dir", exp] + list(extra)
    out = {"run": name, "devices": len(devices)}
    # train_ctc spans every visible device; pin this run to `devices`
    mesh_factory = parallel.make_mesh
    parallel.make_mesh = lambda *a, **k: mesh_factory(devices=devices)
    t0 = time.perf_counter()
    try:
        with clock.measure(out):
            train_ctc.main(argv)
    finally:
        parallel.make_mesh = mesh_factory
    out["wall_s"] = round(time.perf_counter() - t0, 3)
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        recs = [json.loads(ln) for ln in f]
    recs = [r for r in recs if r["event"] == "train_step"]
    losses = [r["loss_per_frame"] for r in recs]
    ts = [r["t"] for r in recs]
    out["steps"] = len(losses)
    out["loss_per_frame"] = losses
    # host clock between logged steps (informational, not a metric)
    out["first_step_s"] = ts[0] if ts else None
    out["step_s"] = np.diff(ts).round(4).tolist()
    out["peak_bytes_in_use"] = _peak_bytes()
    if len(losses) != steps:
        raise RuntimeError(f"{name}: {len(losses)} steps, wanted {steps}")
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"{name}: non-finite loss {losses}")
    return out, losses


def phase_train(work, sz: Sizes, clock, devices) -> dict:
    data = make_data(os.path.join(work, "data"), sz,
                     sz.batch * sz.train_steps, seed=0)
    ds2_data = make_data(os.path.join(work, "data_ds2"), sz,
                         sz.batch * sz.ds2_steps, seed=1)
    runs = []
    for name, d, steps, extra in (
            ("blstm_bf16", data, sz.train_steps, []),
            ("ds2_bf16", ds2_data, sz.ds2_steps,
             ["--conv-layers", "2", "--conv-channels",
              str(sz.conv_channels), "--conv-time-stride", "2"])):
        summary, losses = _train(work, name, d, sz, steps, extra, clock,
                                 devices)
        if not losses[-1] < losses[0]:
            raise RuntimeError(f"{name}: loss did not fall: {losses}")
        runs.append(summary)
    return {"phase": "train", "runs": runs}


def phase_decode(work, sz: Sizes, clock) -> dict:
    import numpy as np

    from kaldi_ctc_tpu.cli import compute_prob, decode_ctc
    from kaldi_ctc_tpu.decoding.wfst import NativeFst

    exp = os.path.join(work, "exp_blstm_bf16")
    dev = make_data(os.path.join(work, "dev"), sz, sz.decode_utts, seed=2)
    out = {"phase": "decode"}
    with clock.measure(out):
        prob = _run_cli(compute_prob.main, [
            "--feats", dev["feats"], "--ali", dev["ali"], "--dir", exp,
            "--minibatch-size", str(sz.decode_utts),
            "--frame-subsampling-factor", str(sz.fs)])
        if not (prob and np.isfinite(prob["loss_per_frame"])
                and prob["num_utts"] == sz.decode_utts):
            raise RuntimeError(f"compute_prob: {prob}")
        out["compute_prob"] = prob

        # word-loop CTC graph over the labels (tests/test_cli_e2e.py)
        arcs, weights = [], []
        for lab in range(1, sz.targets):
            arcs += [[0, lab, lab, lab], [lab, lab, 0, lab], [lab, 0, 0, 0]]
            weights += [1.0, 0.0, 0.0]
        finals = np.full(sz.targets, np.inf, np.float32)
        finals[0] = 0.0
        graph = os.path.join(work, "ctc.fst")
        NativeFst.from_arrays(
            0, sz.targets, np.asarray(arcs, np.int32),
            np.asarray(weights, np.float32), finals).make_ctc_graph(
            ).write(graph)

        for method in ("greedy", "beam", "wfst"):
            hyp = os.path.join(work, f"hyp.{method}.txt")
            argv = ["--feats", dev["feats"], "--dir", exp,
                    "--method", method, "--text", dev["text"],
                    "--output", hyp,
                    "--frame-subsampling-factor", str(sz.fs),
                    "--minibatch-size", str(sz.decode_utts)]
            if method == "wfst":
                argv += ["--graph", graph]
            res = _run_cli(decode_ctc.main, argv)
            with open(hyp) as f:
                n_hyp = sum(1 for _ in f)
            if not (res and np.isfinite(res["label_error_rate"])
                    and res["ref_tokens"] == sz.decode_utts * sz.labels
                    and n_hyp == sz.decode_utts):
                raise RuntimeError(f"decode {method}: {res}, {n_hyp} hyps")
            out[method] = res
    out["peak_bytes_in_use"] = _peak_bytes()
    return out


def phase_serve(work, sz: Sizes, clock) -> dict:
    import http.client
    from http.server import ThreadingHTTPServer

    from kaldi_ctc_tpu.cli import init_model, serve

    exp = os.path.join(work, "exp_serve")
    init_model.main(["--input-dim", "40", "--num-targets", str(sz.targets),
                     "--hidden-dim", str(sz.hidden),
                     "--num-layers", str(sz.layers), "--bidirectional", "0",
                     "--param-stddev", "0.1", "--dir", exp])
    out = {"phase": "serve"}
    args = serve.parse_args(["--dir", exp, "--port", "0",
                             "--use-priors", "0", "--max-streams", "2"])
    engine = serve.Engine(args)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(engine))
    port = httpd.server_address[1]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()

    def post(path, body=b""):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        try:
            conn.request("POST", path, body=body)
            resp = conn.getresponse()
            data = json.loads(resp.read().decode())
        finally:
            conn.close()
        if resp.status != 200:
            raise RuntimeError(f"{path}: {resp.status} {data}")
        return data

    try:
        with clock.measure(out):
            audio = [_pcm(sz.utt_seconds, seed) for seed in range(3)]
            offline, lat = [], []
            for body in audio:
                t0 = time.perf_counter()
                offline.append(post("/recognize", body)["labels"])
                lat.append(round(time.perf_counter() - t0, 4))
            streamed = [None, None]
            errors = []

            def stream(k):
                try:
                    slot = post("/stream/start")["slot"]
                    body, step = audio[k], 2 * 3200     # 200 ms chunks
                    for off in range(0, len(body), step):
                        post(f"/stream/{slot}/chunk", body[off:off + step])
                    streamed[k] = post(f"/stream/{slot}/end")["labels"]
                except Exception as e:  # noqa: BLE001 — reported below
                    errors.append(repr(e))

            workers = [threading.Thread(target=stream, args=(k,))
                       for k in range(2)]
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=600)
        if errors or any(w.is_alive() for w in workers):
            raise RuntimeError(f"stream sessions failed: {errors}")
    finally:
        httpd.shutdown()
        httpd.server_close()
    for k in range(2):
        if streamed[k] != offline[k]:
            raise RuntimeError(f"stream {k} labels {streamed[k]} != "
                               f"offline {offline[k]}")
    out.update({"recognize_s": lat,
                "labels_per_utt": [len(x) for x in offline],
                "streams_match_offline": True,
                "peak_bytes_in_use": _peak_bytes()})
    return out


def _blstm_case(sz: Sizes, mode, layers, seed):
    import jax
    import numpy as np

    from kaldi_ctc_tpu.ops.rnn import RnnConfig, init_rnn_params

    t = sz.raw_frames // sz.fs
    cfg = RnnConfig(input_dim=sz.input_dim, hidden_dim=sz.hidden,
                    num_layers=layers, mode=mode, bidirectional=True)
    params = init_rnn_params(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, sz.batch, sz.input_dim)).astype(np.float32)
    lens = rng.integers(t // 2, t + 1, size=sz.batch).astype(np.int32)
    lens[0] = t
    dy = rng.standard_normal((t, sz.batch, cfg.output_dim)).astype(
        np.float32)
    return cfg, params, x, lens, dy


def _ctc_case(sz: Sizes, seed=0):
    import numpy as np
    t = sz.raw_frames // sz.fs
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((sz.batch, t, sz.targets)) * 2).astype(
        np.float32)
    label_lens = rng.integers(sz.ctc_labels // 2, sz.ctc_labels + 1,
                              size=sz.batch).astype(np.int32)
    label_lens[0] = sz.ctc_labels
    labels = rng.integers(1, sz.targets, size=(sz.batch, sz.ctc_labels)
                          ).astype(np.int32)
    input_lens = rng.integers(2 * sz.ctc_labels + 1, t + 1,
                              size=sz.batch).astype(np.int32)
    input_lens[0] = t
    return logits, labels, input_lens, label_lens


def phase_parity(work, sz: Sizes, clock) -> dict:
    import dataclasses as dc

    import jax
    import jax.numpy as jnp
    import numpy as np

    from kaldi_ctc_tpu import reference
    from kaldi_ctc_tpu.features import (FbankOptions, FrameOptions,
                                        MfccOptions, compute_fbank,
                                        compute_mfcc)
    from kaldi_ctc_tpu.ops.ctc import ctc_loss_and_grad
    from kaldi_ctc_tpu.ops.rnn import RnnMode, rnn_forward

    checks = []
    out = {"phase": "parity", "checks": checks}
    tf32 = ("f32 matmuls run in TF32 on this card by default (10-bit "
            "mantissa, 2^-11 per rounding), compounded through the layers")
    bf16 = ("bf16 operands and stored projections/outputs (8-bit "
            "mantissa, 2^-9 per rounding) at every layer")
    with clock.measure(out):
        for mode, layers, tag in ((RnnMode.LSTM, sz.layers, "blstm"),
                                  (RnnMode.GRU, sz.gru_layers, "bigru")):
            cfg, params, x, lens, dy = _blstm_case(sz, mode, layers, seed=3)
            p_np = jax.tree_util.tree_map(np.asarray, params)
            want_y, want_g, _ = reference.rnn_stack_grad(
                p_np, x, lens, int(mode), True, dy)
            dtypes = ("float32", "bfloat16") if tag == "blstm" else (
                "float32",)
            for dtype in dtypes:
                c = dc.replace(cfg, compute_dtype=dtype)

                @jax.jit
                def fwd_grad(p, x, lens, dy, c=c):
                    def loss(p):
                        y = rnn_forward(p, x, c, lens)
                        return jnp.sum(y.astype(jnp.float32) * dy), y
                    return jax.grad(loss, has_aux=True)(p)

                g, y = fwd_grad(params, jnp.asarray(x), jnp.asarray(lens),
                                jnp.asarray(dy))
                tol_y, tol_g, why = ((1e-2, 2e-2, tf32)
                                     if dtype == "float32"
                                     else (5e-2, 1e-1, bf16))
                checks.append(_check(f"{tag}_{dtype}_forward", y, want_y,
                                     tol_y, why))
                flat_got = np.concatenate([np.ravel(a) for a in
                                           jax.tree_util.tree_leaves(g)])
                flat_want = np.concatenate([np.ravel(a) for a in
                                            jax.tree_util.tree_leaves(
                                                want_g)])
                checks.append(_check(f"{tag}_{dtype}_param_grad", flat_got,
                                     flat_want, tol_g, why))

        args = _ctc_case(sz)
        loss, grad = jax.jit(ctc_loss_and_grad)(*map(jnp.asarray, args))
        want_loss, want_grad = reference.ctc_loss_and_grad(*args)
        checks.append(_check(
            "ctc_loss", loss, want_loss, 1e-5,
            "exp/log recursions in f32, no reduced-precision matmul"))
        checks.append(_check(
            "ctc_grad", grad, want_grad, 2e-3,
            "posteriors are exp(alpha + beta - logZ) with |alpha|, |beta| "
            "~1e3 at T=240, where an f32 ulp is 6e-5, compounded over "
            "240 steps (the CPU shows the same 7e-4)"))

        rng = np.random.default_rng(4)
        wave = (rng.standard_normal(int(16000 * sz.audio_seconds))
                * 1000).astype(np.float32)
        nd = FrameOptions(dither=0.0)
        why = ("f32 rFFT and HIGHEST-precision mel/DCT matmuls; log of "
               "f32 mel energies")
        fopts = FbankOptions(frame_opts=nd)
        got = jax.jit(lambda w: compute_fbank(w, fopts))(jnp.asarray(wave))
        checks.append(_check("fbank", got, reference.fbank(wave, fopts),
                             1e-3, why))
        mopts = dc.replace(MfccOptions.hires(), frame_opts=nd)
        got = jax.jit(lambda w: compute_mfcc(w, mopts))(jnp.asarray(wave))
        checks.append(_check("mfcc_hires", got, reference.mfcc(wave, mopts),
                             1e-3, why))
    out["peak_bytes_in_use"] = _peak_bytes()
    bad = [c["check"] for c in checks if not c["ok"]]
    if bad:
        print(json.dumps(out))
        raise RuntimeError(f"parity outside tolerance: {bad}")
    return out


def _time(fn, *args, reps):
    """Median wall seconds of fn(*args), warmed up, device-synchronized."""
    import jax
    jax.block_until_ready(fn(*args))
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        samples.append(time.perf_counter() - t0)
    return {"median_ms": statistics.median(samples) * 1e3,
            "min_ms": min(samples) * 1e3, "max_ms": max(samples) * 1e3,
            "n": reps}


def phase_ops(work, sz: Sizes, clock) -> dict:
    import dataclasses as dc

    import jax
    import jax.numpy as jnp
    import numpy as np

    from kaldi_ctc_tpu.features import FbankOptions, compute_fbank
    from kaldi_ctc_tpu.ops.ctc import ctc_loss_and_grad
    from kaldi_ctc_tpu.ops.rnn import (RnnConfig, RnnMode, init_rnn_params,
                                       rnn_forward)

    t = sz.raw_frames // sz.fs
    rows = []
    out = {"phase": "ops", "rows": rows}
    with clock.measure(out):
        # an inner BLSTM layer: input is the previous layer's 2H output
        rng = np.random.default_rng(5)
        x = jnp.asarray(rng.standard_normal(
            (t, sz.batch, 2 * sz.hidden)).astype(np.float32))
        lens = jnp.full((sz.batch,), t, jnp.int32)
        for dtype in ("bfloat16", "float32"):
            cfg = RnnConfig(input_dim=2 * sz.hidden, hidden_dim=sz.hidden,
                            num_layers=1, mode=RnnMode.LSTM,
                            bidirectional=True, compute_dtype=dtype)
            params = init_rnn_params(jax.random.PRNGKey(0), cfg)

            @jax.jit
            def layer_fwd_bwd(p, x, cfg=cfg):
                def loss(p, x):
                    return jnp.sum(rnn_forward(p, x, cfg, lens).astype(
                        jnp.float32))
                return jax.grad(loss, argnums=(0, 1))(p, x)

            rows.append({"op": f"blstm_layer_fwd_bwd_{dtype}",
                         "shape": [t, sz.batch, 2 * sz.hidden, sz.hidden],
                         **_time(layer_fwd_bwd, params, x, reps=sz.reps)})
        ctc = jax.jit(ctc_loss_and_grad)
        args = tuple(map(jnp.asarray, _ctc_case(sz)))
        rows.append({"op": "ctc_loss_and_grad",
                     "shape": [sz.batch, t, sz.ctc_labels, sz.targets],
                     **_time(ctc, *args, reps=sz.reps)})
        wave = jnp.asarray(np.random.default_rng(6).standard_normal(
            int(16000 * sz.audio_seconds)).astype(np.float32) * 1000)
        fopts = FbankOptions()
        fb = jax.jit(lambda w: compute_fbank(w, dc.replace(
            fopts, frame_opts=dc.replace(fopts.frame_opts, dither=0.0))))
        rows.append({"op": "fbank", "shape": [int(wave.shape[0])],
                     **_time(fb, wave, reps=sz.reps)})
    return out


def phase_four_cards(work, sz: Sizes, clock, devices) -> dict:
    """train_ctc data-parallel over `devices` at a global batch of
    len(devices) * sz.batch, and the same global batch on one device.

    Per-step losses must agree to 2e-2 relative: both runs see the same
    batches and initial weights; they differ in bf16 rounding of
    per-device batch shapes and in the gradient allreduce's summation
    order, which compound over the steps."""
    import numpy as np

    n = len(devices)
    data = make_data(os.path.join(work, "data4"), sz,
                     n * sz.batch * sz.dp_steps, seed=7)
    out = {"phase": "four_cards", "devices": n,
           "global_batch": n * sz.batch}
    multi, l_multi = _train(work, "dp", data, sz, sz.dp_steps, [], clock,
                            devices, batch=n * sz.batch)
    multi["peak_bytes_in_use"] = [_peak_bytes(d) for d in devices]
    single, l_single = _train(work, "single", data, sz, sz.dp_steps, [],
                              clock, devices[:1], batch=n * sz.batch)
    rel = float(np.max(np.abs(np.subtract(l_multi, l_single))
                       / np.abs(l_single)))
    out.update({"multi": multi, "single": single,
                "max_rel_loss_diff": rel, "tol_rel": 2e-2})
    if rel > 2e-2:
        raise RuntimeError(f"losses differ by {rel}: {l_multi} vs "
                           f"{l_single}")
    # memory_stats() exists on GPUs only; the CPU rehearsal has none
    if devices[0].platform == "gpu" and not all(multi["peak_bytes_in_use"]):
        raise RuntimeError(f"a card held no memory: "
                           f"{multi['peak_bytes_in_use']}")
    return out


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--four-cards", action="store_true",
                   help="run only the four-card data-parallel check")
    args = p.parse_args(argv)
    # CUDA or nothing: a failed CUDA init must stop the run, not fall back
    # to the CPU (which stays listed for serve's host-side features)
    os.environ["JAX_PLATFORMS"] = "cuda,cpu"
    import kaldi_ctc_tpu  # noqa: F401 — fails outside a checkout
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {devices[0].platform})",
              file=sys.stderr)
        return 2
    line = card_line()
    print(line)
    print(json.dumps(phase_card(line)))
    clock = CompileClock()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        if args.four_cards:
            if len(devices) < 4:
                print(f"chip_smoke: --four-cards needs 4 GPUs, found "
                      f"{len(devices)}", file=sys.stderr)
                return 2
            devices = devices[:4]
            print(json.dumps(phase_four_cards(work, FULL, clock, devices)))
        else:
            train = functools.partial(phase_train, devices=devices[:1])
            for phase in (train, phase_decode, phase_serve, phase_parity,
                          phase_ops):
                t0 = time.perf_counter()
                res = phase(work, FULL, clock)
                res["phase_s"] = round(time.perf_counter() - t0, 3)
                print(json.dumps(res), flush=True)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
