"""Benchmark: training throughput of the flagship BLSTM-CTC model.

Measures audio-seconds of speech processed per second per chip on the
librispeech 'google' training configuration (5-layer BLSTM cell 320/dir,
minibatch 48, 700-raw-frame utterances at frame_subsampling_factor 3 →
240 subsampled frames ≈ 7.2 s audio per utterance; run.sh:148-151).

Baseline: the reference trained librispeech-960 ×3 speed-perturb ×5 epochs
in 17h43m35s on 3 GPUs (reports/ctc-google/accuracy.log final line) →
51.84e6 audio-s / 63815 s / 3 ≈ 271 audio-s/s per GPU.

K train steps are fused under one jit (lax.scan) and only a scalar is
fetched, so per-dispatch and transfer overhead stays out of the
measurement.

Prints one JSON line: {"metric", "value", "unit", "vs_baseline"}.

--scaling: the SURVEY §5.8 scaling harness — weak-scaling DP over the
local device mesh (global batch = 48 × n_devices, batch dim sharded over
the 'data' axis), reporting per-chip throughput at 1 device and at all
devices plus the parallel efficiency.  `--cpu 8` forces a virtual
8-device CPU mesh to validate the DP path without accelerators:
  python bench.py --scaling --tiny --cpu 8
On several GPUs plain `--scaling` measures the real scaling.
"""

import json
import sys
import time

import numpy as np

BASELINE_AUDIO_S_PER_S_PER_CHIP = 271.0

# flagship training shapes (run.sh:148-151: mb 48, max 700 frames, fs 3)
BATCH = 48
FRAMES = 240          # subsampled frames (700/3, padded up for tiling)
SECONDS_PER_FRAME = 0.03  # 10 ms shift × frame_subsampling_factor 3
# train steps fused into one dispatch
STEPS_PER_CALL = 40
# Every mode times each dispatch separately and reports median + min/max
# over TIMED_CALLS dispatches (round-3 verdict: single-run numbers made
# a ~7% run-to-run spread indistinguishable from regressions).
TIMED_CALLS = 5


def _stats(samples):
    """{median, min, max, n} over a list of per-call measurements."""
    s = sorted(samples)
    return {"median": s[len(s) // 2] if len(s) % 2 else
            0.5 * (s[len(s) // 2 - 1] + s[len(s) // 2]),
            "min": s[0], "max": s[-1], "n": len(s)}


def _bench_cfg(tiny=False, ds2=False, bf16=False):
    import dataclasses

    from __graft_entry__ import _flagship_cfg
    cfg = _flagship_cfg(tiny=tiny)
    if ds2:
        # DS2 family at the same recurrent scale: the conv front end's
        # 2x time stride halves the sequential BLSTM length
        cfg = dataclasses.replace(cfg, conv_layers=2, conv_channels=32,
                                  conv_time_stride=2)
    if bf16:
        # mixed precision: bf16-stored projections/outputs/dgates, f32
        # gate math, carries, params and accumulation
        cfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    return cfg


def _measure(devices, batch_per_chip=BATCH, tiny=False, ds2=False,
             bf16=False):
    """→ audio-s/s/chip with DP over the given devices."""
    import jax
    import jax.numpy as jnp

    from kaldi_ctc_tpu.models import init_am_params
    from kaldi_ctc_tpu.parallel.mesh import data_sharding, make_mesh
    from kaldi_ctc_tpu.training import (
        TrainOptions, build_train_step, init_train_state)

    cfg = _bench_cfg(tiny=tiny, ds2=ds2, bf16=bf16)
    n_dev = len(devices)
    b = batch_per_chip * n_dev
    frames = 48 if tiny else FRAMES
    lmax = 8 if tiny else 70
    steps_per_call = 3 if tiny else STEPS_PER_CALL
    timed_calls = 2 if tiny else TIMED_CALLS
    rng = np.random.default_rng(0)
    batch_np = {
        "feats": rng.standard_normal((b, frames, cfg.input_dim)).astype(
            np.float32),
        "labels": rng.integers(1, cfg.num_targets, (b, lmax)).astype(
            np.int32),
        "input_lens": np.full((b,), frames, np.int32),
        "label_lens": np.full((b,), lmax, np.int32),
    }
    mesh = make_mesh(devices=list(devices))
    sh = data_sharding(mesh)
    batch = {k: jax.device_put(v, sh) for k, v in batch_np.items()}

    step_fn = build_train_step(cfg, TrainOptions())

    @jax.jit
    def run_k(state, batch):
        def body(s, _):
            s2, m = step_fn(s, batch)
            return s2, m["loss_total"]
        state, losses = jax.lax.scan(body, state, None,
                                     length=steps_per_call)
        return state, losses[-1]

    params = init_am_params(jax.random.PRNGKey(0), cfg)
    state = init_train_state(params)
    # replicate params over the mesh so DP shards only the batch
    from jax.sharding import NamedSharding, PartitionSpec
    rep = NamedSharding(mesh, PartitionSpec())
    state = jax.device_put(state, rep)

    state, loss = run_k(state, batch)   # warmup (compile)
    _ = float(loss)
    audio_s_per_call = b * frames * SECONDS_PER_FRAME * steps_per_call
    samples = []
    for _ in range(timed_calls):
        t0 = time.perf_counter()
        state, loss = run_k(state, batch)
        _ = float(loss)                 # sync point
        samples.append(audio_s_per_call / (time.perf_counter() - t0)
                       / n_dev)
    return _stats(samples)


REFERENCE_DECODE_RTF = 0.055 / 3.0  # README.md:51-54: "(0.05-0.06) /
# frame_subsampling_factor" with the headline fs=3 run — i.e. ~0.018
# per second of audio, measured WITH the GPU forward pass included.


def _build_or_load_tlg(vocab, seed=0, trigram=True):
    """Build (once, cached under /tmp) a genuine pruned-trigram TLG via
    the full native mkgraph chain (decoding/graph.py) on a synthetic
    language (data/synth_lang.py).  trigram=False builds the
    bigram-only graph of the SAME language (identical lexicon/unigrams/
    bigrams; the tgsmall-class decode graph for the rescoring demo).
    → (graph, lang, word_to_id, build_info)."""
    import os
    import tempfile

    from kaldi_ctc_tpu.data.synth_lang import make_language
    from kaldi_ctc_tpu.decoding.graph import build_tlg
    from kaldi_ctc_tpu.decoding.wfst import NativeFst
    from kaldi_ctc_tpu.lm import parse_arpa
    import io

    cache_root = os.environ.get(
        "KCTPU_BENCH_CACHE",
        os.path.join(tempfile.gettempdir(), "kaldi_ctc_tpu_bench"))
    # v3 cache: BFS-renumbered graphs (build_tlg now ends with
    # renumber_bfs).  A v2 cache of the same language is upgraded in
    # place — renumbering is O(arcs), rebuilding is determinize-bound.
    cache = os.path.join(cache_root,
                         f"tlg3{'' if trigram else 'bg'}_v{vocab}_s{seed}")
    fst_path = os.path.join(cache, "TLG.fst")
    meta_path = os.path.join(cache, "meta.json")
    old = os.path.join(cache_root,
                       f"tlg2{'' if trigram else 'bg'}_v{vocab}_s{seed}")
    if not os.path.exists(fst_path) and os.path.exists(
            os.path.join(old, "TLG.fst")):
        from kaldi_ctc_tpu.decoding.wfst import NativeFst as _NF
        t0 = time.perf_counter()
        g = _NF.load(os.path.join(old, "TLG.fst")).renumber_bfs()
        os.makedirs(cache, exist_ok=True)
        g.write(fst_path)
        with open(os.path.join(old, "meta.json")) as f:
            m = json.load(f)
        m["renumber_migrate_s"] = round(time.perf_counter() - t0, 1)
        with open(meta_path, "w") as f:
            json.dump(m, f)
        del g

    t0 = time.perf_counter()
    kw = {} if trigram else {"trigram_hist_frac": 0.0}
    lang = make_language(vocab=vocab, seed=seed, **kw)  # deterministic
    gen_s = time.perf_counter() - t0

    if os.path.exists(fst_path) and os.path.exists(meta_path):
        graph = NativeFst.load(fst_path)
        with open(meta_path) as f:
            meta = json.load(f)
        meta["cached"] = True
        meta["lang_gen_s"] = round(gen_s, 1)
        return graph, lang, {w: int(i) for w, i
                             in meta["word_to_id"].items()}, meta

    lm = parse_arpa(io.StringIO(lang.arpa_text))
    timings = {}
    t0 = time.perf_counter()
    # graph ilabels must be the generator's own phone ids (synth
    # posterior column p is phone p), not order-of-appearance ids
    phone_to_id = {f"p{i:02d}": i
                   for i in range(1, lang.num_phones + 1)}
    graph, word_to_id, phone_to_id = build_tlg(
        lang.lexicon, lm, phone_to_id=phone_to_id, timings=timings)
    build_s = time.perf_counter() - t0
    meta = {
        "vocab": vocab,
        "ngrams": [int(c) for c in lm.counts],
        "graph_states": graph.num_states, "graph_arcs": graph.num_arcs,
        "graph_build_s": round(build_s, 1),
        "build_stage_s": {k: round(v, 1) for k, v in timings.items()},
        "word_to_id": word_to_id,
        "lang_gen_s": round(gen_s, 1), "cached": False,
    }
    os.makedirs(cache, exist_ok=True)
    graph.write(fst_path)
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    return graph, lang, word_to_id, meta


def _forward_rtf(frames_per_utt, utts):
    """Device acoustic forward RTF at flagship shapes: jitted am_forward +
    acoustic_scores (softmax/priors/blank-skip on device), the part of
    the per-utterance decode chain the reference runs on GPU
    (nnet2-ctc-latgen-faster's Decodable, ctc-decodable-am-nnet.cc)."""
    import jax

    from __graft_entry__ import _flagship_cfg
    from kaldi_ctc_tpu.decoding.scores import acoustic_scores
    from kaldi_ctc_tpu.models import (am_forward, default_priors,
                                      init_am_params)

    cfg = _flagship_cfg()
    raw_t = int(np.ceil(frames_per_utt * 3 / 8.0) * 8)  # fs=3, pad to 8
    b = utts
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((b, raw_t, cfg.input_dim)).astype(
        np.float32)
    lens = np.full((b,), raw_t, np.int32)
    priors = default_priors(cfg.num_targets)

    @jax.jit
    def fwd(params, feats, lens):
        logits = am_forward(params, feats, cfg, input_lens=lens)
        scores, skip = acoustic_scores(logits, priors=priors)
        return scores, skip

    params = init_am_params(jax.random.PRNGKey(0), cfg)
    out = fwd(params, feats, lens)           # compile
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(3):
        out = fwd(params, feats, lens)
        jax.block_until_ready(out)
    fwd_s = (time.perf_counter() - t0) / 3.0
    audio_s = b * raw_t * 0.01                # raw frames at 10 ms
    return fwd_s / audio_s


def _decode_bench(vocab=20_000, utts=16, with_forward=False, seed=0):
    """End-to-end decode pipeline RTF on a genuine pruned-3-gram TLG.

    The graph is the real thing — synthetic pruned-trigram ARPA →
    arpa_to_fst → L∘G → determinize-star → minimize → push-special →
    CTC transform — so per-frame active sets have true n-gram LM
    structure.  Every stage of the reference's decode recipe
    (steps/ctc/decode.sh + local/score.sh: latgen → determinize → MBR →
    LM rescore → WER) is timed separately, and utterances are sampled
    *from the LM* with trained-net-shaped posteriors
    (synth_posteriors), so the WER at the end checks correctness of the
    whole chain, not just its speed.

    --with-forward adds the device acoustic forward (flagship BLSTM, jitted
    am_forward + acoustic_scores) for the apples-to-apples comparison
    with the reference's (0.05-0.06)/fs RTF, which includes its GPU
    forward (README.md:51-54)."""
    from kaldi_ctc_tpu.data.synth_lang import edit_distance, synth_posteriors
    from kaldi_ctc_tpu.decoding.det_lattice import (
        determinize_lattice_pruned)
    from kaldi_ctc_tpu.decoding.lattice import decode_lattice
    from kaldi_ctc_tpu.decoding.mbr import MinimumBayesRisk
    from kaldi_ctc_tpu.decoding.wfst import (
        decode_best_path, decode_best_path_batch)

    graph, lang, word_to_id, meta = _build_or_load_tlg(vocab, seed=seed)

    # --- utterances sampled from the LM, posteriors shaped like a
    # trained net's output (spikes + competitors + blank background) ---
    rng = np.random.default_rng(seed + 1)
    truth, scores, total_frames = [], [], 0
    for _ in range(utts):
        wids = lang.sample_sentence(rng)
        truth.append([word_to_id[lang.words[w]] for w in wids])
        phone_seq = [int(p) for w in wids for p in lang.prons[w]]
        post = synth_posteriors(phone_seq, lang.num_phones, rng)
        total_frames += post.shape[0]
        logp = np.log(post)
        # reference blank-skip: drop frames with blank post >= 0.98
        # (nnet2-ctc-latgen-faster --blank-threshold, run_ctc_phone.sh:38)
        scores.append(np.ascontiguousarray(logp[post[:, 0] < 0.98]))
    audio_s = total_frames * SECONDS_PER_FRAME
    kept = sum(s.shape[0] for s in scores) / total_frames

    rtf_fwd = _forward_rtf(total_frames // utts, utts) if with_forward \
        else None

    for s in scores[:2]:
        decode_best_path(graph, s)          # warm the code path
    # median-of-3 full passes (round-3 verdict #3: every decode RTF
    # reports median + spread)
    rtf_1t_samples = []
    for _ in range(3):
        t0 = time.perf_counter()
        hyps = []
        for s in scores:
            w, _, _, ok = decode_best_path(graph, s)
            assert ok and len(w) > 0
            hyps.append([int(x) for x in w])
        rtf_1t_samples.append((time.perf_counter() - t0) / audio_s)
    st_1t = _stats(rtf_1t_samples)
    rtf_1t = st_1t["median"]

    rtf_batch_samples = []
    for _ in range(3):
        t0 = time.perf_counter()
        res = decode_best_path_batch(graph, scores)
        assert all(r[3] for r in res)
        rtf_batch_samples.append((time.perf_counter() - t0) / audio_s)
    st_b = _stats(rtf_batch_samples)
    rtf_batch = st_b["median"]

    t0 = time.perf_counter()
    lats = [decode_lattice(graph, s, lattice_beam=8.0) for s in scores]
    rtf_lat = (time.perf_counter() - t0) / audio_s

    t0 = time.perf_counter()
    clats = [determinize_lattice_pruned(lat, det_beam=8.0)
             for lat in lats]
    rtf_det = (time.perf_counter() - t0) / audio_s

    t0 = time.perf_counter()
    mbr_hyps = [MinimumBayesRisk(c, acoustic_scale=1.0).one_best
                for c in clats]
    rtf_mbr = (time.perf_counter() - t0) / audio_s

    # LM rescore — the two-call lmrescore pipeline (steps/lmrescore.sh
    # semantics, decoding/rescore.py:3-10): subtract the decoding LM at
    # lm_scale=-1, then add the rescoring LM at +1.  With the same LM
    # the round trip must leave the one-best unchanged (neutrality
    # invariant, asserted in tests/test_mbr.py); timing covers both
    # passes, the cost a real tgsmall->tglarge rescore pays.
    from kaldi_ctc_tpu.decoding.rescore import lmrescore_compact
    from kaldi_ctc_tpu.lm import parse_arpa
    import io
    lm = parse_arpa(io.StringIO(lang.arpa_text))
    id_to_word = {i: w for w, i in word_to_id.items()}
    t0 = time.perf_counter()
    rescored = [
        lmrescore_compact(
            lmrescore_compact(c, lm, id_to_word, lm_scale=-1.0),
            lm, id_to_word, lm_scale=1.0)
        for c in clats]
    rtf_resc = (time.perf_counter() - t0) / audio_s

    t0 = time.perf_counter()
    errs = sum(edit_distance(t, h) for t, h in zip(truth, hyps))
    n_ref = sum(len(t) for t in truth)
    wer = 100.0 * errs / max(n_ref, 1)
    errs_mbr = sum(edit_distance(t, h) for t, h in zip(truth, mbr_hyps))
    wer_mbr = 100.0 * errs_mbr / max(n_ref, 1)
    errs_resc = sum(
        edit_distance(t, r.best_path()[0]) for t, r in
        zip(truth, rescored))
    wer_resc = 100.0 * errs_resc / max(n_ref, 1)
    score_s = time.perf_counter() - t0

    # rescoring-helps demo (tgsmall->tglarge analogue): decode the same
    # posteriors through the bigram-only TLG of the same language, then
    # rescore with the full trigram LM via the two-call pipeline — the
    # trigram LM must recover accuracy the weaker decode graph lost.
    # --no-bigram skips it (at 50k+ vocab the bigram graph is a second
    # multi-GB determinization; the 2k/20k rows already demonstrate the
    # rescore chain).
    wer_bg = wer_bg_resc = None
    meta_bg = {"graph_states": None}
    graph_bg, lang_bg, word_to_id_bg, meta_bg2 = (
        (None, None, None, None) if "--no-bigram" in sys.argv
        else _build_or_load_tlg(vocab, seed=seed, trigram=False))
    if graph_bg is not None:
        meta_bg = meta_bg2
        lm_bg = parse_arpa(io.StringIO(lang_bg.arpa_text))
        id_to_word_bg = {i: w for w, i in word_to_id_bg.items()}
        truth_words = [[id_to_word[i] for i in t] for t in truth]
        clats_bg = [determinize_lattice_pruned(
            decode_lattice(graph_bg, s, lattice_beam=8.0), det_beam=8.0)
            for s in scores]
        errs_bg = sum(
            edit_distance(t, [id_to_word_bg[int(w)]
                              for w in c.best_path()[0]])
            for t, c in zip(truth_words, clats_bg))
        wer_bg = 100.0 * errs_bg / max(n_ref, 1)
        resc_bg = [
            lmrescore_compact(
                lmrescore_compact(c, lm_bg, id_to_word_bg, lm_scale=-1.0),
                lm, id_to_word_bg, lm_scale=1.0)
            for c in clats_bg]
        errs_bg_r = sum(
            edit_distance(t, [id_to_word_bg[int(w)]
                              for w in r.best_path()[0]])
            for t, r in zip(truth_words, resc_bg))
        wer_bg_resc = 100.0 * errs_bg_r / max(n_ref, 1)

    full = rtf_lat + rtf_det + rtf_mbr + rtf_resc
    out = {
        "metric": "wfst_decode_rtf",
        "value": round(rtf_1t, 4), "unit": "rtf",
        "graph": "pruned-3gram TLG",
        "vocab": meta["vocab"], "ngrams": meta["ngrams"],
        "graph_states": meta["graph_states"],
        "graph_arcs": meta["graph_arcs"],
        "graph_build_s": meta["graph_build_s"],
        "graph_cached": meta["cached"],
        "audio_s": round(audio_s, 1),
        "kept_frame_fraction": round(kept, 3),
        "rtf_spread": {"min": round(st_1t["min"], 4),
                       "max": round(st_1t["max"], 4), "n": st_1t["n"]},
        "rtf_batch_threaded": round(rtf_batch, 4),
        "rtf_batch_spread": {"min": round(st_b["min"], 4),
                             "max": round(st_b["max"], 4), "n": st_b["n"]},
        "rtf_lattice": round(rtf_lat, 4),
        "rtf_determinize": round(rtf_det, 4),
        "rtf_mbr": round(rtf_mbr, 4),
        "rtf_rescore": round(rtf_resc, 4),
        "rtf_full_lattice_pipeline": round(full, 4),
        "det_fraction_of_pipeline": round(rtf_det / full, 3),
        "wer_bestpath": round(wer, 2), "wer_mbr": round(wer_mbr, 2),
        "wer_rescored": round(wer_resc, 2),
        "wer_bigram_graph": (None if wer_bg is None else round(wer_bg, 2)),
        "wer_bigram_rescored_trigram": (
            None if wer_bg_resc is None else round(wer_bg_resc, 2)),
        "bigram_graph_states": meta_bg["graph_states"],
        "score_s": round(score_s, 2),
        "vs_baseline": round(REFERENCE_DECODE_RTF / rtf_1t, 3),
    }
    if rtf_fwd is not None:
        # the forward RTF is far below 1e-4 — 4-decimal rounding would
        # print 0.0; report 6 decimals + throughput
        out["rtf_forward"] = round(rtf_fwd, 6)
        out["forward_audio_s_per_s"] = round(1.0 / rtf_fwd, 1)
        out["rtf_forward_plus_bestpath"] = round(rtf_fwd + rtf_1t, 6)
        out["vs_baseline_with_forward"] = round(
            REFERENCE_DECODE_RTF / (rtf_fwd + rtf_1t), 3)
    print(json.dumps(out))


def _ctc_bench():
    """CTC-loss micro-bench (fwd+bwd) at the flagship training shapes —
    regenerates the README per-minibatch loss cost from the tree
    (round-3 verdict missing #4; reference analogue: warp-ctc's
    compute_ctc_loss per minibatch, ctc/ctc-nnet-update.cc:211-243).

    K loss+grad evaluations are fused under one jit with a tiny
    dependent update between them (so XLA cannot hoist the loop body),
    making per-dispatch overhead negligible."""
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import _flagship_cfg
    from kaldi_ctc_tpu.ops.ctc import ctc_loss

    cfg = _flagship_cfg()
    A, B, T, L = cfg.num_targets, BATCH, FRAMES, 70
    rng = np.random.default_rng(0)
    logits = jnp.asarray(rng.standard_normal((B, T, A)), jnp.float32)
    labels = jnp.asarray(rng.integers(1, A, (B, L)), jnp.int32)
    ilens = jnp.full((B,), T, jnp.int32)
    llens = jnp.full((B,), L, jnp.int32)
    K = 50

    @jax.jit
    def run_k(logits):
        def body(lg, _):
            def f(x):
                return jnp.sum(ctc_loss(x, labels, ilens, llens))
            loss, g = jax.value_and_grad(f)(lg)
            # real dependent update: prevents CSE/hoisting of the body
            return lg - 1e-6 * g, loss
        lg, losses = jax.lax.scan(body, logits, None, length=K)
        return lg, losses[-1]

    out = run_k(logits)
    jax.block_until_ready(out)          # compile + warm
    samples = []
    for _ in range(TIMED_CALLS):
        t0 = time.perf_counter()
        out = run_k(logits)
        jax.block_until_ready(out)
        samples.append((time.perf_counter() - t0) / K * 1e3)
    st = _stats(samples)
    print(json.dumps({
        "metric": "ctc_loss_fwd_bwd_ms",
        "value": round(st["median"], 3), "unit": "ms/minibatch",
        "spread": {"min": round(st["min"], 3),
                   "max": round(st["max"], 3)}, "n": st["n"],
        "shapes": {"batch": B, "frames": T, "alphabet": A,
                   "max_labels": L},
        "device_kind": jax.devices()[0].device_kind,
        "vs_baseline": None,
    }))


def _serve_bench(n_streams=8, chunks_per_stream=25, port=18057):
    """Serve-path latency bench (round-3 verdict do-this #8): starts the
    real HTTP server (cli/serve.py) on the chip with a flagship-family
    model, then drives N concurrent real-time-paced streaming clients
    (one 200 ms chunk per pace tick each) plus full-utterance
    /recognize calls, and reports p50/p95 chunk latency and end-to-end
    utterance latency.  The reference has no serving layer (its online
    decoders are library code only) — this measures the framework
    value-add surface, README 'Serving'."""
    import http.client
    import tempfile
    import threading
    import time as _time

    import jax

    from kaldi_ctc_tpu.cli import serve as serve_mod

    # fabricate a servable exp dir: flagship-family model, random params
    tmp = tempfile.mkdtemp(prefix="kctpu_serve_bench_")
    from __graft_entry__ import _flagship_cfg
    from kaldi_ctc_tpu.models import init_am_params
    from kaldi_ctc_tpu.training.checkpoint import save_checkpoint
    from kaldi_ctc_tpu.training import init_train_state
    import os

    import dataclasses
    # streaming requires a unidirectional model (a BLSTM's backward
    # direction needs the whole utterance); this is the flagship
    # streaming config — same depth/cell as the offline model
    cfg = dataclasses.replace(_flagship_cfg(), bidirectional=False)
    params = init_am_params(jax.random.PRNGKey(0), cfg)
    with open(os.path.join(tmp, "model_config.json"), "w") as f:
        json.dump(cfg.to_dict(), f)
    os.makedirs(os.path.join(tmp, "checkpoints"), exist_ok=True)
    save_checkpoint(os.path.join(tmp, "checkpoints"), 0,
                    init_train_state(params))

    args = serve_mod.parse_args([
        "--dir", tmp, "--port", str(port), "--use-priors", "0",
        "--max-streams", str(max(n_streams, 1)),
    ])
    engine = serve_mod.Engine(args)
    httpd = serve_mod.ThreadingHTTPServer(
        ("127.0.0.1", port), serve_mod.make_handler(engine))
    t_serve = threading.Thread(target=httpd.serve_forever, daemon=True)
    t_serve.start()

    rng = np.random.default_rng(0)
    sr = 16000
    chunk_s = 0.2                      # 20 frames @ 10 ms
    chunk = (rng.standard_normal(int(sr * chunk_s))
             * 3000).astype(np.int16).tobytes()
    utt = (rng.standard_normal(int(sr * 7.0))
           * 3000).astype(np.int16).tobytes()

    def post(conn, path, body):
        t0 = _time.perf_counter()
        conn.request("POST", path, body=body)
        resp = conn.getresponse()
        data = resp.read()
        assert resp.status == 200, (path, resp.status, data[:200])
        return _time.perf_counter() - t0, json.loads(data)

    # warm the compiled paths (first chunk/utterance compiles)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    _, st = post(conn, "/stream/start", b"")
    post(conn, f"/stream/{st['slot']}/chunk", chunk)
    post(conn, f"/stream/{st['slot']}/end", b"")
    post(conn, "/recognize", utt)
    conn.close()

    chunk_lat = []
    utt_lat = []
    lock = threading.Lock()

    def stream_client():
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        _, st = post(conn, "/stream/start", b"")
        slot = st["slot"]
        lats = []
        for _ in range(chunks_per_stream):
            tick = _time.perf_counter()
            dt, _r = post(conn, f"/stream/{slot}/chunk", chunk)
            lats.append(dt)
            # real-time pacing: next chunk arrives chunk_s after the
            # previous one STARTED (like a live audio source)
            sleep = chunk_s - (_time.perf_counter() - tick)
            if sleep > 0:
                _time.sleep(sleep)
        post(conn, f"/stream/{slot}/end", b"")
        conn.close()
        with lock:
            chunk_lat.extend(lats)

    def utt_client(n):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        lats = []
        for _ in range(n):
            dt, _r = post(conn, "/recognize", utt)
            lats.append(dt)
        conn.close()
        with lock:
            utt_lat.extend(lats)

    threads = [threading.Thread(target=stream_client)
               for _ in range(n_streams)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    # utterance latency measured separately (unloaded), then under the
    # streaming load
    utt_client(5)
    unloaded = sorted(utt_lat)
    utt_lat.clear()
    threads = [threading.Thread(target=stream_client)
               for _ in range(n_streams)]
    for t in threads:
        t.start()
    utt_client(5)
    for t in threads:
        t.join()
    loaded = sorted(utt_lat)
    httpd.shutdown()

    def pct(xs, p):
        xs = sorted(xs)
        return xs[min(len(xs) - 1, int(p / 100.0 * len(xs)))]

    out = {
        "metric": "serve_chunk_latency_p50_ms",
        "value": round(pct(chunk_lat, 50) * 1e3, 1),
        "unit": "ms",
        "n_streams": n_streams,
        "chunk_ms": int(chunk_s * 1e3),
        "chunk_p95_ms": round(pct(chunk_lat, 95) * 1e3, 1),
        "chunk_max_ms": round(max(chunk_lat) * 1e3, 1),
        "n_chunks": len(chunk_lat),
        "utt_s": 7.0,
        "utt_latency_unloaded_p50_ms": round(pct(unloaded, 50) * 1e3, 1),
        "utt_latency_under_streams_p50_ms": round(
            pct(loaded, 50) * 1e3, 1),
        "utt_latency_under_streams_p95_ms": round(
            pct(loaded, 95) * 1e3, 1),
        "realtime_ok": pct(chunk_lat, 95) < chunk_s,
        "device_kind": jax.devices()[0].device_kind,
        "vs_baseline": None,
    }
    print(json.dumps(out))


def _stream_bench(chunk_frames=20, batch=1, calls=60):
    """Streaming chunk-forward latency of the per-layer lax.scan path,
    in f32 and bf16, on the unidirectional flagship stack (5x320 LSTM —
    the serving model family).  This is the device half of the serve
    chunk budget (200 ms chunks); cli/serve.py adds features + HTTP on
    top (bench --serve measures that end to end)."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from kaldi_ctc_tpu.ops.rnn import (RnnConfig, RnnMode,
                                       init_rnn_params,
                                       init_stream_state,
                                       rnn_forward_stream)

    rows = []
    for dtype in ("float32", "bfloat16"):
        cfg = RnnConfig(input_dim=40, hidden_dim=320, num_layers=5,
                        mode=RnnMode.LSTM, bidirectional=False,
                        compute_dtype=dtype)
        params = init_rnn_params(jax.random.PRNGKey(0), cfg)
        x = jnp.asarray(np.random.default_rng(0).standard_normal(
            (chunk_frames, batch, 40)).astype(np.float32))
        lens = jnp.full((batch,), chunk_frames, jnp.int32)

        @jax.jit
        def fwd(params, x, states):
            return rnn_forward_stream(params, x, cfg, states, lens=lens)

        # a 16-chunk dependent chain under ONE jit measures the compute
        # path without per-dispatch overhead
        K = 16

        @jax.jit
        def fwd_k(params, x, states):
            def body(st, _):
                y, st2 = rnn_forward_stream(params, x, cfg, st,
                                            lens=lens)
                return st2, y[-1]
            states, ys = jax.lax.scan(body, states, None, length=K)
            return ys, states

        states = init_stream_state(cfg, batch)
        y, states = fwd(params, x, states)       # compile
        jax.block_until_ready(y)
        lat = []
        for _ in range(calls):
            t0 = time.perf_counter()
            y, states = fwd(params, x, states)
            jax.block_until_ready(y)
            lat.append(time.perf_counter() - t0)
        lat.sort()
        ys, st2 = fwd_k(params, x, init_stream_state(cfg, batch))
        jax.block_until_ready(ys)
        klat = []
        for _ in range(max(calls // 4, 8)):
            t0 = time.perf_counter()
            ys, st2 = fwd_k(params, x, st2)
            jax.block_until_ready(ys)
            klat.append((time.perf_counter() - t0) / K)
        klat.sort()
        rows.append({
            "dtype": dtype,
            "p50_ms": round(lat[len(lat) // 2] * 1e3, 3),
            "p95_ms": round(lat[min(len(lat) - 1,
                                    int(0.95 * len(lat)))] * 1e3, 3),
            "compute_ms_per_chunk": round(
                klat[len(klat) // 2] * 1e3, 3),
        })
    bf16 = next(r for r in rows if r["dtype"] == "bfloat16")
    print(json.dumps({
        "metric": "stream_chunk_forward_compute_ms",
        "value": bf16["compute_ms_per_chunk"], "unit": "ms",
        "chunk_frames": chunk_frames, "batch": batch,
        "rows": rows,
        "device_kind": jax.devices()[0].device_kind,
        "vs_baseline": None,
    }))


def _flag(name, default):
    if name in sys.argv:
        return int(sys.argv[sys.argv.index(name) + 1])
    return default


# Dense bf16 tensor-core peak FLOP/s by device kind: NVIDIA's H100 SXM
# data sheet (989 TFLOP/s bf16 without sparsity, at the 700 W limit).
_PEAK_BF16 = {
    "NVIDIA H100 80GB HBM3": 989e12,
}


def _peak_bf16(kind):
    if kind not in _PEAK_BF16:
        raise SystemExit(f"bench: no peak FLOP/s known for device kind "
                         f"{kind!r}; add it to _PEAK_BF16 with its source")
    return _PEAK_BF16[kind]


def _model_flops_per_subframe(cfg):
    """Analytic fwd+bwd FLOPs per RNN frame for the matmul path (the
    tensor-core work; gate pointwise ops — and the DS2 convs, when present —
    are not counted, so the MFU line is a floor).  Backward of a matmul
    is 2x the forward's FLOPs → train step = 3x forward."""
    from kaldi_ctc_tpu.ops.rnn import RnnMode
    rnn = cfg.rnn
    h = rnn.hidden_dim
    gates = {RnnMode.LSTM: 4, RnnMode.GRU: 3}.get(rnn.mode, 1)
    per_dir_in = rnn.input_dim * gates * h
    per_dir_rec = h * gates * h
    layers = per_dir_in + per_dir_rec
    for _ in range(rnn.num_layers - 1):
        layers += (2 * h if rnn.bidirectional else h) * gates * h \
            + h * gates * h
    ndir = 2 if rnn.bidirectional else 1
    out = (2 * h if rnn.bidirectional else h) * cfg.num_targets
    fwd = 2 * (layers * ndir + out)          # 2 FLOPs per MAC
    return 3 * fwd                           # fwd + bwd(2x)


def main():
    if "--decode" in sys.argv:
        _decode_bench(vocab=_flag("--vocab", 20_000),
                      utts=_flag("--utts", 16),
                      with_forward="--with-forward" in sys.argv,
                      seed=_flag("--seed", 0))
        return
    if "--cpu" in sys.argv:
        n = int(sys.argv[sys.argv.index("--cpu") + 1])
        import jax
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", n)
    import jax

    if "--ctc" in sys.argv:
        _ctc_bench()
        return

    if "--serve" in sys.argv:
        _serve_bench(n_streams=_flag("--streams", 8))
        return

    if "--stream" in sys.argv:
        _stream_bench(chunk_frames=_flag("--chunk-frames", 20),
                      batch=_flag("--batch", 1))
        return

    ds2 = "--ds2" in sys.argv
    bf16 = "--bf16" in sys.argv
    if "--scaling" in sys.argv:
        tiny = "--tiny" in sys.argv
        devs = jax.devices()
        suffix = ("_ds2" if ds2 else "") + ("_bf16" if bf16 else "")
        one = _measure(devs[:1], tiny=tiny, ds2=ds2, bf16=bf16)
        print(json.dumps({
            "metric": "train_throughput_audio_seconds_per_second_per_chip"
                      + suffix,
            "value": round(one["median"], 2), "unit": "audio-s/s/chip",
            "spread": {"min": round(one["min"], 2),
                       "max": round(one["max"], 2)}, "n": one["n"],
            "devices": 1,
            "vs_baseline": round(
                one["median"] / BASELINE_AUDIO_S_PER_S_PER_CHIP, 3)}))
        if len(devs) > 1:
            full = _measure(devs, tiny=tiny, ds2=ds2, bf16=bf16)
            print(json.dumps({
                "metric":
                    "train_throughput_audio_seconds_per_second_per_chip"
                    + suffix,
                "value": round(full["median"], 2),
                "unit": "audio-s/s/chip",
                "spread": {"min": round(full["min"], 2),
                           "max": round(full["max"], 2)}, "n": full["n"],
                "devices": len(devs),
                "scaling_efficiency": round(
                    full["median"] / one["median"], 3),
                "vs_baseline": round(
                    full["median"] / BASELINE_AUDIO_S_PER_S_PER_CHIP,
                    3)}))
        return

    # Headline: bf16 mixed precision — the default training dtype since
    # its round-5 quality validation (the hard-recipe matrix shows
    # paired ΔWER vs f32 centered on 0 after the f32-weight-cotangent
    # fix; see recipes/hard/RESULTS.md).  --f32 pins the old headline;
    # the default output carries both numbers.
    headline_bf16 = not ds2 and not bf16 and "--f32" not in sys.argv
    st = _measure(jax.devices()[:1], ds2=ds2, bf16=bf16 or headline_bf16)
    per_chip = st["median"]
    # analytic matmul-path FLOPs → achieved model FLOP/s and MFU vs the
    # card's dense bf16 peak
    cfg = _bench_cfg(ds2=ds2, bf16=bf16 or headline_bf16)
    flops_per_s = per_chip / SECONDS_PER_FRAME / cfg.time_stride \
        * _model_flops_per_subframe(cfg)
    kind = jax.devices()[0].device_kind
    peak = _peak_bf16(kind)
    out = {
        "metric": "train_throughput_audio_seconds_per_second_per_chip"
                  + ("_ds2" if ds2 else "") + ("_bf16" if bf16 else ""),
        "value": round(per_chip, 2),
        "unit": "audio-s/s/chip",
        "compute_dtype": ("bfloat16" if (bf16 or headline_bf16)
                          else "float32"),
        "spread": {"min": round(st["min"], 2), "max": round(st["max"], 2)},
        "n": st["n"],
        "model_tflops_per_s": round(flops_per_s / 1e12, 1),
        "device_kind": kind,
        "vs_baseline": round(per_chip / BASELINE_AUDIO_S_PER_S_PER_CHIP, 3),
        "mfu_vs_bf16_peak": round(flops_per_s / peak, 3),
    }
    if headline_bf16:
        st32 = _measure(jax.devices()[:1], ds2=ds2, bf16=False)
        out["f32"] = {"median": round(st32["median"], 2),
                      "min": round(st32["min"], 2),
                      "max": round(st32["max"], 2)}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
