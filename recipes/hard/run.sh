#!/usr/bin/env bash
# Hard synthetic WER recipe — the benchmark that can DETECT model quality.
#
# Same CLI chain as recipes/medium/run.sh (egs -> train -> TLG -> WFST
# lattice decode -> score_lattices sweep), but on the confusable corpus
# (make_data.py: clustered low-SNR phone embeddings, correlated
# articulation noise, coarticulation, speaker/rate variation) calibrated
# so the scaled-flagship config lands at mid-range WER — the regime the
# reference's own headline table lives in (README.md:51-54) and where
# ablations (realign / NG-SGD / DS2 / bf16) produce separable numbers.
#
#   bash recipes/hard/run.sh                      # baseline arm, seed 0
#   arm=realign bash recipes/hard/run.sh          # one ablation arm
#   bash recipes/hard/ablate.sh                   # the full matrix
#
# Arms (what changes vs baseline):
#   baseline  bidir LSTM 128x3, simple SGD+momentum, f32, no realign
#   realign   +--realign-epochs (in-loop align->relabel->priors)
#   ng        --affine-type natural (NG-SGD preconditioned affines)
#   ds2       +conv front end (2 layers, time stride 2)
#   bf16      --compute-dtype bfloat16
#
# Per-arm results land in $work/$arm.s$seed/wer_ci.json (WER + 95% CI,
# bootstrap over test utterances, recipes/hard/wer_ci.py).
set -euo pipefail

stage=${stage:-0}
work=${work:-/tmp/kctpu_hard}
arm=${arm:-baseline}
seed=${seed:-0}

vocab=${vocab:-5000}
train_utts=${train_utts:-1200}
test_utts=${test_utts:-120}
num_targets=${num_targets:-42}     # 41 phones + blank

# corpus difficulty (calibrated; see make_data.py --help and README)
within_sep=${within_sep:-0.85}
noise=${noise:-0.45}
artic=${artic:-0.25}

hidden_dim=${hidden_dim:-128}
num_layers=${num_layers:-3}
epochs=${epochs:-40}
minibatch_size=${minibatch_size:-48}
fs_factor=${fs_factor:-3}
lr_initial=${lr_initial:-1e-3}
lr_final=${lr_final:-1e-4}

wfst_beam=${wfst_beam:-16}
lattice_beam=${lattice_beam:-8}
blank_threshold=${blank_threshold:-0.98}

cd "$(dirname "$0")"
export PYTHONPATH="$(cd ../.. && pwd)${PYTHONPATH:+:$PYTHONPATH}"

# Every CLI stage runs as its own process under a wall-clock bound;
# KCTPU_STAGE_TIMEOUT (seconds) raises it for the big training stage.
pyrun() {
  timeout -k 10 "${KCTPU_STAGE_TIMEOUT:-900}" python -m "$@"
}

# arm -> extra train flags
train_flags=()
case "$arm" in
  baseline) ;;
  realign)  train_flags+=(--realign-epochs 15) ;;
  ng)       train_flags+=(--affine-type natural) ;;
  ds2)      train_flags+=(--conv-layers 2 --conv-channels 32
                          --conv-time-stride 1
                          --lr-warmup-steps "${ds2_warmup:-0}") ;;
            # stride 1: at fs=3 a time stride of 2 would leave ~1.2
            # subsampled frames per label — under the 2L+1 CTC bound,
            # the egs filters would drop most of the corpus and the
            # arm would not be comparable
  bf16)     train_flags+=(--compute-dtype bfloat16) ;;
  *) echo "unknown arm: $arm" >&2; exit 2 ;;
esac

data="$work/data"; graph="$work/graph"
exp="$work/$arm.s$seed"
mkdir -p "$data" "$exp" "$graph"

if [ "$stage" -le 0 ] && [ ! -f "$data/.done" ]; then
  echo "=== stage 0: synthesize hard corpus (shared across arms)"
  python make_data.py --out "$data" --vocab "$vocab" \
    --train-utts "$train_utts" --test-utts "$test_utts" \
    --within-sep "$within_sep" --noise "$noise" --artic "$artic" \
    --fs-factor "$fs_factor" | tee "$work/data.json"
  touch "$data/.done"
fi

if [ "$stage" -le 1 ] && [ ! -f "$data/egs/.done" ]; then
  echo "=== stage 1: egs archives (shared across arms)"
  mkdir -p "$data/egs"
  pyrun kaldi_ctc_tpu.cli.prepare_egs get \
    --feats "ark:$data/train/feats.ark" --ali "ark:$data/train/ali.ark" \
    --max-allow-frames $((700 * fs_factor)) \
    --output "ark,scp:$data/egs/egs.1.ark,$data/egs/egs.1.scp" \
    --num-archives 1
  pyrun kaldi_ctc_tpu.cli.prepare_egs sort \
    --egs "ark:$data/egs/egs.1.ark" \
    --output "ark,scp:$data/egs/sorted.1.ark,$data/egs/egs.scp"
  touch "$data/egs/.done"
fi

if [ "$stage" -le 2 ]; then
  echo "=== stage 2: train arm=$arm seed=$seed"
  KCTPU_STAGE_TIMEOUT=${train_timeout:-3600} \
  pyrun kaldi_ctc_tpu.cli.train_ctc \
    --egs "scp:$data/egs/egs.scp" --num-targets "$num_targets" \
    --hidden-dim "$hidden_dim" --num-layers "$num_layers" \
    --bidirectional 1 --epochs "$epochs" \
    --minibatch-size "$minibatch_size" \
    --frame-subsampling-factor "$fs_factor" \
    --initial-learning-rate "$lr_initial" \
    --final-learning-rate "$lr_final" --momentum 0.9 \
    --clip-gradient 5.0 --seed "$seed" \
    "${train_flags[@]}" \
    --dir "$exp" --checkpoint-period 200
fi

if [ "$stage" -le 3 ] && [ ! -f "$graph/TLG.fst" ]; then
  echo "=== stage 3: TLG graph (shared across arms)"
  pyrun kaldi_ctc_tpu.cli.graph_tool make-tlg \
    --lexicon "$data/lexicon.txt" --arpa "$data/lm.arpa" \
    --phones "$data/phones.txt" --output "$graph/TLG.fst"
fi

if [ "$stage" -le 4 ]; then
  echo "=== stage 4: decode + score arm=$arm seed=$seed"
  pyrun kaldi_ctc_tpu.cli.decode_ctc \
    --feats "ark:$data/test/feats.ark" --dir "$exp" \
    --method wfst --graph "$graph/TLG.fst" \
    --words "$graph/TLG.fst.words.txt" \
    --wfst-beam "$wfst_beam" --lattice "$exp/lat.test.ark.txt" \
    --lattice-beam "$lattice_beam" --determinize 1 \
    --blank-threshold "$blank_threshold" \
    --frame-subsampling-factor "$fs_factor" \
    --text "$data/test/text" \
    --output "$exp/hyps.test.txt" | tee "$exp/decode.json"
  pyrun kaldi_ctc_tpu.cli.score_lattices \
    --lattices "$exp/lat.test.ark.txt" --text "$data/test/text" \
    --words "$graph/TLG.fst.words.txt" --compact 1 \
    --min-lmwt 5 --max-lmwt 15 \
    --output "$exp/best_hyps.test.txt" | tee "$exp/wer_sweep.json"
  python wer_ci.py "$data/test/text" "$exp/best_hyps.test.txt" \
    | tee "$exp/wer_ci.json"
fi

echo "=== $arm.s$seed done:"
cat "$exp/wer_ci.json"
