#!/usr/bin/env bash
# Medium synthetic end-to-end WER recipe — one command, bounded runtime.
#
# Exercises the librispeech driver's ACTUAL code path (same CLI stages as
# recipes/librispeech_ctc/run.sh: egs -> train -> priors -> TLG -> WFST
# lattice decode -> score_lattices lm-weight sweep -> MBR -> report) on a
# generated corpus big enough to be non-trivial: ~1h audio-equivalent,
# 5k-word vocab, pruned-trigram LM (make_data.py), so the WER at the end
# checks the entire chain — graph construction, decoding, lattice
# determinization, scoring — not a 16-utterance toy.
#
#   bash recipes/medium/run.sh            # all stages
#   stage=5 bash recipes/medium/run.sh    # decode + score only
#
# The headline WER is tracked in README.md (## Medium synthetic recipe).
set -euo pipefail

stage=${stage:-0}
work=${work:-/tmp/kctpu_medium}
vocab=${vocab:-5000}
train_utts=${train_utts:-400}
test_utts=${test_utts:-40}
num_targets=${num_targets:-42}     # 41 phones + blank

# training knobs (scaled-down flagship: same family, bounded runtime).
# lr: updates are lr*sum over the global minibatch (reference semantics,
# run_ctc_phone.sh:32-33 uses 5e-4); a 4-config on-chip sweep showed
# 1e-3 converges to train acc 1.0 in ~150 steps while 4e-3 thrashes
# (elementwise-clipped updates reach the weight-init scale) and never
# escapes blank collapse.
hidden_dim=${hidden_dim:-128}
num_layers=${num_layers:-3}
epochs=${epochs:-40}
minibatch_size=${minibatch_size:-48}
fs_factor=${fs_factor:-3}
lr_initial=${lr_initial:-1e-3}
lr_final=${lr_final:-1e-4}
# exercise the realign loop; realign_epochs= (set-but-empty) disables it
# for the no-realign ablation, hence ${-} not ${:-}
realign_epochs=${realign_epochs-20}

# decode knobs (run_ctc_phone.sh:36-40)
wfst_beam=${wfst_beam:-16}
lattice_beam=${lattice_beam:-8}
blank_threshold=${blank_threshold:-0.98}

cd "$(dirname "$0")"
export PYTHONPATH="$(cd ../.. && pwd)${PYTHONPATH:+:$PYTHONPATH}"

# Every CLI stage runs as its own process under a wall-clock bound;
# KCTPU_STAGE_TIMEOUT (seconds) raises it for the big training stage.
pyrun() {
  timeout -k 10 "${KCTPU_STAGE_TIMEOUT:-600}" python -m "$@"
}
data="$work/data"; exp="$work/exp"; graph="$work/graph"
mkdir -p "$data" "$exp" "$graph"

if [ "$stage" -le 0 ]; then
  echo "=== stage 0: synthesize corpus (data prep analogue)"
  python make_data.py --out "$data" --vocab "$vocab" \
    --train-utts "$train_utts" --test-utts "$test_utts" \
    | tee "$work/data.json"
fi

if [ "$stage" -le 1 ]; then
  echo "=== stage 1: egs archives (get_egs2.sh analogue)"
  mkdir -p "$exp/egs"
  pyrun kaldi_ctc_tpu.cli.prepare_egs get \
    --feats "ark:$data/train/feats.ark" --ali "ark:$data/train/ali.ark" \
    --max-allow-frames $((700 * fs_factor)) \
    --output "ark,scp:$exp/egs/egs.1.ark,$exp/egs/egs.1.scp" \
    --num-archives 1
  pyrun kaldi_ctc_tpu.cli.prepare_egs sort \
    --egs "ark:$exp/egs/egs.1.ark" \
    --output "ark,scp:$exp/egs/sorted.1.ark,$exp/egs/egs.scp"
fi

if [ "$stage" -le 2 ]; then
  echo "=== stage 2: train (+in-loop realignment at epoch $realign_epochs)"
  KCTPU_STAGE_TIMEOUT=${train_timeout:-2400} \
  pyrun kaldi_ctc_tpu.cli.train_ctc \
    --egs "scp:$exp/egs/egs.scp" --num-targets "$num_targets" \
    --hidden-dim "$hidden_dim" --num-layers "$num_layers" \
    --bidirectional 1 --epochs "$epochs" \
    --minibatch-size "$minibatch_size" \
    --frame-subsampling-factor "$fs_factor" \
    --initial-learning-rate "$lr_initial" \
    --final-learning-rate "$lr_final" --momentum 0.9 \
    --clip-gradient 5.0 --realign-epochs "$realign_epochs" \
    --dir "$exp" --checkpoint-period 200
fi

if [ "$stage" -le 3 ]; then
  echo "=== stage 3: diagnostics (compute_prob on train egs)"
  pyrun kaldi_ctc_tpu.cli.compute_prob \
    --egs "ark:$exp/egs/sorted.1.ark" --dir "$exp" \
    --frame-subsampling-factor "$fs_factor" | tee "$work/train_prob.json"
fi

if [ "$stage" -le 4 ]; then
  echo "=== stage 4: TLG graph (mkgraph analogue, full native chain)"
  pyrun kaldi_ctc_tpu.cli.graph_tool make-tlg \
    --lexicon "$data/lexicon.txt" --arpa "$data/lm.arpa" \
    --phones "$data/phones.txt" --output "$graph/TLG.fst"
fi

if [ "$stage" -le 5 ]; then
  echo "=== stage 5: WFST lattice decode + score (decode.sh + score.sh)"
  pyrun kaldi_ctc_tpu.cli.decode_ctc \
    --feats "ark:$data/test/feats.ark" --dir "$exp" \
    --method wfst --graph "$graph/TLG.fst" \
    --words "$graph/TLG.fst.words.txt" \
    --wfst-beam "$wfst_beam" --lattice "$exp/lat.test.ark.txt" \
    --lattice-beam "$lattice_beam" --determinize 1 \
    --blank-threshold "$blank_threshold" \
    --frame-subsampling-factor "$fs_factor" \
    --text "$data/test/text" \
    --output "$exp/hyps.test.txt" | tee "$work/decode.json"
  pyrun kaldi_ctc_tpu.cli.score_lattices \
    --lattices "$exp/lat.test.ark.txt" --text "$data/test/text" \
    --words "$graph/TLG.fst.words.txt" --compact 1 \
    --min-lmwt 5 --max-lmwt 15 \
    --output "$exp/best_hyps.test.txt" | tee "$work/wer.json"
  pyrun kaldi_ctc_tpu.cli.lattice_tool mbr \
    --lattices "$exp/lat.test.ark.txt" --compact 1 \
    --words "$graph/TLG.fst.words.txt" \
    --output "$exp/mbr_hyps.test.txt"
  python - "$data/test/text" "$exp/mbr_hyps.test.txt" <<'EOF' | tee "$work/wer_mbr.json"
import json, sys
from kaldi_ctc_tpu.utils.edit_distance import edit_distance
refs = {l.split()[0]: l.split()[1:] for l in open(sys.argv[1])}
errs = n = 0
for l in open(sys.argv[2]):
    parts = l.split()
    if parts[0] in refs:
        errs += edit_distance(refs[parts[0]], parts[1:])
        n += len(refs[parts[0]])
print(json.dumps({"metric": "wer_mbr", "wer": round(100.0*errs/max(n,1), 2)}))
EOF
fi

if [ "$stage" -le 6 ]; then
  echo "=== stage 6: report"
  pyrun kaldi_ctc_tpu.cli.generate_report --dir "$exp" || true
  echo "WER sweep:"; cat "$work/wer.json"
fi
