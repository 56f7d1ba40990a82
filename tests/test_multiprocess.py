"""Multi-process SPMD training through the launch CLI (the run.pl
analogue): 2 coordinated jax.distributed CPU processes train one model,
and the result decodes like a single-process run."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from kaldi_ctc_tpu.utils import kaldi_io


def _make_dataset(tmp_path, n=8):
    rng = np.random.default_rng(0)
    lines = []
    with kaldi_io.MatrixWriter(f"ark:{tmp_path}/feats.ark") as fw, \
            kaldi_io.IntVectorWriter(f"ark:{tmp_path}/ali.ark") as aw:
        for i in range(n):
            labs = [1 + (i + j) % 3 for j in range(3)]   # pdf ids
            t = len(labs) * 8
            f = rng.standard_normal((t, 6)).astype(np.float32) * 0.1
            for j, lab in enumerate(labs):
                f[j * 8:(j + 1) * 8, lab] += 2.0
            fw[f"u{i}"] = f
            aw[f"u{i}"] = np.repeat(labs, 8).astype(np.int32)
            # reference transcripts in output-label space (pdf + 1)
            lines.append(f"u{i} {' '.join(str(p + 1) for p in labs)}")
    (tmp_path / "text").write_text("\n".join(lines) + "\n")


@pytest.mark.slow
def test_launch_two_process_training(tmp_path):
    _make_dataset(tmp_path)
    exp = tmp_path / "exp_mp"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    # each process gets 2 virtual devices -> a 2-process, 4-device DP mesh
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    r = subprocess.run(
        [sys.executable, "-m", "kaldi_ctc_tpu.cli.launch",
         "--num-processes", "2", "--port", "29517", "--",
         sys.executable, "-m", "kaldi_ctc_tpu.cli.train_ctc",
         "--feats", f"ark:{tmp_path}/feats.ark",
         "--ali", f"ark:{tmp_path}/ali.ark",
         "--num-targets", "5", "--hidden-dim", "16", "--num-layers", "1",
         "--epochs", "200", "--minibatch-size", "8",
         "--initial-learning-rate", "3e-2",
         "--final-learning-rate", "3e-3", "--momentum", "0.9",
         "--dir", str(exp), "--checkpoint-period", "1000"],
        env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    # only the primary writes the experiment artifacts
    assert (exp / "model_config.json").exists()
    ckpts = sorted((exp / "checkpoints").iterdir())
    assert ckpts, "no checkpoint written by the primary process"

    # the jointly-trained model decodes the training data correctly
    env2 = dict(os.environ)
    env2["JAX_PLATFORMS"] = "cpu"
    r2 = subprocess.run(
        [sys.executable, "-m", "kaldi_ctc_tpu.cli.decode_ctc",
         "--feats", f"ark:{tmp_path}/feats.ark", "--dir", str(exp),
         "--method", "greedy", "--use-priors", "0",
         "--text", f"{tmp_path}/text"],
        env=env2, capture_output=True, text=True, timeout=300)
    assert r2.returncode == 0, r2.stderr[-3000:]
    result = json.loads(r2.stdout.strip().splitlines()[-1])
    assert result["label_error_rate"] < 0.1, result


@pytest.mark.slow
def test_launch_valid_pipeline_no_desync(tmp_path):
    """--valid-feats with an utterance only the filters drop: the valid
    set must be pre-filtered on the GLOBAL list before sharding, or the
    hosts run different batch counts and the SPMD program deadlocks."""
    _make_dataset(tmp_path)
    rng = np.random.default_rng(1)
    with kaldi_io.MatrixWriter(f"ark:{tmp_path}/vfeats.ark") as fw, \
            kaldi_io.IntVectorWriter(f"ark:{tmp_path}/vali.ark") as aw:
        for i in range(4):
            labs = [1 + i % 3]
            # u_v1 violates max-allow-frames (after the global filter
            # both hosts must agree on the surviving set)
            t = 500 if i == 1 else 8
            f = rng.standard_normal((t, 6)).astype(np.float32) * 0.1
            f[:, labs[0]] += 2.0
            fw[f"uv{i}"] = f
            aw[f"uv{i}"] = np.repeat(labs, t).astype(np.int32)
    exp = tmp_path / "exp_mpv"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    r = subprocess.run(
        [sys.executable, "-m", "kaldi_ctc_tpu.cli.launch",
         "--num-processes", "2", "--",
         sys.executable, "-m", "kaldi_ctc_tpu.cli.train_ctc",
         "--feats", f"ark:{tmp_path}/feats.ark",
         "--ali", f"ark:{tmp_path}/ali.ark",
         "--valid-feats", f"ark:{tmp_path}/vfeats.ark",
         "--valid-ali", f"ark:{tmp_path}/vali.ark",
         "--max-allow-frames", "100",
         "--num-targets", "5", "--hidden-dim", "8", "--num-layers", "1",
         "--epochs", "30", "--minibatch-size", "4",
         "--cv-period", "1",      # valid eval every 10 steps
         "--dir", str(exp), "--checkpoint-period", "1000"],
        env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-3000:])
    # the valid metric was actually logged (the eval ran, didn't hang)
    recs = [json.loads(l) for l in
            (exp / "metrics.jsonl").read_text().splitlines()]
    assert any(x.get("event") == "valid" or x.get("kind") == "valid"
               or x.get("type") == "valid" for x in recs) or \
        any("valid" in json.dumps(x) for x in recs), recs[:5]


def test_resume_skips_trained_batches(tmp_path):
    """A mid-epoch checkpoint resumes at the next batch, not at the
    epoch's beginning (no double-training, no lr-horizon overrun)."""
    from kaldi_ctc_tpu.cli import train_ctc
    _make_dataset(tmp_path, n=16)
    exp = str(tmp_path / "exp_resume")
    common = ["--feats", f"ark:{tmp_path}/feats.ark",
              "--ali", f"ark:{tmp_path}/ali.ark",
              "--num-targets", "5", "--hidden-dim", "8",
              "--num-layers", "1", "--minibatch-size", "8",
              "--dir", exp, "--checkpoint-period", "3"]
    # 16 utts / mb 8 = 2 batches per epoch; 4 epochs = 8 steps total.
    train_ctc.main(common + ["--epochs", "4"])
    import json as _json
    recs = [_json.loads(l) for l in
            (tmp_path / "exp_resume" / "metrics.jsonl")
            .read_text().splitlines()]
    steps = [r["step"] for r in recs if r.get("event") == "train_step"
             or "loss_per_frame" in r]
    assert max(steps) == 8, steps
    # wipe metrics, keep checkpoints; the checkpoint at step 3 is
    # mid-epoch (epoch 1, batch 1 of 2); retention keeps the last ones —
    # roll back to step 3 by deleting later checkpoints, then resume
    import shutil
    ckdir = tmp_path / "exp_resume" / "checkpoints"
    for d in ckdir.iterdir():
        if int(d.name.split("_")[-1]) > 3:
            shutil.rmtree(d)
    (tmp_path / "exp_resume" / "metrics.jsonl").unlink()
    train_ctc.main(common + ["--epochs", "4", "--resume"])
    recs = [_json.loads(l) for l in
            (tmp_path / "exp_resume" / "metrics.jsonl")
            .read_text().splitlines()]
    steps = [r["step"] for r in recs if "loss_per_frame" in r
             and r.get("event") != "valid"]
    # resumed at step 3 (epoch 1 batch 1 consumed): remaining work is
    # exactly 5 steps -> ends at 8, and the first new step is 4
    assert min(steps) == 4 and max(steps) == 8, steps


def test_launch_gives_each_child_its_own_card(tmp_path):
    """Child i sees only the i-th visible GPU, so no two JAX processes
    reserve memory on the same card; too few cards is an error."""
    probe = ("import os; open(os.path.join({d!r}, os.environ['PROCESS_ID']),"
             " 'w').write(os.environ['CUDA_VISIBLE_DEVICES'])")

    def launch(n, visible, out):
        out.mkdir()
        env = {k: v for k, v in os.environ.items()
               if k != "CUDA_VISIBLE_DEVICES"}
        if visible is not None:
            env["CUDA_VISIBLE_DEVICES"] = visible
        r = subprocess.run(
            [sys.executable, "-m", "kaldi_ctc_tpu.cli.launch",
             "--num-processes", str(n), "--", sys.executable, "-c",
             probe.format(d=str(out))],
            env=env, capture_output=True, text=True, timeout=120)
        return r, {p.name: p.read_text() for p in out.iterdir()}

    r, seen = launch(3, None, tmp_path / "all")
    assert r.returncode == 0, r.stderr
    assert seen == {"0": "0", "1": "1", "2": "2"}
    r, seen = launch(2, "4,6", tmp_path / "subset")
    assert r.returncode == 0, r.stderr
    assert seen == {"0": "4", "1": "6"}
    r, seen = launch(3, "4,6", tmp_path / "short")
    assert r.returncode != 0 and not seen
    assert "visible cards" in r.stderr
