"""chip_smoke.py: every phase at a tiny width on the CPU, called directly,
and the script's refusal to run without a GPU or outside a checkout.

On the card the same phases run at the flagship width
(``python chip_smoke.py``); here they check paths, arguments and the
pass/fail logic only.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

SZ = chip_smoke.TINY


@pytest.fixture(scope="module")
def clock():
    return chip_smoke.CompileClock()


@pytest.fixture(scope="module")
def trained(tmp_path_factory, clock):
    """One tiny train phase, shared by the phases that decode its model."""
    work = str(tmp_path_factory.mktemp("smoke"))
    res = chip_smoke.phase_train(work, SZ, clock, jax.devices()[:1])
    return work, res


def test_card_line_and_phase():
    line = chip_smoke.card_line(["echo", "NVIDIA H100 80GB HBM3, 700.00 W"])
    assert line == "NVIDIA H100 80GB HBM3, 700.00 W"
    res = chip_smoke.phase_card(line)
    assert res["name"] == "NVIDIA H100 80GB HBM3"
    assert res["power_limit"] == "700.00 W"
    assert res["platform"] == "cpu"      # the script itself refuses this
    with pytest.raises(RuntimeError):
        chip_smoke.card_line(["echo", "no card"])


def test_train_phase(trained):
    _, res = trained
    blstm, ds2 = res["runs"]
    assert blstm["steps"] == SZ.train_steps and ds2["steps"] == SZ.ds2_steps
    for run in (blstm, ds2):
        assert run["loss_per_frame"][-1] < run["loss_per_frame"][0]
        assert run["compile_s"] > 0
    json.dumps(res)


def test_decode_phase(trained, clock):
    work, _ = trained
    res = chip_smoke.phase_decode(work, SZ, clock)
    for method in ("greedy", "beam", "wfst"):
        assert res[method]["ref_tokens"] == SZ.decode_utts * SZ.labels
    assert res["compute_prob"]["num_utts"] == SZ.decode_utts


def test_serve_phase(tmp_path, clock):
    res = chip_smoke.phase_serve(str(tmp_path), SZ, clock)
    assert res["streams_match_offline"]
    assert len(res["recognize_s"]) == 3
    assert max(res["labels_per_utt"]) > 1     # labels vary across frames


def test_parity_phase(tmp_path, clock):
    res = chip_smoke.phase_parity(str(tmp_path), SZ, clock)
    names = [c["check"] for c in res["checks"]]
    assert names == ["blstm_float32_forward", "blstm_float32_param_grad",
                     "blstm_bfloat16_forward", "blstm_bfloat16_param_grad",
                     "bigru_float32_forward", "bigru_float32_param_grad",
                     "ctc_loss", "ctc_grad", "fbank", "mfcc_hires"]
    assert all(c["ok"] for c in res["checks"])


def test_parity_check_flags_excess_error():
    import numpy as np
    ok = chip_smoke._check("x", np.ones(3) * 1.001, np.ones(3), 1e-2, "")
    bad = chip_smoke._check("x", np.ones(3) * 1.1, np.ones(3), 1e-2, "")
    assert ok["ok"] and not bad["ok"]
    assert abs(bad["max_rel"] - 0.1) < 1e-9


def test_ops_phase(tmp_path, clock):
    res = chip_smoke.phase_ops(str(tmp_path), SZ, clock)
    ops = [r["op"] for r in res["rows"]]
    assert ops == ["blstm_layer_fwd_bwd_bfloat16",
                   "blstm_layer_fwd_bwd_float32", "ctc_loss_and_grad",
                   "fbank"]
    assert all(r["median_ms"] > 0 and r["n"] == SZ.reps
               for r in res["rows"])


def test_four_cards_phase_on_virtual_devices(tmp_path, clock):
    devices = jax.devices()[:4]
    assert len(devices) == 4
    res = chip_smoke.phase_four_cards(str(tmp_path), SZ, clock, devices)
    assert res["multi"]["devices"] == 4 and res["single"]["devices"] == 1
    assert res["global_batch"] == 4 * SZ.batch
    assert res["max_rel_loss_diff"] <= res["tol_rel"]


def _run_script(cwd, env):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_script_fails_without_gpu():
    env = dict(os.environ, PYTHONPATH=REPO)
    r = _run_script(REPO, env)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_script_fails_outside_checkout(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = _run_script(str(tmp_path), env)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
