"""Golden feature parity against the reference's stored HTK fixtures.

Replicates feat/feature-mfcc-test.cc:41-124 (UnitTestReadWave +
UnitTestHTKCompare1-6) and feature-fbank-test.cc (UnitTestHTKCompare1-4):
the features computed here are compared against HCopy outputs shipped in
/root/reference/src/feat/test_data (read in place, never copied).  This is
the independent-oracle check the round-1 self-parity tests could not give:
a systematic spec misreading shared by our XLA path and our naive-numpy
reference would still fail here.
"""

import os

import numpy as np
import pytest

from kaldi_ctc_tpu.features import (
    FbankOptions,
    FrameOptions,
    MelOptions,
    MfccOptions,
    add_deltas,
    compute_fbank,
    compute_mfcc,
    read_htk,
    read_wave,
)

REF = "/root/reference/src/feat/test_data"

pytestmark = pytest.mark.skipif(
    not os.path.isdir(REF), reason="reference test_data not available")


def _waveform():
    samples, rate = read_wave(os.path.join(REF, "test.wav"))
    assert rate == 16000.0
    assert samples.shape[0] == 1
    return samples[0]


def test_wave_matches_matlab_ascii():
    """UnitTestReadWave: our RIFF reader must agree sample-exactly with the
    matlab-prepared ascii dump (feature-mfcc-test.cc:31-70)."""
    wave = _waveform()
    with open(os.path.join(REF, "test_matlab.ascii")) as f:
        text = f.read().strip()
    assert text.startswith("[") and text.endswith("]")
    ref = np.array(text[1:-1].split(), dtype=np.float32)
    assert wave.shape == ref.shape
    np.testing.assert_array_equal(wave, ref)


# frame options shared by every HTK golden (dither off, offsets kept,
# hamming window) — each case overrides preemphasis
def _htk_frame_opts(preemph):
    return FrameOptions(dither=0.0, preemph_coeff=preemph,
                        window_type="hamming", remove_dc_offset=False,
                        round_to_power_of_two=True)


# (golden file, MfccOptions, vtln_warp) replicating UnitTestHTKCompare1-6
MFCC_CASES = {
    1: (MfccOptions(frame_opts=_htk_frame_opts(0.0),
                    mel_opts=MelOptions(low_freq=0.0, htk_mode=True),
                    htk_compat=True, use_energy=False), 1.0),
    2: (MfccOptions(frame_opts=_htk_frame_opts(0.0),
                    mel_opts=MelOptions(low_freq=0.0, htk_mode=True),
                    htk_compat=True, use_energy=True), 1.0),
    3: (MfccOptions(frame_opts=_htk_frame_opts(0.0),
                    mel_opts=MelOptions(low_freq=20.0, htk_mode=True),
                    htk_compat=True, use_energy=True), 1.0),
    4: (MfccOptions(frame_opts=_htk_frame_opts(0.97),
                    mel_opts=MelOptions(low_freq=0.0, htk_mode=True),
                    htk_compat=True, use_energy=True), 1.0),
    5: (MfccOptions(frame_opts=_htk_frame_opts(0.97),
                    mel_opts=MelOptions(low_freq=0.0, vtln_low=100.0,
                                        vtln_high=7500.0, htk_mode=True),
                    htk_compat=True, use_energy=True), 1.1),
    6: (MfccOptions(frame_opts=_htk_frame_opts(0.97),
                    mel_opts=MelOptions(num_bins=24, low_freq=125.0,
                                        high_freq=7800.0),
                    htk_compat=True, use_energy=False), 1.0),
}


@pytest.mark.parametrize("case", sorted(MFCC_CASES))
def test_mfcc_htk_golden(case):
    """UnitTestHTKCompare{1-6}: MFCC+deltas vs test.wav.fea_htk.N, |diff|<=1
    over interior rows (the reference's stated tolerance, which covers the
    delta end-effect differences)."""
    opts, warp = MFCC_CASES[case]
    htk, hdr = read_htk(os.path.join(REF, f"test.wav.fea_htk.{case}"))
    wave = _waveform()
    raw = np.asarray(compute_mfcc(wave, opts, vtln_warp=warp))
    feats = np.asarray(add_deltas(raw, order=2, window=2))
    assert feats.shape == htk.shape
    diff = np.abs(feats[10:-10] - htk[10:-10])
    assert diff.max() <= 1.0, f"max diff {diff.max()} at " \
        f"{np.unravel_index(diff.argmax(), diff.shape)}"


# (options, vtln_warp, tolerance): tolerances are the reference's own —
# 0.001 unwarped, 0.01 for warp 1.1 (its VTLN function intentionally
# differs from HTK's, feature-fbank-test.cc:412 uses 0.01 there)
FBANK_CASES = {
    1: (FbankOptions(frame_opts=_htk_frame_opts(0.0),
                     mel_opts=MelOptions(low_freq=0.0, htk_mode=True),
                     htk_compat=True, use_energy=False), 1.0, 0.001),
    2: (FbankOptions(frame_opts=_htk_frame_opts(0.0),
                     mel_opts=MelOptions(low_freq=25.0, htk_mode=True),
                     htk_compat=True, use_energy=False), 1.0, 0.001),
    3: (FbankOptions(frame_opts=_htk_frame_opts(0.0),
                     mel_opts=MelOptions(low_freq=25.0, vtln_low=100.0,
                                         vtln_high=7500.0, htk_mode=True),
                     htk_compat=True, use_energy=False), 0.9, 0.001),
    4: (FbankOptions(frame_opts=_htk_frame_opts(0.0),
                     mel_opts=MelOptions(low_freq=25.0, vtln_low=100.0,
                                         vtln_high=7500.0, htk_mode=True),
                     htk_compat=True, use_energy=False), 1.1, 0.01),
}


@pytest.mark.parametrize("case", sorted(FBANK_CASES))
def test_fbank_htk_golden(case):
    """feature-fbank-test.cc UnitTestHTKCompare{1-4}: |diff|<=0.001 over
    interior rows; the warp-0.9 case only enforces columns < 20 (the
    reference lets the highest bins slide, its VTLN differs from HTK's
    there)."""
    opts, warp, tol = FBANK_CASES[case]
    htk, hdr = read_htk(os.path.join(REF, f"test.wav.fbank_htk.{case}"))
    wave = _waveform()
    feats = np.asarray(compute_fbank(wave, opts, vtln_warp=warp))
    assert feats.shape == htk.shape
    diff = np.abs(feats[10:-10] - htk[10:-10])
    if warp < 1.0:
        diff = diff[:, :20]
    assert diff.max() <= tol, f"max diff {diff.max()} at " \
        f"{np.unravel_index(diff.argmax(), diff.shape)}"


def test_htk_roundtrip(tmp_path):
    from kaldi_ctc_tpu.features.htk import write_htk
    m = np.random.default_rng(0).standard_normal((7, 5)).astype(np.float32)
    p = str(tmp_path / "x.htk")
    write_htk(p, m, sample_period=100000, parm_kind=9)
    back, hdr = read_htk(p)
    np.testing.assert_array_equal(m, back)
    assert hdr.num_samples == 7 and hdr.sample_size == 20
