"""Feature front-end tests.

Strategy mirrors the reference's feat tests (feature-fbank-test.cc etc.):
compare the vectorized XLA implementation against an independent,
deliberately-naive per-frame numpy implementation, plus property checks.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from kaldi_ctc_tpu.features import (
    FbankOptions,
    FrameOptions,
    MfccOptions,
    acc_cmvn_stats,
    add_deltas,
    apply_cmvn,
    compute_fbank,
    compute_mfcc,
    mel_banks,
    splice_frames,
)
from kaldi_ctc_tpu.features.mel import MelOptions, inverse_mel_scale, mel_scale
from kaldi_ctc_tpu.features.mfcc import dct_matrix, lifter_coeffs
from kaldi_ctc_tpu.features.window import feature_window, num_frames

NO_DITHER = FrameOptions(dither=0.0)


def _naive_fbank(wave, opts: FbankOptions):
    """Independent per-frame implementation for parity checking."""
    fo = opts.frame_opts
    assert fo.dither == 0.0
    shift, length, padded = fo.window_shift, fo.window_size, fo.padded_window_size
    window = feature_window(fo).astype(np.float64)
    mel = mel_banks(opts.mel_opts, fo).astype(np.float64)
    nf = 1 + (len(wave) - length) // shift
    out = np.zeros((nf, opts.mel_opts.num_bins))
    for f in range(nf):
        frame = wave[f * shift: f * shift + length].astype(np.float64).copy()
        if fo.remove_dc_offset:
            frame -= frame.mean()
        if fo.preemph_coeff:
            c = fo.preemph_coeff
            for i in range(len(frame) - 1, 0, -1):
                frame[i] -= c * frame[i - 1]
            frame[0] -= c * frame[0]
        frame *= window
        spec = np.fft.rfft(frame, n=padded)
        power = np.abs(spec) ** 2
        m = mel @ power[:-1]
        out[f] = np.log(np.maximum(m, np.finfo(np.float32).eps))
    return out


def test_fbank_matches_naive():
    rng = np.random.default_rng(0)
    wave = (rng.standard_normal(16000) * 1000).astype(np.float32)
    opts = FbankOptions(frame_opts=NO_DITHER)
    got = np.asarray(compute_fbank(jnp.asarray(wave), opts))
    want = _naive_fbank(wave, opts)
    assert got.shape == want.shape == (98, 23)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=5e-3)


def test_fbank_hires_40():
    rng = np.random.default_rng(1)
    wave = (rng.standard_normal(8000) * 1000).astype(np.float32)
    opts = FbankOptions(
        frame_opts=NO_DITHER,
        mel_opts=MelOptions(num_bins=40, low_freq=20.0, high_freq=-400.0))
    got = np.asarray(compute_fbank(jnp.asarray(wave), opts))
    want = _naive_fbank(wave, opts)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=5e-3)


def test_pure_tone_lands_in_right_bin():
    # 1 kHz tone: energy should peak at the mel bin whose center is ~1 kHz
    sr = 16000
    t = np.arange(sr) / sr
    wave = (np.sin(2 * np.pi * 1000 * t) * 10000).astype(np.float32)
    opts = FbankOptions(frame_opts=NO_DITHER)
    feats = np.asarray(compute_fbank(jnp.asarray(wave), opts))
    mean = feats.mean(axis=0)
    peak_bin = int(mean.argmax())
    # compute bin center freqs
    mel_lo = mel_scale(opts.mel_opts.low_freq)
    mel_hi = mel_scale(sr / 2)
    delta = (mel_hi - mel_lo) / (opts.mel_opts.num_bins + 1)
    center = inverse_mel_scale(mel_lo + (peak_bin + 1) * delta)
    assert 800 < center < 1250, center


def test_mfcc_matches_naive_dct_of_fbank():
    rng = np.random.default_rng(2)
    wave = (rng.standard_normal(4800) * 1000).astype(np.float32)
    mopts = MfccOptions(frame_opts=NO_DITHER, use_energy=False)
    got = np.asarray(compute_mfcc(jnp.asarray(wave), mopts))
    fopts = FbankOptions(frame_opts=NO_DITHER,
                         mel_opts=mopts.mel_opts)
    logmel = _naive_fbank(wave, fopts)
    dct = dct_matrix(mopts.num_ceps, mopts.mel_opts.num_bins).astype(np.float64)
    lift = lifter_coeffs(mopts.cepstral_lifter, mopts.num_ceps).astype(np.float64)
    want = (logmel @ dct.T) * lift
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-2)


def test_mfcc_energy_first_coeff():
    rng = np.random.default_rng(3)
    wave = (rng.standard_normal(4800) * 1000).astype(np.float32)
    opts = MfccOptions(frame_opts=NO_DITHER, use_energy=True)
    feats = np.asarray(compute_mfcc(jnp.asarray(wave), opts))
    # c0 replaced by raw log energy — should be large and positive here
    assert feats[:, 0].min() > 5.0


def test_mfcc_hires_dim():
    opts = MfccOptions.hires()
    assert opts.num_ceps == 40 and opts.mel_opts.num_bins == 40
    wave = np.zeros(1600, dtype=np.float32)
    wave[::50] = 1000.0
    feats = compute_mfcc(jnp.asarray(wave),
                         MfccOptions.hires().replace_frame(NO_DITHER)
                         if hasattr(opts, "replace_frame") else
                         MfccOptions(frame_opts=NO_DITHER,
                                     mel_opts=opts.mel_opts,
                                     num_ceps=40, use_energy=False))
    assert feats.shape == (num_frames(1600, NO_DITHER), 40)


def test_num_frames_snip_edges():
    opts = FrameOptions()
    assert num_frames(400, opts) == 1
    assert num_frames(399, opts) == 0
    assert num_frames(560, opts) == 2
    assert num_frames(16000, opts) == 98


def test_dct_matrix_orthogonal():
    d = dct_matrix(23, 23).astype(np.float64)
    np.testing.assert_allclose(d @ d.T, np.eye(23), atol=1e-5)


def test_povey_window_endpoints():
    w = feature_window(FrameOptions())
    assert w.shape == (400,)
    assert abs(w[0]) < 1e-6 and abs(w[-1]) < 1e-6
    assert abs(w[200] - 1.0) < 0.01  # near-peak mid-window


def test_cmvn_roundtrip():
    rng = np.random.default_rng(4)
    feats = rng.standard_normal((100, 13)).astype(np.float32) * 3 + 7
    stats = acc_cmvn_stats(feats)
    normed = np.asarray(apply_cmvn(jnp.asarray(feats), stats, norm_vars=True))
    np.testing.assert_allclose(normed.mean(axis=0), 0.0, atol=1e-4)
    np.testing.assert_allclose(normed.std(axis=0), 1.0, atol=1e-3)


def test_deltas_shape_and_linearity():
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((50, 13)).astype(np.float32)
    out = np.asarray(add_deltas(jnp.asarray(feats)))
    assert out.shape == (50, 39)
    np.testing.assert_allclose(out[:, :13], feats, atol=1e-6)
    # delta of a constant signal is zero
    const = np.ones((20, 4), dtype=np.float32)
    out2 = np.asarray(add_deltas(jnp.asarray(const)))
    np.testing.assert_allclose(out2[:, 4:], 0.0, atol=1e-6)
    # delta of a linear ramp is the slope
    ramp = np.arange(30, dtype=np.float32)[:, None].repeat(2, 1)
    out3 = np.asarray(add_deltas(jnp.asarray(ramp), order=1))
    np.testing.assert_allclose(out3[5:-5, 2:], 1.0, atol=1e-5)


def test_splice_frames():
    feats = np.arange(10, dtype=np.float32)[:, None]
    out = np.asarray(splice_frames(jnp.asarray(feats), 2, 2))
    assert out.shape == (10, 5)
    np.testing.assert_array_equal(out[0], [0, 0, 0, 1, 2])
    np.testing.assert_array_equal(out[5], [3, 4, 5, 6, 7])
    np.testing.assert_array_equal(out[9], [7, 8, 9, 9, 9])


def test_wave_reader_reference_fixture(tmp_path):
    """A seeded 16-bit stereo WAV read back and turned into features."""
    import wave as wavemod

    from kaldi_ctc_tpu.features.wave import read_wave

    rate = 16000
    rng = np.random.default_rng(0)
    pcm = (rng.standard_normal((2, 4000)) * 3000).astype("<i2")
    path = tmp_path / "test.wav"
    with wavemod.open(str(path), "wb") as w:
        w.setnchannels(2); w.setsampwidth(2); w.setframerate(rate)
        w.writeframes(pcm.T.tobytes())
    samples, got_rate = read_wave(str(path))
    assert got_rate == rate and samples.shape == (2, 4000)
    np.testing.assert_array_equal(samples, pcm.astype(samples.dtype))
    # features computable on the audio
    feats = compute_fbank(jnp.asarray(samples[0]),
                          FbankOptions(frame_opts=FrameOptions(
                              dither=0.0, samp_freq=rate)))
    assert feats.shape[0] == num_frames(samples.shape[1],
                                        FrameOptions(samp_freq=rate))
    assert np.isfinite(np.asarray(feats)).all()


def test_compute_cmvn_cli(tmp_path):
    """Per-speaker stats accumulate across utterances; applying them
    zero-means the pooled features."""
    import io, contextlib

    from kaldi_ctc_tpu.cli import compute_cmvn
    from kaldi_ctc_tpu.features.cmvn import apply_cmvn
    from kaldi_ctc_tpu.utils import kaldi_io

    rng = np.random.default_rng(0)
    fark = tmp_path / "f.ark"
    utts = {}
    with kaldi_io.MatrixWriter(f"ark:{fark}") as w:
        for i in range(4):
            m = (rng.standard_normal((10 + i, 3)) + 5).astype(np.float32)
            utts[f"u{i}"] = m
            w[f"u{i}"] = m
    u2s = tmp_path / "utt2spk"
    u2s.write_text("u0 spkA\nu1 spkA\nu2 spkB\nu3 spkB\n")
    out = tmp_path / "cmvn.ark"
    compute_cmvn.main(["--feats", f"ark:{fark}", "--utt2spk", str(u2s),
                       "--out", f"ark,scp:{out},{tmp_path}/cmvn.scp"])
    stats = dict(kaldi_io.SequentialMatrixReader(f"ark:{out}"))
    assert set(stats) == {"spkA", "spkB"}
    assert stats["spkA"][0, -1] == 21  # 10 + 11 frames
    pooled = np.concatenate([utts["u0"], utts["u1"]], axis=0)
    normed = np.concatenate(
        [np.asarray(apply_cmvn(utts["u0"], stats["spkA"])),
         np.asarray(apply_cmvn(utts["u1"], stats["spkA"]))], axis=0)
    np.testing.assert_allclose(normed.mean(axis=0), 0.0, atol=1e-4)


def test_read_wave_pipe(tmp_path):
    """wav.scp pipe entries (cmd |) stream through a shell pipeline."""
    import wave as wavemod

    from kaldi_ctc_tpu.features.wave import read_wave

    rate = 8000
    samples = (1000 * np.sin(np.arange(800) / 10.0)).astype(np.int16)
    wav = tmp_path / "x.wav"
    with wavemod.open(str(wav), "wb") as w:
        w.setnchannels(1); w.setsampwidth(2); w.setframerate(rate)
        w.writeframes(samples.tobytes())
    direct, r1 = read_wave(str(wav))
    piped, r2 = read_wave(f"cat {wav} |")
    assert r1 == r2 == rate
    np.testing.assert_array_equal(direct, piped)


@pytest.mark.parametrize("kind,energy,n_samples", [
    ("fbank", "raw", 400 + 22 * 160 + 97),
    ("fbank", "windowed", 16000 + 59),
    ("mfcc", "raw", 8000 + 131),
])
def test_features_match_reference_ragged_length(kind, energy, n_samples):
    """Sample counts that are no multiple of the frame shift, with the
    energy column computed raw (pre-window) or on windowed frames."""
    from kaldi_ctc_tpu import reference

    rng = np.random.default_rng(n_samples)
    wave = (rng.standard_normal(n_samples) * 1000).astype(np.float32)
    if kind == "fbank":
        opts = FbankOptions(frame_opts=NO_DITHER, use_energy=True,
                            raw_energy=energy == "raw")
        got = np.asarray(compute_fbank(jnp.asarray(wave), opts))
        want = reference.fbank(wave, opts)
    else:
        opts = MfccOptions(frame_opts=NO_DITHER, use_energy=True,
                           raw_energy=energy == "raw")
        got = np.asarray(compute_mfcc(jnp.asarray(wave), opts))
        want = reference.mfcc(wave, opts)
    assert got.shape == want.shape == (num_frames(n_samples, NO_DITHER),
                                       opts.dim)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=5e-3)


def test_vtln_warp_matches_kaldi_formula():
    """VtlnWarpFreq parity: continuous, monotonic, in-range (regression:
    breakpoints were compared in the warped domain)."""
    from kaldi_ctc_tpu.features.mel import _vtln_warp_freq

    def kaldi(vl, vh, lo, hi, warp, f):
        if f < lo or f > hi:
            return f
        l = vl * max(1.0, warp)
        h = vh * min(1.0, warp)
        scale = 1.0 / warp
        Fl, Fh = scale * l, scale * h
        if f < l:
            return lo + (Fl - lo) / (l - lo) * (f - lo)
        if f < h:
            return scale * f
        return hi + (hi - Fh) / (hi - h) * (f - hi)

    for warp in (0.8, 0.9, 1.0, 1.1, 1.25):
        prev = -1.0
        for f in np.linspace(0.0, 8000.0, 801):
            got = _vtln_warp_freq(100, 7500, 20, 8000, warp, float(f))
            want = kaldi(100, 7500, 20, 8000, warp, float(f))
            assert abs(got - want) < 1e-9
            if 20 <= f <= 8000:
                assert 20 - 1e-9 <= got <= 8000 + 1e-9
                assert got >= prev - 1e-9
                prev = got


def test_nonraw_energy_floor_is_eps():
    """Digital silence floors at log(eps) like Kaldi, not log(tiny)."""
    import jax.numpy as jnp
    from kaldi_ctc_tpu.features import FbankOptions, compute_fbank
    from kaldi_ctc_tpu.features.fbank import FrameOptions
    opts = FbankOptions(
        frame_opts=FrameOptions(dither=0.0),
        use_energy=True, raw_energy=False)
    wave = jnp.zeros(4000, jnp.float32)
    feats = np.asarray(compute_fbank(wave, opts))
    # energy is the first column in Kaldi fbank layout
    assert feats[:, 0].min() > -20.0, feats[:, 0].min()


def test_cmvn_rejects_vars_without_means():
    import pytest
    from kaldi_ctc_tpu.features.cmvn import acc_cmvn_stats, apply_cmvn
    x = np.random.default_rng(0).standard_normal((10, 4)).astype(np.float32)
    stats = acc_cmvn_stats(x)
    with pytest.raises(ValueError):
        apply_cmvn(x, stats, norm_means=False, norm_vars=True)
