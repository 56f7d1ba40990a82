"""MFCC features (reference: src/feat/feature-mfcc.{h,cc}).

DCT + liftering fold into a single precomputed [num_ceps, num_bins] matrix
applied as one matmul after the log-mel stage — the whole utterance's MFCCs
are two matmuls and an FFT.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from kaldi_ctc_tpu.features.mel import MelOptions, mel_banks
from kaldi_ctc_tpu.features.window import (
    FrameOptions,
    feature_window,
    frame_signal,
    padded_power_spectrum,
    process_frames,
)

__all__ = ["MfccOptions", "compute_mfcc", "dct_matrix", "lifter_coeffs"]


@dataclasses.dataclass(frozen=True)
class MfccOptions:
    """Mirror of MfccOptions (feature-mfcc.h:38-84)."""

    frame_opts: FrameOptions = FrameOptions()
    mel_opts: MelOptions = MelOptions()
    num_ceps: int = 13
    use_energy: bool = True
    energy_floor: float = 0.0
    raw_energy: bool = True
    cepstral_lifter: float = 22.0
    # HTK output order: [c1..c{n-1}, c0_or_energy]; C0 scaled by sqrt(2)
    # when use_energy=False (feature-mfcc.h:47-49, .cc:70-79).
    htk_compat: bool = False

    @property
    def dim(self) -> int:
        return self.num_ceps

    @staticmethod
    def hires() -> "MfccOptions":
        """The librispeech hires config (conf/mfcc_hires.conf)."""
        return MfccOptions(
            mel_opts=MelOptions(num_bins=40, low_freq=20.0, high_freq=-400.0),
            num_ceps=40,
            use_energy=False,
        )


def dct_matrix(num_ceps: int, num_bins: int) -> np.ndarray:
    """Normalized type-II DCT matrix (matrix-functions.cc ComputeDctMatrix)."""
    m = np.zeros((num_ceps, num_bins), dtype=np.float64)
    m[0, :] = math.sqrt(1.0 / num_bins)
    n = np.arange(num_bins, dtype=np.float64)
    for k in range(1, num_ceps):
        m[k, :] = math.sqrt(2.0 / num_bins) * np.cos(
            math.pi / num_bins * (n + 0.5) * k)
    return m.astype(np.float32)


def lifter_coeffs(q: float, num_ceps: int) -> np.ndarray:
    """Cepstral liftering coefficients (mel-computations.cc ComputeLifterCoeffs)."""
    i = np.arange(num_ceps, dtype=np.float64)
    return (1.0 + 0.5 * q * np.sin(math.pi * i / q)).astype(np.float32)


def compute_mfcc(
    wave: jnp.ndarray,
    opts: MfccOptions = MfccOptions(),
    dither_key: Optional[jax.Array] = None,
    vtln_warp: float = 1.0,
) -> jnp.ndarray:
    """MFCCs for one waveform [num_samples] → [num_frames, num_ceps].

    Matches MfccComputer::Compute (feature-mfcc.cc:32-85).
    """
    fo = opts.frame_opts
    window = jnp.asarray(feature_window(fo))
    mel = jnp.asarray(mel_banks(opts.mel_opts, fo, vtln_warp=vtln_warp))
    dct = dct_matrix(opts.num_ceps, opts.mel_opts.num_bins)
    if opts.cepstral_lifter != 0.0:
        dct = dct * lifter_coeffs(opts.cepstral_lifter, opts.num_ceps)[:, None]
    dct = jnp.asarray(dct)

    frames = frame_signal(wave, fo)
    need_raw = opts.use_energy and opts.raw_energy
    frames, raw_energy = process_frames(
        frames, fo, window, dither_key=dither_key, need_raw_energy=need_raw)
    power = padded_power_spectrum(frames, fo)
    if opts.use_energy and not opts.raw_energy:
        # Kaldi floors energy at float epsilon, not denormal-min
        raw_energy = jnp.log(jnp.maximum(
            jnp.sum(frames * frames, axis=1), jnp.finfo(jnp.float32).eps))
    eps = jnp.finfo(jnp.float32).eps
    # full-precision matmuls: a reduced-precision default (bf16 passes,
    # TF32) visibly quantizes log-mel values
    hi = jax.lax.Precision.HIGHEST
    mel_energies = jnp.dot(power[:, :-1], mel.T, precision=hi)
    if opts.mel_opts.htk_mode:
        # HTK-like flooring (mel-computations.cc:238)
        mel_energies = jnp.maximum(mel_energies, 1.0)
    log_mel = jnp.log(jnp.maximum(mel_energies, eps))
    feats = jnp.dot(log_mel, dct.T, precision=hi)
    if opts.use_energy:
        energy = raw_energy
        if opts.energy_floor > 0.0:
            energy = jnp.maximum(energy, float(np.log(opts.energy_floor)))
        feats = feats.at[:, 0].set(energy)
    return _htk_reorder(feats, opts)


def _htk_reorder(feats: jnp.ndarray, opts: MfccOptions) -> jnp.ndarray:
    """htk_compat output order (feature-mfcc.cc:70-79): rotate c0/energy to
    the last column; scale C0 by sqrt(2) when it is a cepstrum (removes the
    1/sqrt(2) the normalized DCT put on row 0)."""
    if not opts.htk_compat:
        return feats
    first = feats[:, :1]
    if not opts.use_energy:
        first = first * math.sqrt(2.0)
    return jnp.concatenate([feats[:, 1:], first], axis=1)
