"""PLP features (reference: src/feat/feature-plp.{h,cc}).

The per-frame chain (PlpComputer::Compute, feature-plp.cc:112-187):
power spectrum → mel filterbank → equal-loudness weighting → power-law
compression (^compress_factor) → duplicate edge bins → inverse DFT to
autocorrelation → Levinson-Durbin LPC → LPC-to-cepstrum → liftering →
scaling → energy/C0 handling.

Formulation: everything up to the autocorrelation is matmuls over
the whole utterance (the IDFT bases fold into one [lpc_order+1,
num_bins+2] matrix); the Durbin recursion is a short
``lax.fori_loop`` over the LPC order (12 iterations) with every frame
vectorized inside each step — the sequential dimension is tiny and
fixed, so XLA unrolls it into a handful of fused vector ops.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from kaldi_ctc_tpu.features.mel import (MelOptions, mel_banks,
                                        mel_center_freqs)
from kaldi_ctc_tpu.features.mfcc import lifter_coeffs
from kaldi_ctc_tpu.features.window import (
    FrameOptions,
    feature_window,
    frame_signal,
    padded_power_spectrum,
    process_frames,
)

__all__ = ["PlpOptions", "compute_plp", "equal_loudness_vector",
           "idft_bases", "durbin_lpc", "lpc_to_cepstrum"]


@dataclasses.dataclass(frozen=True)
class PlpOptions:
    """Mirror of PlpOptions (feature-plp.h:43-96); defaults match the
    reference's (23 mel bins, LPC order 12, 13 cepstra)."""

    frame_opts: FrameOptions = FrameOptions()
    mel_opts: MelOptions = MelOptions(num_bins=23)
    lpc_order: int = 12
    num_ceps: int = 13              # including C0
    use_energy: bool = True
    energy_floor: float = 0.0
    raw_energy: bool = True
    compress_factor: float = 0.33333
    cepstral_lifter: float = 22.0
    cepstral_scale: float = 1.0
    htk_compat: bool = False

    @property
    def dim(self) -> int:
        return self.num_ceps


def equal_loudness_vector(opts: MelOptions, frame_opts: FrameOptions,
                          vtln_warp: float = 1.0) -> np.ndarray:
    """Equal-loudness preemphasis curve over the mel bin center
    frequencies (GetEqualLoudnessVector, mel-computations.cc:313-325)."""
    f0 = mel_center_freqs(opts, frame_opts, vtln_warp).astype(np.float64)
    fsq = f0 * f0
    fsub = fsq / (fsq + 1.6e5)
    return (fsub * fsub * ((fsq + 1.44e6) / (fsq + 9.61e6))).astype(
        np.float32)


def idft_bases(n_bases: int, dimension: int) -> np.ndarray:
    """[n_bases, dimension] inverse-DFT basis matrix (InitIdftBases,
    feature-functions.cc:188-203): row i maps the duplicated compressed
    mel spectrum to autocorrelation coefficient i."""
    angle = math.pi / (dimension - 1)
    scale = 1.0 / (2.0 * (dimension - 1))
    i = np.arange(n_bases, dtype=np.float64)[:, None]
    j = np.arange(dimension, dtype=np.float64)[None, :]
    m = 2.0 * scale * np.cos(angle * i * j)
    m[:, 0] = scale
    m[:, -1] = scale * np.cos(angle * i[:, 0] * (dimension - 1))
    return m.astype(np.float32)


def durbin_lpc(autocorr: jnp.ndarray, order: int):
    """Levinson-Durbin over a batch of frames.

    autocorr: [N, order+1] → (lpc [N, order], residual energy E [N]).
    Mirror of Durbin (mel-computations.cc:269-300) incl. its 1e-5
    floor on (1-k^2); the loop is over the LPC order only, each step
    fully vectorized over frames.
    """
    autocorr = jnp.asarray(autocorr)
    n_frames = autocorr.shape[0]
    lp0 = jnp.zeros((n_frames, order), autocorr.dtype)
    e0 = autocorr[:, 0]

    def step(i, carry):
        lp, e = carry
        # k_i = (r[i+1] + sum_{j<i} lp[j] * r[i-j]) / E
        idx = i - jnp.arange(order)          # r index i-j for j=0..order-1
        r_rev = jnp.where((idx >= 1) & (jnp.arange(order) < i),
                          autocorr[:, jnp.clip(idx, 0, order)], 0.0)
        ki = (autocorr[:, i + 1] + jnp.sum(lp * r_rev, axis=1)) / e
        c = jnp.maximum(1.0 - ki * ki, 1.0e-5)
        e = e * c
        # lp'[j] = lp[j] - k*lp[i-j-1] for j<i;  lp'[i] = -k
        rev_idx = i - jnp.arange(order) - 1
        lp_rev = jnp.where((rev_idx >= 0) & (jnp.arange(order) < i),
                           lp[:, jnp.clip(rev_idx, 0, order - 1)], 0.0)
        new = lp - ki[:, None] * lp_rev
        new = new.at[:, i].set(-ki)
        keep = jnp.arange(order)[None, :] <= i
        lp = jnp.where(keep, new, lp)
        return lp, e

    lp, e = jax.lax.fori_loop(0, order, step, (lp0, e0))
    return lp, e


def lpc_to_cepstrum(lpc: jnp.ndarray) -> jnp.ndarray:
    """[N, order] LPC → [N, order] cepstra (Lpc2Cepstrum,
    mel-computations.cc:302-311): c[i] = -a[i] - 1/(i+1) *
    sum_{j<i} (i-j) a[j] c[i-j-1]; sequential in i, vectorized over
    frames."""
    lpc = jnp.asarray(lpc)
    n_frames, order = lpc.shape
    c0 = jnp.zeros((n_frames, order), lpc.dtype)

    def step(i, cep):
        j = jnp.arange(order)
        back = i - j - 1                     # c index i-j-1 for j<i
        c_rev = jnp.where((back >= 0) & (j < i),
                          cep[:, jnp.clip(back, 0, order - 1)], 0.0)
        w = jnp.where(j < i, (i - j).astype(lpc.dtype), 0.0)
        s = jnp.sum(w[None, :] * lpc * c_rev, axis=1)
        val = -lpc[:, i] - s / (i + 1.0)
        return cep.at[:, i].set(val)

    return jax.lax.fori_loop(0, order, step, c0)


def compute_plp(
    wave: jnp.ndarray,
    opts: PlpOptions = PlpOptions(),
    dither_key: Optional[jax.Array] = None,
    vtln_warp: float = 1.0,
) -> jnp.ndarray:
    """PLPs for one waveform [num_samples] → [num_frames, num_ceps].

    Matches PlpComputer::Compute (feature-plp.cc:112-187)."""
    if opts.num_ceps > opts.lpc_order + 1:
        raise ValueError("num_ceps must be <= lpc_order+1")
    fo = opts.frame_opts
    window = jnp.asarray(feature_window(fo))
    mel = jnp.asarray(mel_banks(opts.mel_opts, fo, vtln_warp=vtln_warp))
    eql = jnp.asarray(equal_loudness_vector(opts.mel_opts, fo, vtln_warp))
    nb = opts.mel_opts.num_bins
    idft = jnp.asarray(idft_bases(opts.lpc_order + 1, nb + 2))
    lift = None
    if opts.cepstral_lifter != 0.0:
        lift = jnp.asarray(
            lifter_coeffs(opts.cepstral_lifter, opts.num_ceps))

    frames = frame_signal(wave, fo)
    need_raw = opts.use_energy and opts.raw_energy
    frames, raw_energy = process_frames(
        frames, fo, window, dither_key=dither_key,
        need_raw_energy=need_raw)
    if opts.use_energy and not opts.raw_energy:
        raw_energy = jnp.log(jnp.maximum(
            jnp.sum(frames * frames, axis=1), jnp.finfo(jnp.float32).eps))
    power = padded_power_spectrum(frames, fo)

    hi = jax.lax.Precision.HIGHEST
    mel_energies = jnp.dot(power[:, :-1], mel.T, precision=hi)
    mel_energies = mel_energies * eql[None, :]
    mel_energies = jnp.power(
        jnp.maximum(mel_energies, jnp.finfo(jnp.float32).tiny),
        opts.compress_factor)
    # duplicate first and last bins (feature-plp.cc:152-155)
    dup = jnp.concatenate(
        [mel_energies[:, :1], mel_energies, mel_energies[:, -1:]], axis=1)
    autocorr = jnp.dot(dup, idft.T, precision=hi)

    lpc, resid_e = durbin_lpc(autocorr, opts.lpc_order)
    # C0 = -log(1/E) = log(E), floored (feature-plp.cc:166-170)
    resid = jnp.log(jnp.maximum(resid_e, jnp.finfo(jnp.float32).tiny))
    cep = lpc_to_cepstrum(lpc)

    feats = jnp.concatenate(
        [resid[:, None], cep[:, :opts.num_ceps - 1]], axis=1)
    if lift is not None:
        feats = feats * lift[None, :]
    if opts.cepstral_scale != 1.0:
        feats = feats * opts.cepstral_scale
    if opts.use_energy:
        energy = raw_energy
        if opts.energy_floor > 0.0:
            energy = jnp.maximum(energy, float(np.log(opts.energy_floor)))
        feats = feats.at[:, 0].set(energy)
    if opts.htk_compat:
        # energy/C0 last (feature-plp.cc:179-187); unlike MFCC there is
        # no sqrt(2) factor — the reference notes "C0 is not the same as
        # HTK's" and moves it verbatim
        feats = jnp.concatenate([feats[:, 1:], feats[:, :1]], axis=1)
    return feats
