"""Log mel filterbank features (reference: src/feat/feature-fbank.{h,cc}).

One utterance → one fused XLA computation: gather-frame → vectorized window
processing → rFFT power spectrum → dense mel matmul → log.  The mel matrix
and window table are host-side constants closed over by the jitted function.
"""

from __future__ import annotations

import dataclasses
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

__all__ = ["FbankOptions", "compute_fbank"]


@dataclasses.dataclass(frozen=True)
class FbankOptions:
    """Mirror of FbankOptions (feature-fbank.h:39-91)."""

    frame_opts: FrameOptions = FrameOptions()
    mel_opts: MelOptions = MelOptions()
    use_energy: bool = False
    energy_floor: float = 0.0
    raw_energy: bool = True
    use_log_fbank: bool = True
    use_power: bool = True
    htk_compat: bool = False  # energy last, not first (feature-fbank.h:47)

    @property
    def dim(self) -> int:
        return self.mel_opts.num_bins + (1 if self.use_energy else 0)


def compute_fbank(
    wave: jnp.ndarray,
    opts: FbankOptions = FbankOptions(),
    dither_key: Optional[jax.Array] = None,
    vtln_warp: float = 1.0,
) -> jnp.ndarray:
    """Fbank features for one waveform [num_samples] → [num_frames, dim].

    Matches FbankComputer::Compute (feature-fbank.cc:72-126) with
    dither disabled unless a PRNG key is supplied.
    """
    fo = opts.frame_opts
    window = jnp.asarray(feature_window(fo))
    mel = jnp.asarray(mel_banks(opts.mel_opts, fo, vtln_warp=vtln_warp))
    frames = frame_signal(wave, fo)
    need_raw = opts.use_energy and opts.raw_energy
    frames, raw_energy = process_frames(
        frames, fo, window, dither_key=dither_key, need_raw_energy=need_raw)
    power = padded_power_spectrum(frames, fo)
    if opts.use_energy and not opts.raw_energy:
        # Kaldi floors energy at float epsilon, not denormal-min
        eps = jnp.finfo(jnp.float32).eps
        raw_energy = jnp.log(
            jnp.maximum(jnp.sum(frames * frames, axis=1), eps))
    if not opts.use_power:
        power = jnp.sqrt(power)
    # bins are defined over fft bins [0, padded/2); drop the Nyquist bin
    mel_energies = jnp.dot(power[:, :-1], mel.T,
                           precision=jax.lax.Precision.HIGHEST)
    if opts.mel_opts.htk_mode:
        # HTK-like flooring (mel-computations.cc:238)
        mel_energies = jnp.maximum(mel_energies, 1.0)
    if opts.use_log_fbank:
        eps = jnp.finfo(jnp.float32).eps
        mel_energies = jnp.log(jnp.maximum(mel_energies, eps))
    if opts.use_energy:
        energy = raw_energy
        if opts.energy_floor > 0.0:
            energy = jnp.maximum(energy, float(np.log(opts.energy_floor)))
        return _with_energy(mel_energies, energy, opts)
    return mel_energies


def _with_energy(mel_energies, energy, opts: FbankOptions):
    """Energy column first (Kaldi) or last (htk_compat),
    feature-fbank.cc:102-121."""
    if opts.htk_compat:
        return jnp.concatenate([mel_energies, energy[:, None]], axis=1)
    return jnp.concatenate([energy[:, None], mel_energies], axis=1)
