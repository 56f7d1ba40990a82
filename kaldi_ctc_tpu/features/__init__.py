"""Kaldi-compatible feature front end, built on XLA.

Replaces the reference's ``src/feat/`` DSP stack (feature-window, mel
banks, fbank, MFCC, CMVN, deltas, splicing) with batched, jittable JAX
code: framing is a static gather, the STFT is XLA's rFFT over a
power-of-two padded window, and the mel filterbank + DCT are dense
matmuls.
"""

from kaldi_ctc_tpu.features.window import (  # noqa: F401
    FrameOptions,
    feature_window,
    frame_signal,
    num_frames,
    process_frames,
)
from kaldi_ctc_tpu.features.fbank import FbankOptions, compute_fbank  # noqa: F401
from kaldi_ctc_tpu.features.mfcc import MfccOptions, compute_mfcc  # noqa: F401
from kaldi_ctc_tpu.features.mel import MelOptions, mel_banks  # noqa: F401
from kaldi_ctc_tpu.features.cmvn import (  # noqa: F401
    acc_cmvn_stats,
    apply_cmvn,
)
from kaldi_ctc_tpu.features.functions import (  # noqa: F401
    add_deltas,
    splice_frames,
)
from kaldi_ctc_tpu.features.wave import read_wave  # noqa: F401
from kaldi_ctc_tpu.features.htk import read_htk, write_htk  # noqa: F401
from kaldi_ctc_tpu.features.plp import PlpOptions, compute_plp  # noqa: F401
from kaldi_ctc_tpu.features.spectrogram import (  # noqa: F401
    SpectrogramOptions,
    compute_spectrogram,
)
from kaldi_ctc_tpu.features.pitch import (  # noqa: F401
    PitchOptions, ProcessPitchOptions, compute_and_process_pitch,
    compute_kaldi_pitch, process_pitch)
