"""kaldi_ctc_tpu — a CTC ASR framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the kaldi-ctc
reference stack (Kaldi + warp-ctc + cuDNN RNN CTC training and WFST
decoding):

- ``features``: Kaldi-compatible fbank/MFCC/CMVN front end (XLA rFFT).
- ``ops``: CTC alpha-beta loss and multi-layer (B)LSTM/GRU/ReLU/Tanh
  recurrent stacks, both on ``lax.scan``.
- ``models``: the acoustic-model pytree (recurrent stack + projections +
  priors + transition-model-lite), replacing nnet2's Component/AmNnet.
- ``training``: jit-compiled train step (fwd + CTC + bwd + clip + SGD),
  data-parallel over a ``jax.sharding.Mesh``, lr schedules, diagnostics.
- ``data``: egs pipeline — Kaldi ark/scp readers, length bucketing,
  frame subsampling/shift augmentation, host prefetch.
- ``decoding``: greedy best-path and batched CTC prefix beam search.
- ``parallel``: mesh/device management and sharding rules.
"""

__version__ = "0.1.0"

import os as _os

# Persistent XLA compilation cache.  Recipe stages are separate OS
# processes (the reference's per-binary process model, SURVEY §1), so
# without it every stage re-pays full compilation.  JAX_COMPILATION_CACHE_DIR,
# when set, is JAX's own setting and is left alone; otherwise the cache
# lives at one fixed path inside the checkout, shared by every process
# that runs from it.
CHECKOUT_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")

if "JAX_COMPILATION_CACHE_DIR" not in _os.environ:
    import jax as _jax

    _jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)
