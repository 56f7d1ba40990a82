"""Acoustic score preparation for decoding.

Replaces CtcDecodableAmNnet (``ctc/ctc-decodable-am-nnet.cc:29-87``):
softmax posteriors → (blank-threshold frame handling) → floor+log →
divide by priors → acoustic scale.  Priors default to ones with
prior[blank] = 9 (``ctcbin/nnet2-ctc-init-model.cc:64-67``).

Blank handling deviates deliberately from the reference: the reference
*drops* frames whose blank posterior exceeds the threshold (a dynamic-
shape operation); here we *force* such frames to pure blank
(log-prob 0 for blank, -inf otherwise), which is equivalent for
best-path/beam decoding up to repeat-merging at skip boundaries and keeps
shapes static.  `blank_frame_mask` is returned so host-side (WFST)
decoders can drop the frames exactly like the reference.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["acoustic_scores"]


def acoustic_scores(
    logits: jnp.ndarray,               # [B, T, A]
    priors: Optional[np.ndarray] = None,
    acoustic_scale: float = 1.0,
    blank_threshold: float = 0.98,     # run_ctc_phone.sh:38
    blank: int = 0,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Return (scores [B, T, A], skip_mask [B, T]).

    scores = acoustic_scale * (log posterior - log prior), with
    high-confidence blank frames forced to one-hot blank.
    skip_mask[b, t] True where the reference would drop the frame.
    """
    post = jax.nn.softmax(logits, axis=-1)
    skip = post[..., blank] >= blank_threshold if blank_threshold < 1.0 else (
        jnp.zeros(post.shape[:2], bool))
    floor = jnp.finfo(jnp.float32).tiny
    log_post = jnp.log(jnp.maximum(post, floor))
    if priors is not None:
        log_post = log_post - jnp.log(jnp.asarray(priors, jnp.float32))[None, None, :]
    scores = acoustic_scale * log_post
    # force skipped frames to pure blank
    a = logits.shape[-1]
    one_hot_blank = jnp.where(jnp.arange(a) == blank, 0.0, -1e30)
    scores = jnp.where(skip[..., None], one_hot_blank[None, None, :], scores)
    return scores, skip
