"""Batched CTC prefix beam search, fully vectorized on device.

The LM-free decoder between greedy best-path and the WFST TLG decoder.
Everything is static-shape: the beam state is dense arrays, per-frame
candidate generation is a (beam × top-K) expansion, and duplicate-prefix
merging is an O(P²) masked logsumexp over the candidate pool (P ≤ ~200,
trivially cheap elementwise work that avoids data-dependent control flow).

State per (batch, beam): prefix history [Lmax], length, rolling hash,
p_blank / p_nonblank log-probabilities (the classic two-track bookkeeping).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

__all__ = ["prefix_beam_search"]

_NEG_INF = -1e30
_HASH_MULT = jnp.uint32(1000003)
_HASH_MULT2 = jnp.uint32(2654435761)  # independent channel: 64-bit key


def _logaddexp(a, b):
    return jnp.logaddexp(a, b)


@functools.partial(jax.jit, static_argnames=("beam", "prune_k", "max_len",
                                             "blank"))
def prefix_beam_search(
    log_probs: jnp.ndarray,     # [B, T, A] log posteriors (or scaled scores)
    input_lens: jnp.ndarray,    # [B]
    beam: int = 8,
    prune_k: int = 8,
    max_len: int = 0,           # max output labels; 0 → T
    blank: int = 0,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Decode → (labels [B, Lmax], lengths [B], scores [B]).

    Returns the best prefix per utterance with its total log-probability.
    """
    b, t_max, a = log_probs.shape
    l_max = max_len if max_len > 0 else t_max
    w = beam
    k = min(prune_k, a - 1)

    # beam state
    prefixes = jnp.zeros((b, w, l_max), jnp.int32)
    plen = jnp.zeros((b, w), jnp.int32)
    last = jnp.full((b, w), -1, jnp.int32)
    hashes = jnp.zeros((b, w), jnp.uint32)
    hashes2 = jnp.zeros((b, w), jnp.uint32)
    p_b = jnp.full((b, w), _NEG_INF).at[:, 0].set(0.0)
    p_nb = jnp.full((b, w), _NEG_INF)

    def step(state, inputs):
        prefixes, plen, last, hashes, hashes2, p_b, p_nb = state
        lp_t, t = inputs  # [B, A], scalar

        # top-k non-blank tokens per batch element
        lp_noblank = lp_t.at[:, blank].set(_NEG_INF)
        topk_lp, topk_id = jax.lax.top_k(lp_noblank, k)  # [B, K]

        total = _logaddexp(p_b, p_nb)  # [B, W]

        # candidate 0 (per beam): keep prefix.
        #   new p_b: any path + blank emission
        #   new p_nb: repeat last label (from p_nb only)
        lp_blank = lp_t[:, blank][:, None]
        keep_pb = total + lp_blank
        lp_last = jnp.take_along_axis(
            lp_t, jnp.maximum(last, 0), axis=1)  # [B, W]
        keep_pnb = jnp.where(last >= 0, p_nb + lp_last, _NEG_INF)

        # candidates 1..K (per beam): extend with token topk_id[k].
        # If token == last: only from p_b (repeat across blank);
        # else from p_b and p_nb.
        tok = topk_id[:, None, :]                      # [B, 1, K]
        tok_lp = topk_lp[:, None, :]                   # [B, 1, K]
        same_as_last = tok == last[:, :, None]         # [B, W, K]
        src = jnp.where(same_as_last, p_b[:, :, None],
                        total[:, :, None])
        ext_pnb = src + tok_lp                          # [B, W, K]
        can_extend = plen[:, :, None] < l_max
        ext_pnb = jnp.where(can_extend, ext_pnb, _NEG_INF)

        # pool: W keep-candidates + W*K extend-candidates
        pool = w * (1 + k)
        pool_pb = jnp.concatenate(
            [keep_pb, jnp.full((b, w * k), _NEG_INF)], axis=1)
        pool_pnb = jnp.concatenate(
            [keep_pnb, ext_pnb.reshape(b, w * k)], axis=1)

        # bookkeeping for each pool entry: source beam, appended token
        src_beam = jnp.concatenate([
            jnp.arange(w)[None, :].repeat(b, 0),
            jnp.arange(w)[None, :, None].repeat(k, 2).reshape(1, -1)
            .repeat(b, 0)], axis=1)                     # [B, P]
        app_tok = jnp.concatenate([
            jnp.full((b, w), -1, jnp.int32),
            tok.repeat(w, 1).reshape(b, w * k)], axis=1)  # [B, P]

        new_len = jnp.take_along_axis(plen, src_beam, 1) + (app_tok >= 0)
        src_hash = jnp.take_along_axis(hashes, src_beam, 1)
        new_hash = jnp.where(
            app_tok >= 0,
            src_hash * _HASH_MULT + app_tok.astype(jnp.uint32) + jnp.uint32(1),
            src_hash)
        src_hash2 = jnp.take_along_axis(hashes2, src_beam, 1)
        new_hash2 = jnp.where(
            app_tok >= 0,
            src_hash2 * _HASH_MULT2 + app_tok.astype(jnp.uint32)
            + jnp.uint32(1),
            src_hash2)
        new_last = jnp.where(app_tok >= 0, app_tok,
                             jnp.take_along_axis(last, src_beam, 1))

        # merge duplicate prefixes: same (hash64, len, last) → same
        # prefix (two independent 32-bit rolling hashes make collisions
        # ~2^-64 — negligible even over very long streams)
        key = (new_hash, new_hash2, new_len, new_last)
        eq = ((key[0][:, :, None] == key[0][:, None, :])
              & (key[1][:, :, None] == key[1][:, None, :])
              & (key[2][:, :, None] == key[2][:, None, :])
              & (key[3][:, :, None] == key[3][:, None, :]))   # [B, P, P]

        def seg_lse(scores):
            # logsumexp of scores over each equality class
            m = jnp.max(jnp.where(eq, scores[:, None, :], _NEG_INF), axis=2)
            s = jnp.sum(jnp.where(eq, jnp.exp(scores[:, None, :]
                                              - m[:, :, None]), 0.0), axis=2)
            return m + jnp.log(jnp.maximum(s, 1e-37))

        # representative = first pool index in each class; non-representative
        # entries must carry no mass or top-k could select duplicates that
        # double-count on later frames
        idx = jnp.arange(pool)[None, :]
        first_in_class = jnp.min(
            jnp.where(eq, idx[:, None, :], pool), axis=2) == idx
        merged_pb = jnp.where(first_in_class, seg_lse(pool_pb), _NEG_INF)
        merged_pnb = jnp.where(first_in_class, seg_lse(pool_pnb), _NEG_INF)
        merged_total = _logaddexp(merged_pb, merged_pnb)

        # top-W beams from the pool
        top_score, top_idx = jax.lax.top_k(merged_total, w)   # [B, W]
        sel = lambda x: jnp.take_along_axis(x, top_idx, 1)
        nb_src = sel(src_beam)
        nb_tok = sel(app_tok)
        new_p_b = sel(merged_pb)
        new_p_nb = sel(merged_pnb)
        nb_len = sel(new_len)
        nb_hash = sel(new_hash)
        nb_hash2 = sel(new_hash2)
        nb_last = sel(new_last)

        # rebuild prefixes: gather source rows, append token where present
        gathered = jnp.take_along_axis(
            prefixes, nb_src[:, :, None], axis=1)             # [B, W, L]
        src_len = jnp.take_along_axis(plen, nb_src, 1)
        pos_mask = (jnp.arange(l_max)[None, None, :]
                    == src_len[:, :, None]) & (nb_tok[:, :, None] >= 0)
        new_prefixes = jnp.where(pos_mask, jnp.maximum(nb_tok, 0)[:, :, None],
                                 gathered)

        # frames past input_len leave everything unchanged
        active = (t < input_lens)[:, None]
        out = (
            jnp.where(active[:, :, None], new_prefixes, prefixes),
            jnp.where(active, nb_len, plen),
            jnp.where(active, nb_last, last),
            jnp.where(active, nb_hash, hashes),
            jnp.where(active, nb_hash2, hashes2),
            jnp.where(active, new_p_b, p_b),
            jnp.where(active, new_p_nb, p_nb),
        )
        return out, None

    lp_seq = jnp.moveaxis(log_probs, 1, 0)  # [T, B, A]
    ts = jnp.arange(t_max)
    (prefixes, plen, last, hashes, hashes2, p_b, p_nb), _ = jax.lax.scan(
        step, (prefixes, plen, last, hashes, hashes2, p_b, p_nb),
        (lp_seq, ts))

    final = _logaddexp(p_b, p_nb)  # [B, W]
    best = jnp.argmax(final, axis=1)  # [B]
    take = lambda x: jnp.take_along_axis(
        x, best[:, None, None] if x.ndim == 3 else best[:, None], 1).squeeze(1)
    return (take(prefixes), take(plen),
            jnp.take_along_axis(final, best[:, None], 1)[:, 0])
