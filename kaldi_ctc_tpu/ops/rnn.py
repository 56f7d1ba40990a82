"""Multi-layer (B)LSTM/GRU/ReLU/Tanh recurrent stacks on ``lax.scan``.

Replacement for the reference's cuDNN RNN surface
(``src/cudamatrix/cudnn-recurrent.h:17-140`` and
``src/nnet2/nnet-cudnn-component.{h,cc}``): same capability set — modes
RELU(0)/TANH(1)/LSTM(2)/GRU(3) matching the reference's rnn-mode integers
(``nnet-cudnn-component.cc:252-259``), multi-layer, bidirectional:

- the input projection ``x @ W_x + b`` for ALL timesteps is hoisted out of
  the recurrence into one large ``[T*B, D] @ [D, G]`` matmul; the scan
  body only does the ``[B, H] @ [H, G]`` recurrent matmul plus the gate
  math — the same factorization cuDNN uses internally, expressed so XLA
  can compile it;
- the backward direction is ``lax.scan(..., reverse=True)`` over the same
  buffers (no explicit sequence reversal copies);
- parameters are plain pytrees (per-layer dicts) so sharding rules can
  target gate/hidden axes directly for model parallelism.

Length handling: unlike the reference, which lets the backward BLSTM pass
consume pad frames (SURVEY §7.3), ``input_lens`` masks the recurrence so
state carries across pad frames and outputs there are zero.  This is a
deliberate correctness improvement; CTC itself is pad-safe either way since
the loss receives true input lengths.

GRU uses the cuDNN "linear-before-reset" formulation (the variant the
reference's cudnn wrapper exposes).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, List, Optional

import jax
import jax.numpy as jnp

__all__ = ["RnnMode", "RnnConfig", "init_rnn_params", "rnn_forward",
           "init_stream_state", "rnn_forward_stream"]


class RnnMode(enum.IntEnum):
    """Matches the reference's rnn-mode config integers."""

    RELU = 0
    TANH = 1
    LSTM = 2
    GRU = 3


_GATES = {RnnMode.RELU: 1, RnnMode.TANH: 1, RnnMode.LSTM: 4, RnnMode.GRU: 3}


@dataclasses.dataclass(frozen=True)
class RnnConfig:
    """Mirror of CuDNNRecurrentComponent's config surface
    (nnet-cudnn-component.cc:72-98,488-491)."""

    input_dim: int
    hidden_dim: int
    num_layers: int = 1
    mode: RnnMode = RnnMode.LSTM
    bidirectional: bool = True  # reference default (nnet-cudnn-component.cc:488)
    param_stddev: float = 0.02
    bias_stddev: float = 0.2
    # matmul compute dtype: "float32" or "bfloat16" (mixed precision —
    # params/state stay f32, matmul operands cast, f32 accumulation)
    compute_dtype: str = "float32"

    @property
    def num_directions(self) -> int:
        return 2 if self.bidirectional else 1

    @property
    def output_dim(self) -> int:
        return self.hidden_dim * self.num_directions

    def layer_input_dim(self, layer: int) -> int:
        return self.input_dim if layer == 0 else self.output_dim


def init_rnn_params(key: jax.Array, cfg: RnnConfig) -> List[Dict[str, Any]]:
    """Random init. Returns params[layer][dir]['w_x'|'w_h'|'b'].

    Layer l, direction d:
      w_x [layer_input_dim, G*H], w_h [H, G*H], b [G*H]
    (the reference keeps one packed flat vector with per-gate Gaussian init,
    nnet-cudnn-component.cc:327-360; a structured pytree is equivalent and
    shardable).
    """
    g = _GATES[cfg.mode]
    params: List[Dict[str, Any]] = []
    for layer in range(cfg.num_layers):
        in_dim = cfg.layer_input_dim(layer)
        dirs = []
        for _ in range(cfg.num_directions):
            key, k1, k2, k3 = jax.random.split(key, 4)
            dirs.append({
                "w_x": cfg.param_stddev * jax.random.normal(
                    k1, (in_dim, g * cfg.hidden_dim), dtype=jnp.float32),
                "w_h": cfg.param_stddev * jax.random.normal(
                    k2, (cfg.hidden_dim, g * cfg.hidden_dim), dtype=jnp.float32),
                "b": cfg.bias_stddev * jax.random.normal(
                    k3, (g * cfg.hidden_dim,), dtype=jnp.float32),
            })
        params.append({"dirs": dirs})
    return params


def _rec_matmul(h, w_h):
    # operands in w_h's dtype, f32 accumulation
    return jnp.dot(h.astype(w_h.dtype), w_h,
                   preferred_element_type=jnp.float32)


def _lstm_cell(h, c, x_proj, w_h):
    gates = x_proj + _rec_matmul(h, w_h)
    i, f, g, o = jnp.split(gates, 4, axis=-1)
    i = jax.nn.sigmoid(i)
    f = jax.nn.sigmoid(f)
    g = jnp.tanh(g)
    o = jax.nn.sigmoid(o)
    c_new = f * c + i * g
    h_new = o * jnp.tanh(c_new)
    return h_new, c_new


def _gru_cell(h, x_proj, w_h):
    # cuDNN linear-before-reset GRU: recurrent projection computed once,
    # reset gate applied to the candidate's recurrent term.
    h_proj = _rec_matmul(h, w_h)
    xr, xz, xn = jnp.split(x_proj, 3, axis=-1)
    hr, hz, hn = jnp.split(h_proj, 3, axis=-1)
    r = jax.nn.sigmoid(xr + hr)
    z = jax.nn.sigmoid(xz + hz)
    n = jnp.tanh(xn + r * hn)
    return (1.0 - z) * n + z * h


def _zero_state(cfg: RnnConfig, batch: int) -> Any:
    h = jnp.zeros((batch, cfg.hidden_dim), jnp.float32)
    return (h, jnp.zeros_like(h)) if cfg.mode == RnnMode.LSTM else h


def _scan_layer(
    x: jnp.ndarray,            # [T, B, D_in]
    lens: jnp.ndarray,         # [B]
    p: Dict[str, Any],
    cfg: RnnConfig,
    init: Any,                 # (h, c) for LSTM, h otherwise
    reverse: bool = False,
) -> tuple:
    """One direction of one layer → (final carry, ys [T, B, H]).

    Frames ``t >= lens[b]`` leave stream b's carry unchanged and output
    zero."""
    t_max, b, _ = x.shape
    mode = cfg.mode
    cd = jnp.bfloat16 if cfg.compute_dtype == "bfloat16" else jnp.float32

    # hoisted input projection: one big matmul over all frames (bf16
    # operands, f32 accumulation in mixed-precision mode; the result is
    # STORED in the compute dtype, so offline and streaming agree)
    x_proj = (jnp.dot(x.reshape(t_max * b, -1).astype(cd),
                      p["w_x"].astype(cd),
                      preferred_element_type=jnp.float32)
              + p["b"]).astype(cd).reshape(t_max, b, -1)
    valid = (jnp.arange(t_max)[:, None] < lens[None, :])[..., None]  # [T,B,1]
    w_h_master = p["w_h"]
    act = jax.nn.relu if mode == RnnMode.RELU else jnp.tanh

    def step(carry, inp):
        xp, v = inp
        # The cast lives inside the step: the scan closes over the f32
        # master w_h, so in bfloat16 mode its cotangent is summed over
        # all T steps in an f32 carry, not a bf16 one.
        w_h = w_h_master.astype(cd)
        if mode == RnnMode.LSTM:
            h, c = carry
            h_new, c_new = _lstm_cell(h, c, xp, w_h)
            h_new = jnp.where(v, h_new, h)
            new = (h_new, jnp.where(v, c_new, c))
        else:
            h = carry
            h_new = (_gru_cell(h, xp, w_h) if mode == RnnMode.GRU
                     else act(xp + _rec_matmul(h, w_h)))
            h_new = jnp.where(v, h_new, h)
            new = h_new
        return new, jnp.where(v, h_new, 0.0)

    final, ys = jax.lax.scan(step, init, (x_proj, valid), reverse=reverse)
    return final, ys.astype(cd)  # layer output in the compute dtype


def rnn_forward(
    params: List[Dict[str, Any]],
    x: jnp.ndarray,
    cfg: RnnConfig,
    input_lens: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """Run the full stack. x: [T, B, input_dim] → [T, B, H*num_directions]."""
    t_max, b, _ = x.shape
    lens = (input_lens if input_lens is not None
            else jnp.full((b,), t_max, dtype=jnp.int32))
    init = _zero_state(cfg, b)
    out = x
    for layer_params in params:
        dirs = layer_params["dirs"]
        _, fwd = _scan_layer(out, lens, dirs[0], cfg, init)
        if cfg.bidirectional:
            _, bwd = _scan_layer(out, lens, dirs[1], cfg, init,
                                 reverse=True)
            out = jnp.concatenate([fwd, bwd], axis=-1)
        else:
            out = fwd
    return out


# ---------------------------------------------------------------------------
# Streaming (state-carrying) forward — unidirectional stacks only
# ---------------------------------------------------------------------------

def init_stream_state(cfg: RnnConfig, batch: int) -> List[Any]:
    """Zero carry state per layer: (h, c) for LSTM, h otherwise."""
    if cfg.bidirectional:
        raise ValueError("streaming requires a unidirectional stack")
    return [_zero_state(cfg, batch) for _ in range(cfg.num_layers)]


def rnn_forward_stream(
    params: List[Dict[str, Any]],
    x: jnp.ndarray,                 # [T, B, input_dim] (one chunk)
    cfg: RnnConfig,
    states: List[Any],
    lens: Optional[jnp.ndarray] = None,   # [B] valid frames this chunk
) -> tuple:
    """Chunked forward with explicit carry — the online-decoding analogue
    of the reference's AdvanceDecoding-style incremental processing
    (decoder/lattice-faster-online-decoder.h): feeding chunks with the
    carried state is exactly equivalent to one full-utterance forward.

    With `lens`, frames >= lens[b] neither update stream b's state nor
    produce output (batched serving: slots with short final chunks).

    → (y [T, B, H], new_states)."""
    if cfg.bidirectional:
        raise ValueError("streaming requires a unidirectional stack")
    t_max, b, _ = x.shape
    if lens is None:
        lens = jnp.full((b,), t_max, dtype=jnp.int32)
    out = x
    new_states: List[Any] = []
    for layer_params, st in zip(params, states):
        st_new, out = _scan_layer(out, lens, layer_params["dirs"][0], cfg,
                                  st)
        new_states.append(st_new)
    return out, new_states
