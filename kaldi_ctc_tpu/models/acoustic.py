"""The CTC acoustic model: recurrent stack + output projection + priors.

Replaces the reference's nnet2 model layer for the 'google' CTC config
(``make_configs.py:237-365``: stacked CuDNNRecurrentComponents → affine to
num_targets → softmax appended at prior-adjustment time) and the AmNnet
prior carrier (``nnet2/am-nnet.h:38-67``).  Output index 0 is the blank
(CtcTransitionModel's +1 shift, ``ctc/ctc-transition-model.h:56-62``);
priors default to ones with prior[blank]=9
(``ctcbin/nnet2-ctc-init-model.cc:64-67``).

Parameters are a plain pytree so sharding rules (parallel/mesh.py) can
annotate the gate/hidden axes for tensor parallelism.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from kaldi_ctc_tpu.ops.rnn import RnnConfig, RnnMode, init_rnn_params, rnn_forward

__all__ = ["AmConfig", "init_am_params", "am_forward", "default_priors"]


@dataclasses.dataclass(frozen=True)
class AmConfig:
    """Model config (the dataclass replacement for make_configs.py output)."""

    input_dim: int
    num_targets: int  # pdfs + 1 blank; blank = index 0
    hidden_dim: int = 320
    num_layers: int = 5
    mode: RnnMode = RnnMode.LSTM
    bidirectional: bool = True
    param_stddev: float = 0.02
    bias_stddev: float = 0.2
    dropout: float = 0.0
    # matmul compute dtype: "float32" or "bfloat16" (mixed precision)
    compute_dtype: str = "float32"
    # input splicing (nnet2 SpliceComponent, edge-clamped): frames
    # [-splice_left .. +splice_right] concatenated per step
    splice_left: int = 0
    splice_right: int = 0
    # the 'FT' model type (make_configs.py:269-279): an Affine + ReLU +
    # renormalize front layer of this width before the RNN stack
    # (AddAffRelNormLayer); 0 = 'google' (RNN-first)
    front_affine_dim: int = 0
    # front-layer nonlinearity — the nnet2 nonlinear component family
    # (nnet2/nnet-component.h): "relu" (RectifiedLinearComponent, the
    # AddAffRelNormLayer default), "tanh" (TanhComponent), "sigmoid"
    # (SigmoidComponent), "pnorm" (PnormComponent, p=2 over
    # `front_group`-sized groups — Kaldi's Affine+Pnorm+Normalize
    # idiom), "maxout" (MaxoutComponent, max over groups).  The RMS
    # renormalize (NormalizeComponent) always follows, as in the
    # reference's relu and pnorm recipes.
    front_nonlin: str = "relu"
    # group size for pnorm/maxout: the affine emits
    # front_affine_dim * front_group, the nonlinearity reduces groups
    front_group: int = 1
    # the 'DS2' model type — declared but unimplemented in the reference
    # (make_configs.py:121-122 offers google|DS2|FT; :294 asserts on DS2).
    # Implemented here as the Deep Speech 2 conv front end: conv_layers
    # 2D convolutions over (time, freq) with the paper's kernels
    # (11,41), (11,21), (11,21), freq stride 2 per layer and time stride
    # `conv_time_stride` on the first layer, leaky clipped-ReLU(20)
    # activations (see am_forward for why not the paper's batch norm); the (freq, channel) map flattens into the RNN input.
    # Convs are dense device work and the time stride cuts the sequential RNN
    # length, so this family trades a little accuracy for throughput.
    conv_layers: int = 0
    conv_channels: int = 32
    conv_time_stride: int = 2
    # conv-front normalization: "seq" (default) is DS2's sequence-wise
    # batch norm made functional — moments per (utterance, channel) over
    # the utterance's valid frames and freq bins, learned gamma/beta —
    # so there is no cross-sample batch statistic and train/inference
    # are the same pure function.  "none" reproduces the round-4
    # normalization-free front, which blank-collapses on the hard
    # recipe (recipes/hard/RESULTS.md: WER 100.00, train acc 0.000).
    conv_norm: str = "seq"

    # (time_kernel, freq_kernel, time_stride, freq_stride) per conv layer
    _DS2_SPECS = ((11, 41, None, 2), (11, 21, 1, 2), (11, 21, 1, 2))

    def conv_specs(self):
        if self.conv_layers > len(self._DS2_SPECS):
            raise ValueError(f"at most {len(self._DS2_SPECS)} conv layers")
        out = []
        for i in range(self.conv_layers):
            tk, fk, ts, fs = self._DS2_SPECS[i]
            out.append((tk, fk, self.conv_time_stride if ts is None else ts,
                        fs))
        return out

    @property
    def time_stride(self) -> int:
        """Output frames per input frame denominator (1 without convs)."""
        s = 1
        for _tk, _fk, ts, _fs in self.conv_specs():
            s *= ts
        return s

    def output_lens(self, input_lens):
        """Map input frame counts to logit frame counts ('SAME' conv
        padding: out = ceil(in / stride) per strided layer). Works on
        numpy ints and traced jnp arrays; identity when conv_layers=0."""
        lens = input_lens
        for _tk, _fk, ts, _fs in self.conv_specs():
            if ts > 1:
                lens = -(-lens // ts)
        return lens

    @property
    def conv_out_dim(self) -> int:
        f = self.input_dim
        for _tk, _fk, _ts, fs in self.conv_specs():
            f = -(-f // fs)
        return f * self.conv_channels

    @property
    def spliced_dim(self) -> int:
        return self.input_dim * (1 + self.splice_left + self.splice_right)

    @property
    def front_out_dim(self) -> int:
        """Front affine output width: group-expanded for pnorm/maxout."""
        group = (self.front_group
                 if self.front_nonlin in ("pnorm", "maxout") else 1)
        return self.front_affine_dim * group

    @property
    def rnn(self) -> RnnConfig:
        if self.conv_layers and (self.splice_left or self.splice_right
                                 or self.front_affine_dim):
            raise ValueError("DS2 conv front end does not combine with "
                             "splicing or the FT front layer")
        return RnnConfig(
            input_dim=(self.conv_out_dim if self.conv_layers
                       else (self.front_affine_dim or self.spliced_dim)),
            hidden_dim=self.hidden_dim,
            num_layers=self.num_layers,
            mode=self.mode,
            bidirectional=self.bidirectional,
            param_stddev=self.param_stddev,
            bias_stddev=self.bias_stddev,
            compute_dtype=self.compute_dtype,
        )

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["mode"] = int(self.mode)
        return d

    @staticmethod
    def from_dict(d: dict) -> "AmConfig":
        d = dict(d)
        d["mode"] = RnnMode(d["mode"])
        return AmConfig(**d)


def default_priors(num_targets: int, blank_prior: float = 9.0) -> np.ndarray:
    """Prior vector: ones with a large blank prior (nnet2-ctc-init-model.cc:64-67)."""
    p = np.ones(num_targets, dtype=np.float32)
    p[0] = blank_prior
    return p


def init_am_params(key: jax.Array, cfg: AmConfig) -> Dict[str, Any]:
    k_rnn, k_w, k_f = jax.random.split(key, 3)
    out_in = cfg.rnn.output_dim
    params = {
        "rnn": init_rnn_params(k_rnn, cfg.rnn),
        "out_w": cfg.param_stddev * jax.random.normal(
            k_w, (out_in, cfg.num_targets), dtype=jnp.float32),
        "out_b": jnp.zeros((cfg.num_targets,), dtype=jnp.float32),
    }
    if cfg.front_affine_dim:
        if cfg.front_nonlin not in ("relu", "tanh", "sigmoid", "pnorm",
                                    "maxout"):
            raise ValueError(f"unknown front_nonlin {cfg.front_nonlin!r}")
        params["front_w"] = cfg.param_stddev * jax.random.normal(
            k_f, (cfg.spliced_dim, cfg.front_out_dim),
            dtype=jnp.float32)
        params["front_b"] = jnp.zeros((cfg.front_out_dim,),
                                      dtype=jnp.float32)
    if cfg.conv_layers:
        convs = []
        c_in = 1
        for tk, fk, _ts, _fs in cfg.conv_specs():
            k_f, k_c = jax.random.split(k_f)
            # fan-in-scaled init: the DS2 kernels are large (11x41),
            # param_stddev alone would blow the activations up
            fan_in = tk * fk * c_in
            layer = {
                "conv_w": (jax.random.normal(
                    k_c, (tk, fk, c_in, cfg.conv_channels),
                    dtype=jnp.float32) * np.sqrt(2.0 / fan_in)),
                "conv_b": jnp.zeros((cfg.conv_channels,), jnp.float32),
            }
            if cfg.conv_norm == "seq":
                layer["norm_g"] = jnp.ones((cfg.conv_channels,),
                                           jnp.float32)
                layer["norm_b"] = jnp.zeros((cfg.conv_channels,),
                                            jnp.float32)
            elif cfg.conv_norm != "none":
                raise ValueError(f"unknown conv_norm {cfg.conv_norm!r}")
            convs.append(layer)
            c_in = cfg.conv_channels
        params["conv"] = convs
    return params


def grow_rnn_layer(params: Dict[str, Any], cfg: AmConfig,
                   key: jax.Array) -> tuple:
    """Append a freshly initialized recurrent layer (layer-wise growth,
    the nnet-insert step of steps/ctc/train.sh:357-384).

    Returns (new_params, new_cfg). The caller must rebuild jitted steps
    and optimizer state (the pytree structure changed).
    """
    new_cfg = dataclasses.replace(cfg, num_layers=cfg.num_layers + 1)
    in_dim = cfg.rnn.output_dim
    g = {RnnMode.RELU: 1, RnnMode.TANH: 1, RnnMode.LSTM: 4, RnnMode.GRU: 3}[
        cfg.mode]
    dirs = []
    for _ in range(cfg.rnn.num_directions):
        key, k1, k2, k3 = jax.random.split(key, 4)
        dirs.append({
            "w_x": cfg.param_stddev * jax.random.normal(
                k1, (in_dim, g * cfg.hidden_dim), dtype=jnp.float32),
            "w_h": cfg.param_stddev * jax.random.normal(
                k2, (cfg.hidden_dim, g * cfg.hidden_dim), dtype=jnp.float32),
            "b": cfg.bias_stddev * jax.random.normal(
                k3, (g * cfg.hidden_dim,), dtype=jnp.float32),
        })
    new_params = dict(params)
    new_params["rnn"] = list(params["rnn"]) + [{"dirs": dirs}]
    return new_params, new_cfg


def am_forward(
    params: Dict[str, Any],
    feats: jnp.ndarray,            # [B, T, D] batch-major
    cfg: AmConfig,
    input_lens: Optional[jnp.ndarray] = None,
    dropout_key: Optional[jax.Array] = None,
    probes: Optional[Dict[str, jnp.ndarray]] = None,
    taps: Optional[Dict[str, jnp.ndarray]] = None,
) -> jnp.ndarray:
    """Forward pass → logits [B, T, num_targets].

    Internally time-major for the scan; the final projection is one large
    [T*B, H] @ [H, A] matmul.

    probes/taps serve the natural-gradient affine updates
    (training/natural_gradient.py): a zero probe added to an affine
    pre-activation makes ``grad wrt probe`` the layer's output
    derivative, and ``taps`` (a dict the caller passes in) receives the
    layer's input rows — together the two factors
    AffineComponentPreconditionedOnline::Update preconditions.
    """
    if cfg.conv_layers:
        # DS2 conv front end, batch-major: [B, T, F, 1] NHWC convs with
        # 'SAME'-style padding, clipped ReLU(20) (the DS2
        # activation), pad frames masked out at each rate so strided
        # outputs never mix valid and pad content beyond the reach a
        # real 'SAME' edge has
        # Convs always compute in f32, even when compute_dtype is
        # bfloat16: on the accelerator this family was first tuned on,
        # f32 convs beside a bf16 recurrent stack measured faster than
        # bf16 convs with their extra casts.  That choice has not been
        # measured on the H100, where bf16 convs reach cuDNN's tensor
        # cores (ROADMAP A7).
        cd = jnp.float32
        x = feats[..., None]  # [B, T, F, 1]
        lens = input_lens
        for conv, (tk, fk, ts, fs) in zip(params["conv"],
                                          cfg.conv_specs()):
            if lens is not None:
                valid = (jnp.arange(x.shape[1])[None, :]
                         < lens[:, None])
                x = jnp.where(valid[..., None, None], x,
                              jnp.zeros((), x.dtype))
            # explicit (k-1)//2, k//2 padding, NOT 'SAME': SAME splits
            # its padding based on the total (batch-padded) length, so
            # the same utterance would get different window alignment in
            # different length buckets; this fixed split keeps
            # out = ceil(in/stride) with length-independent alignment
            x = jax.lax.conv_general_dilated(
                x.astype(cd), conv["conv_w"].astype(cd),
                window_strides=(ts, fs),
                padding=(((tk - 1) // 2, tk // 2),
                         ((fk - 1) // 2, fk // 2)),
                dimension_numbers=("NHWC", "HWIO", "NHWC"),
            ) + conv["conv_b"]
            if "norm_g" in conv:
                # DS2's sequence-wise batch norm (paper §3.2), made
                # functional: moments per (utterance, channel) over the
                # utterance's VALID frames and all freq bins, learned
                # gamma/beta — no cross-sample batch statistic, so train
                # and inference are one pure function and jit/pjit see
                # no mutable state.  Without this the conv front
                # blank-collapses on the hard recipe (round-4
                # RESULTS.md: both ds2 arms WER 100.00) — exactly the
                # instability the paper's seq-wise BN exists to fix.
                if lens is not None:
                    v = (jnp.arange(x.shape[1])[None, :]
                         < lens[:, None]).astype(x.dtype)      # [B, T]
                    n = jnp.maximum(v.sum(1) * x.shape[2], 1.0)  # [B]
                    vm = v[:, :, None, None]
                    mean = (x * vm).sum((1, 2)) / n[:, None]     # [B, C]
                    var = (((x - mean[:, None, None, :]) ** 2 * vm)
                           .sum((1, 2)) / n[:, None])
                else:
                    mean = x.mean((1, 2))
                    var = x.var((1, 2))
                x = ((x - mean[:, None, None, :])
                     / jnp.sqrt(var[:, None, None, :] + 1e-5)
                     * conv["norm_g"] + conv["norm_b"])
            # leaky clipped ReLU.  The DS2 paper uses clipped ReLU
            # stabilized by batch norm; with conv_norm="none" and a hard
            # ReLU the plain-SGD conv stack collapses to all-dead units
            # (observed: 100% zeros after a few hundred steps).  The
            # leaky slope keeps zero-region units recoverable.
            x = jnp.minimum(
                jnp.where(x > 0, x, jnp.asarray(0.01, x.dtype) * x),
                jnp.asarray(20.0, x.dtype))
            if lens is not None and ts > 1:
                lens = -(-lens // ts)
        b_, t_, f_, c_ = x.shape
        feats = x.reshape(b_, t_, f_ * c_).astype(jnp.float32)
        input_lens = lens
    x = jnp.swapaxes(feats, 0, 1)  # [T, B, D]
    if cfg.splice_left or cfg.splice_right:
        # SpliceComponent with edge clamping: concat frames t-L..t+R.
        # Clamp at each utterance's true last frame (input_lens), not the
        # batch-padded T-1, so the tail context matches exact-length
        # inference instead of splicing in pad frames.
        parts = []
        t = x.shape[0]
        last = (jnp.full((1,), t - 1, jnp.int32) if input_lens is None
                else jnp.maximum(input_lens - 1, 0))  # [B] or [1]
        for off in range(-cfg.splice_left, cfg.splice_right + 1):
            idx = jnp.minimum(
                jnp.maximum(jnp.arange(t)[:, None] + off, 0),
                last[None, :])                       # [T, B]
            parts.append(jnp.take_along_axis(
                x, idx[..., None], axis=0))
        x = jnp.concatenate(parts, axis=-1)
    if cfg.front_affine_dim:
        # FT front layer: Affine + nonlinearity + renormalize to unit
        # RMS (AddAffRelNormLayer, make_configs.py:269-274; pnorm/maxout
        # follow Kaldi's Affine+Pnorm/Maxout+Normalize idiom,
        # nnet2/nnet-component.h:411,514,555)
        cd = jnp.bfloat16 if cfg.compute_dtype == "bfloat16" else jnp.float32
        if taps is not None:
            taps["front_in"] = x
        h = (jnp.dot(x.astype(cd), params["front_w"].astype(cd),
                     preferred_element_type=jnp.float32)
             + params["front_b"])
        if probes is not None and "front" in probes:
            h = h + probes["front"]
        if cfg.front_nonlin == "relu":
            h = jax.nn.relu(h)
        elif cfg.front_nonlin == "tanh":
            h = jnp.tanh(h)
        elif cfg.front_nonlin == "sigmoid":
            h = jax.nn.sigmoid(h)
        else:  # pnorm / maxout: reduce front_group-sized groups
            g = h.reshape(h.shape[:-1]
                          + (cfg.front_affine_dim, cfg.front_group))
            if cfg.front_nonlin == "pnorm":
                h = jnp.sqrt(jnp.sum(g * g, axis=-1) + 1e-20)
            else:
                h = jnp.max(g, axis=-1)
        rms = jnp.sqrt(jnp.mean(h * h, axis=-1, keepdims=True) + 1e-20)
        x = h / rms
        if taps is not None:
            taps["front_out"] = x
    y = rnn_forward(params["rnn"], x, cfg.rnn, input_lens)
    if cfg.dropout > 0.0 and dropout_key is not None:
        keep = 1.0 - cfg.dropout
        mask = jax.random.bernoulli(dropout_key, keep, y.shape)
        y = jnp.where(mask, y / keep, 0.0)
    t, b, h = y.shape
    cd = jnp.bfloat16 if cfg.compute_dtype == "bfloat16" else jnp.float32
    if taps is not None:
        taps["out_in"] = y
    logits = (jnp.dot(y.reshape(t * b, h).astype(cd),
                      params["out_w"].astype(cd),
                      preferred_element_type=jnp.float32)
              + params["out_b"]).reshape(t, b, -1)
    if probes is not None and "out" in probes:
        # probe rows are [T*B, A], the same layout the out_deriv rows
        # feed ng_affine_update in
        logits = logits + probes["out"].reshape(logits.shape)
    return jnp.swapaxes(logits, 0, 1)  # [B, T, A]
