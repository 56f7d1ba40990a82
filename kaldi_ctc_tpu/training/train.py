"""Training: jit-compiled CTC train step + the outer loop pieces.

Replaces the reference's NnetCtcUpdater/TrainNnetSimple
(``ctc/ctc-nnet-update.cc:76-348``, ``ctc/ctc-nnet-train.cc:181-284``) and
the train.sh outer-loop semantics (``steps/ctc/train.sh:327-456``):

- one fused XLA step: forward (B)LSTM stack → CTC alpha-beta loss+grad →
  backprop → elementwise grad clip (cuDNN component clip ±5,
  ``nnet-cudnn-component.cc:602-603``) → SGD(+momentum) update;
- SGD uses gradient *sums* over the minibatch like the reference
  (``nnet-cudnn-component.cc:612-614`` — ``params += lr*grad`` with no 1/B),
  with an ``objective_scale`` knob (set to 1/num_data_shards for parity with
  the reference's N-GPU parameter averaging);
- exponential lr decay ``lr(x) = lr_i * exp(x*log(lr_f/lr_i)/num_steps)``
  (``steps/ctc/train.sh:352``);
- greedy-collapse label accuracy computed per minibatch
  (``ctc/ctc-nnet-update.cc:261-317``) — argmax+collapse on device,
  Levenshtein on host;
- data parallelism: batch arrays sharded over the mesh 'data' axis, params
  replicated; XLA inserts the gradient allreduce (vs the reference's
  once-per-iteration ``nnet-am-average``, ``steps/ctc/train.sh:431-435``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from kaldi_ctc_tpu.models.acoustic import AmConfig, am_forward
from kaldi_ctc_tpu.ops.ctc import ctc_loss, greedy_collapse
from kaldi_ctc_tpu.utils.edit_distance import batch_edit_distance

__all__ = ["TrainOptions", "exponential_lr", "make_train_step",
           "make_eval_step", "accuracy_from_outputs", "TrainState",
           "init_train_state"]


@dataclasses.dataclass(frozen=True)
class TrainOptions:
    """Mirror of the reference's trainer knobs (ctc/ctc-nnet-train.h:33-66,
    steps/ctc/train.sh:7-116)."""

    initial_learning_rate: float = 5e-4
    final_learning_rate: float = 1e-5
    num_steps: int = 10000          # decay horizon (num_iters analogue)
    momentum: float = 0.0
    clip_elementwise: float = 5.0   # cudnn component clip ±5
    clip_norm: float = 0.0          # optional global-norm clip (0 = off)
    objective_scale: float = 1.0    # 1/num_data_shards for parity
    # NaN/Inf guard (ctc-nnet-update.cc:232-234,254 kills the job on a
    # non-finite objf/grad).  The update is ALWAYS suppressed on device
    # when loss or grad norm is non-finite, so state stays clean either
    # way; the driver decides abort-vs-skip from the exported "finite"
    # metric.  guard=False removes the select entirely (bench ablation).
    guard_nonfinite: bool = True
    # "simple" (plain SGD on affine fronts) or "natural" (online NG-SGD
    # preconditioning of the affine updates — NaturalGradientAffine /
    # --affine-type natural, steps/ctc/nnet2/components.py:30-33)
    affine_type: str = "simple"
    ng_rank_in: int = 30
    ng_rank_out: int = 80
    ng_update_period: int = 1
    ng_num_samples_history: float = 2000.0
    ng_alpha: float = 4.0
    # linear lr warmup over this many steps before the exponential
    # decay (0 = off, the reference schedule).  CTC models with fresh
    # conv fronts blank-collapse in the first epochs at the full lr;
    # the standard remedy (DS2 trains with SortaGrad + warmup-like
    # ramps) is a short ramp from ~0 to lr_initial.
    warmup_steps: int = 0


class TrainState(NamedTuple):
    params: Any
    velocity: Any
    step: jnp.ndarray
    # natural-gradient preconditioner states ({} for plain affine —
    # an empty dict adds no pytree leaves, so checkpoints stay
    # layout-compatible with pre-NG runs)
    ng: Any = None


def init_train_state(params: Any,
                     opts: "TrainOptions" = None) -> TrainState:
    velocity = jax.tree_util.tree_map(jnp.zeros_like, params)
    ng = None
    if opts is not None and opts.affine_type == "natural":
        from kaldi_ctc_tpu.training.natural_gradient import ng_init
        ng = {}
        for name in ("front", "out"):
            w = params.get(f"{name}_w")
            if w is None:
                continue
            d_in, d_out = int(w.shape[0]), int(w.shape[1])
            ng[name] = {
                "in": ng_init(d_in + 1, opts.ng_rank_in, opts.ng_alpha),
                "out": ng_init(d_out, opts.ng_rank_out, opts.ng_alpha)}
    return TrainState(params=params, velocity=velocity,
                      step=jnp.zeros((), jnp.int32), ng=ng)


def exponential_lr(opts: TrainOptions, step) -> jnp.ndarray:
    """lr(x) = lr_i * exp(x * log(lr_f/lr_i) / num_steps) (train.sh:352),
    optionally preceded by a linear warmup ramp (warmup_steps > 0)."""
    ratio = math.log(opts.final_learning_rate / opts.initial_learning_rate)
    lr = opts.initial_learning_rate * jnp.exp(
        step.astype(jnp.float32) * (ratio / max(opts.num_steps, 1)))
    if opts.warmup_steps > 0:
        w = (step.astype(jnp.float32) + 1.0) / float(opts.warmup_steps)
        lr = lr * jnp.minimum(w, 1.0)
    return lr


def _clip_tree(grads: Any, opts: TrainOptions) -> Any:
    if opts.clip_elementwise > 0:
        c = opts.clip_elementwise
        grads = jax.tree_util.tree_map(
            lambda g: jnp.clip(g, -c, c), grads)
    if opts.clip_norm > 0:
        leaves = jax.tree_util.tree_leaves(grads)
        norm = jnp.sqrt(sum(jnp.sum(g * g) for g in leaves))
        scale = jnp.minimum(1.0, opts.clip_norm / jnp.maximum(norm, 1e-20))
        grads = jax.tree_util.tree_map(lambda g: g * scale, grads)
    return grads


def build_train_step(cfg: AmConfig, opts: TrainOptions):
    """Build the raw (unjitted) train step function.

    Signature: state, metrics = step(state, batch)
    batch: dict with feats [B,T,D] f32, labels [B,L] i32,
           input_lens [B] i32, label_lens [B] i32.
    metrics: dict of scalars + hyp ids/lens for host-side accuracy.
    Use make_train_step for the jitted version; the raw body is exposed so
    callers can fuse multiple steps under one jit (lax.scan) — important on
    backends with high per-dispatch overhead.
    """

    use_ng = opts.affine_type == "natural"
    if use_ng:
        from kaldi_ctc_tpu.training.natural_gradient import (
            NgOptions, ng_affine_update)
        ng_opts = NgOptions(
            rank_in=opts.ng_rank_in, rank_out=opts.ng_rank_out,
            update_period=opts.ng_update_period,
            num_samples_history=opts.ng_num_samples_history,
            alpha=opts.ng_alpha)

    def loss_fn(params, probes, batch, dropout_key):
        taps = {}
        logits = am_forward(params, batch["feats"], cfg,
                            input_lens=batch["input_lens"],
                            dropout_key=dropout_key,
                            probes=probes or None,
                            taps=taps if use_ng else None)
        # conv time stride shrinks the logit sequence (identity otherwise)
        out_lens = cfg.output_lens(batch["input_lens"])
        losses = ctc_loss(logits, batch["labels"], out_lens,
                          batch["label_lens"])
        total = jnp.sum(losses) * opts.objective_scale
        return total, (losses, logits, taps)

    def train_step(state: TrainState, batch: Dict[str, jnp.ndarray]):
        # per-step dropout key derived from the step counter (deterministic,
        # resume-stable); unused when cfg.dropout == 0
        dkey = (jax.random.fold_in(jax.random.PRNGKey(0), state.step)
                if cfg.dropout > 0.0 else None)
        b, t = batch["feats"].shape[0], batch["feats"].shape[1]
        probes = {}
        if use_ng:
            # zero probes on the affine pre-activations: grad wrt each
            # probe is that layer's out_deriv rows, the second factor
            # of the NG update
            t_out = -(-t // cfg.time_stride)
            probes["out"] = jnp.zeros((t_out * b, cfg.num_targets),
                                      jnp.float32)
            if cfg.front_affine_dim:
                probes["front"] = jnp.zeros(
                    (t, b, cfg.front_out_dim), jnp.float32)
        (total, (losses, logits, taps)), (grads, pgrads) = \
            jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True)(
                state.params, probes, batch, dkey)
        new_ng = state.ng
        if use_ng:
            new_ng = dict(state.ng)
            y = taps["out_in"]
            gw, gb, s_in, s_out = ng_affine_update(
                state.ng["out"]["in"], state.ng["out"]["out"],
                y.reshape(-1, y.shape[-1]), pgrads["out"], ng_opts)
            grads["out_w"], grads["out_b"] = gw, gb
            new_ng["out"] = {"in": s_in, "out": s_out}
            if cfg.front_affine_dim:
                xf = taps["front_in"]
                gw, gb, s_in, s_out = ng_affine_update(
                    state.ng["front"]["in"], state.ng["front"]["out"],
                    xf.reshape(-1, xf.shape[-1]),
                    pgrads["front"].reshape(-1, cfg.front_out_dim),
                    ng_opts)
                grads["front_w"], grads["front_b"] = gw, gb
                new_ng["front"] = {"in": s_in, "out": s_out}
        grads = _clip_tree(grads, opts)
        lr = exponential_lr(opts, state.step)
        grad_norm = jnp.sqrt(sum(
            jnp.sum(g * g) for g in jax.tree_util.tree_leaves(grads)))
        # elementwise clip keeps NaN NaN, so grad_norm still detects it
        finite = jnp.isfinite(jnp.sum(losses)) & jnp.isfinite(grad_norm)
        if opts.momentum > 0:
            velocity = jax.tree_util.tree_map(
                lambda v, g: opts.momentum * v + g, state.velocity, grads)
        else:
            velocity = grads
        if opts.guard_nonfinite:
            # suppress the whole update on a poisoned batch: params AND
            # velocity keep their previous values (a NaN velocity would
            # re-poison every later step through momentum)
            params = jax.tree_util.tree_map(
                lambda p, v: jnp.where(finite, p - lr * v, p),
                state.params, velocity)
            velocity = jax.tree_util.tree_map(
                lambda v_new, v_old: jnp.where(finite, v_new, v_old),
                velocity, state.velocity)
        else:
            params = jax.tree_util.tree_map(
                lambda p, v: p - lr * v, state.params, velocity)
        if use_ng and opts.guard_nonfinite:
            # a poisoned batch must not corrupt the preconditioners
            new_ng = jax.tree_util.tree_map(
                lambda n, o: jnp.where(finite, n, o), new_ng, state.ng)
        new_state = TrainState(params=params,
                               velocity=(velocity if opts.momentum > 0
                                         else state.velocity),
                               step=state.step + 1,
                               ng=new_ng)
        out_lens = cfg.output_lens(batch["input_lens"])
        hyp_ids, hyp_lens = greedy_collapse(
            jnp.argmax(logits, axis=-1), out_lens)
        num_frames = jnp.sum(out_lens)
        metrics = {
            "loss_total": jnp.sum(losses),
            "loss_per_frame": jnp.sum(losses) / num_frames.astype(jnp.float32),
            "num_frames": num_frames,
            "lr": lr,
            "grad_norm": grad_norm,
            "finite": finite,
            "hyp_ids": hyp_ids,
            "hyp_lens": hyp_lens,
        }
        return new_state, metrics

    return train_step


def make_train_step(cfg: AmConfig, opts: TrainOptions):
    """Jitted train step (state donated)."""
    return jax.jit(build_train_step(cfg, opts), donate_argnums=(0,))


def make_eval_step(cfg: AmConfig):
    """Diagnostic objf/accuracy pass (nnet2-ctc-compute-prob analogue)."""

    def eval_step(params, batch):
        logits = am_forward(params, batch["feats"], cfg,
                            input_lens=batch["input_lens"])
        out_lens = cfg.output_lens(batch["input_lens"])
        losses = ctc_loss(logits, batch["labels"], out_lens,
                          batch["label_lens"])
        hyp_ids, hyp_lens = greedy_collapse(
            jnp.argmax(logits, axis=-1), out_lens)
        return {
            "loss_total": jnp.sum(losses),
            "num_frames": jnp.sum(out_lens),
            "hyp_ids": hyp_ids,
            "hyp_lens": hyp_lens,
        }

    return jax.jit(eval_step)


def _host_local_rows(x) -> np.ndarray:
    """This host's rows of a batch-sharded output.

    In multi-host SPMD the hyp arrays span non-addressable devices; each
    host scores only its own rows (which line up with its local labels),
    so gather just the addressable shards in index order."""
    if getattr(x, "is_fully_addressable", True):
        return np.asarray(x)
    shards = sorted(x.addressable_shards, key=lambda s: s.index)
    return np.concatenate([np.asarray(s.data) for s in shards], axis=0)


def accuracy_from_outputs(
    metrics: Dict[str, Any],
    labels: np.ndarray,
    label_lens: np.ndarray,
) -> Tuple[float, int, int]:
    """Greedy-collapse label accuracy = 1 - edit_distance/ref_len.

    Host-side Levenshtein over the device-computed collapsed hypotheses
    (ComputeTotAccuracy, ctc-nnet-update.cc:261-317).
    Returns (accuracy, total_errors, total_ref_len).
    """
    hyp_ids = _host_local_rows(metrics["hyp_ids"])
    hyp_lens = _host_local_rows(metrics["hyp_lens"])
    dists, ref_lens = batch_edit_distance(
        np.asarray(labels), np.asarray(label_lens), hyp_ids, hyp_lens)
    total_err = int(dists.sum())
    total_ref = int(ref_lens.sum())
    acc = 1.0 - total_err / max(total_ref, 1)
    return acc, total_err, total_ref
