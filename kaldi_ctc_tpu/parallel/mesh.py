"""Device mesh and sharding rules.

Replaces the reference's process-per-GPU + parameter-averaging "distributed
runtime" (``steps/ctc/train.sh:386-446``, ``utils/run.pl``) with a single
SPMD program over a ``jax.sharding.Mesh``:

- ``data`` axis: utterance minibatch sharded across devices; the
  per-step gradient allreduce XLA inserts is mathematically stronger than
  the reference's once-per-outer-iteration ``nnet-am-average``.
- ``model`` axis (optional): gate/hidden dims of the recurrent weights and
  the output projection sharded for tensor parallelism when the model
  exceeds one device's memory (the reference has no TP).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "data_sharding", "param_sharding", "shard_batch",
           "replicated"]


def make_mesh(
    data: int = -1,
    model: int = 1,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Create a ('data', 'model') mesh. data=-1 → all remaining devices."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if data == -1:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(
            f"mesh {data}x{model} needs {data * model} devices but "
            f"{n} are available — the device count must be divisible "
            f"by the mesh shape; pass an explicitly trimmed `devices` "
            f"list (devices[:k*model]) to use a subset")
    dev_array = np.asarray(devices).reshape(data, model)
    return Mesh(dev_array, axis_names=("data", "model"))


def data_sharding(mesh: Mesh) -> NamedSharding:
    """Batch arrays: leading (batch) dim over the data axis."""
    return NamedSharding(mesh, P("data"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def param_sharding(mesh: Mesh, params: Any,
                   tensor_parallel: bool = False) -> Any:
    """Sharding pytree matching `params`.

    Default: fully replicated (pure DP).  With tensor_parallel: the gate
    dim (last axis) of recurrent weights and the output projection's target
    axis go over the 'model' axis.
    """
    def rule(path, leaf):
        if not tensor_parallel or leaf.ndim == 0:
            return replicated(mesh)
        names = [getattr(p, "key", getattr(p, "name", None)) for p in path]
        if "w_x" in names or "w_h" in names or "b" in names:
            spec = [None] * leaf.ndim
            spec[-1] = "model"
            return NamedSharding(mesh, P(*spec))
        if "out_w" in names or "out_b" in names:
            spec = [None] * leaf.ndim
            spec[-1] = "model"
            return NamedSharding(mesh, P(*spec))
        return replicated(mesh)

    return jax.tree_util.tree_map_with_path(rule, params)


def shard_batch(batch: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """Place host batch arrays with the batch dim sharded over 'data'.

    Single-process: a plain device_put.  Multi-host SPMD: each process
    passes its local shard (see distributed.host_shard) and the pieces
    are assembled into one global array across the mesh."""
    sh = data_sharding(mesh)
    if jax.process_count() > 1:
        return jax.tree_util.tree_map(
            lambda x: jax.make_array_from_process_local_data(
                sh, np.asarray(x)), batch)
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sh), batch)
