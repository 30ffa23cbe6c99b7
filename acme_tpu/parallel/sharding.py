"""Lane-axis sharding over a device mesh.

The reference is single-process/single-thread (SURVEY.md section 2.3); the
scaling axis here is the *lane* (independent circuit instance:
parameter-sweep point, audio channel, voice).  Lanes need no communication
during the scan -- the recurrence is within-lane -- so multi-device
execution is pure SPMD data parallelism: shard the lane dimension of the
carry and the inputs over the mesh and let the XLA partitioner run each
shard locally.  Traffic between devices (NVLink between the cards of one
host) is limited to the initial scatter / final gather.  That makes "dp"
the one real mesh axis for this workload; tensor/pipeline/sequence
parallelism do not apply (the per-lane state is tens of floats and the time
recurrence is inherently serial, see SURVEY.md sections 2.3 and 5).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["lane_mesh", "lane_sharding", "shard_state", "sharded_run"]


def lane_mesh(n_devices: int | None = None, axis: str = "dp") -> Mesh:
    """A 1-D mesh over ``n_devices`` (default: all) with the lane axis."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def lane_sharding(mesh: Mesh, axis: str = "dp") -> NamedSharding:
    """Sharding that splits the leading (lane) dimension over the mesh."""
    return NamedSharding(mesh, P(axis))


def shard_state(state, mesh: Mesh, axis: str = "dp"):
    """Place a CompiledModel scan carry with its lane dimension sharded."""
    sh = lane_sharding(mesh, axis)

    def place(leaf):
        return jax.device_put(leaf, NamedSharding(mesh, P(axis, *([None] * (leaf.ndim - 1)))))

    return jax.tree_util.tree_map(place, state)


def sharded_run(cm, u, mesh: Mesh, axis: str = "dp"):
    """Run a CompiledModel with lanes sharded over ``mesh``.

    ``u``: (L, nu, T) with L divisible by the mesh size.  The scan carry and
    the batched input are placed lane-sharded; the jitted scan then executes
    SPMD with no collectives in the loop body.
    """
    import jax.numpy as jnp

    u = jnp.asarray(u, cm.dtype)
    if u.ndim != 3:
        raise ValueError("sharded_run expects a (L, nu, T) batch")
    L = u.shape[0]
    if L % mesh.devices.size != 0:
        raise ValueError(f"{L} lanes not divisible by {mesh.devices.size} devices")
    state = shard_state(cm.initial_state(L), mesh, axis)
    u_tm = jnp.transpose(u, (2, 0, 1))
    u_tm = jax.device_put(u_tm, NamedSharding(mesh, P(None, axis, None)))
    state, (y_tm, conv, iters) = cm._scan(state, u_tm)
    y = jnp.transpose(y_tm, (1, 2, 0))
    from .. import engine as _engine
    return y, state, _engine.RunInfo(converged=conv, iters=iters)


def sharded_run_sweep(cm, u_time, lane_values, lane_input_idx, mesh: Mesh,
                      axis: str = "dp"):
    """Parameter-sweep run with the lane-constant table sharded over the mesh."""
    import jax.numpy as jnp

    u_time = jnp.asarray(u_time, cm.dtype)
    lane_values = jnp.asarray(lane_values, cm.dtype)
    L = lane_values.shape[0]
    if L % mesh.devices.size != 0:
        raise ValueError(f"{L} lanes not divisible by {mesh.devices.size} devices")
    state = shard_state(cm.initial_state(L), mesh, axis)
    lane_values = jax.device_put(lane_values, lane_sharding(mesh, axis))
    u_tm = jax.device_put(u_time.T, NamedSharding(mesh, P(None, None)))
    lane_idx = tuple(int(i) for i in lane_input_idx)
    state, (y_tm, conv, iters) = cm._scan_sweep(state, u_tm, lane_values, lane_idx)
    y = jnp.transpose(y_tm, (1, 2, 0))
    from .. import engine as _engine
    return y, state, _engine.RunInfo(converged=conv, iters=iters)
