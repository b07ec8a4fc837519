"""Multi-host runtime for the sharded engine (jax.distributed).

The reference is a single-process, single-GPU application (SURVEY.md
§2.10: "Distributed comm backend: none"); this module is the beyond-
reference multi-host path this engine adds.  It owns exactly three
responsibilities, all host-side:

* **Process-group bring-up** — :func:`initialize` wraps
  ``jax.distributed.initialize`` (coordination service + Gloo collectives
  on the CPU backend, NCCL over NVLink/the network on GPUs).  After it returns,
  ``jax.devices()`` spans every process and the *same*
  :func:`voxelhashing_tpu.parallel.sharded.make_sharded_step` program
  runs SPMD across hosts — the compute path does not change.
* **Global-array construction** — in multi-process JAX every jit input
  must be a global array whose shards live on the right processes.
  :func:`create_sharded_global` builds the device-sharded
  :class:`~voxelhashing_tpu.blockmap.MapState` via
  ``jax.make_array_from_callback`` (each process materialises only its
  addressable shards — the full pool never exists on one host), and
  :func:`replicate` lifts per-host frame data (every host is assumed to
  ingest the same RGB-D frame, e.g. from the network sensor's broadcast)
  into a mesh-replicated array.
* **Collective-safe readback** — :func:`fetch_replicated` returns
  process-local numpy for replicated outputs (the pose).

Typical 2-host session::

    from voxelhashing_tpu.parallel import distributed, sharded
    distributed.initialize("host0:9876", num_processes=2, process_id=pid)
    mesh = distributed.global_mesh()
    state, lcfg = distributed.create_sharded_global(cfg, mesh)
    step = sharded.make_sharded_step(cfg, mesh)
    for depth, color in frames:
        d = distributed.replicate(depth, mesh)
        c = distributed.replicate(color, mesh)
        state, pose = step(state, d, c)

Tested end-to-end by ``tests/test_distributed.py`` (two real processes,
Gloo collectives, 4-device global mesh).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import EngineConfig, MapConfig
from .. import blockmap
from . import sharded as _sharded
from .sharded import AXIS, ShardedState


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, *, cpu_devices_per_process: int = 0,
               ) -> None:
    """Bring up the multi-host process group.

    ``cpu_devices_per_process > 0`` forces the CPU backend with that many
    virtual devices per process and Gloo cross-process collectives — the
    single-host multi-process test configuration.  On GPUs leave it 0:
    every process then sees its local GPUs, ``jax.devices()`` spans all
    processes' GPUs once the group is up, and XLA hands the collectives
    to NCCL (NVLink within a host, the network between hosts).
    ``coordinator_address`` is ``host:port`` of process 0 (e.g.
    ``localhost:<free port>`` on one machine); nothing discovers a
    cluster implicitly.
    """
    if cpu_devices_per_process > 0:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", cpu_devices_per_process)
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def global_mesh(n_devices: Optional[int] = None) -> Mesh:
    """1-D mesh over all (or the first ``n_devices``) global devices."""
    devs = jax.devices() if n_devices is None else jax.devices()[:n_devices]
    return Mesh(np.array(devs), axis_names=(AXIS,))


def create_sharded_global(cfg: EngineConfig, mesh: Mesh,
                          initial_pose=None
                          ) -> Tuple[ShardedState, MapConfig]:
    """Multi-process-safe :func:`sharded.create_sharded`.

    Each process materialises only the map shards it can address; the
    global array is assembled by ``jax.make_array_from_callback`` without
    any host ever holding the whole pool.
    """
    n_dev = mesh.devices.size
    lcfg = _sharded.local_map_config(cfg.map, n_dev)
    local = blockmap.create(lcfg)
    local_np = jax.tree_util.tree_map(np.asarray, local)
    shard = NamedSharding(mesh, P(AXIS))

    def make(leaf):
        full_shape = (n_dev,) + leaf.shape

        def cb(index):
            # every device's shard is one fresh empty local map
            n = len(range(*index[0].indices(n_dev)))
            return np.broadcast_to(leaf[None], (n,) + leaf.shape)

        return jax.make_array_from_callback(full_shape, shard, cb)

    stacked = jax.tree_util.tree_map(make, local_np)
    pose0 = np.eye(4, dtype=np.float32) if initial_pose is None \
        else np.asarray(initial_pose, np.float32)
    return ShardedState(map=stacked,
                        pose=replicate(pose0, mesh),
                        frame=replicate(np.int32(0), mesh)), lcfg


def replicate(x, mesh: Mesh):
    """Lift identical per-host data to a mesh-replicated global array."""
    arr = np.asarray(x)
    rep = NamedSharding(mesh, P())
    return jax.make_array_from_callback(arr.shape, rep, lambda idx: arr[idx])


def fetch_replicated(x) -> np.ndarray:
    """Read a replicated global array back on this process."""
    shards = [s for s in x.addressable_shards]
    return np.asarray(shards[0].data)
