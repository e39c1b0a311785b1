"""Device-mesh helpers.

The reference is single-threaded (its only nod to parallelism is an unused
`Base.Threads` import, /root/reference/src/CompressedSensing.jl:12). Here
scaling is a first-class axis pair:

  * 'batch' — data parallelism over problem instances (independent b's)
  * 'atoms' — model/tensor parallelism: the dictionary A is column-sharded
    so each chip correlates its own atom shard with the residual

Collectives ride the mesh via psum/pmin/pmax/all_gather inside shard_map
(see cstpu.parallel.sharded); XLA lowers them to the devices' own
collective library (NCCL on GPUs). A mesh is any set of devices, shaped
by the algorithm: every device of one host reaches every other alike.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(shape=None, axis_names=("batch", "atoms"), devices=None) -> Mesh:
    """Create a mesh over the available devices.

    Default: all devices on the 'atoms' (tensor-parallel) axis, batch=1.
    """
    devices = np.array(devices if devices is not None else jax.devices())
    if shape is None:
        shape = (1, devices.size)
    return Mesh(devices.reshape(shape), axis_names)


def shard_dictionary(A, mesh: Mesh, axis: str = "atoms"):
    """Place A column-sharded over `axis` (replicated over the rest)."""
    return jax.device_put(A, NamedSharding(mesh, P(None, axis)))


def shard_batch(b, mesh: Mesh, axis: str = "batch"):
    """Place a batch of measurements row-sharded over `axis`."""
    spec = P(axis, None) if b.ndim == 2 else P(None)
    return jax.device_put(b, NamedSharding(mesh, spec))
