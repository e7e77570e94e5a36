"""Multi-host runtime (the NCCL/MPI-equivalent the reference lacks).

SURVEY.md §2.2: the reference has no distributed communication backend of
any kind (no sockets, no RPC, no MPI anywhere in the crate).  The
JAX equivalent is the multi-controller runtime: every host runs
the same program, `jax.distributed.initialize` wires the hosts into one
XLA runtime, and `jax.devices()` then spans every host — collectives
(psum film merges, all_gathers, ppermute ring forwarding) compile to
NCCL collectives within and across hosts with no further code changes.  All
of pbrt_tpu's mesh code (`parallel/mesh.py`, `parallel/geomshard.py`)
works unchanged on a global mesh because sampling is a pure function of
(pixel, sample, dim): no host ever needs another host's RNG state.

Typical multi-host usage (same script on every host):

    from pbrt_tpu.parallel.multihost import initialize_multihost, global_mesh
    initialize_multihost("host0:1234", n_hosts, rank)
    mesh = global_mesh(dp=None, sp=2)   # spans ALL hosts' devices
    ShardedRenderer(Renderer(desc, opt), mesh).render()

Per-host film assembly: `process_local_slice` tells each host which rows
of the lane batch it feeds (jax requires per-host input slices for
globally-sharded arrays via `jax.make_array_from_process_local_data`).
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np

import jax
from jax.sharding import Mesh

log = logging.getLogger("pbrt_tpu")


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None) -> bool:
    """Initialize the JAX multi-controller runtime.

    Where a cluster manager describes the job, the three arguments
    auto-detect from the environment (pass nothing); elsewhere supply
    coordinator "host:port", world size, and this process's rank.  Safe to call when already initialized or on
    a single process (returns False then).  Mirrors what NCCL/MPI init
    would be in the reference's world — which has none (SURVEY §2.2).
    """
    if jax.process_count() > 1:
        return True  # already initialized
    try:
        if coordinator_address is None and num_processes is None:
            jax.distributed.initialize()
        else:
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes,
                process_id=process_id,
            )
    except (ValueError, RuntimeError) as e:
        log.info("multi-host init skipped (%s); running single-process", e)
        return False
    log.info(
        "multi-host runtime: process %d/%d, %d local + %d global devices",
        jax.process_index(), jax.process_count(),
        jax.local_device_count(), jax.device_count(),
    )
    return True


def global_mesh(dp: Optional[int] = None, sp: int = 1,
                tp: Optional[int] = None) -> Mesh:
    """Build a mesh over ALL devices of ALL hosts.

    Axes follow parallel/mesh.py: dp = ray/pixel shards, sp = sample
    shards, tp (optional third axis) = geometry shards for
    parallel/geomshard.py.  Device order is jax.devices() (pod-global),
    so dp-major assignment keeps each host's devices contiguous on the dp
    axis — lane slices then align with process-local data feeding.
    """
    devs = jax.devices()
    n = len(devs)
    if tp is None:
        dp = dp or (n // sp)
        assert dp * sp == n, f"dp*sp={dp * sp} != devices {n}"
        return Mesh(np.array(devs).reshape(dp, sp), ("dp", "sp"))
    dp = dp or (n // (sp * tp))
    assert dp * sp * tp == n, f"dp*sp*tp={dp * sp * tp} != devices {n}"
    return Mesh(np.array(devs).reshape(dp, sp, tp), ("dp", "sp", "tp"))


def process_local_slice(n_lanes: int) -> slice:
    """The rows of a dp-sharded lane batch this host must provide.

    With dp-major meshes from :func:`global_mesh`, host p feeds lanes
    [p*n/P, (p+1)*n/P) where P = process_count.  n_lanes must divide
    evenly (callers pad to the mesh size already).
    """
    p = jax.process_index()
    np_ = jax.process_count()
    per = n_lanes // np_
    return slice(p * per, (p + 1) * per)
