"""Multi-host distribution (SURVEY §2.5 P5; §5.8 comms backend).

The reference's inter-machine story is static partition + filesystem merge
(hammings -n/-N) and a bespoke TCP RPC (pacbiokit4b BKS). Here multi-host is
the standard jax.distributed process group: every host runs the same
program, `initialize()` wires the group, global device meshes span hosts
(collectives ride the devices' own links within a host, the network
across), and input sharding gives
each host its slice of the readset — no bespoke sockets.

Single-host degenerates gracefully (process_count == 1), so every driver can
call these helpers unconditionally.
"""
from __future__ import annotations

import os


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> tuple[int, int]:
    """Initialize jax.distributed from args or the standard env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID).
    Returns (process_id, process_count)."""
    import jax
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    want_procs = num_processes or int(
        os.environ.get("JAX_NUM_PROCESSES", "1"))
    if (coordinator or want_procs > 1):
        try:
            jax.distributed.initialize(
                coordinator_address=coordinator,
                num_processes=num_processes, process_id=process_id)
        except RuntimeError:
            # backend already initialized (single-host dev flows) — proceed
            # with whatever group exists
            pass
    return jax.process_index(), jax.process_count()


def host_shard(items, process_id: int | None = None,
               process_count: int | None = None):
    """Round-robin shard of an iterable for this host — the multi-host input
    pipeline: each host parses and aligns only its share of the reads; the
    per-host SAM shards concatenate afterwards (the reference's hammings
    node-partition + merge pattern generalized)."""
    import jax
    pid = jax.process_index() if process_id is None else process_id
    pcount = jax.process_count() if process_count is None else process_count
    for i, item in enumerate(items):
        if i % pcount == pid:
            yield item


def shard_output_path(path, process_id: int | None = None) -> str:
    """Per-host output naming: out.sam -> out.p3.sam on process 3."""
    import jax
    pid = jax.process_index() if process_id is None else process_id
    if pid == 0 and jax.process_count() == 1:
        return str(path)
    root, ext = os.path.splitext(str(path))
    return f"{root}.p{pid}{ext}"


def merge_sam_shards(out_path, shard_paths: list) -> None:
    """Concatenate per-host SAM shards (header from the first)."""
    with open(out_path, "w") as out:
        for i, p in enumerate(shard_paths):
            with open(p) as f:
                for line in f:
                    if line.startswith("@") and i > 0:
                        continue
                    out.write(line)


def global_mesh(axis_names=("dp", "tp"), shape=None):
    """A device mesh spanning every process's devices. shape defaults to
    (all_devices, 1)."""
    import jax
    import numpy as np
    from jax.sharding import Mesh
    devs = jax.devices()
    if shape is None:
        shape = (len(devs), 1)
    arr = np.asarray(devs[: shape[0] * shape[1]]).reshape(*shape)
    return Mesh(arr, axis_names)
