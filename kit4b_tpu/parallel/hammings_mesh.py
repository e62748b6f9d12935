"""Mesh-parallel hammings: own-row sharding of the min-matmul engine.

The reference distributes the exhaustive sweep across machines by static
genome-sweep partitioning with a filesystem merge (`-n numnodes -N node` +
ePMmerge, ngskit4b/hammings.cpp:99-106). On a device mesh the min-matmul
formulation (kmer/hammings_mxu.py) shards the *own-window rows* over an "sp"
axis: every device holds the (replicated) window one-hot matrix, computes
max-matches for its contiguous row block against all partner spans, and the
row blocks concatenate back — embarrassingly parallel, no collective beyond
the output gather. Node-level partitioning composes orthogonally via
partner-span ranges (merge = elementwise min, as the reference's ePMmerge).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..kmer.hammings_mxu import (OUT_BIG, PART, _round_up,
                                 _window_onehot_dev, max_matches,
                                 max_matches_impl)


def make_hammings_mesh(mesh: Mesh, G: int, K: int, *, antisense: bool = True,
                       span_lo: int = 0, span_cnt: int | None = None):
    """Build the jitted sharded engine: ext codes (replicated) -> hmin [G].
    Partner spans are PART rows each."""
    D = mesh.devices.size
    Gp = _round_up(G, D * PART)
    R = Gp // D
    cnt = Gp // PART if span_cnt is None else span_cnt
    impl = max_matches_impl()
    span = dict(part_lo=span_lo * PART, part_cnt=cnt * PART, impl=impl)

    def _local(ext):
        i = jax.lax.axis_index("sp")
        W, valid = _window_onehot_dev(ext, K, Gp, G)
        wo = jax.lax.dynamic_slice_in_dim(W, i * R, R)
        row_base = (i * R).reshape(1).astype(jnp.int32)
        maxm = max_matches(wo, W, diag=True, row_base=row_base, **span)
        if antisense:
            grev = ext[:G][::-1]
            rc = jnp.where(grev < 4, 3 - grev, grev)
            rc_ext = jnp.concatenate(
                [rc, jnp.full(Gp + K - G, 0x0F, rc.dtype)])
            Wrc, _ = _window_onehot_dev(rc_ext, K, Gp, G)
            maxm = jnp.maximum(maxm, max_matches(
                wo, Wrc, diag=False, row_base=row_base, **span))
        hmin = K - maxm
        vloc = jax.lax.dynamic_slice_in_dim(valid, i * R, R)
        return jnp.where(vloc, jnp.minimum(hmin, int(OUT_BIG)),
                         int(OUT_BIG))

    shmapped = jax.shard_map(_local, mesh=mesh,
                             in_specs=(P(),), out_specs=P("sp"),
                             check_vma=False)
    return jax.jit(shmapped), Gp


def hammings_mesh(genome_seq: np.ndarray, K: int, *,
                  antisense: bool = True, devices=None,
                  node: int = 0, numnodes: int = 1) -> np.ndarray:
    """Run the row-sharded engine over all (or given) devices; same output
    contract as kmer.hammings.hammings_exhaustive (uint16 [G])."""
    devices = devices if devices is not None else jax.devices()
    mesh = Mesh(np.asarray(devices), ("sp",))
    g = np.ascontiguousarray(genome_seq, np.uint8)
    G = len(g)
    out = np.full(G, OUT_BIG, np.uint16)
    if G < K:
        return out[:0] if G == 0 else out
    D = mesh.devices.size
    Gp = _round_up(G, D * PART)
    n_spans = Gp // PART
    lo = (node * n_spans) // numnodes
    hi = ((node + 1) * n_spans) // numnodes
    if hi <= lo:
        return out
    fn, Gp = make_hammings_mesh(mesh, G, K, antisense=antisense,
                                span_lo=lo, span_cnt=hi - lo)
    ext = np.concatenate([g, np.full(Gp + K - G, 0x0F, np.uint8)])
    h = np.asarray(jax.device_get(fn(jnp.asarray(ext))))[:G]
    nvalid = int((h != int(OUT_BIG)).sum())
    if nvalid == 0 or (not antisense and nvalid < 2):
        return out
    return h.astype(np.uint16)
