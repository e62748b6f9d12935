"""Ring-rotation hammings: mesh-relative memory via `ppermute`.

`parallel/hammings_mesh.py` shards the *own-window rows* but replicates
the full partner one-hot on every device — fine up to tens of Mbp, but
the per-device footprint grows with the whole genome. This module is the
SURVEY.md §5.7-prescribed ring formulation (the stationary-query /
rotating-KV pattern of ring attention, applied to the reference's
offset-sweep decomposition, ngskit4b/hammings.cpp:3183-3289):

- each device holds ONE genome block of raw 2-bit codes (+K halo) for
  both strands — O(G/D) per device, so capacity scales with mesh size;
- the partner *code blocks* rotate around the "sp" ring via
  `jax.lax.ppermute` (codes are ~25x smaller than the window one-hot,
  so the traffic between devices per step is B+K bytes, not B*5K);
- every step rebuilds the partner window one-hot locally (a gather +
  compare) and feeds the same `max_matches` as the replicated engine
  (`kmer/hammings_mxu.py`), accumulating the running min-Hamming;
- the self-pair diagonal only exists on step 0 (partner block == own
  block), where the local diagonal IS the global diagonal, so the
  unmodified static-diag kernels apply: step 0 runs diag=True, the
  D-1 rotated steps run diag=False.

Output contract matches `hammings_exhaustive_mxu` bit-for-bit (uint16
[G], 0xFFFF where no valid window) — asserted on 2/4/8-device CPU
meshes in tests/test_hammings_ring.py.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..kmer.hammings_mxu import (OUT_BIG, PART, _round_up, max_matches,
                                 max_matches_impl)


def _block_onehot(codes: jnp.ndarray, K: int, B: int):
    """Window one-hot for one code block. codes: [B+K] uint8 (own block
    plus K halo codes from the successor block). Returns (W [B, C] int8
    with invalid windows zeroed, valid [B] bool). Mirrors
    hammings_mxu._window_onehot_dev exactly (channel c = (k=c//5,
    b=c%5); sentinel = code >= 5) so the ring output is bit-identical
    to the replicated engine."""
    C = _round_up(5 * K, 128)
    win = jnp.stack([jax.lax.dynamic_slice_in_dim(codes, k, B)
                     for k in range(K)], axis=1)            # [B, K]
    kidx = np.minimum(np.arange(C) // 5, K - 1)
    bval = np.where(np.arange(C) < 5 * K, np.arange(C) % 5, 255)
    W = (jnp.take(win, jnp.asarray(kidx), axis=1)
         == jnp.asarray(bval, codes.dtype)[None, :]).astype(jnp.int8)
    sent = (codes >= 5).astype(jnp.int32)
    cs = jnp.concatenate([jnp.zeros(1, jnp.int32), jnp.cumsum(sent)])
    nbad = jax.lax.dynamic_slice_in_dim(cs, K, B) - cs[:B]
    valid = nbad == 0
    return W * valid[:, None].astype(jnp.int8), valid


def make_hammings_ring(mesh: Mesh, G: int, K: int, *,
                       antisense: bool = True):
    """Build the jitted ring engine.

    Input: (sense_blocks [D, B+K] uint8, rc_blocks [D, B+K] uint8),
    each sharded P("sp") — see hammings_ring() for the host-side block
    slicing. Output: hmin [D*B] int32 (min window-Hamming per genome
    position, pre-validity-mask; host applies the OUT_BIG mask)."""
    D = mesh.devices.size
    B = _round_up(-(-max(G, 1) // D), PART)
    impl = max_matches_impl()
    perm = [(j, (j - 1) % D) for j in range(D)]   # device i receives i+1
    zero = np.zeros(1, np.int32)

    def _pair_min(Wo, codes_pair, diag: bool):
        """min-Hamming of own rows vs both strands of a partner code
        block. diag only applies to the sense strand (rc windows of the
        same block never alias an own window)."""
        Wp, _ = _block_onehot(codes_pair[0], K, B)
        parts = [(Wp, diag)]
        if antisense:
            Wrc, _ = _block_onehot(codes_pair[1], K, B)
            parts.append((Wrc, False))
        maxm = None
        for W_part, dg in parts:
            m = max_matches(Wo, W_part, part_lo=0, part_cnt=B, diag=dg,
                            row_base=zero, impl=impl)
            maxm = m if maxm is None else jnp.maximum(maxm, m)
        return K - maxm

    def _local(sb, rb):
        # shapes inside shard_map: [1, B+K] each
        Wo, _ = _block_onehot(sb[0], K, B)
        # step 0: partner block == own block -> local diag is global diag
        h = _pair_min(Wo, (sb[0], rb[0]), diag=True)

        def body(_, carry):
            h, cp = carry
            cp = jax.lax.ppermute(cp, "sp", perm)
            h = jnp.minimum(h, _pair_min(Wo, (cp[0], cp[1]), diag=False))
            return h, cp

        h, _ = jax.lax.fori_loop(
            0, D - 1, body, (h, jnp.stack([sb[0], rb[0]])))
        return h

    shmapped = jax.shard_map(_local, mesh=mesh,
                             in_specs=(P("sp"), P("sp")),
                             out_specs=P("sp"), check_vma=False)
    return jax.jit(shmapped), B


def hammings_ring(genome_seq: np.ndarray, K: int, *,
                  antisense: bool = True, devices=None) -> np.ndarray:
    """Ring-parallel exhaustive hammings. Same output contract as
    kmer.hammings_mxu.hammings_exhaustive_mxu (uint16 [G])."""
    devices = devices if devices is not None else jax.devices()
    mesh = Mesh(np.asarray(devices), ("sp",))
    D = mesh.devices.size
    g = np.ascontiguousarray(genome_seq, np.uint8)
    G = len(g)
    out = np.full(G, OUT_BIG, np.uint16)
    if G - K + 1 <= 0:
        return out
    B = _round_up(-(-G // D), PART)
    Gp = B * D

    ext = np.concatenate([g, np.full(Gp + K - G, 0x0F, np.uint8)])
    rcg = np.where(g < 4, 3 - g, g)[::-1]
    rc_ext = np.concatenate([rcg, np.full(Gp + K - G, 0x0F, np.uint8)])
    sense_blocks = np.stack([ext[i * B: i * B + B + K] for i in range(D)])
    rc_blocks = np.stack([rc_ext[i * B: i * B + B + K] for i in range(D)])

    # validity (host): sentinel-run + tail bound — identical to the
    # replicated engine's `valid` (hammings_mxu._window_onehot_dev)
    sent = (ext[:Gp + K] >= 5).astype(np.int64)
    cs = np.concatenate([[0], np.cumsum(sent)])
    nbad = cs[K: Gp + K] - cs[:Gp]
    valid = (nbad == 0) & (np.arange(Gp) < G - K + 1)
    nvalid = int(valid.sum())
    if nvalid == 0 or (not antisense and nvalid < 2):
        return out

    fn, B = make_hammings_ring(mesh, G, K, antisense=antisense)
    sh = NamedSharding(mesh, P("sp"))
    hmin = np.asarray(jax.device_get(fn(
        jax.device_put(sense_blocks, sh), jax.device_put(rc_blocks, sh))))
    h = np.where(valid[:G], np.minimum(hmin[:G], int(OUT_BIG)),
                 int(OUT_BIG))
    return h.astype(np.uint16)
