"""Device-mesh parallel strategies (SURVEY.md §2.5 P1-P5 equivalents).

Axes:
  "dp" — data parallelism over read batches (reference P1: worker threads
         pulling read blocks, KAligner.cpp:10370 ThreadedIterReads).
  "tp" — index shard parallelism (reference P3: suffix-array partitioning,
         SfxArray.h:100 multi-block design / hammings node partitioning).

The sharded align step: reads are split over "dp"; the k-mer LUT + suffix
array are range-partitioned by key over "tp" (each shard resolves only seeds
whose k-mer key falls in its range; the genome itself is replicated since
extension needs random access and costs 1 byte/base vs the SA's 4-5). Shard
candidate sets are disjoint per bucket, so an all_gather over "tp" followed by
the standard finalize reproduces the single-chip result exactly.

Collectives run under shard_map (SURVEY.md §5.8: all_gather replaces the
BKS RPC response merge; no bespoke sockets).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import seed_extend


def make_mesh(dp: int, tp: int = 1, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    if dp * tp > len(devices):
        raise ValueError(f"need {dp * tp} devices, have {len(devices)}")
    arr = np.asarray(devices[: dp * tp]).reshape(dp, tp)
    return Mesh(arr, ("dp", "tp"))


def shard_index_by_key(sa_clean: np.ndarray, lut: np.ndarray, tp: int):
    """Range-partition the k-mer LUT (and its SA entries) into `tp` shards.

    Returns (sa_shards [tp, Mpad], lut_shards [tp, keys_per+1], key_lo [tp]).
    Shard t owns keys [t*keys_per, (t+1)*keys_per); its local LUT is
    rebased so lut_local[0] == 0. SA shards are padded to equal length.
    """
    n_keys = len(lut) - 1
    if n_keys % tp:
        raise ValueError(f"key space {n_keys} not divisible by tp={tp}")
    keys_per = n_keys // tp
    sa_parts, lut_parts, key_lo = [], [], []
    for t in range(tp):
        klo, khi = t * keys_per, (t + 1) * keys_per
        slo, shi = int(lut[klo]), int(lut[khi])
        sa_parts.append(sa_clean[slo:shi])
        lut_parts.append((lut[klo:khi + 1] - slo).astype(lut.dtype))
        key_lo.append(klo)
    mpad = max(len(p) for p in sa_parts)
    sa_shards = np.zeros((tp, mpad), dtype=sa_clean.dtype)
    for t, p_ in enumerate(sa_parts):
        sa_shards[t, : len(p_)] = p_
        # pad with a safely out-of-range position? buckets never point past
        # their shard's entries, so padding content is never dereferenced
        # beyond clipping — keep zeros.
    return sa_shards, np.stack(lut_parts), np.asarray(key_lo, np.int32)


def make_sharded_align_pass(mesh: Mesh, *, genome_len: int, offsets: tuple,
                            lut_k: int, cand_per_window: int,
                            n_compact: int, max_ml: int):
    """Build a jitted dp x tp sharded align pass.

    Args (sharded): gpack/gbad [Gw] replicated; sa_shards [tp, Mpad],
    lut_shards [tp, keys+1], key_lo [tp] split over "tp"; reads [B, L]
    split over "dp". Returns the same stats dict as seed_extend.align_pass,
    sharded over "dp". Matches the single-chip result exactly whenever no
    shard overflows its per-shard compaction (the sharded path can only see
    MORE candidates than a single chip, never fewer).
    """

    def _local(gpack, gbad, sa_s, lut_s, key_lo_s, reads):
        # shapes inside shard_map: sa_s [1, Mpad], lut_s [1, keys+1], ...
        ids, mm, ovf = seed_extend.gather_score_candidates(
            gpack, gbad, sa_s[0], lut_s[0], key_lo_s[0], reads,
            genome_len=genome_len, offsets=offsets, lut_k=lut_k,
            cand_per_window=cand_per_window, n_compact=n_compact)
        # exact cross-shard merge: collect every shard's scored candidates
        ids_all = jax.lax.all_gather(ids, "tp", axis=1, tiled=True)
        mm_all = jax.lax.all_gather(mm, "tp", axis=1, tiled=True)
        out = seed_extend.finalize_candidates(ids_all, mm_all, max_ml=max_ml)
        out["overflow"] = jax.lax.psum(ovf.astype(jnp.int32), "tp") > 0
        return out

    shmapped = jax.shard_map(
        _local, mesh=mesh,
        in_specs=(P(), P(), P("tp", None), P("tp", None), P("tp"),
                  P("dp", None)),
        out_specs={"low_mm": P("dp"), "n_low": P("dp"), "nxt_mm": P("dp"),
                   "hit_id": P("dp", None), "hit_mm": P("dp", None),
                   "overflow": P("dp")},
        check_vma=False)
    return jax.jit(shmapped)


def make_sharded_align_pass_v3(mesh: Mesh, *, genome_len: int,
                               offsets: tuple, lut_k: int, n_compact: int,
                               n_extend: int, max_ml: int):
    """dp x tp sharded pass over the PRODUCTION v3 kernel
    (ops/seed_extend_v3.fast_candidates_v3).

    Args (sharded): gview [Gv, 2*nw2] replicated; sa_shards [tp, Mpad] and
    lut2_shards [tp, keys_per, 2] split over "tp"; key_lo [tp]; reads
    [B, L] split over "dp". Returns the fast_pass_v3 stats dict sharded
    over "dp".

    Exactly-once across shards: a locus is emitted only by the shard owning
    its FIRST exact window's k-mer key — the canonical test recomputes the
    first exact window from the extension's mismatch bits, a global
    property independent of which shard evaluated it (seed_extend_v3
    canonicalisation block) — so the cross-shard merge is a plain
    all_gather concatenation (SURVEY.md §2.5 P3)."""
    from ..ops import seed_extend_v3
    from ..ops.seed_extend_fast import finalize_fast

    def _local(gview, sa_s, lut2_s, key_lo_s, reads):
        ids, mm, ovf = seed_extend_v3.fast_candidates_v3(
            gview, sa_s[0], lut2_s[0], key_lo_s[0], reads,
            genome_len=genome_len, offsets=offsets, lut_k=lut_k,
            n_compact=n_compact, n_extend=n_extend)
        ids_all = jax.lax.all_gather(ids, "tp", axis=0, tiled=True)
        mm_all = jax.lax.all_gather(mm, "tp", axis=0, tiled=True)
        out = finalize_fast(ids_all.T, mm_all.T, max_ml=max_ml)
        out["overflow"] = jax.lax.psum(ovf.astype(jnp.int32), "tp") > 0
        return out

    shmapped = jax.shard_map(
        _local, mesh=mesh,
        in_specs=(P(), P("tp", None), P("tp", None, None), P("tp"),
                  P("dp", None)),
        out_specs={"low_mm": P("dp"), "n_low": P("dp"), "nxt_mm": P("dp"),
                   "hit_id": P("dp", None), "hit_mm": P("dp", None),
                   "overflow": P("dp")},
        check_vma=False)
    return jax.jit(shmapped)


def shard_index_by_key_v3(sa_clean: np.ndarray, lut: np.ndarray, tp: int):
    """shard_index_by_key for the v3 kernel: the per-shard LUT becomes
    (lo, cnt) pair rows [tp, keys_per, 2] int32."""
    sa_shards, lut_shards, key_lo = shard_index_by_key(sa_clean, lut, tp)
    lo = lut_shards[:, :-1].astype(np.int64)
    cnt = lut_shards[:, 1:].astype(np.int64) - lo
    lut2_shards = np.stack([lo, cnt], axis=2).astype(np.int32)
    return sa_shards, lut2_shards, key_lo


def device_put_sharded_index_v3(mesh: Mesh, gview, sa_shards, lut2_shards,
                                key_lo):
    """Place v3 index arrays with their mesh shardings."""
    return (jax.device_put(gview, NamedSharding(mesh, P())),
            jax.device_put(jnp.asarray(sa_shards.astype(np.int32)),
                           NamedSharding(mesh, P("tp", None))),
            jax.device_put(jnp.asarray(lut2_shards),
                           NamedSharding(mesh, P("tp", None, None))),
            jax.device_put(jnp.asarray(key_lo),
                           NamedSharding(mesh, P("tp"))))


def device_put_sharded_index(mesh: Mesh, gpack, gbad, sa_shards, lut_shards,
                             key_lo):
    """Place index arrays with their mesh shardings."""
    gspec = NamedSharding(mesh, P())
    tspec = NamedSharding(mesh, P("tp", None))
    kspec = NamedSharding(mesh, P("tp"))
    return (jax.device_put(jnp.asarray(gpack), gspec),
            jax.device_put(jnp.asarray(gbad), gspec),
            jax.device_put(jnp.asarray(sa_shards), tspec),
            jax.device_put(jnp.asarray(lut_shards.astype(np.int32)), tspec),
            jax.device_put(jnp.asarray(key_lo), kspec))


def make_sharded_align_pass_v4(mesh: Mesh, *, genome_len: int,
                               offsets: tuple, lut_k: int, read_len: int,
                               n_compact: int, n_extend: int, max_ml: int):
    """dp x tp sharded pass over the PRODUCTION v4 packed-native kernel
    (ops/seed_extend_v4._cands_core_v4).

    Args (sharded): gview [Gv, 2*nw2] replicated; sa_shards [tp, Mpad] /
    lut2_shards [tp, keys_per, 2] / key_lo [tp] over "tp"; reads2b
    [B, ceil(L/4)] uint8 and nlist [K, 2] int32 split over "dp" (nlist
    read indices are LOCAL to the dp shard). Returns the fast_pass stats
    dict sharded over "dp".

    The exactly-once guarantee is v3's unchanged: v4 keeps big-endian
    (lexicographic) seed keys, so key-range ownership and the
    first-exact-window canonical test are bit-identical
    (seed_extend_v4 module docstring)."""
    from ..ops import seed_extend_v4
    from ..ops.seed_extend_fast import finalize_fast

    def _local(gview, sa_s, lut2_s, key_lo_s, reads2b, nlist):
        planes = seed_extend_v4.words_from_2bit(reads2b, nlist, read_len)
        ids, mm, ovf = seed_extend_v4._cands_core_v4(
            gview, sa_s[0], lut2_s[0], key_lo_s[0], planes,
            genome_len=genome_len, offsets=offsets, lut_k=lut_k,
            read_len=read_len, n_compact=n_compact, n_extend=n_extend)
        ids_all = jax.lax.all_gather(ids, "tp", axis=0, tiled=True)
        mm_all = jax.lax.all_gather(mm, "tp", axis=0, tiled=True)
        out = finalize_fast(ids_all.T, mm_all.T, max_ml=max_ml)
        out["overflow"] = jax.lax.psum(ovf.astype(jnp.int32), "tp") > 0
        return out

    shmapped = jax.shard_map(
        _local, mesh=mesh,
        in_specs=(P(), P("tp", None), P("tp", None, None), P("tp"),
                  P("dp", None), P("dp", None)),
        out_specs={"low_mm": P("dp"), "n_low": P("dp"), "nxt_mm": P("dp"),
                   "hit_id": P("dp", None), "hit_mm": P("dp", None),
                   "overflow": P("dp")},
        check_vma=False)
    return jax.jit(shmapped)


def pack_reads_sharded(reads: np.ndarray, dp: int):
    """Host-side packing for the v4 sharded pass: [B, L] codes -> 2-bit
    [B, ceil(L/4)] + per-dp-shard-local N lists stacked [B? no, dp*K, 2].

    Each dp shard's nlist indices must be local to its rows, so the batch
    is packed per shard and the nlists concatenated in shard order."""
    from ..align.kalign import pack_reads_2bit
    B = reads.shape[0]
    if B % dp:
        raise ValueError(f"batch {B} not divisible by dp={dp}")
    per = B // dp
    packed, nlists = [], []
    for d in range(dp):
        p, nl, ok = pack_reads_2bit(reads[d * per:(d + 1) * per])
        if not ok:
            raise ValueError("too many Ns for the packed path")
        packed.append(p)
        nlists.append(nl)
    return np.concatenate(packed), np.concatenate(nlists)


def shard_index_by_position(index, tp: int, read_len: int):
    """POSITION-range sharding — the P3 completion for multi-Gbp genomes
    (SURVEY.md §2.5 P3; VERDICT r3 item 7). Key-range sharding
    (shard_index_by_key*) still replicates the genome on every tp shard
    because extension needs random access; here shard t instead owns the
    genome block [t*G/tp, (t+1)*G/tp):

      * gview block covers the shard's rows plus a read-length halo on
        both sides (window offsets reach below a block boundary and
        extension reaches past it) — per-device genome residency is
        O(G/tp + L), not O(G);
      * the clean suffix array is PARTITIONED BY POSITION: shard t keeps
        the sa entries pointing into its block (global positions, key
        order preserved by the stable filter), with a full-key-space
        local (lo, cnt) pair table over its own entries;
      * every shard evaluates the full read batch against its block.
        Each genome locus belongs to exactly one shard and the
        first-exact-window canonical test is a global property computed
        identically everywhere (halo provides full extension context),
        so cross-shard emission is exactly-once and the merge is a plain
        all_gather — the same argument as the key-range sharding, now
        with O(G/tp) residency.

    Returns (gview_blocks [tp, Gvb, 2*nw2] uint32, base [tp] int32
    16-aligned global row-0 positions, sa_shards [tp, Mpad] int32 GLOBAL
    positions, lut2_shards [tp, n_keys, 2] int32). Matches the
    reference's >4 Gbp capacity class (libkit4b/SfxArray.cpp:906-909
    5-byte suffix elements) with int32 local indices."""
    from ..ops.extend_packed import pack_genome
    from ..ops.seed_extend_fast import make_gview
    g = index.genome
    G = len(g.seq)
    L = read_len
    nw2 = (L + 15) // 16 + 1
    k = index.lut_k
    n_keys = len(index.lut) - 1
    sa = index.sa_clean.astype(np.int64)
    # recompute each clean suffix's key to histogram per-shard luts
    dm = np.arange(4, dtype=np.int64)
    keys = np.zeros(len(sa), np.int64)
    for j in range(k):
        keys = keys * 4 + dm[g.seq[sa + j]]
    per = -(-G // tp)
    halo = ((L + 15) // 16 + nw2) * 16
    gv_list, base_list, sa_list, lut2_list = [], [], [], []
    for t in range(tp):
        blo, bhi = t * per, min((t + 1) * per, G)
        base = max(0, (blo - halo) & ~15)
        gend = min(G, bhi + halo)
        gpack, gbad = pack_genome(g.seq[base:gend], nw2 + 1)
        gv_list.append(make_gview(gpack, gbad, nw2))
        base_list.append(base)
        inb = (sa >= blo) & (sa < bhi)
        sa_t = sa[inb]
        keys_t = keys[inb]
        lut_t = np.searchsorted(keys_t, np.arange(n_keys + 1))
        lo = lut_t[:-1]
        cnt = lut_t[1:] - lo
        sa_list.append(sa_t.astype(np.int32))
        lut2_list.append(np.stack([lo, cnt], axis=1).astype(np.int32))
    gvb = max(x.shape[0] for x in gv_list)
    mpad = max(len(x) for x in sa_list)
    gview_blocks = np.zeros((tp, gvb, 2 * nw2), np.uint32)
    sa_shards = np.zeros((tp, mpad), np.int32)
    for t in range(tp):
        gview_blocks[t, :gv_list[t].shape[0]] = gv_list[t]
        # pad rows mark every base invalid so they can never match
        gview_blocks[t, gv_list[t].shape[0]:, nw2:] = 0xFFFFFFFF
        sa_shards[t, :len(sa_list[t])] = sa_list[t]
    return (gview_blocks, np.asarray(base_list, np.int32), sa_shards,
            np.stack(lut2_list))


def make_sharded_align_pass_pos(mesh: Mesh, *, genome_len: int,
                                offsets: tuple, lut_k: int, read_len: int,
                                n_compact: int, n_extend: int,
                                max_ml: int):
    """dp x tp sharded pass over POSITION-sharded genome blocks
    (shard_index_by_position): per-device residency O(G/tp). Sharded
    args: gview_blocks [tp, Gvb, 2nw2], base [tp], sa_shards [tp, Mpad],
    lut2_shards [tp, n_keys, 2] over "tp"; reads2b/nlist over "dp"."""
    from ..ops import seed_extend_v4
    from ..ops.seed_extend_fast import finalize_fast

    def _local(gview_b, base_s, sa_s, lut2_s, reads2b, nlist):
        planes = seed_extend_v4.words_from_2bit(reads2b, nlist, read_len)
        ids, mm, ovf = seed_extend_v4._cands_core_v4(
            gview_b[0], sa_s[0], lut2_s[0], jnp.int32(0), planes,
            genome_len=genome_len, offsets=offsets, lut_k=lut_k,
            read_len=read_len, n_compact=n_compact, n_extend=n_extend,
            gview_base=base_s[0])
        ids_all = jax.lax.all_gather(ids, "tp", axis=0, tiled=True)
        mm_all = jax.lax.all_gather(mm, "tp", axis=0, tiled=True)
        out = finalize_fast(ids_all.T, mm_all.T, max_ml=max_ml)
        out["overflow"] = jax.lax.psum(ovf.astype(jnp.int32), "tp") > 0
        return out

    shmapped = jax.shard_map(
        _local, mesh=mesh,
        in_specs=(P("tp", None, None), P("tp"), P("tp", None),
                  P("tp", None, None), P("dp", None), P("dp", None)),
        out_specs={"low_mm": P("dp"), "n_low": P("dp"), "nxt_mm": P("dp"),
                   "hit_id": P("dp", None), "hit_mm": P("dp", None),
                   "overflow": P("dp")},
        check_vma=False)
    return jax.jit(shmapped)


def make_sharded_pe_pass_pos(mesh: Mesh, *, genome_len: int,
                             offsets: tuple, lut_k: int, read_len: int,
                             n_compact: int, n_extend: int, max_ml: int,
                             max_tot: int, mm_delta: int, min_ins: int,
                             max_ins: int):
    """dp x tp sharded PAIRED-END pass over POSITION-sharded genome
    blocks — the multi-chip story for the flagship PE workload
    (VERDICT r4 missing #2; reference ProcessPairedEnds under node
    partitioning, ngskit4b/KAligner.cpp:2944 + the hammings-style
    partitioning precedent, hammings.cpp:99-106).

    Both mates' candidates are produced per genome shard (exactly-once:
    each locus lives in one shard's block, halo supplies full extension
    context), all_gathered over "tp", finalized, and paired with the
    AcceptProvPE cross-product ON EVERY dp SHARD — pairing needs both
    mates' global hit lists, so it runs after the tp merge; the result
    rows are sharded over "dp" only. Output: [B/dp, 12] int32 rows per
    dp shard (align/pe.py layout; not wire-packed).

    Non-overflow rows match the single-chip pe_pass_packed rows
    bit-identically (same finalize inputs after the tp merge)."""
    from ..ops import seed_extend_v4
    from ..ops.pe_packed import _pair_rows
    from ..ops.seed_extend_fast import finalize_fast

    def _mate(gview_b, base_s, sa_s, lut2_s, r2b, nl):
        planes = seed_extend_v4.words_from_2bit(r2b, nl, read_len)
        ids, mm, ovf = seed_extend_v4._cands_core_v4(
            gview_b[0], sa_s[0], lut2_s[0], jnp.int32(0), planes,
            genome_len=genome_len, offsets=offsets, lut_k=lut_k,
            read_len=read_len, n_compact=n_compact, n_extend=n_extend,
            gview_base=base_s[0])
        ids_all = jax.lax.all_gather(ids, "tp", axis=0, tiled=True)
        mm_all = jax.lax.all_gather(mm, "tp", axis=0, tiled=True)
        f = finalize_fast(ids_all.T, mm_all.T, max_ml=max_ml)
        return f, jax.lax.psum(ovf.astype(jnp.int32), "tp") > 0

    def _local(gview_b, base_s, sa_s, lut2_s, starts, r2b1, nl1, r2b2,
               nl2):
        f1, ovf1 = _mate(gview_b, base_s, sa_s, lut2_s, r2b1, nl1)
        f2, ovf2 = _mate(gview_b, base_s, sa_s, lut2_s, r2b2, nl2)
        return _pair_rows(f1, f2, ovf1, ovf2, starts, L1=read_len,
                          L2=read_len, max_tot=max_tot, mm_delta=mm_delta,
                          min_ins=min_ins, max_ins=max_ins)

    shmapped = jax.shard_map(
        _local, mesh=mesh,
        in_specs=(P("tp", None, None), P("tp"), P("tp", None),
                  P("tp", None, None), P(),
                  P("dp", None), P("dp", None),
                  P("dp", None), P("dp", None)),
        out_specs=P("dp", None),
        check_vma=False)
    return jax.jit(shmapped)


def make_sharded_deep_pe_pass_pos(mesh: Mesh, *, genome_len: int,
                                  offsets: tuple, lut_k: int,
                                  read_len: int, n_blocks: int,
                                  block_size: int, max_ml: int,
                                  max_tot: int, mm_delta: int,
                                  min_ins: int, max_ins: int,
                                  skip_bucket: int = 5000,
                                  n_sel: int | None = 4):
    """Position-sharded deep escalation tier: both mates take the capped
    deep exploration against each genome shard's block, candidates
    all_gather over "tp", finalize + AcceptProvPE pairing per dp shard.
    Exactly-once across shards holds because each locus lives in ONE
    shard's block (the per-shard rarest-K explored sets may differ, but
    only the owning shard can emit a locus). Per-bucket caps apply to
    SHARD-LOCAL bucket counts, so the union explores at least the
    single-device capped candidate set — the sharded deep tier is
    never less sensitive than one chip."""
    from ..ops.pe_packed import _pair_rows
    from ..ops.seed_extend_deep import deep_cands_planes
    from ..ops.seed_extend_fast import finalize_fast
    from ..ops.seed_extend_v4 import words_from_2bit

    def _mate(gview_b, base_s, sa_s, lut2_s, r2b, nl):
        planes = words_from_2bit(r2b, nl, read_len)
        ids, mm = deep_cands_planes(
            gview_b[0], sa_s[0], lut2_s[0], planes,
            genome_len=genome_len, offsets=offsets, lut_k=lut_k,
            read_len=read_len, n_blocks=n_blocks, block_size=block_size,
            skip_bucket=skip_bucket, n_sel=n_sel, gview_base=base_s[0])
        ids_all = jax.lax.all_gather(ids, "tp", axis=0, tiled=True)
        mm_all = jax.lax.all_gather(mm, "tp", axis=0, tiled=True)
        return finalize_fast(ids_all.T, mm_all.T, max_ml=max_ml)

    def _local(gview_b, base_s, sa_s, lut2_s, starts, r2b1, nl1, r2b2,
               nl2):
        f1 = _mate(gview_b, base_s, sa_s, lut2_s, r2b1, nl1)
        f2 = _mate(gview_b, base_s, sa_s, lut2_s, r2b2, nl2)
        no = jnp.zeros(f1["low_mm"].shape[0], bool)
        return _pair_rows(f1, f2, no, no, starts, L1=read_len,
                          L2=read_len, max_tot=max_tot, mm_delta=mm_delta,
                          min_ins=min_ins, max_ins=max_ins)

    shmapped = jax.shard_map(
        _local, mesh=mesh,
        in_specs=(P("tp", None, None), P("tp"), P("tp", None),
                  P("tp", None, None), P(),
                  P("dp", None), P("dp", None),
                  P("dp", None), P("dp", None)),
        out_specs=P("dp", None),
        check_vma=False)
    return jax.jit(shmapped)


def shard_index_by_key_v5(sa_clean: np.ndarray, lut: np.ndarray, tp: int):
    """shard_index_by_key for the v5 flattened kernel: per-shard lut4
    rows [tp, keys_per, 8] = [sa[lo..lo+6] (global positions), cnt].
    Positions are global genome loci, so cross-shard merge semantics are
    unchanged; only bucket ownership (key ranges) is sharded."""
    from ..ops.seed_extend_v5 import P_POS
    sa_shards, lut_shards, key_lo = shard_index_by_key(sa_clean, lut, tp)
    l4 = []
    for t in range(tp):
        lo = lut_shards[t, :-1].astype(np.int64)
        cnt = (lut_shards[t, 1:].astype(np.int64) - lo)
        sa_s = sa_shards[t].astype(np.int64)
        m = len(sa_s)
        # m == 0 (a shard owning zero suffixes — tiny genomes / skewed key
        # ranges at large tp): cnt is all zero so the position columns are
        # never dereferenced; emit a zero block instead of indexing empty
        cols = [sa_s[np.clip(lo + p, 0, max(m - 1, 0))] if m
                else np.zeros_like(lo) for p in range(P_POS)]
        l4.append(np.stack(cols + [cnt], axis=1).astype(np.int32))
    return sa_shards, np.stack(l4), key_lo


def device_put_sharded_index_v5(mesh: Mesh, gview, lut4_shards, key_lo):
    """Place v5 index arrays with their mesh shardings."""
    return (jax.device_put(gview, NamedSharding(mesh, P())),
            jax.device_put(jnp.asarray(lut4_shards),
                           NamedSharding(mesh, P("tp", None, None))),
            jax.device_put(jnp.asarray(key_lo),
                           NamedSharding(mesh, P("tp"))))


def make_sharded_align_pass_v5(mesh: Mesh, *, genome_len: int,
                               offsets: tuple, lut_k: int, read_len: int,
                               n_compact: int, n_extend: int, max_ml: int):
    """dp x tp sharded pass over the v5 flattened-index kernel
    (ops/seed_extend_v5._cands_core_v5) — the production tier-1 on
    clean indexes.

    Args (sharded): gview replicated; lut4_shards [tp, keys_per, 8] and
    key_lo [tp] over "tp"; reads2b/nlist over "dp" (nlist indices local to
    the dp shard). The exactly-once guarantee is v4's unchanged (big-endian
    keys, first-exact-window canonical test); reads whose seed buckets
    exceed P_POS inline positions are flagged overflow (psum over "tp") and
    escalate through the caller's ladder, exactly as on one chip."""
    from ..ops import seed_extend_v4, seed_extend_v5
    from ..ops.seed_extend_fast import finalize_fast

    def _local(gview, lut4_s, key_lo_s, reads2b, nlist):
        planes = seed_extend_v4.words_from_2bit(reads2b, nlist, read_len)
        ids, mm, ovf = seed_extend_v5._cands_core_v5(
            gview, lut4_s[0], key_lo_s[0], planes,
            genome_len=genome_len, offsets=offsets, lut_k=lut_k,
            read_len=read_len, n_compact=n_compact, n_extend=n_extend)
        ids_all = jax.lax.all_gather(ids, "tp", axis=0, tiled=True)
        mm_all = jax.lax.all_gather(mm, "tp", axis=0, tiled=True)
        out = finalize_fast(ids_all.T, mm_all.T, max_ml=max_ml)
        out["overflow"] = jax.lax.psum(ovf.astype(jnp.int32), "tp") > 0
        return out

    shmapped = jax.shard_map(
        _local, mesh=mesh,
        in_specs=(P(), P("tp", None, None), P("tp"),
                  P("dp", None), P("dp", None)),
        out_specs={"low_mm": P("dp"), "n_low": P("dp"), "nxt_mm": P("dp"),
                   "hit_id": P("dp", None), "hit_mm": P("dp", None),
                   "overflow": P("dp")},
        check_vma=False)
    return jax.jit(shmapped)
