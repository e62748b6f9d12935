"""Batched seed-and-extend alignment pass — the device hot path of kalign.

Replaces the reference's per-read, per-core-window suffix-array walk
(libkit4b/SfxArray.cpp:5806 LocateCoreMultiples + :7938 LocateFirstExact):

  reference (scalar CPU)                 this module (vector device)
  -------------------------------------  -----------------------------------
  binary search per core window          direct-addressed k-mer LUT gather
  iterate <=MaxIter SA entries per core  fixed C candidates per core (masked)
  per-candidate left/right byte extend   packed-word gather + XOR/popcount
  tsIdentNode hash dedup of loci         per-read sort + adjacent-equal mask
  best/next-best MM bookkeeping          masked min / count / second-min

Pipeline per pass (one jit-compiled executable per read length):
  1. seed lookup  — k-mer keys for every (strand, core window) resolve to SA
     bucket ranges through the LUT; up to C candidate positions per bucket.
  2. compaction   — candidate ids (pos*2+strand) sorted per read; the first
     NC columns hold every real candidate for all but pathological repeat
     reads (overflow flagged, classified multi — the analog of the
     reference's MaxIter truncation, ngskit4b/KAligner.h:53-56).
  3. extension    — 2-bit-packed mismatch scoring (ops/extend_packed.py):
     NW word gathers + XOR/popcount instead of an L-byte gather per
     candidate.
  4. finalize     — cross-candidate dedup, best/next-best, top-k hits.

Index sharding (SURVEY.md §2.5 P3): the k-mer LUT is range-partitioned by key;
a shard holding keys [key_lo, key_lo + lut_len - 1) resolves only seeds in its
range. Shard candidate sets are disjoint per bucket, so all-gathering the
compacted per-shard candidates and finalizing reproduces the single-chip
result (byte-identical whenever no shard overflows its NC compaction).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import extend_packed

INT32_MAX = jnp.iinfo(jnp.int32).max


def revcomp_device(reads: jnp.ndarray) -> jnp.ndarray:
    """Reverse-complement uint8 code reads on device (N and sentinels fixed)."""
    comp = jnp.where(reads < 4, 3 - reads, reads)
    return comp[..., ::-1]


def gather_score_candidates(gpack: jnp.ndarray,   # [Gw] packed genome
                            gbad: jnp.ndarray,    # [Gw] packed invalid mask
                            sa: jnp.ndarray,      # [M] int32 suffix positions
                            lut: jnp.ndarray,     # [lut_len] bucket starts
                            key_lo: jnp.ndarray,  # scalar: first key of shard
                            reads: jnp.ndarray,   # [B, L] uint8 codes
                            *,
                            genome_len: int,
                            offsets: tuple,
                            lut_k: int,
                            cand_per_window: int,
                            n_compact: int,
                            reads_have_ns: bool = True):
    """Stages 1-3. Returns (ids, mm, overflow):
    ids [B, NC] int32 pos*2+strand sorted ascending (INT32_MAX invalid),
    mm [B, NC] int32 mismatch counts, overflow [B] bool (candidates truncated).
    """
    B, L = reads.shape
    G = genome_len
    M = sa.shape[0]
    C = cand_per_window
    NC = n_compact
    W = len(offsets)
    k = lut_k
    nw = (L + 30) // 16
    n_keys = lut.shape[0] - 1

    seqs = jnp.stack([reads, revcomp_device(reads)], axis=1)  # [B, 2, L]

    # --- 1. seed lookup ----------------------------------------------------
    offs = (jnp.asarray(offsets, jnp.int32)[:, None]
            + jnp.arange(k, dtype=jnp.int32)[None, :])          # [W, k]
    bases = seqs[:, :, offs]                                     # [B,2,W,k]
    pow4 = (jnp.uint32(1) << (2 * jnp.arange(k - 1, -1, -1,
                                             dtype=jnp.uint32))).astype(
                                                 jnp.int32)
    keys = jnp.sum(jnp.where(bases < 4, bases, 0).astype(jnp.int32)
                   * pow4, axis=-1, dtype=jnp.int32)             # [B,2,W]
    key_ok = jnp.all(bases < 4, axis=-1)

    local = keys - key_lo.astype(jnp.int32)
    in_shard = (local >= 0) & (local < n_keys)
    local = jnp.clip(local, 0, n_keys - 1)
    lo = lut[local]
    hi = lut[local + 1]
    cnt = jnp.where(key_ok & in_shard, jnp.minimum(hi - lo, C), 0)

    cidx = lo[..., None] + jnp.arange(C, dtype=jnp.int32)        # [B,2,W,C]
    cvalid = jnp.arange(C, dtype=jnp.int32) < cnt[..., None]
    sa_pos = sa[jnp.clip(cidx, 0, M - 1)].astype(jnp.int32)
    off_arr = jnp.asarray(offsets, dtype=jnp.int32)[None, None, :, None]
    pos = sa_pos - off_arr                                       # read start
    valid = cvalid & (pos >= 0) & (pos + L <= G)
    strand_arr = jnp.arange(2, dtype=jnp.int32)[None, :, None, None]
    cand_id = jnp.where(valid, pos * 2 + strand_arr,
                        INT32_MAX).reshape(B, 2 * W * C)

    # --- 2. compaction -----------------------------------------------------
    ids_full = jnp.sort(cand_id, axis=1)
    n_real = jnp.sum(ids_full != INT32_MAX, axis=1, dtype=jnp.int32)
    overflow = n_real > NC
    if ids_full.shape[1] < NC:   # short reads: fewer candidates than NC
        ids_full = jnp.pad(ids_full, ((0, 0),
                                      (0, NC - ids_full.shape[1])),
                           constant_values=INT32_MAX)
    ids = jax.lax.slice_in_dim(ids_full, 0, NC, axis=1)          # [B, NC]
    dup = jnp.concatenate(
        [jnp.zeros((B, 1), dtype=bool), ids[:, 1:] == ids[:, :-1]], axis=1)
    ok = (ids != INT32_MAX) & ~dup

    # --- 3. packed extension ----------------------------------------------
    rpack, rbad = extend_packed.pack_read_phases(
        seqs, nw, with_bad=reads_have_ns)
    pmask = jnp.asarray(extend_packed.phase_masks(L, nw))
    pos_s = jnp.where(ok, ids >> 1, 0)
    strand_s = (ids & 1).astype(jnp.int32)
    mm = extend_packed.extend_packed(gpack, gbad, rpack, rbad, pmask,
                                     pos_s, strand_s, read_len=L)
    mm = jnp.where(ok, mm, INT32_MAX)
    ids = jnp.where(ok, ids, INT32_MAX)
    return ids, mm, overflow


def finalize_candidates(ids: jnp.ndarray, mm: jnp.ndarray, *, max_ml: int,
                        presorted: bool = False):
    """Stage 4: dedup (cross-shard) + best/next-best/top-k.

    ids/mm: [B, N] int32, INT32_MAX = invalid. Duplicated ids (same alignment
    reached via different shards) carry identical mm and are masked.
    presorted=True skips the id sort (single-shard path: compaction already
    sorted and deduped).
    """
    B = ids.shape[0]
    if presorted:
        ids_s, mm_s = ids, mm
        ok = ids_s != INT32_MAX
    else:
        order = jnp.argsort(ids, axis=1)
        ids_s = jnp.take_along_axis(ids, order, axis=1)
        mm_s = jnp.take_along_axis(mm, order, axis=1)
        dup = jnp.concatenate(
            [jnp.zeros((B, 1), dtype=bool),
             ids_s[:, 1:] == ids_s[:, :-1]], axis=1)
        ok = (ids_s != INT32_MAX) & ~dup
        mm_s = jnp.where(ok, mm_s, INT32_MAX)

    low = jnp.min(mm_s, axis=1)                                  # [B]
    is_low = (mm_s == low[:, None]) & ok
    n_low = jnp.sum(is_low, axis=1, dtype=jnp.int32)
    nxt = jnp.min(jnp.where(mm_s > low[:, None], mm_s, INT32_MAX), axis=1)

    hit_order = jnp.argsort(mm_s, axis=1, stable=True)[:, :max_ml]
    hit_id = jnp.take_along_axis(ids_s, hit_order, axis=1)
    hit_mm = jnp.take_along_axis(mm_s, hit_order, axis=1)
    hit_id = jnp.where(hit_mm == INT32_MAX, INT32_MAX, hit_id)

    return {"low_mm": low, "n_low": n_low, "nxt_mm": nxt,
            "hit_id": hit_id, "hit_mm": hit_mm}


@functools.partial(
    jax.jit, static_argnames=("genome_len", "offsets", "lut_k",
                              "cand_per_window", "n_compact", "max_ml",
                              "reads_have_ns"))
def align_pass(gpack: jnp.ndarray, gbad: jnp.ndarray, sa: jnp.ndarray,
               lut: jnp.ndarray, reads: jnp.ndarray, *, genome_len: int,
               offsets: tuple, lut_k: int, cand_per_window: int,
               n_compact: int, max_ml: int, reads_have_ns: bool = True):
    """Single-device pass over a read batch, both strands.

    Returns dict of per-read arrays:
      low_mm   [B] int32  — lowest full-read mismatch count (INT32_MAX if none)
      n_low    [B] int32  — deduped loci count at low_mm
      nxt_mm   [B] int32  — next-lowest distinct mismatch count
      hit_id   [B, max_ml] int32 — best hits as pos*2+strand, (mm, pos) order
      hit_mm   [B, max_ml] int32
      overflow [B] bool   — candidate list truncated (classify as multi)
    """
    ids, mm, overflow = gather_score_candidates(
        gpack, gbad, sa, lut, jnp.int32(0), reads, genome_len=genome_len,
        offsets=offsets, lut_k=lut_k, cand_per_window=cand_per_window,
        n_compact=n_compact, reads_have_ns=reads_have_ns)
    out = finalize_candidates(ids, mm, max_ml=max_ml, presorted=True)
    out["overflow"] = overflow
    return out
