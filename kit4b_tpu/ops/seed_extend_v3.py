"""Round-3 kalign device hot path: gather-minimal, lane-major seed-extend.

Produces results IDENTICAL to ops/seed_extend_fast (same seeds, compaction
order, locus set, mismatch counts, classification) but re-engineered around
two cost rules of XLA gathers and elementwise work:

  1. a gather costs per INDEX plus per gathered element, regardless of
     table size -> minimise gather indices AND gathered elements, never
     loop word-wise gathers;
  2. elementwise work is cheapest when the minor dim is wide -> every
     elementwise tensor here is [..., B] (lane-major), vs round 2's
     [B, 12..24] shapes.

Design deltas vs seed_extend_fast.fast_candidates:
  *  LUT bucket (lo, cnt) pairs ride ONE row-gather (lut2 [keys, 2]) instead
     of two scalar gathers      (12 vs 24 indices/read)
  *  candidates are DEDUPLICATED BY LOCUS before extension: the first slot
     holding a given (pos, strand) is provably the first-exact-window
     canonical copy (a slot exists iff its seed window matches exactly), so
     extending only first copies yields the same ids/mm set while cutting
     extension row-gathers from NC=24 to NS~8 per read
  *  the extension context row is fetched with one [NS, B]-indexed gather
     from the materialised genome row view (per-row cost dominates; width
     is cheap)

Reference parity anchors: CSfxArray::LocateCoreMultiples inner loop
(libkit4b/SfxArray.cpp:5806), CKAligner::AlignRead
(ngskit4b/KAligner.cpp:9583), sensitivity/MaxIter ladder
(ngskit4b/KAligner.h:53-56).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .seed_extend_fast import fast_offsets, _tail_mask  # shared, same math

INT32_MAX = np.int32(np.iinfo(np.int32).max)
MISM_BITS = np.uint32(0x55555555)


def make_lut2_device(lut) -> jnp.ndarray:
    """[n_keys, 2] int32 (bucket_lo, bucket_cnt) pair table, so one
    row-gather resolves a seed window (vs two scalar gathers).

    Accepts the host lut or an ALREADY-UPLOADED device lut array; the pair
    table is built on device either way (the [n_keys, 2] table is 2x the
    lut's bytes — 134 MB at lut_k=12)."""
    assert int(lut[-1]) < 2**31, "suffix count must fit int32"

    @jax.jit
    def _build(lut_d):
        lut32 = lut_d.astype(jnp.int32)
        return jnp.stack([lut32[:-1], lut32[1:] - lut32[:-1]], axis=1)

    return _build(lut if isinstance(lut, jnp.ndarray)
                  else jnp.asarray(np.asarray(lut)))


def pack_reads_t(seqs: jnp.ndarray, nw: int):
    """[S, L, B] uint8 codes -> phase-0 packed (rpack, rbad) [S, nw, B]
    uint32 (lane-major: B minor)."""
    S, L, B = seqs.shape
    ext = jnp.zeros((S, 16 * nw, B), dtype=jnp.uint8).at[:, :L, :].set(seqs)
    r = ext.reshape(S, nw, 16, B)
    shifts = (2 * jnp.arange(16, dtype=jnp.uint32))[None, None, :, None]
    rpack = jnp.sum((r & 3).astype(jnp.uint32) << shifts, axis=2,
                    dtype=jnp.uint32)
    rbad = jnp.sum((r >= 4).astype(jnp.uint32) << shifts, axis=2,
                   dtype=jnp.uint32)
    return rpack, rbad


def fast_candidates_v3(gview: jnp.ndarray,   # [Gv, 2*nw2] genome row view
                       sa: jnp.ndarray,      # [M] int32 clean suffix pos
                       lut2: jnp.ndarray,    # [n_keys, 2] (lo, cnt) pairs
                       key_lo: jnp.ndarray,  # scalar: first key of shard
                       reads: jnp.ndarray,   # [B, L] uint8 codes
                       *,
                       genome_len: int,
                       offsets: tuple,
                       lut_k: int,
                       n_compact: int,
                       n_extend: int | None = None,
                       single_strand: int | None = None,
                       lut_base: int = 4,
                       digit_map: tuple | None = None,
                       max_per_bucket: int | None = None):
    """Seed + compact + locus-dedup + extend, lane-major.

    Returns (ids, mm, overflow): ids/mm [NS, B] int32 (INT32_MAX invalid),
    one slot per DISTINCT locus (pos, strand), mm its true mismatch count;
    overflow [B] bool = raw candidate total exceeded n_compact OR distinct
    loci exceeded n_extend (caller escalates, as the reference escalates
    MaxIter-truncated reads)."""
    seqs = build_seqs(reads, single_strand=single_strand)
    return _cands_core(gview, sa, lut2, key_lo, seqs,
                       genome_len=genome_len, offsets=offsets, lut_k=lut_k,
                       n_compact=n_compact, n_extend=n_extend,
                       single_strand=single_strand, lut_base=lut_base,
                       digit_map=digit_map, max_per_bucket=max_per_bucket)


def build_seqs(reads: jnp.ndarray, *, single_strand: int | None = None):
    """[B, L] uint8 codes -> lane-major strand stack [S, L, B]."""
    rt = reads.T                                            # [L, B]
    if single_strand is None:
        comp = jnp.where(rt < 4, 3 - rt, rt)
        return jnp.stack([rt, comp[::-1, :]], axis=0)       # [2, L, B]
    return rt[None]


def _cands_core(gview, sa, lut2, key_lo, seqs, *, genome_len, offsets,
                lut_k, n_compact, n_extend=None, single_strand=None,
                lut_base=4, digit_map=None, max_per_bucket=None):
    S, L, B = seqs.shape
    G = genome_len
    M = sa.shape[0]
    NC = n_compact
    NS = n_extend or NC
    W = len(offsets)
    k = lut_k
    nw = (L + 15) // 16
    nw2 = nw + 1
    n_keys = lut2.shape[0]
    Gv = gview.shape[0]
    D = S * W

    # --- seed keys [S, W, B] (full-lane shifted adds) -----------------------
    if digit_map is None:
        dig = jnp.where(seqs < 4, seqs, 0).astype(jnp.int32)
    else:
        z = jnp.where(seqs < 4, seqs, 0).astype(jnp.int32)
        dm = digit_map
        dig = jnp.where(z == 0, dm[0],
                        jnp.where(z == 1, dm[1],
                                  jnp.where(z == 2, dm[2], dm[3])))
    keys = []
    key_ok = []
    for off in offsets:
        acc = jnp.zeros((S, B), dtype=jnp.int32)
        ok = jnp.ones((S, B), dtype=bool)
        for t in range(k):
            acc = acc * lut_base + dig[:, off + t, :]
            ok = ok & (seqs[:, off + t, :] < 4)
        keys.append(acc)
        key_ok.append(ok)
    keys = jnp.stack(keys, axis=1)                          # [S, W, B]
    key_ok = jnp.stack(key_ok, axis=1)

    local = keys - key_lo.astype(jnp.int32)
    in_shard = (local >= 0) & (local < n_keys)
    local = jnp.clip(local, 0, n_keys - 1)
    pair = lut2[local]                                      # [S, W, B, 2]
    lo = pair[..., 0]
    cnt = jnp.where(key_ok & in_shard, pair[..., 1], 0)
    if max_per_bucket is not None:
        # reference MaxIter analog (KAligner.h:53-56)
        cnt = jnp.minimum(cnt, max_per_bucket)
    lo_d = lo.reshape(D, B)                   # d = strand*W + w, same order
    cnt_d = cnt.reshape(D, B)

    # --- slot -> (bucket, rank) compaction, lane-major ----------------------
    cum = jnp.cumsum(cnt_d, axis=0)                         # [D, B]
    total = cum[-1]
    overflow = total > NC
    j = jnp.arange(NC, dtype=jnp.int32)[:, None, None]      # [NC, 1, 1]
    le = (cum[None, :, :] <= j).astype(jnp.int32)           # [NC, D, B]
    b = jnp.sum(le, axis=1)
    b = jnp.clip(b, 0, D - 1)
    donehot = (b[:, None, :] ==
               jnp.arange(D, dtype=jnp.int32)[None, :, None])  # [NC, D, B]
    cum0 = jnp.concatenate([jnp.zeros((1, B), jnp.int32), cum[:-1]], axis=0)
    prev = jnp.sum(jnp.where(donehot, cum0[None], 0), axis=1)
    lo_b = jnp.sum(jnp.where(donehot, lo_d[None], 0), axis=1)
    jq = jnp.arange(NC, dtype=jnp.int32)[:, None]           # [NC, 1]
    rank = jq - prev
    sa_idx = lo_b + rank
    slot_ok = jq < jnp.minimum(total, NC)[None, :]

    w_d = b % W
    strand = (b // W) if single_strand is None \
        else jnp.full_like(b, single_strand)
    off_np = np.asarray(offsets, np.int32)
    off_b = jnp.sum(jnp.where(
        w_d[:, None, :] == jnp.arange(W, dtype=jnp.int32)[None, :, None],
        jnp.asarray(off_np)[None, :, None], 0), axis=1)
    sa_pos = sa[jnp.clip(sa_idx, 0, M - 1)].astype(jnp.int32)
    pos = sa_pos - off_b
    valid = slot_ok & (pos >= 0) & (pos + L <= G)

    # --- locus dedup: keep only the first slot per (pos, strand) -----------
    # A slot exists iff its window matches the locus exactly (clean-SA keys
    # are N-free on both sides), so the first slot per locus IS the
    # first-exact-window canonical copy of seed_extend_fast (:31-36 there).
    lid = jnp.where(valid, pos * 2 + strand, INT32_MAX)     # [NC, B]
    eq = (lid[:, None, :] == lid[None, :, :]) & valid[None, :, :]
    tri = np.tril(np.ones((NC, NC), dtype=bool), -1)        # j < i
    dup = jnp.any(eq & jnp.asarray(tri)[:, :, None], axis=1)
    keep = valid & ~dup
    n_uniq = jnp.sum(keep, axis=0, dtype=jnp.int32)
    overflow = overflow | (n_uniq > NS)

    # recompact kept slots -> NS extension slots
    kcum = jnp.cumsum(keep.astype(jnp.int32), axis=0)       # [NC, B]
    j2 = jnp.arange(NS, dtype=jnp.int32)[:, None, None]     # [NS, 1, 1]
    src = jnp.sum((kcum[None, :, :] <= j2).astype(jnp.int32), axis=1)
    src = jnp.clip(src, 0, NC - 1)                          # [NS, B]
    shot = (src[:, None, :] ==
            jnp.arange(NC, dtype=jnp.int32)[None, :, None])  # [NS, NC, B]
    pos2 = jnp.sum(jnp.where(shot, pos[None], 0), axis=1)
    str2 = jnp.sum(jnp.where(shot, strand[None], 0), axis=1)
    wd2 = jnp.sum(jnp.where(shot, w_d[None], 0), axis=1)
    ok2 = (jnp.arange(NS, dtype=jnp.int32)[:, None]
           < jnp.minimum(n_uniq, NS)[None, :])              # [NS, B]

    # --- extension: ONE row-gather per distinct locus -----------------------
    posc = jnp.where(ok2, pos2, 0)
    w0 = jnp.clip(posc >> 4, 0, Gv - 1)
    rows = gview[w0]                                        # [NS, B, 2*nw2]
    rows = jnp.transpose(rows, (0, 2, 1))                   # [NS, 2*nw2, B]
    gw = rows[:, :nw2]
    gb = rows[:, nw2:]
    sh = (2 * (posc & 15)).astype(jnp.uint32)[:, None, :]   # [NS, 1, B]
    hi_sh = jnp.uint32(32) - sh

    def shift_align(words):
        lo_w = words[:, :nw] >> sh
        hi_w = jnp.where(sh == 0, jnp.uint32(0), words[:, 1:] << hi_sh)
        return lo_w | hi_w

    ga = shift_align(gw)                                    # [NS, nw, B]
    gba = shift_align(gb)
    rpack, rbad = pack_reads_t(seqs, nw)                    # [S, nw, B]
    if S == 1:
        rp = rpack[0][None]
        rb = rbad[0][None]
    else:
        st = str2[:, None, :]                               # [NS, 1, B]
        rp = jnp.where(st == 0, rpack[0][None], rpack[1][None])
        rb = jnp.where(st == 0, rbad[0][None], rbad[1][None])

    x = ga ^ rp
    mism = (x | (x >> 1)) & MISM_BITS
    badb = (gba | rb) & MISM_BITS
    tmask = jnp.asarray(_tail_mask(L, nw))[None, :, None]
    bits = (mism | badb) & tmask                            # [NS, nw, B]
    mm = jnp.sum(jax.lax.population_count(bits), axis=1,
                 dtype=jnp.int32)                           # [NS, B]

    # --- first-exact-window canonicalisation (from extension bits) ---------
    # The kept slot is the first SURVIVING copy; under per-bucket caps /
    # key-range sharding an earlier exact window's copy may not have
    # survived locally. Recomputing the first exact window from the
    # mismatch bits keeps emission exactly-once GLOBALLY (each locus is
    # owned by the shard holding its first exact window's key) and matches
    # seed_extend_fast bit-for-bit.
    from .seed_extend_fast import _window_masks
    wmask = _window_masks(offsets, k, nw)                   # np [W, nw]
    fw = jnp.full((NS, B), W, dtype=jnp.int32)
    any_exact = jnp.zeros((NS, B), dtype=bool)
    for w in range(W - 1, -1, -1):
        ne = jnp.zeros((NS, B), dtype=bool)
        for wi in range(nw):
            if wmask[w, wi]:
                ne = ne | ((bits[:, wi] & jnp.uint32(wmask[w, wi])) != 0)
        ex = ~ne
        fw = jnp.where(ex, w, fw)
        any_exact = any_exact | ex
    canonical = ok2 & any_exact & (fw == wd2)

    ids = jnp.where(canonical, pos2 * 2 + str2, INT32_MAX)
    mm = jnp.where(canonical, mm, INT32_MAX)
    return ids, mm, overflow


def unpack_reads_2bit(reads2b: jnp.ndarray, nlist: jnp.ndarray,
                      read_len: int) -> jnp.ndarray:
    """[B, ceil(L/4)] 2-bit-packed codes + sparse N list [K, 2] int32
    (read_idx, base_idx; padded with out-of-range sentinels) -> [B, L] uint8 codes.

    The host link moves ~10-35 MB/s, so reads cross it 2-bit packed
    (the reference's own on-disk representation, libkit4b/packed seqs)
    with the rare Ns scattered back from a sparse list."""
    B, L4 = reads2b.shape
    parts = [(reads2b >> (2 * t)) & 3 for t in range(4)]
    reads = jnp.stack(parts, axis=2).reshape(B, 4 * L4)[:, :read_len]
    reads = reads.at[nlist[:, 0], nlist[:, 1]].set(4, mode="drop")
    return reads


def _classify_compact(ids, mm, overflow, *, max_tot_mm, mm_delta):
    """[NS, B] candidate stats -> (code, low, n_low) each [B]."""
    ok = ids != INT32_MAX
    low = jnp.min(mm, axis=0)
    n_low = jnp.sum((mm == low[None, :]) & ok, axis=0, dtype=jnp.int32)
    nxt = jnp.min(jnp.where(mm > low[None, :], mm, INT32_MAX), axis=0)
    best_id = jnp.min(jnp.where(mm == low[None, :], ids, INT32_MAX), axis=0)
    aligned = low <= max_tot_mm
    unique = (aligned & ~overflow & (n_low == 1)
              & ((nxt - low) >= mm_delta))
    code = jnp.where(overflow, -3,
                     jnp.where(unique, best_id,
                               jnp.where(aligned, -2, -1)))
    return code, low, n_low


def pack_result2(code, low):
    """(code, low) -> [B, 2] int32 compact result (8 bytes/read over the
    link): col 0 = code (pos*2+strand when accepted, else -1 nohit /
    -2 multi / -3 overflow), col 1 = lowest mismatch count (INT32_MAX when
    no candidate scored). Valid while 2*genome_len + 1 < 2^31 (~1.07 Gbp,
    the int32 locus-id ceiling — the reference switches to 5-byte suffix
    elements past 4 Gbp, libkit4b/SfxArray.cpp:906-909; beyond 1 Gbp our
    path is the key-range sharded index with per-shard offsets,
    parallel/mesh.py). Replaces round 3's single-word format, whose 24-bit
    position field capped the production path at 8.4 Mbp genomes."""
    return jnp.stack([code, low], axis=1)


def unpack_result2(res: np.ndarray):
    """Host-side inverse of pack_result2 -> (code, low, n_low); n_low is
    reduced to its class (1 accepted, >=2 multi, 0 otherwise)."""
    res = np.asarray(res)
    code = res[:, 0].astype(np.int64)
    low = res[:, 1].astype(np.int64)
    n_low = np.where(code >= 0, 1, np.where(code == -2, 2, 0))
    return code, low, n_low


@functools.partial(
    jax.jit, static_argnames=("genome_len", "offsets", "lut_k",
                              "n_compact", "n_extend", "max_tot_mm",
                              "mm_delta", "max_per_bucket", "read_len",
                              "tier2"))
def fast_pass_packed_v3(gview, sa, lut2, reads2b, nlist, *, genome_len,
                        offsets, lut_k, n_compact, max_tot_mm, mm_delta,
                        read_len, n_extend=None, max_per_bucket=None,
                        tier2=(128, 192, 96)):
    """2-bit-packed reads in, [B, 2] int32 out — the minimal host-link
    variant of fast_pass_compact_v3 (see pack_result2).

    tier2 = (E, NC2, NS2): capacity-overflowed reads (class -3, typically
    <0.1%) are re-seeded ON DEVICE at the deeper (NC2, NS2) tier inside the
    same call — the reference's MaxIter sensitivity rung without a host
    round-trip (KAligner.h:53-56). Reads still overflowing tier 2 (or past
    the E read slots) return class 3 and escalate through the host tiers."""
    B = reads2b.shape[0]
    reads = unpack_reads_2bit(reads2b, nlist, read_len)
    seqs = build_seqs(reads)
    kw = dict(genome_len=genome_len, offsets=offsets, lut_k=lut_k,
              max_per_bucket=max_per_bucket)
    ids, mm, overflow = _cands_core(gview, sa, lut2, jnp.int32(0), seqs,
                                    n_compact=n_compact, n_extend=n_extend,
                                    **kw)
    code, low, n_low = _classify_compact(ids, mm, overflow,
                                         max_tot_mm=max_tot_mm,
                                         mm_delta=mm_delta)
    if tier2 is not None:
        E, NC2, NS2 = tier2
        esc = code == -3
        n_esc = jnp.sum(esc, axis=0, dtype=jnp.int32)
        ecum = jnp.cumsum(esc.astype(jnp.int32))
        ridx = jnp.sum((ecum[None, :] <=
                        jnp.arange(E, dtype=jnp.int32)[:, None])
                       .astype(jnp.int32), axis=1)          # [E]
        ridx = jnp.clip(ridx, 0, B - 1)
        egood = jnp.arange(E, dtype=jnp.int32) < jnp.minimum(n_esc, E)
        eseqs = seqs[:, :, ridx]                            # [S, L, E]
        ids2, mm2, ovf2 = _cands_core(gview, sa, lut2, jnp.int32(0), eseqs,
                                      n_compact=NC2, n_extend=NS2, **kw)
        code2, low2, nlow2 = _classify_compact(ids2, mm2, ovf2,
                                               max_tot_mm=max_tot_mm,
                                               mm_delta=mm_delta)
        tgt = jnp.where(egood, ridx, jnp.int32(2 ** 30))    # OOB -> dropped
        code = code.at[tgt].set(code2, mode="drop")
        low = low.at[tgt].set(low2, mode="drop")
    return pack_result2(code, low)


@functools.partial(
    jax.jit, static_argnames=("genome_len", "offsets", "lut_k",
                              "n_compact", "n_extend", "max_tot_mm",
                              "mm_delta", "max_per_bucket"))
def fast_pass_compact_v3(gview, sa, lut2, reads, *, genome_len,
                         offsets, lut_k, n_compact, max_tot_mm, mm_delta,
                         n_extend=None, max_per_bucket=None):
    """Lane-major fast pass with on-device classification; same [B, 3]
    int32 contract as seed_extend_fast.fast_pass_compact:
      col 0: pos*2+strand unique accept, or -1 nohit / -2 multi / -3 overflow
      col 1: lowest mismatch count (INT32_MAX when no hit)
      col 2: number of distinct loci at the lowest count"""
    ids, mm, overflow = fast_candidates_v3(
        gview, sa, lut2, jnp.int32(0), reads, genome_len=genome_len,
        offsets=offsets, lut_k=lut_k, n_compact=n_compact,
        n_extend=n_extend, max_per_bucket=max_per_bucket)
    code, low, n_low = _classify_compact(ids, mm, overflow,
                                         max_tot_mm=max_tot_mm,
                                         mm_delta=mm_delta)
    return jnp.stack([code, low, n_low], axis=1)


@functools.partial(
    jax.jit, static_argnames=("genome_len", "offsets", "lut_k",
                              "n_compact", "n_extend", "max_ml",
                              "max_per_bucket"))
def fast_pass_v3(gview, sa, lut2, reads, *, genome_len, offsets,
                 lut_k, n_compact, max_ml, n_extend=None,
                 max_per_bucket=None):
    """Lane-major full-stats pass; same output contract as
    seed_extend_fast.fast_pass (dict of low_mm/n_low/nxt_mm [B],
    hit_id/hit_mm [B, max_ml], overflow [B])."""
    from .seed_extend_fast import finalize_fast
    ids, mm, overflow = fast_candidates_v3(
        gview, sa, lut2, jnp.int32(0), reads, genome_len=genome_len,
        offsets=offsets, lut_k=lut_k, n_compact=n_compact,
        n_extend=n_extend, max_per_bucket=max_per_bucket)
    out = finalize_fast(ids.T, mm.T, max_ml=max_ml)
    out["overflow"] = overflow
    return out
