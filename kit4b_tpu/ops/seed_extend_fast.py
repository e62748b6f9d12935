"""Fast batched seed-and-extend pass — the round-2 kalign device hot path.

Replaces ops/seed_extend.align_pass with a design tuned to measured XLA
gather and sort costs:

  cost driver (round 1)                  this module
  -------------------------------------  -----------------------------------
  elementwise genome gathers (~10ns/el)  ROW gathers of the genome context
                                         (one index fetches 2*(nw+1) words)
  per-read candidate SORT ([B,720])      cumsum bucket->slot compaction
                                         (searchsorted-by-compare, no sort)
  16-phase read packing + phase masks    phase-0 read packing; GENOME words
                                         funnel-shifted to read phase
  sort-based locus dedup                 first-exact-window canonicalisation
                                         (a locus is emitted only by its
                                         first mismatch-free seed window)
  fixed per-bucket candidate cap C=24    ALL bucket entries up to a per-read
    (silent truncation)                  capacity NC; truncation sets an
                                         overflow flag -> host escalates the
                                         read to a bigger-NC tier (the
                                         reference's sensitivity/MaxIter
                                         ladder, ngskit4b/KAligner.h:53-56)

Discovery guarantee: W = max_mm + 1 DISJOINT lut_k-mer windows per strand.
Pigeonhole: any alignment with <= max_mm mismatches has at least one
mismatch-free window, whose k-mer key indexes the LUT bucket containing the
locus (the clean-suffix SA holds every N-free genome k-mer). This mirrors the
reference's progressive core passes (libkit4b/SfxArray.cpp:7866-7893) with a
single fixed-shape evaluation.

First-exact-window dedup: a candidate found via window w counts iff w is the
read's FIRST mismatch-free window at that locus (computable from the
extension's XOR bits alone). Exactly-once emission holds per shard AND
globally across key-range index shards, because each shard emits only the
candidates whose canonical window key it owns — the cross-shard merge is a
plain concatenation (SURVEY.md §2.5 P3).

Reference parity anchors: CSfxArray::LocateCoreMultiples inner loop
(libkit4b/SfxArray.cpp:5806), CKAligner::AlignRead (ngskit4b/KAligner.cpp:9583).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

INT32_MAX = np.int32(np.iinfo(np.int32).max)
MISM_BITS = np.uint32(0x55555555)


def fast_offsets(read_len: int, lut_k: int, max_mm: int) -> tuple:
    """Evenly spread disjoint seed-window offsets.

    W = min(max_mm + 1, L // k) windows guarantee discovery of all loci with
    <= W - 1 mismatches; spreading them across the read (stride >= k) keeps
    the pigeonhole property while covering 3' error-dense tails."""
    L, k = read_len, lut_k
    W = min(max_mm + 1, L // k)
    if W <= 0:
        return ()
    if W == 1:
        return (0,)
    stride = (L - k) // (W - 1)
    return tuple(i * stride for i in range(W))


def make_gview(gpack: np.ndarray, gbad: np.ndarray, nw2: int) -> np.ndarray:
    """[Gv, 2*nw2] uint32 row-gather view: row i = gpack[i:i+nw2] ++
    gbad[i:i+nw2]. One row fetch supplies the full extension context for a
    candidate whose read-start word is i."""
    p = np.lib.stride_tricks.sliding_window_view(gpack, nw2)
    b = np.lib.stride_tricks.sliding_window_view(gbad, nw2)
    return np.concatenate([p, b], axis=1).astype(np.uint32)


def make_gview_device(gpack: np.ndarray, gbad: np.ndarray,
                      nw2: int) -> jnp.ndarray:
    """make_gview built ON DEVICE: only the 2-bit packed genome (+bad mask)
    is copied to the device (~0.5 byte/base); the [Gv, 2*nw2] sliding-window
    view (16x larger) is materialised device-side."""
    import jax

    @jax.jit
    def _build(gp, gb):
        Gw = gp.shape[0]
        Gv = Gw - nw2 + 1
        p = jnp.stack([jax.lax.dynamic_slice(gp, (j,), (Gv,))
                       for j in range(nw2)], axis=1)
        b = jnp.stack([jax.lax.dynamic_slice(gb, (j,), (Gv,))
                       for j in range(nw2)], axis=1)
        return jnp.concatenate([p, b], axis=1)

    return _build(jnp.asarray(gpack.astype(np.uint32)),
                  jnp.asarray(gbad.astype(np.uint32)))


def pack_reads0(seqs: jnp.ndarray, nw: int):
    """[B, S, L] uint8 codes -> phase-0 packed (rpack, rbad) [B, S, nw]."""
    B, S, L = seqs.shape
    ext = jnp.zeros((B, S, 16 * nw), dtype=jnp.uint8).at[:, :, :L].set(seqs)
    r = ext.reshape(B, S, nw, 16)
    shifts = (2 * jnp.arange(16, dtype=jnp.uint32))
    rpack = jnp.sum((r & 3).astype(jnp.uint32) << shifts, axis=-1,
                    dtype=jnp.uint32)
    rbad = jnp.sum((r >= 4).astype(jnp.uint32) << shifts, axis=-1,
                   dtype=jnp.uint32)
    return rpack, rbad


def _tail_mask(read_len: int, nw: int) -> np.ndarray:
    """uint32 [nw]: flag bit 2m of word j set iff base 16j + m < read_len."""
    out = np.zeros(nw, dtype=np.uint32)
    for j in range(nw):
        for m in range(16):
            if 16 * j + m < read_len:
                out[j] |= np.uint32(1) << np.uint32(2 * m)
    return out


def _window_masks(offsets: tuple, lut_k: int, nw: int) -> np.ndarray:
    """uint32 [W, nw]: flag bits covering read bases [off, off+k)."""
    out = np.zeros((len(offsets), nw), dtype=np.uint32)
    for w, off in enumerate(offsets):
        for i in range(off, off + lut_k):
            out[w, i // 16] |= np.uint32(1) << np.uint32(2 * (i % 16))
    return out


def revcomp_device(reads: jnp.ndarray) -> jnp.ndarray:
    comp = jnp.where(reads < 4, 3 - reads, reads)
    return comp[..., ::-1]


def fast_candidates(gview: jnp.ndarray,   # [Gv, 2*nw2] genome context rows
                    sa: jnp.ndarray,      # [M] int32 clean-suffix positions
                    lut: jnp.ndarray,     # [lut_len] bucket starts
                    key_lo: jnp.ndarray,  # scalar: first key of shard
                    reads: jnp.ndarray,   # [B, L] uint8 codes
                    *,
                    genome_len: int,
                    offsets: tuple,
                    lut_k: int,
                    n_compact: int,
                    single_strand: int | None = None,
                    lut_base: int = 4,
                    digit_map: tuple | None = None,
                    max_per_bucket: int | None = None):
    """Seed + compact + extend + canonicalise. Returns (ids, mm, overflow):
    ids/mm [B, NC] int32 (INT32_MAX invalid), each surviving entry a
    deduplicated locus; overflow [B] bool -> escalate the read.

    single_strand: None evaluates both strands (reads + their revcomp);
    0/1 evaluates `reads` as given, labelling hits with that strand bit
    (the bisulfite path pre-collapses/pre-revcomps its read tensors)."""
    B, L = reads.shape
    G = genome_len
    M = sa.shape[0]
    NC = n_compact
    W = len(offsets)
    k = lut_k
    nw = (L + 15) // 16
    nw2 = nw + 1
    n_keys = lut.shape[0] - 1
    Gv = gview.shape[0]

    if single_strand is None:
        seqs = jnp.stack([reads, revcomp_device(reads)], axis=1)  # [B,2,L]
    else:
        seqs = reads[:, None, :]                                  # [B,1,L]
    S = seqs.shape[1]
    D = S * W

    # --- seed lookup: bucket (lo, cnt) per (strand, window) ----------------
    offs = (jnp.asarray(offsets, jnp.int32)[:, None]
            + jnp.arange(k, dtype=jnp.int32)[None, :])          # [W, k]
    bases = seqs[:, :, offs]                                     # [B,S,W,k]
    powb = jnp.asarray([lut_base ** e for e in range(k - 1, -1, -1)],
                       dtype=jnp.int32)
    if digit_map is None:
        digits = jnp.where(bases < 4, bases, 0).astype(jnp.int32)
    else:
        dm = jnp.asarray(digit_map, dtype=jnp.int32)
        digits = dm[jnp.where(bases < 4, bases, 0).astype(jnp.int32)]
    keys = jnp.sum(digits * powb, axis=-1, dtype=jnp.int32)      # [B,S,W]
    key_ok = jnp.all(bases < 4, axis=-1)
    local = keys - key_lo.astype(jnp.int32)
    in_shard = (local >= 0) & (local < n_keys)
    local = jnp.clip(local, 0, n_keys - 1)
    lo = lut[local].astype(jnp.int32)
    cnt = (lut[local + 1].astype(jnp.int32) - lo)
    cnt = jnp.where(key_ok & in_shard, cnt, 0)
    if max_per_bucket is not None:
        # reference MaxIter analog (KAligner.h:53-56): bound per-core SA
        # exploration so deep-repeat buckets stay within capacity;
        # truncated buckets explore their first max_per_bucket entries
        cnt = jnp.minimum(cnt, max_per_bucket)
    lo_d = lo.reshape(B, D)
    cnt_d = cnt.reshape(B, D)          # flat bucket order d = strand*W + w

    # --- slot -> (bucket, rank) compaction (no sort) -----------------------
    cum = jnp.cumsum(cnt_d, axis=1)                              # [B, D]
    total = cum[:, -1]
    overflow = total > NC
    j = jnp.arange(NC, dtype=jnp.int32)                          # [B, NC]
    b = jnp.sum((cum[:, None, :] <= j[None, :, None]).astype(jnp.int32),
                axis=2)
    b = jnp.clip(b, 0, D - 1)
    cum0 = jnp.pad(cum, ((0, 0), (1, 0)))
    prev = jnp.take_along_axis(cum0, b, axis=1)
    rank = j[None, :] - prev
    sa_idx = jnp.take_along_axis(lo_d, b, axis=1) + rank
    slot_ok = j[None, :] < jnp.minimum(total, NC)[:, None]

    w_d = b % W
    if single_strand is None:
        strand = b // W
    else:
        strand = jnp.full_like(b, single_strand)
    off_b = jnp.asarray(offsets, dtype=jnp.int32)[w_d]           # [B, NC]
    sa_pos = sa[jnp.clip(sa_idx, 0, M - 1)].astype(jnp.int32)
    pos = sa_pos - off_b
    valid = slot_ok & (pos >= 0) & (pos + L <= G)

    # --- extension: one context-row gather per candidate -------------------
    rpack, rbad = pack_reads0(seqs, nw)                          # [B,2,nw]
    w0 = jnp.clip(jnp.where(valid, pos, 0) >> 4, 0, Gv - 1)
    rows = gview[w0]                                             # [B,NC,2nw2]
    gw = rows[..., :nw2]
    gb = rows[..., nw2:]
    sh = (2 * (jnp.where(valid, pos, 0) & 15)).astype(jnp.uint32)[..., None]
    hi_sh = jnp.uint32(32) - sh

    def shift_align(words):
        lo_w = words[..., :nw] >> sh
        hi_w = jnp.where(sh == 0, jnp.uint32(0), words[..., 1:] << hi_sh)
        return lo_w | hi_w

    ga = shift_align(gw)
    gba = shift_align(gb)
    if S == 1:
        rp = rpack[:, None, 0, :]
        rb = rbad[:, None, 0, :]
    else:
        st = strand[..., None]
        rp = jnp.where(st == 0, rpack[:, None, 0, :], rpack[:, None, 1, :])
        rb = jnp.where(st == 0, rbad[:, None, 0, :], rbad[:, None, 1, :])

    x = ga ^ rp
    mism = (x | (x >> 1)) & MISM_BITS
    badb = (gba | rb) & MISM_BITS
    tmask = jnp.asarray(_tail_mask(L, nw))
    bits = (mism | badb) & tmask                                 # [B,NC,nw]
    mm = jnp.sum(jax.lax.population_count(bits), axis=-1,
                 dtype=jnp.int32)

    # --- first-exact-window canonicalisation -------------------------------
    wmask = jnp.asarray(_window_masks(offsets, k, nw))           # [W, nw]
    notexact = jnp.any((bits[:, :, None, :] & wmask[None, None]) != 0,
                       axis=-1)                                  # [B,NC,W]
    exact = ~notexact
    fw = jnp.argmax(exact, axis=-1).astype(jnp.int32)            # first True
    canonical = valid & jnp.any(exact, axis=-1) & (fw == w_d)

    ids = jnp.where(canonical, pos * 2 + strand, INT32_MAX)
    mm = jnp.where(canonical, mm, INT32_MAX)
    return ids, mm, overflow


def finalize_fast(ids: jnp.ndarray, mm: jnp.ndarray, *, max_ml: int):
    """Masked best/next-best stats + top-max_ml hits ordered by (mm, id).

    ids/mm [B, N] int32 with INT32_MAX invalid; entries are already
    deduplicated (exactly-once per locus), so no sort-dedup is needed —
    ordering uses one small int64 key sort."""
    B, N = ids.shape
    ok = ids != INT32_MAX
    low = jnp.min(mm, axis=1)
    n_low = jnp.sum((mm == low[:, None]) & ok, axis=1, dtype=jnp.int32)
    nxt = jnp.min(jnp.where(mm > low[:, None], mm, INT32_MAX), axis=1)

    mm_s, id_s = jax.lax.sort((mm, ids), dimension=1, num_keys=2)
    hit_mm = mm_s[:, :max_ml]
    hit_id = jnp.where(hit_mm == INT32_MAX, INT32_MAX, id_s[:, :max_ml])
    if max_ml > N:
        pad = ((0, 0), (0, max_ml - N))
        hit_mm = jnp.pad(hit_mm, pad, constant_values=int(INT32_MAX))
        hit_id = jnp.pad(hit_id, pad, constant_values=int(INT32_MAX))
    return {"low_mm": low, "n_low": n_low, "nxt_mm": nxt,
            "hit_id": hit_id, "hit_mm": hit_mm}


@functools.partial(
    jax.jit, static_argnames=("genome_len", "offsets", "lut_k",
                              "n_compact", "max_tot_mm", "mm_delta",
                              "max_per_bucket"))
def fast_pass_compact(gview: jnp.ndarray, sa: jnp.ndarray, lut: jnp.ndarray,
                      reads: jnp.ndarray, *, genome_len: int, offsets: tuple,
                      lut_k: int, n_compact: int, max_tot_mm: int,
                      mm_delta: int, max_per_bucket: int | None = None):
    """fast_pass with ON-DEVICE classification and a compact return.

    Returning the full stats dict to the host moves far more bytes than
    the answer needs. This variant classifies each read on device and returns ONE [B, 3] int32 array:
      col 0: pos*2+strand of the unique accepted hit, or -1 nohit,
             -2 multialigned, -3 capacity overflow (caller escalates)
      col 1: lowest mismatch count (INT32_MAX when no hit)
      col 2: number of distinct loci at the lowest mismatch count
    Callers needing hit lists (PE pairing, rescue passes) use fast_pass."""
    ids, mm, overflow = fast_candidates(
        gview, sa, lut, jnp.int32(0), reads, genome_len=genome_len,
        offsets=offsets, lut_k=lut_k, n_compact=n_compact,
        max_per_bucket=max_per_bucket)
    ok = ids != INT32_MAX
    low = jnp.min(mm, axis=1)
    n_low = jnp.sum((mm == low[:, None]) & ok, axis=1, dtype=jnp.int32)
    nxt = jnp.min(jnp.where(mm > low[:, None], mm, INT32_MAX), axis=1)
    best_id = jnp.min(jnp.where(mm == low[:, None], ids, INT32_MAX), axis=1)
    aligned = low <= max_tot_mm
    unique = (aligned & ~overflow & (n_low == 1)
              & ((nxt - low) >= mm_delta))
    code = jnp.where(overflow, -3,
                     jnp.where(unique, best_id,
                               jnp.where(aligned, -2, -1)))
    return jnp.stack([code, low, n_low], axis=1)


@functools.partial(
    jax.jit, static_argnames=("genome_len", "offsets", "lut_k",
                              "n_compact", "max_ml", "max_per_bucket"))
def fast_pass(gview: jnp.ndarray, sa: jnp.ndarray, lut: jnp.ndarray,
              reads: jnp.ndarray, *, genome_len: int, offsets: tuple,
              lut_k: int, n_compact: int, max_ml: int,
              max_per_bucket: int | None = None):
    """Single-device fast pass over a read batch, both strands.

    Same output contract as ops/seed_extend.align_pass: dict with
    low_mm/n_low/nxt_mm [B], hit_id/hit_mm [B, max_ml], overflow [B].
    overflow=True means the read's candidate total exceeded n_compact and its
    stats are incomplete — the caller escalates it to a bigger tier."""
    ids, mm, overflow = fast_candidates(
        gview, sa, lut, jnp.int32(0), reads, genome_len=genome_len,
        offsets=offsets, lut_k=lut_k, n_compact=n_compact,
        max_per_bucket=max_per_bucket)
    out = finalize_fast(ids, mm, max_ml=max_ml)
    out["overflow"] = overflow
    return out


@functools.partial(
    jax.jit, static_argnames=("genome_len", "scan_len"))
def window_scan(gview: jnp.ndarray,   # [Gv, 2*nw2] genome context rows
                probes: jnp.ndarray,  # [R, L] uint8 strand-ready codes
                starts: jnp.ndarray,  # [R] int32 window start positions
                *, genome_len: int, scan_len: int):
    """Dense mismatch scan: for each probe, mm at every genome position
    in [start, start+scan_len) — the device analog of the PE orphan
    rescue's sliding window (KAligner.cpp:3333 AlignPartnerRead).
    Returns (best_mm, best_pos, n_best) each [R] int32."""
    R, L = probes.shape
    nw = (L + 15) // 16
    nw2 = nw + 1
    Gv = gview.shape[0]
    nw2g = gview.shape[1] // 2        # gview rows: [pack(nw2g), bad(nw2g)]
    rpack, rbad = pack_reads0(probes[:, None, :], nw)   # [R,1,nw]
    rpack = rpack[:, 0, :][:, None, :]
    rbad = rbad[:, 0, :][:, None, :]
    pos = starts[:, None] + jnp.arange(scan_len, dtype=jnp.int32)[None, :]
    valid = (pos >= 0) & (pos + L <= genome_len)
    safe = jnp.clip(pos, 0, genome_len - L)
    w0 = jnp.clip(safe >> 4, 0, Gv - 1)
    rows = gview[w0]                                     # [R,P,2*nw2g]
    gw = rows[..., :nw2]
    gb = rows[..., nw2g:nw2g + nw2]
    sh = (2 * (safe & 15)).astype(jnp.uint32)[..., None]
    hi_sh = jnp.uint32(32) - sh

    def shift_align(words):
        lo_w = words[..., :nw] >> sh
        hi_w = jnp.where(sh == 0, jnp.uint32(0), words[..., 1:] << hi_sh)
        return lo_w | hi_w

    ga = shift_align(gw)
    gba = shift_align(gb)
    x = ga ^ rpack
    mism = (x | (x >> 1)) & MISM_BITS
    badb = (gba | rbad) & MISM_BITS
    tmask = jnp.asarray(_tail_mask(L, nw))
    bits = (mism | badb) & tmask
    mm = jnp.sum(jax.lax.population_count(bits), axis=-1,
                 dtype=jnp.int32)
    mm = jnp.where(valid, mm, INT32_MAX)
    best = jnp.min(mm, axis=1)
    n_best = jnp.sum(mm == best[:, None], axis=1, dtype=jnp.int32)
    bi = jnp.argmin(mm, axis=1).astype(jnp.int32)
    best_pos = jnp.take_along_axis(safe, bi[:, None], axis=1)[:, 0]
    return best, best_pos, n_best


@functools.partial(
    jax.jit, static_argnames=("genome_len", "scan_len", "read_len"))
def window_scan_packed(gview: jnp.ndarray, r2b: jnp.ndarray,
                       nlist: jnp.ndarray, starts: jnp.ndarray,
                       *, genome_len: int, scan_len: int, read_len: int):
    """Gather-free window scan (round 5): same contract as window_scan
    — (best_mm, best_pos, n_best) over [start, start+scan_len) — but the
    probe arrives 2-bit packed and the genome is touched via ONE
    contiguous block gather per probe instead of scan_len overlapping
    row gathers. The block is pre-aligned to `start` with a per-probe
    funnel shift, then 16 static phase-shifted word streams turn every
    scan position into pure slicing: position p = 16t + s reads words
    [t, t+nw) of phase s. The row-gather formulation paid ~2M per-index
    gathers per [4096 x 501] scan; this pays ~176K plus elementwise
    work."""
    from .seed_extend_v4 import words_from_2bit
    rw, rb, _, _ = words_from_2bit(r2b, nlist, read_len)   # [nw, R]
    return _phase_scan(gview, rw.T, rb.T, starts,
                       genome_len=genome_len, scan_len=scan_len,
                       read_len=read_len)


@functools.partial(
    jax.jit, static_argnames=("genome_len", "scan_len", "read_len"))
def window_scan_pe(gview: jnp.ndarray, planes1, planes2,
                   idxs: jnp.ndarray, which: jnp.ndarray,
                   want_strand: jnp.ndarray, starts: jnp.ndarray,
                   *, genome_len: int, scan_len: int, read_len: int):
    """PE orphan rescue scan with DEVICE-side probe gather: the orphan
    mate's words come from the group-resident word planes (the
    (rw, rb, rcw, rcb) [nw, N] tuples shared by the whole superbatch),
    so only idxs/which/strand/starts cross the host link (~16 B/row vs
    ~40+ B of probe bytes). which[r] = 1 rescues mate 1, 2 rescues
    mate 2; want_strand selects forward/revcomp words."""
    p1, p2 = planes1, planes2
    sel = lambda a, b: jnp.where((which == 2)[None, :], a[:, idxs],
                                 b[:, idxs])
    rw = sel(p2[0], p1[0])         # [nw, R] forward words of the orphan
    rb = sel(p2[1], p1[1])
    rcw = sel(p2[2], p1[2])
    rcb = sel(p2[3], p1[3])
    fwd = (want_strand == 0)[None, :]
    pw = jnp.where(fwd, rw, rcw).T
    pb = jnp.where(fwd, rb, rcb).T
    return _phase_scan(gview, pw, pb, starts, genome_len=genome_len,
                       scan_len=scan_len, read_len=read_len)


def _phase_scan(gview, pw, pb, starts, *, genome_len: int, scan_len: int,
                read_len: int):
    """Shared phase-sliced scan body: probe words pw/pb [R, nw]."""
    R = pw.shape[0]
    L = read_len
    P = scan_len
    nw = (L + 15) // 16
    nw2g = gview.shape[1] // 2
    Gv = gview.shape[0]
    T = (P + 15) // 16
    nwblk = T + nw + 1

    base_w = starts >> 4
    idx = jnp.clip(base_w[:, None]
                   + jnp.arange(nwblk + 1, dtype=jnp.int32)[None, :],
                   0, Gv - 1)
    blk = gview[idx]                                     # [R, nwblk+1, 2nw2g]
    gw = blk[..., 0]                                     # [R, nwblk+1]
    gb = blk[..., nw2g]
    # pre-align the streams to `starts` (sub-word funnel, per probe)
    sh0 = (2 * (starts & 15)).astype(jnp.uint32)[:, None]
    aw = jnp.where(sh0 == 0, gw[:, :-1],
                   (gw[:, :-1] >> sh0) | (gw[:, 1:] << (32 - sh0)))
    ab = jnp.where(sh0 == 0, gb[:, :-1],
                   (gb[:, :-1] >> sh0) | (gb[:, 1:] << (32 - sh0)))
    tmask = jnp.asarray(_tail_mask(L, nw))
    # phase s: bases starting at start + 16t + s live in words [t, t+nw)
    mm_st = []
    for s in range(16):
        shs = jnp.uint32(2 * s)
        if s == 0:
            ws, bs = aw, ab
        else:
            ws = (aw[:, :-1] >> shs) | (aw[:, 1:] << (32 - shs))
            bs = (ab[:, :-1] >> shs) | (ab[:, 1:] << (32 - shs))
        acc = jnp.zeros((R, T), jnp.int32)
        for j in range(nw):
            x = ws[:, j:j + T] ^ pw[:, j:j + 1]
            mism = (x | (x >> 1)) & MISM_BITS
            badb = (bs[:, j:j + T] | pb[:, j:j + 1]) & MISM_BITS
            acc = acc + jax.lax.population_count(
                (mism | badb) & tmask[j]).astype(jnp.int32)
        mm_st.append(acc)
    mm = jnp.stack(mm_st, axis=2).reshape(R, T * 16)     # p = 16t + s
    p = jnp.arange(T * 16, dtype=jnp.int32)[None, :]
    pos = starts[:, None] + p
    valid = (p < P) & (pos >= 0) & (pos + L <= genome_len)
    mm = jnp.where(valid, mm, INT32_MAX)
    best = jnp.min(mm, axis=1)
    n_best = jnp.sum(mm == best[:, None], axis=1, dtype=jnp.int32)
    prel = jnp.min(jnp.where(mm == best[:, None], p, jnp.int32(2 ** 30)),
                   axis=1)
    best_pos = jnp.clip(starts + prel, 0, genome_len - L)
    return best, best_pos, n_best
