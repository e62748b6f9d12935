"""Round-4 PE hot path: packed-native paired-end pairing, fully on device.

Round 3's PE device pass (align/pe.py pe_pass) still ran the round-2
byte-tensor kernel (seed_extend_fast) and escalated capacity overflows
through HOST round-trip tiers — on a repeat-dense 40 Mbp genome (BASELINE
config #4) that meant thousands of blocking host round-trips. This module
replaces it with the production v4 packed-native
candidate machinery (ops/seed_extend_v4) end to end:

  *  reads cross the host link 2-bit packed (25 B per 100 bp read);
  *  both mates' seed+extend, the AcceptProvPE cross-product over their
     top-max_ml loci, tier-2 escalation AND a final capped tier-3 all run
     in ONE compiled graph — the pass is TOTAL (nothing escalates to the
     host; the capped tier is the reference MaxIter sensitivity floor,
     ngskit4b/KAligner.h:53-56);
  *  one [B, 12] int32 row per pair returns over the link (48 B/pair):
     cols 0-9 are the align/pe.py pe_pass layout; cols 10/11 are the
     per-mate overflow bits the host escalation groups on.

Pairing semantics are identical to align/pe.py pe_pass (itself mirroring
the reference's AcceptProvPE cross-product, ngskit4b/KAligner.cpp:
10173-10238, and unique-PE acceptance): same top-max_ml (mm, id)-ordered
hit lists, same orientation/insert-window checks, same distinct-loci tie
rejection — tests assert row equality on non-overflow pairs.

Reference parity anchors: CKAligner::ProcessPairedEnds
(ngskit4b/KAligner.cpp:2944), AcceptProvPE (:10173), MaxIter ladder
(ngskit4b/KAligner.h:53-56).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .seed_extend_fast import INT32_MAX, finalize_fast
from .seed_extend_v4 import _cands_core_v4, words_from_2bit

PAIR_NONE = 0
PAIR_ACCEPT = 1
PAIR_MULTI = 2
PAIR_OVERFLOW = 3


def _side_code(f, ovf, max_tot, mm_delta):
    """Compact per-mate classification from finalize_fast stats — the
    same rule as the SE compact pass (eHRMMDelta uniqueness)."""
    aligned = f["low_mm"] <= max_tot
    unique = (aligned & ~ovf & (f["n_low"] == 1)
              & ((f["nxt_mm"] - f["low_mm"]) >= mm_delta))
    best = jnp.min(jnp.where(f["hit_mm"] == f["low_mm"][:, None],
                             f["hit_id"], INT32_MAX), axis=1)
    return jnp.where(unique, best, jnp.where(aligned, -2, -1))


def _pair_rows(f1, f2, ovf1, ovf2, starts, *, L1, L2, max_tot, mm_delta,
               min_ins, max_ins):
    """AcceptProvPE cross-product over both mates' top-max_ml hits ->
    [B, 12] rows: cols 0-9 follow the align/pe.py pe_pass layout; cols
    10/11 carry the per-mate overflow bits (see module docstring)."""
    code1 = _side_code(f1, ovf1, max_tot, mm_delta)
    code2 = _side_code(f2, ovf2, max_tot, mm_delta)
    h1, m1 = f1["hit_id"], f1["hit_mm"]            # [B, ML]
    h2, m2 = f2["hit_id"], f2["hit_mm"]
    p1 = h1 >> 1
    s1 = h1 & 1
    p2 = h2 >> 1
    s2 = h2 & 1
    ok1 = (h1 != INT32_MAX) & (m1 <= max_tot)
    ok2 = (h2 != INT32_MAX) & (m2 <= max_tot)
    c1 = jnp.searchsorted(starts, p1, side="right")
    c2 = jnp.searchsorted(starts, p2, side="right")

    p1e, s1e, c1e = p1[:, :, None], s1[:, :, None], c1[:, :, None]
    p2e, s2e, c2e = p2[:, None, :], s2[:, None, :], c2[:, None, :]
    fwd1 = s1e == 0
    order_ok = jnp.where(fwd1, p2e >= p1e, p1e >= p2e)
    left = jnp.where(fwd1, p1e, p2e)
    right_end = jnp.where(fwd1, p2e + L2, p1e + L1)
    insert = right_end - left
    ok = (ok1[:, :, None] & ok2[:, None, :] & (s1e != s2e)
          & (c1e == c2e) & order_ok
          & (insert >= min_ins) & (insert <= max_ins))
    score = jnp.where(ok, m1[:, :, None] + m2[:, None, :], INT32_MAX)
    B, ML = p1.shape
    flat = score.reshape(B, ML * ML)
    best = jnp.min(flat, axis=1)
    besti = jnp.argmin(flat, axis=1).astype(jnp.int32)
    bi, bj = besti // ML, besti % ML
    take = lambda a, idx: jnp.take_along_axis(a, idx[:, None], axis=1)[:, 0]
    bid1 = take(h1, bi)
    bid2 = take(h2, bj)
    bmm1 = take(m1, bi)
    bmm2 = take(m2, bj)
    btlen = jnp.take_along_axis(insert.reshape(B, ML * ML),
                                besti[:, None], axis=1)[:, 0]
    pflat = jnp.broadcast_to(p1e, (B, ML, ML)).reshape(B, ML * ML)
    qflat = jnp.broadcast_to(p2e, (B, ML, ML)).reshape(B, ML * ML)
    okf = ok.reshape(B, ML * ML)
    tie = jnp.any(okf & (flat == best[:, None])
                  & ((pflat != take(pflat, besti)[:, None])
                     | (qflat != take(qflat, besti)[:, None])), axis=1)
    have = best != INT32_MAX
    overflow = ovf1 | ovf2
    pcode = jnp.where(overflow, PAIR_OVERFLOW,
                      jnp.where(~have, PAIR_NONE,
                                jnp.where(tie, PAIR_MULTI, PAIR_ACCEPT)))
    # cols 10/11: per-mate overflow bits — the host groups escalated
    # pairs by which mate actually needs the deep exploration
    return jnp.stack([jnp.where(have, bid1, -1),
                      jnp.where(have, bid2, -1),
                      bmm1, bmm2,
                      jnp.where(have, btlen, 0),
                      pcode, code1, code2,
                      f1["low_mm"], f2["low_mm"],
                      ovf1.astype(jnp.int32), ovf2.astype(jnp.int32)],
                     axis=1)


def pack_rows6(rows):
    """[B, 12] int32 pair rows -> [B, 6] wire words (device side).

    The [B, 12] layout costs 48 B/pair over the host link; the packed
    form is 24 B: words 0/1 = ids, word 2 = mm1 | mm2<<8 | tlen<<16,
    word 3 = pcode | ovf1<<2 | ovf2<<3 | low1<<8 | low2<<16, words
    4/5 = side codes. mm/low clamp to 255 and tlen to 65535 — all are
    only consumed when the row is ACCEPT/side-aligned, where they are
    far below the clamps."""
    mm1 = jnp.clip(rows[:, 2], 0, 255)
    mm2 = jnp.clip(rows[:, 3], 0, 255)
    tlen = jnp.clip(rows[:, 4], 0, 65535)
    low1 = jnp.clip(rows[:, 8], 0, 255)
    low2 = jnp.clip(rows[:, 9], 0, 255)
    w2 = mm1 | (mm2 << 8) | (tlen << 16)
    w3 = (rows[:, 5] | (rows[:, 10] << 2) | (rows[:, 11] << 3)
          | (low1 << 8) | (low2 << 16))
    return jnp.stack([rows[:, 0], rows[:, 1], w2, w3,
                      rows[:, 6], rows[:, 7]], axis=1)


def unpack_rows12(a: np.ndarray) -> np.ndarray:
    """Host-side inverse of pack_rows6: [N, 6] wire words -> [N, 12].
    Passes [N, 12] arrays through (kernels skip packing when the insert
    ceiling exceeds the 16-bit tlen field)."""
    if a.shape[1] == 12:
        return a
    out = np.empty((len(a), 12), np.int32)
    out[:, 0] = a[:, 0]
    out[:, 1] = a[:, 1]
    w2 = a[:, 2].astype(np.uint32)
    out[:, 2] = w2 & 255
    out[:, 3] = (w2 >> 8) & 255
    out[:, 4] = (w2 >> 16) & 0xFFFF
    w3 = a[:, 3].astype(np.uint32)
    out[:, 5] = w3 & 3
    out[:, 10] = (w3 >> 2) & 1
    out[:, 11] = (w3 >> 3) & 1
    out[:, 8] = (w3 >> 8) & 255
    out[:, 9] = (w3 >> 16) & 255
    out[:, 6] = a[:, 4]
    out[:, 7] = a[:, 5]
    return out


def _mate_stats(gview, sa, lut2, planes, *, kw, n_compact, n_extend,
                max_ml, max_per_bucket=None):
    ids, mm, ovf = _cands_core_v4(gview, sa, lut2, jnp.int32(0), planes,
                                  n_compact=n_compact, n_extend=n_extend,
                                  max_per_bucket=max_per_bucket, **kw)
    return finalize_fast(ids.T, mm.T, max_ml=max_ml), ovf


@functools.partial(
    jax.jit, static_argnames=("genome_len", "offsets", "lut_k", "read_len",
                              "n_compact", "n_extend", "max_ml", "max_tot",
                              "mm_delta", "min_ins", "max_ins", "tier2",
                              "tier3"))
def pe_pass_packed(gview, sa, lut2, starts, r2b1, nl1, r2b2, nl2, *,
                   genome_len: int, offsets: tuple, lut_k: int,
                   read_len: int, n_compact: int, n_extend: int,
                   max_ml: int, max_tot: int, mm_delta: int,
                   min_ins: int, max_ins: int,
                   tier2: tuple = (512, 192, 96),
                   tier3: tuple = (64, 2048)):
    """TOTAL paired-end pass: 2-bit packed mates in, [B, 6] packed wire
    words out (pack_rows6 of the [B, 12] rows: cols 0-9 pe_pass layout
    + cols 10/11 per-mate overflow bits; hosts unpack with
    unpack_rows12).

    tier2 = (E2, NC2, NS2): pairs whose tier-1 candidate compaction
    overflowed on either mate re-run both mates at the deeper capacities.
    tier3 = (E3, NC3): pairs still overflowing re-run CAPPED
    (max_per_bucket = NC3 // n_buckets, NS3 = NC3), which cannot overflow
    — the reference's MaxIter truncation floor. Pairs beyond the E2/E3
    escape slots keep PAIR_OVERFLOW (callers resolve the remainder with a
    second wave; with default sizing this is empty even on repeat-dense
    genomes)."""
    kw = dict(genome_len=genome_len, offsets=offsets, lut_k=lut_k,
              read_len=read_len)
    pair_kw = dict(L1=read_len, L2=read_len, max_tot=max_tot,
                   mm_delta=mm_delta, min_ins=min_ins, max_ins=max_ins)
    planes1 = words_from_2bit(r2b1, nl1, read_len)
    planes2 = words_from_2bit(r2b2, nl2, read_len)
    f1, ovf1 = _mate_stats(gview, sa, lut2, planes1, kw=kw,
                           n_compact=n_compact, n_extend=n_extend,
                           max_ml=max_ml)
    f2, ovf2 = _mate_stats(gview, sa, lut2, planes2, kw=kw,
                           n_compact=n_compact, n_extend=n_extend,
                           max_ml=max_ml)
    out = _pair_rows(f1, f2, ovf1, ovf2, starts, **pair_kw)
    B = out.shape[0]

    def escalate(out, tier_caps, capped):
        E, NC2 = tier_caps[0], tier_caps[1]
        NS2 = tier_caps[2] if len(tier_caps) > 2 else NC2
        cap = None
        if capped:
            cap = max(1, NC2 // (2 * len(offsets)))
        esc = out[:, 5] == PAIR_OVERFLOW
        n_esc = jnp.sum(esc, dtype=jnp.int32)
        ecum = jnp.cumsum(esc.astype(jnp.int32))
        ridx = jnp.sum((ecum[None, :] <=
                        jnp.arange(E, dtype=jnp.int32)[:, None])
                       .astype(jnp.int32), axis=1)
        ridx = jnp.clip(ridx, 0, B - 1)
        egood = jnp.arange(E, dtype=jnp.int32) < jnp.minimum(n_esc, E)
        ep1 = tuple(p[:, ridx] for p in planes1)
        ep2 = tuple(p[:, ridx] for p in planes2)
        g1, o1 = _mate_stats(gview, sa, lut2, ep1, kw=kw, n_compact=NC2,
                             n_extend=NS2, max_ml=max_ml,
                             max_per_bucket=cap)
        g2, o2 = _mate_stats(gview, sa, lut2, ep2, kw=kw, n_compact=NC2,
                             n_extend=NS2, max_ml=max_ml,
                             max_per_bucket=cap)
        if capped:   # capped exploration is total by construction
            o1 = jnp.zeros_like(o1)
            o2 = jnp.zeros_like(o2)
        rows2 = _pair_rows(g1, g2, o1, o2, starts, **pair_kw)
        tgt = jnp.where(egood, ridx, jnp.int32(2 ** 30))
        return out.at[tgt].set(rows2, mode="drop")

    if tier2 is not None:
        out = escalate(out, tier2, capped=False)
    if tier3 is not None:
        out = escalate(out, tier3, capped=True)
    return pack_rows6(out) if max_ins <= 65535 else out
