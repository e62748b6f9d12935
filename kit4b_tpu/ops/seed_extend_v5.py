"""Round-3 kalign hot path v5: flattened seed index (positions-in-LUT).

Bit-identical final results to seed_extend_v4.fast_pass_packed_v4 (see the
fast_pass_packed_v5 docstring for the n_esc <= E precondition), with the
tier-1 SA indirection REMOVED. The v4 fused pass is dominated by three
latency-bound row gathers from device memory (LUT pair, SA, genome rows);
the elementwise work (compaction, dedup, extension math) is small. v5
merges the first two: the bucket table stores its first
7 suffix positions INLINE, so one [D, B] row gather of [p0..p6, cnt]
replaces the LUT pair gather AND the entire [NC, B] SA gather.

  lut4 [n_keys, 8] int32 = [sa[lo+0..6] (clamped), cnt]   (~535 MB at
  lut_k=12 — HBM capacity traded for one less latency-bound gather, built
  on device from the existing lut + sa arrays, never crossing the host link)

Reads touching any seed bucket with cnt > 7 ESCALATE (code -3) exactly like
v4's candidate-total overflow, and resolve through the same tier-2 full
lut2+SA path with identical classification — so accepted/rejected sets and
loci stay bit-identical (tests/test_seed_extend_v5.py asserts this on
random and repeat-planted genomes). The host picks v5 only when the index's
bucket histogram predicts a tiny escalation population (KAligner._use_v5);
repeat-dense indexes (config #4 Alu) keep the v4 path.

Reference parity anchors unchanged: CSfxArray::LocateCoreMultiples
(libkit4b/SfxArray.cpp:5806), CKAligner::AlignRead
(ngskit4b/KAligner.cpp:9583), MaxIter ladder (ngskit4b/KAligner.h:53-56).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .seed_extend_fast import _tail_mask, _window_masks
from .seed_extend_v3 import INT32_MAX, MISM_BITS, _classify_compact, \
    pack_result2
from .seed_extend_v4 import _cands_core_v4, _keys_be, words_from_2bit

P_POS = 7   # suffix positions inlined per bucket (col 7 = cnt)


def make_lut4_device(lut, sa) -> jnp.ndarray:
    """[n_keys, 8] int32 flattened bucket table: cols 0..6 = the bucket's
    first 7 suffix positions (sa[lo..lo+6], clamped reads — masked by cnt
    downstream), col 7 = bucket count. Built on device; at lut_k=12 the
    table is 535 MB and must never cross the host link."""
    assert int(lut[-1]) < 2 ** 31, "suffix count must fit int32"

    @jax.jit
    def _build(lut_d, sa_d):
        lut32 = lut_d.astype(jnp.int32)
        lo = lut32[:-1]
        cnt = lut32[1:] - lo
        M = sa_d.shape[0]
        cols = [sa_d[jnp.clip(lo + p, 0, M - 1)].astype(jnp.int32)
                for p in range(P_POS)]
        return jnp.stack(cols + [cnt], axis=1)

    lut_d = lut if isinstance(lut, jnp.ndarray) \
        else jnp.asarray(np.asarray(lut))
    sa_d = sa if isinstance(sa, jnp.ndarray) \
        else jnp.asarray(np.asarray(sa, dtype=np.int32))
    return _build(lut_d, sa_d)


def host_escalation_estimate(lut: np.ndarray, n_windows: int) -> float:
    """Upper-bound estimate of the per-read tier-1 escalation probability:
    a read escalates when ANY of its 2*n_windows seed buckets holds more
    than P_POS suffixes. Windows are approximated as independent draws
    weighted by bucket occupancy (true-locus windows) — a histogram-only
    host-side eligibility check, no device work."""
    cnt = np.diff(np.asarray(lut))
    total = int(cnt.sum())
    if total == 0:
        return 0.0
    frac_high = float(cnt[cnt > P_POS].sum()) / total
    return min(1.0, 2 * n_windows * frac_high)


def _cands_core_v5(gview, lut4, key_lo, planes, *, genome_len, offsets,
                   lut_k, read_len, n_compact, n_extend=None):
    """Tier-1 seed + compact + locus-dedup + extend from the flattened
    bucket table. Same (ids, mm, overflow) contract as _cands_core_v4;
    overflow additionally includes any-seed-bucket-over-P_POS reads."""
    rw, rb, rcw, rcb = planes
    nw, B = rw.shape
    L = read_len
    G = genome_len
    NC = n_compact
    NS = n_extend or NC
    W = len(offsets)
    k = lut_k
    nw2 = nw + 1
    n_keys = lut4.shape[0]
    Gv = gview.shape[0]
    D = 2 * W

    kf, okf = _keys_be(rw, rb, offsets, k)                  # [W, B]
    kr, okr = _keys_be(rcw, rcb, offsets, k)
    keys = jnp.stack([kf, kr], axis=0)                      # [S, W, B]
    key_ok = jnp.stack([okf, okr], axis=0)

    local = keys - key_lo.astype(jnp.int32)
    in_shard = (local >= 0) & (local < n_keys)
    local = jnp.clip(local, 0, n_keys - 1)
    row = lut4[local]                                       # [S, W, B, 8]
    cnt_raw = jnp.where(key_ok & in_shard, row[..., P_POS], 0)
    high = cnt_raw > P_POS
    cnt = jnp.minimum(cnt_raw, P_POS)
    cnt_d = cnt.reshape(D, B)
    posP = row[..., :P_POS].reshape(D, B, P_POS)            # [D, B, 7]

    # --- compaction (v4's cumsum + one-hot machinery on clamped counts) ----
    cum = jnp.cumsum(cnt_d, axis=0)
    total = cum[-1]
    overflow = (total > NC) | jnp.any(high.reshape(D, B), axis=0)
    j = jnp.arange(NC, dtype=jnp.int32)[:, None, None]
    le = (cum[None, :, :] <= j).astype(jnp.int32)
    b = jnp.clip(jnp.sum(le, axis=1), 0, D - 1)
    donehot = (b[:, None, :] ==
               jnp.arange(D, dtype=jnp.int32)[None, :, None])
    cum0 = jnp.concatenate([jnp.zeros((1, B), jnp.int32), cum[:-1]], axis=0)
    prev = jnp.sum(jnp.where(donehot, cum0[None], 0), axis=1)
    jq = jnp.arange(NC, dtype=jnp.int32)[:, None]
    rank = jq - prev                                        # [NC, B]
    slot_ok = jq < jnp.minimum(total, NC)[None, :]
    w_d = b % W
    strand = b // W
    off_np = np.asarray(offsets, np.int32)
    off_b = jnp.sum(jnp.where(
        w_d[:, None, :] == jnp.arange(W, dtype=jnp.int32)[None, :, None],
        jnp.asarray(off_np)[None, :, None], 0), axis=1)

    # suffix position per slot WITHOUT an SA gather: bucket-select each of
    # the 7 inline position columns, then rank-select among them
    sa_pos = jnp.zeros((NC, B), jnp.int32)
    for p in range(P_POS):
        sel = jnp.sum(jnp.where(donehot, posP[None, :, :, p], 0), axis=1)
        sa_pos = sa_pos + jnp.where(rank == p, sel, 0)
    pos = sa_pos - off_b
    valid = slot_ok & (pos >= 0) & (pos + L <= G)

    # --- locus dedup + recompaction (identical to v4) ----------------------
    lid = jnp.where(valid, pos * 2 + strand, INT32_MAX)
    eq = (lid[:, None, :] == lid[None, :, :]) & valid[None, :, :]
    tri = np.tril(np.ones((NC, NC), dtype=bool), -1)
    dup = jnp.any(eq & jnp.asarray(tri)[:, :, None], axis=1)
    keep = valid & ~dup
    n_uniq = jnp.sum(keep, axis=0, dtype=jnp.int32)
    overflow = overflow | (n_uniq > NS)
    kcum = jnp.cumsum(keep.astype(jnp.int32), axis=0)
    j2 = jnp.arange(NS, dtype=jnp.int32)[:, None, None]
    src = jnp.clip(jnp.sum((kcum[None, :, :] <= j2).astype(jnp.int32),
                           axis=1), 0, NC - 1)
    shot = (src[:, None, :] ==
            jnp.arange(NC, dtype=jnp.int32)[None, :, None])
    pos2 = jnp.sum(jnp.where(shot, pos[None], 0), axis=1)
    str2 = jnp.sum(jnp.where(shot, strand[None], 0), axis=1)
    wd2 = jnp.sum(jnp.where(shot, w_d[None], 0), axis=1)
    ok2 = (jnp.arange(NS, dtype=jnp.int32)[:, None]
           < jnp.minimum(n_uniq, NS)[None, :])

    # --- extension: one row-gather per distinct locus (v4 unchanged) -------
    posc = jnp.where(ok2, pos2, 0)
    w0 = jnp.clip(posc >> 4, 0, Gv - 1)
    rows = gview[w0]                                        # [NS, B, 2*nw2]
    rows = jnp.transpose(rows, (0, 2, 1))
    gw = rows[:, :nw2]
    gb = rows[:, nw2:]
    sh = (2 * (posc & 15)).astype(jnp.uint32)[:, None, :]
    hi_sh = jnp.uint32(32) - sh

    def shift_align(words):
        lo_w = words[:, :nw] >> sh
        hi_w = jnp.where(sh == 0, jnp.uint32(0), words[:, 1:] << hi_sh)
        return lo_w | hi_w

    ga = shift_align(gw)
    gba = shift_align(gb)
    st = str2[:, None, :]
    rp = jnp.where(st == 0, rw[None], rcw[None])
    rbad = jnp.where(st == 0, rb[None], rcb[None])
    x = ga ^ rp
    mism = (x | (x >> 1)) & MISM_BITS
    badb = (gba | rbad) & MISM_BITS
    tmask = jnp.asarray(_tail_mask(L, nw))[None, :, None]
    bits = (mism | badb) & tmask
    mm = jnp.sum(jax.lax.population_count(bits), axis=1, dtype=jnp.int32)

    # --- first-exact-window canonicalisation (identical to v4) -------------
    wmask = _window_masks(offsets, k, nw)
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


@functools.partial(
    jax.jit, static_argnames=("genome_len", "offsets", "lut_k",
                              "n_compact", "n_extend", "max_tot_mm",
                              "mm_delta", "read_len", "tier2"))
def fast_pass_packed_v5(gview, sa, lut2, lut4, reads2b, nlist, *,
                        genome_len, offsets, lut_k, n_compact, max_tot_mm,
                        mm_delta, read_len, n_extend=None,
                        tier2=(256, 192, 96)):
    """Drop-in for fast_pass_packed_v4 with the flattened tier-1 index.
    Tier-2 escalation (bucket>P_POS, candidate-total or distinct-loci
    overflow) runs v4's full lut2+SA path on device with big caps.

    Result equivalence: identical to v4's for every read PROVIDED the
    number of escalated reads fits the E tier-2 slots. v5 escalates
    strictly more reads than v4 (every bucket-high read, not just
    capacity overflows), so when n_esc > E the leftover reads return
    class -3 and resolve through the caller's host escalation ladder —
    still correct end to end, at a perf cost. Hosts size E from the
    bucket histogram (KAligner._lut4_for picks v5 only when the
    predicted escalation population is tiny relative to E)."""
    B = reads2b.shape[0]
    planes = words_from_2bit(reads2b, nlist, read_len)
    kw = dict(genome_len=genome_len, offsets=offsets, lut_k=lut_k,
              read_len=read_len)
    ids, mm, overflow = _cands_core_v5(gview, lut4, jnp.int32(0), planes,
                                       n_compact=n_compact,
                                       n_extend=n_extend, **kw)
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
                       .astype(jnp.int32), axis=1)
        ridx = jnp.clip(ridx, 0, B - 1)
        egood = jnp.arange(E, dtype=jnp.int32) < jnp.minimum(n_esc, E)
        eplanes = tuple(p[:, ridx] for p in planes)         # [nw, E]
        ids2, mm2, ovf2 = _cands_core_v4(gview, sa, lut2, jnp.int32(0),
                                         eplanes, n_compact=NC2,
                                         n_extend=NS2, **kw)
        code2, low2, nlow2 = _classify_compact(ids2, mm2, ovf2,
                                               max_tot_mm=max_tot_mm,
                                               mm_delta=mm_delta)
        tgt = jnp.where(egood, ridx, jnp.int32(2 ** 30))
        code = code.at[tgt].set(code2, mode="drop")
        low = low.at[tgt].set(low2, mode="drop")
    return pack_result2(code, low)
