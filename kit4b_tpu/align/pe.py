"""Paired-end alignment: pairing logic over per-mate multiloci hits.

Mirrors the reference's PE handling (ngskit4b/KAligner.cpp:10173-10238
AcceptProvPE cross-product over multiloci hits; :2944 ProcessPairedEnds;
:3333 AlignPartnerRead orphan rescue):

  - both mates aligned independently, keeping up to max_ml loci each;
  - a pair is provisionally accepted when mates hit the same chromosome on
    opposite strands in the proper orientation (leftmost mate forward) with
    observed insert within [pair_min_len, pair_max_len] (-d/-D, defaults
    100/1000);
  - among valid combinations the lowest combined-mismatch pair wins; ties on
    distinct loci reject the pair as multi (matching the reference's unique
    PE requirement);
  - orphan rescue (pemode 1/3): when one mate aligned uniquely and the other
    found nothing acceptable, the partner is re-aligned within the insert
    window around the anchor on the expected strand — here a windowed scan
    using the same packed mismatch scorer over every in-window position.

PE modes (-U): 1 rescue orphans, 2 no rescue, 3/4 as 1/2 but orphans fall
back to SE acceptance.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

from .. import dna
from . import kalign as _k

INT32_MAX = np.iinfo(np.int32).max

PAIR_NONE = 0       # no valid combination
PAIR_ACCEPT = 1
PAIR_MULTI = 2      # distinct-loci tie at the best combined score
PAIR_OVERFLOW = 3   # a side overflowed its candidate tier -> host escalates


@functools.partial(
    __import__("jax").jit,
    static_argnames=("genome_len", "offsets", "lut_k", "n_compact",
                     "max_ml", "max_tot1", "max_tot2", "mm_delta",
                     "min_ins", "max_ins", "max_per_bucket"))
def pe_pass(gview, sa, lut, starts, reads1, reads2, *, genome_len: int,
            offsets: tuple, lut_k: int, n_compact: int, max_ml: int,
            max_tot1: int, max_tot2: int, mm_delta: int,
            min_ins: int, max_ins: int,
            max_per_bucket: int | None = None):
    """Device-side PE pairing: align both mates and evaluate the reference's
    AcceptProvPE cross-product (KAligner.cpp:10173-10238) over their
    multiloci hits entirely on device; one compact [B, 8] int32 result:

      0: best id1 (pos*2+strand)   4: tlen (outer insert)
      1: best id2                  5: pair code (PAIR_*)
      2: mm1                       6: mate1 side code (compact semantics)
      3: mm2                       7: mate2 side code
      8: mate1 low_mm              9: mate2 low_mm

    Both mates share one read length here (same-L batches); mixed-length
    pairs take the host path."""
    import jax.numpy as jnp

    from ..ops import seed_extend_fast as F
    L1 = reads1.shape[1]
    L2 = reads2.shape[1]
    kw = dict(genome_len=genome_len, offsets=offsets, lut_k=lut_k,
              n_compact=n_compact, max_per_bucket=max_per_bucket)
    ids1, mm1, ovf1 = F.fast_candidates(gview, sa, lut, jnp.int32(0),
                                        reads1, **kw)
    ids2, mm2, ovf2 = F.fast_candidates(gview, sa, lut, jnp.int32(0),
                                        reads2, **kw)
    f1 = F.finalize_fast(ids1, mm1, max_ml=max_ml)
    f2 = F.finalize_fast(ids2, mm2, max_ml=max_ml)

    def side_code(f, ovf, max_tot):
        aligned = f["low_mm"] <= max_tot
        unique = (aligned & ~ovf & (f["n_low"] == 1)
                  & ((f["nxt_mm"] - f["low_mm"]) >= mm_delta))
        best = jnp.min(jnp.where(
            (f["hit_mm"] == f["low_mm"][:, None]), f["hit_id"],
            F.INT32_MAX), axis=1)
        return jnp.where(unique, best, jnp.where(aligned, -2, -1))

    code1 = side_code(f1, ovf1, max_tot1)
    code2 = side_code(f2, ovf2, max_tot2)

    h1, m1 = f1["hit_id"], f1["hit_mm"]          # [B, ML]
    h2, m2 = f2["hit_id"], f2["hit_mm"]
    p1 = h1 >> 1
    s1 = h1 & 1
    p2 = h2 >> 1
    s2 = h2 & 1
    ok1 = (h1 != F.INT32_MAX) & (m1 <= max_tot1)
    ok2 = (h2 != F.INT32_MAX) & (m2 <= max_tot2)
    c1 = jnp.searchsorted(starts, p1, side="right")
    c2 = jnp.searchsorted(starts, p2, side="right")

    # cross product [B, ML, ML]
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
    score = jnp.where(ok, m1[:, :, None] + m2[:, None, :], F.INT32_MAX)
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
    # distinct-loci ties at the best score reject the pair (reference
    # unique-PE requirement)
    pflat = jnp.broadcast_to(p1e, (B, ML, ML)).reshape(B, ML * ML)
    qflat = jnp.broadcast_to(p2e, (B, ML, ML)).reshape(B, ML * ML)
    okf = ok.reshape(B, ML * ML)
    tie = jnp.any(okf & (flat == best[:, None])
                  & ((pflat != take(pflat, besti)[:, None])
                     | (qflat != take(qflat, besti)[:, None])), axis=1)
    have = best != F.INT32_MAX
    overflow = ovf1 | ovf2
    pcode = jnp.where(overflow, PAIR_OVERFLOW,
                      jnp.where(~have, PAIR_NONE,
                                jnp.where(tie, PAIR_MULTI, PAIR_ACCEPT)))
    return jnp.stack([jnp.where(have, bid1, -1),
                      jnp.where(have, bid2, -1),
                      bmm1, bmm2,
                      jnp.where(have, btlen, 0),
                      pcode, code1, code2,
                      f1["low_mm"], f2["low_mm"]], axis=1)

NAR_PE_ACCEPTED = _k.NAR_ACCEPTED
NAR_PE_NOPAIR = "nopair"
NAR_PE_INSERT = "badinsert"


@dataclass
class PePair:
    nar: str                      # accepted / nopair / badinsert / ...
    r1: _k.AlignResult | None = None
    r2: _k.AlignResult | None = None
    tlen: int = 0                 # observed insert (outer distance)
    rescued: int = 0              # 1 or 2 if that mate was orphan-rescued


def _hits_of(res: _k.AlignResult, hit_ids, hit_mms, max_tot_mm):
    """Usable loci for pairing: all reported hits with mm <= budget."""
    out = []
    for hid, hmm in zip(hit_ids, hit_mms):
        if hid == INT32_MAX or hmm > max_tot_mm:
            continue
        out.append((int(hid) >> 1, int(hid) & 1, int(hmm)))
    return out


class _LazyRecs:
    """Sequence view over an [N, L] code matrix that materialises
    SeqRecord objects only where individually indexed (escalation
    residues, rescue anchors) — the batch paths slice the matrix."""

    def __init__(self, codes, names):
        self.codes_matrix = np.ascontiguousarray(codes, dtype=np.uint8)
        self._names = names if isinstance(names, list) else list(names)

    def __len__(self):
        return len(self.codes_matrix)

    def __getitem__(self, i):
        from ..io.fasta import SeqRecord
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        return SeqRecord(self._names[i], "", self.codes_matrix[i])


class PeAligner:
    """Paired-end driver over a base KAligner."""

    use_packed = True   # False forces the round-2 byte-tensor device path

    def __init__(self, aligner: _k.KAligner, *,
                 pair_min_len: int = 100, pair_max_len: int = 1000,
                 pe_mode: int = 2,
                 escalation: tuple = ((2048, 256), (256, 2048))):
        self.al = aligner
        self.min_len = pair_min_len
        self.max_len = pair_max_len
        self.pe_mode = pe_mode
        # (batch, candidate-capacity) device escalation tiers for pairs
        # whose tier-1 candidate compaction overflowed
        self.escalation = escalation
        # in-graph tier-2 of the packed pass (E slots, NC, NS); None
        # disables it (escalation handles everything host-side)
        self.tier2 = (1024, 192, 96)
        g = aligner.index.genome
        self._chrom_of = g  # for same-chrom checks via locate

    def _same_chrom(self, p1: int, p2: int) -> bool:
        g = self.al.index.genome
        c1 = np.searchsorted(g.starts, p1, side="right")
        c2 = np.searchsorted(g.starts, p2, side="right")
        return c1 == c2

    def _valid_pair(self, h1, h2, L1: int, L2: int):
        """Orientation + insert check. Returns insert length or None.

        Default PE library (FR): forward mate leftmost, reverse mate
        rightmost; insert = outer distance.
        """
        p1, s1, _ = h1
        p2, s2, _ = h2
        if s1 == s2:
            return None
        if not self._same_chrom(p1, p2):
            return None
        if s1 == 0:  # mate1 forward, mate2 reverse: p1 <= p2 end
            left, right_end = p1, p2 + L2
            if p2 < p1:
                return None
        else:        # mate2 forward
            left, right_end = p2, p1 + L1
            if p1 < p2:
                return None
        insert = right_end - left
        if not (self.min_len <= insert <= self.max_len):
            return None
        return insert

    def align_pairs_arrays(self, codes1: np.ndarray, codes2: np.ndarray,
                           names1=None, names2=None):
        """Array-native align_pairs: [N, L] uint8 code matrices in,
        (rec1, rec2, PePair) stream out — the per-record Python
        marshaling (np.stack over N SeqRecord objects per pass) is
        skipped; records are materialised lazily from matrix rows."""
        from ..io.fasta import SeqRecord
        n = len(codes1)
        recs1 = _LazyRecs(codes1, names1 or (f"r1_{i}" for i in range(n)))
        recs2 = _LazyRecs(codes2, names2 or (f"r2_{i}" for i in range(n)))
        yield from self._align_pairs_device(recs1, recs2)

    def align_pairs(self, recs1, recs2):
        """Align paired record lists; yields (rec1, rec2, PePair).

        Uniform-length pairs run the device pairing pass (pe_pass); mixed
        lengths fall back to the host cross-product."""
        recs1, recs2 = list(recs1), list(recs2)
        assert len(recs1) == len(recs2), "PE file length mismatch"
        lens = {(len(a.codes), len(b.codes))
                for a, b in zip(recs1, recs2)}
        if len(lens) == 1 and len(recs1[0].codes) == len(recs2[0].codes):
            yield from self._align_pairs_device(recs1, recs2)
            return
        res1 = {id(r): v for r, v in zip(recs1, self._align_all(recs1))}
        res2 = {id(r): v for r, v in zip(recs2, self._align_all(recs2))}
        for r1, r2 in zip(recs1, recs2):
            yield r1, r2, self._pair(r1, r2, res1[id(r1)], res2[id(r2)])

    def _align_pairs_device(self, recs1, recs2):
        import jax
        import jax.numpy as jnp
        al = self.al
        g = al.index.genome
        L = len(recs1[0].codes)
        _, max_tot = al.schedule_for(L)
        gview, sa, lut, lut2 = al._device_for(L)
        starts_d = jnp.asarray(np.asarray(g.starts, np.int32))
        B = al.batch_size
        kw = dict(genome_len=len(g.seq),
                  offsets=al._offsets_for(L, max_tot),
                  lut_k=al.index.lut_k, n_compact=al.n_compact,
                  max_ml=al.max_ml, max_tot1=max_tot, max_tot2=max_tot,
                  mm_delta=al.mm_delta, min_ins=self.min_len,
                  max_ins=self.max_len)
        # production path: the TOTAL packed-native PE pass (one submission
        # resolves seed+extend, pairing, tier-2 AND the capped final tier
        # on device — ops/pe_packed.py); the round-2 byte-tensor pe_pass
        # stays as the fallback for genomes past the int32 locus ceiling
        use_packed = (self.use_packed and lut2 is not None
                      and 2 * len(g.seq) + 1 < 2 ** 31)
        pkw = dict(genome_len=len(g.seq),
                   offsets=al._offsets_for(L, max_tot),
                   lut_k=al.index.lut_k, read_len=L,
                   n_compact=al.n_compact, n_extend=al.n_extend,
                   max_ml=al.max_ml, max_tot=max_tot,
                   mm_delta=al.mm_delta, min_ins=self.min_len,
                   max_ins=self.max_len,
                   tier2=self.tier2 if self.tier2 is None
                   else (min(B, self.tier2[0]),) + tuple(self.tier2[1:]),
                   tier3=None)
        # context for the deep escalation tier (repeat-dense pairs past
        # the in-graph tier-2 slots run ops/seed_extend_deep.deep_pe_pass)
        self._pctx = dict(gview=gview, sa=sa, lut2=lut2, starts_d=starts_d,
                          L=L, max_tot=max_tot,
                          offsets=al._offsets_for(L, max_tot))

        def submit(i0):
            from ..ops import pe_packed
            from .kalign import pack_reads_2bit
            if isinstance(recs1, _LazyRecs):
                a1 = recs1.codes_matrix[i0:i0 + B]
                a2 = recs2.codes_matrix[i0:i0 + B]
            else:
                a1 = np.stack([r.codes for r in recs1[i0:i0 + B]])
                a2 = np.stack([r.codes for r in recs2[i0:i0 + B]])
            if len(a1) < B:
                a1 = np.concatenate(
                    [a1, np.repeat(a1[:1], B - len(a1), axis=0)])
                a2 = np.concatenate(
                    [a2, np.repeat(a2[:1], B - len(a2), axis=0)])
            if use_packed:
                r2b1, nl1, ok1 = pack_reads_2bit(a1)
                r2b2, nl2, ok2 = pack_reads_2bit(a2)
                if ok1 and ok2:
                    handles = (jnp.asarray(r2b1), jnp.asarray(nl1),
                               jnp.asarray(r2b2), jnp.asarray(nl2))
                    dev = pe_packed.pe_pass_packed(
                        gview, sa, lut2, starts_d, *handles, **pkw)
                    return ("packed", dev, handles, (a1, a2))
            return ("old", pe_pass(gview, sa, lut, starts_d, a1, a2, **kw),
                    None, (a1, a2))

        # SUPERBATCH grouping (round 5): submit SB batches' tier-1/2
        # passes together, then resolve their escalation POOLED — every
        # stage (overflow rescue scans, deep waves, orphan rescue) runs
        # once per group with all segments' device calls submitted
        # before any collection, instead of once per batch. Pooling
        # cuts the host-device sync points ~SBx. The next group's tier-1/2
        # is submitted before the current group's escalation so the
        # device queue never drains.
        SB = getattr(self, "superbatch", 4)
        starts_idx = list(range(0, len(recs1), B))
        groups = [starts_idx[i:i + SB]
                  for i in range(0, len(starts_idx), SB)]
        pending_group = None
        for grp in groups:
            subs = [(i0, submit(i0)) for i0 in grp]
            if pending_group is not None:
                yield from self._drain_group(pending_group, recs1, recs2,
                                             max_tot)
            pending_group = subs
        if pending_group is not None:
            yield from self._drain_group(pending_group, recs1, recs2,
                                         max_tot)

    def _drain_group(self, subs, recs1, recs2, max_tot):
        """Resolve one superbatch group. Consecutive 'packed' batches
        concatenate into one pooled escalation (global rows r map to
        segment r // batch_size); any 'old'-kind fallback batch drains
        through the per-batch path."""
        import jax
        B = self.al.batch_size
        if any(sub[0] != "packed" for _, sub in subs):
            for i0, sub in subs:
                yield from self._drain_device(i0, sub, recs1, recs2,
                                              max_tot)
            return
        from ..ops.pe_packed import unpack_rows12
        import jax.numpy as jnp
        i0g = subs[0][0]
        # one concatenated fetch for the whole group's tier-1/2 rows
        # (one host sync instead of SB)
        allout = unpack_rows12(np.array(jax.device_get(
            jnp.concatenate([sub[1] for _, sub in subs], axis=0))))
        outs, handles_list, a1s, a2s = [], [], [], []
        for si, (i0, (kind, dev, handles, arrs)) in enumerate(subs):
            n = min(B, len(recs1) - i0)
            outs.append(allout[si * B:si * B + n])
            handles_list.append(handles)
            a1s.append(arrs[0][:n])
            a2s.append(arrs[1][:n])
        out = np.concatenate(outs)
        arrs = (np.concatenate(a1s), np.concatenate(a2s))
        yield from self._resolve_rows(out, len(out), i0g, handles_list,
                                      arrs, recs1, recs2, max_tot)

    # deep-tier E quanta: escalated-pair subsets pad to these static
    # shapes so only a few deep executables ever compile (rescue-first
    # shrinks the deep residue, so the mid quantum earns its compile:
    # a 300-row residue pays E=1024, not 4096; the 16384 quantum lets a
    # whole superbatch group's dual rows run as ONE device call)
    _DEEP_QUANTA = (256, 1024, 4096, 16384)
    # deep candidate budget (n_blocks, block_size) by sensitivity mode.
    # Measured on the config-4 Alu workload: budget 512 vs 2048 costs only
    # ~0.7% pair acceptance at identical 100% true-locus precision —
    # repeat-interior reads resolve through the orphan-rescue window scan
    # anchored on their (usually non-repeat) mate, not through bucket
    # exploration, so the deeper lottery buys little (.verify_scratch
    # deep_quality protocol, 2026-08-20). The reference MaxIter skip
    # applies on top (ops/seed_extend_deep).
    # Round-5 re-measurement with rarest-K selection (_DEEP_N_SEL): deep
    # cost is linear in C and rarest-4 at C=128 (cap 32/bucket on the 4
    # least-populated buckets) ACCEPTS MORE pairs than uniform C=512
    # (cap 28 over 18 buckets) at equal 100% true-locus — 31,805 vs
    # 31,756 on 32K config-4 pairs — at ~4x less device cost.
    # chip A/B (config 4): (1,64)K4 = 75.3K reads/s at 63,578 accepted
    # vs (1,128)K4 = 68.6K at 63,581 — 10% throughput for 3 pairs in
    # 65,536; the ladder keeps the wider budgets for -m more/ultra
    _DEEP_BLOCKS_BY_SENS = {"less": (1, 32), "default": (1, 64),
                            "more": (4, 128), "ultra": (16, 128)}
    # rarest-K window selection for the deep tier (None = all windows):
    # explore only the K least-populated seed buckets per read at cap
    # C//K — highest true-locus odds per gathered candidate
    _DEEP_N_SEL_BY_SENS = {"less": 4, "default": 4, "more": 6,
                           "ultra": None}

    @property
    def _DEEP_N_SEL(self):
        if "_deep_n_sel" in self.__dict__:
            return self.__dict__["_deep_n_sel"]
        return self._DEEP_N_SEL_BY_SENS.get(self.al.sens, 4)

    @_DEEP_N_SEL.setter
    def _DEEP_N_SEL(self, v):
        self.__dict__["_deep_n_sel"] = v

    @property
    def _DEEP_BLOCKS(self):
        if "_deep_blocks" in self.__dict__:
            return self.__dict__["_deep_blocks"]
        return self._DEEP_BLOCKS_BY_SENS.get(self.al.sens, (4, 128))

    @_DEEP_BLOCKS.setter
    def _DEEP_BLOCKS(self, v):
        self.__dict__["_deep_blocks"] = v

    def _deep_escalate(self, out, ovf, handles, i0=None, recs1=None,
                       recs2=None, max_tot=None, arrs=None, pre=None):
        """Resolve PAIR_OVERFLOW rows with the deep capped kernel
        (ops/seed_extend_deep.deep_pe_pass) — one device submission per
        E-quantum chunk, mates gathered on device from the batch's
        already-uploaded 2-bit reads. Pairs are grouped by WHICH mate
        overflowed (rows cols 10/11): single-overflow pairs pay one deep
        mate plus a cheap tier-1 rescore of the clean mate.

        Dual-overflow pairs are STAGED (round 5): deep mate 1 only; if
        that yields a unique anchor, the partner resolves through the
        exhaustive insert-window rescue (the reference's
        AlignPartnerRead flow) instead of a second deep exploration —
        only rows whose mate-1 deep was non-unique pay the full
        two-mate deep. Returns {row: PePair} for rescue-resolved rows.

        Probe words come from the group-resident planes (built by
        _resolve_rows), so chunks address GLOBAL group rows and every
        wave submits all its chunks before collecting any. `pre` is an
        already-submitted stage-1 devs list (from _deep_submit_stage1):
        the caller submitted deep work before running the rescue scans
        so deep computes while the host processes rescue rows."""
        resolved: dict[int, PePair] = {}
        kw = self._deep_kw()

        def wave(groups):
            self._deep_collect(out, self._deep_submit(out, groups, kw))

        o1 = out[ovf, 10] != 0
        o2 = out[ovf, 11] != 0
        can_rescue = self.pe_mode in (1, 3) and recs1 is not None
        if not can_rescue:
            # no-rescue modes (-U2/-U4) cannot stage through the window
            # scan: dual rows need both mates' stats in one cross-product
            # call, at the wider round-4 budget (uniform windows)
            NBb, NCbb = {"less": (2, 128), "more": (16, 128),
                         "ultra": (64, 128)}.get(self.al.sens, (4, 128))
            kw.update(n_blocks=NBb, block_size=NCbb, n_sel=None)
            wave(((ovf[o1 & ~o2], True, False),
                  (ovf[~o1 & o2], False, True),
                  (ovf[o1 & o2], True, True)))
            left = ovf[out[ovf, 5] == PAIR_OVERFLOW]
            if len(left):
                wave(((left, True, True),))
            return resolved
        if pre is not None:
            self._deep_collect(out, pre)
        else:
            # stage 1: dual-overflow rows deep ONLY mate 1 (the
            # partner's cheap rescore re-overflows, re-flagging the row
            # with mate 1's deep side code in col 6 for the rescue
            # stage below)
            wave(((ovf[o1 & ~o2], True, False),
                  (ovf[~o1 & o2], False, True),
                  (ovf[o1 & o2], True, False)))

        def rescue_left():
            left = ovf[out[ovf, 5] == PAIR_OVERFLOW]
            if len(left):
                # rows whose deep mate came back unique resolve via the
                # exhaustive insert-window scan (AlignPartnerRead,
                # KAligner.cpp:3333) — strictly stronger in-window
                # coverage than a second capped bucket exploration, at
                # ~2 orders less cost. No dead-marking: a capped deep's
                # -1 is not proof of absence.
                resolved.update(self._rescue_overflow(
                    out, left, i0, recs1, recs2, max_tot, arrs,
                    dead_mark=False))

        return self._deep_finish(out, ovf, i0, recs1, recs2, max_tot,
                                 arrs, wave, resolved, rescue_left)

    def _deep_kw(self):
        ctx = self._pctx
        al = self.al
        NB, NCb = self._DEEP_BLOCKS
        return dict(genome_len=len(al.index.genome.seq),
                    offsets=ctx["offsets"], lut_k=al.index.lut_k,
                    read_len=ctx["L"], n_blocks=NB, block_size=NCb,
                    max_ml=al.max_ml, max_tot=ctx["max_tot"],
                    mm_delta=al.mm_delta, min_ins=self.min_len,
                    max_ins=self.max_len, n_compact=al.n_compact,
                    n_extend=al.n_extend, n_sel=self._DEEP_N_SEL)

    def _deep_submit(self, out, groups, kw):
        """Submit deep_pe_pass_planes calls for every E-quantum chunk of
        every (rows, deep1, deep2) group; returns [(chunk, dev), ...]
        without collecting."""
        import jax.numpy as jnp

        from ..ops.seed_extend_deep import deep_pe_pass_planes
        ctx = self._pctx
        P1, P2 = ctx["planes"]
        devs = []
        step = self._DEEP_QUANTA[-1]
        for rows, d1, d2 in groups:
            if len(rows) == 0:
                continue
            for s in range(0, len(rows), step):
                chunk = rows[s:s + step]
                E = next(q for q in self._DEEP_QUANTA if q >= len(chunk))
                idxs = np.full(E, chunk[0], np.int32)
                idxs[:len(chunk)] = chunk
                devs.append((chunk, deep_pe_pass_planes(
                    ctx["gview"], ctx["sa"], ctx["lut2"],
                    ctx["starts_d"], P1, P2, jnp.asarray(idxs),
                    deep1=d1, deep2=d2, **kw)))
        return devs

    def _deep_collect(self, out, devs):
        import jax

        from ..ops.pe_packed import unpack_rows12
        for chunk, dev in devs:
            out[chunk] = unpack_rows12(
                np.array(jax.device_get(dev)))[:len(chunk)]

    def _deep_submit_stage1(self, out, ovf):
        """Submit stage-1 deep waves (no collection) for rows known to
        need deep work — callers run the rescue scans and their host
        processing while these compute, then pass the devs back via
        _deep_escalate(pre=...)."""
        o1 = out[ovf, 10] != 0
        o2 = out[ovf, 11] != 0
        return self._deep_submit(out, ((ovf[o1 & ~o2], True, False),
                                       (ovf[~o1 & o2], False, True),
                                       (ovf[o1 & o2], True, False)),
                                 self._deep_kw())

    def _deep_finish(self, out, ovf, i0, recs1, recs2, max_tot, arrs,
                     wave, resolved, rescue_left):
        rescue_left()
        # stage 2b: rows whose mate-1 deep found NOTHING in budget
        # (code -1 — the cap can miss loci the exhaustive scan finds):
        # deep mate 2 instead, then rescue mate 1 from its anchor. With
        # mate-1 deep empty, the dual cross-product is empty too, so
        # rows that still fail are unpairable: PAIR_NONE.
        left = ovf[out[ovf, 5] == PAIR_OVERFLOW]
        d2 = left[(out[left, 10] == 0) & (out[left, 6] == -1)]
        if len(d2):
            wave(((d2, False, True),))
            rescue_left()
            dead = d2[out[d2, 5] == PAIR_OVERFLOW]
            out[dead, 5] = PAIR_NONE
        # stage 3 residue (non-unique deep anchors — PE disambiguation
        # may still resolve them through the dual cross-product — or a
        # clean-mate rescore that re-overflowed after resolving through
        # the in-graph tier-2): both mates deep — deep never overflows
        left = ovf[out[ovf, 5] == PAIR_OVERFLOW]
        if len(left):
            wave(((left, True, True),))
        return resolved

    def _drain_device(self, i0, sub, recs1, recs2, max_tot):
        import jax
        kind, dev, handles, arrs = sub
        out = np.array(jax.device_get(dev))
        if kind == "packed":
            from ..ops.pe_packed import unpack_rows12
            out = unpack_rows12(out)
        B = self.al.batch_size
        n = min(B, len(recs1) - i0)
        yield from self._resolve_rows(out, n, i0, handles, arrs, recs1,
                                      recs2, max_tot,
                                      packed=kind == "packed")

    def _resolve_rows(self, out, n, i0, handles, arrs, recs1, recs2,
                      max_tot, packed=True):
        import jax
        import jax.numpy as jnp
        if hasattr(self, "_pctx"):
            # build the group-resident word planes ONCE: every deep wave
            # and rescue scan gathers probe words from them with global
            # row indices, so no per-segment device calls and no probe
            # bytes re-cross the link
            if packed:
                from ..ops.seed_extend_v4 import planes_2bit
                L = self._pctx["L"]
                hlist = handles if isinstance(handles, list) \
                    else [handles]
                c1 = [planes_2bit(h[0], h[1], read_len=L) for h in hlist]
                c2 = [planes_2bit(h[2], h[3], read_len=L) for h in hlist]
                cat = (lambda cs: tuple(
                    jnp.concatenate([c[k] for c in cs], axis=1)
                    if len(cs) > 1 else cs[0][k] for k in range(4)))
                self._pctx["planes"] = (cat(c1), cat(c2))
            else:
                self._pctx["planes"] = None
        # escalate overflowed pairs through DEVICE pe_pass tiers with
        # larger candidate capacities (the PE analog of the SE
        # escalation ladder / reference MaxIter sensitivity tiers,
        # KAligner.h:53-56). The packed pass resolves scattered overflow
        # in-graph (tier-2); repeat-dense residues take the deep capped
        # kernel; the fallback pe_pass path keeps the host ladder.
        ovf = np.nonzero(out[:n, 5] == PAIR_OVERFLOW)[0]
        pre_rescued: dict[int, PePair] = {}
        if packed and len(ovf) and self.pe_mode in (1, 3):
            # RESCUE BEFORE DEEP (the reference's own flow): a mate whose
            # core buckets overflow is, under MaxIter semantics, "too
            # many matches" = unaligned (SfxArray.cpp:6592) — the
            # reference then rescues it from the uniquely aligned anchor
            # (AlignPartnerRead, KAligner.cpp:3333), never deep-exploring
            # the repeat. The exhaustive insert-window scan both beats
            # the capped bucket lottery on quality (it cannot miss an
            # in-window locus) and costs ~2 orders less than the deep
            # kernel, which now only sees the residue — and that residue
            # is classified up front so its stage-1 deep waves are
            # SUBMITTED before the rescue scans collect: deep computes
            # while the host processes rescue rows.
            o1 = out[ovf, 10] != 0
            o2 = out[ovf, 11] != 0
            c1 = out[ovf, 6]
            c2 = out[ovf, 7]
            if self.pe_mode in (1, 2):
                dead = ovf[(o1 & ~o2 & (c2 == -1))
                           | (o2 & ~o1 & (c1 == -1))]
                out[dead, 5] = PAIR_NONE
            resc = (o2 & ~o1 & (c1 >= 0)) | (o1 & ~o2 & (c2 >= 0))
            deep_rows = ovf[~resc & (out[ovf, 5] == PAIR_OVERFLOW)]
            pre = self._deep_submit_stage1(out, deep_rows) \
                if len(deep_rows) else None
            pre_rescued = self._rescue_overflow(
                out, ovf[resc], i0, recs1, recs2, max_tot, arrs,
                dead_mark=False)
            if pre is not None:
                pre_rescued.update(self._deep_escalate(
                    out, deep_rows, handles, i0=i0, recs1=recs1,
                    recs2=recs2, max_tot=max_tot, arrs=arrs, pre=pre))
            ovf = ovf[out[ovf, 5] == PAIR_OVERFLOW]
        elif packed and len(ovf):
            pre_rescued = self._rescue_overflow(out, ovf, i0, recs1,
                                                recs2, max_tot, arrs)
            ovf = ovf[out[ovf, 5] == PAIR_OVERFLOW]
            if len(ovf):
                pre_rescued.update(self._deep_escalate(
                    out, ovf, handles, i0=i0, recs1=recs1, recs2=recs2,
                    max_tot=max_tot, arrs=arrs))
                ovf = ovf[out[ovf, 5] == PAIR_OVERFLOW]
        for ti, (bt, nct) in enumerate(self.escalation):
            if len(ovf) == 0:
                break
            final = ti == len(self.escalation) - 1
            # submit every chunk of this tier before collecting any:
            # the calls are independent, so dispatch + h2d pipeline on
            # the device queue instead of paying a blocking round-trip
            # per chunk
            devs = []
            for s in range(0, len(ovf), bt):
                chunk = ovf[s:s + bt]
                devs.append((chunk, self._pe_pass_subset(
                    [recs1[i0 + int(i)] for i in chunk],
                    [recs2[i0 + int(i)] for i in chunk], bt, nct,
                    capped=final, block=False)))
            for chunk, dev in devs:
                out[chunk] = np.array(jax.device_get(dev))[:len(chunk)]
            ovf = ovf[out[ovf, 5] == PAIR_OVERFLOW]
        # anything past the final tier takes the host full-stats path
        esc = {}
        if len(ovf):
            sub1 = [recs1[i0 + int(i)] for i in ovf]
            sub2 = [recs2[i0 + int(i)] for i in ovf]
            a1 = self._align_all(sub1)
            a2 = self._align_all(sub2)
            for j, i in enumerate(ovf):
                esc[int(i)] = self._pair(sub1[j], sub2[j], a1[j], a2[j])
        rescues = self._batch_rescue(out, n, i0, recs1, recs2, max_tot,
                                     arrs=arrs) \
            if self.pe_mode in (1, 3) else {}
        rows_l = out[:n].tolist()   # one bulk convert: the per-row loop
        #                             then touches only Python ints
        for i in range(n):
            r1, r2 = recs1[i0 + i], recs2[i0 + i]
            row = rows_l[i]
            if row[5] == PAIR_OVERFLOW:
                yield r1, r2, esc[i]
                continue
            yield r1, r2, self._pair_from_row(
                r1, r2, row, max_tot,
                rescue=pre_rescued.get(i) or rescues.get(i))

    def _batch_rescue(self, out, n, i0, recs1, recs2, max_tot,
                      arrs=None) -> dict:
        """Device orphan rescue: one window_scan batch over every
        PAIR_NONE row with exactly one uniquely-aligned mate
        (AlignPartnerRead, KAligner.cpp:3333 — here a dense on-device
        mismatch scan of the insert window). Row selection and probe
        construction are vectorized when the batch code arrays are
        available (arrs = (a1, a2) from the submit step)."""
        c1 = out[:n, 6].astype(np.int64)
        c2 = out[:n, 7].astype(np.int64)
        is_none = out[:n, 5] == PAIR_NONE
        m2 = is_none & (c1 >= 0) & (c2 == -1)   # anchor 1, rescue mate 2
        m1 = is_none & (c2 >= 0) & (c1 == -1)   # anchor 2, rescue mate 1
        ridx = np.concatenate([np.nonzero(m2)[0], np.nonzero(m1)[0]])
        if len(ridx) == 0:
            return {}
        anchor_who = np.concatenate(
            [np.ones(int(m2.sum()), np.int64),
             np.full(int(m1.sum()), 2, np.int64)])
        return self._window_rescue(out, ridx, anchor_who, i0, recs1,
                                   recs2, max_tot, arrs)

    def _rescue_overflow(self, out, ovf, i0, recs1, recs2, max_tot,
                         arrs=None, dead_mark: bool = True) -> dict:
        """Rescue-before-deep for PAIR_OVERFLOW rows (pemode 1/3).

        A pair where exactly ONE mate overflowed its candidate tier while
        the other aligned uniquely is resolved by the exhaustive
        insert-window scan anchored on the clean mate — the reference's
        AlignPartnerRead flow for a partner with too many matches
        (KAligner.cpp:3333; MaxIter skip SfxArray.cpp:6592). The scan
        enumerates every in-window locus, a strict superset of what any
        capped bucket exploration could pair against, so acceptance
        decisions dominate the deep tier's. Resolved rows (accepted or
        proven unpairable) leave PAIR_OVERFLOW; the deep kernel only
        sees the residue (dual overflow / non-unique anchors).

        Additionally (dead_mark=True, valid only when the clean side
        carries COMPLETE tier stats — not a capped deep that can miss
        loci), pemode 1/2 rows whose CLEAN mate found nothing (code -1)
        can never pair — marked PAIR_NONE without any deep work."""
        o1 = out[ovf, 10] != 0
        o2 = out[ovf, 11] != 0
        c1 = out[ovf, 6].astype(np.int64)
        c2 = out[ovf, 7].astype(np.int64)
        if dead_mark and self.pe_mode in (1, 2):
            dead = ovf[(o1 & ~o2 & (c2 == -1)) | (o2 & ~o1 & (c1 == -1))]
            out[dead, 5] = PAIR_NONE
        if self.pe_mode not in (1, 3):
            return {}
        r_m2 = ovf[o2 & ~o1 & (c1 >= 0)]   # anchor mate1, rescue mate 2
        r_m1 = ovf[o1 & ~o2 & (c2 >= 0)]   # anchor mate2, rescue mate 1
        ridx = np.concatenate([r_m2, r_m1])
        if len(ridx) == 0:
            return {}
        anchor_who = np.concatenate(
            [np.ones(len(r_m2), np.int64), np.full(len(r_m1), 2,
                                                   np.int64)])
        res = self._window_rescue(out, ridx, anchor_who, i0, recs1,
                                  recs2, max_tot, arrs)
        resolved = {}
        for i, pp in res.items():
            # success -> accepted pair; failure -> partner absent from
            # the insert window: the pair is NONE (the overflowed mate
            # is 'too many matches' under reference semantics). Either
            # way the row leaves PAIR_OVERFLOW; the overflowed mate's
            # side code becomes -2 so the PAIR_NONE orphan-rescue pass
            # does not re-scan the same window.
            out[i, 5] = PAIR_NONE
            out[i, 7 if int(out[i, 10]) == 0 else 6] = -2
            if pp is not None:
                resolved[i] = pp
        return resolved

    def _window_rescue(self, out, ridx, anchor_who, i0, recs1, recs2,
                       max_tot, arrs=None) -> dict:
        """Batched insert-window scans: for each row i in ridx, rescue
        the orphan mate (mate 2 when anchor_who==1 else mate 1) around
        the anchor mate's unique locus (row col 6/7). Returns
        {row: PePair | None} covering every selected row."""
        import jax
        import jax.numpy as jnp

        from ..ops import seed_extend_fast as F
        c1 = out[:, 6].astype(np.int64)
        c2 = out[:, 7].astype(np.int64)
        code = np.where(anchor_who == 1, c1[ridx], c2[ridx])
        apos = code >> 1
        astrand = code & 1
        g = self.al.index.genome
        L1 = len(recs1[i0].codes)
        L2 = len(recs2[i0].codes)
        gview, _, _, _ = self.al._device_for(max(L1, L2))
        scan_len = self.max_len - self.min_len + 1

        La = np.where(anchor_who == 1, L1, L2)
        Lo = np.where(anchor_who == 1, L2, L1)
        want_strand = np.where(astrand == 0, 1, 0)
        lo_all = np.where(astrand == 0, apos + self.min_len - Lo,
                          apos + La - self.max_len).astype(np.int32)
        out_map: dict[int, PePair | None] = {}
        RB = 4096
        QUANTA = (512, 1024, 2048, RB)
        devs = []
        hl = getattr(self, "_pctx", {}).get("planes") \
            if arrs is not None else None
        # group rescues by ORPHAN length: a mate-2 orphan (anchor 1) has
        # length L2, a mate-1 orphan L1 — the scans score every probe
        # column, so unequal-length orphans cannot share one padded
        # stack; each group scans at its own probe width. Skipped when
        # the device-gather path below serves all rows.
        if hl is not None and L1 == L2:
            groups = []
        elif arrs is not None and L1 == L2:
            a1, a2 = arrs
            orphan_all = np.where((anchor_who == 1)[:, None],
                                  a2[ridx], a1[ridx])
            groups = [(np.arange(len(ridx)), orphan_all)]
        else:
            groups = []
            for who in (1, 2):
                sel_t = np.nonzero(anchor_who == who)[0]
                if not len(sel_t):
                    continue
                src = recs2 if who == 1 else recs1
                groups.append((sel_t, np.stack(
                    [src[i0 + int(ridx[t])].codes for t in sel_t])))
        if hl is not None and L1 == L2:
            # DEVICE probe gather (round 5): the orphan mates' words sit
            # in the group-resident planes — ship only row indices and
            # window starts (~16 B/row), gather + revcomp-select on
            # device (F.window_scan_pe). One call per quantum chunk over
            # the WHOLE group.
            P1, P2 = hl
            orphan_who = np.where(anchor_who == 1, 2, 1)
            RBW = 16384
            QW = QUANTA + (RBW,)
            for s in range(0, len(ridx), RBW):
                tsel = np.arange(s, min(s + RBW, len(ridx)))
                q = next(x for x in QW if x >= len(tsel))
                li = np.zeros(q, np.int32)
                li[:len(tsel)] = ridx[tsel]
                wh = np.full(q, 1, np.int32)
                wh[:len(tsel)] = orphan_who[tsel]
                ws_ = np.zeros(q, np.int32)
                ws_[:len(tsel)] = want_strand[tsel]
                st_ = np.zeros(q, np.int32)
                st_[:len(tsel)] = lo_all[tsel]
                devs.append((tsel, F.window_scan_pe(
                    gview, P1, P2, jnp.asarray(li),
                    jnp.asarray(wh), jnp.asarray(ws_),
                    jnp.asarray(st_), genome_len=len(g.seq),
                    scan_len=scan_len, read_len=L1)))
        from .kalign import pack_reads_2bit
        for sel_t, orphan in groups:
            rc = dna._COMPLEMENT[orphan][:, ::-1]
            probes_all = np.where((want_strand[sel_t] == 0)[:, None],
                                  orphan, rc)
            Lg = probes_all.shape[1]
            for s in range(0, len(sel_t), RB):
                e = min(s + RB, len(sel_t))
                # pad to the smallest quantum (fewer compiled shapes,
                # no full-RB padding waste for small residues)
                q = next(x for x in QUANTA if x >= e - s)
                probes = np.zeros((q, Lg), np.uint8)
                probes[:e - s] = probes_all[s:e]
                starts = np.zeros(q, np.int32)
                starts[:e - s] = lo_all[sel_t[s:e]]
                # 2-bit packed probes + the gather-free phase-sliced scan
                # (h2d 4x smaller, compute ~12x cheaper than the
                # row-gather scan)
                r2b, nl, pok = pack_reads_2bit(probes)
                if pok:
                    devs.append((sel_t[s:e], F.window_scan_packed(
                        gview, jnp.asarray(r2b), jnp.asarray(nl),
                        jnp.asarray(starts), genome_len=len(g.seq),
                        scan_len=scan_len, read_len=Lg)))
                else:
                    devs.append((sel_t[s:e], F.window_scan(
                        gview, jnp.asarray(probes), jnp.asarray(starts),
                        genome_len=len(g.seq), scan_len=scan_len)))
        starts_g = g.starts
        for tsel, dev in devs:
            best, bpos, n_best = (np.array(x)[:len(tsel)]
                                  for x in jax.device_get(dev))
            # vectorized acceptance: unique in-window best within budget
            # + the _valid_pair orientation/insert/same-chrom checks
            ap = apos[tsel]
            ast = astrand[tsel]
            lo_t = Lo[tsel]
            la_t = La[tsel]
            opos = bpos.astype(np.int64)
            fwd_anchor = ast == 0
            left_p = np.where(fwd_anchor, ap, opos)
            right_end = np.where(fwd_anchor, opos + lo_t, ap + la_t)
            ins = right_end - left_p
            order_ok = np.where(fwd_anchor, opos >= ap, ap >= opos)
            ci_a = np.searchsorted(starts_g, ap, side="right")
            ci_o = np.searchsorted(starts_g, opos, side="right")
            t_ok = ((best <= max_tot) & (n_best == 1) & order_ok
                    & (ci_a == ci_o) & (ins >= self.min_len)
                    & (ins <= self.max_len))
            for i in ridx[tsel[~t_ok]].tolist():
                out_map[i] = None
            amm = np.where(anchor_who[tsel] == 1,
                           out[ridx[tsel], 8], out[ridx[tsel], 9])
            # bulk-convert the accepted rows' fields to Python ints once
            ok_j = np.nonzero(t_ok)[0]
            cols = np.stack([ridx[tsel[ok_j]], anchor_who[tsel[ok_j]],
                             want_strand[tsel[ok_j]], bpos[ok_j],
                             best[ok_j], astrand[tsel[ok_j]],
                             apos[tsel[ok_j]], amm[ok_j],
                             ins[ok_j]]).T.tolist()
            for (i, who_a, wstr, op, bm, astr, apv, am, insv) in cols:
                o_res = _k.AlignResult(_k.NAR_ACCEPTED, strand=wstr,
                                       pos=op, mm=bm, n_low=1)
                a_res = _k.AlignResult(_k.NAR_ACCEPTED, strand=astr,
                                       pos=apv, mm=am, n_low=1)
                if who_a == 1:
                    r1, r2, who = a_res, o_res, 2
                else:
                    r1, r2, who = o_res, a_res, 1
                out_map[i] = PePair(NAR_PE_ACCEPTED, r1, r2, tlen=insv,
                                    rescued=who)
        return out_map

    def _pe_pass_subset(self, sub1, sub2, bt: int, nct: int,
                        capped: bool = False, block: bool = True):
        """One escalation-tier pe_pass over a pair subset (batch bt,
        candidate capacity nct). The final tier runs capped: per-bucket
        SA exploration is clamped (reference MaxIter analog) so the
        pass is total -- nothing escalates to the host."""
        import jax
        import jax.numpy as jnp
        al = self.al
        g = al.index.genome
        L = len(sub1[0].codes)
        _, max_tot = al.schedule_for(L)
        gview, sa, lut, _lut2 = al._device_for(L)
        starts_d = jnp.asarray(np.asarray(g.starts, np.int32))
        a1 = np.stack([r.codes for r in sub1])
        a2 = np.stack([r.codes for r in sub2])
        if len(sub1) < bt:
            a1 = np.concatenate(
                [a1, np.repeat(a1[:1], bt - len(sub1), axis=0)])
            a2 = np.concatenate(
                [a2, np.repeat(a2[:1], bt - len(sub2), axis=0)])
        cap = None
        if capped:
            n_buckets = 2 * len(al._offsets_for(L, max_tot))
            cap = max(1, nct // n_buckets)
        kw = dict(genome_len=len(g.seq),
                  offsets=al._offsets_for(L, max_tot),
                  lut_k=al.index.lut_k, n_compact=nct,
                  max_ml=al.max_ml, max_tot1=max_tot, max_tot2=max_tot,
                  mm_delta=al.mm_delta, min_ins=self.min_len,
                  max_ins=self.max_len, max_per_bucket=cap)
        dev = pe_pass(gview, sa, lut, starts_d, a1, a2, **kw)
        if not block:
            return dev
        return np.array(jax.device_get(dev))

    def _pair_from_row(self, rec1, rec2, row, max_tot,
                       rescue: "PePair | None" = None) -> PePair:
        (bid1, bid2, mm1, mm2, tlen, pcode, code1, code2,
         low1, low2) = (int(x) for x in row[:10])
        if pcode == PAIR_ACCEPT:
            return PePair(
                NAR_PE_ACCEPTED,
                _k.AlignResult(_k.NAR_ACCEPTED, strand=bid1 & 1,
                               pos=bid1 >> 1, mm=mm1, n_low=1),
                _k.AlignResult(_k.NAR_ACCEPTED, strand=bid2 & 1,
                               pos=bid2 >> 1, mm=mm2, n_low=1),
                tlen=tlen)
        if pcode == PAIR_NONE and self.pe_mode in (1, 3):
            # orphan rescue outcome precomputed by the batched device
            # window scan (_batch_rescue)
            if rescue is not None:
                return rescue
        if self.pe_mode in (3, 4):
            r1 = (_k.AlignResult(_k.NAR_ACCEPTED, strand=code1 & 1,
                                 pos=code1 >> 1, mm=low1, n_low=1)
                  if code1 >= 0 else None)
            r2 = (_k.AlignResult(_k.NAR_ACCEPTED, strand=code2 & 1,
                                 pos=code2 >> 1, mm=low2, n_low=1)
                  if code2 >= 0 else None)
            if r1 or r2:
                return PePair(NAR_PE_NOPAIR, r1, r2)
        return PePair(NAR_PE_NOPAIR)

    def _align_all(self, recs):
        """Align records preserving order; returns list of
        (AlignResult, hit_ids, hit_mms, max_tot_mm)."""
        out = []
        for chunk_start in range(0, len(recs), self.al.batch_size):
            chunk = recs[chunk_start:chunk_start + self.al.batch_size]
            by_len: dict[int, list[int]] = {}
            for i, r in enumerate(chunk):
                by_len.setdefault(len(r.codes), []).append(i)
            chunk_out: list = [None] * len(chunk)
            for L, idxs in by_len.items():
                arr = np.stack([chunk[i].codes for i in idxs])
                n = len(idxs)
                if n < self.al.batch_size:
                    pad = np.repeat(arr[:1], self.al.batch_size - n, axis=0)
                    arr = np.concatenate([arr, pad])
                results, raw = self.al.align_batch(arr, return_raw=True)
                _, max_tot_mm = self.al.schedule_for(L)
                for j, i in enumerate(idxs):
                    chunk_out[i] = (results[j], raw["hit_id"][j],
                                    raw["hit_mm"][j], max_tot_mm)
            out.extend(chunk_out)
        return out

    def _pair(self, rec1, rec2, a1, a2) -> PePair:
        res1, hid1, hmm1, mtm1 = a1
        res2, hid2, hmm2, mtm2 = a2
        L1, L2 = len(rec1.codes), len(rec2.codes)
        h1 = _hits_of(res1, hid1, hmm1, mtm1)
        h2 = _hits_of(res2, hid2, hmm2, mtm2)

        best = None
        best_score = None
        n_best = 0
        for c1 in h1:
            for c2 in h2:
                ins = self._valid_pair(c1, c2, L1, L2)
                if ins is None:
                    continue
                score = c1[2] + c2[2]
                if best_score is None or score < best_score:
                    best, best_score, n_best = (c1, c2, ins), score, 1
                elif score == best_score and (c1[0], c2[0]) != (
                        best[0][0], best[1][0]):
                    n_best += 1
        if best is not None and n_best == 1:
            (p1, s1, m1), (p2, s2, m2), ins = best
            return PePair(
                NAR_PE_ACCEPTED,
                _k.AlignResult(_k.NAR_ACCEPTED, strand=s1, pos=p1, mm=m1,
                               n_low=1),
                _k.AlignResult(_k.NAR_ACCEPTED, strand=s2, pos=p2, mm=m2,
                               n_low=1),
                tlen=ins)
        if best is not None:
            return PePair(NAR_PE_NOPAIR)

        # orphan rescue (pemode 1/3): anchor on a uniquely aligned mate
        if self.pe_mode in (1, 3):
            pair = self._rescue(rec1, rec2, res1, res2, h1, h2, L1, L2,
                                mtm1, mtm2)
            if pair is not None:
                return pair

        # orphan-as-SE fallback (pemode 3/4)
        if self.pe_mode in (3, 4):
            r1 = res1 if res1.nar == _k.NAR_ACCEPTED else None
            r2 = res2 if res2.nar == _k.NAR_ACCEPTED else None
            if r1 or r2:
                return PePair(NAR_PE_NOPAIR, r1, r2)
        return PePair(NAR_PE_NOPAIR)

    def write_sam(self, path, pairs, cmdline: str = "",
                  emit_unmapped: bool = True, snp_caller=None) -> dict:
        """Write paired (rec1, rec2, PePair) stream to SAM with full mate
        fields (flags 0x1/0x2/0x40/0x80, RNEXT/PNEXT/TLEN —
        KAligner.cpp:6050-6115)."""
        from ..io.sam import (FLAG_FIRST, FLAG_MATE_REVERSE,
                              FLAG_MATE_UNMAPPED, FLAG_PAIRED,
                              FLAG_PROPER_PAIR, FLAG_REVERSE, FLAG_SECOND,
                              FLAG_UNMAPPED, SamAlignment, SamWriter,
                              seq_qual_for_strand)
        import bisect
        g = self.al.index.genome
        starts_list = g.starts.tolist()
        stats = {"pairs": 0, NAR_PE_ACCEPTED: 0, NAR_PE_NOPAIR: 0,
                 "rescued": 0}
        snp_pos, snp_reads = [], []
        with SamWriter(path, g.names, g.lengths, pg_cl=cmdline) as w:
            for rec1, rec2, pp in pairs:
                stats["pairs"] += 1
                accepted = pp.nar == NAR_PE_ACCEPTED
                stats[NAR_PE_ACCEPTED if accepted else NAR_PE_NOPAIR] += 1
                if pp.rescued:
                    stats["rescued"] += 1
                for which, (rec, res, mate_res) in enumerate(
                        ((rec1, pp.r1, pp.r2), (rec2, pp.r2, pp.r1))):
                    flag = FLAG_PAIRED | (FLAG_FIRST if which == 0
                                          else FLAG_SECOND)
                    me_ok = res is not None and res.nar == _k.NAR_ACCEPTED
                    mate_ok = (mate_res is not None
                               and mate_res.nar == _k.NAR_ACCEPTED)
                    if not me_ok:
                        if not emit_unmapped:
                            continue
                        flag |= FLAG_UNMAPPED
                        if not mate_ok:
                            flag |= FLAG_MATE_UNMAPPED
                        seq, qual = seq_qual_for_strand(rec.codes, rec.qual,
                                                        False)
                        w.write(SamAlignment(rec.name, flag, "*", 0, 0, "*",
                                             seq=seq, qual=qual))
                        continue
                    if accepted:
                        flag |= FLAG_PROPER_PAIR
                    rev = res.strand == 1
                    if rev:
                        flag |= FLAG_REVERSE
                    ci = bisect.bisect_right(starts_list, res.pos) - 1
                    off = res.pos - starts_list[ci]
                    rnext, pnext, tlen = "*", 0, 0
                    if mate_ok:
                        if mate_res.strand == 1:
                            flag |= FLAG_MATE_REVERSE
                        mci = bisect.bisect_right(starts_list,
                                                  mate_res.pos) - 1
                        moff = mate_res.pos - starts_list[mci]
                        rnext = "=" if mci == ci else g.names[mci]
                        pnext = moff + 1
                        tlen = pp.tlen if res.pos <= mate_res.pos \
                            else -pp.tlen
                    else:
                        flag |= FLAG_MATE_UNMAPPED
                    seq, qual = seq_qual_for_strand(rec.codes, rec.qual, rev)
                    w.write(SamAlignment(
                        rec.name, flag, g.names[ci], off + 1, 254,
                        f"{len(rec.codes)}M", rnext, pnext, tlen, seq, qual,
                        tags=(f"NM:i:{res.mm}",)))
                    if snp_caller is not None:
                        oriented = (dna.revcomp(rec.codes) if rev
                                    else rec.codes)
                        snp_pos.append(res.pos)
                        snp_reads.append(oriented)
        if snp_caller is not None and snp_pos:
            lens = {len(r) for r in snp_reads}
            for L in lens:
                sel = [i for i, r in enumerate(snp_reads) if len(r) == L]
                snp_caller.add_alignments(
                    np.asarray([snp_pos[i] for i in sel], np.int64),
                    np.stack([snp_reads[i] for i in sel]))
        return stats

    def write_sam_fast(self, path, pairs, cmdline: str = "",
                       emit_unmapped: bool = True, snp_caller=None,
                       chunk: int = 16384) -> dict:
        """Vectorized PE SAM writer: buffers the (rec1, rec2, PePair)
        stream in chunks, converts sequences/qualities as whole arrays,
        and emits records through the native bulk formatter
        (native/hostops.cpp format_sam_pe) — same records as write_sam
        without per-record Python formatting (which dominated the
        config-4 end-to-end wall-clock at ~10x the alignment cost).
        Requires uniform read lengths and the native lib; falls back to
        write_sam otherwise."""
        import ctypes

        from ..index.sa_build import _load_native
        from ..io.sam import (FLAG_FIRST, FLAG_MATE_REVERSE,
                              FLAG_MATE_UNMAPPED, FLAG_PAIRED,
                              FLAG_PROPER_PAIR, FLAG_REVERSE, FLAG_SECOND,
                              FLAG_UNMAPPED)
        lib = _load_native()
        if lib is None or not hasattr(lib, "format_sam_pe"):
            return self.write_sam(path, pairs, cmdline=cmdline,
                                  emit_unmapped=emit_unmapped,
                                  snp_caller=snp_caller)
        g = self.al.index.genome
        starts = g.starts.astype(np.int64)
        chrom_cat = "".join(g.names).encode()
        chrom_ofs = np.zeros(len(g.names) + 1, np.int64)
        chrom_ofs[1:] = np.cumsum([len(n) for n in g.names])
        stats = {"pairs": 0, NAR_PE_ACCEPTED: 0, NAR_PE_NOPAIR: 0,
                 "rescued": 0}
        _FWD = np.frombuffer(b"ACGTNNNN", np.uint8)
        _RC = np.frombuffer(b"TGCANNNN", np.uint8)

        def flush(buf, raw_f):
            n2 = 2 * len(buf)
            L = len(buf[0][0].codes)
            names = []
            flag = np.zeros(n2, np.int32)
            ci = np.full(n2, -1, np.int32)
            pos1 = np.zeros(n2, np.int64)
            rnext = np.full(n2, -2, np.int32)
            pnext = np.zeros(n2, np.int64)
            tlen = np.zeros(n2, np.int64)
            nm = np.full(n2, -1, np.int32)
            codes = np.zeros((n2, L), np.uint8)
            quals = np.zeros((n2, L), np.uint8)
            rev = np.zeros(n2, bool)
            keep = np.ones(n2, bool)
            snp_rows = []
            for j, (rec1, rec2, pp) in enumerate(buf):
                accepted = pp.nar == NAR_PE_ACCEPTED
                for which, (rec, res, mres) in enumerate(
                        ((rec1, pp.r1, pp.r2), (rec2, pp.r2, pp.r1))):
                    i = 2 * j + which
                    names.append(rec.name.encode())
                    f = FLAG_PAIRED | (FLAG_FIRST if which == 0
                                       else FLAG_SECOND)
                    me_ok = res is not None and res.nar == _k.NAR_ACCEPTED
                    mate_ok = (mres is not None
                               and mres.nar == _k.NAR_ACCEPTED)
                    codes[i, :len(rec.codes)] = rec.codes
                    if rec.qual is not None and len(rec.qual) == L:
                        quals[i] = np.asarray(rec.qual, np.uint8) + 33
                    if not me_ok:
                        if not emit_unmapped:
                            keep[i] = False
                        f |= FLAG_UNMAPPED
                        if not mate_ok:
                            f |= FLAG_MATE_UNMAPPED
                        flag[i] = f
                        continue
                    if accepted:
                        f |= FLAG_PROPER_PAIR
                    if res.strand == 1:
                        f |= FLAG_REVERSE
                        rev[i] = True
                    c = int(np.searchsorted(starts, res.pos,
                                            side="right") - 1)
                    ci[i] = c
                    pos1[i] = res.pos - starts[c] + 1
                    nm[i] = res.mm
                    if mate_ok:
                        if mres.strand == 1:
                            f |= FLAG_MATE_REVERSE
                        mc = int(np.searchsorted(starts, mres.pos,
                                                 side="right") - 1)
                        rnext[i] = -1 if mc == c else mc
                        pnext[i] = mres.pos - starts[mc] + 1
                        tlen[i] = pp.tlen if res.pos <= mres.pos \
                            else -pp.tlen
                    else:
                        f |= FLAG_MATE_UNMAPPED
                    flag[i] = f
                    if snp_caller is not None:
                        snp_rows.append((res.pos, i))
            # strand-oriented ascii sequences + reversed quals, vectorized
            seq_ascii = _FWD[codes]
            if rev.any():
                seq_ascii[rev] = _RC[codes[rev][:, ::-1]]
                qr = quals[rev]
                nzq = qr[:, 0] != 0
                qr[nzq] = qr[nzq][:, ::-1]
                quals[rev] = qr
            sel = np.nonzero(keep)[0]
            sel_names = [names[i] for i in sel]
            qn_cat = b"".join(sel_names)
            qn_ofs = np.zeros(len(sel) + 1, np.int64)
            qn_ofs[1:] = np.cumsum([len(x) for x in sel_names])
            max_cn = max((len(n) for n in g.names), default=1)
            cap = (int(qn_ofs[-1])
                   + len(sel) * (2 * L + 2 * max_cn + 160) + 16)
            out = ctypes.create_string_buffer(cap)
            # keep every array referenced until the native call returns
            a_flag = np.ascontiguousarray(flag[sel])
            a_ci = np.ascontiguousarray(ci[sel])
            a_pos = np.ascontiguousarray(pos1[sel])
            a_mapq = np.full(len(sel), 254, np.int32)
            a_rnext = np.ascontiguousarray(rnext[sel])
            a_pnext = np.ascontiguousarray(pnext[sel])
            a_tlen = np.ascontiguousarray(tlen[sel])
            a_nm = np.ascontiguousarray(nm[sel])
            a_seq = np.ascontiguousarray(seq_ascii[sel])
            a_qual = np.ascontiguousarray(quals[sel])
            P32 = ctypes.POINTER(ctypes.c_int32)
            P64 = ctypes.POINTER(ctypes.c_int64)
            PU8 = ctypes.POINTER(ctypes.c_uint8)
            nb = lib.format_sam_pe(
                qn_cat, qn_ofs.ctypes.data_as(P64),
                chrom_cat, chrom_ofs.ctypes.data_as(P64),
                a_flag.ctypes.data_as(P32), a_ci.ctypes.data_as(P32),
                a_pos.ctypes.data_as(P64), a_mapq.ctypes.data_as(P32),
                a_rnext.ctypes.data_as(P32), a_pnext.ctypes.data_as(P64),
                a_tlen.ctypes.data_as(P64), a_nm.ctypes.data_as(P32),
                a_seq.ctypes.data_as(PU8), a_qual.ctypes.data_as(PU8),
                len(sel), L, out, cap)
            if nb < 0:
                raise RuntimeError("format_sam_pe buffer overflow")
            raw_f.write(out.raw[:nb])
            if snp_caller is not None and snp_rows:
                spos = np.asarray([p for p, _ in snp_rows], np.int64)
                sidx = np.asarray([i for _, i in snp_rows])
                orient = codes[sidx].copy()
                r2 = rev[sidx]
                if r2.any():
                    rc = orient[r2][:, ::-1]
                    orient[r2] = np.where(rc < 4, 3 - rc, rc)
                snp_caller.add_alignments(spos, orient)

        with open(path, "w", newline="") as f:
            f.write("@HD\tVN:1.4\tSO:unsorted\n")
            for name, ln in zip(g.names, g.lengths):
                f.write(f"@SQ\tSN:{name}\tLN:{int(ln)}\n")
            f.write(f"@PG\tID:kit4b_tpu\tPN:kit4b_tpu\tCL:{cmdline}\n")
        with open(path, "ab") as raw_f:
            buf = []
            L0 = None
            for rec1, rec2, pp in pairs:
                stats["pairs"] += 1
                acc = pp.nar == NAR_PE_ACCEPTED
                stats[NAR_PE_ACCEPTED if acc else NAR_PE_NOPAIR] += 1
                if pp.rescued:
                    stats["rescued"] += 1
                if len(rec1.codes) != len(rec2.codes):
                    # rare unequal-mate pair: keep record order, format
                    # this one through the per-record path
                    if buf:
                        flush(buf, raw_f)
                        buf = []
                    raw_f.write(self._pair_records_text(
                        rec1, rec2, pp, emit_unmapped,
                        snp_caller).encode())
                    continue
                L = len(rec1.codes)
                if L0 is None:
                    L0 = L
                if L != L0:      # length change: flush the uniform run
                    if buf:
                        flush(buf, raw_f)
                    buf = []
                    L0 = L
                buf.append((rec1, rec2, pp))
                if len(buf) >= chunk:
                    flush(buf, raw_f)
                    buf = []
            if buf:
                flush(buf, raw_f)
        return stats

    def _pair_records_text(self, rec1, rec2, pp, emit_unmapped,
                           snp_caller) -> str:
        """Two SAM record lines for one pair (the per-record formatting
        used by write_sam, shared by write_sam_fast's unequal-mate
        fallback)."""
        from ..io.sam import (FLAG_FIRST, FLAG_MATE_REVERSE,
                              FLAG_MATE_UNMAPPED, FLAG_PAIRED,
                              FLAG_PROPER_PAIR, FLAG_REVERSE, FLAG_SECOND,
                              FLAG_UNMAPPED, seq_qual_for_strand)
        import bisect
        g = self.al.index.genome
        starts_list = g.starts.tolist()
        accepted = pp.nar == NAR_PE_ACCEPTED
        lines = []
        for which, (rec, res, mate_res) in enumerate(
                ((rec1, pp.r1, pp.r2), (rec2, pp.r2, pp.r1))):
            flag = FLAG_PAIRED | (FLAG_FIRST if which == 0
                                  else FLAG_SECOND)
            me_ok = res is not None and res.nar == _k.NAR_ACCEPTED
            mate_ok = (mate_res is not None
                       and mate_res.nar == _k.NAR_ACCEPTED)
            if not me_ok:
                if not emit_unmapped:
                    continue
                flag |= FLAG_UNMAPPED
                if not mate_ok:
                    flag |= FLAG_MATE_UNMAPPED
                seq, qual = seq_qual_for_strand(rec.codes, rec.qual, False)
                lines.append(f"{rec.name}\t{flag}\t*\t0\t0\t*\t*\t0\t0\t"
                             f"{seq}\t{qual}\n")
                continue
            if accepted:
                flag |= FLAG_PROPER_PAIR
            rev = res.strand == 1
            if rev:
                flag |= FLAG_REVERSE
            ci = bisect.bisect_right(starts_list, res.pos) - 1
            off = res.pos - starts_list[ci]
            rnext, pnext, tlen = "*", 0, 0
            if mate_ok:
                if mate_res.strand == 1:
                    flag |= FLAG_MATE_REVERSE
                mci = bisect.bisect_right(starts_list, mate_res.pos) - 1
                moff = mate_res.pos - starts_list[mci]
                rnext = "=" if mci == ci else g.names[mci]
                pnext = moff + 1
                tlen = pp.tlen if res.pos <= mate_res.pos else -pp.tlen
            else:
                flag |= FLAG_MATE_UNMAPPED
            seq, qual = seq_qual_for_strand(rec.codes, rec.qual, rev)
            lines.append(
                f"{rec.name}\t{flag}\t{g.names[ci]}\t{off + 1}\t254\t"
                f"{len(rec.codes)}M\t{rnext}\t{pnext}\t{tlen}\t{seq}\t"
                f"{qual}\tNM:i:{res.mm}\n")
            if snp_caller is not None:
                oriented = (dna.revcomp(rec.codes) if rev else rec.codes)
                snp_caller.add_alignments(
                    np.asarray([res.pos], np.int64), oriented[None, :])
        return "".join(lines)

    def _rescue(self, rec1, rec2, res1, res2, h1, h2, L1, L2, mtm1, mtm2):
        """AlignPartnerRead equivalent (KAligner.cpp:3333-3440): scan the
        insert window around the unique anchor for the missing mate."""
        if res1.nar == _k.NAR_ACCEPTED and not h2:
            anchor, orphan, Lo, mtm, who = res1, rec2, L2, mtm2, 2
        elif res2.nar == _k.NAR_ACCEPTED and not h1:
            anchor, orphan, Lo, mtm, who = res2, rec1, L1, mtm1, 1
        else:
            return None
        g = self.al.index.genome.seq
        # expected window: opposite strand within max insert of the anchor
        if anchor.strand == 0:
            lo = anchor.pos + self.min_len - Lo
            hi = anchor.pos + self.max_len - Lo
            want_strand = 1
        else:
            lo = anchor.pos + len(
                (rec1 if who == 2 else rec2).codes) - self.max_len
            hi = anchor.pos + len(
                (rec1 if who == 2 else rec2).codes) - self.min_len
            want_strand = 0
        lo = max(0, lo)
        hi = min(len(g) - Lo, hi)
        if hi < lo:
            return None
        probe = (orphan.codes if want_strand == 0
                 else dna.revcomp(orphan.codes))
        span = g[lo:hi + Lo]
        wins = np.lib.stride_tricks.sliding_window_view(span, Lo)
        mm = (wins != probe).sum(axis=1)
        best = int(mm.min())
        if best > mtm:
            return None
        cands = np.nonzero(mm == best)[0]
        if len(cands) != 1:
            return None
        opos = lo + int(cands[0])
        o_res = _k.AlignResult(_k.NAR_ACCEPTED, strand=want_strand,
                               pos=opos, mm=best, n_low=1)
        if who == 2:
            r1, r2 = anchor, o_res
        else:
            r1, r2 = o_res, anchor
        ins = self._valid_pair((r1.pos, r1.strand, r1.mm),
                               (r2.pos, r2.strand, r2.mm), L1, L2)
        if ins is None:
            return None
        return PePair(NAR_PE_ACCEPTED, r1, r2, tlen=ins, rescued=who)
