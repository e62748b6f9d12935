"""kalign: seed-and-extend short-read aligner (device engine).

Mirrors the reference CKAligner semantics (ngskit4b/KAligner.cpp:82 Align,
:9583 AlignRead; libkit4b/SfxArray.cpp:7838 AlignReads) while batching the
work as fixed-shape device passes:

  - Progressive pigeonhole passes: pass m seeks alignments with <= m
    mismatches using exact core windows of CL = L // (m + mm_delta)
    (SfxArray.cpp:7869-7878), then a final pass at the KAligner-derived
    CoreLen/CoreDelta (KAligner.cpp:9665-9669).
  - Reads are aligned as whole batches per pass; resolved reads (best
    mismatch count <= pass allowance) are compacted out on the host between
    passes — the batch analog of the reference's early `return(Rslt)`.
  - Uniqueness: best hit accepted when there is exactly one locus at the
    lowest mismatch count and the next-lowest differs by >= mm_delta
    (MinEditDist), as in the reference's eHRMMDelta handling.

Round-1 scope: SE substitutions-only (microInDel / splice / chimeric trims are
later milestones — SURVEY.md §7 step 5).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Iterator

import jax
import numpy as np

from .. import dna
from ..index.sfx_index import SfxIndex
from ..io.fasta import SeqRecord
from ..io.sam import (FLAG_REVERSE, FLAG_UNMAPPED, SamAlignment, SamWriter,
                      seq_qual_for_strand)

INT32_MAX = np.iinfo(np.int32).max


def pack_reads_2bit(reads: np.ndarray, n_cap: int | None = None):
    """[B, L] uint8 codes -> ([B, ceil(L/4)] packed, [n_cap, 2] sparse N
    list, ok). The host link is the bottleneck (~10-35 MB/s), so reads
    cross it 2-bit packed; Ns ride a sparse (read, base) list, padded with
    large positive OOB sentinels (jnp .at[] mode="drop" drops out-of-range
    indices but WRAPS negative ones). ok=False when the batch has more Ns
    than n_cap (caller uses the unpacked path). Native C loop when built
    (native/hostops.cpp, ~40x numpy's strided packing); numpy fallback.

    n_cap=None sizes the list from the batch's actual N count, rounded up
    to a power of two >= 4096 so jit executables are shared across batches
    (reads sampled over telomere/centromere N runs carry tens of thousands
    of Ns per batch — a fixed 4096 cap silently demoted those batches to
    the slow unpacked path)."""
    from ..index.sa_build import _load_native
    import ctypes
    B, L = reads.shape
    if n_cap is None:
        n_n = int((reads >= 4).sum())
        n_cap = 4096
        while n_cap < n_n:
            n_cap <<= 1
    L4 = (L + 3) // 4
    lib = _load_native()
    if lib is not None and hasattr(lib, "pack2bit_u8"):
        reads_c = np.ascontiguousarray(reads)
        packed = np.empty((B, L4), dtype=np.uint8)
        nlist = np.empty((n_cap, 2), dtype=np.int32)
        nn = lib.pack2bit_u8(
            reads_c.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_int64(B), ctypes.c_int64(L),
            packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            nlist.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.c_int64(n_cap))
        if nn < 0:
            return packed, None, False
        return packed, nlist, True
    ext = np.zeros((B, 4 * L4), dtype=np.uint8)
    ext[:, :L] = reads & 3
    packed = (ext[:, 0::4] | (ext[:, 1::4] << 2) | (ext[:, 2::4] << 4)
              | (ext[:, 3::4] << 6))
    ridx, bidx = np.nonzero(reads >= 4)
    if len(ridx) > n_cap:
        return packed, None, False
    nlist = np.full((n_cap, 2), 2**30, dtype=np.int32)
    nlist[:len(ridx), 0] = ridx
    nlist[:len(ridx), 1] = bidx
    return packed, nlist, True

# sensitivity modes (reference ePMdefault/ePMMoreSens/ePMUltraSens/ePMLessSens
# mapped to slides + min-core adjustment, KAligner.cpp:9377-9393)
SENS_MODES = {
    "default": (0, 8),
    "more": (-1, 8),
    "ultra": (-2, 9),
    "less": (2, 6),
}


def auto_min_core_len(genome_len: int, sens: str = "default") -> int:
    """floor(log4(G)) - 1, clamped (KAligner.cpp:9369-9374, cKAMinCoreLen)."""
    auto = 0
    g = genome_len
    while g:
        g >>= 2
        auto += 1
    auto -= 1
    adj, _ = SENS_MODES[sens]
    return max(4, auto) + adj


@dataclass(frozen=True)
class PassSpec:
    allow_mm: int
    core_len: int
    offsets: tuple  # core window start offsets within the read


def build_pass_schedule(read_len: int, max_subs_per100: int, mm_delta: int,
                        genome_len: int, sens: str = "default",
                        ) -> tuple[list[PassSpec], int]:
    """Pigeonhole pass schedule for one read length.

    Returns (passes, max_tot_mm). Mirrors AlignReads' progressive loop +
    final call (SfxArray.cpp:7866-7893) and AlignRead's CoreLen/CoreDelta
    derivation (KAligner.cpp:9662-9669).
    """
    L = read_len
    if max_subs_per100 == 0:
        max_tot_mm = 0
    else:
        max_tot_mm = max(1, int(0.5 + L * max_subs_per100 / 100.0))
    max_tot_mm = min(max_tot_mm, 63)

    min_core = auto_min_core_len(genome_len, sens)
    denom = max_tot_mm + (1 if mm_delta == 1 else 2)
    core_final = max(min_core, L // denom)
    _, slides_per100 = SENS_MODES[sens]
    max_slides = max(1, (slides_per100 * L + 99) // 100)
    core_delta = max(L // max_slides - 1, core_final)

    passes: list[PassSpec] = []
    for m in range(max_tot_mm + 1):
        cl = L // (m + mm_delta)
        if cl <= core_final:
            break
        offsets = tuple(o for o in range(0, L - cl + 1, cl))
        passes.append(PassSpec(m, cl, offsets))
    # final pass at KAligner core/delta
    offsets = []
    o = 0
    while o + core_final <= L and len(offsets) < max_slides:
        offsets.append(o)
        o += core_delta
    passes.append(PassSpec(max_tot_mm, core_final, tuple(offsets)))
    return passes, max_tot_mm


def union_offsets(passes: list[PassSpec]) -> tuple:
    """Union of all pass core-window offsets, ascending.

    With the default MinEditDist=1 the progressive pass loop and a single
    all-windows evaluation are equivalent: pigeonhole guarantees every
    alignment with mm == low is discovered by pass `low`'s windows, so the
    lowest-mm locus set (and hence unique/multi classification) is identical;
    evaluating extra windows only improves next-best tracking. Fusing them
    means ONE compiled executable and one candidate sort per batch instead of
    one per pass.
    """
    s: set[int] = set()
    for p in passes:
        s.update(p.offsets)
    return tuple(sorted(s))


# NAR (not-aligned reason / acceptance) codes — subset of reference
# eNAR* (KAligner.h): accepted, no-hit, multialign, excess Ns.
NAR_ACCEPTED = "accepted"
NAR_NOHIT = "nohit"
NAR_MULTI = "multi"
NAR_NS = "ns"


@dataclass
class AlignResult:
    nar: str
    strand: int = 0        # 0 = '+', 1 = '-'
    pos: int = -1          # concatenated-genome start
    mm: int = -1
    n_low: int = 0
    nxt_mm: int = INT32_MAX
    multi_ids: np.ndarray | None = None  # pos*2+strand of multiloci hits
    cigar: str | None = None             # non-None for microInDel rescues
    trim_left: int = 0                   # AutoTrimFlanks 5' soft clip
    trim_right: int = 0                  # AutoTrimFlanks 3' soft clip
    secondary: bool = False              # SAM 0x100 (mlmode 5 report-all)


class KAligner:
    """Batch seed-and-extend aligner over a loaded SfxIndex.

    Device hot path: ops/seed_extend_fast.fast_pass. Reads whose candidate
    total exceeds the tier capacity are escalated through `escalation`
    (batch, capacity) tiers — the analog of the reference's MaxIter
    sensitivity ladder (ngskit4b/KAligner.h:53-56); reads still overflowing
    the last tier are classified multi, as the reference classifies
    MaxIter-truncated reads."""

    def __init__(self, index: SfxIndex, *,
                 max_subs: int = 5,          # per 100bp (-s, cDfltAllowedSubs)
                 mm_delta: int = 1,          # MinEditDist (-r)
                 max_ml: int = 5,            # cDfltMaxMultiHits
                 max_ns: int = 1,            # cDfltMaxNs (per 100bp, min 1)
                 cand_per_window: int = 24,  # (round-1 path; kept for compat)
                 n_compact: int = 24,        # tier-1 per-read candidate cap
                 n_extend: int = 12,         # tier-1 distinct-locus cap (v3)
                 batch_size: int = 16384,
                 sens: str = "default",
                 escalation: tuple = ((512, 512), (64, 8192)),
                 micro_indel: int = 0,   # microInDel max length (-y), 0=off
                 splice_max: int = 0,    # splice junction max gap (-l), 0=off
                 chimeric_pct: int = 0,  # min chimeric len % (-c), 0=off
                 use_v5: bool | None = None):  # flattened lut4 tier-1
                                               # (None = auto by histogram)
        self.index = index
        self.max_subs = max_subs
        self.mm_delta = mm_delta
        self.max_ml = max_ml
        self.max_ns = max_ns
        self.cand = cand_per_window
        self.n_compact = n_compact
        self.n_extend = n_extend
        self.batch_size = batch_size
        self.sens = sens
        self.escalation = escalation
        self.micro_indel = micro_indel
        self.splice_max = splice_max
        self.chimeric_pct = chimeric_pct
        self.use_v5 = use_v5
        self._schedules: dict[int, tuple[list[PassSpec], int]] = {}
        self._fast_dev: dict[int, tuple] = {}   # nw2 -> (gview, sa, lut)
        self._lut4 = None       # device lut4 (read-length independent)
        self._lut4_decided = None
        self._host_packed = None

    def schedule_for(self, read_len: int):
        if read_len not in self._schedules:
            self._schedules[read_len] = build_pass_schedule(
                read_len, self.max_subs, self.mm_delta,
                len(self.index.genome.seq), self.sens)
        return self._schedules[read_len]

    def _device_for(self, read_len: int):
        """(gview, sa, lut, lut2) device arrays for this read length's
        word count (lut2 = (lo, cnt) pair rows for the v3 tier-1 path)."""
        from ..ops import seed_extend_fast, seed_extend_v3
        nw2 = (read_len + 15) // 16 + 1
        if nw2 not in self._fast_dev:
            import jax.numpy as jnp
            if self._host_packed is None:
                from ..ops.extend_packed import pack_genome
                self._host_packed = pack_genome(self.index.genome.seq, 65)
            gpack, gbad = self._host_packed
            gview = seed_extend_fast.make_gview_device(gpack, gbad, nw2)
            sa = jnp.asarray(self.index.sa_clean.astype(np.int32))
            lut = jnp.asarray(self.index.lut.astype(
                np.int32 if self.index.lut[-1] < 2**31 else np.int64))
            # lut2 derives from the device lut: zero extra host-link bytes
            lut2 = (seed_extend_v3.make_lut2_device(lut)
                    if self.index.lut[-1] < 2**31 else None)
            self._fast_dev[nw2] = (gview, sa, lut, lut2)
        return self._fast_dev[nw2]

    def _lut4_for(self, read_len: int, sa):
        """Device lut4 (flattened bucket table) when the v5 tier-1 path is
        worth it: escalation population predicted tiny by the host-side
        bucket histogram (ops/seed_extend_v5.host_escalation_estimate) and
        the table fits HBM comfortably. Returns None to keep the v4 path
        (e.g. repeat-dense indexes, where most reads would escalate).
        The decision is keyed per read length (window counts differ), the
        lut4 table itself is read-length independent and built once."""
        if self._lut4_decided is None:
            self._lut4_decided = {}
        if read_len not in self._lut4_decided:
            from ..ops import seed_extend_v5
            decided = False
            if self.use_v5 is not False:
                if len(self.index.lut) - 1 > 4 ** 12:
                    if self.use_v5:
                        import warnings
                        warnings.warn(
                            "use_v5=True ignored: lut has "
                            f"{len(self.index.lut) - 1} keys > 4^12; the "
                            "flattened lut4 would exceed the HBM budget — "
                            "running the v4 tier-1 instead", RuntimeWarning)
                else:
                    _, mtm = self.schedule_for(read_len)
                    w = len(self._offsets_for(read_len, mtm))
                    est = seed_extend_v5.host_escalation_estimate(
                        self.index.lut, w)
                    decided = bool(self.use_v5) or est <= 0.004
            if decided and self._lut4 is None:
                self._lut4 = seed_extend_v5.make_lut4_device(
                    self.index.lut, sa)
            self._lut4_decided[read_len] = decided
        return self._lut4 if self._lut4_decided[read_len] else None

    def _offsets_for(self, read_len: int, max_tot_mm: int) -> tuple:
        from ..ops import seed_extend_fast
        # discovery must reach max_tot + delta - 1 so next-best tracking
        # within MinEditDist is complete (SfxArray.cpp:7869-7878)
        return seed_extend_fast.fast_offsets(
            read_len, self.index.lut_k,
            max_tot_mm + max(self.mm_delta - 1, 0))

    _force_full = False   # set True when callers need multiloci hit lists

    def _use_compact(self) -> bool:
        """Compact device classification unless hit lists are needed
        host-side (rescue passes / mlmode use the multiloci candidates)."""
        return not (self.micro_indel or self.splice_max
                    or self.chimeric_pct or self._force_full)

    # --- device pass (submit / collect split for pipelining) ---------------
    def _submit(self, reads: np.ndarray, n_compact: int | None = None,
                compact: bool | None = None, capped: bool = False):
        from ..ops import seed_extend_fast, seed_extend_v3
        B, L = reads.shape
        _, max_tot_mm = self.schedule_for(L)
        gview, sa, lut, lut2 = self._device_for(L)
        offsets = self._offsets_for(L, max_tot_mm)
        nc = n_compact or self.n_compact
        # capped tiers clamp per-bucket SA exploration (reference MaxIter
        # analog, KAligner.h:53-56) so the pass is total: with
        # cap = nc // (2*W) the clamped candidate total never overflows
        cap = max(1, nc // (2 * len(offsets))) if capped else None
        kw = dict(genome_len=len(self.index.genome.seq),
                  offsets=offsets,
                  lut_k=self.index.lut_k,
                  n_compact=nc, max_per_bucket=cap)
        if compact is None:
            compact = self._use_compact()
        tier1 = n_compact is None and lut2 is not None
        if compact:
            if tier1:
                # v3: gather-minimal lane-major pass; overflow (raw > NC or
                # distinct loci > NS) escalates through the old-path tiers
                if 2 * len(self.index.genome.seq) + 1 < 2 ** 31:
                    # minimal-link variant: 2-bit reads up, 8 bytes/read
                    # down, packed-native kernel (zero-unpack). v5 when the
                    # bucket histogram predicts a tiny escalation set (one
                    # flattened row gather replaces LUT pair + SA gathers),
                    # else the v4 full lut2+SA tier-1.
                    from ..ops import seed_extend_v4, seed_extend_v5
                    reads2b, nlist, ok = pack_reads_2bit(reads)
                    if ok:
                        import jax.numpy as jnp
                        lut4 = self._lut4_for(L, sa)
                        if lut4 is not None:
                            kw.pop("max_per_bucket", None)
                            return ("packed",
                                    seed_extend_v5.fast_pass_packed_v5(
                                        gview, sa, lut2, lut4,
                                        jnp.asarray(reads2b),
                                        jnp.asarray(nlist), read_len=L,
                                        max_tot_mm=max_tot_mm,
                                        mm_delta=self.mm_delta,
                                        n_extend=self.n_extend,
                                        tier2=(512, 192, 96), **kw))
                        return ("packed", seed_extend_v4.fast_pass_packed_v4(
                            gview, sa, lut2, jnp.asarray(reads2b),
                            jnp.asarray(nlist), read_len=L,
                            max_tot_mm=max_tot_mm, mm_delta=self.mm_delta,
                            n_extend=self.n_extend, **kw))
                return seed_extend_v3.fast_pass_compact_v3(
                    gview, sa, lut2, reads, max_tot_mm=max_tot_mm,
                    mm_delta=self.mm_delta, n_extend=self.n_extend, **kw)
            return seed_extend_fast.fast_pass_compact(
                gview, sa, lut, reads, max_tot_mm=max_tot_mm,
                mm_delta=self.mm_delta, **kw)
        if tier1:
            return seed_extend_v3.fast_pass_v3(
                gview, sa, lut2, reads, max_ml=self.max_ml,
                n_extend=self.n_extend, **kw)
        return seed_extend_fast.fast_pass(
            gview, sa, lut, reads, max_ml=self.max_ml, **kw)

    def _code_from_full(self, host: dict, max_tot_mm: int) -> np.ndarray:
        """Classify full-stats rows into compact codes (escalation merge)."""
        low = host["low_mm"].astype(np.int64)
        aligned = low <= max_tot_mm
        unique = (aligned & ~host["overflow"] & (host["n_low"] == 1)
                  & ((host["nxt_mm"].astype(np.int64) - low)
                     >= self.mm_delta))
        best = host["hit_id"][:, 0].astype(np.int64)
        return np.where(host["overflow"], -3,
                        np.where(unique, best,
                                 np.where(aligned, -2, -1))).astype(np.int64)

    def _collect_compact(self, devout, reads: np.ndarray) -> dict:
        """Fetch [B,2] compact results; escalate overflow codes via the
        full-stats tiers; return the classification dict."""
        if isinstance(devout, tuple) and devout[0] == "packed":
            from ..ops.seed_extend_v3 import unpack_result2
            code, low, n_low = unpack_result2(
                np.array(jax.device_get(devout[1])))
        else:
            host = np.array(jax.device_get(devout))
            code = host[:, 0].astype(np.int64)
            low = host[:, 1].astype(np.int64)
            n_low = host[:, 2].astype(np.int64)
        for ti, (bt, nct) in enumerate(self.escalation):
            idxs = np.nonzero(code == -3)[0]
            if len(idxs) == 0:
                break
            final = ti == len(self.escalation) - 1
            for s in range(0, len(idxs), bt):
                chunk = idxs[s:s + bt]
                sub = reads[chunk]
                if len(chunk) < bt:
                    sub = np.concatenate(
                        [sub, np.repeat(sub[:1], bt - len(chunk), axis=0)])
                out2 = {k: np.array(v) for k, v in jax.device_get(
                    self._submit(sub, n_compact=nct, compact=False,
                                 capped=final)).items()}
                _, max_tot_mm = self.schedule_for(reads.shape[1])
                code[chunk] = self._code_from_full(
                    {k: v[:len(chunk)] for k, v in out2.items()}, max_tot_mm)
                low[chunk] = out2["low_mm"][:len(chunk)]
                n_low[chunk] = out2["n_low"][:len(chunk)]
        B, L = reads.shape
        _, max_tot_mm = self.schedule_for(L)
        max_ns_seq = max(L * self.max_ns // 100, self.max_ns)
        ns_bad = (reads == dna.BASE_N).sum(axis=1) > max_ns_seq
        # final-tier overflow (-3) is classified multi, as the reference
        # classifies MaxIter-truncated reads
        nar = np.where(ns_bad, 3,
                       np.where(code >= 0, 0,
                                np.where(code == -1, 1, 2))).astype(np.uint8)
        pos = np.where(code >= 0, code >> 1, -1)
        strand = np.where(code >= 0, code & 1, 0)
        return {"nar": nar, "pos": pos, "strand": strand, "mm": low,
                "low_mm": low, "n_low": n_low, "nxt_mm": None,
                "hit_id": None, "hit_mm": None,
                "overflow": code == -3, "max_tot_mm": max_tot_mm}

    def _collect(self, devout, reads: np.ndarray) -> dict:
        """Fetch tier-1 results; escalate overflowed reads through tiers."""
        host = {k: np.array(v) for k, v in jax.device_get(devout).items()}
        trunc = host["overflow"].copy()
        for ti, (bt, nct) in enumerate(self.escalation):
            idxs = np.nonzero(trunc)[0]
            if len(idxs) == 0:
                break
            final = ti == len(self.escalation) - 1
            for s in range(0, len(idxs), bt):
                chunk = idxs[s:s + bt]
                sub = reads[chunk]
                if len(chunk) < bt:
                    sub = np.concatenate(
                        [sub, np.repeat(sub[:1], bt - len(chunk), axis=0)])
                out2 = {k: np.asarray(v) for k, v in jax.device_get(
                    self._submit(sub, n_compact=nct, compact=False,
                                 capped=final)).items()}
                for key in ("low_mm", "n_low", "nxt_mm", "hit_id", "hit_mm"):
                    host[key][chunk] = out2[key][:len(chunk)]
                trunc[chunk] = out2["overflow"][:len(chunk)]
        host["overflow"] = trunc   # True only if the FINAL tier overflowed
        return host

    def align_batch_raw(self, reads: np.ndarray) -> dict:
        """Vectorized alignment of a [B, L] uint8 code batch.

        Returns numpy arrays: nar [B] uint8 (0=accepted 1=nohit 2=multi
        3=excess-Ns), pos/strand/mm [B] (valid where accepted), plus the raw
        stats (full-stats keys are None on the compact path)."""
        if self._use_compact():
            return self._collect_compact(self._submit(reads), reads)
        host = self._collect(self._submit(reads), reads)
        return self._classify(reads, host)

    def _classify(self, reads: np.ndarray, host: dict) -> dict:
        B, L = reads.shape
        _, max_tot_mm = self.schedule_for(L)
        max_ns_seq = max(L * self.max_ns // 100, self.max_ns)
        ns_bad = (reads == dna.BASE_N).sum(axis=1) > max_ns_seq

        low = host["low_mm"].astype(np.int64)
        n_low = host["n_low"].astype(np.int64)
        nxt = host["nxt_mm"].astype(np.int64)
        trunc = host["overflow"]
        aligned = low <= max_tot_mm
        unique = (aligned & ~trunc & (n_low == 1)
                  & ((nxt - low) >= self.mm_delta))
        nar = np.where(ns_bad, 3,
                       np.where(unique, 0, np.where(aligned, 2, 1))
                       ).astype(np.uint8)
        hid = host["hit_id"][:, 0].astype(np.int64)
        return {"nar": nar, "pos": hid >> 1, "strand": (hid & 1),
                "mm": low, "low_mm": low, "n_low": n_low, "nxt_mm": nxt,
                "hit_id": host["hit_id"].astype(np.int64),
                "hit_mm": host["hit_mm"].astype(np.int64),
                "overflow": trunc, "max_tot_mm": max_tot_mm}

    _NAR_NAMES = (NAR_ACCEPTED, NAR_NOHIT, NAR_MULTI, NAR_NS)

    def align_batch(self, reads: np.ndarray, return_raw: bool = False):
        """Align a [B, L] uint8 code batch; returns one AlignResult per read
        (and, with return_raw, the raw per-read stat arrays for PE pairing)."""
        compact = None if not return_raw else False
        return self._finalize(reads, self._submit(reads, compact=compact),
                              return_raw)

    def _finalize(self, reads, devout, return_raw: bool = False):
        if not isinstance(devout, dict):   # compact [B, 2] result
            raw = self._collect_compact(devout, reads)
        else:
            raw = self._classify(reads, self._collect(devout, reads))
        results = self._to_results(raw)
        hit_id, hit_mm = raw["hit_id"], raw["hit_mm"]
        max_tot_mm = raw["max_tot_mm"]
        if self.micro_indel:
            self._indel_rescue(reads, results, hit_id, hit_mm, max_tot_mm)
        if self.splice_max:
            self._splice_rescue(reads, results, hit_id, hit_mm)
        if self.chimeric_pct:
            self._chimeric_rescue(reads, results, hit_id, hit_mm)
        if return_raw:
            return results, {"low_mm": raw["low_mm"], "n_low": raw["n_low"],
                             "nxt_mm": raw["nxt_mm"], "hit_id": hit_id,
                             "hit_mm": hit_mm, "overflow": raw["overflow"]}
        return results

    def _to_results(self, raw: dict) -> list:
        nar = raw["nar"]
        pos = raw["pos"]
        strand = raw["strand"]
        low = raw["low_mm"]
        n_low = raw["n_low"]
        nxt = raw["nxt_mm"]
        has_hits = raw["hit_id"] is not None
        at_low = (raw["hit_mm"] == low[:, None]) if has_hits else None
        results: list[AlignResult] = []
        for i in range(len(nar)):
            c = nar[i]
            if c == 0:
                results.append(AlignResult(
                    NAR_ACCEPTED, strand=int(strand[i]), pos=int(pos[i]),
                    mm=int(low[i]), n_low=1,
                    nxt_mm=int(nxt[i]) if nxt is not None else INT32_MAX))
            elif c == 2:
                results.append(AlignResult(
                    NAR_MULTI, mm=int(low[i]),
                    n_low=int(n_low[i]) if n_low is not None else 0,
                    nxt_mm=int(nxt[i]) if nxt is not None else INT32_MAX,
                    multi_ids=(raw["hit_id"][i][at_low[i]]
                               if has_hits else None)))
            else:
                results.append(AlignResult(self._NAR_NAMES[c]))
        return results

    def _chimeric_rescue(self, reads, results, hit_id, hit_mm):
        """Chimeric flank-trim pass (SfxArray.cpp:7925 adaptive trim)."""
        from ..ops.chimeric import find_chimeric
        todo = [i for i, r in enumerate(results)
                if r.nar == NAR_NOHIT and hit_mm[i][0] < INT32_MAX]
        if not todo:
            return
        g = self.index.genome.seq
        C = hit_id.shape[1]
        L = reads.shape[1]
        B = len(todo)
        oriented = np.zeros((B, L), np.uint8)
        pos = np.full((B, C), INT32_MAX, np.int64)
        strand = np.zeros((B, C), np.int64)
        for j, i in enumerate(todo):
            top_strand = int(hit_id[i][0]) & 1
            r = reads[i]
            oriented[j] = dna.revcomp(r) if top_strand else r
            for c in range(C):
                hid = int(hit_id[i][c])
                if hid == INT32_MAX or (hid & 1) != top_strand:
                    continue
                pos[j, c] = hid >> 1
                strand[j, c] = top_strand
        hits = find_chimeric(g, oriented, pos, strand,
                             min_chimeric_pct=self.chimeric_pct,
                             subs_per_100=self.max_subs)
        for j, i in enumerate(todo):
            h = hits[j]
            if h is None:
                continue
            results[i] = AlignResult(
                NAR_ACCEPTED, strand=h.strand, pos=h.pos, mm=h.mm,
                n_low=1, cigar=h.cigar(L))

    def _splice_rescue(self, reads, results, hit_id, hit_mm):
        """Splice-junction pass (LocateSpliceJuncts equivalent): candidate
        locus pairs from the multiloci hits anchor a two-segment search."""
        from ..ops.splice import find_splices
        todo = [i for i, r in enumerate(results)
                if r.nar == NAR_NOHIT and hit_mm[i][0] < INT32_MAX]
        if not todo:
            return
        g = self.index.genome.seq
        C = hit_id.shape[1]
        L = reads.shape[1]
        B = len(todo)
        oriented = np.zeros((B, L), np.uint8)
        pos = np.full((B, C), INT32_MAX, np.int64)
        strand = np.zeros((B, C), np.int64)
        for j, i in enumerate(todo):
            top_strand = int(hit_id[i][0]) & 1
            r = reads[i]
            oriented[j] = dna.revcomp(r) if top_strand else r
            for c in range(C):
                hid = int(hit_id[i][c])
                if hid == INT32_MAX or (hid & 1) != top_strand:
                    continue
                pos[j, c] = hid >> 1
                strand[j, c] = top_strand
        hits = find_splices(g, oriented, pos, strand,
                            max_gap=self.splice_max)
        for j, i in enumerate(todo):
            h = hits[j]
            if h is None:
                continue
            results[i] = AlignResult(
                NAR_ACCEPTED, strand=h.strand, pos=h.pos, mm=h.mm,
                n_low=1, cigar=h.cigar(L))

    def _indel_rescue(self, reads, results, hit_id, hit_mm, max_tot_mm):
        """Second-chance microInDel pass (LocateInDels equivalent) for reads
        the substitutions-only pass rejected: their over-budget candidate
        loci anchor a single-indel split search (ops/indel.py)."""
        from ..ops.indel import find_indels
        todo = [i for i, r in enumerate(results)
                if r.nar == NAR_NOHIT and hit_mm[i][0] < INT32_MAX]
        if not todo:
            return
        g = self.index.genome.seq
        B = len(todo)
        C = hit_id.shape[1]
        L = reads.shape[1]
        oriented = np.zeros((B, L), np.uint8)
        pos = np.full((B, C), INT32_MAX, np.int64)
        strand = np.zeros((B, C), np.int64)
        for j, i in enumerate(todo):
            top_strand = int(hit_id[i][0]) & 1
            r = reads[i]
            oriented[j] = dna.revcomp(r) if top_strand else r
            for c in range(C):
                hid = int(hit_id[i][c])
                if hid == INT32_MAX or (hid & 1) != top_strand:
                    continue
                pos[j, c] = hid >> 1
                strand[j, c] = top_strand
        hits = find_indels(g, oriented, pos, strand,
                           max_indel=self.micro_indel)
        for j, i in enumerate(todo):
            h = hits[j]
            if h is None:
                continue
            results[i] = AlignResult(
                NAR_ACCEPTED, strand=h.strand, pos=h.pos, mm=h.mm,
                n_low=1, cigar=h.cigar(L))

    def align_records(self, records: Iterable[SeqRecord], *,
                      prefetch: bool = True
                      ) -> Iterator[tuple[SeqRecord, AlignResult]]:
        """Stream records, batching by read length.

        With prefetch (default), record parsing/batching runs on a background
        thread so host IO overlaps device compute — the reference's
        background reads-loader (KAligner.cpp:4786 InitiateLoadingReads /
        P4 in SURVEY.md §2.5).
        """
        def batches():
            buckets: dict[int, list[SeqRecord]] = {}
            for rec in records:
                buckets.setdefault(len(rec.codes), []).append(rec)
                bl = buckets[len(rec.codes)]
                if len(bl) >= self.batch_size:
                    yield bl
                    buckets[len(rec.codes)] = []
            for bl in buckets.values():
                if bl:
                    yield bl

        from collections import deque

        def drain(item):
            recs, arr, dev = item
            for rec, res in zip(recs, self._finalize(arr, dev)[:len(recs)]):
                yield rec, res

        def pipeline(source):
            # keep 2 device batches in flight: submit k+1 before
            # finalizing k so the chip computes while the host classifies
            pending: deque = deque()
            for bl in source:
                arr = self._pad_batch(bl)
                pending.append((bl, arr, self._submit(arr)))
                if len(pending) >= 2:
                    yield from drain(pending.popleft())
            while pending:
                yield from drain(pending.popleft())

        if not prefetch:
            yield from pipeline(batches())
            return

        import queue
        import threading
        q: "queue.Queue" = queue.Queue(maxsize=2)
        SENTINEL = object()
        err: list[BaseException] = []

        def producer():
            try:
                for bl in batches():
                    q.put(bl)
            except BaseException as e:  # surfaced on the consumer side
                err.append(e)
            finally:
                q.put(SENTINEL)

        t = threading.Thread(target=producer, daemon=True)
        t.start()

        def qsource():
            while True:
                bl = q.get()
                if bl is SENTINEL:
                    return
                yield bl

        yield from pipeline(qsource())
        t.join()
        if err:
            raise err[0]

    def align_records_raw(self, records: Iterable[SeqRecord], *,
                          prefetch: bool = True):
        """Batched raw-path streaming for the vectorized SAM writer:
        yields (recs, arr, raw) per batch, skipping per-read AlignResult
        construction entirely. Two device batches stay in flight
        (submit k+1 before collecting k) and record parsing runs on a
        background thread, as in align_records."""
        def batches():
            buckets: dict[int, list[SeqRecord]] = {}
            for rec in records:
                buckets.setdefault(len(rec.codes), []).append(rec)
                bl = buckets[len(rec.codes)]
                if len(bl) >= self.batch_size:
                    yield bl
                    buckets[len(rec.codes)] = []
            for bl in buckets.values():
                if bl:
                    yield bl

        from collections import deque

        def pipeline(source):
            pending: deque = deque()
            for bl in source:
                arr = self._pad_batch(bl)
                pending.append((bl, arr, self._submit(arr)))
                if len(pending) >= 2:
                    bl0, arr0, dev0 = pending.popleft()
                    yield bl0, arr0, self._collect_compact(dev0, arr0) \
                        if not isinstance(dev0, dict) \
                        else self._classify(arr0, self._collect(dev0, arr0))
            while pending:
                bl0, arr0, dev0 = pending.popleft()
                yield bl0, arr0, self._collect_compact(dev0, arr0) \
                    if not isinstance(dev0, dict) \
                    else self._classify(arr0, self._collect(dev0, arr0))

        if not prefetch:
            yield from pipeline(batches())
            return

        import queue
        import threading
        q: "queue.Queue" = queue.Queue(maxsize=2)
        SENTINEL = object()
        err: list[BaseException] = []

        def producer():
            try:
                for bl in batches():
                    q.put(bl)
            except BaseException as e:
                err.append(e)
            finally:
                q.put(SENTINEL)

        t = threading.Thread(target=producer, daemon=True)
        t.start()

        def qsource():
            while True:
                bl = q.get()
                if bl is SENTINEL:
                    return
                yield bl

        yield from pipeline(qsource())
        t.join()
        if err:
            raise err[0]

    def _pad_batch(self, recs: list[SeqRecord]) -> np.ndarray:
        arr = np.stack([r.codes for r in recs])
        n = len(recs)
        if n < self.batch_size:
            # pad to the fixed batch size so every device pass reuses the
            # same compiled executable (static shapes; XLA compiles once)
            pad = np.repeat(arr[:1], self.batch_size - n, axis=0)
            arr = np.concatenate([arr, pad])
        return arr


def filter_alignments(aligned, genome, *, chrom_include=None,
                      chrom_exclude=None, priority_bed=None,
                      max_pcr_dups: int = 0):
    """Post-acceptance filters applied to the (rec, res) stream, mirroring
    the reference phases FiltByChroms (KAligner.cpp:696),
    FiltByPriorityRegions (:707), and ReducePCRduplicates (:634).

    - chrom include/exclude regex lists (-Z/-z) demote accepted hits on
      excluded chromosomes to 'nohit'.
    - priority_bed: accepted hits must overlap a feature.
    - max_pcr_dups: at most this many accepted reads per (start, strand)
      locus; 0 disables. Requires a buffered pass (sorted by locus), so this
      generator materializes when enabled.
    """
    import re
    inc = [re.compile(x) for x in (chrom_include or [])]
    exc = [re.compile(x) for x in (chrom_exclude or [])]

    def chrom_ok(name: str) -> bool:
        if inc:
            return any(p_.search(name) for p_ in inc)
        if exc:
            return not any(p_.search(name) for p_ in exc)
        return True

    def apply(rec, res):
        if res.nar != NAR_ACCEPTED:
            return rec, res
        ci, off = genome.locate(np.array([res.pos]))
        name = genome.names[int(ci[0])]
        if not chrom_ok(name):
            return rec, AlignResult(NAR_NOHIT)
        if priority_bed is not None:
            L = len(rec.codes)
            if not priority_bed.overlapping(name, int(off[0]),
                                            int(off[0]) + L):
                return rec, AlignResult(NAR_NOHIT)
        return rec, res

    if not max_pcr_dups:
        for rec, res in aligned:
            yield apply(rec, res)
        return
    # PCR duplicate reduction needs locus grouping: buffer, count per
    # (pos, strand), demote beyond the cap (reference keeps the first)
    buffered = [apply(rec, res) for rec, res in aligned]
    counts: dict = {}
    for rec, res in buffered:
        if res.nar != NAR_ACCEPTED:
            yield rec, res
            continue
        key = (res.pos, res.strand)
        n = counts.get(key, 0) + 1
        counts[key] = n
        if n > max_pcr_dups:
            yield rec, AlignResult(NAR_NOHIT)
        else:
            yield rec, res


def write_align_stats(path, stats: dict, sub_hist: np.ndarray,
                      insert_hist: np.ndarray | None = None) -> None:
    """Aligner stats CSV (reference -O output: substitution distribution,
    KAligner.cpp:3600; PE insert-size distribution, :5323)."""
    with open(path, "w") as f:
        f.write('"section","key","value"\n')
        for k, v in stats.items():
            f.write(f'"classification","{k}",{v}\n')
        for i, c in enumerate(sub_hist):
            if c:
                f.write(f'"substitutions","{i}",{int(c)}\n')
        if insert_hist is not None:
            for i, c in enumerate(insert_hist):
                if c:
                    f.write(f'"insert_size","{i}",{int(c)}\n')


def write_sam(path, index: SfxIndex, aligned, cmdline: str = "",
              emit_unmapped: bool = True, snp_caller=None,
              stats_path=None, bam_index=False) -> dict:
    """Write (SeqRecord, AlignResult) stream to SAM (or BAM when the path
    ends .bam); returns counters.

    When `snp_caller` (align.snp.SnpCaller) is given, accepted alignments are
    also accumulated into its pileup (the kalign SNP phase input,
    KAligner.cpp:795-809). `stats_path` writes the substitution-distribution
    CSV (-O equivalent).
    """
    g = index.genome
    from collections import defaultdict
    stats = defaultdict(int)
    stats.update({NAR_ACCEPTED: 0, NAR_NOHIT: 0, NAR_MULTI: 0, NAR_NS: 0})
    snp_pos: list[int] = []
    snp_reads: list[np.ndarray] = []

    def flush_snp():
        if snp_caller is not None and snp_pos:
            snp_caller.add_alignments(np.asarray(snp_pos, np.int64),
                                      np.stack(snp_reads))
            snp_pos.clear()
            snp_reads.clear()

    sub_hist = np.zeros(64, np.int64)
    import bisect
    starts_list = g.starts.tolist()  # per-read locate via bisect (fast path)
    writer_cls = SamWriter
    if str(path).endswith(".bam"):
        from ..io.bam import BamWriter
        if bam_index:
            # BAI needs coordinate order: buffer, sort by (chrom, loci),
            # then write BAM+BAI (the reference sorts accepted hits before
            # WriteBAMReadHits, KAligner.cpp:5718)
            class _SortedBam:
                def __init__(self, *a, **kw):
                    kw["index"] = bam_index   # True -> BAI, "csi" -> CSI
                    self._a, self._kw = a, kw
                    self._order = {n: i for i, n in enumerate(a[1])}
                    self._recs = []

                def write(self, aln):
                    self._recs.append(aln)

                def __enter__(self):
                    return self

                def __exit__(self, *exc):
                    self._recs.sort(key=lambda r: (
                        self._order.get(r.rname, 1 << 30), r.pos))
                    with BamWriter(*self._a, **self._kw) as bw:
                        for r in self._recs:
                            bw.write(r)
            writer_cls = _SortedBam
        else:
            writer_cls = BamWriter
    with writer_cls(path, g.names, g.lengths, pg_cl=cmdline) as w:
        for rec, res in aligned:
            stats[res.nar] += 1
            if res.nar == NAR_ACCEPTED:
                ci = bisect.bisect_right(starts_list, res.pos) - 1
                off = res.pos - starts_list[ci]
                rev = res.strand == 1
                seq, qual = seq_qual_for_strand(rec.codes, rec.qual, rev)
                cigar = res.cigar or f"{len(rec.codes)}M"
                nm = res.mm
                matched = len(rec.codes)
                if res.cigar:
                    import re as _re
                    # NM counts indel bases (SAM spec); 'N' skips do not
                    nm += sum(int(x) for x in
                              _re.findall(r"(\d+)[ID]", res.cigar))
                    matched = sum(int(x) for x in
                                  _re.findall(r"(\d+)M", res.cigar))
                # reference MAPQ scheme (KAligner.cpp:6146-6233): 254 base,
                # -20 splice, -10 microInDel, scaled by matched fraction
                mapq = 254
                if res.cigar:
                    if "N" in res.cigar:
                        mapq -= 20
                    elif "I" in res.cigar or "D" in res.cigar:
                        mapq -= 10
                mapq = min(254, max(1, mapq * matched // len(rec.codes)))
                flag = FLAG_REVERSE if rev else 0
                if res.secondary:
                    flag |= 0x100
                w.write(SamAlignment(
                    qname=rec.name, flag=flag,
                    rname=g.names[ci], pos=off + 1,
                    mapq=mapq, cigar=cigar, seq=seq, qual=qual,
                    tags=(f"NM:i:{nm}",)))
                sub_hist[min(res.mm, 63)] += 1
                if res.cigar is not None or res.secondary:
                    continue  # indel/secondary reads do not feed the pileup
                if snp_caller is not None:
                    oriented = (dna.revcomp(rec.codes) if rev
                                else rec.codes)
                    snp_pos.append(res.pos)
                    snp_reads.append(oriented)
                    if len(snp_pos) >= 16384 and \
                            len(snp_reads[0]) == len(oriented):
                        flush_snp()
            elif emit_unmapped:
                seq, qual = seq_qual_for_strand(rec.codes, rec.qual, False)
                w.write(SamAlignment(
                    qname=rec.name, flag=FLAG_UNMAPPED, rname="*", pos=0,
                    mapq=0, cigar="*", seq=seq, qual=qual))
            # length change would break np.stack batching; flush eagerly
            if snp_caller is not None and snp_reads and \
                    len(snp_reads[-1]) != len(snp_reads[0]):
                last_p, last_r = snp_pos.pop(), snp_reads.pop()
                flush_snp()
                snp_pos.append(last_p)
                snp_reads.append(last_r)
    flush_snp()
    if stats_path:
        write_align_stats(stats_path, stats, sub_hist)
    return stats


_ASCII_FWD = np.frombuffer(b"ACGTNNNN", np.uint8)          # code -> base
_ASCII_RC = np.frombuffer(b"TGCANNNN", np.uint8)           # code -> comp


def _align_blocks_raw(aligner: "KAligner", src_path):
    """Zero-object block pipeline: uniform-length read blocks straight
    from io.fasta.read_seq_blocks into the device submit queue (two
    batches in flight, parsing on a producer thread). Yields
    (names: list[bytes], arr [B, L], quals [n, L] | None, raw, n)."""
    import queue
    import threading
    from collections import deque

    from ..io.fasta import read_seq_blocks

    B = aligner.batch_size
    q: "queue.Queue" = queue.Queue(maxsize=2)
    SENTINEL = object()
    err: list[BaseException] = []

    def producer():
        try:
            for blk in read_seq_blocks(src_path, B):
                q.put(blk)
        except BaseException as e:
            err.append(e)
        finally:
            q.put(SENTINEL)

    threading.Thread(target=producer, daemon=True).start()

    def collect(arr, dev):
        return aligner._collect_compact(dev, arr) \
            if not isinstance(dev, dict) \
            else aligner._classify(arr, aligner._collect(dev, arr))

    pending: deque = deque()
    while True:
        blk = q.get()
        if blk is SENTINEL:
            break
        names, codes, quals = blk
        n = len(names)
        arr = codes
        if n < B:
            arr = np.concatenate(
                [codes, np.repeat(codes[:1], B - n, axis=0)])
        pending.append((names, arr, quals, n, aligner._submit(arr)))
        if len(pending) >= 2:
            nm0, a0, q0, n0, d0 = pending.popleft()
            yield nm0, a0, q0, collect(a0, d0), n0
    if err:
        raise err[0]
    while pending:
        nm0, a0, q0, n0, d0 = pending.popleft()
        yield nm0, a0, q0, collect(a0, d0), n0


def write_sam_fast(path, index: SfxIndex, aligner: "KAligner", records,
                   cmdline: str = "", emit_unmapped: bool = True,
                   snp_caller=None, stats_path=None) -> dict:
    """Vectorized end-to-end fastq/fasta -> SAM: batches from
    KAligner.align_records_raw are classified as whole arrays and the SAM
    text is emitted by the native bulk formatter (native/hostops.cpp
    format_sam_se — the reference's AppendStr fast-writer scheme,
    KAligner.cpp:6338-6418), skipping per-read Python object churn.

    `records` may be an iterable of SeqRecords OR a fastq/fasta path:
    a path with uniform-length reads takes the zero-object block route
    (io.fasta.read_seq_blocks — arrays straight from the file bytes to
    the device submit queue, byte-identical SAM output).

    Requirements: SE substitutions-only aligner (no microInDel / splice /
    chimeric rescue), plain-text SAM output, native lib built. Falls back
    to write_sam when any requirement is unmet. Returns the same stats
    dict as write_sam."""
    import ctypes
    import os as _os

    from ..index.sa_build import _load_native
    lib = _load_native()
    src_path = records if isinstance(records, (str, _os.PathLike)) \
        else None
    if (str(path).endswith(".bam") or aligner.micro_indel
            or aligner.splice_max or aligner.chimeric_pct
            or lib is None or not hasattr(lib, "format_sam_se")):
        from ..io.fasta import read_seqs
        rec_iter = read_seqs(src_path) if src_path is not None else records
        return write_sam(path, index, aligner.align_records(rec_iter),
                         cmdline=cmdline, emit_unmapped=emit_unmapped,
                         snp_caller=snp_caller, stats_path=stats_path)

    blocks_gen = first_block = None
    if src_path is not None:
        blocks_gen = _align_blocks_raw(aligner, src_path)
        try:
            first_block = next(blocks_gen)
        except ValueError:        # non-uniform read lengths
            from ..io.fasta import read_seqs
            blocks_gen = None
            records = read_seqs(src_path)
        except StopIteration:     # empty input
            pass

    g = index.genome
    starts = g.starts.astype(np.int64)
    chrom_cat = "".join(g.names).encode()
    chrom_ofs = np.zeros(len(g.names) + 1, np.int64)
    chrom_ofs[1:] = np.cumsum([len(n) for n in g.names])
    stats = {NAR_ACCEPTED: 0, NAR_NOHIT: 0, NAR_MULTI: 0, NAR_NS: 0}
    sub_hist = np.zeros(64, np.int64)

    with open(path, "w", newline="") as f:
        f.write("@HD\tVN:1.4\tSO:unsorted\n")
        for name, ln in zip(g.names, g.lengths):
            f.write(f"@SQ\tSN:{name}\tLN:{int(ln)}\n")
        f.write(f"@PG\tID:kit4b_tpu\tPN:kit4b_tpu\tCL:{cmdline}\n")
    def emit(raw_f, names, arr, quals_all, raw, n):
        """Format + write one aligned block. names: list[bytes] (n);
        arr: uint8 [>=n, L] codes; quals_all: uint8 [n, L] raw phred+33
        ASCII or None; raw: compact result dict from the aligner."""
        L = arr.shape[1]
        nar = raw["nar"][:n]
        pos = raw["pos"][:n].astype(np.int64)
        strand = raw["strand"][:n].astype(np.int64)
        mm = np.asarray(raw["mm"][:n])
        cnt = np.bincount(nar, minlength=4)
        for c_i, key in enumerate((NAR_ACCEPTED, NAR_NOHIT,
                                   NAR_MULTI, NAR_NS)):
            stats[key] += int(cnt[c_i])
        acc = nar == 0
        sub_hist[:] = sub_hist + np.bincount(
            np.minimum(mm[acc], 63), minlength=64)
        if not emit_unmapped:
            sel = np.nonzero(acc)[0]
        else:
            sel = np.arange(n)
        if len(sel) == 0:
            return
        codes = arr[sel]
        acc_s = acc[sel]
        rev_s = acc_s & (strand[sel] == 1)
        # strand-oriented ASCII sequence, vectorized
        seq_ascii = _ASCII_FWD[codes]
        if rev_s.any():
            seq_ascii[rev_s] = _ASCII_RC[codes[rev_s][:, ::-1]]
        # first-byte 0 sentinel -> formatter emits "*" (no quality);
        # reverse-strand hits emit reversed qualities (SAMfile parity,
        # io/sam.py seq_qual_for_strand)
        if quals_all is None:
            quals = np.zeros((len(sel), L), np.uint8)
        else:
            quals = np.ascontiguousarray(quals_all[sel])
            if rev_s.any():
                quals[rev_s] = quals[rev_s][:, ::-1]
        ci = np.zeros(len(sel), np.int64)
        pos1 = np.zeros(len(sel), np.int64)
        if acc_s.any():
            p_acc = pos[sel][acc_s]
            c_acc = np.searchsorted(starts, p_acc,
                                    side="right") - 1
            ci[acc_s] = c_acc
            pos1[acc_s] = p_acc - starts[c_acc] + 1
        flag = np.where(acc_s,
                        np.where(rev_s, FLAG_REVERSE, 0),
                        FLAG_UNMAPPED).astype(np.int32)
        mapq = np.full(len(sel), 254, np.int32)
        nm = mm[sel].astype(np.int32)
        sel_names = [names[i] for i in sel] if len(sel) != n else names
        qn_cat = b"".join(sel_names)
        qn_ofs = np.zeros(len(sel) + 1, np.int64)
        qn_ofs[1:] = np.cumsum([len(x) for x in sel_names])
        # +16: the native guard checks against out+cap-1 with the full
        # per-record worst case, so an exact-fit cap is 1 byte short
        # (visible on single-read batches with short names)
        max_cn = max((len(n) for n in g.names), default=1)
        cap = int(qn_ofs[-1]) + len(sel) * (2 * L + max_cn + 128) + 16
        out = ctypes.create_string_buffer(cap)
        nb = lib.format_sam_se(
            qn_cat, qn_ofs.ctypes.data_as(
                ctypes.POINTER(ctypes.c_int64)),
            chrom_cat, chrom_ofs.ctypes.data_as(
                ctypes.POINTER(ctypes.c_int64)),
            flag.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ci.astype(np.int32).ctypes.data_as(
                ctypes.POINTER(ctypes.c_int32)),
            pos1.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            mapq.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            nm.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            np.ascontiguousarray(seq_ascii).ctypes.data_as(
                ctypes.POINTER(ctypes.c_uint8)),
            quals.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            len(sel), L, out, cap)
        if nb < 0:
            raise RuntimeError("format_sam_se buffer overflow")
        raw_f.write(out.raw[:nb])
        if snp_caller is not None and acc_s.any():
            orient = codes[acc_s].copy()
            r2 = rev_s[acc_s]
            if r2.any():
                rc = orient[r2][:, ::-1]
                orient[r2] = np.where(rc < 4, 3 - rc, rc)
            snp_caller.add_alignments(pos[sel][acc_s], orient)

    # body appended via the native formatter
    with open(path, "ab") as raw_f:
        if blocks_gen is not None:
            if first_block is not None:
                emit(raw_f, *first_block)
                for blk in blocks_gen:
                    emit(raw_f, *blk)
        else:
            for recs, arr, raw in aligner.align_records_raw(records):
                n = len(recs)
                L = arr.shape[1]
                quals_all = None
                if any(r.qual is not None for r in recs):
                    quals_all = np.zeros((n, L), np.uint8)
                    for i, r in enumerate(recs):
                        if r.qual is not None and len(r.qual) == L:
                            quals_all[i] = np.asarray(
                                r.qual, np.uint8) + 33
                emit(raw_f, [r.name.encode() for r in recs], arr,
                     quals_all, raw, n)
    if stats_path:
        write_align_stats(stats_path, stats, sub_hist)
    return stats
