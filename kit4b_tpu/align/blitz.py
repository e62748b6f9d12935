"""blitz: BLAT-like local alignment of long queries against the index.

Capability parity with CBlitz (libkit4b/CBlitz.cpp:341 Process — seed K-mers
into tsQueryAlignNodes, path scoring IdentifyHighScorePaths:2603, output
:1854-2544): long queries (contigs, transcripts, long reads) are seeded at a
stride through the k-mer LUT, hits are chained along diagonals into local
alignment blocks, blocks are scored by ungapped extension, and results are
reported PSL-style and as SAM.

Device shape: seeding is one batched LUT gather per query chunk (the same
machinery as kalign's seed stage); chaining/scoring is a vectorized
diagonal-sort on the host (hit counts are tiny relative to genome scale).
Banded affine DP refinement arrives with the microInDel kernel.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import dna
from ..index.sfx_index import SfxIndex


@dataclass
class BlitzHit:
    query: str
    q_start: int
    q_end: int
    chrom: str
    t_start: int
    t_end: int
    strand: str
    matches: int
    mismatches: int
    score: int
    q_gaps: int = 0
    t_gaps: int = 0
    q_gap_bases: int = 0
    t_gap_bases: int = 0
    blocks: list | None = None   # [(q_start, t_start, len)] gapped blocks


def _seed_hits(index: SfxIndex, q: np.ndarray, stride: int,
               max_per_seed: int = 16):
    """Seed positions (qpos, tpos) for one query strand via the LUT."""
    g = index.genome
    k = index.lut_k
    L = len(q)
    if L < k:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    starts = np.arange(0, L - k + 1, stride)
    w = q[starts[:, None] + np.arange(k)]
    ok = (w < 4).all(axis=1)
    pow4 = 4 ** np.arange(k - 1, -1, -1, dtype=np.int64)
    keys = (w.astype(np.int64) * pow4).sum(axis=1)
    lo = index.lut[keys]
    hi = np.minimum(index.lut[keys + 1], lo + max_per_seed)
    qps, tps = [], []
    for s, a, b, good in zip(starts, lo, hi, ok):
        if not good or b <= a:
            continue
        t = index.sa_clean[a:b]
        qps.extend([s] * len(t))
        tps.extend(t.tolist())
    return np.asarray(qps, np.int64), np.asarray(tps, np.int64)


def _chain_and_score(index: SfxIndex, q: np.ndarray, qps, tps, *,
                     strand: str, qname: str, min_hits: int,
                     band: int, min_score: int,
                     match: int = 1, mismatch: int = -2):
    """Cluster seeds by diagonal band, score blocks by direct compare."""
    g = index.genome
    out = []
    if len(qps) == 0:
        return out
    diag = tps - qps
    order = np.lexsort((tps, diag))
    diag, qps, tps = diag[order], qps[order], tps[order]
    # split where diagonal jumps beyond the band or target jumps far
    brk = np.nonzero((np.diff(diag) > band)
                     | (np.diff(tps) > 100_000))[0] + 1
    k = index.lut_k
    for grp in np.split(np.arange(len(qps)), brk):
        if len(grp) < min_hits:
            continue
        q0 = int(qps[grp].min())
        q1 = int(qps[grp].max()) + k
        d0 = int(np.median(diag[grp]))
        t0, t1 = q0 + d0, q1 + d0
        if t0 < 0 or t1 > len(g.seq):
            continue
        qseg = q[q0:q1]
        tseg = g.seq[t0:t1]
        n = min(len(qseg), len(tseg))
        mm = int(((qseg[:n] != tseg[:n]) | (qseg[:n] >= 4)
                  | (tseg[:n] >= 4)).sum())
        score = (n - mm) * match + mm * mismatch
        if score < min_score:
            continue
        ci = int(np.searchsorted(g.starts, t0, side="right") - 1)
        out.append(BlitzHit(qname, q0, q0 + n, g.names[ci],
                            t0 - int(g.starts[ci]),
                            t0 - int(g.starts[ci]) + n,
                            strand, n - mm, mm, score))
    return out


def blitz_align(index: SfxIndex, records, *, stride: int = 4,
                min_hits: int = 3, band: int = 12, min_score: int = 50,
                max_hits_per_query: int = 16,
                gapped: bool = False, sw_band: int = 256) -> list[BlitzHit]:
    """Align each query record; returns hits sorted by score per query.

    gapped=True refines every chained block with the banded affine SW
    engine (CBlitz::HighScoreSW, CBlitz.cpp:1560 — here pacbio/sswd),
    replacing the ungapped score with the gapped alignment, its block
    structure, and gap accounting for PSL."""
    hits: list[BlitzHit] = []
    # gapped mode defers the score threshold to the SW stage: an indel
    # within the diagonal band makes the merged chain score poorly
    # UNGAPPED (e.g. a 12 bp deletion in a 600 bp query nets -75), but
    # HighScoreSW-style refinement recovers it — the reference scores
    # paths with SW before thresholding (CBlitz.cpp:1560)
    pre_score = -(1 << 30) if gapped else min_score
    for rec in records:
        per_q: list[BlitzHit] = []
        for strand, q in (("+", rec.codes),
                          ("-", dna.revcomp(rec.codes))):
            qps, tps = _seed_hits(index, q, stride)
            per_q.extend(_chain_and_score(
                index, q, qps, tps, strand=strand, qname=rec.name,
                min_hits=min_hits, band=band, min_score=pre_score))
        if gapped and per_q:
            per_q = _refine_gapped(index, rec, per_q, sw_band, min_score)
        per_q.sort(key=lambda h: -h.score)
        hits.extend(per_q[:max_hits_per_query])
    return hits


def _refine_gapped(index: SfxIndex, rec, hits: list[BlitzHit],
                   sw_band: int, min_score: int) -> list[BlitzHit]:
    """Banded-SW refinement of chained blocks (one device batch/query)."""
    from ..pacbio.sswd import SWScores, banded_sw_batch
    g = index.genome
    name_to_ci = {n: i for i, n in enumerate(g.names)}
    B = len(hits)
    margin = sw_band // 2
    qs = {s: (rec.codes if s == "+" else dna.revcomp(rec.codes))
          for s in "+-"}
    Lp = max(len(rec.codes), 1)
    jobs = []
    for h in hits:
        ci = name_to_ci[h.chrom]
        ts = int(g.starts[ci])
        tl = int(g.lengths[ci])
        t0 = max(0, h.t_start - h.q_start - margin)
        t1 = min(tl, h.t_end + (Lp - h.q_end) + margin)
        jobs.append((ts + t0, t1 - t0, t0))
    Lt = max(j[1] for j in jobs)
    probes = np.full((B, Lp), 0x0F, np.uint8)
    targets = np.full((B, Lt), 0x0F, np.uint8)
    plens = np.zeros(B, np.int32)
    tlens = np.zeros(B, np.int32)
    diag0 = np.zeros(B, np.int32)
    for b, (h, (gt0, tl, t0)) in enumerate(zip(hits, jobs)):
        q = qs[h.strand]
        probes[b, :len(q)] = q
        targets[b, :tl] = g.seq[gt0: gt0 + tl]
        plens[b] = len(q)
        tlens[b] = tl
        diag0[b] = (h.t_start - t0) - h.q_start
    res = banded_sw_batch(probes, plens, targets, tlens, diag0,
                          band=sw_band, scores=SWScores(1, -2, -3, -1))
    out = []
    for h, a, (gt0, tl, t0) in zip(hits, res, jobs):
        if a.score < min_score:
            continue
        blocks = []
        qi, ti = a.p_start, a.t_start + t0
        qg = tg = qgb = tgb = 0
        for op, n in a.ops:
            if op == "M":
                if blocks and blocks[-1][0] + blocks[-1][2] == qi \
                        and blocks[-1][1] + blocks[-1][2] == ti:
                    blocks[-1] = (blocks[-1][0], blocks[-1][1],
                                  blocks[-1][2] + n)
                else:
                    blocks.append((qi, ti, n))
                qi += n
                ti += n
            elif op == "D":
                qg += 1
                qgb += n
                qi += n
            else:
                tg += 1
                tgb += n
                ti += n
        out.append(BlitzHit(h.query, a.p_start, a.p_end, h.chrom,
                            a.t_start + t0, a.t_end + t0, h.strand,
                            a.matches, a.mismatches, a.score,
                            q_gaps=qg, t_gaps=tg, q_gap_bases=qgb,
                            t_gap_bases=tgb, blocks=blocks))
    return out


def write_psl(path, hits: list[BlitzHit], q_lens: dict,
              t_lens: dict) -> None:
    """PSL output (CBlitz PSL writer, CBlitz.cpp:1854)."""
    with open(path, "w") as f:
        f.write("psLayout version 3\n\nmatch\tmis-\trep.\tN's\tQ gap\tQ gap"
                "\tT gap\tT gap\tstrand\tQ name\tQ size\tQ start\tQ end\t"
                "T name\tT size\tT start\tT end\tblock\tblockSizes\t"
                "qStarts\ttStarts\ncount\tmatch\tmatch\t\tcount\tbases\t"
                "count\tbases\n" + "-" * 80 + "\n")
        for h in hits:
            blocks = h.blocks or [(h.q_start, h.t_start,
                                   h.q_end - h.q_start)]
            f.write("\t".join(map(str, [
                h.matches, h.mismatches, 0, 0, h.q_gaps, h.q_gap_bases,
                h.t_gaps, h.t_gap_bases, h.strand,
                h.query, q_lens.get(h.query, 0), h.q_start, h.q_end,
                h.chrom, t_lens.get(h.chrom, 0), h.t_start, h.t_end,
                len(blocks),
                "".join(f"{b[2]}," for b in blocks),
                "".join(f"{b[0]}," for b in blocks),
                "".join(f"{b[1]}," for b in blocks)])) + "\n")
