"""callhaplotypes allelic-association-score modes 7/8/9/11/12.

Capability parity with CCallHaplotypes (ngskit4b/CallHaplotypes.cpp):

- mode 7 (eMCSHSrcVsRefs)  / mode 8 (eMCSHRefsVsRefs): per-bin homozygosity
  scoring of source PBAs against reference PBAs (or all refs vs all refs).
  Scoring semantics follow AlignSelfPBAsThread (CallHaplotypes.cpp:3559-3710):
  a locus contributes only when BOTH PBAs have coverage; exact byte equality
  counts NumExactMatches (and NumBiallelicExactMatches when the shared PBA is
  one of the six biallelic patterns); otherwise an allele-set intersection
  counts NumNonRefAlleles when the source carries an allele absent from the
  reference, else NumPartialMatches. ExactScore = exact/alignlen;
  PartialScore = (exact + (partial+nonref)/2)/alignlen. Output CSV layout is
  the reference's (GenPBAsHomozygosityScores, :3796).

- mode 11 (eMCSHKFiltScores): filter a scores CSV by source/reference name
  regexes (FilterAlleleScores :11232).

- mode 12 (eMCSHKTransFiltScores): filter + pivot to per-(src,bin) rows with
  one column per reference, seven value-type rows per bin
  (FilterTransformAlleleScores :11452-11905).

- mode 9 (eMCSHGroupScores): group sources to references by score —
  bin-score imputation (bins < 10000 bp or <1% aligned imputed from the
  previous directly-accepted bin, retro-imputation of the immediately
  preceding rejected bin; ProcessAlleleScoreBins :11940-12110), noise-ref
  pruning to a Min/MaxUnprunedRefs window (:12296-12460, implemented to the
  documented intent: iteratively drop references with the fewest
  highest-scoring bins genome-wide), per-bin highest-PartialScore reference
  selection with 3-bin outlier correction (:12500-12870), and the
  imputation / imputation-summary / grouping-matrix CSV outputs.

The per-locus scoring is plain byte arithmetic over [G] uint8 arrays —
bandwidth-bound, vectorized NumPy (one pass per src x ref pair per chrom;
bin reduction via np.add.reduceat). This is a host-side analysis engine, not
a device hot path.
"""
from __future__ import annotations

import csv
import re
from dataclasses import dataclass, field

import numpy as np

# the six biallelic exact-match PBA patterns (CallHaplotypes.cpp:3682)
_BIALLELIC = np.zeros(256, np.bool_)
for _b in (0xF0, 0xCC, 0xC3, 0x3C, 0x33, 0x0F):
    _BIALLELIC[_b] = True

SCORE_HEADER = ('"SourcePBA","ReferencePBA","Chrom","Bin","BinLoci",'
                '"BinSize","AlignLen","NumExactMatches",'
                '"NumBiallelicExactMatches","NumPartialMatches",'
                '"NumNonRefAlleles","ExactScore","PartialScore"')


def score_pair_bins(src: np.ndarray, ref: np.ndarray,
                    bin_size: int) -> list[tuple]:
    """Score one (source, reference) PBA pair along one chromosome.
    Returns per-bin tuples (bin_id, bin_loci, bin_size, align_len, exact,
    biallelic, partial, nonref, exact_score, partial_score)."""
    n = min(len(src), len(ref))
    src = np.asarray(src[:n], np.uint8)
    ref = np.asarray(ref[:n], np.uint8)
    chrom_len = n
    bs = bin_size if bin_size > 0 else chrom_len
    bs = min(bs, chrom_len)
    cov = (src > 0) & (ref > 0)
    exact = cov & (src == ref)
    biallelic = exact & _BIALLELIC[ref]
    inter = cov & ~exact & ((src & ref) != 0)
    nonref = inter & ((~ref & src) != 0)
    partial = inter & ~nonref
    edges = np.arange(0, chrom_len, bs)
    cnt = [np.add.reduceat(m.astype(np.int64), edges)
           for m in (cov, exact, biallelic, partial, nonref)]
    out = []
    for i, loci in enumerate(edges):
        size = min(bs, chrom_len - loci)
        al, ex, bi, pa, nr = (int(c[i]) for c in cnt)
        if al > 0:
            es = ex / al
            ps = (ex + (pa + nr) / 2) / al
        else:
            es = ps = 0.0
        out.append((i + 1, int(loci), size, al, ex, bi, pa, nr, es, ps))
    return out


def gen_allele_scores(ref_pbas: dict[str, dict], src_pbas: dict[str, dict],
                      out_csv: str, *, bin_size: int = 100_000) -> int:
    """Modes 7/8: score every source PBA against every reference PBA
    per chromosome per bin; write the reference's .score.csv layout
    (GenPBAsHomozygosityScores). src_pbas == {} means refs vs refs
    (mode 8). Returns rows written."""
    srcs = src_pbas if src_pbas else ref_pbas
    ref_names = list(ref_pbas)
    chrom_order: list[str] = []
    for chroms in ref_pbas.values():
        for c in chroms:
            if c not in chrom_order:
                chrom_order.append(c)
    rows = 0
    with open(out_csv, "w") as f:
        f.write(SCORE_HEADER + "\n")
        for chrom in chrom_order:
            for sname, schroms in srcs.items():
                for rname in ref_names:
                    rchroms = ref_pbas[rname]
                    if chrom not in schroms or chrom not in rchroms:
                        continue
                    for (bid, loci, size, al, ex, bi, pa, nr, es,
                         ps) in score_pair_bins(schroms[chrom],
                                                rchroms[chrom], bin_size):
                        f.write(f'"{sname}","{rname}","{chrom}",{bid},'
                                f'{loci},{size},{al},{ex},{bi},{pa},{nr},'
                                f'{es:.7f},{ps:.7f}\n')
                        rows += 1
    return rows


def _compile_res(patterns) -> list[re.Pattern] | None:
    if not patterns:
        return None
    return [re.compile(p) for p in patterns]


def _match_any(res, name: str) -> bool:
    return res is None or any(r.search(name) for r in res)


def read_score_csv(path) -> list[dict]:
    """Parse an allele-association scores CSV into row dicts."""
    rows = []
    with open(path) as f:
        rd = csv.reader(f)
        for i, flds in enumerate(rd):
            if not flds or (i == 0 and flds[0] == "SourcePBA"):
                continue
            rows.append({
                "src": flds[0], "ref": flds[1], "chrom": flds[2],
                "bin": int(flds[3]), "loci": int(flds[4]),
                "size": int(flds[5]), "alignlen": int(flds[6]),
                "exact": int(flds[7]), "biallelic": int(flds[8]),
                "partial": int(flds[9]), "nonref": int(flds[10]),
                "escore": float(flds[11]), "pscore": float(flds[12])})
    return rows


def filter_allele_scores(in_csv, out_csv, *, src_res=None, ref_res=None,
                         chrom_res=None) -> int:
    """Mode 11 (FilterAlleleScores): retain rows whose source / reference /
    chromosome names match the include regexes (None = accept all)."""
    sre, rre, cre = (_compile_res(src_res), _compile_res(ref_res),
                     _compile_res(chrom_res))
    kept = 0
    with open(in_csv) as fi, open(out_csv, "w") as fo:
        for i, line in enumerate(fi):
            if i == 0 and line.startswith('"SourcePBA"'):
                fo.write(line)
                continue
            flds = next(csv.reader([line]))
            if len(flds) < 13:
                continue
            if (_match_any(sre, flds[0]) and _match_any(rre, flds[1])
                    and _match_any(cre, flds[2])):
                fo.write(line)
                kept += 1
    return kept


def filter_transform_allele_scores(in_csv, out_csv, *, src_res=None,
                                   ref_res=None, chrom_res=None) -> int:
    """Mode 12 (FilterTransformAlleleScores): filter then pivot — rows
    keyed (chrom, bin, src) sorted ascending, one column per retained
    reference, seven value-type rows per key (AlignLen, NumExactMatches,
    NumBiallelicExactMatches, NumPartialMatches, NumNonRefAlleles,
    ExactScore, PartialScore)."""
    sre, rre, cre = (_compile_res(src_res), _compile_res(ref_res),
                     _compile_res(chrom_res))
    rows = [r for r in read_score_csv(in_csv)
            if _match_any(sre, r["src"]) and _match_any(rre, r["ref"])
            and _match_any(cre, r["chrom"])]
    if not rows:
        open(out_csv, "w").close()
        return 0
    chrom_ord = {c: i for i, c in enumerate(
        dict.fromkeys(r["chrom"] for r in rows))}
    src_ord = {s: i for i, s in enumerate(
        dict.fromkeys(r["src"] for r in rows))}
    ref_ord = {s: i for i, s in enumerate(
        dict.fromkeys(r["ref"] for r in rows))}
    rows.sort(key=lambda r: (chrom_ord[r["chrom"]], r["bin"],
                             src_ord[r["src"]], ref_ord[r["ref"]]))
    refs = [r["ref"] for r in rows[:len(ref_ord)]]
    nrefs = len(refs)
    int_types = [("AlignLen", "alignlen"), ("NumExactMatches", "exact"),
                 ("NumBiallelicExactMatches", "biallelic"),
                 ("NumPartialMatches", "partial"),
                 ("NumNonRefAlleles", "nonref")]
    dbl_types = [("ExactScore", "escore"), ("PartialScore", "pscore")]
    n_out = 0
    with open(out_csv, "w") as f:
        f.write('"SourcePBA","Value","Chrom","Bin","BinLoci","BinSize"')
        for rn in refs:
            f.write(f',"{rn}"')
        for i in range(0, len(rows), nrefs):
            grp = rows[i:i + nrefs]
            a = grp[0]
            for vname, key in int_types + dbl_types:
                f.write(f'\n"{a["src"]}","{vname}","{a["chrom"]}",'
                        f'{a["bin"]},{a["loci"]},{a["size"]}')
                for g in grp:
                    if key in ("escore", "pscore"):
                        f.write(f',"{g[key]:0.5f}"')
                    else:
                        f.write(f',"{g[key]}"')
                n_out += 1
        f.write("\n")
    return n_out


# --- mode 9: grouping by allelic association scores -----------------------

# bin ProcState flags (CallHaplotypes.h:92-99)
ACCEPTED = 0x01
IMPUTED = 0x02
NOT_ACCEPTED = 0x04
REF_PRUNED = 0x08
REF_SELECTED = 0x10
NO_DIFF_REFS = 0x20


@dataclass
class ScoreBins:
    """Scores organised [n_src, n_ref, n_bins] over concatenated
    (chrom, bin) pairs, mirroring the reference's ChromID.BinLoci.SrcID.RefID
    ordering."""
    srcs: list[str]
    refs: list[str]
    chroms: list[str]          # per concat bin: chrom name
    bin_ids: np.ndarray        # per concat bin: 1-based bin id within chrom
    bin_loci: np.ndarray
    bin_sizes: np.ndarray
    alignlen: np.ndarray       # [S, R, B]
    escore: np.ndarray         # [S, R, B] float
    pscore: np.ndarray         # [S, R, B] float
    state: np.ndarray = field(init=False)  # [S, R, B] uint8

    def __post_init__(self):
        self.state = np.zeros(self.escore.shape, np.uint8)


def load_score_bins(path) -> ScoreBins:
    rows = read_score_csv(path)
    if not rows:
        raise ValueError(f"no score rows in {path}")
    srcs = list(dict.fromkeys(r["src"] for r in rows))
    refs = list(dict.fromkeys(r["ref"] for r in rows))
    keys = list(dict.fromkeys((r["chrom"], r["bin"]) for r in rows))
    kidx = {k: i for i, k in enumerate(keys)}
    sidx = {s: i for i, s in enumerate(srcs)}
    ridx = {s: i for i, s in enumerate(refs)}
    nb = len(keys)
    shape = (len(srcs), len(refs), nb)
    al = np.zeros(shape, np.int64)
    es = np.zeros(shape, np.float64)
    ps = np.zeros(shape, np.float64)
    loci = np.zeros(nb, np.int64)
    sizes = np.zeros(nb, np.int64)
    for r in rows:
        b = kidx[(r["chrom"], r["bin"])]
        al[sidx[r["src"]], ridx[r["ref"]], b] = r["alignlen"]
        es[sidx[r["src"]], ridx[r["ref"]], b] = r["escore"]
        ps[sidx[r["src"]], ridx[r["ref"]], b] = r["pscore"]
        loci[b] = r["loci"]
        sizes[b] = r["size"]
    return ScoreBins(srcs, refs, [k[0] for k in keys],
                     np.array([k[1] for k in keys]), loci, sizes, al, es, ps)


def impute_score_bins(sb: ScoreBins) -> None:
    """Imputation pass (ProcessAlleleScoreBins :12040-12110): a bin whose
    size < 10000 or aligned proportion < 0.01 takes the previous
    directly-accepted bin's scores (IMPUTED) else is NOT_ACCEPTED; a
    directly-accepted bin retro-imputes an immediately preceding
    NOT_ACCEPTED bin. Chromosome boundaries reset the chain."""
    S, R, B = sb.escore.shape
    for s in range(S):
        for r in range(R):
            prev = -1
            prev_chrom = None
            for b in range(B):
                if sb.chroms[b] != prev_chrom:
                    prev = -1
                    prev_chrom = sb.chroms[b]
                prop = sb.alignlen[s, r, b] / max(sb.bin_sizes[b], 1)
                if sb.bin_sizes[b] < 10_000 or prop < 0.01:
                    if prev >= 0 and sb.state[s, r, prev] == ACCEPTED:
                        sb.escore[s, r, b] = sb.escore[s, r, prev]
                        sb.pscore[s, r, b] = sb.pscore[s, r, prev]
                        sb.state[s, r, b] = IMPUTED
                    else:
                        sb.state[s, r, b] = NOT_ACCEPTED
                else:
                    sb.state[s, r, b] = ACCEPTED
                    if prev >= 0 and sb.state[s, r, prev] == NOT_ACCEPTED:
                        sb.escore[s, r, prev] = sb.escore[s, r, b]
                        sb.pscore[s, r, prev] = sb.pscore[s, r, b]
                        sb.state[s, r, prev] = IMPUTED
                prev = b


def prune_references(sb: ScoreBins, min_unpruned: int,
                     max_unpruned: int) -> np.ndarray:
    """Noise-reference pruning (:12296-12460, documented intent): per
    source, iteratively count per reference the bins where it is the
    highest PartialScore among unpruned refs (NOT_ACCEPTED bins excluded),
    then prune the lowest-count references while more than max_unpruned
    remain and at least min_unpruned would survive. Returns pruned mask
    [S, R] (True = pruned)."""
    S, R, B = sb.pscore.shape
    min_unpruned = max(1, min(min_unpruned, R))
    max_unpruned = max(min_unpruned, min(max_unpruned, R))
    pruned = np.zeros((S, R), np.bool_)
    for s in range(S):
        while True:
            alive = ~pruned[s]
            n_alive = int(alive.sum())
            if n_alive <= max_unpruned or n_alive <= min_unpruned:
                break
            usable = (sb.state[s] & NOT_ACCEPTED) == 0  # [R, B]
            scores = np.where(usable & alive[:, None], sb.pscore[s], -1.0)
            top = scores.argmax(axis=0)            # [B]
            valid = scores.max(axis=0) >= 0.0
            cnts = np.bincount(top[valid], minlength=R)
            cnts = np.where(alive, cnts, np.iinfo(np.int64).max)
            lo = cnts.min()
            drop = (cnts == lo) & alive
            if n_alive - int(drop.sum()) < min_unpruned:
                break
            pruned[s] |= drop
            if int((~pruned[s]).sum()) <= max_unpruned:
                break
    return pruned


def select_references(sb: ScoreBins, pruned: np.ndarray) -> np.ndarray:
    """Per-bin highest-PartialScore (tie: ExactScore) unpruned reference
    (:12500-12600), then 3-bin outlier correction (:12850-12880): a
    selection differing from identical bracketing selections is flipped.
    Returns sel [S, B] of ref indices, -1 when none."""
    S, R, B = sb.pscore.shape
    sel = np.full((S, B), -1, np.int64)
    for s in range(S):
        alive = ~pruned[s]
        if not alive.any():
            continue
        ps = np.where(alive[:, None], sb.pscore[s], -np.inf)
        es = np.where(alive[:, None], sb.escore[s], -np.inf)
        # lexicographic argmax: pscore then escore
        order = ps + es * 1e-12
        sel[s] = order.argmax(axis=0)
        none = ~np.isfinite(order.max(axis=0))
        sel[s][none] = -1
        # outlier fix per chromosome
        for b in range(1, B - 1):
            if (sb.chroms[b - 1] == sb.chroms[b] == sb.chroms[b + 1]
                    and sel[s, b - 1] == sel[s, b + 1] != sel[s, b]
                    and sel[s, b - 1] >= 0):
                sel[s, b] = sel[s, b - 1]
    return sel


def group_allele_scores(in_csv, out_base, *, min_unpruned: int = 1,
                        max_unpruned: int = 4) -> dict:
    """Mode 9 (GroupAlleleScores + ProcessAlleleScoreBins): impute, write
    imputation CSVs, prune, select, write the grouping matrix. Outputs:
    <out_base>.imputation.csv, <out_base>.imputation.summary.csv,
    <out_base>.csv (per-bin per-ref selected-source counts + GrpMembers:0),
    <out_base>.selected.csv (per-bin selected ref per source)."""
    sb = load_score_bins(in_csv)
    impute_score_bins(sb)
    S, R, B = sb.escore.shape

    # per (src, ref, chrom) imputation proportions
    line = 0
    with open(f"{out_base}.imputation.csv", "w") as f:
        f.write('"SummaryLine","Chrom","Source (GBS)","Reference (WGS)",'
                '"PropAccepted","PropImputed","PropRejected"')
        for s in range(S):
            for r in range(R):
                for chrom in dict.fromkeys(sb.chroms):
                    m = np.array([c == chrom for c in sb.chroms])
                    st = sb.state[s, r, m]
                    tot = max(len(st), 1)
                    line += 1
                    f.write(f'\n{line},"{chrom}","{sb.srcs[s]}",'
                            f'"{sb.refs[r]}",'
                            f'{(st == ACCEPTED).sum() / tot:f},'
                            f'{(st == IMPUTED).sum() / tot:f},'
                            f'{(st == NOT_ACCEPTED).sum() / tot:f}')
    with open(f"{out_base}.imputation.summary.csv", "w") as f:
        f.write('"SummaryLine","Source (GBS)","PropAccepted",'
                '"PropImputed","PropRejected"')
        for s in range(S):
            st = sb.state[s]
            tot = max(st.size, 1)
            f.write(f'\n{s + 1},"{sb.srcs[s]}",'
                    f'{(st == ACCEPTED).sum() / tot:f},'
                    f'{(st == IMPUTED).sum() / tot:f},'
                    f'{(st == NOT_ACCEPTED).sum() / tot:f}')

    pruned = prune_references(sb, min_unpruned, max_unpruned)
    sel = select_references(sb, pruned)

    # grouping matrix: per bin, count of sources selecting each reference
    # (+ GrpMembers:0 = sources with no selection), the reference's main
    # grouping CSV shape (:12642-12718)
    with open(f"{out_base}.csv", "w") as f:
        f.write('"Chrom","BinID","BinLoci","BinSize"')
        for rn in sb.refs:
            f.write(f',"{rn}"')
        f.write(',"GrpMembers:0"')
        for b in range(B):
            cnts = np.bincount(sel[:, b][sel[:, b] >= 0], minlength=R)
            f.write(f'\n"{sb.chroms[b]}",{sb.bin_ids[b]},{sb.bin_loci[b]},'
                    f'{sb.bin_sizes[b]}')
            for r in range(R):
                f.write(f',{cnts[r]}')
            f.write(f',{int((sel[:, b] < 0).sum())}')
        f.write("\n")

    # per-source selected reference matrix (:12780-12830)
    with open(f"{out_base}.selected.csv", "w") as f:
        f.write('"Chrom","BinID","BinLoci","BinSize"')
        for sn in sb.srcs:
            f.write(f',"{sn}"')
        for b in range(B):
            f.write(f'\n"{sb.chroms[b]}",{sb.bin_ids[b]},{sb.bin_loci[b]},'
                    f'{sb.bin_sizes[b]}')
            for s in range(S):
                f.write(f',"{sb.refs[sel[s, b]] if sel[s, b] >= 0 else ""}"')
        f.write("\n")
    return {"srcs": sb.srcs, "refs": sb.refs, "pruned": pruned, "sel": sel,
            "bins": B}
