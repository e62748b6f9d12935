"""alignsbs: alignment bootstrapper.

Capability parity with `ngskit4b alignsbs` (ngskit4b/AlignsBootstrap.cpp
CAlignsBootstrap): derive the length distribution of an initial query
(and target) sequence set, then for each bootstrap iteration sample
same-length sequences from a query assembly and a target assembly,
align queries onto targets allowing maxsubs substitutions per 100bp,
and report per-iteration counts of queries hitting >=1 target and
targets hit by >=1 query. Iteration 0 is the original query set vs the
original target set.

Device redesign: the reference re-aligns every iteration's query set
against every iteration's target set with host threads. Here the target
*assembly* is indexed once and every iteration's sampled queries are
aligned in one stream of fixed-shape device batches (one compile, full
batches); whether a query "hit a target" is then a host-side
interval-membership test of its accepted locus against that iteration's
sampled target fragments — alignment work is O(total queries), not
O(iterations x re-index).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..io.fasta import Genome, SeqRecord


@dataclass
class BootstrapResult:
    iteration: int          # 0 = original sets
    n_queries: int
    query_hits: int         # queries aligned into >=1 sampled target
    n_targets: int
    targets_hit: int        # sampled targets covered by >=1 query


def sample_fragments(genome: Genome, lengths: np.ndarray,
                     rng: np.random.Generator) -> list[tuple[int, int]]:
    """Sample (concat_start, len) fragments from the assembly with the
    given length distribution, loci uniform over chroms scaled by
    length and never crossing a chrom boundary (CSimReads-style)."""
    starts = np.asarray(genome.starts, np.int64)
    lens = np.asarray(genome.lengths, np.int64)
    probs = lens / lens.sum()
    out = []
    longest = int(np.argmax(lens))
    for ln in lengths:
        ln = int(ln)
        for _ in range(64):
            ci = rng.choice(len(lens), p=probs)
            if lens[ci] < ln:
                continue
            # ofs=0 allowed when the chrom exactly fits the fragment
            ofs = int(rng.integers(0, lens[ci] - ln + 1))
            out.append((int(starts[ci]) + ofs, ln))
            break
        else:
            # keep set sizes fixed: fall back to the longest chrom
            # (clamped) so every sampled length yields a fragment
            ln2 = min(ln, int(lens[longest]))
            ofs = int(rng.integers(0, lens[longest] - ln2 + 1))
            out.append((int(starts[longest]) + ofs, ln2))
    return out


def _align_starts(index, frags: list, genome: Genome, aligner,
                  sense_only: bool = False) -> np.ndarray:
    """Align fragments (from `genome`) via the target index; returns the
    accepted concat-genome start per fragment, -1 when unaligned."""
    recs = [SeqRecord(f"b{i}", "", genome.seq[s:s + ln])
            for i, (s, ln) in enumerate(frags)]
    starts = np.full(len(recs), -1, np.int64)
    for rec, res in aligner.align_records(iter(recs)):
        if res.nar == "accepted" and not (sense_only and res.strand):
            starts[int(rec.name[1:])] = res.pos  # concat-genome coords
    return starts


def bootstrap_align(query_seqs: list, query_assembly: Genome,
                    target_seqs: list, target_assembly: Genome,
                    *, n_bootstraps: int = 100, max_subs: int = 0,
                    seed: int = 0, batch_size: int = 4096,
                    sense_only: bool = False) -> list[BootstrapResult]:
    """Run the bootstrap. query_seqs/target_seqs: initial SeqRecords
    providing length distributions (iteration 0 uses them directly)."""
    from ..index.sfx_index import SfxIndex
    from .kalign import KAligner

    rng = np.random.default_rng(seed or None)
    q_lens = np.array([len(r.codes) for r in query_seqs], np.int64)
    t_lens = np.array([len(r.codes) for r in target_seqs], np.int64)

    index = SfxIndex.build(target_assembly)
    al = KAligner(index, max_subs=max_subs, max_ns=1,
                  batch_size=batch_size)

    results = []
    # iteration 0: the original query seqs vs original target fragments.
    # Original targets are located in the assembly by exact search of
    # their first bases; targets not from the assembly fall back to
    # whole-assembly acceptance.
    t_concat = target_assembly.seq
    orig_t: list[tuple[int, int]] = []
    for r in target_seqs:
        ln = len(r.codes)
        pos = _find_subseq(t_concat, r.codes[:min(ln, 64)])
        if pos >= 0:
            orig_t.append((pos, ln))
    q_recs = list(query_seqs)
    by_name = {r.name: i for i, r in enumerate(q_recs)}
    starts = np.full(len(q_recs), -1, np.int64)
    for rec, res in al.align_records(iter(q_recs)):
        if res.nar == "accepted" and not (sense_only and res.strand):
            starts[by_name[rec.name]] = res.pos
    results.append(_score_iteration(0, starts, q_lens, orig_t))

    for it in range(1, n_bootstraps + 1):
        q_frags = sample_fragments(query_assembly, q_lens, rng)
        t_frags = sample_fragments(target_assembly, t_lens, rng)
        starts = _align_starts(index, q_frags, query_assembly, al,
                               sense_only)
        results.append(_score_iteration(
            it, starts, np.array([ln for _, ln in q_frags]), t_frags))
    return results


def _find_subseq(hay: np.ndarray, needle: np.ndarray) -> int:
    if len(needle) == 0 or len(hay) < len(needle):
        return -1
    cand = np.nonzero(hay[:len(hay) - len(needle) + 1] == needle[0])[0]
    for c in cand[:100000]:
        if np.array_equal(hay[c:c + len(needle)], needle):
            return int(c)
    return -1


def _score_iteration(it: int, starts: np.ndarray, q_lens: np.ndarray,
                     t_frags: list) -> BootstrapResult:
    if not t_frags:
        return BootstrapResult(it, len(starts), 0, 0, 0)
    t_beg = np.array([s for s, _ in t_frags], np.int64)
    t_end = np.array([s + ln for s, ln in t_frags], np.int64)
    order = np.argsort(t_beg)
    t_beg, t_end = t_beg[order], t_end[order]
    q_hit = 0
    hit_targets: set[int] = set()
    for s, ln in zip(starts, q_lens):
        if s < 0:
            continue
        e = s + int(ln)
        # overlapping targets: any fragment with beg < e and end > s
        j = np.searchsorted(t_beg, e)
        hits = np.nonzero(t_end[:j] > s)[0]
        if len(hits):
            q_hit += 1
            hit_targets.update(int(h) for h in hits)
    return BootstrapResult(it, len(starts), q_hit, len(t_frags),
                           len(hit_targets))


def write_bootstrap_csv(q_path, t_path, results: list) -> None:
    with open(q_path, "w") as f:
        f.write('"Iteration","Queries","QueriesHitting"\n')
        for r in results:
            f.write(f"{r.iteration},{r.n_queries},{r.query_hits}\n")
    with open(t_path, "w") as f:
        f.write('"Iteration","Targets","TargetsHit"\n')
        for r in results:
            f.write(f"{r.iteration},{r.n_targets},{r.targets_hit}\n")
