"""Bisulfite alignment mode (reference kalign -b + index -m1 bisulfite).

The reference collapses BOTH conversions into one suffix array (T->C and
A->G simultaneously, libkit4b/SfxArray.cpp:511-535), leaving a 2-symbol
alphabet whose k-mer buckets are enormous. This redesign uses the
standard two-index scheme instead (as Bismark/BWA-meth do):

  watson-origin reads:  read C->T collapsed  vs  genome C->T collapsed
  crick-origin reads :  revcomp(read) G->A   vs  genome G->A collapsed

Each direction is a plus-strand-only fast pass over its own collapsed
LUT/SA; candidates are concatenated (disjoint by strand bit) and finalized
together, so n_low / next-best semantics span both directions exactly as
the reference's joint search does. Mismatch counts are over the collapsed
alphabet, i.e. C/T (resp. G/A) differences are free, matching bisulfite
chemistry.
"""
from __future__ import annotations

import functools
import os

import numpy as np

from .. import dna
from ..index.sfx_index import SfxIndex
from ..io.fasta import Genome


def collapse_ct(codes: np.ndarray) -> np.ndarray:
    """C -> T (code 1 -> 3); sentinels/N unchanged."""
    out = np.asarray(codes).copy()
    out[out == 1] = 3
    return out


def collapse_ga(codes: np.ndarray) -> np.ndarray:
    """G -> A (code 2 -> 0); sentinels/N unchanged."""
    out = np.asarray(codes).copy()
    out[out == 2] = 0
    return out


class BsIndex:
    """Two collapsed-genome indexes + the original genome.

    Saved as .kbx (npz bundle of the two .kix payloads)."""

    def __init__(self, genome: Genome, idx_ct: SfxIndex, idx_ga: SfxIndex):
        self.genome = genome
        self.ct = idx_ct
        self.ga = idx_ga
        self.lut_k = idx_ct.lut_k

    # monotone code->digit maps for the two collapsed alphabets
    DMAP_CT = (0, 0, 1, 2)   # {A,G,T} after C->T; C never occurs
    DMAP_GA = (0, 1, 1, 2)   # {A,C,T} after G->A; G never occurs

    @classmethod
    def build(cls, genome: Genome, lut_k: int | None = None) -> "BsIndex":
        from ..index.sfx_index import pick_lut_k
        if lut_k is None:
            # 3-symbol alphabet: grow k so 3^k matches 4^k4 bucket load
            import math
            lut_k = min(16, math.ceil(pick_lut_k(len(genome.seq))
                                      * math.log(4) / math.log(3)))
        g_ct = Genome(genome.names, genome.starts, genome.lengths,
                      collapse_ct(genome.seq))
        g_ga = Genome(genome.names, genome.starts, genome.lengths,
                      collapse_ga(genome.seq))
        return cls(genome,
                   SfxIndex.build(g_ct, lut_k, lut_base=3,
                                  digit_map=cls.DMAP_CT),
                   SfxIndex.build(g_ga, lut_k, lut_base=3,
                                  digit_map=cls.DMAP_GA))

    def save(self, path) -> None:
        np.savez_compressed(
            path, version=np.int64(1), lut_k=np.int64(self.lut_k),
            seq=self.genome.seq,
            chrom_names=np.array(self.genome.names, dtype=object),
            chrom_starts=self.genome.starts,
            chrom_lengths=self.genome.lengths,
            sa_ct=self.ct.sa_clean, lut_ct=self.ct.lut,
            sa_ga=self.ga.sa_clean, lut_ga=self.ga.lut,
            allow_pickle=True)

    @classmethod
    def load(cls, path) -> "BsIndex":
        path = str(path)
        if not os.path.exists(path) and os.path.exists(path + ".npz"):
            path = path + ".npz"
        z = np.load(path, allow_pickle=True)
        g = Genome(list(z["chrom_names"]), z["chrom_starts"],
                   z["chrom_lengths"], z["seq"])
        k = int(z["lut_k"])
        g_ct = Genome(g.names, g.starts, g.lengths, collapse_ct(g.seq))
        g_ga = Genome(g.names, g.starts, g.lengths, collapse_ga(g.seq))
        return cls(g, SfxIndex(g_ct, k, z["sa_ct"], z["lut_ct"],
                               lut_base=3, digit_map=cls.DMAP_CT),
                   SfxIndex(g_ga, k, z["sa_ga"], z["lut_ga"],
                            lut_base=3, digit_map=cls.DMAP_GA))


@functools.partial(
    __import__("jax").jit,
    static_argnames=("genome_len", "offsets", "lut_k", "n_compact",
                     "max_tot_mm", "mm_delta"))
def bs_pass_compact(gview_ct, sa_ct, lut_ct, gview_ga, sa_ga, lut_ga,
                    reads_ct, reads_garc, *, genome_len: int, offsets: tuple,
                    lut_k: int, n_compact: int, max_tot_mm: int,
                    mm_delta: int):
    """Both bisulfite directions in one executable; compact [B,3] result
    (same contract as seed_extend_fast.fast_pass_compact)."""
    import jax.numpy as jnp

    from ..ops import seed_extend_fast as F
    kw = dict(genome_len=genome_len, offsets=offsets, lut_k=lut_k,
              n_compact=n_compact, lut_base=3)
    ids_w, mm_w, ovf_w = F.fast_candidates(
        gview_ct, sa_ct, lut_ct, jnp.int32(0), reads_ct,
        single_strand=0, digit_map=BsIndex.DMAP_CT, **kw)
    ids_c, mm_c, ovf_c = F.fast_candidates(
        gview_ga, sa_ga, lut_ga, jnp.int32(0), reads_garc,
        single_strand=1, digit_map=BsIndex.DMAP_GA, **kw)
    ids = jnp.concatenate([ids_w, ids_c], axis=1)
    mm = jnp.concatenate([mm_w, mm_c], axis=1)
    overflow = ovf_w | ovf_c
    ok = ids != F.INT32_MAX
    low = jnp.min(mm, axis=1)
    n_low = jnp.sum((mm == low[:, None]) & ok, axis=1, dtype=jnp.int32)
    nxt = jnp.min(jnp.where(mm > low[:, None], mm, F.INT32_MAX), axis=1)
    best = jnp.min(jnp.where(mm == low[:, None], ids, F.INT32_MAX), axis=1)
    aligned = low <= max_tot_mm
    unique = (aligned & ~overflow & (n_low == 1)
              & ((nxt - low) >= mm_delta))
    code = jnp.where(overflow, -3,
                     jnp.where(unique, best,
                               jnp.where(aligned, -2, -1)))
    return jnp.stack([code, low, n_low], axis=1)


class BsAligner:
    """SE bisulfite aligner over a BsIndex (kalign -b capability)."""

    def __init__(self, index: BsIndex, *, max_subs: int = 5,
                 mm_delta: int = 1, max_ns: int = 1,
                 n_compact: int = 24, batch_size: int = 16384):
        self.index = index
        self.max_subs = max_subs
        self.mm_delta = mm_delta
        self.max_ns = max_ns
        self.n_compact = n_compact
        self.batch_size = batch_size
        self._dev = None

    def _device(self, read_len: int):
        import jax.numpy as jnp

        from ..ops import seed_extend_fast as F
        from ..ops.extend_packed import pack_genome
        if self._dev is None:
            nw2 = (read_len + 15) // 16 + 1
            dv = []
            for idx in (self.index.ct, self.index.ga):
                gp, gb = pack_genome(idx.genome.seq, 65)
                dv.append((jnp.asarray(F.make_gview(gp, gb, nw2)),
                           jnp.asarray(idx.sa_clean.astype(np.int32)),
                           jnp.asarray(idx.lut.astype(np.int32))))
            self._dev = tuple(dv)
        return self._dev

    def align_batch_raw(self, reads: np.ndarray) -> dict:
        import jax

        from ..ops import seed_extend_fast as F
        from .kalign import build_pass_schedule
        B, L = reads.shape
        _, max_tot = build_pass_schedule(
            L, self.max_subs, self.mm_delta, len(self.index.genome.seq))
        offsets = F.fast_offsets(L, self.index.lut_k,
                                 max_tot + max(self.mm_delta - 1, 0))
        (gv_ct, sa_ct, lut_ct), (gv_ga, sa_ga, lut_ga) = self._device(L)
        reads_ct = collapse_ct(reads)
        reads_garc = collapse_ga(dna.revcomp(reads.T).T
                                 if reads.ndim == 1 else
                                 np.stack([dna.revcomp(r) for r in reads]))
        out = np.array(jax.device_get(bs_pass_compact(
            gv_ct, sa_ct, lut_ct, gv_ga, sa_ga, lut_ga,
            reads_ct, reads_garc,
            genome_len=len(self.index.genome.seq), offsets=offsets,
            lut_k=self.index.lut_k, n_compact=self.n_compact,
            max_tot_mm=max_tot, mm_delta=self.mm_delta)))
        code = out[:, 0].astype(np.int64)
        low = out[:, 1].astype(np.int64)
        n_low = out[:, 2].astype(np.int64)
        max_ns_seq = max(L * self.max_ns // 100, self.max_ns)
        ns_bad = (reads == dna.BASE_N).sum(axis=1) > max_ns_seq
        nar = np.where(ns_bad, 3,
                       np.where(code >= 0, 0,
                                np.where(code == -1, 1, 2))).astype(np.uint8)
        return {"nar": nar, "pos": np.where(code >= 0, code >> 1, -1),
                "strand": np.where(code >= 0, code & 1, 0),
                "mm": low, "n_low": n_low, "max_tot_mm": max_tot}
