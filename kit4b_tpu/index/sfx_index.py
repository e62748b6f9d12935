"""Device-resident genome index: suffix array + k-mer bucket LUT.

Capability parity with the reference CSfxArray (libkit4b/SfxArray.h:97-209,
SfxArray.cpp:1758 Finalise / :3309 IterateExacts / :7938 LocateFirstExact),
redesigned for XLA:

- The genome is one concatenated uint8 code array with EOS sentinels between
  chromosomes (same scheme as the reference's concatenated SfxBlock).
- Instead of per-query binary search over the raw suffix array (irregular,
  divergent — hostile to a vector machine), we keep only the "clean" suffixes
  (first `lut_k` bases all ACGT) in lexicographic order and precompute a
  direct-addressed bucket table over all 4^lut_k k-mer prefixes. A seed lookup
  is then two int32 gathers (bucket start + end) — O(1), branchless, batched.
- Seeds longer than `lut_k` are resolved by bucket candidates + full extension
  scoring (the extension kernel rejects non-matching candidates), mirroring the
  reference's cap of `MaxIter` suffix-array entries examined per core
  (ngskit4b/KAligner.h:53-56) with a fixed per-bucket candidate budget.

File format: .kix (NumPy .npz) holding genome seq, chrom directory, clean SA
and LUT — the analog of the reference's .sfx V5 file (SfxArray.h:194-209).
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from .. import dna
from ..io.fasta import Genome
from .sa_build import _load_native, build_suffix_array

KIX_VERSION = 1


def pick_lut_k(genome_len: int) -> int:
    """LUT k-mer width: ~log4(G) like the reference's auto core length
    (ngskit4b/KAligner.cpp:9369-9374), clamped to [8, 13] to bound LUT memory
    at 4^13+1 int32 = 256 MiB worst case."""
    k = 1
    g = genome_len
    while g >= 4:
        g >>= 2
        k += 1
    return max(8, min(13, k))


@dataclass
class SfxIndex:
    genome: Genome
    lut_k: int
    sa_clean: np.ndarray  # int32/int64 [M] clean-suffix positions, lex order
    lut: np.ndarray       # int64 [4^lut_k + 1] bucket starts into sa_clean

    # LUT radix: 4 for plain DNA; 3 with a digit_map for bisulfite-collapsed
    # alphabets (align/bisulfite.py) so direct addressing stays dense
    lut_base: int = 4
    digit_map: tuple | None = None

    @classmethod
    def build(cls, genome: Genome, lut_k: int | None = None,
              lut_base: int = 4,
              digit_map: tuple | None = None) -> "SfxIndex":
        seq = genome.seq
        if lut_k is None:
            lut_k = pick_lut_k(len(seq))
        sa = build_suffix_array(seq)
        # Clean mask: suffix has lut_k in-bounds bases all < BASE_N.
        n = len(seq)
        k = lut_k
        ok = np.ones(n, dtype=bool)
        isbase = seq < dna.BASE_N
        # ok[p] = all(isbase[p:p+k]); compute via cumulative sum of non-base.
        bad = (~isbase).astype(np.int64)
        cbad = np.concatenate([[0], np.cumsum(bad)])
        ok[: n - k + 1] = (cbad[k:] - cbad[:-k]) == 0
        if k > 1:
            ok[n - k + 1:] = False
        sa_clean = sa[ok[sa]]
        # Keys of clean suffixes (non-decreasing in SA order; any digit_map
        # must be monotone in code order so bucket ranges stay contiguous).
        dm = np.arange(4, dtype=np.int64) if digit_map is None \
            else np.asarray(digit_map, dtype=np.int64)
        keys = np.zeros(len(sa_clean), dtype=np.int64)
        for j in range(k):
            keys = keys * lut_base + dm[seq[sa_clean + j]]
        lut = np.searchsorted(
            keys, np.arange(lut_base**k + 1, dtype=np.int64)).astype(np.int64)
        return cls(genome, k, sa_clean.astype(
            np.int32 if n < 2**31 else np.int64), lut,
            lut_base=lut_base, digit_map=digit_map)

    @classmethod
    def build_buckets(cls, genome: Genome,
                      lut_k: int | None = None) -> "SfxIndex":
        """k-mer BUCKET index: clean positions grouped by lut_k-mer key
        in arbitrary in-bucket order — no suffix sorting.

        The seed-and-extend passes only resolve key buckets and verify
        candidates by extension, so full lexicographic suffix order is
        refinement they never read; a stable counting sort by key
        replaces SA-IS at ~10x less build cost. Used by workloads whose
        probes are pure bucket lookups (kmarkers/prekmarkers config #3;
        the reference's LocKMers walks IterateExacts ranges the same
        way, ngskit4b/LocKMers.cpp:525). kalign keeps the SA-IS build:
        its capped tiers pick the FIRST entries of a bucket, and golden
        equivalence fixes that order."""
        seq = genome.seq
        if lut_k is None:
            lut_k = pick_lut_k(len(seq))
        n = len(seq)
        k = lut_k
        if n < k:
            return cls(genome, k, np.zeros(0, np.int32),
                       np.zeros(4 ** k + 1, np.int64))
        m = n - k + 1
        # native counting-sort path: one histogram + one scatter pass,
        # bit-identical output (in-bucket order ascending by position,
        # same as a stable argsort by key), ~7x the numpy path below
        lib = _load_native()
        if lib is not None and hasattr(lib, "bucket_index") \
                and n < 2 ** 31 and k <= 15:
            seq_c = np.ascontiguousarray(seq, dtype=np.uint8)
            sa_buf = np.empty(m, np.int32)
            lut = np.empty(4 ** k + 1, np.int64)
            import ctypes
            ngood = lib.bucket_index(
                seq_c.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                n, k,
                sa_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                lut.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
            if ngood >= 0:
                return cls(genome, k, sa_buf[:ngood].copy(), lut)
        clean = np.where(seq < dna.BASE_N, seq, 0).astype(np.int32)
        keys = clean[:m].copy()
        for j in range(1, k):
            keys *= 4
            keys += clean[j:j + m]
        cb = np.concatenate(
            [[0], np.cumsum((seq >= dna.BASE_N).astype(np.int32))])
        good = (cb[k:] - cb[:-k]) == 0
        pos = np.nonzero(good)[0]
        keys = keys[good]
        order = np.argsort(keys, kind="stable")
        sa_clean = pos[order]
        counts = np.bincount(keys, minlength=4 ** k)
        lut = np.zeros(4 ** k + 1, np.int64)
        np.cumsum(counts, out=lut[1:])
        return cls(genome, k, sa_clean.astype(
            np.int32 if n < 2**31 else np.int64), lut)

    # --- persistence (.kix) -------------------------------------------------
    def save(self, path: str | os.PathLike) -> None:
        np.savez_compressed(
            path if str(path).endswith(".npz") else str(path),
            version=np.int64(KIX_VERSION),
            lut_k=np.int64(self.lut_k),
            seq=self.genome.seq,
            chrom_names=np.array(self.genome.names, dtype=object),
            chrom_starts=self.genome.starts,
            chrom_lengths=self.genome.lengths,
            sa_clean=self.sa_clean,
            lut=self.lut,
            allow_pickle=True)

    @classmethod
    def load(cls, path: str | os.PathLike) -> "SfxIndex":
        path = str(path)
        if not os.path.exists(path) and os.path.exists(path + ".npz"):
            path = path + ".npz"
        z = np.load(path, allow_pickle=True)
        if int(z["version"]) != KIX_VERSION:
            raise ValueError(f"unsupported .kix version {int(z['version'])}")
        g = Genome(list(z["chrom_names"]), z["chrom_starts"],
                   z["chrom_lengths"], z["seq"])
        return cls(g, int(z["lut_k"]), z["sa_clean"], z["lut"])

    # --- device view --------------------------------------------------------
    def device_arrays(self, max_read_len: int = 1024,
                      pad_quantum: int = 0):
        """Returns (gpack, gbad, sa, lut) jax arrays for the align path.

        gpack/gbad are the 2-bit packed genome + invalid-base mask
        (ops/extend_packed.py); the raw byte genome stays host-side.
        With pad_quantum > 0, arrays pad up to that multiple so same-scale
        genomes share jit-compiled executables (off by default: the remote
        compiler in this environment is slow enough that reusing existing
        cache entries wins over cross-genome shape sharing).
        """
        import jax.numpy as jnp
        from ..ops.extend_packed import pack_genome
        nw = (max_read_len + 30) // 16
        gpack, gbad = pack_genome(self.genome.seq, nw)

        def pad_to(arr, fill=0):
            if not pad_quantum:
                return arr
            n = len(arr)
            target = -(-max(n, 1) // pad_quantum) * pad_quantum
            if target == n:
                return arr
            out = np.full(target, fill, dtype=arr.dtype)
            out[:n] = arr
            return out

        # padded gbad marks every slot invalid -> padded windows can never
        # score as matches; padded sa entries are unreachable via the LUT
        gpack = pad_to(gpack)
        gbad = pad_to(gbad, fill=np.uint32(0xFFFFFFFF))
        sa = pad_to(self.sa_clean)
        lut = (jnp.asarray(self.lut, dtype=jnp.int32)
               if self.lut[-1] < 2**31 else jnp.asarray(self.lut))
        return (jnp.asarray(gpack), jnp.asarray(gbad),
                jnp.asarray(sa), lut)
