"""hammings: genome-wide minimum K-mer Hamming distances.

Capability parity with the reference's exhaustive mode
(ngskit4b/hammings.cpp:3183 GHamDistWatson / GHamDistCrick,
ThreadedGHamDist:883): for every K-mer position p, the minimum Hamming
distance to any *other* K-mer in the genome (sense) and to any reverse
complement K-mer (antisense).

The default engine is the min-matmul formulation (hammings_mxu.py). The
legacy sweep kept here follows the reference: it decomposes the O(G^2)
all-pairs sweep into independent O(G) passes, one per relative cursor
offset; each pass is a fixed-shape vector computation (shifted compare -> windowed sum via
cumulative sums -> masked min), driven by lax.fori_loop on device. Crick
passes reduce to Watson passes against the reverse-complemented genome (the
anti-diagonal sweep hammings.cpp:3289 becomes a fixed offset after reversing
one cursor's coordinate system).

Multi-node static partitioning (-n numnodes -N node, hammings.cpp:99-106) is
preserved as offset-range partitioning; `merge` is an elementwise min.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .. import dna

BIG = np.uint16(0xFFFF)


@functools.partial(jax.jit, static_argnames=("K",), donate_argnums=(2,))
def _sweep_range(g: jnp.ndarray, partner: jnp.ndarray, hmin: jnp.ndarray,
                 d_start, d_end, *, K: int) -> jnp.ndarray:
    """Fused on-device sweep: for every offset d in [d_start, d_end), compare
    g-windows at i against partner-windows at i+d (d may be negative; rolls
    wrap and bounds masks reject). Window sums use 5+5 shifted adds —
    elementwise slices that XLA fuses into one pass per offset, unlike the
    cumsum formulation. One compile covers any offset range (traced bounds).

    g/partner: uint8 codes. Sentinels (>= BASE_UNDEF) add a +32 penalty so
    sentinel-spanning windows fail the ws < 32 validity cut. hmin: int16.
    """
    G = g.shape[0]
    idx = jnp.arange(G, dtype=jnp.int32)
    gpen = (g >= 5).astype(jnp.int16) * 32
    BIG16 = jnp.int16(9999)

    def body(d, hmin):
        p = jnp.roll(partner, -d)
        ppen = jnp.roll((partner >= 5).astype(jnp.int16) * 32, -d)
        dvp = (g != p).astype(jnp.int16) + jnp.maximum(gpen, ppen)
        q, r = divmod(K, 5)
        ws = jnp.zeros((G,), jnp.int16)
        if q:
            s5 = dvp
            s5 = (dvp + jnp.roll(dvp, -1) + jnp.roll(dvp, -2)
                  + jnp.roll(dvp, -3) + jnp.roll(dvp, -4))
            for m in range(q):
                ws = ws + jnp.roll(s5, -5 * m)
        for j in range(5 * q, K):
            ws = ws + jnp.roll(dvp, -j)
        ok = ((idx + K <= G) & (idx + d >= 0) & (idx + d + K <= G)
              & (ws < 32))
        return jnp.minimum(hmin, jnp.where(ok, ws, BIG16))

    return jax.lax.fori_loop(d_start, d_end, body, hmin)


def hammings_exhaustive(genome_seq: np.ndarray, K: int,
                        *, antisense: bool = True,
                        node: int = 0, numnodes: int = 1,
                        progress_every: int = 0,
                        legacy_sweep: bool = False,
                        chunk: int = 1 << 14) -> np.ndarray:
    """Minimum Hamming distance per K-mer start position (uint16, 0xFFFF
    where no valid K-mer).

    Default engine: the min-matmul formulation (hammings_mxu.py) — all
    window pairs as one-hot int8 matrix products with a running max-match.
    Node partitioning splits partner-span ranges; merge partials with
    np.minimum (ePMmerge).

    legacy_sweep=True keeps the original per-offset rolling formulation
    (offset chunks round-robined over nodes) for cross-checking."""
    G = len(genome_seq)
    if G < K:
        return np.full(0, BIG, np.uint16)
    if not legacy_sweep:
        from .hammings_mxu import hammings_exhaustive_mxu
        return hammings_exhaustive_mxu(np.asarray(genome_seq), K,
                                       antisense=antisense, node=node,
                                       numnodes=numnodes)
    g = jnp.asarray(np.ascontiguousarray(genome_seq, np.uint8))
    rc_np = np.where(genome_seq[::-1] < 4, 3 - genome_seq[::-1],
                     genome_seq[::-1]).astype(np.uint8)
    rc = jnp.asarray(rc_np)
    hmin = jnp.full((G,), jnp.int16(9999), dtype=jnp.int16)

    # offset ranges: sense skips d=0 (self), antisense includes it
    spans = []
    lo, hi = -(G - K), G - K
    for a in range(lo, hi + 1, chunk):
        b = min(a + chunk, hi + 1)
        spans.append(("sense", a, b))
        if antisense:
            spans.append(("anti", a, b))
    my = spans[node::numnodes]
    for i, (kind, a, b) in enumerate(my):
        partner = g if kind == "sense" else rc
        if kind == "sense" and a <= 0 < b:
            hmin = _sweep_range(g, partner, hmin, a, 0, K=K)
            hmin = _sweep_range(g, partner, hmin, 1, b, K=K)
        else:
            hmin = _sweep_range(g, partner, hmin, a, b, K=K)
        if progress_every and (i + 1) % progress_every == 0:
            print(f"hammings: chunk {i+1}/{len(my)}")
    out = np.array(jax.device_get(hmin)).astype(np.int32)
    out = np.where(out >= 9999, 0xFFFF, out).astype(np.uint16)
    out[max(0, G - K + 1):] = BIG
    return out


def hammings_restricted(index, K: int, *, max_hamming: int = 3,
                        batch: int = 16384, antisense: bool = True,
                        n_compact: int = 64) -> np.ndarray:
    """Restricted-mode hammings (ngskit4b hammings ePMrestrict;
    CSfxArray::LocateSfxHammings SfxArray.cpp:4107): per K-mer position,
    the minimum Hamming distance up to `max_hamming` (values above
    report max_hamming + 1), found by pigeonhole suffix-array probes.

    Core scheduling follows the reference\'s core-length-by-SA-search
    compromise (hammings.cpp:399): W = min(max_hamming+1, K//lut_k)
    disjoint seed windows guarantee discovery of every hit with
    mm <= W-1; when K is too short for max_hamming+1 full-width cores,
    hits in (W-1, max_hamming] are found best-effort exactly as the
    reference\'s shortened cores are.

    K-mers containing 1..4 indeterminate bases enumerate all canonical
    substitutions and take the minimum over variants; >4 Ns score 0
    (SfxArray.cpp:4152-4177).

    `index`: SfxIndex over the genome. Returns uint16 [G]."""
    import jax
    import jax.numpy as jnp

    from ..ops import seed_extend_fast as F
    from .kmarkers import _fast_device_arrays

    g = index.genome
    G = len(g.seq)
    nk = G - K + 1
    out = np.full(G, BIG, np.uint16)
    if nk <= 0:
        return out
    gview_d, sa_d, lut_d = _fast_device_arrays(index, K)
    W = min(max_hamming + 1, max(1, K // index.lut_k))
    cl = K // W
    offsets = tuple(min(j * cl, K - index.lut_k) for j in range(W))
    INT32_MAX = np.iinfo(np.int32).max

    def run_batches(positions, reads_of, fold_min):
        """positions int64 [N]; reads_of(chunk)->[nb,K] uint8;
        fold_min(chunk, best_mm) folds per-query minima into out."""
        pending = []

        def submit(s):
            chunk = positions[s:s + batch]
            nb = len(chunk)
            reads = reads_of(chunk)
            if nb < batch:
                reads = np.concatenate(
                    [reads, np.repeat(reads[:1], batch - nb, axis=0)])
            return chunk, nb, F.fast_pass(
                gview_d, sa_d, lut_d, jnp.asarray(reads),
                genome_len=G, offsets=offsets, lut_k=index.lut_k,
                n_compact=n_compact, max_ml=8,
                max_per_bucket=max(1, n_compact // (2 * W)))

        def drain(chunk, nb, dev):
            host = {k: np.asarray(v)
                    for k, v in jax.device_get(dev).items()}
            hid = host["hit_id"][:nb]
            hmm = host["hit_mm"][:nb].astype(np.int64)
            valid = hid != INT32_MAX
            pos = np.where(valid, hid >> 1, -1)
            strand = np.where(valid, hid & 1, 0)
            use = valid & (hmm <= max_hamming)
            # exclude the query\'s own sense locus
            use &= ~((strand == 0) & (pos == chunk[:, None]))
            if not antisense:
                use &= strand == 0
            mm = np.where(use, hmm, max_hamming + 1)
            fold_min(chunk, mm.min(axis=1))

        for s in range(0, len(positions), batch):
            pending.append(submit(s))
            if len(pending) >= 2:
                drain(*pending.pop(0))
        for item in pending:
            drain(*item)

    # classify windows by N content (vectorized)
    isn = (g.seq >= 4).astype(np.int64)
    cn = np.concatenate([[0], np.cumsum(isn)])
    n_in_win = cn[K:nk + K] - cn[:nk]
    clean_pos = np.nonzero(n_in_win == 0)[0].astype(np.int64)
    some_n = np.nonzero((n_in_win >= 1) & (n_in_win <= 4))[0]
    many_n = np.nonzero(n_in_win > 4)[0]

    def fold_direct(chunk, best):
        out[chunk] = np.minimum(out[chunk],
                                best.astype(np.uint16))

    if len(clean_pos):
        run_batches(clean_pos,
                    lambda c: g.seq[c[:, None] + np.arange(K)],
                    fold_direct)

    # N-containing windows: enumerate 4^n canonical substitutions
    # (SfxArray.cpp:4152-4177); each variant is one query, minima fold
    # back to the source position
    if len(some_n):
        var_pos = []
        var_reads = []
        for p0 in some_n:
            win = np.array(g.seq[p0:p0 + K])
            nidx = np.nonzero(win >= 4)[0]
            n = len(nidx)
            for it in range(4 ** n):
                v = win.copy()
                for d, ix in enumerate(nidx):
                    v[ix] = (it >> (2 * d)) & 3
                var_pos.append(p0)
                var_reads.append(v)
        var_pos = np.asarray(var_pos, np.int64)
        var_reads = np.stack(var_reads)

        def fold_variant(chunk, best):
            np.minimum.at(out, chunk, best.astype(np.uint16))

        # reads_of indexes into the variant table by positional slice
        cursor = {"i": 0}

        def reads_of(chunk):
            i = cursor["i"]
            cursor["i"] = i + len(chunk)
            return var_reads[i:i + len(chunk)]

        run_batches(np.arange(len(var_pos), dtype=np.int64), reads_of,
                    lambda c, b: fold_variant(var_pos[c], b))

    # >4 indeterminates: treated as Hamming 0 from anything (reference)
    out[many_n] = 0
    out[max(0, nk):] = BIG
    return out


def hammings_oracle(genome_seq: np.ndarray, K: int,
                    antisense: bool = True, positions=None) -> np.ndarray:
    """Plain NumPy oracle: every window compared base by base with every
    other window (and every reverse-complement window). positions: only
    these window starts are computed; the others stay 0xFFFF."""
    g = np.asarray(genome_seq)
    G = len(g)
    sent = g >= dna.BASE_UNDEF  # UNDEF/INDEL/EOS/EOG all invalidate windows
    nk = G - K + 1
    if nk <= 0:
        return np.zeros(0, np.uint16)
    wins = np.lib.stride_tricks.sliding_window_view(g, K)
    valid = ~np.lib.stride_tricks.sliding_window_view(sent, K).any(axis=1)
    out = np.full(G, BIG, np.uint16)
    rev = wins[:, ::-1]
    rc_wins = np.where(rev < 4, 3 - rev, rev)  # N and sentinels unchanged
    vw = np.ascontiguousarray(wins[valid])
    vrc = np.ascontiguousarray(rc_wins[valid])
    vidx = np.nonzero(valid)[0]
    for n, i in enumerate(vidx):
        if positions is not None and i not in positions:
            continue
        d = (vw != vw[n]).sum(axis=1)
        d[n] = BIG                  # the window itself
        best = int(d.min()) if len(d) else int(BIG)
        if antisense:
            best = min(best, int((vrc != vw[n]).sum(axis=1).min()))
        out[i] = best
    return out


def merge(*partials: np.ndarray) -> np.ndarray:
    """ePMmerge equivalent: elementwise min over per-node results."""
    out = partials[0].copy()
    for p in partials[1:]:
        if len(p) != len(out):
            raise ValueError("hammings merge: dimension mismatch")
        np.minimum(out, p, out=out)
    return out


def write_csv(path, genome, hmin: np.ndarray, K: int) -> None:
    """Per-position CSV (chrom, offset, Hamming) like the reference's
    trans-to-CSV mode (hammings.cpp:105)."""
    names, dists = split_by_chrom(genome, hmin, K)
    write_csv_dists(path, names, dists)


def split_by_chrom(genome, hmin: np.ndarray, K: int):
    """Flat concatenated-genome hmin -> (names, per-chrom uint16 arrays of
    NumEls = chrom_len - K + 1)."""
    names, dists = [], []
    for ci, name in enumerate(genome.names):
        s = int(genome.starts[ci])
        ln = int(genome.lengths[ci])
        n_els = max(0, ln - K + 1)
        names.append(name)
        dists.append(np.asarray(hmin[s:s + n_els], np.uint16))
    return names, dists


def write_csv_dists(path, names, dists) -> None:
    with open(path, "w") as f:
        f.write("\"chrom\",\"offset\",\"Hamming\"\n")
        for name, d in zip(names, dists):
            for off in range(len(d)):
                if d[off] == BIG:
                    continue
                f.write(f"\"{name}\",{off},{int(d[off])}\n")


def read_csv_dists(path):
    """Inverse of write_csv_dists -> (names, per-chrom uint16 arrays);
    offsets absent from the CSV read back as the BIG sentinel."""
    per: dict[str, dict[int, int]] = {}
    order: list[str] = []
    with open(path) as f:
        head = f.readline()
        for line in f:
            c = line.rstrip("\n").split(",")
            if len(c) < 3:
                continue
            name = c[0].strip('"')
            if name not in per:
                per[name] = {}
                order.append(name)
            per[name][int(c[1])] = int(c[2])
    names, dists = [], []
    for name in order:
        d = per[name]
        arr = np.full(max(d) + 1 if d else 0, BIG, np.uint16)
        for off, v in d.items():
            arr[off] = v
        names.append(name)
        dists.append(arr)
    return names, dists


# --- reference .hmg binary interop (ngskit4b/hammings.cpp:78-94) ---------
_HMG_MAGIC = b"bham"
_HMG_MAX_CHROMS = 1000           # cMaxHHammingChroms
_HMG_NAME_LEN = 81               # cMaxDatasetSpeciesChrom
_HMG_HDR_LEN = 4 + 4 + 4 + 2 + 4 * _HMG_MAX_CHROMS
_HMG_CHROM_FIXED = 4 + _HMG_NAME_LEN + 4


def write_hmg(path, names, dists) -> None:
    """Reference quick-load binary Hamming file (tsHHamHdr/tsHHamChrom,
    ngskit4b/hammings.cpp:78-94, packed layout, Version 1) — byte
    interoperable with the reference's ePMtrans/ePMmerge modes."""
    import struct
    if len(names) > _HMG_MAX_CHROMS:
        raise ValueError(f"hmg holds at most {_HMG_MAX_CHROMS} chroms")
    chrom_blobs = []
    for cid, (name, d) in enumerate(zip(names, dists), start=1):
        nm = name.encode()[:_HMG_NAME_LEN - 1]
        nm = nm + b"\0" * (_HMG_NAME_LEN - len(nm))
        d = np.asarray(d, np.uint16)
        chrom_blobs.append(struct.pack("<I", cid) + nm
                           + struct.pack("<I", len(d))
                           + d.astype("<u2").tobytes())
    ofs = []
    cur = _HMG_HDR_LEN
    for b in chrom_blobs:
        ofs.append(cur)
        cur += len(b)
    hdr = (_HMG_MAGIC + struct.pack("<I", 1) + struct.pack("<i", cur)
           + struct.pack("<H", len(names))
           + struct.pack(f"<{_HMG_MAX_CHROMS}I",
                         *(ofs + [0] * (_HMG_MAX_CHROMS - len(ofs)))))
    assert len(hdr) == _HMG_HDR_LEN
    with open(path, "wb") as f:
        f.write(hdr)
        for b in chrom_blobs:
            f.write(b)


def read_hmg(path):
    """Inverse of write_hmg -> (names, per-chrom uint16 arrays)."""
    import struct
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:4] != _HMG_MAGIC:
        raise ValueError(f"{path}: not a .hmg Hamming file")
    n_chroms = struct.unpack_from("<H", raw, 12)[0]
    ofs = struct.unpack_from(f"<{_HMG_MAX_CHROMS}I", raw, 14)
    names, dists = [], []
    for i in range(n_chroms):
        o = ofs[i]
        name = raw[o + 4:o + 4 + _HMG_NAME_LEN].split(b"\0")[0].decode()
        n_els = struct.unpack_from("<I", raw, o + 4 + _HMG_NAME_LEN)[0]
        d = np.frombuffer(raw, "<u2", n_els, o + _HMG_CHROM_FIXED)
        names.append(name)
        dists.append(d.astype(np.uint16))
    return names, dists


def load_dists(path):
    """(names, dists) from .hmg binary, .csv, or .npy flat array."""
    p = str(path)
    if p.endswith(".csv"):
        return read_csv_dists(p)
    with open(p, "rb") as f:
        magic = f.read(4)
    if magic == _HMG_MAGIC:
        return read_hmg(p)
    arr = np.load(p)
    return None, [np.asarray(arr, np.uint16)]   # flat single-chunk


def save_dists(path, names, dists) -> None:
    p = str(path)
    if p.endswith(".csv"):
        write_csv_dists(p, names, dists)
    elif p.endswith(".npy"):
        np.save(p, np.concatenate([np.asarray(d, np.uint16)
                                   for d in dists]))
    else:
        write_hmg(p, names or [f"c{i+1}" for i in range(len(dists))],
                  dists)


def merge_dists(loaded):
    """ePMmerge over (names, dists) tuples: elementwise min per chrom."""
    names, dists = loaded[0]
    dists = [np.asarray(d, np.uint16).copy() for d in dists]
    for nm2, d2 in loaded[1:]:
        if nm2 is not None and names is not None and nm2 != names:
            raise ValueError("hammings merge: chromosome sets differ")
        if len(d2) != len(dists):
            raise ValueError("hammings merge: chrom count mismatch")
        for a, b in zip(dists, d2):
            if len(a) != len(b):
                raise ValueError("hammings merge: dimension mismatch")
            np.minimum(a, np.asarray(b, np.uint16), out=a)
    return names, dists
