"""hammings exhaustive sweep vs naive oracle."""
import numpy as np
import pytest

from kit4b_tpu import dna
from kit4b_tpu.kmer import hammings


def _genome(n, seed, with_sentinels=True):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, n).astype(np.uint8)
    if with_sentinels:
        g[n // 2] = dna.BASE_EOS  # fake a chrom boundary
        g[-1] = dna.BASE_EOG
    return g


@pytest.mark.parametrize("K,n,anti", [(5, 120, False), (5, 120, True),
                                      (8, 300, True)])
def test_exhaustive_matches_oracle(K, n, anti):
    g = _genome(n, seed=K + n)
    got = hammings.hammings_exhaustive(g, K, antisense=anti)
    want = hammings.hammings_oracle(g, K, antisense=anti)
    np.testing.assert_array_equal(got[: n - K + 1], want[: n - K + 1])


def test_node_partition_merge():
    K, n = 6, 200
    g = _genome(n, seed=3)
    full = hammings.hammings_exhaustive(g, K)
    parts = [hammings.hammings_exhaustive(g, K, node=i, numnodes=3)
             for i in range(3)]
    merged = hammings.merge(*parts)
    np.testing.assert_array_equal(merged, full)


def test_with_n_bases():
    K, n = 5, 150
    g = _genome(n, seed=9, with_sentinels=False)
    g[20:24] = dna.BASE_N
    got = hammings.hammings_exhaustive(g, K)
    want = hammings.hammings_oracle(g, K)
    np.testing.assert_array_equal(got[: n - K + 1], want[: n - K + 1])


def test_restricted_matches_oracle_capped():
    from kit4b_tpu.index.sfx_index import SfxIndex
    from kit4b_tpu.io.fasta import Genome
    rng = np.random.default_rng(21)
    n, K, H = 2000, 32, 3
    g = rng.integers(0, 4, n).astype(np.uint8)
    # plant a near-duplicate pair to exercise small distances
    g[500:532] = g[100:132]
    g[800:832] = g[200:232]
    g[803] = (g[803] + 1) % 4  # hamming 1 vs source
    g[850:882] = ((g[250:282] + 1) % 4)  # far from everything
    seq = np.concatenate([g, [dna.BASE_EOG]]).astype(np.uint8)
    gen = Genome(["c"], np.array([0]), np.array([n]), seq)
    idx = SfxIndex.build(gen, lut_k=8)
    got = hammings.hammings_restricted(idx, K, max_hamming=H, batch=512)
    want = hammings.hammings_oracle(seq, K)
    nk = n - K + 1
    w = np.minimum(want[:nk].astype(int), H + 1)
    gt = got[:nk].astype(int)
    # restricted mode guarantees exact values <= H; above H it reports H+1
    mismatch = np.nonzero(gt != w)[0]
    assert len(mismatch) == 0, (mismatch[:5], gt[mismatch[:5]],
                                w[mismatch[:5]])


def test_restricted_n_enumeration():
    """K-mers with 1..4 Ns enumerate substitutions (SfxArray.cpp:4152);
    >4 Ns score 0; short-K relaxed core scheduling still discovers
    low-mm hits."""
    import numpy as np
    from kit4b_tpu.index.sfx_index import SfxIndex
    from kit4b_tpu.io.fasta import Genome, SeqRecord
    from kit4b_tpu.kmer.hammings import hammings_restricted
    rng = np.random.default_rng(13)
    K = 16
    a = rng.integers(0, 4, 400).astype(np.uint8)
    # duplicate a segment so its K-mers have hamming 0
    a[200:216] = a[100:116]
    # an N inside a window whose substitution matches the duplicate
    b = a.copy()
    b[300:316] = a[100:116]
    b[308] = 4                      # one N
    g = Genome.from_records([SeqRecord("c", "", b)])
    idx = SfxIndex.build(g, lut_k=8)
    # K//(max_hamming+1)=16//4=4 < lut_k=8: the old code raised; now the
    # relaxed scheduling covers W = 2 cores
    out = hammings_restricted(idx, K, max_hamming=3, batch=512)
    assert out[100] == 0 and out[200] == 0
    # N window at 300: the A/C/G/T enumeration includes the exact match
    # against loci 100/200 -> hamming 0 via the substituted variant
    assert out[300] == 0
    # many-N window scores 0 per the reference convention
    c = a.copy()
    c[50:56] = 4                    # 6 Ns in windows covering 50..55
    g2 = Genome.from_records([SeqRecord("c", "", c)])
    idx2 = SfxIndex.build(g2, lut_k=8)
    out2 = hammings_restricted(idx2, K, max_hamming=3, batch=512)
    assert out2[45] == 0            # window 45..60 holds >4 Ns


def test_hmg_binary_roundtrip_and_cli_merge(tmp_path):
    """Reference .hmg quick-load binary (tsHHamHdr/tsHHamChrom,
    ngskit4b/hammings.cpp:78-94) roundtrips, and the CLI mode ladder
    (node runs -m1 -N/-n -> -m3 merge -> -m5 transCSV) reproduces the
    single-node result end to end (VERDICT r3 item 8)."""
    import subprocess
    import sys

    from kit4b_tpu.io.fasta import SeqRecord, write_fasta
    from kit4b_tpu.kmer import hammings
    rng = np.random.default_rng(11)
    seqs = [SeqRecord("cA", "", rng.integers(0, 4, 400).astype(np.uint8)),
            SeqRecord("cB", "", rng.integers(0, 4, 300).astype(np.uint8))]
    fa = tmp_path / "g.fa"
    write_fasta(fa, seqs)
    K = 9
    env = dict(__import__("os").environ,
               JAX_PLATFORMS="cpu")

    def run(*args):
        r = subprocess.run([sys.executable, "-m", "kit4b_tpu", *args],
                           capture_output=True, text=True, env=env,
                           cwd="/root/repo")
        assert r.returncode == 0, r.stderr[-2000:]

    # single-node reference result
    run("hammings", "-m1", "-i", str(fa), "-o", str(tmp_path / "all.hmg"),
        "-K", str(K))
    # 3-node split + merge
    for node in (1, 2, 3):
        run("hammings", "-m1", "-i", str(fa),
            "-o", str(tmp_path / f"n{node}.hmg"), "-K", str(K),
            "-N", str(node), "-n", "3")
    run("hammings", "-m3",
        "-i", *(str(tmp_path / f"n{i}.hmg") for i in (1, 2, 3)),
        "-o", str(tmp_path / "merged.hmg"))
    names_a, dists_a = hammings.read_hmg(tmp_path / "all.hmg")
    names_m, dists_m = hammings.read_hmg(tmp_path / "merged.hmg")
    assert names_a == names_m == ["cA", "cB"]
    for a, m in zip(dists_a, dists_m):
        np.testing.assert_array_equal(a, m)
    # trans to CSV and back preserves the distances
    run("hammings", "-m5", "-i", str(tmp_path / "merged.hmg"),
        "-o", str(tmp_path / "merged.csv"))
    names_c, dists_c = hammings.read_csv_dists(tmp_path / "merged.csv")
    assert names_c == names_a
    for a, c in zip(dists_a, dists_c):
        np.testing.assert_array_equal(a[:len(c)], c)
        assert (a[len(c):] == hammings.BIG).all()
    # binary roundtrip exactness
    hammings.write_hmg(tmp_path / "rt.hmg", names_a, dists_a)
    names_r, dists_r = hammings.read_hmg(tmp_path / "rt.hmg")
    assert names_r == names_a
    for a, r in zip(dists_a, dists_r):
        np.testing.assert_array_equal(a, r)


def test_oracle_at_positions_matches_full_oracle():
    g = _genome(400, seed=4)
    full = hammings.hammings_oracle(g, 9)
    pos = {0, 17, 199, 390}
    part = hammings.hammings_oracle(g, 9, positions=pos)
    idx = sorted(pos)
    np.testing.assert_array_equal(part[idx], full[idx])
    rest = np.setdiff1d(np.arange(len(g)), idx)
    assert (part[rest] == hammings.BIG).all()
