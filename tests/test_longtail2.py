"""pangenome, seghaplotypes, gbsmapsnps, dgts, rnaexpr, genmlds,
sarscov2ml, alignsbs."""
import numpy as np
import pytest

from kit4b_tpu import dna
from kit4b_tpu.cli import main
from kit4b_tpu.io.fasta import SeqRecord, write_fasta


def _sam(path, recs, chroms):
    with open(path, "w") as f:
        f.write("@HD\tVN:1.4\tSO:unsorted\n")
        for name, ln in chroms:
            f.write(f"@SQ\tSN:{name}\tLN:{ln}\n")
        for i, (chrom, pos, seq) in enumerate(recs):
            f.write(f"r{i}\t0\t{chrom}\t{pos}\t254\t{len(seq)}M\t*\t0\t0"
                    f"\t{seq}\t{'I' * len(seq)}\n")


def test_pangenome_prefix_and_filter(tmp_path):
    fa = tmp_path / "in.fa"
    fa.write_text(">chr1 desc\nACGT\n>chr2\nGGCC\n")
    out = tmp_path / "out.fa"
    assert main(["pangenome", "-m", "0", "-p", "FndrA",
                 "-i", str(fa), "-o", str(out)]) == 0
    lines = out.read_text().splitlines()
    assert lines[0] == ">FndrA|#chr1 desc"
    assert lines[2] == ">FndrA|#chr2"

    sam = tmp_path / "a.sam"
    _sam(sam, [("FndrA|#c1", 10, "ACGT"), ("FndrB|#c1", 20, "ACGT")],
         [("FndrA|#c1", 100), ("FndrB|#c1", 100)])
    fsam = tmp_path / "f.sam"
    assert main(["pangenome", "-m", "1", "-p", "FndrA",
                 "-i", str(sam), "-o", str(fsam)]) == 0
    body = [l for l in fsam.read_text().splitlines()
            if not l.startswith("@")]
    assert len(body) == 1 and body[0].split("\t")[2] == "FndrA|#c1"
    hdr = [l for l in fsam.read_text().splitlines()
           if l.startswith("@SQ")]
    assert len(hdr) == 1 and "SN:FndrA|#c1" in hdr[0]


def test_pangenome_wiggle(tmp_path):
    sam = tmp_path / "a.sam"
    # 3 alignments in bin 0, 1 in bin 1 (bin = 1kbp), plus a duplicate
    # locus that unique mode must collapse
    recs = [("c1", 5, "A" * 50), ("c1", 5, "A" * 50),
            ("c1", 500, "A" * 50), ("c1", 1500, "A" * 50)]
    _sam(sam, recs, [("c1", 3000)])
    wig = tmp_path / "all.wig"
    assert main(["pangenome", "-m", "2", "-b", "1",
                 "-i", str(sam), "-o", str(wig)]) == 0
    vals = [l for l in wig.read_text().splitlines()
            if not l.startswith(("track", "fixedStep"))]
    assert vals == ["3", "1"]
    wigu = tmp_path / "uniq.wig"
    assert main(["pangenome", "-m", "3", "-b", "1",
                 "-i", str(sam), "-o", str(wigu)]) == 0
    vals = [l for l in wigu.read_text().splitlines()
            if not l.startswith(("track", "fixedStep"))]
    assert vals == ["2", "1"]


def test_seghaplotypes(tmp_path):
    """Exact oracle for the full CSegHaplotypes ladder: raw bins ->
    ApplySmoothing (adjacent halves) -> seed calling (score = counts per
    100Kbp clamped [2,999]) -> neighbor interpolation of uncovered bins ->
    per-founder score-run BEDs (seghaplotypes.cpp:1111-1438)."""
    sam = tmp_path / "pg.sam"
    chroms = [("FA|#c1", 50000), ("FB|#c1", 50000)]
    recs = []
    # founder A: 17 hits in bin 0, 13 in bin 1; founder B: 12 in bin 2
    for i in range(30):
        recs.append(("FA|#c1", 1 + i * 600, "A" * 60))
    for i in range(12):
        recs.append(("FB|#c1", 20001 + i * 700, "A" * 60))
    # one stray B hit in bin 0 (below min score)
    recs.append(("FB|#c1", 100, "A" * 60))
    _sam(sam, recs, chroms)
    bed = tmp_path / "segs.bed"
    assert main(["seghaplotypes", "-i", str(sam), "-o", str(bed),
                 "-b", "10", "--minbinscore", "5", "-M", "0.3"]) == 0
    # default output splits per founder
    def rows(p):
        return [l.split("\t") for l in p.read_text().splitlines()[1:]]
    fa = [(int(s), int(e), int(sc)) for c, s, e, f, sc in
          rows(tmp_path / "segs.bed.FA.bed")]
    fb = [(int(s), int(e), int(sc)) for c, s, e, f, sc in
          rows(tmp_path / "segs.bed.FB.bed")]
    # smoothed: A = [23,21,6,0,0], B = [1,6,12,6,0]; score = cnt*10
    # bin2: A prop 6/18 >= 0.3 -> both founders called there
    # bin4: uncovered -> interpolated from called bin3 (pattern B only)
    assert fa == [(0, 10000, 230), (10000, 20000, 210),
                  (20000, 30000, 60)]
    assert fb == [(20000, 30000, 120), (30000, 40000, 60),
                  (40000, 50000, 1)]

    # -s (no split): single combined BED; -n: called bins carry the
    # no-score sentinel instead of coverage scores
    assert main(["seghaplotypes", "-i", str(sam), "-o", str(bed),
                 "-b", "10", "--minbinscore", "5", "-M", "0.3",
                 "-s", "-n"]) == 0
    both = rows(bed)
    assert {r[3] for r in both} == {"FA", "FB"}
    from kit4b_tpu.tools.seghaps import BED_NO_SCORE
    assert all(int(r[4]) == BED_NO_SCORE for r in both)
    # noscore merges same-score runs: one row per founder span
    fa_rows = [r for r in both if r[3] == "FA"]
    assert [(int(r[1]), int(r[2])) for r in fa_rows] == [(0, 30000)]


def test_seghaplotypes_marker_boost_and_align_beds(tmp_path):
    """SNP-marker confidence boost ((mult-1) * overlapped sites,
    seghaplotypes.cpp:1111-1112) and per-founder raw-alignment BEDs."""
    from kit4b_tpu.tools.seghaps import SegHapEngine, load_snpmarker_sites
    sam = tmp_path / "pg.sam"
    # 3 FA hits in bin 0; one overlaps two marker sites
    recs = [("FA|#c1", 1, "A" * 60), ("FA|#c1", 201, "A" * 60),
            ("FA|#c1", 401, "A" * 60)]
    _sam(sam, recs, [("FA|#c1", 10000)])
    mk = tmp_path / "markers.csv"
    mk.write_text('"MarkerID","Chrom","Loci","RefBase","CA","CA_purity"\n'
                  '1,"c1",210,"A","T",1.0\n1,"c1",240,"A","T",1.0\n')
    sites = load_snpmarker_sites(mk)
    assert list(sites["c1"]) == [210, 240]
    eng = SegHapEngine(bin_size_kbp=1, min_bin_score=1,
                       snp_marker_mult=5)
    eng.load_markers(mk)
    eng.parse_sam(str(sam))
    eng.bin_counts()
    # raw = 3 alignments + (5-1)*2 marker boost on the overlapping one
    assert eng.targs["c1"].bins[0, 0] == 3 + 8
    beds = eng.gen_alignment_beds(str(sam))
    p = f"{sam}.FA.bed"
    assert beds[p] == 3
    assert len(open(p).read().splitlines()) == 4


def test_gbsmapsnps_map_and_combine(tmp_path):
    gbs_csv = tmp_path / "gbs.csv"
    gbs_csv.write_text(
        "SNPID,Chrom,Loci,FounderA,FounderB,P1,P2,P3\n"
        "s1,c1,100,AA,TT,AA,TT,AT\n"
        "s2,c1,200,CC,GG,GG,NA,CC\n"
        "s3,c1,300,AA,AA,AA,AA,AA\n")     # non-discriminating -> dropped
    out = tmp_path / "m1.csv"
    assert main(["gbsmapsnps", "-i", str(gbs_csv),
                 "-o", str(out)]) == 0
    from kit4b_tpu.kmer.gbs import (CALL_BOTH, CALL_FA, CALL_FB, CALL_NA,
                                    read_haplotype_matrix)
    founders, progenies, rows = read_haplotype_matrix(out)
    assert founders == ("FounderA", "FounderB")
    assert progenies == ["P1", "P2", "P3"]
    assert len(rows) == 2
    assert rows[0][2] == [CALL_FA, CALL_FB, CALL_BOTH]
    assert rows[1][2] == [CALL_FB, CALL_NA, CALL_FA]

    # combine with a matrix that fills the NA and conflicts on P1/s1
    m2 = tmp_path / "m2.csv"
    from kit4b_tpu.kmer.gbs import write_haplotype_matrix
    write_haplotype_matrix(m2, founders, progenies, [
        ("c1", 100, [CALL_FB, CALL_FB, CALL_BOTH]),
        ("c1", 200, [CALL_FB, CALL_FA, CALL_FA])])
    comb = tmp_path / "comb.csv"
    assert main(["gbsmapsnps", "-m", "1", "-i", str(out),
                 "-I", str(m2), "-o", str(comb)]) == 0
    _, _, crows = read_haplotype_matrix(comb)
    assert crows[0][2] == [CALL_NA, CALL_FB, CALL_BOTH]  # conflict -> NA
    assert crows[1][2] == [CALL_FB, CALL_FA, CALL_FA]    # NA filled


def test_dgts_qtl(tmp_path):
    from kit4b_tpu.io.fasta import Genome
    from kit4b_tpu.kmer.pba import save_pba
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, 500).astype(np.uint8)
    fa = tmp_path / "g.fa"
    write_fasta(fa, [SeqRecord("c1", "", codes)])
    g = Genome.load(fa)
    # sample 1: dirac A at locus 10; sample 2: dirac C; sample 3: empty
    for name, slot in (("s1", 3), ("s2", 2)):
        pba = np.zeros(500, np.uint8)
        pba[10] = 3 << (2 * slot)
        save_pba(tmp_path / f"{name}.pba.npz", g, pba)
    save_pba(tmp_path / "s3.pba.npz", g, np.zeros(500, np.uint8))
    qtls = tmp_path / "qtls.csv"
    qtls.write_text('"Chrom","Loci","Allele"\nc1,10,A\n')
    out = tmp_path / "dgts.csv"
    assert main(["dgts", "-Q", str(qtls), "-o", str(out),
                 "-i", f"s1={tmp_path}/s1.pba.npz",
                 f"s2={tmp_path}/s2.pba.npz",
                 f"s3={tmp_path}/s3.pba.npz",
                 "-k", "0.8", "-p", "0.95"]) == 0
    hdr = out.read_text().splitlines()[0]
    assert hdr.startswith('"Chrom","Loci","RefDiplotype"')
    row = out.read_text().splitlines()[1].split(",")
    # coverage 2/3 < 0.8 -> uncharacterised (CDGTvQTLs low-coverage)
    cols = dict(zip(hdr.replace('"', "").split(","), row))
    assert cols["Characterised"] == "0"
    assert abs(float(cols["Coverage"]) - 2 / 3) < 0.01


def test_rnaexpr_replicates(tmp_path):
    rng = np.random.default_rng(5)
    base1 = rng.random(60) * 100
    base2 = rng.random(60) * 100
    # samples: a_rep1,a_rep2 correlated; b_rep1,b_rep2 correlated;
    # but b_rep2 column is actually a copy of a profile (mislabeled)
    cols = {
        "a1": base1 + rng.normal(0, 1, 60),
        "a2": base1 + rng.normal(0, 1, 60),
        "b1": base2 + rng.normal(0, 1, 60),
        "b2": base1 + rng.normal(0, 1, 60),   # mislabeled!
    }
    csvp = tmp_path / "cnts.csv"
    with open(csvp, "w") as f:
        f.write('"Feature","a1","a2","b1","b2"\n')
        for i in range(60):
            f.write(f"f{i}," + ",".join(
                f"{cols[s][i]:.3f}" for s in ("a1", "a2", "b1", "b2"))
                + "\n")
    out = tmp_path / "rep.csv"
    assert main(["rnaexpr", "-i", str(csvp), "-o", str(out)]) == 0
    rows = {l.split(",")[0].strip('"'): l.split(",")
            for l in out.read_text().splitlines()[1:]}
    assert rows["a1"][7] == "0" or rows["a1"][7] == "1"
    # b1's labeled partner b2 is NOT its best match
    assert rows["b1"][7] == "0"
    assert rows["b2"][3].strip('"') in ("a1", "a2")


def test_genmlds_and_sarscov2ml(tmp_path):
    src = tmp_path / "feat.csv"
    src.write_text('"Feature","s1","s2"\n"f1",1,2\n"f2",3,4\n')
    lab = tmp_path / "lab.csv"
    lab.write_text("s1,case\ns2,control\n")
    out = tmp_path / "ml.csv"
    assert main(["genmlds", "-i", str(src), "-l", str(lab),
                 "-o", str(out)]) == 0
    lines = out.read_text().splitlines()
    assert lines[0] == '"Sample","Label","f1","f2"'
    assert lines[1] == '"s1","case",1,3'
    assert lines[2] == '"s2","control",2,4'

    # linkage: f0,f1,f2 co-occur >= class 3 in 20 rows; f3 random
    rng = np.random.default_rng(1)
    mat = np.zeros((40, 4), int)
    mat[:20, :3] = 3
    mat[:, 3] = rng.integers(0, 2, 40)
    mx = tmp_path / "mx.csv"
    with open(mx, "w") as f:
        f.write('"Isolate","f0","f1","f2","f3"\n')
        for i, row in enumerate(mat):
            f.write(f"i{i}," + ",".join(map(str, row)) + "\n")
    lout = tmp_path / "link.csv"
    assert main(["sarscov2ml", "-i", str(mx), "-o", str(lout),
                 "-l", "3", "-r", "10", "-c", "3"]) == 0
    lines = lout.read_text().splitlines()
    assert len(lines) >= 2
    n, feats = lines[1].split(",", 1)
    assert int(n) == 20
    assert set(feats.strip('"').split(";")) == {"f0", "f1", "f2"}


def test_alignsbs(tmp_path):
    from kit4b_tpu.align.alignsbs import bootstrap_align
    from kit4b_tpu.io.fasta import Genome
    rng = np.random.default_rng(9)
    codes = rng.integers(0, 4, 20000).astype(np.uint8)
    fa = tmp_path / "asm.fa"
    write_fasta(fa, [SeqRecord("c1", "", codes)])
    asm = Genome.load(fa)
    # queries sampled from the same assembly -> should mostly hit
    qseqs = [SeqRecord(f"q{i}", "", codes[i * 500:i * 500 + 80])
             for i in range(10)]
    tseqs = [SeqRecord(f"t{i}", "", codes[i * 1000:i * 1000 + 2000])
             for i in range(8)]
    res = bootstrap_align(qseqs, asm, tseqs, asm, n_bootstraps=3,
                          max_subs=0, seed=4, batch_size=64)
    assert len(res) == 4
    orig = res[0]
    assert orig.n_queries == 10 and orig.query_hits >= 8
    for r in res[1:]:
        assert r.n_queries == 10 and r.n_targets == 8
        assert r.query_hits >= 5       # dense target coverage of c1


def test_gbsmapsnps_progeny_reports_and_nm(tmp_path):
    """Per-progeny 0/1 founder-bit reports (ReportHaplotypesByProgeny,
    GBSmapSNPs.cpp:1108) and 3-field NM chrom mapping with loci clamping
    (LoadNM :439, clamp :900)."""
    gbs_csv = tmp_path / "gbs.csv"
    gbs_csv.write_text(
        "SNPID,Chrom,Loci,FounderA,FounderB,P1,P2\n"
        "s1,alias1,100,AA,TT,AA,AT\n"
        "s2,alias1,9999,CC,GG,GG,NA\n")
    nm = tmp_path / "nm.csv"
    nm.write_text('"FromChrom","ToChrom","Size"\nalias1,chr1,5000\n')
    out = tmp_path / "hap.csv"
    from kit4b_tpu.cli import main
    assert main(["gbsmapsnps", "-i", str(gbs_csv), "-I", str(nm),
                 "-e", "7", "-o", str(out)]) == 0
    from kit4b_tpu.kmer.gbs import read_haplotype_matrix
    _, progenies, rows = read_haplotype_matrix(out)
    assert progenies == ["P1", "P2"]
    # alias1 -> chr1, loci 9999 clamped to 5000
    assert [(c, l) for c, l, _ in rows] == [("chr1", 100), ("chr1", 5000)]
    p1 = (tmp_path / "hap.csv.progeny.7.P1.csv").read_text().splitlines()
    assert p1[0] == '"ExprID","Progeny","Chrom","Loci",' \
                    '"Fndr:FounderA","Fndr:FounderB"'
    # P1: s1 matches Fa dirac (1,0); s2 matches Fb dirac (0,1)
    assert p1[1] == '7,"P1","chr1",100,1,0'
    assert p1[2] == '7,"P1","chr1",5000,0,1'
    # P2: s1 het of both founders (1,1); s2 NA -> skipped
    p2 = (tmp_path / "hap.csv.progeny.7.P2.csv").read_text().splitlines()
    assert p2[1:] == ['7,"P2","chr1",100,1,1']
    alln = (tmp_path / "hap.csv.progeny.7.all.csv").read_text()
    assert alln.count("\n") == 4  # header + 3 informative rows


@pytest.mark.parametrize("n_feat,n_samp", [(60, 4), (500, 12), (2000, 7)])
def test_pearson_matrix_matches_corrcoef(n_feat, n_samp):
    from kit4b_tpu.align.rnaexpr import pearson_matrix
    rng = np.random.default_rng(n_feat)
    base = rng.random((n_feat, 1)) * 100
    counts = base + rng.normal(0, 5, (n_feat, n_samp)) * rng.random(n_samp)
    want = np.corrcoef(counts.T)
    np.testing.assert_allclose(pearson_matrix(counts), want, rtol=0,
                               atol=1e-6)


def test_linkage_cosupport_is_exact_count():
    """The co-support matmul counts rows exactly: a linkage supported by
    exactly min_rows rows is found, one row fewer is not."""
    from kit4b_tpu.tools.mlds import find_feature_linkages
    mat = np.zeros((300, 5), int)
    mat[:257, :3] = 4          # f0..f2 co-occur in 257 rows
    mat[::2, 3:] = 4
    names = [f"f{i}" for i in range(5)]
    assert find_feature_linkages(mat, names, num_linked=3, min_rows=257)
    assert not find_feature_linkages(mat, names, num_linked=3,
                                     min_rows=258)
