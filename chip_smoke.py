#!/usr/bin/env python
"""Smoke test of the main path on an NVIDIA GPU, through the CLI, at real size.

    python chip_smoke.py            # one GPU: phases 1-4
    python chip_smoke.py --multi    # four GPUs: the mesh passes only

Phases (one process, one card; the CPU comparisons run in child processes
that never open the card):

1. device: fails unless JAX's backend is "gpu"; prints the devices, the
   JAX version, the compile-cache directory, and the card's name and power
   limit from nvidia-smi.
2. SE kalign (config #1 scale): a seeded 4.6 Mbp genome, 100,000 x 100 bp
   Illumina-error reads from `simreads`, `index` then `kalign` to SAM, scored
   against the truth in the read names. The first 4,096 reads are aligned
   again on the CPU in a child process; its SAM records must equal the
   GPU's byte for byte.
3. PE kalign + SNP: 50,000 pairs 2x150 from the same genome with planted
   SNPs, `kalign -u` with a VCF SNP file; pairs scored against the truth,
   SNP recall and precision against the planted set, and the same CPU
   comparison on the first 4,096 pairs.
4. hammings (config #2): the Pallas kernel and the plain XLA version
   against the NumPy oracle at 20 kbp, against each other at 2 Mbp, both
   timed at 2 Mbp, the kernel at 12.1 Mbp when time allows, and the CLI's
   `hammings` output checked against the kernel.

With --multi (four cards) only the mesh paths run:
`__graft_entry__.dryrun_multichip(4)` and `hammings -R` / `hammings -M`
through the CLI at 2 Mbp, each checked against the one-card result.

Any failed check raises, and the script exits non-zero. The last line of
standard output is one JSON object: {"ok": true, "device": {...}}.
"""
import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
T_START = time.time()
BUDGET_S = 1200          # the whole run, compilation included

SE_GENOME_LEN = 4_600_000
SE_READS = 100_000
SE_LEN = 100
PE_PAIRS = 50_000
PE_LEN = 150
SNP_PER_MBP = 1000
CPU_SUBSET = 4096
HAM_ORACLE_LEN = 20_000
HAM_LEN = 2_000_000
HAM_YEAST_LEN = 12_100_000
HAM_K = 25
YEAST_CHECKS = 16

# Dense int8 tensor-core peak by device kind, ops/s (NVIDIA H100 SXM5
# data sheet: 1,979 TOPS without sparsity, at the full 700 W power limit).
INT8_PEAK = {
    "NVIDIA H100 80GB HBM3": 1979e12,
}


def say(*a):
    print(*a, flush=True)


def elapsed() -> float:
    return time.time() - T_START


def cli(*argv) -> float:
    """Run one CLI command in this process; returns its wall seconds."""
    from kit4b_tpu.cli import main
    t0 = time.time()
    rc = main([str(a) for a in argv])
    if rc != 0:
        raise RuntimeError(f"kit4b_tpu {' '.join(map(str, argv))}: rc={rc}")
    return time.time() - t0


def cli_cpu_child(workdir, *argv) -> float:
    """Run one CLI command in a child process held to the CPU (it never
    opens the card)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.time()
    r = subprocess.run([sys.executable, "-m", "kit4b_tpu",
                        *map(str, argv)], cwd=workdir, env=env,
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"CPU child {' '.join(map(str, argv))}: "
                           f"rc={r.returncode}\n{r.stderr[-3000:]}")
    return time.time() - t0


# --- phase 1 ---------------------------------------------------------------

def phase_device(want_count: int):
    import jax

    from kit4b_tpu.index import sa_build
    from kit4b_tpu.utils.runtime import enable_compile_cache
    if jax.default_backend() != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU; JAX's backend is "
                         f"{jax.default_backend()!r}")
    devs = jax.devices()
    if len(devs) < want_count:
        raise SystemExit(f"chip_smoke: needs {want_count} GPUs, "
                         f"found {len(devs)}")
    cache = enable_compile_cache()
    t0 = time.time()
    lib = sa_build._load_native()
    if lib is None:
        raise RuntimeError("the native library did not build "
                           "(make -C native)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    say(f"[device] jax {jax.__version__}; devices {devs}")
    say(f"[device] compile cache: {cache}")
    say(f"[device] native library {sa_build._LIB_PATH} loaded in "
        f"{time.time() - t0:.1f}s")
    say(f"[device] nvidia-smi: {smi}")
    return devs[0], smi.splitlines()[0]


# --- SAM scoring -------------------------------------------------------------

def sam_records(path):
    """(header lines without @PG, record lines) of a SAM file."""
    head, recs = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("@"):
                if not line.startswith("@PG"):
                    head.append(line)
            else:
                recs.append(line)
    return head, recs


def score_se(recs):
    """Accepted, true-locus and NM == truth-subs counts of SE records."""
    from kit4b_tpu.sim.simreads import parse_truth
    n = acc = true = nm_ok = 0
    for line in recs:
        f = line.split("\t")
        n += 1
        if int(f[1]) & 4:
            continue
        acc += 1
        t = parse_truth(f[0])
        strand = "-" if int(f[1]) & 16 else "+"
        if (f[2] == t["chrom"] and int(f[3]) - 1 == t["start"]
                and strand == t["strand"]):
            true += 1
            nm = [x for x in f[11:] if x.startswith("NM:i:")]
            if nm and int(nm[0][5:]) == t["subs"]:
                nm_ok += 1
    return n, acc, true, nm_ok


def score_pe(recs):
    """Pairs, accepted (proper-pair) pairs, and accepted pairs whose two
    mates both sit at their true locus and strand."""
    from kit4b_tpu.sim.simreads import parse_truth
    mates: dict = {}
    for line in recs:
        f = line.split("\t")
        t = parse_truth(f[0])
        flag = int(f[1])
        ok = (not flag & 4 and f[2] == t["chrom"]
              and int(f[3]) - 1 == t["start"]
              and ("-" if flag & 16 else "+") == t["strand"])
        mates.setdefault(t["read_id"], []).append((flag, ok))
    pairs = len(mates)
    acc = true = 0
    for ms in mates.values():
        if len(ms) == 2 and all(fl & 2 for fl, _ in ms):
            acc += 1
            true += all(ok for _, ok in ms)
    return pairs, acc, true


def check_cpu_equal(tag, gpu_sam, cpu_sam, names):
    """The GPU run's records for `names` must equal the CPU child's, byte
    for byte, and so must the headers (@PG aside)."""
    gh, gr = sam_records(gpu_sam)
    ch, cr = sam_records(cpu_sam)
    if gh != ch:
        raise AssertionError(f"{tag}: SAM headers differ GPU vs CPU")
    gsub = [r for r in gr if r.split("\t", 1)[0] in names]
    if len(gsub) != len(cr):
        raise AssertionError(f"{tag}: {len(gsub)} GPU records vs "
                             f"{len(cr)} CPU records")
    bad = [i for i, (a, b) in enumerate(zip(gsub, cr)) if a != b]
    if bad:
        i = bad[0]
        raise AssertionError(
            f"{tag}: {len(bad)}/{len(cr)} records differ GPU vs CPU; "
            f"first:\nGPU {gsub[i]}CPU {cr[i]}")
    say(f"[{tag}] CPU child: {len(cr)} SAM records byte-identical "
        f"to the GPU's")


def write_subset(src, dst, n):
    from kit4b_tpu.io.fasta import read_seqs, write_fasta
    recs = []
    for r in read_seqs(src):
        recs.append(r)
        if len(recs) == n:
            break
    write_fasta(dst, recs)
    return {r.name for r in recs}


# --- phase 2 ---------------------------------------------------------------

def make_genome(path, length, seed=4600):
    from kit4b_tpu.io.fasta import SeqRecord, write_fasta
    rng = np.random.default_rng(seed)
    write_fasta(path, [SeqRecord("ecoli_sim", "", rng.integers(
        0, 4, length).astype(np.uint8))])


def phase_se(wd, genome_len=SE_GENOME_LEN, n_reads=SE_READS,
             n_cpu=CPU_SUBSET):
    fa, kix = os.path.join(wd, "genome.fa"), os.path.join(wd, "genome.kix")
    reads, sam = os.path.join(wd, "se.fa"), os.path.join(wd, "se.sam")
    t0 = time.time()
    make_genome(fa, genome_len)
    say(f"[se] genome {genome_len:,} bp written in {time.time() - t0:.1f}s")
    t_idx = cli("index", "-i", fa, "-o", kix)
    t_sim = cli("simreads", "-i", fa, "-o", reads, "-n", n_reads,
                "-l", SE_LEN, "-e", "illumina", "-z", "0.02", "-S", 7)
    t_aln = cli("kalign", "-i", reads, "-I", kix, "-o", sam, "-M", 1)
    n, acc, true, nm_ok = score_se(sam_records(sam)[1])
    say(f"[se] wall: index {t_idx:.1f}s, simreads {t_sim:.1f}s, "
        f"kalign {t_aln:.1f}s (compilation included)")
    say(f"[se] {n:,} reads: accepted {100 * acc / n:.2f}%, true locus "
        f"{100 * true / max(acc, 1):.3f}% of accepted, NM == truth subs "
        f"{100 * nm_ok / max(true, 1):.2f}% of true-locus")
    if n != n_reads:
        raise AssertionError(f"se: {n} SAM records for {n_reads} reads")
    if acc < 0.97 * n or true < 0.999 * acc:
        raise AssertionError("se: acceptance or true-locus below limits "
                             "(97% / 99.9%)")
    sub, cpu_sam = os.path.join(wd, "se_sub.fa"), os.path.join(wd,
                                                                "se_cpu.sam")
    names = write_subset(reads, sub, n_cpu)
    t_cpu = cli_cpu_child(wd, "kalign", "-i", sub, "-I", kix, "-o",
                          cpu_sam, "-M", 1)
    say(f"[se] CPU child kalign of {len(names)} reads: {t_cpu:.1f}s")
    check_cpu_equal("se", sam, cpu_sam, names)
    return fa, kix


# --- phase 3 ---------------------------------------------------------------

def read_truth_bed(path):
    out = set()
    with open(path) as f:
        for line in f:
            c = line.split("\t")
            out.add((c[0], int(c[1])))
    return out


def read_vcf_loci(path):
    out = set()
    with open(path) as f:
        for line in f:
            if not line.startswith("#"):
                c = line.split("\t")
                out.add((c[0], int(c[1]) - 1))
    return out


def phase_pe(wd, fa, kix, n_pairs=PE_PAIRS, n_cpu=CPU_SUBSET):
    r1, r2 = os.path.join(wd, "pe_1.fa"), os.path.join(wd, "pe_2.fa")
    bed, vcf = os.path.join(wd, "snps.bed"), os.path.join(wd, "snps.vcf")
    sam = os.path.join(wd, "pe.sam")
    t_sim = cli("simreads", "-i", fa, "-o", r1, "-O", r2, "-p",
                "-n", n_pairs, "-l", PE_LEN, "-j", 250, "-J", 600,
                "-e", "illumina", "-z", "0.01", "-N", SNP_PER_MBP,
                "-u", bed, "-S", 9)
    pe_args = ("-I", kix, "-U", 1, "-d", 200, "-D", 700, "-M", 1)
    t_aln = cli("kalign", "-i", r1, "-u", r2, "-o", sam, "-S", vcf,
                *pe_args)
    pairs, acc, true = score_pe(sam_records(sam)[1])
    planted, called = read_truth_bed(bed), read_vcf_loci(vcf)
    hit = len(planted & called)
    say(f"[pe] wall: simreads {t_sim:.1f}s, kalign+snp {t_aln:.1f}s "
        f"(compilation included)")
    say(f"[pe] {pairs:,} pairs: accepted {acc:,} "
        f"({100 * acc / max(pairs, 1):.2f}%), both mates at the true locus "
        f"{100 * true / max(acc, 1):.3f}% of accepted")
    say(f"[pe] SNPs: planted {len(planted):,}, called {len(called):,}, "
        f"recall {100 * hit / max(len(planted), 1):.2f}%, precision "
        f"{100 * hit / max(len(called), 1):.2f}%")
    if pairs != n_pairs:
        raise AssertionError(f"pe: {pairs} pairs in the SAM, "
                             f"{n_pairs} simulated")
    if acc < 0.95 * pairs or true < 0.999 * acc:
        raise AssertionError("pe: acceptance or true-locus below limits "
                             "(95% / 99.9%)")
    s1, s2 = os.path.join(wd, "pe_sub_1.fa"), os.path.join(wd, "pe_sub_2.fa")
    names = write_subset(r1, s1, n_cpu) | write_subset(r2, s2, n_cpu)
    cpu_sam = os.path.join(wd, "pe_cpu.sam")
    t_cpu = cli_cpu_child(wd, "kalign", "-i", s1, "-u", s2, "-o", cpu_sam,
                          *pe_args)
    say(f"[pe] CPU child kalign of {len(names) // 2} pairs: {t_cpu:.1f}s")
    check_cpu_equal("pe", sam, cpu_sam, names)


# --- phase 4 ---------------------------------------------------------------

def ham_genome(wd, n, seed=2500):
    """Two chromosomes of n // 2 bp with a run of Ns, written as FASTA and
    loaded back as the CLI sees them (EOS between, EOG at the end).
    Returns (fasta path, concatenated codes)."""
    from kit4b_tpu.io.fasta import Genome, SeqRecord, write_fasta
    g = np.random.default_rng(seed).integers(0, 4, n).astype(np.uint8)
    g[n // 4: n // 4 + 200] = 4
    fa = os.path.join(wd, f"ham_{n}.fa")
    write_fasta(fa, [SeqRecord("h1", "", g[:n // 2]),
                     SeqRecord("h2", "", g[n // 2:])])
    return fa, Genome.load(fa).seq


def ham_ops(n, K=HAM_K):
    """int8 multiply-adds x2 of the two-strand min-matmul at length n."""
    from kit4b_tpu.kmer.hammings_mxu import PART, _round_up
    Gp = _round_up(n, PART)
    C = _round_up(5 * K, 128)
    return 2 * 2 * C * Gp * Gp


def time_impl(g, impl, reps=3):
    from kit4b_tpu.kmer.hammings_mxu import hammings_exhaustive_mxu
    out = hammings_exhaustive_mxu(g, HAM_K, impl=impl)      # compile, warm
    ts = []
    for _ in range(reps):
        t0 = time.time()
        hammings_exhaustive_mxu(g, HAM_K, impl=impl)  # ends in device_get
        ts.append(time.time() - t0)
    return out, statistics.median(ts), ts


def phase_hammings(wd, dev, smi, ham_len=HAM_LEN, oracle_len=HAM_ORACLE_LEN,
                   yeast_len=HAM_YEAST_LEN):
    from kit4b_tpu.kmer import hammings
    from kit4b_tpu.kmer.hammings_mxu import hammings_exhaustive_mxu
    peak = INT8_PEAK.get(dev.device_kind)
    if peak is None:
        raise KeyError(f"no int8 peak for device kind {dev.device_kind!r}")

    _, g = ham_genome(wd, oracle_len)
    t0 = time.time()
    want = hammings.hammings_oracle(g, HAM_K)
    t_or = time.time() - t0
    for impl in ("kernel", "xla"):
        got = hammings_exhaustive_mxu(g, HAM_K, impl=impl)
        if not np.array_equal(got, want):
            raise AssertionError(f"hammings {impl} != oracle at "
                                 f"{oracle_len} bp")
    say(f"[hammings] kernel == xla == oracle at {oracle_len:,} bp, K=25, "
        f"both strands, N run + EOS (oracle {t_or:.1f}s)")

    fa, g = ham_genome(wd, ham_len)
    res = {}
    for impl in ("kernel", "xla"):
        out, t, ts = time_impl(g, impl)
        res[impl] = out
        if impl == "kernel":
            ts_kernel = ts
        rate = (ham_len - HAM_K + 1) / t
        share = ham_ops(ham_len) / t / peak
        say(f"[hammings] {impl}: {ham_len / 1e6:.1f} Mbp K=25 both strands "
            f"median {t:.3f}s of {[round(x, 3) for x in ts]} = "
            f"{rate:,.0f} k-mers/s, {100 * share:.1f}% of int8 peak "
            f"({peak / 1e12:,.0f} TOPS) on {smi}")
    if not np.array_equal(res["kernel"], res["xla"]):
        n_bad = int((res["kernel"] != res["xla"]).sum())
        raise AssertionError(f"hammings kernel != xla at {ham_len} bp "
                             f"({n_bad} positions)")
    say(f"[hammings] kernel == xla bit for bit at {ham_len / 1e6:.1f} Mbp")

    npy = os.path.join(wd, "ham.npy")
    t_cli = cli("hammings", "-i", fa, "-o", npy, "-K", HAM_K)
    if not np.array_equal(np.load(npy), res["kernel"]):
        raise AssertionError("hammings CLI output != kernel result")
    say(f"[hammings] CLI `hammings` at {ham_len / 1e6:.1f} Mbp: "
        f"{t_cli:.1f}s, output equals the kernel's")

    # yeast scale (12.1 Mbp), kernel only, when the O(G^2) estimate from
    # the 2 Mbp median fits what is left of the budget
    t_est = statistics.median(ts_kernel) * (yeast_len / ham_len) ** 2
    left = BUDGET_S - elapsed()
    if 1.5 * t_est + 60 > left - 60:
        say(f"[hammings] {yeast_len / 1e6:.1f} Mbp skipped: estimated "
            f"{t_est:.0f}s, {left:.0f}s of the budget left")
        return
    _, gy = ham_genome(wd, yeast_len, seed=12100)
    t0 = time.time()
    hy = hammings_exhaustive_mxu(gy, HAM_K, impl="kernel")
    t = time.time() - t0
    say(f"[hammings] kernel: {yeast_len / 1e6:.1f} Mbp K=25 both strands "
        f"one run {t:.1f}s (compilation included) = "
        f"{(yeast_len - HAM_K + 1) / t:,.0f} k-mers/s, "
        f"{100 * ham_ops(yeast_len) / t / peak:.1f}% of int8 peak on {smi}")
    pos = set(np.random.default_rng(5).choice(len(gy) - HAM_K, YEAST_CHECKS,
                                              replace=False).tolist())
    t0 = time.time()
    want = hammings.hammings_oracle(gy, HAM_K, positions=pos)
    idx = sorted(pos)
    if hy.shape != gy.shape or not np.array_equal(hy[idx], want[idx]):
        raise AssertionError("hammings yeast-scale output != oracle at "
                             "sampled positions")
    say(f"[hammings] {yeast_len / 1e6:.1f} Mbp output == oracle at "
        f"{len(idx)} sampled positions ({time.time() - t0:.1f}s)")


# --- phase 5 (--multi) -------------------------------------------------------

def phase_multi(wd, count, ham_len=HAM_LEN):
    """The mesh passes on `count` devices, each against one device."""
    import jax

    import __graft_entry__
    t0 = time.time()
    __graft_entry__.dryrun_multichip(count)
    say(f"[multi] dryrun_multichip({count}): {time.time() - t0:.1f}s")
    fa, _ = ham_genome(wd, ham_len)
    outs = {}
    for flag in ("", "-R", "-M"):
        npy = os.path.join(wd, f"ham{flag}.npy")
        t = cli("hammings", "-i", fa, "-o", npy, "-K", HAM_K,
                *([flag] if flag else []))
        outs[flag] = np.load(npy)
        say(f"[multi] hammings {flag or '(one device)'} at "
            f"{ham_len / 1e6:.1f} Mbp: {t:.1f}s (compilation included)")
    for flag in ("-R", "-M"):
        if not np.array_equal(outs[flag], outs[""]):
            raise AssertionError(f"hammings {flag} != one-device result")
    say(f"[multi] hammings -R and -M bit-identical to one device")
    peaks = [d.memory_stats()["peak_bytes_in_use"]
             for d in jax.devices()[:count]]
    say(f"[multi] peak bytes in use per device: {peaks}")
    if min(peaks) < 32 << 20:
        raise AssertionError("multi: a device held almost no data; the "
                             "mesh did not spread the work")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="four GPUs: run only the mesh passes")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(HERE, "kit4b_tpu")):
        raise SystemExit("chip_smoke: the kit4b_tpu package is not beside "
                         "this script")
    sys.path.insert(0, HERE)
    count = 4 if args.multi else 1
    dev, smi = phase_device(count)
    wd = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        if args.multi:
            phase_multi(wd, count)
        else:
            fa, kix = phase_se(wd)
            phase_pe(wd, fa, kix)
            phase_hammings(wd, dev, smi)
    finally:
        shutil.rmtree(wd, ignore_errors=True)
    say(f"[done] {elapsed():.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
