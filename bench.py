"""Benchmark driver: kalign seed-and-extend throughput on one chip.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.

Config #1 of BASELINE.md: E. coli-scale genome (4.6 Mbp), 100K x 100 bp SE
simulated reads with Illumina-skewed errors -> aligned (unique-accept) on the
default sensitivity schedule. Serial rounds and depth-2/depth-4 streaming are
both measured; the headline is the better median, and every per-round time
is logged. Needs a GPU: it fails on any other backend.

vs_baseline: ratio vs the reference ngskit4b binary's 64-core linear
extrapolation from the 2-vCPU measurement on this host (BASELINE.md).
"""
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


# Reference ngskit4b kalign measured on THIS host (2 vCPUs, -T2): 100K reads
# in 9.43s end-to-end = 10,600 reads/s (see BASELINE.md "Measured" section).
# The driver's stated target is a 64-core host; absent one, we extrapolate
# linearly (2-core measured x 32), which overstates the reference (its rwlock
# block dispatch and shared-index memory traffic do not scale linearly), so
# vs_baseline below is a LOWER bound on the true ratio.
BASELINE_CPU_READS_PER_SEC = 10_600 * 32

GENOME_LEN = 4_600_000
N_READS = 100_000
READ_LEN = 100
BATCH = 98304
N_ROUNDS = 12


def main():
    from kit4b_tpu.utils.runtime import enable_compile_cache
    enable_compile_cache()
    import jax
    from kit4b_tpu import dna
    from kit4b_tpu.align import kalign
    from kit4b_tpu.index.sfx_index import SfxIndex
    from kit4b_tpu.io.fasta import Genome
    from kit4b_tpu.sim import simreads

    if jax.default_backend() != "gpu":
        raise SystemExit(f"bench: needs a GPU; JAX's backend is "
                         f"{jax.default_backend()!r}")
    dev = jax.devices()[0]
    log(f"devices: {jax.devices()}")
    rng = np.random.default_rng(12345)
    seq = np.concatenate([rng.integers(0, 4, GENOME_LEN).astype(np.uint8),
                          [dna.BASE_EOG]]).astype(np.uint8)
    g = Genome(["ecoli_sim"], np.array([0]), np.array([GENOME_LEN]), seq)

    t0 = time.time()
    idx = SfxIndex.build(g)
    log(f"index build: {time.time()-t0:.1f}s (lut_k={idx.lut_k}, "
        f"clean={len(idx.sa_clean)})")

    recs = simreads.sim_reads(
        g, simreads.SimParams(n_reads=N_READS, read_len=READ_LEN, seed=7,
                              error_mode="illumina", subs_rate=0.02))
    reads = np.stack([r.codes for r in recs])
    log(f"simreads: {len(recs)} reads")

    al = kalign.KAligner(idx, batch_size=BATCH)
    starts = list(range(0, len(reads) - BATCH + 1, BATCH))
    n_done = len(starts) * BATCH

    from collections import deque

    def one_round():
        """Align the full readset: one batch per round at this scale."""
        devs = [al._submit(reads[s:s + BATCH]) for s in starts]
        out, n_acc = [], 0
        for s, d in zip(starts, devs):
            raw = al._collect_compact(d, reads[s:s + BATCH])
            n_acc += int((raw["nar"] == 0).sum())
            out.append(raw)
        return out, n_acc

    def stream(n_batches, depth):
        """Steady-state streaming at the given pipeline depth: batch
        k+depth's 2-bit upload overlaps batch k's compute."""
        out, n_acc = [], 0
        pending = deque()
        t0 = time.time()
        marks = []
        for r in range(n_batches):
            pending.append(al._submit(reads[:BATCH]))
            if len(pending) >= depth:
                raw = al._collect_compact(pending.popleft(), reads[:BATCH])
                n_acc = int((raw["nar"] == 0).sum())
                out.append(raw)
                marks.append(time.time())
        while pending:
            raw = al._collect_compact(pending.popleft(), reads[:BATCH])
            n_acc = int((raw["nar"] == 0).sum())
            out.append(raw)
            marks.append(time.time())
        total = time.time() - t0
        return out, n_acc, total

    # warmup: compiles every pass shape incl. escalation tiers (the first
    # full round exercises overflow escalation exactly as the timed ones do)
    t0 = time.time()
    raws, n_acc = one_round()
    log(f"warmup (compile + first full round): {time.time()-t0:.1f}s")
    for depth in (2, 4):
        stream(depth + 1, depth)   # compile/warm the stream paths

    # every protocol runs interleaved so that a drift during the run cannot
    # bias one of them; the headline is the best median.
    times_serial = []
    stream_runs = {2: [], 4: []}
    for r in range(N_ROUNDS):
        t0 = time.time()
        raws, n_acc = one_round()
        dt = time.time() - t0
        times_serial.append(dt)
        log(f"serial round {r:2d}: {dt*1000:7.1f} ms  "
            f"{n_done/dt:9.0f} reads/s  accepted {n_acc}")
        if r % 4 == 3:     # interleave a 6-batch stream probe per protocol
            for depth in (2, 4):
                _, _, tot = stream(6, depth)
                rps_s = 6 * BATCH / tot
                stream_runs[depth].append(rps_s)
                log(f"stream depth-{depth} probe: {tot:.2f}s = "
                    f"{rps_s:9.0f} reads/s")
    med = statistics.median(times_serial)
    rps_serial = n_done / med
    iqr = (np.percentile(times_serial, 75)
           - np.percentile(times_serial, 25)) * 1000
    log(f"serial: median {med*1000:.1f} ms = {rps_serial:.0f} reads/s "
        f"(min {min(times_serial)*1000:.1f}, max {max(times_serial)*1000:.1f},"
        f" IQR {iqr:.1f} ms)")
    best_stream = 0.0
    best_depth = 0
    for depth, runs in stream_runs.items():
        if runs:
            m = statistics.median(runs)
            log(f"stream depth-{depth}: median of {len(runs)} probes = "
                f"{m:.0f} reads/s")
            if m > best_stream:
                best_stream, best_depth = m, depth
    rps = max(rps_serial, best_stream)
    proto = "serial" if rps == rps_serial else f"stream-depth{best_depth}"
    log(f"headline protocol: {proto} = {rps:.0f} reads/s")

    # cost split: host-to-device copy of one batch's 2-bit reads, and the
    # tier-1 pass on device-resident reads
    import jax.numpy as jnp
    b0 = reads[:BATCH]
    reads2b, nlist, _ = kalign.pack_reads_2bit(b0)
    def h2d():
        jax.block_until_ready((jnp.asarray(reads2b), jnp.asarray(nlist)))
    r2b_d = jnp.asarray(reads2b); nl_d = jnp.asarray(nlist)
    from kit4b_tpu.ops import seed_extend_v4, seed_extend_v5
    gview, sa, lut, lut2 = al._device_for(READ_LEN)
    _, mtm = al.schedule_for(READ_LEN)
    offs = al._offsets_for(READ_LEN, mtm)
    lut4 = al._lut4_for(READ_LEN, sa)   # production: v5 on clean indexes
    log(f"tier-1 kernel: "
        f"{'v5 (flattened lut4)' if lut4 is not None else 'v4'}")
    def compute():
        if lut4 is not None:
            out = seed_extend_v5.fast_pass_packed_v5(
                gview, sa, lut2, lut4, r2b_d, nl_d, read_len=READ_LEN,
                genome_len=len(seq), offsets=offs, lut_k=idx.lut_k,
                n_compact=al.n_compact, n_extend=al.n_extend,
                max_tot_mm=mtm, mm_delta=al.mm_delta, tier2=(512, 192, 96))
        else:
            out = seed_extend_v4.fast_pass_packed_v4(
                gview, sa, lut2, r2b_d, nl_d, read_len=READ_LEN,
                genome_len=len(seq), offsets=offs, lut_k=idx.lut_k,
                n_compact=al.n_compact, n_extend=al.n_extend,
                max_tot_mm=mtm, mm_delta=al.mm_delta)
        jax.block_until_ready(out)
    compute()  # warm (compiled already by the rounds)
    comp_ms = 0.0
    for name, fn in (("h2d 2-bit reads", h2d), ("compute-only", compute)):
        ts = []
        for _ in range(6):
            t0 = time.time(); fn(); ts.append(time.time() - t0)
        t = statistics.median(ts)
        if name == "compute-only":
            comp_ms = t * 1000
        log(f"cost split - {name}: {t*1000:7.1f} ms"
            + (f"  ({BATCH/t:,.0f} reads/s compute ceiling)"
               if name == "compute-only" else ""))

    # correctness spot check vs ground truth (outside the timed region)
    nar = np.concatenate([r["nar"] for r in raws])
    pos = np.concatenate([r["pos"] for r in raws])
    strand = np.concatenate([r["strand"] for r in raws])
    acc = np.nonzero(nar == 0)[0]
    ci, off = g.locate(pos[acc])
    n_ok = 0
    for j, i in enumerate(acc):
        t = simreads.parse_truth(recs[i].name)
        if (g.names[int(ci[j])] == t["chrom"] and int(off[j]) == t["start"]
                and ("-" if strand[i] else "+") == t["strand"]):
            n_ok += 1
    log(f"accepted {n_acc} ({100*n_acc/n_done:.1f}%), "
        f"truth-correct {100*n_ok/max(n_acc,1):.2f}% of accepted")

    vs = rps / BASELINE_CPU_READS_PER_SEC if BASELINE_CPU_READS_PER_SEC \
        else 0.0

    # --- secondary driver-visible metrics: PE config-#4 and the config-#2
    # hammings sweep ride the same JSON line as extra fields
    extras = {
        "se_serial_reads_per_sec": round(rps_serial, 1),
        "se_stream_reads_per_sec": round(best_stream, 1),
        "se_protocol": proto,
        "se_round_iqr_ms": round(float(iqr), 1),
        "se_compute_only_ms": round(comp_ms, 1),
    }
    from bench_pe import run_pe_bench
    rps_pe, vs_pe, det = run_pe_bench(n_rounds=6)
    extras["pe_reads_per_sec"] = round(rps_pe, 1)
    extras["pe_vs_baseline"] = round(vs_pe, 3)
    extras["pe_true_locus_pct"] = det["true_pct"]
    from kit4b_tpu.kmer.hammings_mxu import hammings_exhaustive_mxu
    # calibrate on 2 Mbp, then run the full yeast scale (config #2,
    # 12.1 Mbp) if the O(G^2) extrapolation fits the time budget
    HG_CAL, HG_FULL = 2_000_000, 12_100_000
    gh = np.random.default_rng(4242).integers(
        0, 4, HG_FULL).astype(np.uint8)
    hammings_exhaustive_mxu(gh[:500_000], 25, antisense=True)  # warm
    hammings_exhaustive_mxu(gh[:HG_CAL], 25, antisense=True)  # compile
    t0 = time.time()
    hammings_exhaustive_mxu(gh[:HG_CAL], 25, antisense=True)
    dt_cal = time.time() - t0
    est_full = dt_cal * (HG_FULL / HG_CAL) ** 2
    log(f"hammings calibration {HG_CAL/1e6:.0f} Mbp: {dt_cal:.1f}s "
        f"-> est {est_full:.0f}s at {HG_FULL/1e6:.1f} Mbp")
    HG = HG_FULL if est_full < 420 else 4_000_000
    t0 = time.time()
    hammings_exhaustive_mxu(gh[:HG], 25, antisense=True)
    dt = time.time() - t0
    hk = (HG - 24) / dt
    # reference: 67 s / 200 Kbp sense-only on 2 cores; O(G^2) sweep,
    # both strands x2, 64-core /32 (bench_hammings.py derivation)
    hbase = HG / (67.0 * (HG / 200_000.0) ** 2 * 2.0 / 32.0)
    extras["hammings_genome_mbp"] = round(HG / 1e6, 1)
    extras["hammings_kmers_per_sec"] = round(hk, 1)
    extras["hammings_vs_baseline"] = round(hk / hbase, 1)
    log(f"hammings {HG/1e6:.1f} Mbp K=25 both strands: {dt:.1f}s = "
        f"{hk:,.0f} k-mers/s = {hk/hbase:.1f}x 64-core extrapolation")

    print(json.dumps({
        "metric": "kalign_reads_aligned_per_sec_per_chip",
        "value": round(rps, 1),
        "unit": "reads/s",
        "vs_baseline": round(vs, 3),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        **extras,
    }))


if __name__ == "__main__":
    main()
