"""Benchmark: genome-wide K=25 Hamming distances (BASELINE config #2).

Prints ONE JSON line {"metric", "value", "unit", "vs_baseline"}.

Workload: yeast-scale 12.1 Mbp random genome, K=25, BOTH strands, full
exhaustive all-offsets sweep on one GPU via the min-matmul engine
(kmer/hammings_mxu.py, the matrix-product form of ngskit4b/hammings.cpp:3183
GHamDistWatson/GHamDistCrick).

Baseline: the reference binary measured 67 s for a 200 Kbp sense-only run
on this 2-vCPU host (-T2). The sweep is O(G^2), so yeast both-strands =
67 s * (12.1M/200K)^2 * 2 = 490,440 s on 2 cores; the 64-core linear
extrapolation (driver target hardware) is /32 = 15,326 s -> 789 k-mers/s.
vs_baseline = (12.1M / wall_s) / 789.
"""
import json
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 1)[0])

GENOME_LEN = 12_100_000
K = 25
BASELINE_KMERS_PER_SEC = GENOME_LEN / (67.0 * (GENOME_LEN / 200_000.0) ** 2
                                       * 2.0 / 32.0)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    from kit4b_tpu.utils.runtime import enable_compile_cache
    enable_compile_cache()
    import jax

    from kit4b_tpu.kmer.hammings_mxu import hammings_exhaustive_mxu

    log(f"devices: {jax.devices()}")
    rng = np.random.default_rng(4242)
    g = rng.integers(0, 4, GENOME_LEN).astype(np.uint8)

    # warm the session + compile on a 1 Mbp slice (outside the timed run)
    t0 = time.time()
    hammings_exhaustive_mxu(g[:1_000_000], K, antisense=True)
    log(f"warmup (session + compile, 1 Mbp): {time.time()-t0:.1f}s")

    t0 = time.time()
    hd = hammings_exhaustive_mxu(g, K, antisense=True)
    dt = time.time() - t0
    nk = GENOME_LEN - K + 1
    rate = nk / dt
    log(f"hammings {GENOME_LEN/1e6:.1f} Mbp K={K} both strands: "
        f"{dt:.1f}s = {rate:,.0f} k-mers/s; min={int(hd[:nk].min())} "
        f"max={int(hd[:nk].max())} mean={float(hd[:nk].mean()):.2f}")

    print(json.dumps({
        "metric": "hammings_kmers_per_sec_per_chip",
        "value": round(rate, 1),
        "unit": "k-mers/s",
        "vs_baseline": round(rate / BASELINE_KMERS_PER_SEC, 3),
    }))


if __name__ == "__main__":
    main()
