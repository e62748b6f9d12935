"""Capture a jax.profiler trace of the production kalign pass.

Closes SURVEY §5.1: the reference only has CStopWatch wall-clock logging
(libkit4b/StopWatch.h); this captures a real XLA device trace (TensorBoard
`trace_viewer` format) of one warm v4 fast-pass round plus the host-side
collect, into --outdir (default /tmp/kit4b_trace).

Usage:  python tools/capture_trace.py [--outdir DIR] [--batch 32768]
The resulting directory loads in TensorBoard (`tensorboard --logdir DIR`)
or xprof, or with jax.profiler.ProfileData.from_file.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from kit4b_tpu.utils.runtime import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax  # noqa: E402
import numpy as np  # noqa: E402

from kit4b_tpu import dna  # noqa: E402
from kit4b_tpu.align import kalign  # noqa: E402
from kit4b_tpu.index.sfx_index import SfxIndex  # noqa: E402
from kit4b_tpu.io.fasta import Genome  # noqa: E402
from kit4b_tpu.sim import simreads  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--outdir", default="/tmp/kit4b_trace")
    ap.add_argument("--batch", type=int, default=32768)
    ap.add_argument("--genome", type=int, default=4_600_000)
    args = ap.parse_args()

    rng = np.random.default_rng(1)
    seq = np.concatenate([rng.integers(0, 4, args.genome).astype(np.uint8),
                          [dna.BASE_EOG]]).astype(np.uint8)
    g = Genome(["c1"], np.array([0]), np.array([args.genome]), seq)
    idx = SfxIndex.build(g)
    recs = simreads.sim_reads(
        g, simreads.SimParams(n_reads=args.batch, read_len=100, seed=3,
                              error_mode="illumina", subs_rate=0.02))
    reads = np.stack([r.codes for r in recs])
    al = kalign.KAligner(idx, batch_size=args.batch)

    # warm (compile + session) outside the trace
    al.align_batch_raw(reads)

    os.makedirs(args.outdir, exist_ok=True)
    with jax.profiler.trace(args.outdir):
        t0 = time.time()
        out = al.align_batch_raw(reads)
        dt = time.time() - t0
    n_acc = int((out["nar"] == 0).sum())
    print(f"traced one round: {dt*1000:.1f} ms, accepted {n_acc}/"
          f"{args.batch}; trace -> {args.outdir}")


if __name__ == "__main__":
    main()
