"""Measure steady-state pipelined throughput of the compact fast pass:
how much of the per-call dispatch overhead can in-flight batching hide,
and what single-call large batches cost end-to-end."""
import sys, os, time, functools
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import jax
import jax.numpy as jnp

from kit4b_tpu import dna
from kit4b_tpu.io.fasta import Genome
from kit4b_tpu.index.sfx_index import SfxIndex
from kit4b_tpu.sim import simreads
from kit4b_tpu.ops import seed_extend_fast as F
from kit4b_tpu.ops.extend_packed import pack_genome

GENOME_LEN = 4_600_000
L = 100
N_READS = 98304

rng = np.random.default_rng(12345)
seq = np.concatenate([rng.integers(0, 4, GENOME_LEN).astype(np.uint8),
                      [dna.BASE_EOG]]).astype(np.uint8)
g = Genome(["e"], np.array([0]), np.array([GENOME_LEN]), seq)
idx = SfxIndex.build(g)
recs = simreads.sim_reads(g, simreads.SimParams(
    n_reads=N_READS, read_len=L, seed=7, error_mode="illumina",
    subs_rate=0.02))
reads = np.stack([r.codes for r in recs])

offsets = F.fast_offsets(L, idx.lut_k, 5)
nw2 = (L + 15) // 16 + 1
gpack, gbad = pack_genome(seq, 65)
gview = jnp.asarray(F.make_gview(gpack, gbad, nw2))
sa = jnp.asarray(idx.sa_clean.astype(np.int32))
lut = jnp.asarray(idx.lut.astype(np.int32))
G = len(seq)


def run(name, B, NC, n_rounds=3):
    fn = functools.partial(F.fast_pass_compact, genome_len=G,
                           offsets=offsets, lut_k=idx.lut_k,
                           n_compact=NC, max_tot_mm=5, mm_delta=1)
    batches = [reads[s:s + B] for s in range(0, N_READS - B + 1, B)]
    # compile
    jax.block_until_ready(fn(gview, sa, lut, jnp.asarray(batches[0])))
    best = None
    for _ in range(n_rounds):
        t0 = time.time()
        outs = [fn(gview, sa, lut, jnp.asarray(b)) for b in batches]
        res = [np.asarray(o) for o in outs]
        dt = time.time() - t0
        if best is None or dt < best:
            best = dt
    n = len(batches) * B
    print(f"{name:42s} {best*1000:8.1f} ms  {n/best/1000:7.0f}K r/s",
          flush=True)
    return res


def run_nofetch(name, B, NC, n_rounds=3):
    """Device-rate: submit all, block on last, fetch nothing big."""
    fn = functools.partial(F.fast_pass_compact, genome_len=G,
                           offsets=offsets, lut_k=idx.lut_k,
                           n_compact=NC, max_tot_mm=5, mm_delta=1)
    batches = [jnp.asarray(reads[s:s + B])
               for s in range(0, N_READS - B + 1, B)]
    jax.block_until_ready(fn(gview, sa, lut, batches[0]))
    best = None
    for _ in range(n_rounds):
        t0 = time.time()
        outs = [fn(gview, sa, lut, b) for b in batches]
        jax.block_until_ready(outs[-1])
        s = jnp.sum(outs[-1][:, 0])          # tiny d2h
        float(s)
        dt = time.time() - t0
        if best is None or dt < best:
            best = dt
    n = len(batches) * B
    print(f"{name:42s} {best*1000:8.1f} ms  {n/best/1000:7.0f}K r/s",
          flush=True)


print(f"devices: {jax.devices()}", flush=True)
for B, NC in [(8192, 16), (16384, 16), (32768, 16), (98304, 16),
              (32768, 24), (98304, 24)]:
    run_nofetch(f"device-only  B={B} NC={NC}", B, NC)
for B, NC in [(16384, 16), (32768, 16), (98304, 16), (32768, 24),
              (98304, 24)]:
    run(f"with-d2h     B={B} NC={NC}", B, NC)
