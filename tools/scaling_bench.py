#!/usr/bin/env python
"""Scaling-efficiency harness (SURVEY §7 step 9): align-pass throughput at
increasing dp x tp mesh shapes.

On a CPU host this validates the harness with a virtual 8-device mesh
(numbers are not meaningful for absolute throughput); on a multi-GPU host
the same invocation reports reads/s per device and scaling efficiency per
shape.

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python tools/scaling_bench.py
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from kit4b_tpu import dna
    from kit4b_tpu.align.kalign import build_pass_schedule, union_offsets
    from kit4b_tpu.index.sfx_index import SfxIndex
    from kit4b_tpu.io.fasta import Genome
    from kit4b_tpu.parallel import mesh as pmesh

    n_dev = len(jax.devices())
    rng = np.random.default_rng(1)
    G = 2_000_000
    seq = np.concatenate([rng.integers(0, 4, G).astype(np.uint8),
                          [dna.BASE_EOG]]).astype(np.uint8)
    g = Genome(["c"], np.array([0]), np.array([G]), seq)
    idx = SfxIndex.build(g)
    passes, _ = build_pass_schedule(100, 5, 1, len(g.seq))
    offs = union_offsets(passes)
    kw = dict(genome_len=len(g.seq), offsets=offs, lut_k=idx.lut_k,
              read_len=100, n_compact=64, n_extend=32, max_ml=5)
    B_per_dev = 4096
    from kit4b_tpu.ops import seed_extend_fast, seed_extend_v3
    gpack_d, gbad_d, _, _ = idx.device_arrays()
    nw2 = (100 + 15) // 16 + 1
    gview = seed_extend_fast.make_gview_device(
        np.asarray(gpack_d), np.asarray(gbad_d), nw2)

    shapes = []
    d = 1
    while d <= n_dev:
        shapes.append((d, 1))
        d *= 2
    if n_dev >= 2:
        shapes.append((n_dev // 2, 2))

    results = []
    base_rps = None
    for dp, tp in shapes:
        m = pmesh.make_mesh(dp, tp)
        sa_s, lut2_s, key_lo = pmesh.shard_index_by_key_v3(idx.sa_clean,
                                                           idx.lut, tp)
        args = pmesh.device_put_sharded_index_v3(m, gview, sa_s, lut2_s,
                                                 key_lo)
        fn = pmesh.make_sharded_align_pass_v4(m, **kw)
        B = B_per_dev * dp
        reads = rng.integers(0, 4, (B, 100)).astype(np.uint8)
        reads2b, nlist = pmesh.pack_reads_sharded(reads, dp)
        out = fn(*args, reads2b, nlist)
        jax.block_until_ready(out)
        t0 = time.time()
        for _ in range(5):
            out = fn(*args, reads2b, nlist)
            jax.device_get(out["low_mm"])
        dt = (time.time() - t0) / 5
        rps = B / dt
        if base_rps is None:
            base_rps = rps
        eff = rps / (base_rps * dp * tp)
        results.append({"dp": dp, "tp": tp, "devices": dp * tp,
                        "reads_per_s": round(rps),
                        "scaling_efficiency": round(eff, 3)})
        print(json.dumps(results[-1]), flush=True)
    print(json.dumps({"backend": jax.default_backend(),
                      "n_devices": n_dev, "results": results}))


if __name__ == "__main__":
    main()
