"""P5 multi-process distribution + §5.3 fault-injection (VERDICT item 7).

- test_two_process_align: two real jax.distributed CPU processes align
  host-sharded reads, write SAM shards, merge — asserted byte-equal (modulo
  record order) to the single-process run.
- test_filter_kill_resume: SIGKILL a filter run after its checkpoint lands,
  resume from the checkpoint, assert the final output equals an
  uninterrupted run's.
"""
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

import conftest  # noqa: F401

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

WORKER = r"""
import os, sys
import numpy as np
pid = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
workdir = sys.argv[4]
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                           num_processes=nproc, process_id=pid)
sys.path.insert(0, %r)
from kit4b_tpu.align import kalign
from kit4b_tpu.index.sfx_index import SfxIndex
from kit4b_tpu.io.fasta import read_seqs
from kit4b_tpu.parallel import distributed as D

assert jax.process_count() == nproc
idx = SfxIndex.load(os.path.join(workdir, "g.kix"))
recs = list(read_seqs(os.path.join(workdir, "reads.fa")))
mine = list(D.host_shard(recs, pid, nproc))
al = kalign.KAligner(idx, batch_size=256)
out = D.shard_output_path(os.path.join(workdir, "out.sam"), pid)
kalign.write_sam(out, idx, al.align_records(iter(mine), prefetch=False))
print("WORKER_DONE", pid, len(mine), flush=True)
""" % (REPO,)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def _mk_workdir(tmp_path):
    from kit4b_tpu import dna
    from kit4b_tpu.index.sfx_index import SfxIndex
    from kit4b_tpu.io.fasta import Genome
    from kit4b_tpu.sim import simreads
    rng = np.random.default_rng(4)
    n = 100_000
    seq = np.concatenate([rng.integers(0, 4, n).astype(np.uint8),
                          [dna.BASE_EOG]]).astype(np.uint8)
    g = Genome(["c1"], np.array([0]), np.array([n]), seq)
    SfxIndex.build(g).save(tmp_path / "g.kix")
    recs = simreads.sim_reads(g, simreads.SimParams(
        n_reads=500, read_len=100, seed=2, error_mode="uniform",
        subs_rate=0.01))
    simreads.write_reads(tmp_path / "reads.fa", recs, "fasta")
    return g


def _sam_records(path):
    out = {}
    for line in open(path):
        if line.startswith("@"):
            continue
        f = line.rstrip("\n").split("\t")
        out[f[0]] = (f[1], f[2], f[3], f[5])
    return out


@pytest.mark.multiproc
def test_two_process_align(tmp_path):
    _mk_workdir(tmp_path)
    port = _free_port()
    wpath = tmp_path / "worker.py"
    wpath.write_text(WORKER)
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, str(wpath), str(i), "2", str(port), str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-2000:]
        assert "WORKER_DONE" in out

    from kit4b_tpu.parallel.distributed import merge_sam_shards
    merge_sam_shards(tmp_path / "merged.sam",
                     [tmp_path / "out.p0.sam", tmp_path / "out.p1.sam"])

    # single-process run for comparison
    from kit4b_tpu.align import kalign
    from kit4b_tpu.index.sfx_index import SfxIndex
    from kit4b_tpu.io.fasta import read_seqs
    idx = SfxIndex.load(tmp_path / "g.kix")
    al = kalign.KAligner(idx, batch_size=256)
    kalign.write_sam(tmp_path / "single.sam", idx,
                     al.align_records(read_seqs(tmp_path / "reads.fa"),
                                      prefetch=False))
    a = _sam_records(tmp_path / "merged.sam")
    b = _sam_records(tmp_path / "single.sam")
    assert a == b, f"{len(a)} vs {len(b)} records; " \
        f"diff={ {k: (a.get(k), b.get(k)) for k in (set(a) ^ set(b)) or set(list(a)[:1]) if a.get(k) != b.get(k)} }"


def test_filter_kill_resume(tmp_path):
    """SIGKILL between checkpoint write and completion; resume must produce
    the uninterrupted result (SURVEY §5.3/5.4)."""
    from kit4b_tpu import dna
    from kit4b_tpu.io.fasta import Genome
    from kit4b_tpu.sim import simreads
    rng = np.random.default_rng(8)
    n = 60_000
    seq = np.concatenate([rng.integers(0, 4, n).astype(np.uint8),
                          [dna.BASE_EOG]]).astype(np.uint8)
    g = Genome(["c1"], np.array([0]), np.array([n]), seq)
    recs = simreads.sim_reads(g, simreads.SimParams(
        n_reads=3000, read_len=100, seed=3, error_mode="uniform",
        subs_rate=0.01))
    simreads.write_reads(tmp_path / "r.fa", recs, "fasta")
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO}

    def run_filter(out, ckpt, kill_after_ckpt=False):
        p = subprocess.Popen(
            [sys.executable, "-m", "kit4b_tpu", "filter",
             "-i", str(tmp_path / "r.fa"), "-o", out, "-k", ckpt],
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        if kill_after_ckpt:
            deadline = time.time() + 240
            while time.time() < deadline:
                if os.path.exists(ckpt + ".npz"):
                    os.kill(p.pid, signal.SIGKILL)
                    p.wait()
                    return False     # killed
                if p.poll() is not None:
                    break            # finished before checkpoint?!
                time.sleep(0.02)
        p.wait()
        assert p.returncode == 0
        return True

    # uninterrupted baseline
    run_filter(str(tmp_path / "base.fa"), str(tmp_path / "ck1"))
    # killed run -> resume from checkpoint
    finished = run_filter(str(tmp_path / "res.fa"), str(tmp_path / "ck2"),
                          kill_after_ckpt=True)
    if finished:
        pytest.skip("run finished before the kill window (machine too fast)")
    assert not os.path.exists(tmp_path / "res.fa")
    run_filter(str(tmp_path / "res.fa"), str(tmp_path / "ck2"))
    base = (tmp_path / "base.fa").read_text()
    res = (tmp_path / "res.fa").read_text()
    assert base == res
