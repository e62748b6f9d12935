"""swservice: distributed SW alignment dispatch (BKS RPC equivalent).

The reference offloads SW jobs to remote provider machines over a bespoke
framed TCP protocol — session negotiation, keepalives, 64MB frames, up to
128 service instances per provider (pacbiokit4b/BKScommon.h:27-99,
BKSRequester.cpp, BKSProvider.cpp). On a device mesh the same role — "align this
stream of (probe, target) pairs somewhere else, fast" — is a device-mesh
batch dispatcher: jobs are packed into fixed-shape batches, sharded over a
"dp" mesh axis with shard_map, and every chip runs the banded SW wavefront
kernel on its shard. Session/keepalive/frame machinery disappears: the XLA
runtime owns transport and failure surfacing (SURVEY.md §5.8).

No sockets; multi-host use composes with parallel/distributed.py process
groups (each host feeds its local shard of the job stream).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import jax
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..pacbio.sswd import SWScores, _sw_scan, banded_sw_batch


@dataclass
class SWJob:
    probe: np.ndarray
    target: np.ndarray
    diag0: int = 0


@dataclass
class SWService:
    """Batch SW scorer over every available device.

    >>> svc = SWService(band=256)
    >>> scores = svc.score([SWJob(p, t), ...])   # one device pass per shard
    """
    band: int = 256
    scores: SWScores = field(default_factory=SWScores)
    devices: list | None = None

    def __post_init__(self):
        devs = self.devices if self.devices is not None else jax.devices()
        self.mesh = Mesh(np.asarray(devs), ("dp",))
        self.n_dev = len(devs)

    def score(self, jobs: list[SWJob]) -> np.ndarray:
        """Peak SW score per job; jobs are padded to a whole number of
        per-device shards and sharded over the dp axis."""
        if not jobs:
            return np.zeros(0, np.int32)
        D = self.n_dev
        B = -(-len(jobs) // D) * D
        Lp = -(-max(len(j.probe) for j in jobs) // 512) * 512
        Lt = -(-max(len(j.target) for j in jobs) // 512) * 512
        probes = np.full((B, Lp), 0x0F, np.uint8)
        targets = np.full((B, Lt), 0x0F, np.uint8)
        plens = np.zeros(B, np.int32)
        tlens = np.zeros(B, np.int32)
        diag0 = np.zeros(B, np.int32)
        for i, j in enumerate(jobs):
            probes[i, :len(j.probe)] = j.probe
            targets[i, :len(j.target)] = j.target
            plens[i] = len(j.probe)
            tlens[i] = len(j.target)
            diag0[i] = j.diag0
        sc = self.scores

        def _local(p, t, pl, tl, d0):
            best, _, _, _ = _sw_scan(
                p, t, pl, tl, d0, W=self.band, Lp=Lp, traceback=False,
                match=sc.match, mismatch=sc.mismatch,
                gap_open=sc.gap_open, gap_ext=sc.gap_ext)
            return best

        fn = jax.jit(jax.shard_map(
            _local, mesh=self.mesh,
            in_specs=(P("dp"), P("dp"), P("dp"), P("dp"), P("dp")),
            out_specs=P("dp"), check_vma=False))
        out = fn(probes, targets, plens, tlens, diag0)
        return np.asarray(jax.device_get(out))[:len(jobs)]

    def align(self, jobs: list[SWJob]):
        """Full alignments (with traceback) — single-device batched path."""
        if not jobs:
            return []
        B = len(jobs)
        Lp = max(len(j.probe) for j in jobs)
        Lt = max(len(j.target) for j in jobs)
        probes = np.full((B, Lp), 0x0F, np.uint8)
        targets = np.full((B, Lt), 0x0F, np.uint8)
        plens = np.zeros(B, np.int32)
        tlens = np.zeros(B, np.int32)
        diag0 = np.zeros(B, np.int32)
        for i, j in enumerate(jobs):
            probes[i, :len(j.probe)] = j.probe
            targets[i, :len(j.target)] = j.target
            plens[i] = len(j.probe)
            tlens[i] = len(j.target)
            diag0[i] = j.diag0
        return banded_sw_batch(probes, plens, targets, tlens, diag0,
                               band=self.band, scores=self.scores)
