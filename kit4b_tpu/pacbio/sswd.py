"""Batched banded affine-gap Smith-Waterman on device.

Device replacement for the reference's striped SW engine
(pacbiokit4b/SSW.cpp CSSW::Align, per-thread CSWAlign instances
SWAlign.h:82): instead of one sequence pair per CPU thread, a whole batch of
(probe, target) pairs runs as one [B, W] wavefront — `lax.scan` walks probe
rows, the band (width W) follows the expected diagonal, and the in-row
gap-run recurrence (the classic "lazy-F" dependency) is resolved with an
associative max-scan, so every op is a full-width vector op.

Scoring matches CSSW::SetScores semantics (SSW.cpp:331): match/mismatch,
affine gaps costing open for the first base and ext for each later base
(cSSWDfltDlyGapExtn=2, SSW.h:20). Alignment is local (scores floor at 0,
traceback from the peak).

Traceback: the kernel emits one byte per cell
  bits 0-1  H0 source: 0 stop, 1 diag (M), 2 up (D, gap in target)
  bit 2     cell value came from F (left run, I) rather than H0
  bit 3     E extends E above (vs opening from H above)
  bit 4     F extends F left (vs opening from H0 left)
and the host walks the packed byte cube — the O(Lp*W) DP stays on device,
the O(alignment length) walk stays on host.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

NEG = np.int32(-(1 << 24))


@dataclass(frozen=True)
class SWScores:
    """CSSW::SetScores equivalent (SSW.h:16-20)."""
    match: int = 1
    mismatch: int = -1
    gap_open: int = -3
    gap_ext: int = -1


@functools.partial(jax.jit, static_argnames=("W", "Lp", "traceback",
                                             "match", "mismatch",
                                             "gap_open", "gap_ext"))
def _sw_scan(probes, targets, plens, tlens, diag0, *, W, Lp, traceback,
             match, mismatch, gap_open, gap_ext):
    B, Lt = targets.shape
    karr = jnp.arange(W, dtype=jnp.int32)
    barr = jnp.arange(B, dtype=jnp.int32)

    # the band slides one target column per probe row, so the target
    # window rides the scan carry: one [B] element gather per step plus
    # a shift, instead of a [B, W] per-index gather per step (which
    # cost ~1.9G gathered elements per 20 Kbp x band-3000 batch)
    cols_init = diag0[:, None] - 1 + karr[None, :] - W // 2
    tb_init = jnp.take_along_axis(
        targets, jnp.clip(cols_init, 0, Lt - 1), axis=1)

    def row(carry, i):
        Hprev, Eprev, tbwin, best, bi, bk = carry
        pb = probes[:, i][:, None]                       # [B,1]
        cols = diag0[:, None] + i + karr[None, :] - W // 2
        okc = (cols >= 0) & (cols < tlens[:, None])
        newc = diag0 + i + (W - 1) - W // 2
        nc = targets[barr, jnp.clip(newc, 0, Lt - 1)]
        tb = jnp.concatenate([tbwin[:, 1:], nc[:, None]], axis=1)
        okp = (i < plens)[:, None] & (pb < 4) & okc & (tb < 4)
        sub = jnp.where(okp, jnp.where(pb == tb, match, mismatch), NEG)

        Hup = jnp.concatenate([Hprev[:, 1:],
                               jnp.full((B, 1), NEG, jnp.int32)], axis=1)
        Eup = jnp.concatenate([Eprev[:, 1:],
                               jnp.full((B, 1), NEG, jnp.int32)], axis=1)
        e_open = Hup + gap_open
        e_ext = Eup + gap_ext
        E = jnp.maximum(e_open, e_ext)
        eext = e_ext >= e_open

        diag = Hprev + sub
        H0 = jnp.maximum(jnp.maximum(diag, E), 0)
        dirb = jnp.where(H0 == 0, 0, jnp.where(H0 == diag, 1, 2))

        # lazy-F: F[k] = max_{m<k} (H0[m] + open + (k-m-1)*ext)
        X = H0 + gap_open - (karr[None, :] + 1) * gap_ext
        M = jax.lax.associative_scan(jnp.maximum, X, axis=1)
        Mx = jnp.concatenate([jnp.full((B, 1), NEG, jnp.int32),
                              M[:, :-1]], axis=1)
        Xx = jnp.concatenate([jnp.full((B, 1), NEG, jnp.int32),
                              X[:, :-1]], axis=1)
        F = Mx + karr[None, :] * gap_ext
        fext = Mx > Xx
        Hf = jnp.maximum(H0, F)
        usedf = F > H0

        rb = jnp.max(Hf, axis=1)
        rk = jnp.argmax(Hf, axis=1).astype(jnp.int32)
        improve = rb > best
        best = jnp.where(improve, rb, best)
        bi = jnp.where(improve, i, bi)
        bk = jnp.where(improve, rk, bk)

        out = None
        if traceback:
            out = (dirb.astype(jnp.uint8)
                   | (usedf.astype(jnp.uint8) << 2)
                   | (eext.astype(jnp.uint8) << 3)
                   | (fext.astype(jnp.uint8) << 4))
        return (Hf, E, tb, best, bi, bk), out

    H0 = jnp.zeros((B, W), jnp.int32)
    E0 = jnp.full((B, W), NEG, jnp.int32)
    z = jnp.zeros((B,), jnp.int32)
    (Hl, El, _tbl, best, bi, bk), ptrs = jax.lax.scan(
        row, (H0, E0, tb_init, z, z, z), jnp.arange(Lp, dtype=jnp.int32))
    return best, bi, bk, ptrs


@functools.partial(jax.jit, static_argnames=("W", "L_OPS"))
def _traceback_dev(ptrs, probes, targets, best, bi, bk, diag0, *,
                   W: int, L_OPS: int):
    """ON-DEVICE traceback over the resident pointer array (round 5):
    fetching the [Lp, B, W] pointer matrix cost ~2 GB over the host link
    per realistic-scale SW batch (20 Kbp reads x band 3000); the
    vmapped while_loop walks it device-side and returns ~L_OPS bytes of
    reverse-order op codes (1=M 2=D 3=I) per lane plus the start
    coordinates and match counts."""
    Lp = ptrs.shape[0]

    def one(P, probe, target, sc, pi, pk, d0):
        Lt = target.shape[0]
        Lq = probe.shape[0]

        def cond(st):
            i, c, state, n, ops, nm, nmm, stop = st
            k = c - i - d0 + W // 2
            return ((~stop) & (i >= 0) & (c >= 0) & (k >= 0) & (k < W)
                    & (n < L_OPS))

        def body(st):
            i, c, state, n, ops, nm, nmm, stop = st
            k = jnp.clip(c - i - d0 + W // 2, 0, W - 1)
            byte = P[jnp.clip(i, 0, Lp - 1), k].astype(jnp.int32)
            is_h0 = state == 1
            is_e = state == 2
            is_f = state == 3
            d = byte & 3
            ns = jnp.where(state == 0,
                           jnp.where((byte & 4) != 0, 3, 1),
                           jnp.where(is_h0, jnp.where(d == 1, 0, 2),
                                     jnp.where(is_e,
                                               jnp.where((byte & 8) != 0,
                                                         2, 0),
                                               jnp.where((byte & 16) != 0,
                                                         3, 1))))
            stop2 = is_h0 & (d == 0)
            opM = is_h0 & (d == 1)
            op = jnp.where(opM, 1, jnp.where(is_e, 2,
                                             jnp.where(is_f, 3, 0)))
            emit = (op > 0) & ~stop2
            match = (probe[jnp.clip(i, 0, Lq - 1)]
                     == target[jnp.clip(c, 0, Lt - 1)])
            nm = nm + jnp.where(emit & opM & match, 1, 0)
            nmm = nmm + jnp.where(emit & opM & ~match, 1, 0)
            nc = jnp.clip(n, 0, L_OPS - 1)
            ops = ops.at[nc].set(jnp.where(emit, op.astype(jnp.int8),
                                           ops[nc]))
            n = n + emit.astype(jnp.int32)
            di = jnp.where(emit & (opM | is_e), -1, 0)
            dc = jnp.where(emit & (opM | is_f), -1, 0)
            return (i + di, c + dc, ns, n, ops, nm, nmm, stop | stop2)

        i0 = pi
        c0 = d0 + pi + pk - W // 2
        init = (i0, c0, jnp.int32(0), jnp.int32(0),
                jnp.zeros(L_OPS, jnp.int8), jnp.int32(0), jnp.int32(0),
                sc <= 0)
        i, c, _, n, ops, nm, nmm, _ = jax.lax.while_loop(cond, body, init)
        return ops, n, i + 1, c + 1, nm, nmm

    return jax.vmap(one, in_axes=(1, 0, 0, 0, 0, 0, 0))(
        ptrs, probes, targets, best, bi, bk, diag0)


@dataclass
class SWAlignment:
    score: int
    p_start: int          # aligned probe range [p_start, p_end)
    p_end: int
    t_start: int          # aligned target range [t_start, t_end)
    t_end: int
    ops: list             # [(op, length)] op in "M D I" probe-major
    matches: int = 0
    mismatches: int = 0


def banded_sw_batch(probes: np.ndarray, plens: np.ndarray,
                    targets: np.ndarray, tlens: np.ndarray,
                    diag0: np.ndarray, *, band: int = 256,
                    scores: SWScores = SWScores(),
                    traceback: bool = True):
    """Align each (probe[b], target[b]) pair in a band of width `band`
    centered on target_col = probe_row + diag0[b]. Arrays are code matrices
    padded with 0x0F. Returns list[SWAlignment] (ops empty when
    traceback=False)."""
    B, Lp = probes.shape
    W = band
    # bucket shapes to multiples of 512 so jit caches across ragged batches
    Lp_p = -(-max(Lp, 1) // 512) * 512
    Lt_p = -(-max(targets.shape[1], 1) // 512) * 512
    if Lp_p != Lp:
        probes = np.pad(probes, ((0, 0), (0, Lp_p - Lp)),
                        constant_values=0x0F)
    if Lt_p != targets.shape[1]:
        targets = np.pad(targets, ((0, 0), (0, Lt_p - targets.shape[1])),
                         constant_values=0x0F)
    Lp = Lp_p
    best, bi, bk, ptrs = _sw_scan(
        jnp.asarray(probes), jnp.asarray(targets),
        jnp.asarray(plens, np.int32), jnp.asarray(tlens, np.int32),
        jnp.asarray(diag0, np.int32), W=W, Lp=Lp, traceback=traceback,
        match=scores.match, mismatch=scores.mismatch,
        gap_open=scores.gap_open, gap_ext=scores.gap_ext)
    if not traceback:
        best = np.asarray(jax.device_get(best))
        return [SWAlignment(int(best[b]), 0, 0, 0, 0, []) for b in range(B)]
    # on-device traceback: only op codes + coords cross the link (the
    # pointer matrix itself is [Lp, B, W] — ~2 GB at realistic scale)
    L_OPS = Lp + W
    ops_d, n_d, ps_d, ts_d, nm_d, nmm_d = _traceback_dev(
        ptrs, jnp.asarray(probes), jnp.asarray(targets), best, bi, bk,
        jnp.asarray(diag0, np.int32), W=W, L_OPS=L_OPS)
    best = np.asarray(jax.device_get(best))
    bi = np.asarray(jax.device_get(bi))
    bk = np.asarray(jax.device_get(bk))
    OPS, NN, PS, TS, NM, NMM = (np.asarray(jax.device_get(x)) for x in
                                (ops_d, n_d, ps_d, ts_d, nm_d, nmm_d))
    out = []
    opc = {1: "M", 2: "D", 3: "I"}
    for b in range(B):
        sc = int(best[b])
        if sc <= 0:
            out.append(SWAlignment(0, 0, 0, 0, 0, []))
            continue
        rops = OPS[b, :int(NN[b])][::-1]
        ops = []
        if len(rops):
            # run-length collapse (vectorized boundaries)
            bnd = np.nonzero(np.concatenate(
                [[True], rops[1:] != rops[:-1]]))[0]
            lens = np.diff(np.concatenate([bnd, [len(rops)]]))
            ops = [(opc[int(rops[j])], int(ln))
                   for j, ln in zip(bnd, lens)]
        i_end = int(bi[b])
        c_end = int(diag0[b]) + i_end + int(bk[b]) - W // 2
        out.append(SWAlignment(sc, int(PS[b]), i_end + 1, int(TS[b]),
                               c_end + 1, ops, int(NM[b]), int(NMM[b])))
    return out


def _traceback_one(P, score, pi, pk, diag0, W, probe, target) -> SWAlignment:
    if score <= 0:
        return SWAlignment(0, 0, 0, 0, 0, [])
    i, c = pi, diag0 + pi + pk - W // 2
    p_end, t_end = i + 1, c + 1
    rops = []
    state = "H"
    nm = nmm = 0
    while i >= 0 and c >= 0:
        k = c - i - diag0 + W // 2
        if k < 0 or k >= W:
            break
        byte = int(P[i, k])
        if state == "H":
            state = "F" if byte & 4 else "H0"
            continue
        if state == "H0":
            d = byte & 3
            if d == 0:
                break
            if d == 1:
                rops.append("M")
                if probe[i] == target[c]:
                    nm += 1
                else:
                    nmm += 1
                i -= 1
                c -= 1
                state = "H"
            else:
                state = "E"
            continue
        if state == "E":
            rops.append("D")
            state = "E" if byte & 8 else "H"
            i -= 1
            continue
        # state F
        rops.append("I")
        state = "F" if byte & 16 else "H0"
        c -= 1
    ops = []
    for op in reversed(rops):
        if ops and ops[-1][0] == op:
            ops[-1][1] += 1
        else:
            ops.append([op, 1])
    return SWAlignment(score, i + 1, p_end, c + 1, t_end,
                       [(o, n) for o, n in ops], nm, nmm)


def sw_oracle(p: np.ndarray, t: np.ndarray,
              scores: SWScores = SWScores()) -> int:
    """Naive full-matrix affine local-alignment score for tests."""
    Lp, Lt = len(p), len(t)
    H = np.zeros((Lp + 1, Lt + 1), np.int32)
    E = np.full((Lp + 1, Lt + 1), int(NEG), np.int32)
    F = np.full((Lp + 1, Lt + 1), int(NEG), np.int32)
    best = 0
    for i in range(1, Lp + 1):
        for j in range(1, Lt + 1):
            E[i, j] = max(H[i - 1, j] + scores.gap_open,
                          E[i - 1, j] + scores.gap_ext)
            F[i, j] = max(H[i, j - 1] + scores.gap_open,
                          F[i, j - 1] + scores.gap_ext)
            s = scores.match if p[i - 1] == t[j - 1] else scores.mismatch
            H[i, j] = max(0, H[i - 1, j - 1] + s, E[i, j], F[i, j])
            best = max(best, H[i, j])
    return int(best)
