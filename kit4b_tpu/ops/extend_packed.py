"""2-bit-packed extension scoring — bandwidth-optimal mismatch counting.

Gathers cost ~per element on the XLA path, so the [B, nCand, L] byte
gather dominated align time. This module packs 16 bases per uint32 word
(genome once at index load; each read batch into all 16 alignment phases) so a
candidate extension is NW = (L+30)//16 word gathers + XOR/popcount, a ~12x
reduction in gathered elements and pure elementwise compute after that.

Semantics: mismatch count over the L-base window, where any invalid base
(N, chromosome sentinel, off-end) on either side counts as a mismatch — the
packed analog of the reference's per-base compare loop in
CSfxArray::LocateCoreMultiples extension (libkit4b/SfxArray.cpp:5845-…);
alignments spanning chromosome boundaries are rejected by their sentinel
mismatches exactly as EOS bases fail to match in the reference.
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

MISM_BITS = np.uint32(0x55555555)  # one flag bit per 2-bit base slot


def pack_genome(seq: np.ndarray, nw: int) -> tuple[np.ndarray, np.ndarray]:
    """Pack genome codes -> (gpack, gbad) uint32 arrays, padded by nw words.

    gpack: base i in bits [2*(i%16)] of word i//16 (low 2 bits of the code).
    gbad : bit 2*(i%16) set when base i is invalid (N/sentinel/beyond end).
    """
    g = np.asarray(seq, dtype=np.uint8)
    n = len(g)
    nwords = (n + 15) // 16 + nw
    base = np.zeros(nwords * 16, dtype=np.uint32)
    bad = np.ones(nwords * 16, dtype=np.uint32)  # off-end slots are invalid
    base[:n] = g & 3
    bad[:n] = g >= 4
    shifts = (2 * np.arange(16, dtype=np.uint32))[None, :]
    gpack = (base.reshape(-1, 16) << shifts).sum(axis=1, dtype=np.uint32)
    gbad = (bad.reshape(-1, 16) << shifts).sum(axis=1, dtype=np.uint32)
    return gpack, gbad


def phase_masks(read_len: int, nw: int) -> np.ndarray:
    """uint32 [16, nw]: flag bit 2m of word j set iff window-relative base
    16j + m - s lies within [0, read_len) for phase s."""
    out = np.zeros((16, nw), dtype=np.uint32)
    for s in range(16):
        for j in range(nw):
            for m in range(16):
                i = 16 * j + m - s
                if 0 <= i < read_len:
                    out[s, j] |= np.uint32(1) << np.uint32(2 * m)
    return out


def pack_read_phases(seqs: jnp.ndarray, nw: int, with_bad: bool = True):
    """seqs [B, S, L] uint8 -> (rpack, rbad) each [B, S*16, nw] uint32.

    Phase s is the read shifted s base-slots right so its packing lines up
    with genome words when the candidate position p has p % 16 == s.
    with_bad=False skips the read-side invalid mask (valid when the batch was
    screened to contain no Ns) and returns rbad=None.
    """
    B, S, L = seqs.shape
    ext = jnp.zeros((B, S, 16 * nw), dtype=jnp.uint8)
    ext = ext.at[:, :, :L].set(seqs)
    shifts = (2 * jnp.arange(16, dtype=jnp.uint32))[None, None, None, :]
    packs = []
    bads = []
    for s in range(16):
        r = jnp.roll(ext, s, axis=-1).reshape(B, S, nw, 16)
        packs.append(jnp.sum((r & 3).astype(jnp.uint32) << shifts, axis=-1,
                             dtype=jnp.uint32))
        if with_bad:
            bads.append(jnp.sum((r >= 4).astype(jnp.uint32) << shifts,
                                axis=-1, dtype=jnp.uint32))
    # [B, S, 16, nw] -> [B, S*16, nw] with index = strand*16 + phase
    rpack = jnp.stack(packs, axis=2).reshape(B, S * 16, nw)
    rbad = (jnp.stack(bads, axis=2).reshape(B, S * 16, nw)
            if with_bad else None)
    return rpack, rbad


def extend_packed(gpack: jnp.ndarray,    # [Gw] uint32 packed genome
                  gbad: jnp.ndarray,     # [Gw] uint32 packed invalid mask
                  rpack: jnp.ndarray,    # [B, S*16, nw] packed read phases
                  rbad: jnp.ndarray,     # [B, S*16, nw]
                  pmask: jnp.ndarray,    # [16, nw] uint32 phase masks
                  pos: jnp.ndarray,      # [B, NC] int32 window start positions
                  strand: jnp.ndarray,   # [B, NC] int32
                  *, read_len: int) -> jnp.ndarray:
    """Mismatch counts [B, NC] int32 for each (pos, strand) candidate."""
    B, NC = pos.shape
    nw = rpack.shape[-1]
    Gw = gpack.shape[0]

    w0 = jnp.clip(pos >> 4, 0, Gw - nw)                   # [B, NC]
    phase = (pos & 15).astype(jnp.int32)
    widx = w0[..., None] + jnp.arange(nw, dtype=jnp.int32)  # [B, NC, nw]
    gw = gpack[widx]
    gb = gbad[widx]

    sel = strand * 16 + phase                              # [B, NC]
    rp = jnp.take_along_axis(rpack, sel[..., None], axis=1)
    pm = pmask[phase]                                      # [B, NC, nw]

    x = gw ^ rp
    mism = (x | (x >> 1)) & MISM_BITS
    badb = gb & MISM_BITS
    if rbad is not None:
        rb = jnp.take_along_axis(rbad, sel[..., None], axis=1)
        badb = badb | (rb & MISM_BITS)
    bits = (mism | badb) & pm
    return jnp.sum(jax.lax.population_count(bits), axis=-1,
                   dtype=jnp.int32)
