"""Min-matmul engine for exhaustive genome-wide K-mer Hamming distances.

The reference computes, for every K-mer window position, the minimum Hamming
distance to every other window (sense) and to every reverse-complement window
(antisense) via O(G) rolling sweeps per relative offset
(ngskit4b/hammings.cpp:3183 GHamDistWatson/GHamDistCrick) — O(G^2) scalar
updates on CPU clusters. Here the whole computation is a dense int8 matrix
product:

  encode every window i as a one-hot row  W[i, 5k+b] = [genome[i+k] == b]
  (5 channels per base so N==N counts as a match, exactly like the scalar
  sweep's code-equality compare; width 5K padded to a 128 multiple), then

      matches[i, j] = (W @ W^T)[i, j]      and      ws[i, j] = K - matches

so a window's minimum Hamming distance is K minus its row maximum of
`matches` (self-pair excluded). Only that row maximum is needed, which
`max_matches` computes by one of two implementations, chosen per backend by
`max_matches_impl`:

- "kernel" (GPU): a Pallas kernel through the Triton route. Each block owns
  `KERNEL_T` rows of W and loops over partner blocks of `KERNEL_S` rows; each
  step is one int8 x int8 -> int32 tensor-core product whose row maxima are
  folded into a running max held in registers, so the [R, G] product never
  reaches device memory.
- "xla" (CPU): plain `lax.dot_general` on int8 operands with int32
  accumulation, one partner span at a time, then a row max. It is also the
  plain reference the kernel is checked against.

Sentinel windows (any code >= BASE_UNDEF inside) get an all-zero row: their
ws against anything is exactly K, which can never under-report a true
minimum (true window Hamming <= K whenever any valid partner exists); their
own output positions are masked to 0xFFFF afterwards. The sense self-pair is
masked on the product's diagonal.

Multi-node partitioning (hammings -n/-N, ngskit4b/hammings.cpp:99-106) is
preserved: nodes take disjoint partner-span ranges and `merge` remains an
elementwise min.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

BIG32 = np.int32(1 << 20)
OUT_BIG = np.uint16(0xFFFF)

# Partner rows per span: the unit of padding, node partitioning and the
# plain implementation's product width.
PART = 1024
# Kernel tiling: own rows per block, partner rows per step, launch shape.
KERNEL_T = 128
KERNEL_S = 128
KERNEL_WARPS = 8
KERNEL_STAGES = 3
# Grid size below which the kernel also splits the partner spans over a
# second grid axis, so that small inputs still fill the card's SMs.
KERNEL_MIN_BLOCKS = 1024


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def window_onehot(codes: np.ndarray, K: int, Gp: int,
                  dtype=np.int8) -> tuple[np.ndarray, np.ndarray]:
    """Host/NumPy builder of the window one-hot matrix W
    [Gp, 128*ceil(5K/128)] and the window-validity mask [Gp] (in-range and
    sentinel-free; N is valid). Kept for tests; the device path uses
    _window_onehot_dev."""
    G = len(codes)
    C = _round_up(5 * K, 128)
    W = np.zeros((Gp, C), dtype)
    pad = np.full(K, 0x0F, np.uint8)  # EOG sentinel padding
    ext = np.concatenate([np.asarray(codes, np.uint8), pad])
    nk = max(0, G - K + 1)
    valid = np.zeros(Gp, bool)
    if nk:
        sent = ext >= 5
        # windowed any-sentinel via cumsum
        cs = np.concatenate([[0], np.cumsum(sent[: G])])
        nbad = cs[K:] - cs[: G - K + 1] if G >= K else np.zeros(0, np.int64)
        valid[:nk] = nbad == 0
        for k in range(K):
            col = ext[k: k + Gp]
            for b in range(5):
                W[:nk, 5 * k + b] = (col[:nk] == b)
        W[~valid] = 0
    return W, valid


def _window_onehot_dev(ext: jnp.ndarray, K: int, Gp: int, G: int):
    """Device builder: ext is codes padded to Gp+K with EOG. Returns
    (W [Gp, C] int8, valid [Gp] bool).

    Channel c encodes (k=c//5, b=c%5); W is built as one gather+compare over
    all C channels, never materializing narrow [Gp, 5] or [Gp, K] slices."""
    C = _round_up(5 * K, 128)
    win = jnp.stack([jax.lax.dynamic_slice_in_dim(ext, k, Gp)
                     for k in range(K)], axis=1)          # [Gp, K] uint8
    kidx = np.minimum(np.arange(C) // 5, K - 1)
    bval = np.where(np.arange(C) < 5 * K, np.arange(C) % 5, 255)
    W = (jnp.take(win, jnp.asarray(kidx), axis=1)
         == jnp.asarray(bval, ext.dtype)[None, :]).astype(jnp.int8)
    sent = (ext >= 5).astype(jnp.int32)
    cs = jnp.concatenate([jnp.zeros(1, jnp.int32), jnp.cumsum(sent)])
    nbad = jax.lax.dynamic_slice_in_dim(cs, K, Gp) - cs[:Gp]
    idx = jnp.arange(Gp, dtype=jnp.int32)
    valid = (nbad == 0) & (idx < G - K + 1)
    return W * valid[:, None].astype(jnp.int8), valid


def max_matches_impl(backend: str | None = None) -> str:
    """The one place the max-matches implementation is chosen: the Pallas
    kernel on the GPU, plain XLA on the CPU. Any other backend raises."""
    backend = jax.default_backend() if backend is None else backend
    if backend == "gpu":
        return "kernel"
    if backend == "cpu":
        return "xla"
    raise NotImplementedError(
        f"hammings: no max-matches implementation for backend {backend!r}")


def max_matches(W_own, W_part, *, part_lo: int, part_cnt: int, diag: bool,
                row_base, impl: str, interpret: bool = False):
    """[R] int32: per row of W_own [R, C], the maximum match count against
    partner rows [part_lo, part_lo + part_cnt) of W_part (multiples of
    PART). With diag, each row's pair with itself (global row
    row_base[0] + i of W_part) is excluded. row_base: [1] int32."""
    if impl == "kernel":
        return _max_matches_kernel(W_own, W_part, part_lo=part_lo,
                                   part_cnt=part_cnt, diag=diag,
                                   row_base=row_base, interpret=interpret)
    if impl == "xla":
        return _max_matches_xla(W_own, W_part, part_lo=part_lo,
                                part_cnt=part_cnt, diag=diag,
                                row_base=row_base)
    raise ValueError(f"hammings: unknown max-matches implementation {impl!r}")


def _max_matches_xla(W_own, W_part, *, part_lo, part_cnt, diag, row_base):
    R = W_own.shape[0]
    rows = jnp.arange(R, dtype=jnp.int32) + row_base[0]

    def body(s, acc):
        off = part_lo + s * PART
        wp = jax.lax.dynamic_slice_in_dim(W_part, off, PART)
        m = jax.lax.dot_general(W_own, wp, (((1,), (1,)), ((), ())),
                                preferred_element_type=jnp.int32)
        if diag:
            cols = off + jnp.arange(PART, dtype=jnp.int32)
            m = jnp.where(rows[:, None] == cols[None, :], -BIG32, m)
        return jnp.maximum(acc, jnp.max(m, axis=1))

    init = jnp.full((R,), -BIG32, jnp.int32)
    return jax.lax.fori_loop(0, part_cnt // PART, body, init)


def _kernel(rb_ref, wo_ref, wp_ref, out_ref, *, T, S, blk_lo, steps, diag):
    """One block: own rows [t*T, (t+1)*T) against `steps` partner blocks of
    S rows starting at block blk_lo + p*steps. Writes the row maxima."""
    t = pl.program_id(0)
    p = pl.program_id(1)
    wo = wo_ref[...]                                     # [T, C] int8
    row0 = rb_ref[0] + t * T
    first = blk_lo + p * steps

    def masked(m, col0):
        rows = row0 + jax.lax.broadcasted_iota(jnp.int32, (T, S), 0)
        cols = col0 + jax.lax.broadcasted_iota(jnp.int32, (T, S), 1)
        return jnp.where(rows == cols, -BIG32, m)

    def body(i, acc):
        col0 = (first + i) * S
        wp = wp_ref[pl.ds(col0, S), :]                   # [S, C] int8
        m = pl.dot(wo, wp, trans_b=True)                 # [T, S] int32
        if diag:
            on_diag = (row0 < col0 + S) & (col0 < row0 + T)
            m = jax.lax.cond(on_diag, masked, lambda m, _: m, m, col0)
        return jnp.maximum(acc, jnp.max(m, axis=1))

    out_ref[...] = jax.lax.fori_loop(0, steps, body,
                                     jnp.full((T,), -BIG32, jnp.int32))


def _kernel_splits(n_tiles: int, n_blocks: int) -> int:
    """Partner-span splits: the largest divisor of n_blocks that brings the
    grid to KERNEL_MIN_BLOCKS blocks."""
    want = max(1, -(-KERNEL_MIN_BLOCKS // n_tiles))
    return max(d for d in range(1, min(want, n_blocks) + 1)
               if n_blocks % d == 0)


def _max_matches_kernel(W_own, W_part, *, part_lo, part_cnt, diag, row_base,
                        interpret=False):
    T, S = KERNEL_T, KERNEL_S
    R, C = W_own.shape
    n_tiles = R // T
    n_blocks = part_cnt // S
    P = _kernel_splits(n_tiles, n_blocks)
    kern = functools.partial(_kernel, T=T, S=S, blk_lo=part_lo // S,
                             steps=n_blocks // P, diag=diag)
    out = pl.pallas_call(
        kern,
        grid=(n_tiles, P),
        in_specs=[
            pl.BlockSpec((1,), lambda t, p: (0,)),
            pl.BlockSpec((T, C), lambda t, p: (t, 0)),
            pl.BlockSpec(W_part.shape, lambda t, p: (0, 0)),
        ],
        out_specs=pl.BlockSpec((None, T), lambda t, p: (p, t)),
        out_shape=jax.ShapeDtypeStruct((P, R), jnp.int32),
        compiler_params=pl_triton.CompilerParams(
            num_warps=KERNEL_WARPS, num_stages=KERNEL_STAGES),
        backend="triton",
        interpret=interpret,
        name="hammings_max_matches",
    )(jnp.asarray(row_base, jnp.int32), W_own, W_part)
    return jnp.max(out, axis=0)


@functools.partial(jax.jit, static_argnames=("K", "Gp", "G", "rc"))
def _build_w(ext, *, K, Gp, G, rc):
    if rc:
        grev = ext[:G][::-1]
        c = jnp.where(grev < 4, 3 - grev, grev)
        ext = jnp.concatenate([c, jnp.full(Gp + K - G, 0x0F, c.dtype)])
    return _window_onehot_dev(ext, K, Gp, G)


@functools.partial(jax.jit, static_argnames=(
    "R", "diag", "lo", "cnt", "impl", "interpret"))
def _chunk_maxm(W, W_part, row_base, *, R, diag, lo, cnt, impl, interpret):
    """Max matches for own rows [row_base, row_base+R) vs partner rows
    [lo, lo+cnt); reduced to [R] so only small partials live in HBM."""
    wo = jax.lax.dynamic_slice_in_dim(W, row_base[0], R)
    return max_matches(wo, W_part, part_lo=lo, part_cnt=cnt, diag=diag,
                       row_base=row_base, impl=impl, interpret=interpret)


def hammings_exhaustive_mxu(genome_seq: np.ndarray, K: int, *,
                            antisense: bool = True,
                            node: int = 0, numnodes: int = 1,
                            row_chunk: int = 1 << 21,
                            impl: str | None = None,
                            interpret: bool = False) -> np.ndarray:
    """Min window-Hamming per position (uint16 [G]; 0xFFFF where no valid
    window). Node n of N takes partner spans [n*cnt, ...) — partials
    merge with elementwise min exactly like the reference's ePMmerge.

    Own rows are processed in `row_chunk` slices, so device memory holds W
    (+Wrc) and one chunk's partials. impl: "kernel" or "xla"; None takes
    max_matches_impl(). interpret runs the kernel in interpret mode."""
    g = np.ascontiguousarray(genome_seq, np.uint8)
    G = len(g)
    nk = G - K + 1
    out = np.full(G, OUT_BIG, np.uint16)
    if nk <= 0:
        return out
    impl = max_matches_impl() if impl is None else impl

    Gp = _round_up(max(G, PART), PART)
    n_spans = Gp // PART
    lo = (node * n_spans) // numnodes
    hi = ((node + 1) * n_spans) // numnodes
    if hi <= lo:
        return out

    ext = jnp.asarray(np.concatenate(
        [g, np.full(Gp + K - G, 0x0F, np.uint8)]))
    W, valid = _build_w(ext, K=K, Gp=Gp, G=G, rc=False)
    parts = [(W, True)]
    if antisense:
        Wrc, _ = _build_w(ext, K=K, Gp=Gp, G=G, rc=True)
        parts.append((Wrc, False))
    R = min(Gp, _round_up(row_chunk, PART))
    maxm = np.full(Gp, -BIG32, np.int32)
    for rb in range(0, Gp, R):
        if rb + R > Gp:
            rb = Gp - R       # overlap tail chunk; max is idempotent
        base = jnp.asarray([rb], jnp.int32)
        mm = None
        for W_part, diag in parts:
            m = _chunk_maxm(W, W_part, base, R=R, diag=diag, lo=lo * PART,
                            cnt=(hi - lo) * PART, impl=impl,
                            interpret=interpret)
            mm = m if mm is None else jnp.maximum(mm, m)
        maxm[rb: rb + R] = np.asarray(jax.device_get(mm))
        if rb + R >= Gp:
            break
    hv = np.asarray(jax.device_get(valid))
    nvalid = int(hv.sum())
    if nvalid == 0 or (not antisense and nvalid < 2):
        # no partner exists; all-zero invalid/padded rows would report K
        return out
    h = np.where(hv[:G], np.minimum(K - maxm[:G], int(OUT_BIG)),
                 int(OUT_BIG))
    return h.astype(np.uint16)
