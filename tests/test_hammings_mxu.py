"""Min-matmul hammings engine vs the naive oracle: the plain XLA path, the
Pallas kernel in interpret mode, the kernel choice, the wrapper's padding
and row chunking, node-partitioned merge."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kit4b_tpu.kmer import hammings_mxu as H
from kit4b_tpu.kmer.hammings import hammings_oracle, merge
from kit4b_tpu.kmer.hammings_mxu import hammings_exhaustive_mxu


def _genome(n=900, seed=3):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, n).astype(np.uint8)
    g[n // 3] = 7          # EOS chrom separator
    g[rng.integers(0, n, 8)] = 4   # N bases (valid, N==N matches)
    return g


@pytest.mark.parametrize("K", [7, 25])
@pytest.mark.parametrize("anti", [True, False])
def test_mxu_xla_matches_oracle(K, anti):
    g = _genome()
    want = hammings_oracle(g, K, antisense=anti)
    got = hammings_exhaustive_mxu(g, K, antisense=anti, impl="xla")
    assert np.array_equal(want, got)


@pytest.mark.parametrize("anti", [True, False])
@pytest.mark.parametrize("n_run", [False, True])
def test_mxu_pallas_interpret_matches_oracle(anti, n_run):
    g = _genome(700, seed=5)
    if n_run:
        g[400:430] = 4     # a run of Ns
        g[-1] = 7          # EOS at the end
    want = hammings_oracle(g, 25, antisense=anti)
    got = hammings_exhaustive_mxu(g, 25, antisense=anti, impl="kernel",
                                  interpret=True)
    assert np.array_equal(want, got)


def _onehots(n, K, seed):
    g = _genome(n, seed=seed)
    Gp = H._round_up(n, H.PART)
    ext = jnp.asarray(np.concatenate([g, np.full(Gp + K - n, 0x0F,
                                                 np.uint8)]))
    W, _ = H._build_w(ext, K=K, Gp=Gp, G=n, rc=False)
    Wrc, _ = H._build_w(ext, K=K, Gp=Gp, G=n, rc=True)
    return W, Wrc


@pytest.mark.parametrize("min_blocks,splits", [(8, 1), (16, 2), (64, 8)])
@pytest.mark.parametrize("diag", [True, False])
def test_kernel_partner_split_matches_xla(monkeypatch, min_blocks, splits,
                                          diag):
    """Own rows [1024, 2048) (8 tiles) against partner rows [1024, 3072)
    (16 blocks), with the partner spans split over 1, 2 or 8 grid
    columns."""
    monkeypatch.setattr(H, "KERNEL_MIN_BLOCKS", min_blocks)
    assert H._kernel_splits(1024 // H.KERNEL_T, 2048 // H.KERNEL_S) == splits
    W, Wrc = _onehots(3000, 25, seed=9)
    W_part = W if diag else Wrc
    wo = W[1024:2048]
    kw = dict(part_lo=1024, part_cnt=2048, diag=diag,
              row_base=jnp.asarray([1024], jnp.int32))
    want = H._max_matches_xla(wo, W_part, **kw)
    got = H._max_matches_kernel(wo, W_part, interpret=True, **kw)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_kernel_splits_fill_grid():
    # few own-row tiles: split the partner blocks up to the grid target
    assert H._kernel_splits(8, 16) == 16
    assert H._kernel_splits(8, 24) == 24
    # a divisor of the block count, never above what the grid needs
    assert H._kernel_splits(100, 24) == 8
    # enough own-row tiles: no split
    assert H._kernel_splits(H.KERNEL_MIN_BLOCKS, 64) == 1


@pytest.mark.parametrize("backend,impl", [("gpu", "kernel"), ("cpu", "xla")])
def test_max_matches_impl_by_backend(backend, impl):
    assert H.max_matches_impl(backend) == impl


@pytest.mark.parametrize("backend", ["rocm", "metal", "interpreter"])
def test_max_matches_impl_unknown_backend_raises(backend):
    with pytest.raises(NotImplementedError, match=backend):
        H.max_matches_impl(backend)


def test_max_matches_impl_default_is_this_backend():
    assert jax.default_backend() == "cpu"
    assert H.max_matches_impl() == "xla"


def test_max_matches_rejects_unknown_impl():
    W, _ = _onehots(1000, 9, seed=1)
    with pytest.raises(ValueError, match="unknown"):
        H.max_matches(W, W, part_lo=0, part_cnt=1024, diag=True,
                      row_base=np.zeros(1, np.int32), impl="pallas")


@pytest.mark.parametrize("n,row_chunk", [
    (1025, 1 << 21),    # one row past a span: padded to two spans
    (3000, 1024),       # three exact chunks
    (2100, 2048),       # second chunk overlaps the first (tail chunk)
    (4500, 3072),       # tail chunk overlap with a 5-span genome
])
@pytest.mark.parametrize("impl", ["xla", "kernel"])
def test_wrapper_padding_and_tail_chunk(n, row_chunk, impl):
    g = _genome(n, seed=n)
    want = hammings_oracle(g, 11)
    got = hammings_exhaustive_mxu(g, 11, row_chunk=row_chunk, impl=impl,
                                  interpret=(impl == "kernel"))
    assert got.shape == (n,) and got.dtype == np.uint16
    np.testing.assert_array_equal(got, want)


def test_mxu_node_partition_merge():
    g = _genome(1100, seed=7)
    full = hammings_exhaustive_mxu(g, 13, impl="xla")
    parts = [hammings_exhaustive_mxu(g, 13, impl="xla",
                                     node=i, numnodes=3) for i in range(3)]
    assert np.array_equal(full, merge(*parts))


def test_mxu_tiny_and_all_invalid():
    # genome shorter than K
    assert hammings_exhaustive_mxu(np.zeros(5, np.uint8), 9).shape == (5,)
    # all-sentinel genome: everything invalid
    g = np.full(300, 7, np.uint8)
    out = hammings_exhaustive_mxu(g, 9, impl="xla")
    assert (out == 0xFFFF).all()


@pytest.mark.gpu
def test_kernel_matches_xla_on_gpu():
    """Compiled kernel vs the plain version at 64 kbp on the card."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU; chip_smoke.py runs this comparison "
                    "at 2 Mbp on the card")
    g = _genome(64_000, seed=17)
    want = hammings_exhaustive_mxu(g, 25, impl="xla")
    got = hammings_exhaustive_mxu(g, 25, impl="kernel")
    np.testing.assert_array_equal(got, want)
