"""Ring-rotation hammings (parallel/hammings_ring.py): bit-identity with
the replicated min-matmul engine on 2/4/8-device CPU meshes."""
import numpy as np
import pytest

import jax

from kit4b_tpu.kmer.hammings_mxu import hammings_exhaustive_mxu
from kit4b_tpu.parallel.hammings_ring import hammings_ring


def _genome(n, seed=7, with_n=True):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, n).astype(np.uint8)
    if with_n:
        g[n // 3: n // 3 + 40] = 4          # N run
        g[: 25] = 4                          # leading Ns
    return g


@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_ring_matches_replicated(ndev):
    g = _genome(6000)
    K = 13
    want = hammings_exhaustive_mxu(g, K, antisense=True)
    devs = jax.devices()[:ndev]
    got = hammings_ring(g, K, antisense=True, devices=devs)
    assert got.dtype == np.uint16 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_ring_watson_only():
    g = _genome(4000, seed=11)
    K = 25
    want = hammings_exhaustive_mxu(g, K, antisense=False)
    got = hammings_ring(g, K, antisense=False, devices=jax.devices()[:4])
    np.testing.assert_array_equal(got, want)


def test_ring_repeat_dense():
    # planted exact repeats -> hamming 0 islands must survive the ring
    rng = np.random.default_rng(3)
    g = rng.integers(0, 4, 5000).astype(np.uint8)
    unit = rng.integers(0, 4, 200).astype(np.uint8)
    g[100:300] = unit
    g[3100:3300] = unit                      # cross-block exact copy
    K = 17
    want = hammings_exhaustive_mxu(g, K, antisense=True)
    got = hammings_ring(g, K, antisense=True, devices=jax.devices()[:8])
    np.testing.assert_array_equal(got, want)
    assert (want[100:300 - K + 1] == 0).all()


def test_ring_tiny_edge():
    g = _genome(30, with_n=False)
    got = hammings_ring(g, 25, devices=jax.devices()[:2])
    want = hammings_exhaustive_mxu(g, 25)
    np.testing.assert_array_equal(got, want)
