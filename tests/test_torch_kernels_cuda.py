"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports only torch, numpy and the port (the machine with the card has no
JAX), so it runs there as ``python -m pytest -q tests/test_torch_kernels_cuda.py``.
Without CUDA every test skips: a CUDA kernel has no CPU mode. Policy as in
PERF.md: hash64 and voronoi_assign bitwise (the kernel repeats the plain
version's rounding), st_scan count/min/max bitwise and sum to rtol 1e-5.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import hashing, voronoi
from repro_torch.core.datastore import make_pred
from repro_torch.data.synthetic import CityConfig, make_sites
from repro_torch.kernels.hash64 import ops as hops
from repro_torch.kernels.st_scan import ops as st_ops
from repro_torch.kernels.st_scan import ref as st_ref
from repro_torch.kernels.voronoi_assign import ops as vops


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the port's kernels have no CPU mode)")
    return torch.device("cuda")


def _i32(rng, n):
    return rng.integers(-2**31, 2**31, n).astype(np.int32)


def test_hash64_kernel_matches_plain(cuda):
    rng = np.random.default_rng(3)
    hi = torch.from_numpy(_i32(rng, 100_000)).to(cuda)
    lo = torch.from_numpy(_i32(rng, 100_000)).to(cuda)
    before = hops.launches
    for n in (1, 8, 80, 65535):
        for h in (hi, None):
            assert torch.equal(hops.xxh64_mod(h, lo, n),
                               hashing.xxh64_mod_plain(h, lo, n))
    assert hops.launches == before + 8


def test_voronoi_kernel_matches_plain(cuda):
    rng = np.random.default_rng(10)
    city = CityConfig()
    sites = torch.from_numpy(make_sites(80, city, seed=3)).to(cuda)
    pts = torch.from_numpy(rng.uniform([city.lat_min, city.lon_min],
                                       [city.lat_max, city.lon_max],
                                       (50_000, 2)).astype(np.float32)).to(cuda)
    before = vops.launches
    got = voronoi.hash_spatial(pts[:, 0], pts[:, 1], sites)
    assert vops.launches == before + 1
    assert torch.equal(got, voronoi.voronoi_assign(pts, sites))


@pytest.mark.parametrize("q,channels", [(3, (0,)), (9, (0, 1, 2, 3)),
                                        (5, (2, 0, 3)), (8, (0, 1, 2, 3, 4, 5))])
def test_st_scan_kernel_matches_plain(cuda, q, channels):
    rng = np.random.default_rng(q)
    e, w, c, l = 6, 9, 3000, 16
    t = lambda x: torch.from_numpy(x).to(cuda)
    args = (t(rng.uniform(0, 100, (e, w, c)).astype(np.float32)),
            t(rng.integers(0, 6, (e, 2, c)).astype(np.int32)),
            t(rng.integers(0, 2 * c, e).astype(np.int32)),
            make_pred(q=q, lat0=rng.uniform(0, 50, q), lat1=rng.uniform(50, 100, q),
                      lon0=rng.uniform(0, 50, q), lon1=rng.uniform(50, 100, q),
                      t0=rng.uniform(0, 50, q), t1=rng.uniform(50, 100, q),
                      sid_hi=rng.integers(0, 6, q), sid_lo=rng.integers(0, 6, q),
                      has_spatial=rng.random(q) < 0.7,
                      has_temporal=rng.random(q) < 0.7,
                      has_sid=rng.random(q) < 0.3, is_and=rng.random(q) < 0.7,
                      device=cuda),
            t(rng.integers(0, 6, (q, e, l, 2)).astype(np.int32)),
            t(rng.integers(-1, l + 1, (q, e)).astype(np.int32)))
    before = st_ops.launches
    got = st_ops.st_scan(*args, channels=channels, valid_c=2900)
    assert st_ops.launches == before + -(-len(channels) // st_ops.MAX_K)
    want = st_ref.st_scan_ref(*args, channels=channels, valid_c=2900)
    assert torch.equal(got[0], want[0])
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=0)
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])


def test_wrappers_refuse_cpu_tensors_for_kernels(cuda):
    x = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        hops.xxh64_mod_cuda(None, x, 8)
    with pytest.raises(ValueError, match="CUDA"):
        vops.voronoi_assign_cuda(x.float(), x.float(), torch.zeros(3, 2))
