"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports only torch, numpy and the port (the machine with the card has no
JAX), so it runs there as ``python -m pytest -q tests/test_torch_kernels_cuda.py``.
Without CUDA every test skips: a CUDA kernel has no CPU mode. Policy as in
PERF.md: hash64 and voronoi_assign bitwise (the kernel repeats the plain
version's rounding), st_scan count/min/max bitwise and sum to rtol 1e-5;
flash_attention to 2e-5 in fp32 (the same online softmax, summed in another
order) and 1e-2 in bf16 (one bf16 ulp of outputs of order 1 is 0.0078; the
kernel's tensor-core sums and the plain version's differ in order).
"""

import numpy as np
import pytest
import torch

from repro_torch.core import hashing, voronoi
from repro_torch.core.datastore import make_pred
from repro_torch.data.synthetic import CityConfig, make_sites
from repro_torch.configs.base import get_config, reduce_for_smoke
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.hash64 import ops as hops
from repro_torch.kernels.st_scan import ops as st_ops
from repro_torch.kernels.st_scan import ref as st_ref
from repro_torch.kernels.voronoi_assign import ops as vops
from repro_torch.models.model import Model
from repro_torch.models.transformer import tree_map


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


FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}


def _flash_case(cuda, dtype, b, sq, skv, h, kv, dh, causal, q_offset=0,
                seed=0):
    """Kernel and plain version on the same seeded inputs; checks both the
    result and that exactly one launch was counted."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(cuda, dtype) for shape in ((b, sq, h, dh), (b, skv, kv, dh),
                                              (b, skv, kv, dh)))
    before = fops.launches
    got = fops.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    assert fops.launches == before + 1
    want = flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset)
    assert got.dtype == dtype and got.shape == (b, sq, h, dh)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,kv", [(4, 4), (8, 4), (8, 2), (4, 1)])
@pytest.mark.parametrize("dh", [32, 64, 128])
def test_flash_kernel_matches_plain(cuda, dtype, causal, h, kv, dh):
    _flash_case(cuda, dtype, 2, 200, 200, h, kv, dh, causal, seed=dh + h)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q_offset", [0, 1, 63, 64, 77, 191, 255])
def test_flash_kernel_decode_row(cuda, dtype, q_offset):
    """Sq == 1 over a 256-slot cache: attends to keys 0..q_offset."""
    _flash_case(cuda, dtype, 3, 1, 256, 16, 8, 128, True, q_offset, seed=q_offset)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,skv,causal", [(77, 131, True), (77, 131, False),
                                           (1, 1, True), (130, 5, False)])
def test_flash_kernel_ragged(cuda, dtype, sq, skv, causal):
    q_offset = max(skv - sq, 0) if causal else 0
    _flash_case(cuda, dtype, 2, sq, skv, 4, 2, 64, causal, q_offset, seed=sq)


def test_flash_kernel_reads_a_cache_slice_in_place(cuda):
    """A layer's slice of the (L, B, S, KV, d) cache goes in without a copy,
    and the kernel is bitwise deterministic across calls."""
    rng = np.random.default_rng(1)
    cache = torch.from_numpy(rng.standard_normal((3, 2, 96, 2, 64)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    q = torch.from_numpy(rng.standard_normal((2, 1, 4, 64)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    k_l, v_l = cache[1], cache[2]
    got = fops.flash_attention_cuda(q, k_l, v_l, causal=True, q_offset=50)
    again = fops.flash_attention_cuda(q, k_l, v_l, causal=True, q_offset=50)
    assert torch.equal(got, again)
    want = flash_attention_ref(q, k_l, v_l, causal=True, q_offset=50)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=1e-2)


def test_flash_wrapper_refuses_what_the_kernel_lacks(cuda):
    q = torch.zeros((1, 8, 2, 64))
    with pytest.raises(ValueError, match="CUDA"):
        fops.flash_attention_cuda(q, q, q, causal=True)
    for bad in (torch.zeros((1, 8, 2, 48), device=cuda),                 # d
                torch.zeros((1, 8, 2, 64), device=cuda, dtype=torch.half)):
        with pytest.raises(ValueError):
            fops.flash_attention_cuda(bad, bad, bad, causal=True)


def test_smoke_model_on_card_matches_cpu(cuda):
    """The dense decoder through the kernel (forward and cached decode) in
    fp32 against its own CPU run through the plain version, at 1e-4."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduce_for_smoke(get_config("qwen3-14b")).replace(
        compute_dtype_str="float32")
    cpu = Model(cfg, device="cpu")
    params = cpu.init(torch.Generator().manual_seed(0))
    card = Model(cfg, device=cuda)
    cparams = tree_map(lambda a: a.to(cuda), params)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 70)).astype(np.int32))
    before = fops.launches
    h_card, _ = card.forward(cparams, {"tokens": toks.to(cuda)})
    h_cpu, _ = cpu.forward(params, {"tokens": toks})
    assert fops.launches == before + cfg.n_layers
    torch.testing.assert_close(h_card.cpu(), h_cpu, rtol=1e-4, atol=1e-4)
    cc, cg = cpu.init_cache(2, 70), card.init_cache(2, 70)
    for t in range(70):
        cc, lc = cpu.decode_step(params, cc, {"tokens": toks[:, t:t + 1]}, t)
        cg, lg = card.decode_step(cparams, cg, {"tokens": toks[:, t:t + 1].to(cuda)}, t)
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
