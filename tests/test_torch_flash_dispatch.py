"""How the flash_attention wrapper chooses and feeds its three CUDA
kernels, checked on the CPU (no kernel runs here).

``_variant`` picks the kernel from shapes and dtype alone; a forced
``variant`` is refused where that kernel does not take the inputs;
``decode_splits`` picks the decode kernel's key splits and
``decode_partition`` the keys of each; the TMA
maps' dims and byte strides are computed in Python (``tma_map_geometry``)
and only encoded in C, so their numbers are checked here, for a contiguous
tensor and for a layer's slice of the KV cache.
"""

import pytest
import torch

from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention.ref import decode_partition


def _qkv(sq, dh, dtype=torch.bfloat16, skv=None):
    q = torch.zeros((1, sq, 4, dh), dtype=dtype)
    k = torch.zeros((1, skv or sq, 2, dh), dtype=dtype)
    return q, k, k.clone()


@pytest.mark.parametrize("sq,dh,dtype,want", [
    (64, 128, torch.bfloat16, "sm90"),
    (63, 128, torch.bfloat16, "mma_sync"),     # fewer rows than a warpgroup
    (1, 128, torch.bfloat16, "decode"),        # decode
    (2048, 128, torch.bfloat16, "sm90"),       # serve prefill
    (2048, 64, torch.bfloat16, "sm90"),        # zamba2-1.2b's shared block
    (2048, 32, torch.bfloat16, "mma_sync"),
    (2048, 128, torch.float32, "mma_sync"),
    (64, 160, torch.bfloat16, "sm90"),         # stablelm-12b's head dim
    (63, 160, torch.bfloat16, "mma_sync"),
    (1, 160, torch.bfloat16, "decode"),
    (2048, 160, torch.bfloat16, "sm90"),       # stablelm-12b prefill
    (2048, 160, torch.float32, "mma_sync"),
    (2048, 96, torch.bfloat16, "mma_sync"),    # no kernel: mma_sync refuses it
])
def test_variant_boundaries(sq, dh, dtype, want):
    assert fops._variant(*_qkv(sq, dh, dtype)) == want
    assert fops.resolve_variant(*_qkv(sq, dh, dtype)) == want


def test_variant_ignores_skv():
    assert fops._variant(*_qkv(64, 128, skv=1)) == "sm90"
    assert fops._variant(*_qkv(63, 128, skv=4096)) == "mma_sync"


@pytest.mark.parametrize("sq,dh,dtype", [(63, 128, torch.bfloat16),
                                         (63, 64, torch.bfloat16),
                                         (128, 128, torch.float32),
                                         (63, 160, torch.bfloat16),
                                         (128, 160, torch.float32),
                                         (128, 96, torch.bfloat16)])
def test_forced_sm90_on_a_shape_it_lacks_raises(sq, dh, dtype):
    with pytest.raises(ValueError, match="sm90"):
        fops.resolve_variant(*_qkv(sq, dh, dtype), variant="sm90")


def test_forced_variants():
    qkv = _qkv(128, 128)
    assert fops.resolve_variant(*qkv, variant="sm90") == "sm90"
    assert fops.resolve_variant(*qkv, variant="mma_sync") == "mma_sync"
    with pytest.raises(ValueError, match="variant"):
        fops.resolve_variant(*qkv, variant="wgmma")


def _decode_qkv(sq=1, dh=128, dtype=torch.bfloat16, h=16, kv=8, skv=256):
    q = torch.zeros((2, sq, h, dh), dtype=dtype)
    k = torch.zeros((2, skv, kv, dh), dtype=dtype)
    return q, k, k.clone()


@pytest.mark.parametrize("sq,dh,dtype,h,kv,want", [
    (1, 128, torch.bfloat16, 16, 8, "decode"),    # internlm2-1.8b decode
    (1, 64, torch.bfloat16, 16, 8, "decode"),
    (1, 32, torch.bfloat16, 16, 8, "decode"),
    (1, 128, torch.bfloat16, 40, 8, "decode"),    # qwen3-14b, G 5
    (1, 128, torch.bfloat16, 16, 1, "decode"),    # G 16, the most a block takes
    (1, 128, torch.bfloat16, 32, 1, "mma_sync"),  # G 32
    (1, 128, torch.float32, 16, 8, "mma_sync"),
    (1, 64, torch.float32, 16, 8, "mma_sync"),
    (2, 128, torch.bfloat16, 16, 8, "mma_sync"),
    (63, 128, torch.bfloat16, 16, 8, "mma_sync"),
    (64, 128, torch.bfloat16, 16, 8, "sm90"),
    (1, 160, torch.bfloat16, 32, 8, "decode"),    # stablelm-12b decode, G 4
    (1, 160, torch.bfloat16, 16, 1, "decode"),    # d 160, G 16
    (1, 160, torch.bfloat16, 32, 1, "mma_sync"),  # d 160, G 32
    (1, 160, torch.float32, 32, 8, "mma_sync"),
    (2, 160, torch.bfloat16, 32, 8, "mma_sync"),
    (64, 160, torch.bfloat16, 32, 8, "sm90"),
    (1, 128, torch.bfloat16, 32, 32, "decode"),   # deepseek-7b decode, G 1
    (2048, 128, torch.bfloat16, 32, 32, "sm90"),  # deepseek-7b prefill
])
def test_decode_variant_boundaries(sq, dh, dtype, h, kv, want):
    qkv = _decode_qkv(sq, dh, dtype, h, kv)
    assert fops._variant(*qkv) == want
    assert fops.resolve_variant(*qkv) == want


def test_decode_variant_ignores_skv():
    for skv in (1, 256, 4096):
        assert fops._variant(*_decode_qkv(skv=skv)) == "decode"


@pytest.mark.parametrize("sq,dh,dtype,h", [(2, 128, torch.bfloat16, 16),
                                           (64, 128, torch.bfloat16, 16),
                                           (1, 128, torch.float32, 16),
                                           (1, 64, torch.float32, 16),
                                           (1, 128, torch.bfloat16, 136),
                                           (1, 160, torch.float32, 16),
                                           (2, 160, torch.bfloat16, 16),
                                           (1, 160, torch.bfloat16, 136),
                                           (1, 96, torch.bfloat16, 16)])
def test_forced_decode_on_a_shape_it_lacks_raises(sq, dh, dtype, h):
    with pytest.raises(ValueError, match="decode"):
        fops.resolve_variant(*_decode_qkv(sq, dh, dtype, h), variant="decode")


def test_forced_variants_at_sq_1():
    """A decode row may be forced onto the mma_sync kernel (tests, timings),
    never onto the sm90 kernel."""
    qkv = _decode_qkv()
    assert fops.resolve_variant(*qkv, variant="decode") == "decode"
    assert fops.resolve_variant(*qkv, variant="mma_sync") == "mma_sync"
    with pytest.raises(ValueError, match="sm90"):
        fops.resolve_variant(*qkv, variant="sm90")


@pytest.mark.parametrize("b", [1, 2, 3, 8, 16, 64, 128])
@pytest.mark.parametrize("kv", [1, 2, 8, 16])
def test_decode_splits(b, kv):
    for n_keys in (1, 2, 3, 7, 8, 9, 24, 192, 256, 4096, 131072):
        n = fops.decode_splits(b, kv, n_keys)
        assert 1 <= n <= fops.DECODE_MAX_SPLITS
        assert n <= n_keys                      # no split is wholly empty
        # the card's 132 SMs are all given a block wherever the splits
        # allowed (at most 8 and no more than the keys) reach them
        if b * kv * min(fops.DECODE_MAX_SPLITS, n_keys) >= 132:
            assert b * kv * n >= 132
        if b * kv >= fops.DECODE_TARGET_BLOCKS:
            assert n == 1


def test_decode_splits_at_the_serve_shapes():
    assert fops.decode_splits(8, 8, 192) == 4        # internlm2-1.8b, 256 blocks
    assert fops.decode_splits(8, 8, 4096) == 4
    assert fops.decode_splits(1, 8, 4096) == 8       # one request: 64 blocks
    assert fops.decode_splits(8, 8, 1) == 1          # the first prompt token
    assert fops.decode_splits(8, 8, 3) == 3          # no split without a key


@pytest.mark.parametrize("n_keys", [1, 2, 7, 8, 9, 24, 31, 32, 33, 192, 4096])
@pytest.mark.parametrize("n_split", [1, 2, 3, 5, 8])
def test_decode_partition(n_keys, n_split):
    """Contiguous ranges in rank order that cover [0, n_keys) once; only
    trailing ranges may be short or empty."""
    parts = decode_partition(n_keys, n_split)
    assert len(parts) == n_split
    assert parts[0][0] == 0 and parts[-1][1] == n_keys
    per = -(-n_keys // n_split)
    for (a0, a1), (b0, _) in zip(parts, parts[1:]):
        assert a1 == b0
    sizes = [k1 - k0 for k0, k1 in parts]
    assert all(0 <= s <= per for s in sizes) and sizes[0] == min(per, n_keys)
    assert sizes == sorted(sizes, reverse=True)


def test_tma_geometry_of_a_contiguous_tensor():
    x = torch.zeros((2, 100, 16, 128), dtype=torch.bfloat16)
    dims, strides = fops.tma_map_geometry(x)
    assert dims == (128, 100, 16, 2)
    assert strides == (16 * 128 * 2, 128 * 2, 100 * 16 * 128 * 2)


def test_tma_geometry_of_a_cache_slice():
    """A layer's k of the (L, B, max_seq, KV, d) cache: the slice's batch
    stride spans the whole max_seq, whatever Skv the call uses."""
    cache = torch.zeros((3, 2, 256, 8, 128), dtype=torch.bfloat16)
    k_l = cache[1]
    dims, strides = fops.tma_map_geometry(k_l)
    assert dims == (128, 256, 8, 2)
    assert strides == (8 * 128 * 2, 128 * 2, 256 * 8 * 128 * 2)
    assert all(s % 16 == 0 for s in strides)       # TMA's stride rule
    prefix = k_l[:, :100]
    assert fops.tma_map_geometry(prefix) == ((128, 100, 8, 2), strides)


def test_tma_geometry_of_a_d160_cache_slice():
    """stablelm-12b's layer slice of the (L, B, 256, 8, 160) cache: 320-byte
    rows, every stride a multiple of TMA's 16 bytes; the sm90 kernel's
    third 64-column box at column 128 reaches past d = 160, where TMA
    fills zeros."""
    cache = torch.zeros((2, 8, 256, 8, 160), dtype=torch.bfloat16)
    dims, strides = fops.tma_map_geometry(cache[1])
    assert dims == (160, 256, 8, 8)
    assert strides == (8 * 160 * 2, 160 * 2, 256 * 8 * 160 * 2)
    assert all(s % 16 == 0 for s in strides)


def test_forced_variants_at_d160():
    """The stablelm prefill and decode shapes may each be forced onto the
    mma_sync kernel (tests, timings); a decode row never onto sm90."""
    pre = _qkv(2048, 160)
    assert fops.resolve_variant(*pre, variant="sm90") == "sm90"
    assert fops.resolve_variant(*pre, variant="mma_sync") == "mma_sync"
    dec = _decode_qkv(dh=160, h=32, kv=8)
    assert fops.resolve_variant(*dec, variant="decode") == "decode"
    assert fops.resolve_variant(*dec, variant="mma_sync") == "mma_sync"
    with pytest.raises(ValueError, match="sm90"):
        fops.resolve_variant(*dec, variant="sm90")


@pytest.mark.parametrize("sq,dtype,want", [
    (2048, torch.bfloat16, "sm90"),      # zamba2-1.2b's prefill
    (64, torch.bfloat16, "sm90"),        # one warpgroup's rows
    (63, torch.bfloat16, "mma_sync"),
    (2, torch.bfloat16, "mma_sync"),
    (2048, torch.float32, "mma_sync"),
    (64, torch.float32, "mma_sync"),
    (1, torch.bfloat16, "decode"),       # zamba2-1.2b's decode, G 1
    (1, torch.float32, "mma_sync"),
])
def test_variant_boundaries_d64(sq, dtype, want):
    """zamba2-1.2b's shared block, 32 heads over 32 at d 64: bf16 with Sq
    >= 64 goes to the sm90 kernel, fp32 and 1 < Sq < 64 to mma_sync, Sq 1
    to the decode kernel."""
    qkv = _decode_qkv(sq, 64, dtype, h=32, kv=32)
    assert fops._variant(*qkv) == want
    assert fops.resolve_variant(*qkv) == want
    if want != "decode":
        assert fops.resolve_variant(*qkv, variant="mma_sync") == "mma_sync"


def test_sm90_keys_cover_its_head_dims():
    """The probe's key rows are a tile of the kernel at each head dim it
    takes: whole 8-row swizzle atoms, 64 or 128 keys."""
    assert sorted(fops.SM90_KEYS) == sorted(fops.SM90_HEAD_DIMS) == [64, 128, 160]
    assert all(k in (64, 128) for k in fops.SM90_KEYS.values())


def test_tma_geometry_of_a_d64_cache_slice():
    """zamba2-1.2b's site slice of the (n_sites, B, 256, 32, 64) cache:
    128-byte rows, exactly one 64-column box of the sm90 kernel, every
    stride a multiple of TMA's 16 bytes."""
    cache = torch.zeros((6, 8, 256, 32, 64), dtype=torch.bfloat16)
    dims, strides = fops.tma_map_geometry(cache[5])
    assert dims == (64, 256, 32, 8)
    assert strides == (32 * 64 * 2, 64 * 2, 256 * 32 * 64 * 2)
    assert all(s % 16 == 0 for s in strides)
    q = torch.zeros((8, 2048, 3, 32, 64), dtype=torch.bfloat16)[:, :, 0]
    assert fops.tma_map_geometry(q) == ((64, 2048, 32, 8),
                                        (3 * 32 * 64 * 2, 64 * 2,
                                         2048 * 3 * 32 * 64 * 2))


def test_tma_geometry_of_a_head_slice():
    """q of a fused (B, S, 3, H, d) projection, read where it lies."""
    qkv = torch.zeros((2, 64, 3, 4, 128), dtype=torch.bfloat16)
    dims, strides = fops.tma_map_geometry(qkv[:, :, 0])
    assert dims == (128, 64, 4, 2)
    assert strides == (3 * 4 * 128 * 2, 128 * 2, 64 * 3 * 4 * 128 * 2)


def test_cuda_wrapper_refuses_cpu_tensors_before_choosing():
    with pytest.raises(ValueError, match="CUDA"):
        fops.flash_attention_cuda(*_qkv(128, 128), causal=True, variant="sm90")


# -- the backward's two kernels ----------------------------------------------

def _bwd_qkv(sq, skv, dh, dtype=torch.bfloat16, h=16, kv=8):
    q = torch.zeros((1, sq, h, dh), dtype=dtype)
    k = torch.zeros((1, skv, kv, dh), dtype=dtype)
    return q, k, k.clone()


@pytest.mark.parametrize("sq,skv,dh,dtype,want", [
    (4096, 4096, 128, torch.bfloat16, "sm90"),     # internlm2-1.8b's train call
    (64, 64, 128, torch.bfloat16, "sm90"),         # the least rows and keys
    (63, 64, 128, torch.bfloat16, "mma_sync"),     # fewer rows than a warpgroup
    (64, 63, 128, torch.bfloat16, "mma_sync"),     # fewer keys than a tile
    (77, 131, 128, torch.bfloat16, "sm90"),        # ragged, Sq < Skv
    (1, 4096, 128, torch.bfloat16, "mma_sync"),
    (4096, 4096, 128, torch.float32, "mma_sync"),
    (4096, 4096, 32, torch.bfloat16, "mma_sync"),  # the lm-8m example's d
    (4096, 4096, 64, torch.bfloat16, "mma_sync"),
    (4096, 4096, 160, torch.bfloat16, "mma_sync"), # stablelm-12b's d
    (4096, 4096, 96, torch.bfloat16, "mma_sync"),  # no kernel: the check refuses it
])
def test_bwd_variant_boundaries(sq, skv, dh, dtype, want):
    qkv = _bwd_qkv(sq, skv, dh, dtype)
    assert fops._bwd_variant(*qkv) == want
    assert fops.resolve_bwd_variant(*qkv) == want


def _mla_bwd_qkv(sq, skv, dk, dv, dtype=torch.bfloat16, h=128, kv=128):
    """q, k and v at an MLA pair, v the strided half of a K/V expansion as
    ``mla_attend`` passes it."""
    q = torch.zeros((1, sq, h, dk), dtype=dtype)
    k = torch.zeros((1, skv, kv, dk), dtype=dtype)
    return q, k, torch.zeros((1, skv, kv, 2 * dv), dtype=dtype)[..., dv:]


@pytest.mark.parametrize("sq,skv,dk,dv,dtype,want", [
    (4096, 4096, 192, 128, torch.bfloat16, "sm90"),     # deepseek-v2-236b's train call
    (64, 64, 192, 128, torch.bfloat16, "sm90"),         # the least rows and keys
    (63, 64, 192, 128, torch.bfloat16, "mma_sync"),     # fewer rows than a warpgroup
    (64, 63, 192, 128, torch.bfloat16, "mma_sync"),     # fewer keys than a tile
    (77, 131, 192, 128, torch.bfloat16, "sm90"),        # ragged, Sq < Skv
    (4096, 4096, 192, 128, torch.float32, "mma_sync"),
    (64, 64, 192, 128, torch.float32, "mma_sync"),
    (4096, 4096, 48, 32, torch.bfloat16, "mma_sync"),   # the smoke config's pair
    (64, 64, 48, 32, torch.float32, "mma_sync"),
    (4096, 4096, 128, 128, torch.bfloat16, "sm90"),     # d 128 as before
    (63, 4096, 128, 128, torch.bfloat16, "mma_sync"),
])
def test_bwd_variant_boundaries_mla(sq, skv, dk, dv, dtype, want):
    """The backward's kernel at MLA's pairs: bf16 (192, 128) with Sq, Skv
    >= 64 goes to the sm90 backward, fp32, shorter calls and (48, 32) to
    mma_sync; forcing sm90 takes exactly the shapes it would pick, and
    mma_sync may be forced on any of them."""
    qkv = _mla_bwd_qkv(sq, skv, dk, dv, dtype)
    assert fops._bwd_variant(*qkv) == want
    assert fops.resolve_bwd_variant(*qkv) == want
    assert fops.resolve_bwd_variant(*qkv, variant="mma_sync") == "mma_sync"
    if want == "sm90":
        assert fops.resolve_bwd_variant(*qkv, variant="sm90") == "sm90"
    else:
        with pytest.raises(ValueError, match="sm90 backward"):
            fops.resolve_bwd_variant(*qkv, variant="sm90")


def test_sm90_bwd_head_dims_are_forward_pairs():
    """Every pair the sm90 backward takes is one the sm90 forward takes, so
    a call under grad has its forward on the same family of kernel."""
    for dk, dv in fops.SM90_BWD_HEAD_DIMS:
        assert dk in fops.SM90_HEAD_DIMS if dk == dv else (dk, dv) in fops.SM90_MLA_KEYS


def test_bwd_variant_ignores_the_group():
    for h, kv in ((16, 16), (16, 8), (16, 2), (16, 1), (40, 8)):
        assert fops._bwd_variant(*_bwd_qkv(256, 256, 128, h=h, kv=kv)) == "sm90"


@pytest.mark.parametrize("sq,skv,dh,dtype", [
    (4096, 4096, 128, torch.float32),
    (4096, 4096, 32, torch.bfloat16),
    (4096, 4096, 64, torch.bfloat16),
    (4096, 4096, 160, torch.bfloat16),
    (63, 4096, 128, torch.bfloat16),
    (4096, 63, 128, torch.bfloat16),
    (1, 1, 128, torch.bfloat16),
])
def test_forced_sm90_bwd_on_a_shape_it_lacks_raises(sq, skv, dh, dtype):
    with pytest.raises(ValueError, match="sm90 backward"):
        fops.resolve_bwd_variant(*_bwd_qkv(sq, skv, dh, dtype), variant="sm90")


def test_forced_bwd_variants():
    qkv = _bwd_qkv(4096, 4096, 128)
    assert fops.resolve_bwd_variant(*qkv, variant="sm90") == "sm90"
    assert fops.resolve_bwd_variant(*qkv, variant="mma_sync") == "mma_sync"
    small = _bwd_qkv(32, 32, 32, torch.float32)
    assert fops.resolve_bwd_variant(*small, variant="mma_sync") == "mma_sync"
    for bad in ("decode", "wgmma", "bwd"):
        with pytest.raises(ValueError, match="backward variant"):
            fops.resolve_bwd_variant(*qkv, variant=bad)


def test_bwd_counters_keys():
    """Every backward call counts once in ``launches_by_variant["bwd"]`` and
    once under the kernel that took it."""
    assert set(fops.bwd_launches_by_variant) == set(fops.BWD_VARIANTS) \
        == {"sm90", "mma_sync"}
    assert set(fops.launches_by_variant) == set(fops.VARIANTS) | {"bwd"}


def test_bwd_wrapper_refuses_cpu_tensors_before_choosing():
    q, k, v = _bwd_qkv(128, 128, 128)
    with pytest.raises(ValueError, match="CUDA"):
        fops.flash_attention_bwd_cuda(q, k, v, q, q, causal=True, variant="sm90")


# -- MLA's unequal head dims (q/k d_qk, v d_v) ------------------------------

def _mla_qkv(sq, dk, dv, dtype=torch.bfloat16, h=4, kv=4, skv=None):
    q = torch.zeros((1, sq, h, dk), dtype=dtype)
    k = torch.zeros((1, skv or sq, kv, dk), dtype=dtype)
    return q, k, torch.zeros((1, skv or sq, kv, dv), dtype=dtype)


@pytest.mark.parametrize("sq,dk,dv,dtype,want", [
    (2048, 192, 128, torch.bfloat16, "sm90"),      # deepseek-v2-236b's prefill
    (64, 192, 128, torch.bfloat16, "sm90"),        # one warpgroup's rows
    (63, 192, 128, torch.bfloat16, "mma_sync"),
    (2, 192, 128, torch.bfloat16, "mma_sync"),
    (1, 192, 128, torch.bfloat16, "mma_sync"),     # never the decode kernel
    (2048, 192, 128, torch.float32, "mma_sync"),   # the fp32 dense-layer check
    (1, 192, 128, torch.float32, "mma_sync"),
    (2048, 48, 32, torch.bfloat16, "mma_sync"),    # the smoke config's dims
    (64, 48, 32, torch.float32, "mma_sync"),       # its fp32 run on the card
    (1, 48, 32, torch.bfloat16, "mma_sync"),
    (2048, 128, 64, torch.bfloat16, "mma_sync"),   # unlisted: the check refuses it
    (1, 128, 64, torch.bfloat16, "mma_sync"),
])
def test_variant_boundaries_mla(sq, dk, dv, dtype, want):
    qkv = _mla_qkv(sq, dk, dv, dtype)
    assert fops._variant(*qkv) == want
    assert fops.resolve_variant(*qkv) == want
    assert fops.resolve_variant(*qkv, variant="mma_sync") == "mma_sync"


@pytest.mark.parametrize("sq,dk,dv,dtype", [(2048, 48, 32, torch.bfloat16),
                                            (63, 192, 128, torch.bfloat16),
                                            (2048, 192, 128, torch.float32),
                                            (2048, 128, 64, torch.bfloat16),
                                            (2048, 160, 128, torch.bfloat16)])
def test_forced_sm90_on_an_mla_shape_it_lacks_raises(sq, dk, dv, dtype):
    with pytest.raises(ValueError, match="sm90"):
        fops.resolve_variant(*_mla_qkv(sq, dk, dv, dtype), variant="sm90")


@pytest.mark.parametrize("dk,dv", [(192, 128), (48, 32)])
def test_forced_decode_on_an_mla_row_raises(dk, dv):
    with pytest.raises(ValueError, match="decode"):
        fops.resolve_variant(*_mla_qkv(1, dk, dv), variant="decode")


@pytest.mark.parametrize("dk,dv,want", [
    (192, 128, True), (48, 32, True), (32, 32, True), (160, 160, True),
    (128, 64, False), (192, 192, False), (48, 48, False), (32, 48, False),
    (160, 128, False), (96, 96, False)])
def test_head_dims_supported(dk, dv, want):
    assert fops.head_dims_supported(dk, dv) is want
    assert ((dk, dv) in fops.MLA_HEAD_DIMS) is (want and dk != dv)


def test_sm90_mla_keys():
    """The sm90 kernel's MLA pairs are listed pairs, and a 128-key K/V
    stage of (192, 128) is three 64-column K slabs and two V slabs."""
    assert set(fops.SM90_MLA_KEYS) <= set(fops.MLA_HEAD_DIMS)
    assert fops.SM90_MLA_KEYS == {(192, 128): 128}
    # two stages of (3 + 2) slabs of 128 rows x 128 bytes, and Q's 3 slabs
    # of 128 rows, under the 227 KB a block may take
    assert 3 * 128 * 128 + 2 * (3 + 2) * 128 * 128 + 1024 <= 232448


def test_tma_geometry_of_mla_v_view():
    """MLA's v: the second half of each head's 256 columns of the K/V
    expansion (B, S, H, 128 + 128), read where it lies: 256-byte head
    stride, every stride and the view's start a multiple of TMA's 16
    bytes."""
    kvb = torch.zeros((8, 2048, 128, 256), dtype=torch.bfloat16)
    v = kvb[..., 128:]
    dims, strides = fops.tma_map_geometry(v)
    assert dims == (128, 2048, 128, 8)
    assert strides == (128 * 256 * 2, 256 * 2, 2048 * 128 * 256 * 2)
    assert all(s % 16 == 0 for s in strides)
    assert (v.data_ptr() - kvb.data_ptr()) % 16 == 0
    q = torch.zeros((8, 2048, 128, 192), dtype=torch.bfloat16)
    assert fops.tma_map_geometry(q) == ((192, 2048, 128, 8),
                                        (128 * 192 * 2, 192 * 2,
                                         2048 * 128 * 192 * 2))


def test_mla_shapes_reach_the_plain_version_on_the_cpu():
    """On CPU tensors the wrapper takes the plain version at any listed
    pair, the output v's head dim wide."""
    q, k, v = (torch.randn(x.shape) for x in _mla_qkv(5, 48, 32))
    out = fops.flash_attention(q, k, v, causal=True)
    assert out.shape == (1, 5, 4, 32)
