"""How the flash_attention wrapper chooses and feeds its two CUDA kernels,
checked on the CPU (no kernel runs here).

``_variant`` picks the kernel from shapes and dtype alone; a forced
``variant`` is refused where that kernel does not take the inputs; the TMA
maps' dims and byte strides are computed in Python (``tma_map_geometry``)
and only encoded in C, so their numbers are checked here, for a contiguous
tensor and for a layer's slice of the KV cache.
"""

import pytest
import torch

from repro_torch.kernels.flash_attention import ops as fops


def _qkv(sq, dh, dtype=torch.bfloat16, skv=None):
    q = torch.zeros((1, sq, 4, dh), dtype=dtype)
    k = torch.zeros((1, skv or sq, 2, dh), dtype=dtype)
    return q, k, k.clone()


@pytest.mark.parametrize("sq,dh,dtype,want", [
    (64, 128, torch.bfloat16, "sm90"),
    (63, 128, torch.bfloat16, "mma_sync"),     # fewer rows than a warpgroup
    (1, 128, torch.bfloat16, "mma_sync"),      # decode
    (2048, 128, torch.bfloat16, "sm90"),       # serve prefill
    (2048, 64, torch.bfloat16, "mma_sync"),
    (2048, 32, torch.bfloat16, "mma_sync"),
    (2048, 128, torch.float32, "mma_sync"),
])
def test_variant_boundaries(sq, dh, dtype, want):
    assert fops._variant(*_qkv(sq, dh, dtype)) == want
    assert fops.resolve_variant(*_qkv(sq, dh, dtype)) == want


def test_variant_ignores_skv():
    assert fops._variant(*_qkv(64, 128, skv=1)) == "sm90"
    assert fops._variant(*_qkv(63, 128, skv=4096)) == "mma_sync"


@pytest.mark.parametrize("sq,dh,dtype", [(63, 128, torch.bfloat16),
                                         (128, 64, torch.bfloat16),
                                         (128, 128, torch.float32)])
def test_forced_sm90_on_a_shape_it_lacks_raises(sq, dh, dtype):
    with pytest.raises(ValueError, match="sm90"):
        fops.resolve_variant(*_qkv(sq, dh, dtype), variant="sm90")


def test_forced_variants():
    qkv = _qkv(128, 128)
    assert fops.resolve_variant(*qkv, variant="sm90") == "sm90"
    assert fops.resolve_variant(*qkv, variant="mma_sync") == "mma_sync"
    with pytest.raises(ValueError, match="variant"):
        fops.resolve_variant(*qkv, variant="wgmma")


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


def test_tma_geometry_of_a_head_slice():
    """q of a fused (B, S, 3, H, d) projection, read where it lies."""
    qkv = torch.zeros((2, 64, 3, 4, 128), dtype=torch.bfloat16)
    dims, strides = fops.tma_map_geometry(qkv[:, :, 0])
    assert dims == (128, 64, 4, 2)
    assert strides == (3 * 4 * 128 * 2, 128 * 2, 64 * 3 * 4 * 128 * 2)


def test_cuda_wrapper_refuses_cpu_tensors_before_choosing():
    with pytest.raises(ValueError, match="CUDA"):
        fops.flash_attention_cuda(*_qkv(128, 128), causal=True, variant="sm90")
