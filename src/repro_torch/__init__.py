"""PyTorch/CUDA port of the AerialDB reproduction (``repro``).

Mirrors the module layout of the JAX package: ``repro_torch.core.index`` is
the port of ``repro.core.index``, and so on. Plain tensor code is PyTorch;
the three hot functions of the store round trip (the per-edge predicate scan,
xxHash64 placement hashing and Voronoi point location) are hand-written CUDA
kernels under ``csrc/``, built with nvcc for ``sm_90a`` at first use
(``repro_torch.kernels.build``).

Device policy: entry points take ``device`` and default to ``"cuda"``; they
raise when CUDA is missing unless the caller asks for ``device="cpu"``. Each
kernel wrapper runs its plain PyTorch version only for tensors on the CPU;
for a CUDA tensor it launches the kernel or raises.
"""
