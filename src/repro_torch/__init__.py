"""PyTorch/CUDA port of the AerialDB reproduction (``repro``).

Mirrors the module layout of the JAX package: ``repro_torch.core.index`` is
the port of ``repro.core.index``, and so on. Plain tensor code is PyTorch;
every Pallas TPU kernel of the JAX package has a hand-written CUDA kernel
under ``csrc/``, built with nvcc for ``sm_90a`` at first use
(``repro_torch.kernels.build``):

- the store round trip (``api``, ``core``): the per-edge predicate scan
  (``st_scan.cu``), xxHash64 placement hashing (``hash64.cu``) and Voronoi
  point location (``voronoi_assign.cu``); queries answer with
  ``core.datastore.QueryResult`` and ``QueryInfo``, and the latest-per-drone
  cache (``AerialDB.latest``, ``Query().latest()``; plain torch ops on
  either device) with ``LatestResult``; the store fails and recovers edges
  and failure domains (``AerialDB.fail_edges`` / ``fail_device`` and
  ``recover_*``, with the reference's outage-epoch ledger) and repairs
  itself after an outage (``core.repair``: a host-side sweep whose swept
  subset is placed on the state's device), and ``chaos.audit`` compares
  stores by their canonical content; the store also runs split over a
  one-process edge mesh (``launch.mesh.make_edge_mesh``,
  ``distributed.federation``: ``AerialDB.open(cfg, mesh)``);
- the LM serving path (``configs``, ``models``, ``train.train_loop``
  ``make_serve_steps``, ``serve.engine.Engine``) for dense GQA decoders
  such as internlm2-1.8b: FlashAttention-2 forward in every attention
  layer, through ``flash_attention_sm90.cu`` at prefill,
  ``flash_attention_decode.cu`` (split-KV) at decode and
  ``flash_attention.cu`` for the other shapes and fp32.
  ``convert.params_from_numpy`` takes the JAX package's weights.

Device policy: entry points take ``device`` and default to ``"cuda"``; they
raise when CUDA is missing unless the caller asks for ``device="cpu"``. Each
kernel wrapper runs its plain PyTorch version only for tensors on the CPU;
for a CUDA tensor it launches the kernel or raises.
"""
