"""Model configuration and registry (port of ``repro.configs.base``).

The dataclass keeps the fields of the JAX package's ``ModelConfig`` that a
dense GQA decoder reads to serve and to train (``remat``, ``loss_chunk``),
that a Mamba1 stack reads (``ssm_*``, ``d_conv``, ``expand``), that the
Mamba2 hybrid reads (``n_groups``, ``ssm_headdim``, ``attn_every``) and
that the MoE FFN reads (``n_experts`` ... ``moe_group_tokens``, with
``first_dense`` leading dense layers) and that MLA attention reads
(``mla``, ``kv_lora``, ``mla_nope_dim``, ``mla_rope_dim``,
``mla_v_dim``), under the same names and defaults; ``param_dtype`` and
``compute_dtype`` return ``torch`` dtypes. The reference's mesh-only MoE
fields, ``expert_shard`` and ``moe_ff_fsdp`` (how experts shard over a
model mesh), are left out: one card has no model mesh (ROADMAP item 11).
``mrope`` is kept only so that a config asking for it is refused. The port
registers only the configurations it can serve (``ARCH_MODULES``): dense
decoders with GQA attention, the Mamba1 ``ssm`` family, the Mamba2
``hybrid`` family (zamba2) and the ``moe`` family with GQA attention
(grok-1) or with MLA and a leading dense layer (deepseek-v2). Asking for
another one raises ``NotImplementedError`` naming the ROADMAP item that
ports its family.
"""

from __future__ import annotations

import dataclasses
import importlib
import torch

# Families and features the port does not serve yet, with the ROADMAP item
# (Queue 1, item 10, "LM scaffold") that brings them.
NOT_PORTED = ("M-RoPE, the grouped MoE dispatch, Mamba2 outside the hybrid "
              "family, and the enc-dec family are not ported yet (ROADMAP "
              "Queue 1, LM scaffold item 10.3)")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"        # the port serves "dense", "moe", "ssm", "hybrid"
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv: int = 4
    d_head: int = 64
    d_ff: int = 1024
    vocab: int = 1024

    # attention details
    qk_norm: bool = False
    rope_theta: float = 1e4
    mrope: bool = False          # not ported: Model raises
    attn_chunk_kv: int = 1024    # key chunk of the plain flash version
    tie_embeddings: bool = False

    # MoE (the reference's names and defaults; models/moe.py)
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0
    d_ff_expert: int = 0
    first_dense: int = 0          # leading dense-FFN layers (deepseek-v2: 1)
    capacity_factor: float = 1.25
    moe_dispatch: str = "einsum"  # einsum (GShard) | scatter
    aux_loss_weight: float = 0.01
    moe_group_tokens: int = 0     # > 0, the grouped dispatch: not ported

    # MLA (deepseek-v2): latent K/V of width kv_lora with a decoupled rope
    # key; q/k heads of nope + rope, v heads of mla_v_dim
    mla: bool = False
    kv_lora: int = 0
    mla_nope_dim: int = 128
    mla_rope_dim: int = 64
    mla_v_dim: int = 128

    # SSM (Mamba1 in the ssm family, Mamba2 in the hybrid one)
    ssm_state: int = 0
    ssm_version: int = 1
    d_conv: int = 4
    expand: int = 2
    n_groups: int = 1
    ssm_headdim: int = 64
    ssm_chunk: int = 128          # scan chunk: bounds the (B, Q, Di, N) set
    ssm_scan: str = "associative"  # associative | sequential

    # hybrid (zamba2): one shared attention block applied every attn_every
    # mamba layers
    attn_every: int = 0

    # vocab padding: embeddings/unembeddings allocate the padded size;
    # padded logits are masked.
    vocab_pad_multiple: int = 256

    # numerics / memory
    param_dtype_str: str = "float32"
    compute_dtype_str: str = "bfloat16"
    remat: str = "full"           # full | dots | none (training only)
    loss_chunk: int = 2048        # CE vocab-chunking (tokens per block)

    @property
    def param_dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype_str)

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype_str)

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def vocab_padded(self) -> int:
        m = self.vocab_pad_multiple
        return (self.vocab + m - 1) // m * m

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


_REGISTRY = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


ARCH_MODULES = ["internlm2_1_8b", "qwen3_14b", "deepseek_7b",
                "stablelm_12b", "grok_1_314b", "deepseek_v2_236b",
                "zamba2_1_2b", "falcon_mamba_7b"]


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        mod = name.replace("-", "_").replace(".", "_")
        if mod not in ARCH_MODULES:
            raise NotImplementedError(
                f"config {name!r} is not in the port ({', '.join(ARCH_MODULES)}"
                f" are): {NOT_PORTED}")
        importlib.import_module(f"repro_torch.configs.{mod}")
    return _REGISTRY[name]


def reduce_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """Shrink a full config to a CPU-runnable config of the same family:
    same block structure and flags, tiny dims (the JAX package's rule for
    the fields the port has)."""
    kw = dict(n_layers=min(cfg.n_layers, 4), d_model=128,
              d_ff=256 if cfg.d_ff else 0, vocab=512, loss_chunk=128,
              attn_chunk_kv=64, ssm_chunk=16)
    if cfg.n_heads:
        kw.update(n_heads=4, n_kv=min(max(cfg.n_kv * 4 // cfg.n_heads, 1), 4),
                  d_head=32)
    if cfg.n_experts:
        kw.update(n_experts=4, top_k=min(cfg.top_k, 2), d_ff_expert=64,
                  n_shared=min(cfg.n_shared, 1))
    if cfg.mla:
        kw.update(kv_lora=32, mla_nope_dim=32, mla_rope_dim=16, mla_v_dim=32)
    if cfg.ssm_state:
        kw.update(ssm_state=8, ssm_headdim=16)
    if cfg.attn_every:
        kw.update(attn_every=2)
    return cfg.replace(name=cfg.name + "-smoke", **kw)


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` unless ``cfg`` is a dense GQA decoder,
    an MoE decoder (GQA or MLA attention, ungrouped dispatch, any leading
    dense layers), a Mamba1 stack or a Mamba2 hybrid."""
    if cfg.mla and cfg.family != "moe":
        raise NotImplementedError(
            f"{cfg.name}: MLA attention is ported in the moe family only "
            f"(deepseek-v2-236b); {NOT_PORTED}")
    if cfg.family == "moe" and cfg.moe_group_tokens:
        raise NotImplementedError(
            f"{cfg.name}: the grouped MoE dispatch (moe_group_tokens > 0) is "
            f"not ported (ROADMAP Queue 1, item 10.3); {NOT_PORTED}")
    dense = cfg.family == "dense" and not cfg.mrope and not cfg.n_experts
    moe = cfg.family == "moe" and cfg.n_experts > 0 and not cfg.mrope
    mamba1 = cfg.family == "ssm" and cfg.ssm_version == 1
    hybrid = cfg.family == "hybrid" and cfg.ssm_version == 2 and not cfg.mrope
    if not (dense or moe or mamba1 or hybrid):
        raise NotImplementedError(f"{cfg.name}: {NOT_PORTED}")
