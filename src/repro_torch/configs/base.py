"""Model configuration and registry (port of ``repro.configs.base``).

The dataclass keeps the fields of the JAX package's ``ModelConfig`` that a
dense GQA decoder reads to serve and to train (``remat``, ``loss_chunk``),
under the same names and defaults;
``param_dtype`` and ``compute_dtype`` return ``torch`` dtypes. The port
registers only the configurations it can serve (``ARCH_MODULES``): dense
decoders with GQA attention. Asking for another one raises ``NotImplementedError`` naming the
ROADMAP item that ports its family.
"""

from __future__ import annotations

import dataclasses
import importlib
import torch

# Families and features the port does not serve yet, with the ROADMAP item
# (Queue 1, item 10, "LM scaffold") that brings them.
NOT_PORTED = ("MoE, MLA, M-RoPE, Mamba1/2 and the hybrid and enc-dec "
              "families are not ported yet (ROADMAP Queue 1, LM scaffold "
              "item 10.3)")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"        # the port serves "dense" only
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
                "stablelm_12b"]


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
    the dense fields the port has)."""
    return cfg.replace(
        name=cfg.name + "-smoke", n_layers=min(cfg.n_layers, 4), d_model=128,
        d_ff=256 if cfg.d_ff else 0, vocab=512, loss_chunk=128,
        attn_chunk_kv=64, n_heads=4,
        n_kv=min(max(cfg.n_kv * 4 // cfg.n_heads, 1), 4), d_head=32)


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` unless ``cfg`` is a dense GQA decoder."""
    if cfg.family != "dense" or cfg.mrope:
        raise NotImplementedError(f"{cfg.name}: {NOT_PORTED}")
