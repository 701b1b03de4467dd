"""zamba2-1.2b [hybrid]: 38L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=32000, ssm_state=64 — Mamba2 + shared attn blocks [arXiv:2411.15242;
hf]. One shared attention+MLP block applied every 6 Mamba2 layers (weights
shared across applications, per the Zamba2 design)."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv=32, d_head=64,
    d_ff=8192, vocab=32000,
    ssm_state=64, ssm_version=2, ssm_headdim=64, expand=2, n_groups=1,
    attn_every=6,
))
