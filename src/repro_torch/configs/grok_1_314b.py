"""grok-1-314b [moe]: 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8 experts top-2 [hf:xai-org/grok-1; unverified]. The
reference's ``expert_shard=False`` (tensor parallelism over the expert FFN
dim on a model mesh) has no meaning on one card and is left out."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv=8, d_head=128,
    d_ff=32768, vocab=131072,
    n_experts=8, top_k=2, d_ff_expert=32768,
))
