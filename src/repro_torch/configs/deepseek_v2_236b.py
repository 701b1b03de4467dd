"""deepseek-v2-236b [moe]: 60L d_model=5120 128H (GQA kv=128) d_ff=1536
vocab=102400, MoE 160e top-6 — MLA kv_lora=512, 2 shared + 160 routed top-6
[arXiv:2405.04434; hf]. d_ff=1536 is the per-expert width; the single leading
dense layer uses the paper's 12288. The reference's ``expert_shard``
(experts over a model mesh) has no meaning on one card and is left out."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv=128, d_head=128,
    d_ff=12288, vocab=102400,
    n_experts=160, top_k=6, n_shared=2, d_ff_expert=1536, first_dense=1,
    mla=True, kv_lora=512, mla_nope_dim=128, mla_rope_dim=64, mla_v_dim=128,
))
