"""falcon-mamba-7b [ssm]: 64L d_model=4096 (attn-free) d_ff=0 vocab=65024,
ssm_state=16 — mamba1 arch [arXiv:2410.05355; unverified]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=0, n_kv=0, d_head=0,
    d_ff=0, vocab=65024,
    ssm_state=16, ssm_version=1, expand=2, d_conv=4,
))
