"""Jamba-v0.1 [arXiv:2403.19887; hf]: 32L d=4096 32H kv=8 dff=14336,
Mamba:attn 7:1 interleave (attn at layer i%8==3), MoE 16e top-2 every 2nd layer."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba_v0_1_52b", family="hybrid", num_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab_size=65536,
    n_experts=16, top_k=2, moe_dff=14336, moe_every=2, moe_offset=1,
    ssm_state=16, ssm_conv=4, ssm_expand=2, attn_period=8, attn_offset=3,
)
