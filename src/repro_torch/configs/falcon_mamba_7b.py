"""Falcon-Mamba-7B [arXiv:2410.05355]: 64L d=4096 mamba1, state=16, attn-free.

EliteKV does not apply (no attention, no KV cache): the arch runs without
the technique.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="falcon_mamba_7b", family="ssm", num_layers=64, d_model=4096,
    n_heads=1, n_kv_heads=1, d_ff=0, vocab_size=65024,
    ssm_state=16, ssm_conv=4, ssm_expand=2, attn_period=0,
)
