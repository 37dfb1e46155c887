"""Qwen3-MoE-235B-A22B style [hf:Qwen/Qwen3-30B-A3B family]:
94L d=4096 64H (d_head=128) kv=4 MoE 128e top-8 expert dff=1536."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3_moe_235b", family="moe", num_layers=94, d_model=4096,
    n_heads=64, n_kv_heads=4, d_head=128, d_ff=1536, vocab_size=151936,
    n_experts=128, top_k=8, moe_dff=1536, rope_theta=1000000.0,
)
