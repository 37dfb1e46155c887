"""Snowflake Arctic base [hf:Snowflake/snowflake-arctic-base]:
35L d=7168 56H kv=8 MoE 128e top-2 dff=4864 + dense residual MLP."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic_480b", family="moe", num_layers=35, d_model=7168,
    n_heads=56, n_kv_heads=8, d_ff=4864, vocab_size=32000,
    n_experts=128, top_k=2, moe_dff=4864, dense_residual=True,
)
