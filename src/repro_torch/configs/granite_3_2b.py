"""Granite-3.0-2B base [hf:ibm-granite/granite-3.0-2b-base]: 40L d=2048 32H kv=8."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite_3_2b", num_layers=40, d_model=2048,
    n_heads=32, n_kv_heads=8, d_ff=8192, vocab_size=49155,
    tie_embeddings=True,
)
