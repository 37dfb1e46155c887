"""TinyLlama-1.1B [arXiv:2401.02385; hf]: 22L d=2048 32H kv=4 dff=5632."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama_1_1b", num_layers=22, d_model=2048,
    n_heads=32, n_kv_heads=4, d_ff=5632, vocab_size=32000,
)
