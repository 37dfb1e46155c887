"""LLaMA2-13B [arXiv:2307.09288] — the paper's scaling model (MHA)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama2_13b", num_layers=40, d_model=5120,
    n_heads=40, n_kv_heads=40, d_ff=13824, vocab_size=32000,
)
