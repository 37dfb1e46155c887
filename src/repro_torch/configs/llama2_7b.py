"""LLaMA2-7B [arXiv:2307.09288] — the paper's own primary model (MHA)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama2_7b", num_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=32, d_ff=11008, vocab_size=32000,
)
