"""MiniCPM-2B [arXiv:2404.06395; hf]: 40L d=2304 36H kv=36 dff=5760 vocab=122753."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm_2b", num_layers=40, d_model=2304,
    n_heads=36, n_kv_heads=36, d_ff=5760, vocab_size=122753,
    tie_embeddings=True,
)
