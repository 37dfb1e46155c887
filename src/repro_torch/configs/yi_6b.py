"""Yi-6B llama-arch GQA [arXiv:2403.04652; hf]: 32L d=4096 32H kv=4 dff=11008."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi_6b", num_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=4, d_ff=11008, vocab_size=64000,
    rope_theta=5000000.0,
)
