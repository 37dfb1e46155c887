"""InternVL2-2B [arXiv:2404.16821; hf]: InternLM2 backbone 24L d=2048 16H kv=8.

The InternViT frontend is a stub: the backbone takes 256 precomputed patch
embeddings (``batch["patch_embeds"]``) before the text tokens.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2_2b", family="vlm", num_layers=24, d_model=2048,
    n_heads=16, n_kv_heads=8, d_ff=8192, vocab_size=92553,
    frontend="vision", n_frontend_tokens=256,
)
