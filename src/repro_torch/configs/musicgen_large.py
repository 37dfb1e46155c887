"""MusicGen-large decoder backbone over EnCodec tokens [arXiv:2306.05284; hf].

48L d_model=2048 32H (kv=32 -> MHA) d_ff=8192 vocab=2048.  The EnCodec
frontend is a stub: the backbone takes precomputed frame embeddings
(``batch["frames"]``), has no token embedding, and always an LM head.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen_large", family="audio", num_layers=48, d_model=2048,
    n_heads=32, n_kv_heads=32, d_ff=8192, vocab_size=2048,
    frontend="audio", rope_theta=10000.0,
)
