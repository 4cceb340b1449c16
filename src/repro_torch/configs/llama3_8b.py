"""llama3-8b [dense] — GQA kv=8, 128k vocab. [arXiv:2407.21783]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=5e5,
    source="arXiv:2407.21783 (The Llama 3 Herd of Models)",
)
