"""phi4-mini-3.8b [dense] — RoPE (partial rotary), SwiGLU, GQA kv=8.
[arXiv:2412.08905]

NOTE: 24 q heads do not divide the 16-way model axis; the framework pads q
heads to 32 (zero-weight heads). See DESIGN.md §Arch-applicability.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=200064,
    rope_fraction=0.75,
    rope_theta=1e4,
    source="arXiv:2412.08905 (Phi-4 technical report; mini dims)",
)
