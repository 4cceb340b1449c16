"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2.
[arXiv:2403.19887]

Adaptation note: Jamba v0.1 uses Mamba-1 blocks; this framework implements the
SSD (Mamba-2) formulation for all SSM blocks — same state-space family,
MXU-friendlier scan (see DESIGN.md).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    # 1 attention layer per 8, offset 4 (as in the released model)
    attn_every=8,
    attn_offset=4,
    # MoE on every second layer: 16 experts, top-2
    num_experts=16,
    top_k=2,
    moe_d_ff=14336,
    moe_every=2,
    # SSD block dims (adapted from Jamba's mamba config)
    ssm_d_state=16,
    ssm_d_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=128,
    source="arXiv:2403.19887 (Jamba)",
)
