"""deepseek-v2-lite-16b [moe] — MLA kv_lora=512, 2 shared + 64 routed top-6.
[arXiv:2405.04434]

NOTE: the assignment line lists both "64e top-6" and "160 routed"; 160 routed
is the full V2 — V2-*Lite* has 64 routed experts (top-6) and 2 shared, which
is what we implement. moe_d_ff = 1408 as assigned.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=10944,                 # the single leading dense layer
    vocab_size=102400,
    use_mla=True,
    kv_lora_rank=512,
    q_lora_rank=0,              # lite: no q compression
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    head_dim=192,               # nope + rope
    num_experts=64,
    num_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,
    first_dense_layers=1,
    source="arXiv:2405.04434 (DeepSeek-V2; Lite dims)",
)
