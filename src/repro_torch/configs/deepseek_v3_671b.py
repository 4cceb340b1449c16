"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8, MTP.
[arXiv:2412.19437]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    d_ff=18432,                 # leading dense layers
    vocab_size=129280,
    use_mla=True,
    kv_lora_rank=512,
    q_lora_rank=1536,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    head_dim=192,
    num_experts=256,
    num_shared_experts=1,
    top_k=8,
    moe_d_ff=2048,
    first_dense_layers=3,
    mtp=True,
    source="arXiv:2412.19437 (DeepSeek-V3)",
)
