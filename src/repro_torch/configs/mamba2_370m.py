"""mamba2-370m [ssm] — SSD (state-space duality), attention-free.
[arXiv:2405.21060]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=0,
    num_kv_heads=0,
    head_dim=64,
    d_ff=0,
    vocab_size=50280,
    ssm_d_state=128,
    ssm_d_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=128,
    source="arXiv:2405.21060 (Mamba-2 / SSD)",
)
