"""pixtral-12b [vlm] — pixtral-ViT frontend (stub) + mistral-nemo decoder.
[hf:mistralai/Pixtral-12B-2409]

The vision encoder + projector are STUBBED per the task spec: ``input_specs``
provides precomputed patch embeddings of shape (batch, seq, d_model); this
config describes the language decoder that consumes them.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1e6,
    embed_frontend=True,
    source="hf:mistralai/Pixtral-12B-2409",
)
