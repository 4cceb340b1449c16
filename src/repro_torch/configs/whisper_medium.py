"""whisper-medium [audio] — encoder-decoder, conv frontend STUB.
[arXiv:2212.04356]

The mel-spectrogram + conv feature extractor is stubbed per the task spec:
``input_specs`` provides precomputed frame embeddings (batch, 1500, d_model)
for the encoder. This config describes the transformer backbone.

long_500k is SKIPPED for this arch (full-attention enc-dec, 448-token decoder
context by design) — see DESIGN.md §Arch-applicability.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51865,
    encoder_decoder=True,
    num_encoder_layers=24,
    encoder_seq=1500,
    embed_frontend=True,
    source="arXiv:2212.04356 (Whisper)",
)
