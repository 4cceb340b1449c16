"""Model / run configuration system.

Every assigned architecture gets one file in this package defining a
:class:`ModelConfig` with the exact published dimensions (source cited in the
docstring). ``reduced()`` derives the CPU smoke-test variant (2 layers,
d_model <= 512, <= 4 experts) of the same family.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def _pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class ModelConfig:
    name: str
    family: str                      # dense | ssm | hybrid | moe | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None

    # attention flavor
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e4
    rope_fraction: float = 1.0       # phi4: partial rotary
    sliding_window: int = 0          # >0: sliding-window attention (long decode)

    # MLA (deepseek)
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0             # 0 = no q compression
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # MoE
    num_experts: int = 0             # routed experts (0 = dense MLP)
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0      # deepseek: leading dense layers
    moe_every: int = 1               # jamba: MoE layer every k-th layer
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # SSM (mamba2-style SSD)
    ssm_d_state: int = 0
    ssm_d_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    attn_every: int = 0              # hybrid: 1 attention layer per k (jamba 8)
    attn_offset: int = 0             # position of attn layer within the period

    # encoder-decoder (whisper)
    encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_seq: int = 0             # frames after the conv frontend stub

    # modality frontend stub (vlm/audio): inputs are embeddings, not ids
    embed_frontend: bool = False

    # MTP (deepseek v3)
    mtp: bool = False
    mtp_weight: float = 0.3

    # numerics
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    tie_embeddings: bool = False
    use_pallas: bool = False         # TPU deployment path: Pallas kernels

    source: str = ""                 # citation for the dimensions

    # ---- derived -------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim is None and self.num_heads:
            self.head_dim = self.d_model // self.num_heads

    def padded_vocab(self, multiple: int = 128) -> int:
        return _pad_to(self.vocab_size, multiple)

    def padded_heads(self, tp: int) -> int:
        """q heads padded up to a multiple of the tensor-parallel degree."""
        return _pad_to(self.num_heads, tp)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer kind: 'attn' | 'ssm', used by hybrid archs."""
        kinds = []
        for i in range(self.num_layers):
            if self.family == "ssm":
                kinds.append("ssm")
            elif self.attn_every:
                kinds.append("attn" if i % self.attn_every == self.attn_offset
                             else "ssm")
            else:
                kinds.append("attn")
        return tuple(kinds)

    def mlp_kinds(self) -> Tuple[str, ...]:
        """Per-layer MLP kind: 'dense' | 'moe' | 'none' (pure ssm layer)."""
        kinds = []
        for i in range(self.num_layers):
            if self.family == "ssm":
                kinds.append("none")      # mamba2 blocks have no separate MLP
            elif self.num_experts and i >= self.first_dense_layers \
                    and (i % self.moe_every == (self.moe_every - 1)
                         if self.moe_every > 1 else True):
                kinds.append("moe")
            else:
                kinds.append("dense")
        return tuple(kinds)

    # ---- parameter count (for MODEL_FLOPS = 6 N D) ----------------------------
    def param_count(self, active_only: bool = False) -> int:
        V, d = self.padded_vocab(), self.d_model
        n = V * d            # embedding
        if not self.tie_embeddings:
            n += V * d       # unembedding
        for kind, mlp in zip(self.layer_kinds(), self.mlp_kinds()):
            n += 2 * d       # rms norms
            if kind == "attn":
                if self.use_mla:
                    qd = self.qk_nope_head_dim + self.qk_rope_head_dim
                    if self.q_lora_rank:
                        n += d * self.q_lora_rank + self.q_lora_rank * self.num_heads * qd
                    else:
                        n += d * self.num_heads * qd
                    n += d * (self.kv_lora_rank + self.qk_rope_head_dim)
                    n += self.kv_lora_rank * self.num_heads * (
                        self.qk_nope_head_dim + self.v_head_dim)
                    n += self.num_heads * self.v_head_dim * d
                else:
                    hd = self.head_dim
                    n += d * self.num_heads * hd          # q
                    n += 2 * d * self.num_kv_heads * hd   # k, v
                    n += self.num_heads * hd * d          # o
            else:  # ssm
                di, ns, nh = self.ssm_d_inner, self.ssm_d_state, self.ssm_heads
                n += d * (2 * di + 2 * ns + nh)  # in_proj (x,z) + B,C + dt
                n += di * self.ssm_d_conv + 2 * nh  # conv + A + D
                n += di * d                      # out_proj
            if mlp == "dense":
                n += 3 * d * self.d_ff
            elif mlp == "moe":
                e_all = self.num_experts
                e_act = self.top_k
                e = e_act if active_only else e_all
                n += 3 * d * self.moe_d_ff * e
                n += 3 * d * self.moe_d_ff * self.num_shared_experts
                n += d * self.num_experts      # router
        if self.encoder_decoder:
            # encoder layers: self-attn + dense mlp; decoder adds cross-attn
            hd = self.head_dim
            per_enc = (d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd
                       + self.num_heads * hd * d + 3 * d * self.d_ff + 2 * d)
            n += self.num_encoder_layers * per_enc
            n += self.num_layers * (d * self.num_heads * hd
                                    + 2 * d * self.num_kv_heads * hd
                                    + self.num_heads * hd * d + d)  # cross-attn
        return n

    # ---- reduced variant for CPU smoke tests -----------------------------------
    def reduced(self) -> "ModelConfig":
        r = dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=2,
            d_model=min(self.d_model, 256),
            num_heads=4,
            num_kv_heads=min(max(1, self.num_kv_heads), 2),
            head_dim=64,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 1024),
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            moe_d_ff=min(self.moe_d_ff, 256) if self.moe_d_ff else 0,
            first_dense_layers=min(self.first_dense_layers, 1),
            capacity_factor=8.0,   # no token drops: keeps decode == prefill

            kv_lora_rank=min(self.kv_lora_rank, 64) if self.kv_lora_rank else 0,
            q_lora_rank=min(self.q_lora_rank, 64) if self.q_lora_rank else 0,
            qk_nope_head_dim=64 if self.qk_nope_head_dim else 0,
            qk_rope_head_dim=32 if self.qk_rope_head_dim else 0,
            v_head_dim=64 if self.v_head_dim else 0,
            ssm_d_state=min(self.ssm_d_state, 32) if self.ssm_d_state else 0,
            ssm_head_dim=32 if self.ssm_d_state else 64,
            ssm_chunk=32,
            attn_every=min(self.attn_every, 2) if self.attn_every else 0,
            attn_offset=min(self.attn_offset, 1),
            moe_every=min(self.moe_every, 2),
            num_encoder_layers=2 if self.encoder_decoder else 0,
            encoder_seq=min(self.encoder_seq, 64) if self.encoder_seq else 0,
            dtype="float32",
        )
        return r


# ---------------------------------------------------------------------------
# Input shapes (assigned).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str     # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
