"""Model assembly: embeddings, blocks, stack slices, the training loss.

Port of ``repro/models/transformer.py`` for the ``attn``/``dense`` layer
kinds (dense GQA decoders such as qwen3, llama3, qwen2.5) and the
``ssm``/``none`` kind (attention-free Mamba-2 stacks such as mamba2-370m):
the serving half (prefill and decode over stack slices) and the training
half (:func:`lm_loss`, :func:`_run_body`, :func:`forward_loss` on one
device, :func:`mesh_loss_program` on a mesh), each also tensor- and
data-parallel on a ``("data", "model")`` mesh, one call per rank inside
:func:`repro_torch.core.mesh.spmd`. MLA attention and ``attn``/``moe``
layers (deepseek-v2-lite: a leading dense layer, then MLA with a
capacity-routed MoE) are served and trained too, on one device and on
meshes (heads and experts split over ``model``, the latent cache
replicated over it), the routers' load-balance losses summed into the
training loss as the reference sums them. The two frontend
architectures run on one device and on meshes (heads split over
``model``, the encoder's output replicated over it): an embed frontend
(pixtral: the decoder reads patch embeddings, ``{"embeds", "labels"}``)
and an encoder-decoder (whisper: ``enc_blocks``, a non-causal attn/dense
stack over frame embeddings plus a sinusoid, its ``enc_norm``, and a
cross-attention branch, ``ln_x`` and ``xattn``, in every decoder block of
the body, whose cross cache holds the rank's kv heads). Their serving is
the reference's whole-model :func:`prefill` and :func:`decode_step` (its
classic loop), not the stage slices. A hybrid (jamba: Mamba-2 layers with
a dense MLP or an MoE after the mixer, ``ssm``/``dense`` and
``ssm``/``moe``, one attention layer in 8) is served through the stage
slices, on one device and on a mesh; training it raises
(:func:`check_trainable`, ROADMAP Queue 1 item 22). A config with
multi-token prediction (deepseek-v3: ``cfg.mtp``) holds the MTP module
beside the stack (``mtp_norm_h``, ``mtp_norm_e``, ``mtp_proj``,
``mtp_block``), which only the training loss reads (:func:`mtp_loss` on
one device, MTP's segments of :func:`mesh_loss_program` on a mesh).
The reference stacks each period slot's params over periods and scans them;
here a model is an ``nn.Module`` holding a flat ``blocks`` list in layer
order, and :mod:`repro_torch.models.convert` maps the reference's stacked
tree onto it (layer ``n_pro + i*P + j`` is ``body[j][...][i]``).

Decode caches are a list with one dict per layer, ``{"k", "v"}`` for a GQA
layer (an encoder-decoder's also ``{"xk", "xv"}``, the encoder's cross
keys and values rounded to bfloat16), ``{"c", "kpe"}`` (the latent and the
rope key) for an MLA layer and ``{"h", "tail_x", "tail_bc"}`` for an SSM
layer; a stage holds the entries of its own layers.

On a mesh each rank holds its shard of every parameter under
:func:`model_specs` (cut by :func:`shard_params`): the heads and the MLP's
hidden units over ``model`` (column-parallel ``wq``, ``w_gate``, ``w_up``,
row-parallel ``wo``, ``w_down``, whose outputs are P(sum) and psummed by
:func:`apply_block` / :func:`decode_block`), an SSM layer's heads likewise
(``repro_torch.models.mamba``: ``w_x``/``w_z``/``w_dt`` column-parallel,
``out_proj`` row-parallel, ``w_bc``/``conv_bc`` replicated), MLA's heads
(``wq``/``wq_b``, ``w_uk``, ``w_uv`` column-parallel, ``wo``
row-parallel, the latent projection replicated), the MoE's experts (the
stacks S(0), the router replicated, the shared experts as a dense MLP),
the vocabulary over ``model`` (:func:`embed_tokens` masks and psums; the
head's logits are S(1)), and everything replicated over ``data``.
"""
from __future__ import annotations

import copy
import dataclasses
import math
from types import SimpleNamespace
from typing import Callable, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import mesh as M
from repro_torch.core.sbp import NdSbp, ndsbp
from repro_torch.core.tape import INTERNAL, LocalProgram, Step
from repro_torch.kernels.softmax_xent import combine_stats, xent_local_stats
from repro_torch.models.attention import (GQAttention, MLAttention,
                                          cross_attn_decode, gqa_decode,
                                          gqa_forward, init_gqa, init_mla,
                                          kv_to_seq_sharded, mla_decode,
                                          mla_forward)
from repro_torch.models.common import (Boxer, MeshPlan, aux_pmean_step,
                                       branch_psum_step, dense_init,
                                       grad_sync_step, param, resolve_device,
                                       rms_norm)
from repro_torch.models.mamba import (FLOAT32_PARAMS, Mamba, init_mamba,
                                      mamba_decode, mamba_forward)
from repro_torch.models.mlp import (DenseMLP, MoE, dense_mlp_forward,
                                    init_dense_mlp, init_moe, moe_forward)

Kind = Tuple[str, str]        # (layer kind, mlp kind)
#: the layer kinds the port builds
SUPPORTED_KINDS = (("attn", "dense"), ("ssm", "none"), ("attn", "moe"),
                   ("ssm", "dense"), ("ssm", "moe"))


# ---------------------------------------------------------------------------
# layer grouping
# ---------------------------------------------------------------------------

def _period(cfg: ModelConfig) -> int:
    p = 1
    if cfg.attn_every:
        p = cfg.attn_every
    if cfg.num_experts and cfg.moe_every > 1:
        p = math.lcm(p, cfg.moe_every)
    return p


@dataclasses.dataclass(frozen=True)
class StackLayout:
    prologue: Tuple[Kind, ...]       # (kind, mlp_kind) per layer
    period_slots: Tuple[Kind, ...]
    n_periods: int

    def layer_kinds(self) -> List[Kind]:
        """Kinds of every layer in order (prologue, then period-major)."""
        return list(self.prologue) + list(self.period_slots) * self.n_periods


def stack_layout(cfg: ModelConfig) -> StackLayout:
    kinds, mlps = cfg.layer_kinds(), cfg.mlp_kinds()
    n_pro = cfg.first_dense_layers
    P = _period(cfg)
    body = cfg.num_layers - n_pro
    assert body % P == 0, (cfg.name, body, P)
    slots = tuple((kinds[n_pro + j], mlps[n_pro + j]) for j in range(P))
    for i in range(body // P):
        for j in range(P):
            li = n_pro + i * P + j
            assert (kinds[li], mlps[li]) == slots[j], (cfg.name, li)
    return StackLayout(tuple((kinds[i], mlps[i]) for i in range(n_pro)),
                       slots, body // P)


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what this package cannot build yet: a layer kind outside
    :data:`SUPPORTED_KINDS`."""
    kinds = set(stack_layout(cfg).layer_kinds())
    missing = [f"{k}/{m} layers" for (k, m) in sorted(kinds)
               if (k, m) not in SUPPORTED_KINDS]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet (ROADMAP "
            "Queue 1 item 13); the port builds attn/dense, attn/moe (GQA or "
            "MLA), ssm/none, ssm/dense and ssm/moe stacks, encoder-decoders "
            "and embed frontends")


def check_trainable(cfg: ModelConfig) -> None:
    """Raise for a hybrid whose SSM layers carry an MLP (jamba): the port
    serves it but does not train it yet (ROADMAP Queue 1 item 13), and no
    training path may run such a layer without its MLP branch."""
    hybrid = sorted({f"ssm/{m}" for k, m in stack_layout(cfg).layer_kinds()
                     if k == "ssm" and m != "none"})
    if hybrid:
        raise NotImplementedError(
            f"{cfg.name}: training {' and '.join(hybrid)} layers (a hybrid's "
            "SSM layers with an MLP) is ROADMAP Queue 1 item 13; serve it "
            "with api.compile(cfg, mode='serve')")


def has_frontend(cfg: ModelConfig) -> bool:
    """Whether ``cfg`` reads embeddings (an embed frontend) or has an
    encoder: the archs the reference serves only through its classic
    whole-model loop."""
    return cfg.embed_frontend or cfg.encoder_decoder


def check_mesh_supported(cfg: ModelConfig, plan: MeshPlan) -> None:
    """Raise where ``plan``'s mesh cannot run ``cfg``: a model axis that
    does not split the MLA heads, the routed experts or the SSM heads (each
    rank runs ``1 / tp`` of them, as the reference's specs cut them), or an
    encoder-decoder's heads: its cross cache is split by head over
    ``model`` (reference ``model_zoo.py:135-137``), so a rank holds whole q
    heads and a share of the kv heads (or, for fewer kv heads than ranks,
    its group's one)."""
    tp = plan.tp
    if cfg.use_mla and cfg.num_heads % tp:
        raise ValueError(f"{cfg.name}: {cfg.num_heads} MLA heads do not "
                         f"split over tp = {tp} ranks")
    if any(m == "moe" for _, m in stack_layout(cfg).layer_kinds()) \
            and cfg.num_experts % tp:
        raise ValueError(f"{cfg.name}: {cfg.num_experts} experts do not "
                         f"split over tp = {tp} ranks")
    if has_ssm_layers(cfg) and cfg.ssm_heads % tp:
        raise ValueError(f"{cfg.name}: {cfg.ssm_heads} SSM heads do not "
                         f"split over tp = {tp} ranks")
    kv = cfg.num_kv_heads
    if cfg.encoder_decoder and (cfg.num_heads % tp or (kv % tp and tp % kv)):
        raise ValueError(f"{cfg.name}: {cfg.num_heads} q heads and {kv} kv "
                         f"heads do not split over tp = {tp} ranks (the "
                         "cross cache is split by head)")


def has_ssm_layers(cfg: ModelConfig) -> bool:
    """Whether any layer of ``cfg`` is an SSM (Mamba-2) layer."""
    return any(k == "ssm" for k, _ in stack_layout(cfg).layer_kinds())


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[cfg.dtype]


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """One layer: ``ln1``, ``attn``, ``ln2``, ``mlp`` for an attn/dense
    ``kind`` (``ln2``, ``moe`` for attn/moe; ``attn`` is MLA when the
    config says so); ``ln1``, ``ssm`` for an ssm/none one (no MLP), and
    ``ln2`` with ``mlp`` or ``moe`` after it for ssm/dense or ssm/moe. A
    ``cross`` block (an encoder-decoder's decoder layer) also holds
    ``ln_x`` and ``xattn``, its cross-attention (reference
    ``transformer.py:81-99``)."""

    def __init__(self, cfg: ModelConfig, plan: MeshPlan,
                 kind: Kind = ("attn", "dense"), device=None,
                 dtype=torch.float32, cross: bool = False):
        super().__init__()
        assert kind in SUPPORTED_KINDS, kind
        d = cfg.d_model
        kw = dict(device=device, dtype=dtype)
        self.ln1 = param(torch.ones((d,), **kw))
        if cross:
            self.ln_x = param(torch.ones((d,), **kw))
            self.xattn = GQAttention(cfg, plan, cross=True, **kw)
        if kind[0] == "ssm":
            self.ssm = Mamba(cfg, plan, **kw)
        else:
            self.attn = (MLAttention(cfg, plan, **kw) if cfg.use_mla
                         else GQAttention(cfg, plan, **kw))
        if kind[1] == "none":
            return
        self.ln2 = param(torch.ones((d,), **kw))
        if kind[1] == "moe":
            self.moe = MoE(cfg, **kw)
        else:
            self.mlp = DenseMLP(d, cfg.d_ff, **kw)


def is_cross(cfg: ModelConfig, layer: int) -> bool:
    """Whether decoder layer ``layer`` has a cross-attention branch: every
    body layer of an encoder-decoder (the reference builds its prologue
    blocks without one, ``transformer.py:254-262``)."""
    return cfg.encoder_decoder and layer >= len(stack_layout(cfg).prologue)


class Transformer(nn.Module):
    """The whole model: ``embed (Vp, d)``, ``blocks``, ``final_norm``,
    ``unembed (d, Vp)`` — float32 params, as the reference keeps them; an
    encoder-decoder also ``enc_blocks`` (``num_encoder_layers`` attn/dense
    blocks) and ``enc_norm``; a config with multi-token prediction
    (``cfg.mtp``, deepseek-v3) also its module (reference
    ``transformer.py:276-280``): ``mtp_norm_h`` and ``mtp_norm_e`` (d,),
    ``mtp_proj (2d, d)`` and ``mtp_block``, an attn/dense block (MLA when
    the config says so). Only the training loss reads them."""

    def __init__(self, cfg: ModelConfig, plan: MeshPlan, device=None,
                 dtype=torch.float32):
        super().__init__()
        check_supported(cfg)
        d, Vp = cfg.d_model, cfg.padded_vocab()
        kw = dict(device=device, dtype=dtype)
        self.cfg, self.plan = cfg, plan
        self.embed = param(torch.empty((Vp, d), **kw))
        self.blocks = nn.ModuleList(
            Block(cfg, plan, kind=kind, device=device, dtype=dtype,
                  cross=is_cross(cfg, i))
            for i, kind in enumerate(stack_layout(cfg).layer_kinds()))
        self.final_norm = param(torch.ones((d,), **kw))
        self.unembed = param(torch.empty((d, Vp), **kw))
        if cfg.encoder_decoder:
            self.enc_blocks = nn.ModuleList(
                Block(cfg, plan, device=device, dtype=dtype)
                for _ in range(cfg.num_encoder_layers))
            self.enc_norm = param(torch.ones((d,), **kw))
        if cfg.mtp:
            self.mtp_norm_h = param(torch.ones((d,), **kw))
            self.mtp_norm_e = param(torch.ones((d,), **kw))
            self.mtp_proj = param(torch.empty((2 * d, d), **kw))
            self.mtp_block = Block(cfg, plan, device=device, dtype=dtype)


def cast_copy(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """A copy of ``module`` whose parameters are cast to ``dtype`` (shared,
    not copied, where they already have it: a model built in its compute
    dtype is held once, however many stages and sessions serve it), but for
    those the model reads in float32
    (:data:`repro_torch.models.mamba.FLOAT32_PARAMS`)."""
    memo = {id(p): param(p.detach().to(
        torch.float32 if name.rsplit(".", 1)[-1] in FLOAT32_PARAMS
        else dtype)) for name, p in module.named_parameters()}
    return copy.deepcopy(module, memo)


def init_block(gen: torch.Generator, cfg: ModelConfig, plan: MeshPlan,
               kind: str, mlp_kind: str, dtype=torch.float32,
               cross: bool = False) -> Block:
    """One layer's seeded weights, drawn in float32 and cast to ``dtype``
    as :func:`cast_copy` casts them; an MoE's expert stacks are cast leaf
    by leaf as they are drawn (:func:`~repro_torch.models.mlp.init_moe`),
    the same values without the block's float32 copy (deepseek-v3's three
    stacks are 15.0 GB each in float32)."""
    with torch.device("meta"):
        blk = Block(cfg, plan, kind=(kind, mlp_kind),  # shapes; filled below
                    cross=cross)
    blk.ln1 = param(torch.ones((cfg.d_model,), device=gen.device))
    if cross:
        blk.ln_x = param(torch.ones((cfg.d_model,), device=gen.device))
        blk.xattn = init_gqa(gen, cfg, plan, cross=True)
    if kind == "ssm":
        blk.ssm = init_mamba(gen, cfg, plan)
    else:
        blk.attn = (init_mla(gen, cfg, plan) if cfg.use_mla
                    else init_gqa(gen, cfg, plan))
    if mlp_kind == "none":
        return cast_copy(blk, dtype)
    blk.ln2 = param(torch.ones((cfg.d_model,), device=gen.device))
    if mlp_kind == "moe":
        blk.moe = init_moe(gen, cfg, dtype=dtype)
    else:
        blk.mlp = init_dense_mlp(gen, cfg.d_model, cfg.d_ff)
    return cast_copy(blk, dtype)


def init_model(cfg: ModelConfig, plan: MeshPlan, seed: int = 0,
               device=None, dtype=None) -> Transformer:
    """The port's own seeded init at the config's widths (params on
    ``device``; None means the card). Same distributions as the reference's
    ``init_model``; the draws differ (``torch.Generator`` vs
    ``jax.random``), and so do a CPU's and a card's. Every leaf is drawn in
    float32; ``dtype`` (None: float32) casts each block to that dtype as it
    is built (:func:`cast_copy`), and an MoE's expert stacks each as it is
    drawn: the values a later cast would give, without a whole float32
    model on the device (deepseek-v2-lite's 15.7 B params are 62.8 GB in
    float32; the largest float32 transient is then one expert stack, 15.0
    GB for deepseek-v3). A config with ``mtp`` draws its MTP module last,
    after every other leaf, so the other leaves' draws are those of the
    same config without it."""
    device = resolve_device(device)
    dtype = torch.float32 if dtype is None else dtype
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    with torch.device("meta"):
        model = Transformer(cfg, plan)          # shapes only; filled below
    d, Vp = cfg.d_model, cfg.padded_vocab()
    model.embed = param(dense_init(gen, (Vp, d), in_axis=1, dtype=dtype))
    model.unembed = param(dense_init(gen, (d, Vp), dtype=dtype))
    model.final_norm = param(torch.ones((d,), device=device, dtype=dtype))
    model.blocks = nn.ModuleList(
        init_block(gen, cfg, plan, k, m, dtype=dtype, cross=is_cross(cfg, i))
        for i, (k, m) in enumerate(stack_layout(cfg).layer_kinds()))
    if cfg.encoder_decoder:
        model.enc_blocks = nn.ModuleList(
            init_block(gen, cfg, plan, "attn", "dense", dtype=dtype)
            for _ in range(cfg.num_encoder_layers))
        model.enc_norm = param(torch.ones((d,), device=device, dtype=dtype))
    if cfg.mtp:
        model.mtp_norm_h = param(torch.ones((d,), device=device, dtype=dtype))
        model.mtp_norm_e = param(torch.ones((d,), device=device, dtype=dtype))
        model.mtp_proj = param(dense_init(gen, (2 * d, d), dtype=dtype))
        model.mtp_block = init_block(gen, cfg, plan, "attn", "dense",
                                     dtype=dtype)
    return model


# ---------------------------------------------------------------------------
# forward pieces
# ---------------------------------------------------------------------------

def embed_local(p_embed, ids, plan: MeshPlan):
    """This rank's part of the vocab-parallel embedding: a masked gather
    from its vocab rows, P(sum) over the model axis (the whole lookup at
    tp = 1). Exactly one rank holds each id, so the others give zeros.
    The gather is ``F.embedding``, whose backward sums each row's
    contributions in one order on every run (the ids clamped to an edge
    row pile up there; indexing's accumulating backward adds them in a
    varying order on the CPU)."""
    if plan.tp == 1:
        return p_embed[ids.long()]
    V_loc = p_embed.shape[0]
    local = ids.long() - M.axis_index(plan.model_axis) * V_loc
    ok = (local >= 0) & (local < V_loc)
    e = F.embedding(local.clamp(0, V_loc - 1), p_embed)
    return torch.where(ok[..., None], e, torch.zeros((), dtype=e.dtype,
                                                     device=e.device))


def embed_tokens(p_embed, ids, plan: MeshPlan):
    """Vocab-parallel embedding: :func:`embed_local` -> P(sum) -> psum over
    the model axis (a plain gather at tp = 1)."""
    return Boxer(plan).psum_model(embed_local(p_embed, ids, plan))


def _mlp_branch(p: Block, x, cfg: ModelConfig, plan: MeshPlan,
                mlp_kind: str):
    """The MLP branch: ``(out, aux)``, its output (P(sum) on a mesh) and
    its router's load-balance loss -- the MoE's (on the rank's experts,
    the aux whole on every rank), or None for the dense SwiGLU."""
    h2 = rms_norm(x, p.ln2.to(x.dtype), cfg.norm_eps)
    if mlp_kind == "moe":
        return moe_forward(p.moe, h2, cfg, plan)
    return dense_mlp_forward(p.mlp, h2), None


def apply_block(p: Block, x, cfg: ModelConfig, plan: MeshPlan, kind: str,
                mlp_kind: str, positions, causal: bool = True,
                sliding_window: int = 0, want_cache: bool = False,
                cache_len: int = 0, enc=None):
    """Prefill one block. Returns ``(x, aux, cache_or_None)``: ``aux`` the
    MoE router's load-balance loss (float32; None for a block without a
    router, whose aux the reference counts as 0). A GQA layer's
    cache holds the prompt's k/v in bfloat16 (the reference's prefill
    cache dtype): unpadded at tp = 1, and at tp > 1 padded to
    ``cache_len`` and boxed to this rank's sequence block
    (:func:`~repro_torch.models.attention.kv_to_seq_sharded`); an MLA
    layer's holds the prompt's latent ``c`` and rope key ``kpe``, rounded
    to bfloat16 as the reference rounds them (``transformer.py:147-149``,
    in a float32 config too); an SSM layer's holds the final state ``h``
    of the rank's heads and the conv tails. The stage's ``write_slot``
    places any of them in the group cache. With ``enc`` (the encoder's
    output) a cross block runs its cross-attention branch after
    self-attention (``:169-178``), and its cache also holds the branch's
    ``xk``/``xv``, rounded to bfloat16 in a float32 config too."""
    psum = Boxer(plan).psum_model        # the branch P(sum) -> B
    h = rms_norm(x, p.ln1.to(x.dtype), cfg.norm_eps)
    cache = None
    if kind == "ssm":
        if want_cache:
            a, (hs, (tx, tbc)) = mamba_forward(p.ssm, h, cfg, plan,
                                               return_state=True)
            cache = {"h": hs, "tail_x": tx, "tail_bc": tbc}
        else:
            a = mamba_forward(p.ssm, h, cfg, plan)
    elif cfg.use_mla:
        a, (c, kpe) = mla_forward(p.attn, h, cfg, plan, positions,
                                  sliding_window)
        if want_cache:
            cache = {"c": c.to(torch.bfloat16), "kpe": kpe.to(torch.bfloat16)}
    else:
        a, (k, v) = gqa_forward(p.attn, h, cfg, plan, positions,
                                causal=causal, sliding_window=sliding_window)
        if want_cache:
            k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
            if plan.tp > 1:
                k, v = kv_to_seq_sharded(k, v, cfg, plan, cache_len)
            cache = {"k": k, "v": v}
    x = x + psum(a)
    if enc is not None and hasattr(p, "xattn"):
        hx = rms_norm(x, p.ln_x.to(x.dtype), cfg.norm_eps)
        ax, (xk, xv) = gqa_forward(
            p.xattn, hx, cfg, plan, positions, causal=False, kv_src=enc,
            kv_positions=torch.arange(enc.shape[1], device=enc.device))
        if want_cache:
            cache = dict(cache or {}, xk=xk.to(torch.bfloat16),
                         xv=xv.to(torch.bfloat16))
        x = x + psum(ax)
    if mlp_kind == "none":
        return x, None, cache
    mo, aux = _mlp_branch(p, x, cfg, plan, mlp_kind)
    return x + psum(mo), aux, cache


def decode_block(p: Block, x, cache: Dict[str, torch.Tensor], pos,
                 cfg: ModelConfig, plan: MeshPlan, kind: str, mlp_kind: str,
                 sliding_window: int = 0):
    """Single-token step; updates ``cache`` in place (a ring cache's slot
    position table ``pos`` too). Returns (x, cache)."""
    psum = Boxer(plan).psum_model        # the branch P(sum) -> B
    h = rms_norm(x, p.ln1.to(x.dtype), cfg.norm_eps)
    if kind == "ssm":
        a, state = mamba_decode(p.ssm, h, (cache["h"], cache["tail_x"],
                                           cache["tail_bc"]), cfg, plan)
        for key, new in zip(("h", "tail_x", "tail_bc"), state):
            cache[key].copy_(new)
    elif cfg.use_mla:
        a = mla_decode(p.attn, h, cache["c"], cache["kpe"], pos, cfg, plan,
                       sliding_window)
    else:
        a = gqa_decode(p.attn, h, cache["k"], cache["v"], pos, cfg, plan,
                       sliding_window, cache_pos=cache.get("pos"))
    x = x + psum(a)
    if "xk" in cache:     # whisper's cross-attention over its static cache
        hx = rms_norm(x, p.ln_x.to(x.dtype), cfg.norm_eps)
        x = x + psum(cross_attn_decode(p.xattn, hx, cache["xk"],
                                       cache["xv"], cfg, plan))
    if mlp_kind != "none":
        x = x + psum(_mlp_branch(p, x, cfg, plan, mlp_kind)[0])
    return x, cache


def prefill_stack_slice(blocks: Sequence[Block], x, positions,
                        cfg: ModelConfig, plan: MeshPlan,
                        kinds: Sequence[Kind], sliding_window: int = 0,
                        cache_len: int = 0):
    """Prefill over a slice of the stack. x: (B, S, d) hidden entering the
    slice. Returns ``(x, caches)``, one per block (see :func:`apply_block`;
    ``cache_len`` is the decode cache's length, which tp > 1 pads to)."""
    caches = []
    for p, (kind, mlp_kind) in zip(blocks, kinds):
        x, _, cache = apply_block(p, x, cfg, plan, kind, mlp_kind,
                                  positions, True, sliding_window,
                                  want_cache=True, cache_len=cache_len)
        caches.append(cache)
    return x, caches


def decode_stack_slice(blocks: Sequence[Block], caches: List[Dict],
                       x, pos, cfg: ModelConfig, plan: MeshPlan,
                       kinds: Sequence[Kind], sliding_window: int = 0):
    """One decode step over a slice of the stack; composing the slices in
    order is the whole-model decode step. Returns (x, caches)."""
    for p, cache, (kind, mlp_kind) in zip(blocks, caches, kinds):
        x, _ = decode_block(p, x, cache, pos, cfg, plan, kind, mlp_kind,
                            sliding_window)
    return x, caches


def final_logits(final_norm, unembed, h, cfg: ModelConfig):
    """The decode head: final norm, then logits over the padded vocab (on a
    mesh, this rank's column-parallel vocab block: S(1) over ``model``,
    gathered by the stage before greedy or sampling)."""
    return rms_norm(h, final_norm, cfg.norm_eps) @ unembed


def prefill(model: Transformer, batch, cache_len: int,
            sliding_window: int = 0):
    """The whole-model prefill of the reference's classic serve loop
    (``repro/models/transformer.py:478-515``) on one device, or on one
    rank of a mesh (inside :func:`repro_torch.core.mesh.spmd`, ``model``
    holding the rank's shards and ``batch`` its rows): the prompt from
    ``{"tokens": (B, S)}`` (an encoder-decoder's decoder tokens plus the
    sinusoid, and ``"enc_embeds"`` through :func:`encode`) or, for an
    embed frontend, ``{"embeds": (B, S, d)}``. Returns ``(h_last,
    caches)``: the final-normed hidden at the last position (B, 1, d),
    replicated over ``model``, and one cache per layer (see
    :func:`apply_block`): each self-attention ``k``/``v`` zero-padded to
    ``cache_len`` positions as the reference's ``kv_to_seq_sharded`` pads
    them (at tp > 1 the rank's sequence block of them), an MLA latent
    padded likewise, a cross cache of the rank's kv heads; ready for
    decode at position S. No grad."""
    cfg, plan = model.cfg, model.plan
    check_supported(cfg)
    check_mesh_supported(cfg, plan)
    dev, cdt = model.embed.device, compute_dtype(cfg)
    with torch.no_grad():
        if "embeds" in batch_inputs(cfg, "prefill"):
            x = torch.as_tensor(batch["embeds"], device=dev).to(cdt)
        else:
            tokens = torch.as_tensor(batch["tokens"], dtype=torch.int32,
                                     device=dev)
            x = embed_tokens(model.embed, tokens, plan).to(cdt)
            if cfg.encoder_decoder:
                x = x + _sinusoid(x.shape[1], cfg.d_model, x.dtype, dev)
        S = x.shape[1]
        positions = torch.arange(S, device=dev)
        enc = (encode(model, batch["enc_embeds"], cfg, plan)
               if cfg.encoder_decoder else None)
        caches = []
        for p, (kind, mlp_kind) in zip(model.blocks,
                                       stack_layout(cfg).layer_kinds()):
            x, _, cache = apply_block(p, x, cfg, plan, kind, mlp_kind,
                                      positions, True, sliding_window,
                                      want_cache=True, cache_len=cache_len,
                                      enc=enc)
            for key in ("k", "v", "c", "kpe"):      # the sequence caches
                if key in cache and (key in ("c", "kpe") or plan.tp == 1):
                    cache[key] = _pad_positions(cache[key], cache_len)
            caches.append(cache)
        x = rms_norm(x, model.final_norm.to(x.dtype), cfg.norm_eps)
    return x[:, -1:], caches


def _pad_positions(t, length: int):
    """``t`` (B, S, ...) zero-padded to ``length`` positions on dim 1."""
    if t.shape[1] >= length:
        return t
    return torch.cat([t, t.new_zeros((t.shape[0], length - t.shape[1],
                                      *t.shape[2:]))], dim=1)


def decode_step(model: Transformer, caches: List[Dict], tok, pos,
                sliding_window: int = 0):
    """One whole-model decode step (reference ``transformer.py:517-557``),
    on one device or one rank of a mesh (as :func:`prefill`; the logits
    then the rank's vocab block): tok (B,) ids at positions pos (B,), an
    encoder-decoder's embedding plus the sinusoid at ``pos``; every
    layer's :func:`decode_block`, which
    writes the new k/v into ``caches`` IN PLACE (the reference returns new
    caches) and runs the cross-attention over ``xk``/``xv``; then the final
    norm and the head. Returns ``(logits (B, Vp) over the padded vocab,
    caches)``. No grad."""
    cfg, plan = model.cfg, model.plan
    dev, cdt = model.embed.device, compute_dtype(cfg)
    with torch.no_grad():
        tok = torch.as_tensor(tok, dtype=torch.int32, device=dev)
        pos = torch.as_tensor(pos, dtype=torch.int32, device=dev)
        x = embed_tokens(model.embed, tok[:, None], plan).to(cdt)
        if cfg.encoder_decoder:
            x = x + _sinusoid(1, cfg.d_model, x.dtype, dev, positions=pos)
        for p, cache, (kind, mlp_kind) in zip(
                model.blocks, caches, stack_layout(cfg).layer_kinds()):
            x, _ = decode_block(p, x, cache, pos, cfg, plan, kind, mlp_kind,
                                sliding_window)
        x = rms_norm(x, model.final_norm.to(x.dtype), cfg.norm_eps)
        logits = x[:, 0] @ model.unembed.to(x.dtype)
    return logits, caches


def stage_units(cfg: ModelConfig) -> List[List[int]]:
    """Layer indices of each stack unit (a prologue block or a period)."""
    lay = stack_layout(cfg)
    n_pro, P = len(lay.prologue), len(lay.period_slots)
    units = [[i] for i in range(n_pro)]
    units += [[n_pro + i * P + j for j in range(P)]
              for i in range(lay.n_periods)]
    return units


# ---------------------------------------------------------------------------
# shardings on a mesh
# ---------------------------------------------------------------------------

def _spec(plan: MeshPlan, model_comp: str) -> NdSbp:
    """B on every data axis, ``model_comp`` on the model axis."""
    return ndsbp(",".join(model_comp if n == plan.model_axis else "B"
                          for n in plan.axis_names))


def block_specs(cfg: ModelConfig, plan: MeshPlan, kind: Kind,
                cross: bool = False) -> Dict[str, NdSbp]:
    """One block's NdSbp per parameter, by its name in the block
    (``repro/models/transformer.py:103-121``). attn/dense
    (``attention.py:93-103``, ``mlp.py:38-48``): ``wq`` S(1) and ``wo``
    S(0) (heads), ``wk``/``wv`` replicated (each rank slices its kv group),
    ``w_gate``/``w_up`` S(1) and ``w_down`` S(0) (hidden units), norms
    replicated; MLA attention (``attention.py:317-327``) ``w_uk``,
    ``w_uv``, ``wq``/``wq_b`` S(1) and ``wo`` S(0), the rest replicated;
    attn/moe (``mlp.py:69-77``) the expert stacks S(0) (experts), the
    router replicated, the shared experts as a dense MLP. ssm/none
    (``mamba.py:50-59``): ``w_x``, ``w_z``, ``w_dt`` S(1); ``w_bc``,
    ``conv_bc`` replicated; ``conv_x``, ``A_log``, ``D``, ``dt_bias``,
    ``norm_w`` and ``out_proj`` S(0); ``ln1`` replicated; ssm/dense and
    ssm/moe add ``ln2`` and the MLP's or MoE's signatures. A ``cross``
    block adds ``ln_x`` (replicated) and ``xattn.*``, GQA's signatures
    without biases (``:108-110``): the rank's q heads, ``wk``/``wv``
    replicated (each rank slices its kv heads, whose cross cache it holds).
    MLA, MoE and cross blocks run on any mesh whose model axis splits their
    heads and experts (:func:`check_mesh_supported`)."""
    S0, S1, B_ = _spec(plan, "S(0)"), _spec(plan, "S(1)"), _spec(plan, "B")
    if cross:
        xattn = {"wq": S1, "wk": B_, "wv": B_, "wo": S0}
        if cfg.qk_norm:
            xattn.update({"q_norm": B_, "k_norm": B_})
        return {**block_specs(cfg, plan, kind), "ln_x": B_,
                **{"xattn." + n: v for n, v in xattn.items()}}
    assert kind in SUPPORTED_KINDS, kind
    dense = {"w_gate": S1, "w_up": S1, "w_down": S0}
    out = {"ln1": B_, **({} if kind[1] == "none" else {"ln2": B_})}
    if kind[0] == "ssm":
        out.update({"ssm." + n: v for n, v in (
            ("w_x", S1), ("w_z", S1), ("w_bc", B_), ("w_dt", S1),
            ("dt_bias", S0), ("A_log", S0), ("D", S0), ("conv_x", S0),
            ("conv_bc", B_), ("norm_w", S0), ("out_proj", S0))})
    else:
        if cfg.use_mla:
            attn = {"wkv_a": B_, "kv_norm": B_, "w_uk": S1, "w_uv": S1,
                    "wo": S0}
            attn.update({"wq_a": B_, "q_norm": B_, "wq_b": S1}
                        if cfg.q_lora_rank else {"wq": S1})
        else:
            attn = {"wq": S1, "wk": B_, "wv": B_, "wo": S0}
            if cfg.qkv_bias:
                attn.update({"bq": S0, "bk": B_, "bv": B_})
            if cfg.qk_norm:
                attn.update({"q_norm": B_, "k_norm": B_})
        out.update({"attn." + n: v for n, v in attn.items()})
    if kind[1] == "none":
        return out
    if kind[1] == "dense":
        out.update({"mlp." + n: v for n, v in dense.items()})
        return out
    out.update({"moe.router": B_, "moe.w_gate": S0, "moe.w_up": S0,
                "moe.w_down": S0})
    if cfg.num_shared_experts:
        out.update({"moe.shared." + n: v for n, v in dense.items()})
    return out


#: the model axis component of the top-level parameters; MTP's projection
#: is row-parallel (its output P(sum), reference ``transformer.py:306-309``)
_TOP_SPECS = {"embed": "S(0)", "unembed": "S(1)", "final_norm": "B",
              "enc_norm": "B", "mtp_norm_h": "B", "mtp_norm_e": "B",
              "mtp_proj": "S(0)"}
_MTP_LEAVES = ("mtp_norm_h", "mtp_norm_e", "mtp_proj")


def model_specs(cfg: ModelConfig, plan: MeshPlan) -> Dict[str, NdSbp]:
    """Every parameter's NdSbp, by its ``state_dict`` name
    (``repro/models/transformer.py:284-310``): the embedding vocab-parallel
    (S(0)), the head column-parallel (S(1)), the blocks by
    :func:`block_specs`, MTP's norms replicated, its projection S(0) and
    its block an attn/dense block's, replicated over the data axes."""
    out = {n: _spec(plan, c) for n, c in _TOP_SPECS.items()
           if (n != "enc_norm" or cfg.encoder_decoder)
           and (n not in _MTP_LEAVES or cfg.mtp)}
    for li, kind in enumerate(stack_layout(cfg).layer_kinds()):
        out.update({f"blocks.{li}.{k}": v for k, v in block_specs(
            cfg, plan, kind, cross=is_cross(cfg, li)).items()})
    for li in range(cfg.num_encoder_layers if cfg.encoder_decoder else 0):
        out.update({f"enc_blocks.{li}.{k}": v for k, v in block_specs(
            cfg, plan, ("attn", "dense")).items()})
    if cfg.mtp:
        out.update({f"mtp_block.{k}": v for k, v in block_specs(
            cfg, plan, ("attn", "dense")).items()})
    return out


def spec_of(name: str, cfg: ModelConfig, plan: MeshPlan) -> NdSbp:
    """The NdSbp of the parameter ``name`` of a ``Transformer`` or of a
    stage's slice of it (``blocks.<i>.<leaf>``, ``embed``, ...). A block's
    kind is its own, read from its leaf (``ssm.*``, ``moe.*`` or
    ``attn.*``/``mlp.*``; ``ln1`` and ``ln2`` are replicated in any), since
    a stage's slice renumbers its blocks from 0. ``mtp_block.<leaf>`` is
    an attn/dense block's."""
    parts = name.split(".")
    if parts[0] == "mtp_block":
        return block_specs(cfg, plan, ("attn", "dense"))[".".join(parts[1:])]
    if parts[0] in ("blocks", "enc_blocks"):
        kind = {"ssm": ("ssm", "none"), "moe": ("attn", "moe")}.get(
            parts[2], ("attn", "dense"))
        return block_specs(cfg, plan, kind, cross=parts[2] in (
            "ln_x", "xattn"))[".".join(parts[2:])]
    return _spec(plan, _TOP_SPECS[name])


def shard_params(params, cfg: ModelConfig, plan: MeshPlan,
                 coords: Sequence[int]) -> Dict[str, torch.Tensor]:
    """The shard of every parameter that the rank at mesh ``coords`` holds
    under :func:`model_specs`: ``params`` is a global ``Transformer`` or
    its ``state_dict`` (e.g. :func:`repro_torch.models.convert
    .params_from_jax`'s). Returns views of the global tensors."""
    state = params.state_dict() if isinstance(params, nn.Module) else params
    specs = model_specs(cfg, plan)
    return {n: torch.as_tensor(t)[M.shard_slices(
        t.shape, specs[n], plan.axis_sizes, coords)]
        for n, t in state.items()}


# ---------------------------------------------------------------------------
# training loss
# ---------------------------------------------------------------------------

def shard_stats(p_unembed, h, labels, plan: MeshPlan):
    """The local stats ``(m, s, z)`` of this rank's vocab shard: logits on
    its ``S(1)`` columns of ``unembed`` (the whole padded vocab at tp = 1,
    unmasked, as in the reference, ``transformer.py:333-344``) through
    :func:`xent_local_stats` (the kernel on the card) at the shard's
    offset. h: (B, S, d); labels: (B, S)."""
    B, S, d = h.shape
    logits = h.reshape(B * S, d) @ p_unembed.to(h.dtype)
    offset = (M.axis_index(plan.model_axis) * p_unembed.shape[1]
              if plan.tp > 1 else 0)
    return xent_local_stats(logits, labels.reshape(-1), offset)


def weighted_mean(tok, weights):
    """The loss over tokens: ``tok`` weighted, over the weights' sum."""
    w = weights.reshape(-1).float()
    return (tok * w).sum() / torch.clamp_min(w.sum(), 1.0)


def lm_loss(p_unembed, h, labels, weights, plan: MeshPlan,
            cfg: ModelConfig):
    """Sharded-vocab cross-entropy (paper Fig 11b) on one vocab shard.

    h: (B, S, d); labels/weights: (B, S). The stats of the one shard
    (:func:`shard_stats`) are combined as one shard. Returns the weighted
    mean loss. On a mesh the training program combines them across
    ``model`` (:func:`mesh_loss_program`)."""
    m_, s_, z_ = shard_stats(p_unembed, h, labels, plan)
    return weighted_mean(combine_stats(m_[None], s_[None], z_[None]),
                         weights)


def _run_body(model: Transformer, x, cfg: ModelConfig, plan: MeshPlan,
              positions, causal: bool = True, sliding_window: int = 0,
              remat: bool = True, enc=None):
    """The block stack for training: the prologue, then each period, with
    per-period rematerialisation (``torch.utils.checkpoint``, the
    counterpart of the reference's ``jax.checkpoint`` of ``one_period``; at
    tp = 1 its "boxed" save policy saves nothing). Returns ``(x, aux)``:
    ``aux`` the routers' load-balance losses summed in layer order from a
    float32 0, as the reference's prologue loop and scan carry sum them
    (``repro/models/transformer.py:350-384``; a block without a router adds
    the reference's exact 0, so it is skipped). The remat rerun repeats
    each MoE's routing bit for bit (a stable sort, a fixed-order
    scatter-add), so the backward sees the forward's choices. ``enc`` (an
    encoder-decoder's encoder output) reaches every block, an input of each
    period's checkpoint; autograd sums its cotangents from the blocks'
    cross-attentions in one fixed order, the reverse of the layers."""
    lay = stack_layout(cfg)
    n_pro, P = len(lay.prologue), len(lay.period_slots)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def block(i: int, kind: Kind, x, aux, enc):
        x, a, _ = apply_block(model.blocks[i], x, cfg, plan, *kind,
                              positions, causal, sliding_window, enc=enc)
        return x, (aux if a is None else aux + a)

    for i, kind in enumerate(lay.prologue):
        x, aux = block(i, kind, x, aux, enc)

    def one_period(x, aux, enc, i: int):
        for j, kind in enumerate(lay.period_slots):
            x, aux = block(n_pro + i * P + j, kind, x, aux, enc)
        return x, aux

    for i in range(lay.n_periods):
        x, aux = (checkpoint(one_period, x, aux, enc, i, use_reentrant=False)
                  if remat else one_period(x, aux, enc, i))
    return x, aux


def _sinusoid(length: int, d: int, dtype, device, positions=None):
    """The encoder-decoder's sinusoidal position table ``(1, length, d)``
    (reference ``transformer.py:467-476``): ``sin`` then ``cos`` of
    ``pos / 10000^(2i/d)``; with ``positions`` (B,) the decode step's rows
    ``(B, 1, d)`` at those positions (``:523-528``)."""
    if positions is None:
        pos = torch.arange(length, device=device)[:, None].float()
    else:
        pos = positions.to(device)[:, None].float()
    i = torch.arange(d // 2, device=device)[None, :].float()
    ang = pos / torch.pow(torch.tensor(10000.0, device=device), 2 * i / d)
    table = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    return (table[None] if positions is None else table[:, None]).to(dtype)


def encode(model: Transformer, enc_embeds, cfg: ModelConfig, plan: MeshPlan,
           remat: bool = False):
    """The encoder of an encoder-decoder (reference ``transformer.py:
    406-417``, ``:490-500``): the frame embeddings in the compute dtype plus
    the sinusoid, each ``enc_blocks`` layer non-causal at the encoder's
    positions (with ``remat`` each layer rematerialised, the reference's
    ``jax.checkpoint(enc_period)``), then ``enc_norm``."""
    dev = model.embed.device
    enc = torch.as_tensor(enc_embeds, device=dev).to(compute_dtype(cfg))
    enc = enc + _sinusoid(enc.shape[1], cfg.d_model, enc.dtype, dev)
    enc_pos = torch.arange(enc.shape[1], device=dev)

    def layer(p, h):
        return apply_block(p, h, cfg, plan, "attn", "dense", enc_pos,
                           causal=False)[0]

    for p in model.enc_blocks:
        enc = (checkpoint(layer, p, enc, use_reentrant=False) if remat
               else layer(p, enc))
    return rms_norm(enc, model.enc_norm.to(enc.dtype), cfg.norm_eps)


def batch_inputs(cfg: ModelConfig, kind: str = "train") -> Tuple[str, ...]:
    """The batch's keys in the reference's forms (``train/steps.py:37-56``),
    the one place that knows them. ``kind`` "train": ``tokens`` (S + 1
    ids), or for an embed frontend without an encoder ``embeds`` and
    ``labels``; "prefill": ``tokens``, or ``embeds``. An encoder-decoder
    adds ``enc_embeds`` to either."""
    if kind not in ("train", "prefill"):
        raise ValueError(f"batch kind {kind!r}: 'train' or 'prefill'")
    if cfg.embed_frontend and not cfg.encoder_decoder:
        keys = ("embeds", "labels") if kind == "train" else ("embeds",)
    else:
        keys = ("tokens",)
    return keys + (("enc_embeds",) if cfg.encoder_decoder else ())


def batch_tensors(batch, cfg: ModelConfig, device) -> Dict[str, torch.Tensor]:
    """The batch's tensors on ``device``: token ids and labels as int32,
    embeddings as given (the model casts them to its compute dtype)."""
    out = {}
    for key in batch_inputs(cfg):
        t = torch.as_tensor(batch[key], device=device)
        out[key] = t.to(torch.int32) if key in ("tokens", "labels") else t
    return out


def mtp_targets(labels):
    """Multi-token prediction's labels and weights from the LM labels (B,
    S) (reference ``transformer.py:450-455``): position t predicts the
    token two ahead, ``labels[:, t + 1]``; the last position repeats the
    last label at weight 0, so the loss is a mean over B x (S - 1) rows."""
    ones = torch.ones(labels[:, 1:].shape, dtype=torch.float32,
                      device=labels.device)
    return (torch.cat([labels[:, 1:], labels[:, -1:]], dim=1),
            torch.cat([ones, torch.zeros_like(ones[:, :1])], dim=1))


def mtp_concat(x, e, w_h, w_e, eps: float):
    """MTP's input (reference ``:437-440``): the final-normed hidden ``x``
    normed again by ``w_h``, beside the next tokens' embedding ``e`` normed
    by ``w_e``, (B, S, 2d) in ``x``'s dtype."""
    return torch.cat([rms_norm(x, w_h.to(x.dtype), eps),
                      rms_norm(e.to(x.dtype), w_e.to(x.dtype), eps)], dim=-1)


def mtp_loss(model: Transformer, x, labels, positions, cfg: ModelConfig,
             plan: MeshPlan):
    """The MTP head's loss on one device (reference ``:434-455``): from the
    FINAL-normed hidden ``x`` and the next tokens' embedding, the
    concatenation's projection ``mtp_proj``, one attn/dense block
    (``mtp_block``, not rematerialised, its aux dropped), then the
    weighted cross-entropy over the shared head ``unembed`` against
    :func:`mtp_targets`, with no final norm in between."""
    e = embed_tokens(model.embed, labels, plan)
    hm = mtp_concat(x, e, model.mtp_norm_h, model.mtp_norm_e,
                    cfg.norm_eps) @ model.mtp_proj.to(x.dtype)
    hm, _, _ = apply_block(model.mtp_block, hm, cfg, plan, "attn", "dense",
                           positions)
    targets, weights = mtp_targets(labels)
    return lm_loss(model.unembed, hm, targets, weights, plan, cfg)


def forward_loss(model: Transformer, batch, cfg: ModelConfig,
                 plan: MeshPlan, remat: bool = True):
    """Training loss on one device of a dense, SSM, MLA + MoE,
    embed-frontend or encoder-decoder model. batch (numpy or torch), the
    reference's three forms (``repro/models/transformer.py:387-417``):
    ``{"tokens": (B, S+1)}`` int32; for an embed frontend ``{"embeds":
    (B, S, d), "labels": (B, S)}``; an encoder-decoder adds ``"enc_embeds":
    (B, enc_len, d)`` to the tokens (its decoder tokens take no sinusoid
    here, as in the reference). Returns ``(loss, metrics)`` with metrics
    ``lm_loss``, ``aux_loss`` (the routers' summed load-balance loss; 0
    without a router), with ``cfg.mtp`` ``mtp_loss`` (:func:`mtp_loss`),
    and ``loss`` = ``lm_loss + mtp_weight * mtp_loss + router_aux_weight
    * aux_loss``, summed in that order (``:429-458``)."""
    check_supported(cfg)
    dev = model.embed.device
    bt = batch_tensors(batch, cfg, dev)
    if "embeds" in bt:                                    # VLM
        x, labels = bt["embeds"].to(compute_dtype(cfg)), bt["labels"]
    else:
        inputs, labels = bt["tokens"][:, :-1], bt["tokens"][:, 1:]
        x = embed_tokens(model.embed, inputs, plan).to(compute_dtype(cfg))
    positions = torch.arange(x.shape[1], device=dev)
    weights = torch.ones(labels.shape, dtype=torch.float32, device=dev)
    enc = (encode(model, bt["enc_embeds"], cfg, plan, remat=remat)
           if cfg.encoder_decoder else None)
    x, aux = _run_body(model, x, cfg, plan, positions, causal=True,
                       remat=remat, enc=enc)
    x = rms_norm(x, model.final_norm.to(x.dtype), cfg.norm_eps)
    loss = lm_loss(model.unembed, x, labels, weights, plan, cfg)
    metrics = {"lm_loss": loss, "aux_loss": aux}
    if cfg.mtp:
        metrics["mtp_loss"] = mtp_loss(model, x, labels, positions, cfg,
                                       plan)
        loss = loss + cfg.mtp_weight * metrics["mtp_loss"]
    loss = loss + cfg.router_aux_weight * aux
    metrics["loss"] = loss
    return loss, metrics


# ---------------------------------------------------------------------------
# training loss on a mesh: a taped program of local segments between
# collectives
# ---------------------------------------------------------------------------

def next_token_targets(labels):
    """The next-token loss's labels and weights: the labels themselves,
    each at weight 1."""
    return labels, torch.ones(labels.shape, dtype=torch.float32,
                              device=labels.device)


def loss_steps(h: str, plan: MeshPlan, out: str = "loss",
               labels: str = "tokens",
               targets: Callable = next_token_targets) -> List[Step]:
    """The vocab-parallel ``lm_loss`` as program steps, from the final
    hidden ``h`` (model-replicated, after its "f") and the inputs
    ``unembed`` (this rank's ``S(1)`` columns) and ``labels`` (``tokens``,
    whose labels are ``tokens[:, 1:]``, or an embed frontend's ``labels``
    themselves) to ``out``, against ``targets`` of those labels (labels
    and weights: :func:`next_token_targets`, or :func:`mtp_targets` for
    the MTP head's loss; the internal names carry ``out``, so both losses
    fit one program):
    the xent kernel's stats at the rank's vocab offset
    (:func:`shard_stats`), ``m`` held fixed through a pmax (no transpose),
    ``s`` rescaled by ``exp(m - m_g)`` and psummed with ``z`` as "g"s, so
    every rank computes the whole ``log s_g + m_g - z_g`` over its rows
    (``repro/models/transformer.py:326-345``). At tp = 1 the stats of the
    one shard, as :func:`lm_loss`."""
    tag = INTERNAL + out.lstrip(INTERNAL) + "."
    m, s, z = (tag + n for n in ("m", "s", "z"))
    cut = 1 if labels == "tokens" else 0
    steps = [Step(lambda hv, U, t: shard_stats(U, hv, targets(t[:, cut:])[0],
                                               plan),
                  (h, "unembed", labels), (m, s, z))]
    if plan.tp > 1:
        m_g, s_r = tag + "m_g", tag + "s_r"
        steps += [
            Step(lambda v: M.pmax(v, plan.model_axis), (m,), (m_g,),
                 collective=True),
            Step(lambda sv, mv, mg: sv * torch.exp(mv - mg), (s, m, m_g),
                 (s_r,)),
            branch_psum_step(s_r, s_r + ".sum", plan),
            branch_psum_step(z, z + ".sum", plan)]
        s, m, z = s_r + ".sum", m_g, z + ".sum"

    def loss(s_g, m_g, z_g, t):
        tok = torch.log(s_g) + m_g - z_g       # -log softmax[label]
        return weighted_mean(tok, targets(t[:, cut:])[1])
    return steps + [Step(loss, (s, m, z, labels), (out,))]


def mesh_loss_program(cfg: ModelConfig, plan: MeshPlan,
                      remat: bool = True) -> LocalProgram:
    """The training loss of a dense, SSM or MLA + MoE decoder on one rank
    of a ``("data", "model")`` mesh, as a program for the
    training tape (:func:`repro_torch.core.tape.taped_forward`): local
    segments between the model's collectives, every collective a tape
    entry with its transpose, so none runs inside autograd.

    Inputs: the batch's (:func:`batch_inputs`: ``tokens``, this rank's rows
    ``(B, S+1)`` int32, or an embed frontend's ``embeds`` and ``labels``;
    an encoder-decoder's ``enc_embeds`` too) and every parameter by its
    ``state_dict`` name, this rank's shard under :func:`model_specs`;
    outputs ``loss`` (this rank's total, the data
    axes' mean is the step's), ``lm_loss`` (its weighted-mean
    cross-entropy), ``aux_loss`` (the routers' load-balance losses
    summed in layer order, float32; 0 without a router) and, with
    ``cfg.mtp``, ``mtp_loss`` (the MTP head's, after the loss's segments),
    with ``loss = lm_loss + mtp_weight * mtp_loss + router_aux_weight *
    aux_loss`` as in the reference's ``forward_loss``
    (``repro/models/transformer.py:429-458``). Per block, as
    the reference's ``apply_block`` (``:146-210``): the norm,
    "f" (:func:`~repro_torch.models.common.grad_sync_step`), attention on
    the rank's heads (GQA, or MLA), the branch psum "g"
    (:func:`~repro_torch.models.common.branch_psum_step`), the residual
    and norm, "f", the MLP on the rank's units (or the MoE on the rank's
    experts, which also gives its aux, whole on every rank), "g"; an SSM
    block is the norm, "f", Mamba on the rank's heads, "g" and the
    residual. The f sits after each norm, so a
    replicated norm's gradient comes out whole on every rank.
    The embedding is :func:`embed_local` and a "g"; the loss is
    :func:`loss_steps` after the final norm and an "f". The summed aux
    goes through :func:`~repro_torch.models.common.aux_pmean_step` before
    it joins the loss (the reference's ``certified_pmean``), so its
    gradient counts once over the ranks of ``model``. At tp = 1 (a data
    mesh, or ``fsdp``) there is no "f", "g" or pmean, and the loss is
    :func:`lm_loss`'s.

    With ``remat`` each block's segments keep only their inputs and run
    again in the backward: the reference's policy, which saves the psum
    outputs and recomputes the local math between them (``:371-380``);
    a MoE's rerun repeats its routing bit for bit (a stable sort, a
    fixed-order scatter-add). The loss segment and the aux sums run once.

    An encoder-decoder first runs its encoder as segments of its own: the
    frame embeddings plus the sinusoid, each ``enc_blocks`` layer as an
    attn/dense block with non-causal attention (the norm, "f", attention
    on the rank's heads, "g", the residual and norm, "f", the MLP on the
    rank's units, "g"), then ``enc_norm`` and one "f". Each decoder block
    of the body adds its cross branch after self-attention: the residual
    and ``ln_x``, "f", then ``xattn``'s q heads of the rank over the
    encoder output, which enters the rank's ``xk``/``xv`` columns
    (``:169-178``). The encoder output's cotangent is the sum of the
    decoder layers' cross-attention contributions, which the tape adds in
    its one fixed order (the reverse of the layers) and the one "f" sums
    over ``model``, so repeated steps are bitwise equal. An embed
    frontend's ``embeds`` enter where the embedded tokens would. A hybrid
    whose SSM layers carry an MLP raises (:func:`check_trainable`)."""
    check_supported(cfg)
    check_trainable(cfg)
    check_mesh_supported(cfg, plan)
    cdt = compute_dtype(cfg)
    eps, tp = cfg.norm_eps, plan.tp
    kinds = stack_layout(cfg).layer_kinds()
    specs = {(kind, is_cross(cfg, i)): block_specs(cfg, plan, kind,
                                                   cross=is_cross(cfg, i))
             for i, kind in enumerate(kinds)}
    specs.setdefault((("attn", "dense"), False), block_specs(
        cfg, plan, ("attn", "dense")))
    steps: List[Step] = []

    def local(fn, ins, outs, rm=remat):
        steps.append(Step(fn, tuple(ins), tuple(outs), remat=rm))

    def f(src):
        if tp == 1:
            return src
        steps.append(grad_sync_step(src, src + ".f", plan))
        return src + ".f"

    def g(src):
        if tp == 1:
            return src
        steps.append(branch_psum_step(src, src + ".sum", plan))
        return src + ".sum"

    def add_norm(*args):
        """(terms of the residual..., norm weight) -> (x, rms_norm(x))"""
        *terms, w = args
        x = terms[0].to(cdt)
        for t in terms[1:]:
            x = x + t
        return x, rms_norm(x, w.to(cdt), eps)

    def module(names, ws):
        """A block's sub-module from its leaves by dotted name."""
        ns = SimpleNamespace()
        for n, w in zip(names, ws):
            *path, leaf = n.split(".")
            node = ns
            for part in path:
                if not hasattr(node, part):
                    setattr(node, part, SimpleNamespace())
                node = getattr(node, part)
            setattr(node, leaf, w)
        return ns

    def branch(fn, kind: Kind, prefix: str, b: str, h: str, outs,
               extra=(), cross: bool = False, rm: bool = remat):
        """A local step of ``fn(sub-module, h, *extra)``: the block's leaves
        under ``prefix`` gathered into the sub-module the forward takes."""
        names = [k[len(prefix):] for k in specs[kind, cross]
                 if k.startswith(prefix)]
        n = len(names)
        local(lambda hv, *ws: fn(module(names, ws[:n]), hv, *ws[n:]),
              (f(h), *[b + prefix + m for m in names], *extra), outs, rm)

    def attention(p, h, causal=True):
        positions = torch.arange(h.shape[1], device=h.device)
        if cfg.use_mla:
            return mla_forward(p, h, cfg, plan, positions)[0]
        return gqa_forward(p, h, cfg, plan, positions, causal=causal)[0]

    def cross_attention(p, h, enc):
        return gqa_forward(p, h, cfg, plan,
                           torch.arange(h.shape[1], device=h.device),
                           causal=False, kv_src=enc,
                           kv_positions=torch.arange(enc.shape[1],
                                                     device=enc.device))[0]

    def name(n):
        return INTERNAL + n

    dense = ("attn", "dense")

    def dense_block(b, residual, tag, causal=True, rm=remat):
        """The segments of the attn/dense block whose leaves are under
        ``b``, from the ``residual`` terms (internal names tagged ``tag``):
        the norm, attention, "g", the residual and norm, the MLP; returns
        the next residual's terms (the block's output is their sum)."""
        x, h, a = name(tag + "x"), name(tag + "h"), name(tag + "a")
        local(add_norm, (*residual, b + "ln1"), (x, h), rm)
        branch(lambda p, hv: attention(p, hv, causal=causal), dense,
               "attn.", b, h, (a,), rm=rm)
        xm, h2, mo = name(tag + "xm"), name(tag + "h2"), name(tag + "mlp")
        local(add_norm, (x, g(a), b + "ln2"), (xm, h2), rm)
        branch(dense_mlp_forward, dense, "mlp.", b, h2, (mo,), rm=rm)
        return [xm, g(mo)]

    batch = batch_inputs(cfg)
    labels = "labels" if "labels" in batch else "tokens"
    enc = None
    if cfg.encoder_decoder:
        d = cfg.d_model
        local(lambda E: E.to(cdt) + _sinusoid(E.shape[1], d, cdt, E.device),
              ("enc_embeds",), (name("enc_in"),), rm=False)
        res_e = [name("enc_in")]
        for i in range(cfg.num_encoder_layers):
            res_e = dense_block(f"enc_blocks.{i}.", res_e, f"enc{i}_",
                                causal=False)
        local(add_norm, (*res_e, "enc_norm"), (name("enc_xf"), name("enc")))
        # one "f" for every cross branch: each rank's cotangent of the
        # encoder output is its heads' part, summed in the tape's order,
        # then over model once
        enc = f(name("enc"))
    if labels == "labels":      # an embed frontend: the rows' embeddings
        residual = ["embeds"]
    else:
        local(lambda E, t: embed_local(E, t[:, :-1], plan),
              ("embed", "tokens"), (name("e"),), rm=False)
        residual = [g(name("e"))]
    aux = None
    for i, kind in enumerate(kinds):
        b = f"blocks.{i}."
        x, h, a = name(f"x{i}"), name(f"h{i}"), name(f"a{i}")
        local(add_norm, (*residual, b + "ln1"), (x, h))
        if kind[0] == "ssm":
            branch(lambda p, hv: mamba_forward(p, hv, cfg, plan), kind,
                   "ssm.", b, h, (a,))
            residual = [x, g(a)]
            continue
        branch(attention, kind, "attn.", b, h, (a,), cross=is_cross(cfg, i))
        xm, h2, mo = name(f"xm{i}"), name(f"h2_{i}"), name(f"mlp{i}")
        if is_cross(cfg, i):
            xc, hc, ax = name(f"xc{i}"), name(f"hx{i}"), name(f"ax{i}")
            local(add_norm, (x, g(a), b + "ln_x"), (xc, hc))
            branch(cross_attention, kind, "xattn.", b, hc, (ax,),
                   extra=(enc,), cross=True)
            local(add_norm, (xc, g(ax), b + "ln2"), (xm, h2))
        else:
            local(add_norm, (x, g(a), b + "ln2"), (xm, h2))
        if kind[1] == "moe":
            a_i = name(f"aux{i}")
            branch(lambda p, hv: moe_forward(p, hv, cfg, plan), kind,
                   "moe.", b, h2, (mo, a_i), cross=is_cross(cfg, i))
            if aux is None:
                aux = a_i
            else:
                local(torch.add, (aux, a_i), (name(f"aux_sum{i}"),),
                      rm=False)
                aux = name(f"aux_sum{i}")
        else:
            branch(dense_mlp_forward, kind, "mlp.", b, h2, (mo,),
                   cross=is_cross(cfg, i))
        residual = [xm, g(mo)]
    hf = name("hf")
    local(add_norm, (*residual, "final_norm"), (name("xf"), hf))
    routed = aux is not None
    if not routed:          # no router: the reference's aux is 0
        aux = name("aux0")
        local(lambda t: torch.zeros((), dtype=torch.float32,
                                    device=t.device), (labels,), (aux,),
              rm=False)
    elif tp > 1:
        steps.append(aux_pmean_step(aux, aux + ".pmean", plan))
        aux += ".pmean"
    lm = name("lm") if routed or cfg.mtp else "loss"
    steps += loss_steps(f(hf), plan, out=lm, labels=labels)
    total, outs, keys = lm, ("loss", "lm_loss", "aux_loss"), ["loss", lm, aux]

    if cfg.mtp:
        # MTP's segments (reference :434-455), none rematerialised: the
        # next tokens' embedding and a "g"; the two norms and the
        # concatenation (of hf, the FINAL-normed hidden); one "f"; the
        # rank's 2d / tp columns of it times its mtp_proj rows, and a "g";
        # the attn/dense block as the body's; an "f"; the loss against
        # mtp_targets
        cut = 1 if labels == "tokens" else 0
        local(lambda E, t: embed_local(E, t[:, cut:], plan),
              ("embed", labels), (name("e_next"),), rm=False)
        local(lambda hv, ev, wh, we: mtp_concat(hv, ev, wh, we, eps),
              (hf, g(name("e_next")), "mtp_norm_h", "mtp_norm_e"),
              (name("hcat"),), rm=False)

        def proj(hc, w):
            if tp > 1:          # this rank's rows of the row-parallel proj
                lo = M.axis_index(plan.model_axis) * w.shape[0]
                hc = hc[..., lo:lo + w.shape[0]]
            return hc @ w.to(cdt)
        local(proj, (f(name("hcat")), "mtp_proj"), (name("hm0"),), rm=False)
        res_m = dense_block("mtp_block.", [g(name("hm0"))], "mtp_", rm=False)
        local(torch.add, res_m, (name("hm"),), rm=False)
        mtp, mw = name("mtp"), cfg.mtp_weight
        steps += loss_steps(f(name("hm")), plan, out=mtp, labels=labels,
                            targets=mtp_targets)
        total = name("lm_mtp") if routed else "loss"
        local(lambda lv, mv: lv + mw * mv, (lm, mtp), (total,), rm=False)
        outs, keys = outs + ("mtp_loss",), keys + [mtp]
    if routed:
        w = cfg.router_aux_weight
        local(lambda lv, av: lv + w * av, (total, aux), ("loss",), rm=False)
    inputs = (*batch, *model_specs(cfg, plan))
    return LocalProgram(steps, inputs, outs, tuple(keys))
