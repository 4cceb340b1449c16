"""Smoke run of the PyTorch port on one NVIDIA card: kernels, serving, training.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each printing its own lines; any failure exits non-zero before the
result line is printed:

1. device and build: the card's name and power limit (``nvidia-smi``), its
   compute mode (the process runtime's phases need one that admits
   several processes), then
   every CUDA source of the serving and training paths built from
   ``src/repro_torch/csrc`` (one ``nvcc`` per source, started together),
   each with its ``ptxas -v`` register/spill report;
2. kernels: each kernel against its plain PyTorch version at the shapes its
   path gives it -- attention forward and decode at the serving shapes,
   the attention forward also at a training layer, the xent forward and
   backward at the training logits (4,096 x 151,936,
   bf16), the attention backward at a training layer (q (2, 2048, 16, 128),
   kv (2, 2048, 8, 128), causal, bf16) against autograd through the plain
   version, the SSD scan at the mamba2-370m prefill of 512 tokens (x (1,
   512, 32, 64), B and C (1, 512, 1, 128), bf16) and of 2048 tokens -- and
   again on float32 copies of the same inputs, held tighter. bf16
   attention and SSD scans run on the tensor-core kernels and float32 ones
   on the CUDA-core ones; the bf16 attention forward and backward and the
   bf16 SSD scan are also held to the plain version on float32 copies at
   the bf16 limits, and the launch counters show which kernels each dtype
   reached. One decode call must run its kernel and nothing else on the
   card (the split combine is inside it). Decode is also held (bf16 and
   float32 copies) and timed on a long cache (q (4, 16, 128), cache (4,
   8192, 8, 128) bf16, rows at 1,024-8,192 keys) and on the paged window,
   and at the serve shape with a cold L2 as well (the call cycling through
   28 distinct caches, one a layer, 261 MB). The mesh serve path's two
   rank shapes have rows of their own: decode on the rank-1 shard of
   qwen3's tp = 2 cache (q (4, 16, 128), shard (4, 285, 8, 128) bf16 at
   ``k_offset`` 285, one row wholly masked there; both shards' partials
   also combined across two virtual ranks of the card against the plain
   decode over the whole (4, 570) cache) and the attention forward at a
   rank's local heads (q (1, 512, 8, 128), 4 kv heads). The mesh train
   path's have rows too: the attention forward and backward at a rank's
   local heads of a training layer (q (2, 2048, 8, 128), 4 kv heads), and
   the bf16 xent forward and backward on the rank-1 vocab shard (4,096 x
   75,968 at offset 75,968, labels over both shards). The SSD scan has a
   row at a tp = 2 rank's 16 local heads (x (1, 512, 16, 64)), and its
   backward (``ssd_scan_bwd``: for bf16 four kernels, the state and chunk
   passes on the tensor cores, the carry, the head-sum reduce) one at
   mamba2-370m's training layer (x (2, 2048, 32, 64) bf16, B and C (2,
   2048, 1, 128), chunk 128) and one at a tp = 2 rank's 16 heads, each
   against ``ssd_chunked_bwd_ref`` (each gradient within 1e-2 relative in
   norm for bf16 outputs, 1e-4 for float32 ones), two calls bitwise equal,
   and again in float32 at the reduced shape with dhT (the five CUDA-core
   kernels). The launch counters show which route each dtype reached. The
   attention forward has a row at MLA's head dims, deepseek-v2-lite's
   serve prefill (q and k (1, 512, 16, 192), v (1, 512, 16, 128) bf16,
   causal, on the tensor cores), with the float32 kernel at (192, 128)
   and at the reduced config's (96, 64) on shapes of their own (within
   1e-4); its library call is SDPA on the first backend that takes v
   narrower than q and k, named in the row (``library_backend``). MLA's
   training layer has rows too: the forward and the backward at q and k
   (2, 2048, 16, 192), v and dO (2, 2048, 16, 128) bf16, causal (the
   backward's dk/dv kernel on 32-row q tiles there), each held bf16 and
   on float32 copies (the float32 kernels at the same shape within 1e-4),
   the backward also in float32 at the reduced config's (96, 64); their
   library calls SDPA's forward and backward on the first backend that
   takes Dv != D; and the xent forward and backward at deepseek-v2-lite's
   vocabulary (4,096 x 102,400 bf16). whisper-medium's shapes have rows
   too: the attention forward and backward non-causal at its encoder's
   q/k/v (2, 1500, 16, 64) and as cross-attention at q (2, 448, 16, 64)
   over k/v (2, 1500, 16, 64), bf16 (held also on float32 copies; the
   float32 kernels at the same shapes and at small ragged ones within
   1e-4; the library call SDPA with ``is_causal=False``), the decode
   kernel over its cross cache (q (4, 16, 64), cache (4, 1500, 16, 64)
   bf16, every row at ``cur_pos`` 1499) and the xent kernels at its
   training logits (896 x 51,968 bf16).
   Each reports the device time of every kernel its call launches
   (torch.profiler; the names of the kernels the trace matched are
   printed), the wrapper call's, the plain version's, the least time the
   card could take (bytes over 3.35 TB/s or operations over the peak rate
   of their type, whichever is larger) and one PyTorch library call as a
   yardstick (SDPA, or ``F.cross_entropy``; timed here only, the port
   never calls them; none computes the SSD scan, so its row says "none"),
   the kernel's and the wrapper call's times over the library call's
   (``vs_library``, ``wrapper_vs_library``) and the bound's share of the
   kernel's time (``bound_share``);
3. reference: the reduced qwen3 config served through the kernels agrees
   with the same weights on the CPU's plain path (prefill and decode
   logits); then two training steps of it through the kernels agree with
   the same two steps on the CPU (loss, grad_norm), every float32
   attention launch on the CUDA-core kernels; then the reduced
   mamba2 config (float32) served through the SSD kernel gives the CPU's
   plain path's tokens, with prefill logits within 1e-3; then one ZeRO
   train step of it (the SSD forward and backward kernels) agrees with the
   CPU's (loss, grad_norm within 1e-4); then reduced
   deepseek-v2-lite (float32: MLA at head dims 96 / 64, a dense layer and
   a MoE layer) served through the kernels against the CPU's plain path
   as reduced qwen3 is (prefill logits, four decode steps), every prefill
   attention on the float32 CUDA-core kernel; then two ZeRO 1 x 1 train
   steps of reduced deepseek-v2-lite on the card (MLA at 96 / 64 forward
   and backward on the CUDA-core kernels, the MoE and its aux loss on the
   training tape) against the CPU's plain steps: loss, aux_loss and
   grad_norm within 1e-4; then reduced whisper-medium and pixtral-12b
   (float32) through ``make_serve_step`` (the classic loop's whole-model
   prefill and decode): the first token's and two decode steps' logits
   card vs CPU within 1e-3, every launch counted (whisper: 2 encoder, 2
   causal and 2 cross attention forwards, 4 decodes a step, 2 of them
   over the 64-frame cross cache), and 2 ZeRO 1 x 1 train steps each
   against the CPU's plain steps, as reduced deepseek's;
4. serve: qwen3-1.7b at full width, bf16, seeded init, through
   ``repro_torch.api.compile(backend="actors", stages=2)`` -- 12 requests of
   64-512 prompt tokens and 8-48 new tokens in 2 groups of 4 slots; then
   the same requests on ``backend="monolithic"``, which must give the same
   tokens. Around each of the two runs the kernels' launch counters are
   zeroed just before and read just after, and must equal the launches the
   scheduler's work implies, every attention forward on the tensor-core
   kernel. One more monolithic run of the first 4 requests under
   torch.profiler, the device traced alone, gives the device's busy share
   and its kernels by time. Then the same for
   mamba2-370m at full width and depth (48 SSM layers, bf16): one SSD scan
   call per layer per prefill, each on the tensor-core kernels, no
   attention kernel. Then paged, chunked and sampled serving, each run's
   launches counted as above (one decode per layer per decode item and per
   chunk token) at ``cache_len=576``, which page_len 16 divides (569 is
   prime), dense baselines included: qwen3 paged (the 12 requests plus 3
   repeating the prompt of the longest-lived one, 144 pages of 16, half
   the dense reservation) on the actors and monolithic, tokens identical
   to dense monolithic, pages shared, and the decode kernel held to its
   plain version on a window the paged gather made; qwen3 chunked
   (``prefill_chunk=16``, 4 requests of 24-64 tokens), actors ≡
   monolithic, more rounds than unchunked; qwen3 sampled (temperature 0.8,
   top-k 50, top-p 0.95, seed 1): actors ≡ monolithic, seed 1 repeats,
   seed 2 differs, temperature 0 ≡ greedy; mamba2 paged on the actors ≡
   dense. Then qwen3 on worker processes (``runtime="processes"``, 2
   stages: node 0 ``admit`` and one worker process a stage, each mapping
   the driver's weights by CUDA IPC; hidden states, work items and logits
   cross the processes as CUDA tensors): the serve phase's model and 12
   requests, tokens identical to its threads session's, the launches
   counted in the workers and summed in the driver equal to its (336
   attention forwards, 2,632 decodes), each worker's pid not the
   driver's and its device the card, its allocated memory flat over the
   run (the second half's maximum within 64 MiB of the first's); tok/s
   beside the threads and monolithic runs', the workers' start seconds,
   every process's peak memory and the edge bytes. Then qwen3 on a mesh,
   at full width cut to 4 of its 28 layers (the port's seeded init of the
   cut config; the launch checks follow the cut):
   ``Placement(("data", "model"), (1, 2))``,
   2 virtual ranks of the card (every rank a thread, the collectives a
   rendezvous in rank order), heads, MLP units, vocabulary and the KV
   cache by sequence split over ``model`` (cache_len 570, 285 positions a
   rank), the same 12 requests on the actors and the monolithic engine:
   launches counted as above, times 2 ranks, half of the decodes at each
   shard's ``k_offset`` (0 and 285); tokens actors ≡ monolithic; every
   first-token logit within ``atol=0.25, rtol=0.05`` of a 1 x 1 session's
   on the same weights, and the generated tokens equal to its counted (not
   a gate); tok/s, peak memory, the collectives' calls, bytes and seconds,
   and the idle share of a profiled run of the first 4 requests. Then
   mamba2-370m at full width and depth on the same (1, 2) mesh (16 SSM
   heads a rank, the vocabulary split), 4 requests of 64-256 prompt and
   8-16 new tokens on the actors and the monolithic engine: tokens
   identical, 2 x 48 SSD scans a prefill, every one at 16 heads; and the
   reduced mamba2 (float32) on (1, 2), card tokens ≡ the CPU's. Then
   deepseek-v2-lite-16b at full width and depth (27 layers: one dense,
   then 26 of MLA and a MoE of 64 routed experts top-6 and 2 shared;
   15,706,484,224 params drawn in bf16, 29.26 GiB, held once by both
   sessions), qwen3's geometry and 12 requests, on the actors and then
   the monolithic engine: tokens identical, launches counted as above
   (27 x 12 = 324 attention forwards at (192, 128) on the tensor cores, no
   decode kernel: MLA decodes by absorbed einsums over its latent cache),
   tok/s, peak memory and a device profile of the first 4 requests; the
   model is freed before the training phases. Then the classic loop
   (``launch/serve.py:classic_loop``, ``make_serve_step``) at full width
   and depth in bf16: whisper-medium (24 encoder and 24 decoder layers,
   1,012,523,008 params) over 4 x 1,500 frame embeddings, and
   pixtral-12b (40 layers, 12,247,777,280 params, 24.5 GB drawn in bf16
   on the card) from 4 x 32 patch embeddings, 4 prompts of 32, 16 new
   tokens: the launches counted exactly (whisper a prefill 24 causal +
   24 cross + 24 non-causal attention forwards, a decode step 24 + 24
   decodes, 24 over the 1,500-frame cross cache; pixtral 40 and 40), the
   prefill seconds and tok/s, peak memory, a profiled run's idle share,
   and the first token's and one decode step's logits against the same
   calls on the plain versions within ``atol=0.25, rtol=0.05``;
5. train: qwen3-1.7b at full width and depth (bf16 compute, float32 params
   and AdamW state, seeded init) through ``repro_torch.train.steps
   .make_train_step``, fed by ``ActorDataPipeline(SyntheticLM(151936, 2,
   2048))``, 4 steps: loss, grad_norm, wall time and tokens/s per step, the
   peak memory, finite and falling loss, and the exact kernel launches of
   every step, each backward kernel counted on its own and every attention
   launch on the tensor-core kernels (counters zeroed just before the run);
   then one more step under torch.profiler;
6. train, plain versions: the same 4 steps from the same init and batches
   with the model's attention and loss call sites on the plain PyTorch
   versions (autograd through them) on the card, no kernel launched; the
   kernel path's loss and grad_norm are held to these step by step;
7. train on a mesh: the train phase's model, init, batches and steps on
   ``("data", "model")`` (1, 2), 2 virtual ranks of the card, every rank a
   thread with its own copy of its shards and AdamW state: heads, MLP
   units and the vocabulary over ``model``, each rank's loss from the xent
   kernels at its vocab offset, the collectives on the training tape
   (never inside autograd). Each step's loss within 1e-3 relative of the
   train phase's at step 0 and 5e-3 after (grad_norm printed beside it),
   the launches exactly 2 ranks' (attention forward 2 x 2 x 28, dq and
   dk/dv 2 x 28, all on the tensor-core kernels, xent forward and backward
   once at each offset), the collectives' calls, bytes and the seconds the
   ranks waited, the peak memory, then one profiled step. Then data
   parallelism: (2, 2) at qwen3's widths cut to 4 layers (two full-depth
   replicas would not fit), 2 steps beside a 1 x 1 twin of the cut config,
   held the same way (each of these mesh runs passes ``zero=False``: the
   plain path, whose numbers are the baselines);
7b. train with ZeRO: the same model, init, batches and 4 steps through
   ``make_train_step(cfg, MeshPlan(("data", "model"), (2, 1)),
   zero=True)``, 2 virtual ranks over ``data`` (one row each), each
   holding its (1, 1, chunk) rows of every leaf's float32 master and
   moments (12 B x 2,031,739,904 / 2 = 12.19 GB a rank, printed beside the
   48.8 GB of two plain replicas): each leaf cast to bf16 and all-gathered
   before its first use, its gradient reduce-scattered, both on the
   training tape. Losses within 1e-3 relative of the train phase's at
   step 0 and 5e-3 after, grad_norm printed; the launches exactly 2
   ranks' (attention 112 / 56 / 56 on the tensor-core kernels, xent 2 + 2
   at offset 0); the collectives' calls and bytes a step and the seconds
   the ranks waited; the peak memory; one profiled step. Then ZeRO on
   (2, 2) at phase 7's 4-layer cut, 2 steps, held to phase 7's plain
   (2, 2) run at the same limits;
7d. train deepseek-v2-lite-16b at full width cut to 4 layers (the dense
   one and 3 of MLA + MoE; 2,254,979,072 params) through
   ``make_train_step`` with ZeRO at 1 x 1 (the default), 4 steps of 2 x
   2048 ``SyntheticLM`` tokens: every step's launches held (8 attention
   forwards at (192, 128), each layer's forward and its remat rerun, 4 dq
   and 4 dk/dv, all on the tensor cores, the xent kernels once each way),
   finite losses, aux_loss above 0, wall, tokens/s and peak memory, one
   profiled step; then 2 steps of the same init and batches on the plain
   versions, step 0's loss within 1e-3 of the kernels' (later steps
   printed: a top-k pick that flips on a bf16 rounding moves them);
7e. train whisper-medium at full width and depth through
   ``make_train_step`` (ZeRO 1 x 1, bf16 over float32 masters and
   moments), 4 steps of 2 x 448 decoder tokens over 2 x 1,500 frame
   embeddings: every step's launches held (144 attention forwards, each
   attention's and its remat rerun's, by mask 48 causal, 48 non-causal,
   48 cross; 72 backward calls, 48 of them non-causal: 24 encoder, 24
   cross; the xent kernels once each way), wall, tokens/s, peak memory,
   one profiled step; step 1's loss and gradients twice, bitwise equal;
   then 2 steps on the plain versions, the curves held at the qwen3
   train phase's limits;
7c. train mamba2: mamba2-370m at full width and depth (48 SSM layers,
   bf16 compute) through ``make_train_step`` with ZeRO (the default), 4
   steps of 2 x 2048 ``SyntheticLM`` tokens: finite losses printed (their
   trend not gated), every step's launches held (96 SSD forwards: each
   layer's forward and its remat rerun; 48 launches of each of the bf16
   backward's kernels, none of the float32 route's; the xent kernels once
   each way), one profiled step; then the
   same model on a (1, 2) mesh with ZeRO, 2 steps, each rank's launches
   held and every scan at 16 heads;
8. graph reference: a small LogicalGraph (embedding, a residual across
   its two stages, softmax_xent) trains 2 AdamW steps through
   ``api.compile(graph, mode="train")`` on the card, through the float32
   xent kernels, and on the CPU's plain path: loss and grad_norm within
   1e-4 relative, the first step's gradients within 1e-4;
9. graph train, the paper's own path: a LogicalGraph at qwen3-1.7b's
   widths (embedding 151,936 x 2048, 4 x [matmul 2048->6144, gelu, matmul
   6144->2048, residual add], matmul 2048->151,936, softmax_xent over 4,096
   rows; 722,993,152 float32 params seeded with numpy) through SBP plan ->
   ``lower_train_stages`` -> the 1F1B actors, 4 stages, 8 microbatches of
   512 rows, AdamW (lr 3e-4, clip 1.0): ``backend="actors"`` with
   ``regs="1f1b"`` and with the planned quotas, and ``"monolithic"``, 3
   steps each in lockstep. Losses, post-clip gradients and params must be
   bitwise equal across the three, the xent kernels must launch exactly 8
   times forward and 8 backward a step (counters zeroed before the run),
   the forward registers in flight stay within the quotas; step wall time,
   tokens/s and peak memory per step, then one profiled step (busy and
   idle share);
10. graph train on a (2, 2) mesh: the same graph and params on
   ``Placement(("data", "model"), (2, 2))`` -- 4 virtual ranks on the one
   card, every rank a thread, their collectives a rendezvous in rank order
   (``repro_torch.core.mesh``) -- with ``ids`` and ``labels`` pinned
   ``S(0),B``, ``W_out`` ``B,S(1)`` and ``E`` ``B,S(0)``: rows over
   ``data``, the vocabulary over ``model`` (the plan's signatures are
   printed, and the softmax_xent input must be ``(S(0), S(1))``). The same
   3 AdamW steps on ``backend="actors"`` (1F1B) and ``"monolithic"``, one
   session after the other (the reckoned bytes of two at once, replicas
   over ``data`` included, are printed beside that choice): every loss,
   post-clip gradient and param bitwise equal across the two; step 0's
   loss within 1e-5 relative of the 1 x 1 monolithic session of phase 9
   and its post-clip gradients within ``atol=1e-5, rtol=1e-4``, the later
   losses within 1e-4 relative; the xent kernels launched exactly 4 x 8 =
   32 times a step each way, 16 at vocab offset 0 and 16 at 75,968. Step
   wall time, rows/s, each rank's held bytes and the session's peak
   memory, the bytes and calls of the collectives a step and the seconds
   the ranks spent in them, then one profiled step of the actors (busy
   and idle share);
9b. graph train in mixed precision: phase 9's graph and params with
   ``zero=True, precision="bf16", loss_scale="dynamic"``, 3 steps on
   ``backend="actors"`` (1F1B) and ``"monolithic"`` in lockstep: losses,
   the float32 masters, the moments and the loss-scale trajectory
   bitwise equal across the two, masters and moments float32; step 0's
   loss differs from phase 9's float32 loss and lies within one bf16 unit
   (2^-8) of it; the bf16 xent kernels launched exactly 8 forward and 8
   backward a step a backend; ``opt_state_bytes`` beside plain AdamW's;
   each step's wall beside phase 9's;
9c. graph snapshot and resume: phase 9b's configuration on the 1F1B
   actors, in lockstep: U runs 3 steps uninterrupted; K writes a snapshot
   at step 2 (``snapshot_every=2``) and is killed in step 3
   (``KillWorker("b1")`` at its 2 x 8 + 3rd fire), its steps 1-2 bitwise
   U's and ``latest_snapshot`` 2; R (``compile(restore=)``) resumes at
   step count 2 and its step is bitwise U's step 3; C runs step 1 with a
   delayed and a duplicated Req on two real edges, bitwise U's. Losses,
   loss scales, float32 masters and moments compared; 8 + 8 xent launches
   in every completed step of every session; the snapshot's bytes on
   disk, the snapshot step's wall beside U's, the snap actors' write
   seconds, ``load_snapshot``'s and the restore's seconds, beside the
   card's name and power limit. The directory's disk must hold twice the
   snapshot, and the directory is removed at the end;
9d. graph train on worker processes: 9c's configuration on
   ``runtime="processes"`` (one worker process per stage node, 5 in all),
   one session alive at a time: P runs 3 steps, each bitwise U's of 9c
   (loss, scale, and a fingerprint of every float32 master and moment:
   two int64 sums of their bits computed on the card, one weighted by
   position); K snapshots every step from the stage workers, its steps
   1-2 bitwise P's, and is killed in step 3 by ``KillWorker("b1")``, an
   ``os._exit(57)`` of b1's worker: a ``WorkerError`` naming node 2 and
   exit code 57, and no worker process left; R
   (``compile(runtime="processes", restore=)``) resumes from the files
   the workers wrote, step count 2, and its step 3 is bitwise P's. 8 + 8
   xent launches every completed step, counted in the last stage's worker
   and summed in the driver; the snapshot steps' walls beside 9c's, the
   workers' start seconds and peak memory;
11. graph infer: the same graph under ``mode="infer"``, actors vs
   monolithic, bitwise, 8 forward xent launches a run and no backward.
   The kernels line holds the float32 xent forward and backward at the
   graph's microbatch shape (512 x 151,936) with the graph train run's
   launches, and at one rank's vocab shard of the mesh phase (256 x
   75,968 at offset 75,968) with that phase's launches;
12. static check: every ``api.compile`` of the run ran the static plan
   verifier (``check="static"``, the default; ``watch_static_checks``
   prints each one's verdict, passes and host milliseconds beside the
   compile's seconds, and fails the run if a check allocated a byte on
   the card or launched a kernel), all PASS; a small graph on the card
   whose sink leaks a partial value raises ``AnalysisError`` naming it,
   and ``regs=[1, 0]`` a ``ValueError`` naming the minimal feasible
   quotas, with no actor epoch started and no kernel launched; then
   ``python -m repro_torch.analysis`` on deepseek-v3-671b (8 stages) and
   qwen3-1.7b (4), each PASS with its host milliseconds; the phase within
   ``STATIC_PHASE_S``. The serve phase's and the paged phase's qwen3
   actor sessions print each stage's cache term of the static bound
   beside the bytes its cache holds on the card after the run (dense:
   equal; paged: the pages equal the term less the page table and
   cursors, which the port keeps on the host, the slabs' sentinel rows
   printed beside), and phase 9b each stage's ``train_memory_bound``
   beside its float32 masters, moments and gradient sums on the card
   (never above the bound).

The MLA attention row carries the deepseek-v2-lite serve run's launches,
its training-shape rows (forward, backward by kernel, the xent rows at
its vocabulary) the deepseek-v2-lite train run's.
The attention forward and decode rows' ``launches_by_path`` carry the
processes serve run's (``serve processes``), the bf16 graph xent rows'
the graph processes run's (``graph processes``).
The ``ssd_scan_bwd`` row carries the mamba2 train run's launches (by
kernel, and the mesh run's by path), the local-heads SSD row the mamba2
mesh serve run's, and the SSD forward row's ``launches_by_path`` the
mamba2 mesh serve and train runs'.
The kernels line also holds the ZeRO path's rows at a rank's shapes
(attention forward and backward at q (1, 2048, 16, 128), the bf16 xent
forward and backward at 2,048 x 151,936) with phase 7b's launches, and
the bf16 xent at the graph's 512 x 151,936 with phase 9b's.
The mesh train rows carry that phase's (1, 2) launches, the xent rows
by offset (``launches_by_offset``) and the backward's by kernel. The
kernels line's attention forward, decode and SSD scan rows carry
``launches_by_path``, each serving path's launches (the mesh's as
``serve mesh``), the mesh decode row ``launches_by_offset``, and the
decode row its split plan (``splits``, ``ms_by_splits``,
``resident_clusters``), a ``paged_shape`` entry timed at the paged
window, ``long_cache`` and ``cold_l2``. The last two lines are the
kernel table as one JSON object and the result
``{"ok": true, "device": {...}}``. It imports nothing of jax.
"""
from __future__ import annotations

import contextlib
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

PEAK_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor cores
PEAK_F32_FLOPS = 67e12              # H100 SXM float32 outside the tensor cores
# Kernel vs plain version at the path shapes, bf16 inputs: set from the
# measured max abs errors 9.8e-4 (attention: bf16 rounding of the output)
# and 4.1e-3 (decode: the plain version rounds its scores to bf16, as JAX's
# einsum does; the kernel keeps them in float32).
ATOL, RTOL = 5e-3, 1e-2
# a kernel vs the plain version on float32 copies of the same inputs: the
# same arithmetic, so only the order of float32 sums differs
F32_TOL = 1e-4
SEED = 0
# the names of the port's kernels, as the profiler's device trace shows them
PORT_KERNELS = ("flash_fwd_", "flash_bwd_", "flash_decode_kernel",
                "xent_fwd_kernel", "xent_bwd_kernel", "ssd_scan_kernel",
                "ssd_tc_", "ssd_bwd_")
# the SSD scan's bf16 call: its three tensor-core kernels
SSD_TC_KERNELS = ("ssd_tc_state_kernel", "ssd_tc_carry_kernel",
                  "ssd_tc_out_kernel")


_START = time.perf_counter()


def phase(name: str) -> None:
    """Start a phase, with the seconds since the script started."""
    print(f"== {name} (at {time.perf_counter() - _START:.1f} s)", flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of ``fn`` on the card, from CUDA events around ``iters``
    calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_ms(fn, kernels, iters: int = 20, warmup: int = 3):
    """Device time per call of ``fn`` spent in the kernels whose names
    contain one of ``kernels`` (the backward's two kernels together), from
    torch.profiler's device trace over ``iters`` calls after ``warmup``
    calls, and each matching kernel's own time per call by its name as the
    trace gives it; (None, {}) if the trace holds no such kernel."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and any(k in e.key for k in kernels)]
    if not ev:
        return None, {}
    by_name = {e.key: e.self_device_time_total / iters / 1e3 for e in ev}
    return sum(by_name.values()), by_name


def timed(entry: dict, kernels, launch, wrapper, iters: int = 20) -> dict:
    """Fill ``ms`` (the kernels' own device time; CUDA events around
    ``launch`` if the profiler saw no device events), ``wrapper_ms`` (CUDA
    events around the wrapper call the model makes), the kernel's and the
    wrapper call's ratios to the library call (``vs_library``,
    ``wrapper_vs_library``: a call that loses to the library call does not
    hide behind a fast kernel) and the bound's share of the kernel's time
    (``bound_share``). ``kernels`` names every kernel the call launches
    (substrings of their names); the names the trace matched are printed
    with their times, so a kernel that misses the filter shows."""
    kernels = (kernels,) if isinstance(kernels, str) else tuple(kernels)
    label = entry.get("name") or "/".join(kernels)
    ms, by_name = kernel_ms(launch, kernels, iters=iters)
    if ms is None:
        print(f"{label}: the profiler saw no device events of {kernels}; "
              "ms is from CUDA events around the launch call")
        ms = cuda_ms(launch, iters=iters)
    else:
        print(f"{label}: timed kernels " + "; ".join(
            f"{k[:80]} {v:.4f} ms" for k, v in by_name.items()))
        if len(kernels) > 1:
            entry["ms_by_kernel"] = {
                name: sum(v for k, v in by_name.items() if name in k)
                for name in kernels}
    entry["ms"] = ms
    entry["wrapper_ms"] = cuda_ms(wrapper, iters=iters)
    lib = entry.get("library_ms")
    entry["vs_library"] = None if lib is None else ms / lib
    entry["wrapper_vs_library"] = (None if lib is None
                                   else entry["wrapper_ms"] / lib)
    entry["bound_share"] = entry["bound_ms"] / ms
    return entry


def agree(name: str, got, want, atol: float, rtol: float) -> float:
    """Max abs error of ``got`` against ``want``; raise past the limit. The
    worst element's share of its limit is printed beside it."""
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    share = (diff / (atol + rtol * want.float().abs())).max().item()
    ok = torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol)
    print(f"{name}: max_abs_err {err:.3e} (limit {atol} + {rtol}*|ref|; "
          f"worst at {share:.2f} of its limit) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             "version")
    return err


def bound_ms(nbytes: float, flops: float, peak: float = PEAK_BF16_FLOPS):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def device_and_build():
    phase("device and build")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    # the process runtime's phases put several processes on the card: a
    # compute mode of EXCLUSIVE_PROCESS refuses the second, and they fail
    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"compute mode: {mode}")
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_decode import kernel as fd
    from repro_torch.kernels.softmax_xent import kernel as xk
    from repro_torch.kernels.ssd_scan import kernel as ssd
    sources = [fa.SOURCE, fd.SOURCE, xk.SOURCE, fa.BWD_SOURCE, ssd.SOURCE,
               ssd.BWD_SOURCE]
    t0 = time.perf_counter()
    _build.build(sources)
    print(f"built {', '.join(sources)} in "
          f"{time.perf_counter() - t0:.1f} s "
          f"(per source: {_build.build_seconds})")
    for src in sources:
        log = _build.library_path(src).with_suffix(".log").read_text()
        usage = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"ptxas {src}: " + " | ".join(usage))
    return smi


def mask_name(causal: bool, S: int, Sk: int) -> str:
    return "causal" if causal else "non-causal" if S == Sk else "cross"


def attention_row(dev, B, S, H, KV, D, seed, Dv=None, Sk=None,
                  causal: bool = True):
    """The attention forward held to its plain version at q (B, S, H, D),
    k (B, Sk, KV, D), v (B, Sk, KV, Dv) (Dv None: D; Sk None: S), causal
    or not, in bf16 (tensor-core kernel) and float32 (CUDA-core kernel),
    and timed: one kernels-line row's numbers."""
    from repro_torch.kernels.flash_attention import kernel as fa
    Dv = D if Dv is None else Dv
    Sk = S if Sk is None else Sk
    rng = np.random.default_rng(seed)
    mk = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.normal(size=shape).astype(np.float32)).to(dev, torch.bfloat16)
    q, k, v = mk(B, S, H, D), mk(B, Sk, KV, D), mk(B, Sk, KV, Dv)
    mask = mask_name(causal, S, Sk)
    what = (f"flash_attention q{tuple(q.shape)} kv{tuple(k.shape)} {mask}"
            if Dv == D else f"flash_attention q{tuple(q.shape)} "
            f"k{tuple(k.shape)} v{tuple(v.shape)} {mask}")
    # bf16 goes to the tensor-core kernel, float32 to the CUDA-core one
    n0, w0 = fa.launches, fa.wgmma_launches
    got = fa.flash_attention(q, k, v, causal=causal)
    want = fa.plain_flash_attention(q, k, v, causal=causal)
    err = agree(f"{what} bf16", got, want, ATOL, RTOL)
    f32 = [t.float() for t in (q, k, v)]
    want32 = fa.plain_flash_attention(*f32, causal=causal)
    err_c = agree(f"{what} bf16 vs the plain version on float32 copies",
                  got, want32, ATOL, RTOL)
    err32 = agree(f"{what} float32", fa.flash_attention(
        *f32, causal=causal), want32, F32_TOL, F32_TOL)
    torch.cuda.synchronize()
    if (fa.launches - n0, fa.wgmma_launches - w0) != (2, 1):
        raise AssertionError("flash_attention: bf16 did not reach the "
                             "tensor-core kernel, or float32 did")
    del f32, want32
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    # unmasked (q, k) pairs
    pairs = S * (S + 1) // 2 if causal else S * Sk
    # S = Q K^T over D and O = P V over Dv: 2 flops a multiply-add each
    b_ms, b_by = bound_ms(nbytes(q, k, v, got),
                          2 * (D + Dv) * H * B * pairs)
    launch = lambda: fa.flash_attention(q, k, v, causal=causal)  # noqa: E731
    row = {
        "max_abs_err": err, "max_abs_err_vs_f32_copies": err_c,
        "f32_max_abs_err": err32,
        "plain_ms": cuda_ms(
            lambda: fa.plain_flash_attention(q, k, v, causal=causal),
            iters=5),
        "bound_ms": b_ms, "bound_by": b_by}
    if Dv == D:
        row["library_ms"] = cuda_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True))
    else:
        row["library_ms"], row["library_backend"] = sdpa_ms(qt, kt, vt)
    return timed(row, "flash_fwd_wgmma_kernel", launch, launch)


def sdpa_ms(q, k, v, do=None):
    """SDPA's causal call on (B, H, S, D) views -- with ``do`` (B, H, S,
    Dv), its backward -- timed on the first backend of flash, cuDNN,
    memory-efficient and math that takes these head dims, and that
    backend's name (the library call's yardstick; the port never calls
    it)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if do is not None:
        q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]):
                if do is None:
                    call = lambda: sdpa(q, k, v, is_causal=True)  # noqa: E731
                else:
                    out = sdpa(q, k, v, is_causal=True)
                    call = lambda: torch.autograd.grad(  # noqa: E731
                        out, (q, k, v), do, retain_graph=True)
                call()
                torch.cuda.synchronize()
                return cuda_ms(call, iters=20 if do is None else 5), \
                    backend.name
        except RuntimeError as e:
            print(f"SDPA {backend.name} refuses q {tuple(q.shape)} v "
                  f"{tuple(v.shape)}" + (" (backward)" if do is not None
                                         else "")
                  + f": {str(e).splitlines()[0][:100]}")
    raise AssertionError("no SDPA backend took these inputs")


ATTENTION_ROW = {"route": "cuda",
                 "source": "src/repro_torch/csrc/flash_attention.cu",
                 "replaces": "src/repro/kernels/flash_attention/kernel.py:75"}
DECODE_ROW = {"route": "cuda",
              "source": "src/repro_torch/csrc/flash_decode.cu",
              "replaces": "src/repro/kernels/flash_decode/kernel.py:60"}


def check_flash_attention(dev):
    """The attention forward at the serving prefill shape (the row's main
    numbers, as in slice 1) and at one training layer (``train_shape``)."""
    entry = {"name": "flash_attention", **ATTENTION_ROW}
    entry.update(attention_row(dev, 1, 512, 16, 8, 128, SEED))
    entry["train_shape"] = attention_row(dev, 2, 2048, 16, 8, 128, SEED + 7)
    return entry


MLA_ROW_NAME = "flash_attention (MLA, D 192 / Dv 128)"


def check_flash_attention_mla(dev):
    """The attention forward at deepseek-v2-lite's serve prefill (q and k
    (1, 512, 16, 192), v (1, 512, 16, 128) bf16, causal: MLA's heads,
    nope 128 + rope 64 against v 128), held and timed as the serving row;
    then the float32 CUDA-core kernel at (192, 128) and at the reduced
    config's (96, 64) on shapes of its own, each within 1e-4 of the plain
    version."""
    from repro_torch.kernels.flash_attention import kernel as fa
    entry = {"name": MLA_ROW_NAME, **ATTENTION_ROW}
    entry.update(attention_row(dev, 1, 512, 16, 16, 192, SEED + 11,
                               Dv=128))
    rng = np.random.default_rng(SEED + 12)
    errs = {}
    for D, Dv, S, H in ((192, 128, 300, 16), (96, 64, 100, 4)):
        q, k = (torch.from_numpy(rng.normal(size=(1, S, H, D)).astype(
            np.float32)).to(dev) for _ in range(2))
        v = torch.from_numpy(rng.normal(size=(1, S, H, Dv)).astype(
            np.float32)).to(dev)
        n0, w0 = fa.launches, fa.wgmma_launches
        got = fa.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        if (fa.launches - n0, fa.wgmma_launches - w0) != (1, 0):
            raise AssertionError("flash_attention: float32 MLA did not run "
                                 "the CUDA-core kernel once")
        errs[f"({D}, {Dv})"] = agree(
            f"flash_attention float32 q{tuple(q.shape)} v{tuple(v.shape)}",
            got, fa.plain_flash_attention(q, k, v, causal=True), F32_TOL,
            F32_TOL)
    entry["f32_max_abs_err_by_head_dims"] = errs
    return entry


def decode_row(entry: dict, q, k, v, cur, what: str,
               k_offset: int = 0) -> dict:
    """Hold the decode kernel to its plain version on ``(q, k, v, cur)``
    (a cache, or a shard of one starting at position ``k_offset``) in bf16
    and on float32 copies of the same inputs, then time it as the other
    kernels are, against SDPA's call on the same cache and mask. The bound
    counts the keys each row reads: K and V of its unmasked keys, and V of
    the whole shard for a row with none (the finite-sentinel average)."""
    from repro_torch.kernels.flash_decode import kernel as fd
    from repro_torch.kernels.flash_decode.ref import (combine_partials,
                                                      flash_decode_partial_ref)
    off = dict(k_offset=k_offset)
    got = combine_partials(*(t[None] for t in fd.flash_decode(
        q, k, v, cur_pos=cur, **off)))
    want = combine_partials(*(t[None] for t in flash_decode_partial_ref(
        q, k, v, cur_pos=cur, **off)))
    entry["max_abs_err"] = agree(f"{what} bf16", got, want, ATOL, RTOL)
    want32 = combine_partials(*(t[None] for t in flash_decode_partial_ref(
        q.float(), k.float(), v.float(), cur_pos=cur, **off)))
    entry["f32_copies_max_abs_err"] = agree(
        f"{what} vs the plain version on float32 copies", got, want32,
        F32_TOL, F32_TOL)
    del want32
    B, L, KV, D = k.shape
    H = q.shape[1]
    keys = (cur.long() - k_offset + 1).clamp(0, L)   # each row's keys
    masked = int((keys == 0).sum().item())
    keys = int(keys.sum().item())
    m, l, acc = fd.flash_decode(q, k, v, cur_pos=cur, **off)
    row_bytes = KV * D * k.element_size()
    entry["bound_ms"], entry["bound_by"] = bound_ms(
        nbytes(q, cur, m, l, acc) + (2 * keys + masked * L) * row_bytes,
        4 * D * H * keys + 2 * D * H * masked * L)
    mask = ((k_offset + torch.arange(L, device=q.device))[None, :]
            <= cur[:, None].long())
    qs, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    entry["plain_ms"] = cuda_ms(
        lambda: flash_decode_partial_ref(q, k, v, cur_pos=cur, **off))
    entry["library_ms"] = cuda_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            qs, kt, vt, attn_mask=mask[:, None, None], enable_gqa=True))
    return timed(entry, "flash_decode_kernel",
                 lambda: fd.flash_decode_cuda_partials(q, k, v, cur, **off),
                 lambda: fd.flash_decode(q, k, v, cur_pos=cur, **off))


def decode_cold_l2(q, k, v, cur, layers: int = 28) -> dict:
    """The decode call as a serve step finds its caches: each of qwen3's
    28 layers reads its own cache, 28 x 9.3 MB, more than the 50 MB L2
    holds, so every call starts cold. The kernel's device time and the
    wrapper call's, cycling through ``layers`` distinct caches."""
    from repro_torch.kernels.flash_decode import kernel as fd
    gen = torch.Generator(device=q.device).manual_seed(SEED + 8)
    caches = [(k, v)] + [
        tuple(torch.randn(k.shape, generator=gen, device=k.device,
                          dtype=torch.float32).to(k.dtype) for _ in "kv")
        for _ in range(layers - 1)]
    turn = [0]

    def nxt():
        turn[0] = (turn[0] + 1) % layers
        return caches[turn[0]]

    launch = lambda: fd.flash_decode_cuda_partials(q, *nxt(), cur)  # noqa: E731
    wrapper = lambda: fd.flash_decode(q, *nxt(), cur_pos=cur)  # noqa: E731
    ms, _ = kernel_ms(launch, ("flash_decode_kernel",), iters=4 * layers,
                      warmup=layers)
    if ms is None:
        print("flash_decode cold L2: the profiler saw no device events; ms "
              "is from CUDA events around the launch call")
        ms = cuda_ms(launch, iters=4 * layers, warmup=layers)
    out = {"ms": ms, "wrapper_ms": cuda_ms(wrapper, iters=4 * layers,
                                           warmup=layers),
           "caches": layers,
           "bytes_cycled": layers * nbytes(k, v)}
    print(f"flash_decode cold L2 ({layers} caches, "
          f"{out['bytes_cycled'] / 1e6:.1f} MB cycled): kernel "
          f"{out['ms']:.4f} ms, wrapper call {out['wrapper_ms']:.4f} ms")
    del caches
    return out


def decode_by_splits(q, k, v, cur) -> dict:
    """The kernel's device time at each cluster size (1-16 splits) on the
    same inputs: how the time follows the split plan."""
    from repro_torch.kernels.flash_decode import kernel as fd
    out = {}
    for ns in (1, 2, 4, 8, 16):
        call = lambda: fd.flash_decode_cuda_partials(  # noqa: E731
            q, k, v, cur, splits=ns)
        ms, _ = kernel_ms(call, ("flash_decode_kernel",))
        out[ns] = cuda_ms(call) if ms is None else ms
    print("flash_decode ms by splits: " + ", ".join(
        f"{ns}: {ms:.4f}" for ns, ms in out.items()))
    return out


def check_flash_decode(dev):
    """The decode kernel at the serve shape (the row's main numbers), warm
    and with a cold L2 (``cold_l2``), and on a long cache
    (``long_cache``: 8,192 positions, rows at 1K-8K keys)."""
    from repro_torch.kernels.flash_decode import kernel as fd
    B, H, KV, D, L = 4, 16, 8, 128, 569
    rng = np.random.default_rng(SEED + 1)
    mk = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.normal(size=shape).astype(np.float32)).to(dev, torch.bfloat16)
    q, k, v = mk(B, H, D), mk(B, L, KV, D), mk(B, L, KV, D)
    cur = torch.tensor([70, 300, 511, L - 1], dtype=torch.int32, device=dev)
    what = (f"flash_decode q{tuple(q.shape)} cache{tuple(k.shape)} "
            f"cur_pos {cur.tolist()} (parked row at {L - 1})")
    # one call runs the kernel alone: no PyTorch op on the card between
    # its launch and the returned tensors (split combine included)
    _, on_card = kernel_ms(lambda: fd.flash_decode(q, k, v, cur_pos=cur),
                           ("",), iters=5)
    print(f"flash_decode call: device work {sorted(on_card)}")
    if not on_card or any("flash_decode_kernel" not in n for n in on_card):
        raise AssertionError("flash_decode: the call ran device work "
                             f"besides its kernel: {sorted(on_card)}")
    entry = decode_row({
        "name": "flash_decode", **DECODE_ROW,
        "splits": fd.split_plan(B, KV, L, fd.sm_count(q.device)),
    }, q, k, v, cur, what)
    entry["cold_l2"] = decode_cold_l2(q, k, v, cur)
    entry["ms_by_splits"] = decode_by_splits(q, k, v, cur)
    # the plan keeps one block an SM: clusters pack into the GPCs with gaps
    entry["resident_clusters"] = {
        ns: fd.resident_clusters(q.dtype, D, ns, q.device)
        for ns in (1, 2, 4, 8, 16)}
    print(f"flash_decode clusters resident at once by splits: "
          f"{entry['resident_clusters']}")
    L = 8192
    rng = np.random.default_rng(SEED + 9)
    q, k, v = mk(B, H, D), mk(B, L, KV, D), mk(B, L, KV, D)
    cur = torch.tensor([1023, 4095, 6143, L - 1], dtype=torch.int32,
                       device=dev)
    entry["long_cache"] = decode_row(
        {"name": "flash_decode (long cache)",
         "splits": fd.split_plan(B, KV, L, fd.sm_count(q.device))},
        q, k, v, cur, f"flash_decode q{tuple(q.shape)} cache{tuple(k.shape)}"
        f" cur_pos {cur.tolist()}")
    entry["long_cache"]["ms_by_splits"] = decode_by_splits(q, k, v, cur)
    return entry


def check_xent(dev, Vl=151936, offset=0, label="", N=None):
    """The xent forward and backward kernels at the training logits (the
    lm_loss of batch 2 x seq 2048 over the padded qwen3 vocab, or of ``N``
    rows, or over a rank's vocab shard of ``Vl`` columns at ``offset``, the
    labels then drawn over every shard up to it), bf16, then on float32
    copies of the same inputs."""
    from repro_torch.kernels.softmax_xent import kernel as xk
    from repro_torch.kernels.softmax_xent.ref import local_stats_ref
    N = N or TRAIN_B * TRAIN_S
    rng = np.random.default_rng(SEED + 4 + offset)
    logits = (torch.from_numpy(rng.normal(size=(N, Vl)).astype(np.float32))
              .to(dev) * 3).to(torch.bfloat16)
    labels = torch.as_tensor(rng.integers(0, offset + Vl, N),
                             dtype=torch.int32, device=dev)
    ds = torch.as_tensor(rng.normal(size=N), dtype=torch.float32, device=dev)
    dz = torch.as_tensor(rng.normal(size=N), dtype=torch.float32, device=dev)
    what = f"logits ({N}, {Vl})" + (f" at offset {offset}" if offset else "")

    def through_autograd(x, stats):
        leaf = x.detach().requires_grad_(True)
        m, s_, z = stats(leaf, labels, offset)
        (g,) = torch.autograd.grad((s_, z), leaf, (ds, dz))
        return (m, s_.detach(), z.detach()), g

    errs = []
    for dt, atol, rtol in ((torch.bfloat16, ATOL, RTOL),
                           (torch.float32, F32_TOL, F32_TOL)):
        x = logits.to(dt)
        got, g = through_autograd(x, xk.xent_local_stats)
        want, wg = through_autograd(x, local_stats_ref)
        err = max(agree(f"xent_local_stats {name} {what} {dt}", a, b, atol,
                        rtol) for name, a, b in zip("msz", got, want))
        gerr = agree(f"xent_local_stats backward {what} {dt}", g, wg, atol,
                     rtol)
        errs.append((err, gerr))
        del got, g, want, wg, x
    torch.cuda.empty_cache()

    m, s_, z = xk.xent_local_stats_cuda(logits, labels, offset)
    fwd_bytes = nbytes(logits, labels, m, s_, z)
    fb_ms, fb_by = bound_ms(fwd_bytes, 4 * N * Vl, PEAK_F32_FLOPS)
    bb_ms, bb_by = bound_ms(fwd_bytes - nbytes(s_, z) + nbytes(ds, dz)
                            + nbytes(logits), 4 * N * Vl, PEAK_F32_FLOPS)
    # the library yardstick at the shard's shape: labels inside the shard
    lab = (labels.long() - offset).clamp(0, Vl - 1)

    def plain_bwd():
        leaf = logits.detach().requires_grad_(True)
        _, s2, z2 = local_stats_ref(leaf, labels, offset)
        return lambda: torch.autograd.grad((s2, z2), leaf, (ds, dz),
                                           retain_graph=True)

    def library_bwd():
        leaf = logits.detach().requires_grad_(True)
        loss = torch.nn.functional.cross_entropy(leaf.float(), lab,
                                                 reduction="none")
        return lambda: torch.autograd.grad(loss, leaf, ds, retain_graph=True)

    fwd = timed({
        "name": "xent_local_stats" + label, "route": "cuda",
        "source": "src/repro_torch/csrc/softmax_xent.cu",
        "replaces": "src/repro/kernels/softmax_xent/kernel.py:67",
        "shape": [N, Vl], "vocab_offset": offset, "dtype": "bfloat16",
        "max_abs_err": errs[0][0], "f32_max_abs_err": errs[1][0],
        "plain_ms": cuda_ms(lambda: local_stats_ref(logits, labels, offset),
                            iters=5),
        "bound_ms": fb_ms, "bound_by": fb_by,
        "library_ms": cuda_ms(lambda: torch.nn.functional.cross_entropy(
            logits.float(), lab, reduction="none"), iters=5),
    }, "xent_fwd_kernel",
        lambda: xk.xent_local_stats_cuda(logits, labels, offset),
        lambda: xk.xent_local_stats(logits, labels, offset))
    bwd_launch = lambda: xk.xent_local_stats_bwd_cuda(  # noqa: E731
        logits, labels, offset, m, ds, dz)
    bwd = timed({
        "name": "xent_local_stats_bwd" + label, "route": "cuda",
        "shape": [N, Vl], "vocab_offset": offset, "dtype": "bfloat16",
        "source": "src/repro_torch/csrc/softmax_xent.cu",
        "replaces": "src/repro/kernels/softmax_xent/kernel.py:67 (its "
                    "backward; no Pallas counterpart)",
        "max_abs_err": errs[0][1], "f32_max_abs_err": errs[1][1],
        "plain_ms": cuda_ms(plain_bwd(), iters=5),
        "bound_ms": bb_ms, "bound_by": bb_by,
        "library_ms": cuda_ms(library_bwd(), iters=5),
    }, "xent_bwd_kernel", bwd_launch, bwd_launch)
    torch.cuda.empty_cache()
    return fwd, bwd


def check_flash_attention_bwd(dev, H=16, KV=8, seed=SEED + 5,
                              name="flash_attention_bwd", B=None, D=128,
                              Dv=None, S=None, Sk=None, causal: bool = True):
    """The attention backward at one training layer of qwen3-1.7b (all 16
    q and 8 kv heads, or a rank's local heads on a mesh; ``B`` rows, by
    default the train batch's), or at MLA's head dims (q and k ``D``, v
    and dO ``Dv``), or at ``S`` q rows over ``Sk`` keys without ``causal``
    (whisper's encoder and cross-attention), against autograd through the
    plain version, bf16 and on float32 copies."""
    from repro_torch.kernels.flash_attention import kernel as fa
    B, S, Dv = B or TRAIN_B, S or TRAIN_S, D if Dv is None else Dv
    Sk = Sk or S
    rng = np.random.default_rng(seed)
    mk = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.normal(size=shape).astype(np.float32)).to(dev, torch.bfloat16)
    q, k, v, do = mk(B, S, H, D), mk(B, Sk, KV, D), mk(B, Sk, KV, Dv), \
        mk(B, S, H, Dv)
    mask = mask_name(causal, S, Sk)
    what = (f"q{tuple(q.shape)} kv{tuple(k.shape)} {mask}" if Dv == D else
            f"q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)} {mask}")

    def grads(attn, dt):
        leaves = [t.detach().to(dt).requires_grad_(True) for t in (q, k, v)]
        out = attn(*leaves, causal=causal)
        return torch.autograd.grad(out, leaves, do.to(dt))

    # The plain version's bf16 autograd sums dk and dv in bf16 (over its
    # 512-row blocks and the G q heads of a kv head), so the bf16 kernel,
    # which sums in float32 and rounds once, is held to the plain version's
    # autograd on float32 copies of the same bf16 inputs; its distance from
    # the plain bf16 autograd is printed beside it.
    def tc_counts():
        return (fa.bwd_dq_launches, fa.bwd_dkdv_launches,
                fa.bwd_dq_wgmma_launches, fa.bwd_dkdv_wgmma_launches)

    def routed(before, tc):
        got = [a - b for a, b in zip(tc_counts(), before)]
        if got != [1, 1, tc, tc]:
            raise AssertionError(f"flash_attention backward: launches {got}"
                                 f", expected [1, 1, {tc}, {tc}]")

    want32 = grads(fa.plain_flash_attention, torch.float32)
    before = tc_counts()
    got = grads(fa.flash_attention, torch.bfloat16)
    routed(before, 1)           # bf16: the tensor-core kernels
    err = max(agree(f"flash_attention backward d{n} {what} bf16 vs the plain "
                    "version on float32 copies", a, b, ATOL, RTOL)
              for n, a, b in zip("qkv", got, want32))
    want = grads(fa.plain_flash_attention, torch.bfloat16)
    print("flash_attention backward bf16 vs the plain bf16 autograd: max "
          "abs err " + ", ".join(
              f"d{n} {(a.float() - b.float()).abs().max().item():.3e}"
              for n, a, b in zip("qkv", got, want)) + " (not held)")
    del got, want
    before = tc_counts()
    got32 = grads(fa.flash_attention, torch.float32)
    routed(before, 0)           # float32: the CUDA-core kernels
    err32 = max(agree(f"flash_attention backward d{n} {what} float32", a, b,
                      F32_TOL, F32_TOL)
                for n, a, b in zip("qkv", got32, want32))
    errs = [err, err32]
    del got32, want32
    torch.cuda.empty_cache()

    _, lse = fa.flash_attention_cuda(q, k, v, causal=causal,
                                     return_lse=True)
    pairs = S * (S + 1) // 2 if causal else S * Sk
    dq, dk, dv = fa.flash_attention_bwd_cuda(q, k, v, lse, do, causal=causal)
    # S, dQ and dK over D, dP and dV over Dv: 2 flops a multiply-add each
    b_ms, b_by = bound_ms(nbytes(q, k, v, lse, do, dq, dk, dv),
                          2 * (3 * D + 2 * Dv) * H * B * pairs)

    def plain_bwd():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = fa.plain_flash_attention(*leaves, causal=causal)
        return lambda: torch.autograd.grad(out, leaves, do,
                                           retain_graph=True)

    def library_bwd():
        leaves = [t.detach().transpose(1, 2).requires_grad_(True)
                  for t in (q, k, v)]
        out = torch.nn.functional.scaled_dot_product_attention(
            *leaves, is_causal=causal, enable_gqa=True)
        dot = do.transpose(1, 2)
        return lambda: torch.autograd.grad(out, leaves, dot,
                                           retain_graph=True)

    launch = lambda: fa.flash_attention_bwd_cuda(  # noqa: E731
        q, k, v, lse, do, causal=causal)
    row = {
        "name": name, "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:75 (its "
                    "backward; no Pallas counterpart)",
        "max_abs_err": errs[0], "f32_max_abs_err": errs[1],
        "plain_ms": cuda_ms(plain_bwd(), iters=3, warmup=1),
        "bound_ms": b_ms, "bound_by": b_by}
    if Dv == D:
        row["library_ms"] = cuda_ms(library_bwd(), iters=5)
    else:
        row["library_ms"], row["library_backend"] = sdpa_ms(
            *(t.transpose(1, 2) for t in (q, k, v, do)))
    return timed(row, ("flash_bwd_dq_wgmma_kernel",
                       "flash_bwd_dkdv_wgmma_kernel"), launch, launch)


MLA_TRAIN_FWD = "flash_attention (MLA, D 192 / Dv 128, training shape)"
MLA_TRAIN_BWD = "flash_attention_bwd (MLA, D 192 / Dv 128)"


def check_flash_attention_mla_train(dev):
    """The attention at deepseek-v2-lite's training layer (q and k (2,
    2048, 16, 192), v and dO (2, 2048, 16, 128) bf16, causal): the forward
    and the backward, each held to its plain version (bf16 and on float32
    copies, the float32 kernels at the same shape within 1e-4) and timed;
    then the float32 backward at the reduced config's (96, 64) within 1e-4
    of the plain version's autograd."""
    from repro_torch.kernels.flash_attention import kernel as fa
    fwd = {"name": MLA_TRAIN_FWD, **ATTENTION_ROW}
    fwd.update(attention_row(dev, TRAIN_B, TRAIN_S, 16, 16, 192, SEED + 31,
                             Dv=128))
    bwd = check_flash_attention_bwd(dev, H=16, KV=16, seed=SEED + 32,
                                    name=MLA_TRAIN_BWD, D=192, Dv=128)
    rng = np.random.default_rng(SEED + 33)
    shapes = ((2, 300, 4, 96), (2, 300, 2, 96), (2, 300, 2, 64),
              (2, 300, 4, 64))
    q, k, v, do = (torch.from_numpy(rng.normal(size=sh).astype(np.float32))
                   .to(dev) for sh in shapes)

    def grads(attn):
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        return torch.autograd.grad(attn(*leaves, causal=True), leaves, do)
    before = (fa.bwd_dq_launches, fa.bwd_dkdv_launches,
              fa.bwd_dq_wgmma_launches, fa.bwd_dkdv_wgmma_launches)
    got = grads(fa.flash_attention)
    torch.cuda.synchronize()
    n = [a - b for a, b in zip((fa.bwd_dq_launches, fa.bwd_dkdv_launches,
                                fa.bwd_dq_wgmma_launches,
                                fa.bwd_dkdv_wgmma_launches), before)]
    if n != [1, 1, 0, 0]:
        raise AssertionError(f"flash_attention backward float32 (96, 64): "
                             f"launches {n}, expected [1, 1, 0, 0]")
    want = grads(fa.plain_flash_attention)
    bwd["f32_max_abs_err_96_64"] = max(agree(
        f"flash_attention backward d{name} float32 q{tuple(q.shape)} "
        f"k{tuple(k.shape)} v{tuple(v.shape)}", a, b, F32_TOL, F32_TOL)
        for name, a, b in zip("qkv", got, want))
    torch.cuda.empty_cache()
    return fwd, bwd


def check_ssd_scan(dev, H: int = 32, name: str = "ssd_scan",
                   long_prompt: bool = True):
    """The SSD scan at the mamba2-370m prefill of the longest serve prompt
    (x (1, 512, H, 64) with H = 32, or a tp = 2 rank's 16 local heads; B
    and C (1, 512, 1, 128) as views into one projection, as the model
    passes them; the row's main numbers) and of a 2048-token prompt
    (``long_prompt``: 16 chunks, how the chunk-parallel form scales), bf16,
    then on float32 copies of the same inputs. No single PyTorch call
    computes the scan: library "none"."""
    from repro_torch.kernels.ssd_scan import kernel as ssd
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref

    def at(L, seed):
        B, P, N, G, Q = 1, 64, 128, 1, 128
        rng = np.random.default_rng(seed)
        mk = lambda *shape: torch.from_numpy(  # noqa: E731
            rng.normal(size=shape).astype(np.float32)).to(dev, torch.bfloat16)
        x, bc = mk(B, L, H, P), mk(B, L, 2 * G * N)
        Bm = bc[..., :G * N].reshape(B, L, G, N)
        Cm = bc[..., G * N:].reshape(B, L, G, N)
        # decays of the model's range: A = -linspace(1, 16), as its init
        dt = torch.as_tensor(rng.uniform(0.01, 0.2, (B, L, H)),
                             dtype=torch.float32, device=dev)
        A = -torch.linspace(1.0, 16.0, H, device=dev)
        D = torch.as_tensor(rng.normal(size=H), dtype=torch.float32,
                            device=dev)
        args = (x, dt, A, Bm, Cm, D)
        what = f"ssd_scan x{tuple(x.shape)} B/C{tuple(Bm.shape)} chunk {Q}"
        errs = []
        # bf16 goes to the tensor-core kernels, float32 to the CUDA-core one
        n0, w0 = ssd.launches, ssd.wgmma_launches
        for dtype, atol, rtol in ((torch.bfloat16, ATOL, RTOL),
                                  (torch.float32, F32_TOL, F32_TOL)):
            a = [t.to(dtype) if t.dtype == torch.bfloat16 else t
                 for t in args]
            y, hT = ssd.ssd_scan(*a, chunk=Q)
            yr, hr = ssd_chunked_ref(*a, chunk=Q)
            errs.append(max(agree(f"{what} y {dtype}", y, yr, atol, rtol),
                            agree(f"{what} hT {dtype}", hT, hr, F32_TOL,
                                  F32_TOL)))
            if dtype == torch.bfloat16:
                y16, h16 = y, hT
        torch.cuda.synchronize()
        if (ssd.launches - n0, ssd.wgmma_launches - w0) != (2, 1):
            raise AssertionError("ssd_scan: bf16 did not reach the "
                                 "tensor-core kernels, or float32 did")
        # the bf16 kernels against the plain version on float32 copies (y,
        # hT of the float32 run above)
        err_c = max(agree(f"{what} y bf16 vs the plain version on float32 "
                          "copies", y16, yr, ATOL, RTOL),
                    agree(f"{what} hT bf16 vs the plain version on float32 "
                          "copies", h16, hr, F32_TOL, F32_TOL))
        y, hT = ssd.ssd_scan_cuda(*args, chunk=Q)
        flops = 0
        for t0 in range(0, L, Q):                # per chunk of Qc steps
            qc = min(Q, L - t0)
            pairs = qc * (qc + 1) // 2           # the causal (i >= j) pairs
            flops += B * H * (2 * pairs * N + 2 * pairs * P + 4 * qc * N * P)
        b_ms, b_by = bound_ms(nbytes(*args, y, hT), flops)
        return timed({
            "max_abs_err": errs[0], "max_abs_err_vs_f32_copies": err_c,
            "f32_max_abs_err": errs[1],
            "plain_ms": cuda_ms(lambda: ssd_chunked_ref(*args, chunk=Q),
                                iters=5),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        }, SSD_TC_KERNELS, lambda: ssd.ssd_scan_cuda(*args, chunk=Q),
            lambda: ssd.ssd_scan(*args, chunk=Q))

    entry = {"name": name, "route": "cuda",
             "source": "src/repro_torch/csrc/ssd_scan.cu",
             "replaces": "src/repro/kernels/ssd_scan/kernel.py:72"}
    entry.update(at(512, SEED + 9))
    if long_prompt:
        entry["long_prompt"] = at(2048, SEED + 10)
    return entry


# the SSD scan's backward against its plain version: relative error in norm
# of each gradient, 1e-2 for bf16 outputs (one bf16 rounding, 2^-9, of each
# element on top of float32 sums in another order) and 1e-4 for float32 ones
SSD_BWD_RTOL_BF16, SSD_BWD_RTOL_F32 = 1e-2, 1e-4


def ssd_bwd_flops(B, L, H, P, N, Q) -> int:
    """The backward's operations these inputs need: per (b, chunk, h) the
    causal Q x Q products (M = C B^T, dW = dy x^T, dC += dM B, dB += dM^T
    C, dx += W^T dy: pairs x (3N + 2P) multiply-adds) and the five P x N x
    Qc state products (S_c, U_c, and the carried states' terms dy h_c in
    dC, x g_c in dB and B g_c^T in dx; the carried part of the gradient of
    cs, e_i (dy h_c)_i . C_i, is read off dC's first term and needs no
    product of its own)."""
    flops = 0
    for t0 in range(0, L, Q):
        qc = min(Q, L - t0)
        pairs = qc * (qc + 1) // 2
        flops += B * H * 2 * (pairs * (3 * N + 2 * P) + 5 * qc * P * N)
    return flops


def check_ssd_scan_bwd(dev, H: int = 32, name: str = "ssd_scan_bwd"):
    """The SSD scan's backward (``ssd_scan_bwd_cuda``) at a mamba2-370m
    training layer's shape (x (2, 2048, H, 64) bf16 with H = 32 on one
    device, or a tp = 2 rank's 16 local heads; B and C (2, 2048, 1, 128) as
    the model's views, dt and D float32, chunk 128, dy bf16, dhT None as in
    training) on the bf16 route (``BWD_TC_KERNELS``: the state and chunk
    passes on the tensor cores, the carry, the head-sum reduce) against the
    plain ``ssd_chunked_bwd_ref`` on the same inputs (which upcasts bf16 to
    float32: the comparison on float32 copies), timed; a second call on the
    same inputs must give the same bits. At H = 32 also float32 at the
    reduced mamba2 shape (x (2, 64, 16, 32), N 32, chunk 32) with dhT
    given, on the five CUDA-core kernels (``BWD_KERNELS``), held at the
    float32 limit; at a rank's local heads also the forward the train step
    runs there (``ssd_scan_cuda``, bf16 on the tensor-core kernels) against
    ``ssd_chunked_ref``. Each call must launch its route's kernels once
    and none of the other route's. No PyTorch call computes this function:
    library "none"."""
    from repro_torch.kernels.ssd_scan import kernel as ssd
    from repro_torch.kernels.ssd_scan.ref import (ssd_chunked_bwd_ref,
                                                  ssd_chunked_ref)

    def inputs(B, L, H, P, N, dtype, seed, with_dhT):
        rng = np.random.default_rng(seed)
        mk = lambda *shape: torch.from_numpy(  # noqa: E731
            rng.normal(size=shape).astype(np.float32)).to(dev, dtype)
        x, bc, dy = mk(B, L, H, P), mk(B, L, 2 * N), mk(B, L, H, P)
        Bm, Cm = (bc[..., :N].reshape(B, L, 1, N),
                  bc[..., N:].reshape(B, L, 1, N))
        dt = torch.as_tensor(rng.uniform(0.01, 0.2, (B, L, H)),
                             dtype=torch.float32, device=dev)
        A = -torch.linspace(1.0, 16.0, H, device=dev)
        D = torch.as_tensor(rng.normal(size=H), dtype=torch.float32,
                            device=dev)
        dhT = (torch.as_tensor(rng.normal(size=(B, H, P, N)),
                               dtype=torch.float32, device=dev)
               if with_dhT else None)
        return (x, dt, A, Bm, Cm, D), dy, dhT

    def launched(what, call, dtype, P, N):
        """``call()``, which must launch the route of ``dtype``, ``P`` and
        ``N`` once."""
        before, w0 = dict(ssd.bwd_launches), ssd.bwd_wgmma_launches
        out = call()
        torch.cuda.synchronize()
        route = ssd.bwd_kernels(dtype, P, N)
        got = {k: ssd.bwd_launches[k] - before[k] for k in before}
        want = {k: int(k in route) for k in before}
        calls = ssd.bwd_wgmma_launches - w0
        print(f"{what}: launches {got}, tensor-core calls {calls}")
        if got != want or calls != ssd.bwd_tc(dtype, P, N):
            raise AssertionError(f"{what}: launches {got}, tensor-core "
                                 f"calls {calls}; expected {want}")
        return out

    def held(what, got, want):
        worst = 0.0
        for n, g, w in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), got,
                           want):
            err = ((g.double() - w.double()).norm()
                   / w.double().norm()).item()
            limit = (SSD_BWD_RTOL_BF16 if g.dtype == torch.bfloat16
                     else SSD_BWD_RTOL_F32)
            ok = bool(torch.isfinite(g).all()) and err <= limit
            print(f"{what} {n} {g.dtype}: relative err in norm {err:.3e} "
                  f"(limit {limit}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{what}: {n} disagrees with the plain "
                                     "version")
            worst = max(worst, err)
        return worst

    B, L, P, N, Q = TRAIN_B, TRAIN_S, 64, 128, 128
    args, dy, _ = inputs(B, L, H, P, N, torch.bfloat16, SEED + 18, False)
    what = (f"ssd_scan backward x{tuple(args[0].shape)} "
            f"B/C{tuple(args[3].shape)} chunk {Q}")
    call = lambda: ssd.ssd_scan_bwd_cuda(*args, dy, chunk=Q)  # noqa: E731
    got = launched(f"{what} bf16", call, torch.bfloat16, P, N)
    again = call()
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    print(f"{what}: two calls bitwise equal: {same}")
    if not same:
        raise AssertionError(f"{what}: two calls on the same inputs differ")
    del again
    want = ssd_chunked_bwd_ref(*args, dy, chunk=Q)
    err = held(what, got, want)
    max_abs = max((g.float() - w.float()).abs().max().item()
                  for g, w in zip(got, want))
    del want
    entry = {"name": name, "route": "cuda",
             "source": "src/repro_torch/csrc/ssd_scan_bwd.cu",
             "replaces": "none (the backward of src/repro/kernels/ssd_scan/"
                         "kernel.py:72 ssd_scan_pallas; the reference "
                         "differentiates its jnp ssd_chunked_ref)",
             "kernels": list(ssd.BWD_TC_KERNELS),
             "max_abs_err": max_abs, "max_rel_err_in_norm": err,
             "bitwise_repeatable": same,
             "scratch_bytes": 4 * ssd.bwd_scratch_floats(
                 B, L, H, P, N, Q, tc=True)}
    if H == 32:
        small, dy32, dhT = inputs(2, 64, 16, 32, 32, torch.float32,
                                  SEED + 19, True)
        what32 = "ssd_scan backward x(2, 64, 16, 32) float32 (reduced mamba2)"
        entry["f32_max_rel_err_in_norm"] = held(what32, launched(
            what32, lambda: ssd.ssd_scan_bwd_cuda(*small, dy32, dhT,
                                                  chunk=32), torch.float32,
            32, 32),
            ssd_chunked_bwd_ref(*small, dy32, dhT, chunk=32))
    else:
        # the forward of the same train step: SsdScan.forward's call
        w0 = ssd.wgmma_launches
        y, hT = ssd.ssd_scan_cuda(*args, chunk=Q)
        yr, hr = ssd_chunked_ref(*args, chunk=Q)
        torch.cuda.synchronize()
        if ssd.wgmma_launches != w0 + 1:
            raise AssertionError(f"{what}: the bf16 forward did not reach "
                                 "the tensor-core kernels")
        entry["fwd_max_abs_err"] = max(
            agree(f"{what} forward y bf16", y, yr, ATOL, RTOL),
            agree(f"{what} forward hT bf16", hT, hr, F32_TOL, F32_TOL))
        del y, hT, yr, hr
    # each input read once (x, dt, A, B, C, D, dy), each gradient written
    # once
    b_ms, b_by = bound_ms(nbytes(*args, dy, *got),
                          ssd_bwd_flops(B, L, H, P, N, Q))
    entry.update({
        "plain_ms": cuda_ms(lambda: ssd_chunked_bwd_ref(*args, dy, chunk=Q),
                            iters=3, warmup=1),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    return timed(entry, ssd.BWD_TC_KERNELS, call, call)


def check_reference(dev, arch: str = "qwen3-1.7b"):
    """Reduced ``arch`` (float32) through the kernels on the card against
    the same weights on the CPU's plain path: prefill logits, then four
    decode steps fed the CPU's greedy tokens. Every prefill's attention
    runs the float32 CUDA-core kernel (for deepseek-v2-lite at MLA's
    reduced head dims, 96 / 64)."""
    phase(f"reference (reduced {arch}, card vs CPU plain path)")
    from repro_torch.api import greedy_from_logits
    from repro_torch.configs.registry import get_config
    from repro_torch.core.lowering import lower_serve_stages
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.models.common import MeshPlan
    from repro_torch.models.model_zoo import build_model

    cfg = get_config(arch).reduced()
    n0, w0 = fa.launches, fa.wgmma_launches
    rng = np.random.default_rng(SEED + 2)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in (37, 100)]
    geo = dict(num_stages=2, cache_len=160, max_prompt_len=128,
               group_size=len(prompts))
    # the same seeded weights on each device (the init runs on the CPU)
    progs = {d: lower_serve_stages(
        cfg, build_model(cfg, MeshPlan.single_device(), seed=SEED,
                         device="cpu").to(d),
        **geo) for d in ("cpu", dev)}
    worst = 0.0

    def compare(a, b, what):
        nonlocal worst
        err = (a.cpu() - b).abs().max().item()
        worst = max(worst, err)
        if not torch.allclose(a.cpu(), b, rtol=1e-3, atol=1e-3):
            raise AssertionError(f"{what}: card and CPU disagree "
                                 f"(max abs err {err:.3e})")

    with torch.inference_mode():
        caches = {d: [s.init_caches(len(prompts)) for s in p.stages]
                  for d, p in progs.items()}
        toks = []
        for slot, pr in enumerate(prompts):
            out = {}
            for d, p in progs.items():
                x = torch.as_tensor(pr[None], dtype=torch.int32, device=d)
                for s, st in enumerate(p.stages):
                    x, sc = st.prefill(st.params, x, pr.size - 1)
                    st.write_slot(caches[d][s], sc, slot)
                out[d] = x
            compare(out[dev], out["cpu"], f"prefill logits, prompt {slot}")
            toks.append(int(greedy_from_logits(out["cpu"], cfg.vocab_size)))
        pos = [pr.size for pr in prompts]
        for step in range(4):
            out = {}
            for d, p in progs.items():
                x = torch.tensor(toks, dtype=torch.int32, device=d)
                pt = torch.tensor(pos, dtype=torch.int32, device=d)
                for s, st in enumerate(p.stages):
                    x, _ = st.decode(st.params, caches[d][s], x, pt)
                out[d] = x
            compare(out[dev], out["cpu"], f"decode step {step} logits")
            toks = greedy_from_logits(out["cpu"], cfg.vocab_size).tolist()
            pos = [p_ + 1 for p_ in pos]
    torch.cuda.synchronize()
    want = (cfg.num_layers * len(prompts), 0)
    if (fa.launches - n0, fa.wgmma_launches - w0) != want:
        raise AssertionError(f"reduced {arch}: attention launches "
                             f"{fa.launches - n0} (tensor-core "
                             f"{fa.wgmma_launches - w0}), expected {want}")
    print(f"reduced {arch} prefill + 4 decode steps: logits agree, max abs "
          f"err {worst:.3e} (bound 1e-3 + 1e-3*|ref|, float32); "
          f"{want[0]} float32 attention launches, none on the tensor cores")


def check_reference_train(dev, arch: str = "qwen3-1.7b", zero: bool = False):
    """Two training steps of the reduced ``arch`` (float32) through the
    kernels on the card against the same two steps on the CPU's plain path,
    from the same initial weights and batches: loss, ``aux_loss`` and
    grad_norm within 1e-4. ``zero``: the card runs the ZeRO 1 x 1 step
    (the taped loss program; for deepseek-v2-lite its MLA and MoE steps),
    the CPU the plain one. whisper and pixtral take their batches in the
    reference's forms (``launch.serve.classic_batch``: 2 x 64 tokens over
    2 x 64 frames; 2 x 64 patch embeddings and labels), the other archs
    ``SyntheticLM`` tokens."""
    phase(f"reference train (reduced {arch}, card"
          + (" ZeRO 1 x 1" if zero else "") + " vs CPU plain path, 2 steps)")
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.serve import classic_batch
    from repro_torch.models.transformer import has_frontend
    from repro_torch.train.steps import make_train_step

    cfg = get_config(arch).reduced()
    if has_frontend(cfg):
        rng = np.random.default_rng(SEED + 6)
        batches = [classic_batch(cfg, 2, 64, rng, "train") for _ in range(2)]
    else:
        src = SyntheticLM(cfg.vocab_size, 2, 64, seed=SEED + 6)
        batches = [{"tokens": src(i)} for i in range(2)]
    init = None
    runs = {}
    zero_train_counts()
    for d in ("cpu", dev):
        card_zero = zero and d != "cpu"
        ts = make_train_step(cfg, zero=card_zero, device=d)
        if init is None:
            params = ts.init_params(SEED)
            init = {n: t.detach().clone()
                    for n, t in params.state_dict().items()}
        elif card_zero:
            params = ts.shard_params_fn(init)
        else:
            params = ts.init_params(SEED)
            params.load_state_dict(init)
        opt = ts.init_opt(params)
        runs[d] = []
        for b in batches:
            params, opt, m = ts.step_fn(params, opt, b)
            runs[d].append(tuple(float(m[k]) for k in
                                 ("loss", "aux_loss", "grad_norm")))
    # float32 attention runs on the CUDA-core kernels, none on tensor cores
    n = train_counts()
    if (min(n["flash_attention"], n["flash_bwd_dq_kernel"],
            n["flash_bwd_dkdv_kernel"]) < 2
            or n["flash_fwd_wgmma_kernel"] or n["flash_bwd_dq_wgmma_kernel"]
            or n["flash_bwd_dkdv_wgmma_kernel"]):
        raise AssertionError(f"reduced {arch} train steps, float32: launches "
                             f"{n}; expected the CUDA-core kernels only")
    print(f"reduced {arch} float32 train steps: attention launches {n}")
    worst = 0.0
    for got, want in zip(runs[dev], runs["cpu"]):
        err = max(abs(g - w) / max(abs(w), 1e-30) for g, w in zip(got, want)
                  if w or g)
        worst = max(worst, err)
        if err > REF_TRAIN_RTOL:
            raise AssertionError(f"train steps: card {runs[dev]} vs CPU "
                                 f"{runs['cpu']}")
    if cfg.num_experts and not all(r[1] > 0 for r in runs[dev]):
        raise AssertionError(f"reduced {arch}: aux_loss {runs[dev]} not > 0")
    print(f"reduced {arch}, 2 train steps: card (loss, aux_loss, grad_norm) "
          f"{runs[dev]}, CPU {runs['cpu']}; max relative err {worst:.3e} "
          f"(bound {REF_TRAIN_RTOL}, float32)")


def check_reference_mamba(dev):
    """Reduced mamba2 (float32) served through the SSD kernel on the card
    against the same weights on the CPU's plain path: the same tokens on
    the stage actors, then prefill logits within 1e-3."""
    phase("reference (reduced mamba2, card vs CPU plain path)")
    from repro_torch import api
    from repro_torch.configs.registry import get_config
    from repro_torch.core.lowering import lower_serve_stages
    from repro_torch.kernels.ssd_scan import kernel as ssd
    from repro_torch.models.common import MeshPlan
    from repro_torch.models.model_zoo import build_model

    cfg = get_config("mamba2-370m").reduced()
    rng = np.random.default_rng(SEED + 8)
    requests = [(rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32), g)
                for n, g in ((37, 6), (100, 3), (5, 8), (64, 4))]
    # the same seeded weights on each device (the init runs on the CPU)
    state = build_model(cfg, MeshPlan.single_device(), seed=SEED,
                        device="cpu").state_dict()
    outs, launches = {}, {}
    for d in ("cpu", dev):
        ssd.launches = ssd.wgmma_launches = 0
        with api.compile(cfg, mode="serve", backend="actors", stages=2,
                         params=state, device=d, num_groups=2, group_size=1,
                         max_prompt_len=128, max_new_tokens=8) as sess:
            outs[d] = sess.generate(requests)
        launches[d] = (ssd.launches, ssd.wgmma_launches)
    # float32: every launch on the CUDA-core kernel
    want = {"cpu": (0, 0), dev: (len(requests) * cfg.num_layers, 0)}
    same = all(np.array_equal(a, b) for a, b in zip(outs["cpu"], outs[dev]))
    print(f"reduced mamba2 served on the stage actors: tokens identical to "
          f"the CPU's: {same}; ssd_scan (launches, tensor-core launches) "
          f"{launches} (expected {want})")
    if not same or launches != want:
        raise AssertionError(f"reduced mamba2: card {outs[dev]} vs CPU "
                             f"{outs['cpu']}, launches {launches}")
    progs = {d: lower_serve_stages(cfg, build_model(
        cfg, MeshPlan.single_device(), seed=SEED, device="cpu").to(d),
        num_stages=2, cache_len=128, max_prompt_len=100, group_size=1)
        for d in ("cpu", dev)}
    worst = 0.0
    with torch.inference_mode():
        for toks, _ in requests:
            out = {}
            for d, p in progs.items():
                x = torch.as_tensor(toks[None], device=d)
                for st in p.stages:
                    x, _ = st.prefill(st.params, x, toks.size - 1)
                out[d] = x.cpu()
            worst = max(worst, (out[dev] - out["cpu"]).abs().max().item())
            if not torch.allclose(out[dev], out["cpu"], rtol=1e-3, atol=1e-3):
                raise AssertionError(f"reduced mamba2 prefill of {toks.size} "
                                     "tokens: card and CPU logits disagree")
    print(f"reduced mamba2 prefill logits: max abs err {worst:.3e} (bound "
          "1e-3 + 1e-3*|ref|, float32)")


def serve_counts():
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_decode import kernel as fd
    from repro_torch.kernels.ssd_scan import kernel as ssd
    return {"flash_attention": fa.launches,
            "flash_fwd_wgmma_kernel": fa.wgmma_launches,
            "flash_decode": fd.launches, "ssd_scan": ssd.launches,
            "ssd_scan_wgmma": ssd.wgmma_launches}


def zero_serve_counts():
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_decode import kernel as fd
    from repro_torch.kernels.ssd_scan import kernel as ssd
    fa.launches = fa.wgmma_launches = ssd.launches = 0
    ssd.wgmma_launches = 0
    fd.reset_counts()


def serve_requests(cfg, n_req: int = 12, seed: int = SEED + 3,
                   lens=(64, 512), gens=(8, 48)):
    """``n_req`` numpy-seeded requests: prompts of ``lens`` tokens (inclusive
    range) and ``gens`` new tokens."""
    rng = np.random.default_rng(seed)
    n = rng.integers(lens[0], lens[1] + 1, n_req)
    g = rng.integers(gens[0], gens[1] + 1, n_req)
    return [(rng.integers(0, cfg.vocab_size, (k,)).astype(np.int32), int(m))
            for k, m in zip(n, g)]


def serve(dev, arch: str):
    """The main path: full-width ``arch`` on the stage actors, then the
    same requests on the monolithic engine, each run's kernel launches
    counted and checked: per layer, one attention forward per prefill and
    one decode per decode item, or one SSD scan per prefill. Returns the
    launch counts of the actor run, and ``{"outs", "tok_per_s",
    "mono_tok_per_s"}``: its tokens and both runs' rates."""
    phase(f"serve ({arch}, full width, bf16, actors x 2 stages)")
    from repro_torch import api
    from repro_torch.configs.registry import get_config

    cfg = get_config(arch)
    requests = serve_requests(cfg)
    n_req = len(requests)
    geo = dict(num_groups=2, group_size=4, max_prompt_len=512,
               max_new_tokens=48, seed=SEED)

    t0 = time.perf_counter()
    sess = api.compile(cfg, mode="serve", backend="actors", stages=2, **geo)
    torch.cuda.synchronize()
    print(f"compiled in {time.perf_counter() - t0:.1f} s "
          f"(cache_len {sess.cache_len})")
    print(sess.describe())
    def counted(session):
        zero_serve_counts()
        out = session.generate(requests)
        got = serve_counts()
        st = session.last_stats
        L = cfg.num_layers
        ssm = cfg.family == "ssm"
        # every bf16 attention forward and SSD scan on the tensor cores
        want = {"flash_attention": 0 if ssm else L * st["prefill_items"],
                "flash_fwd_wgmma_kernel":
                    0 if ssm else L * st["prefill_items"],
                "flash_decode": 0 if ssm else L * st["decode_items"],
                "ssd_scan": L * st["prefill_items"] if ssm else 0,
                "ssd_scan_wgmma": L * st["prefill_items"] if ssm else 0}
        print(f"launches on the {session.backend} run: {got} (expected "
              f"{want}: {L} layers, {st['prefill_items']} prefills, "
              f"{st['decode_items']} decode items)")
        if got != want or st["prefill_items"] != n_req:
            raise AssertionError(f"{session.backend}: kernel launches {got},"
                                 f" expected {want}")
        return out, got

    torch.cuda.reset_peak_memory_stats()
    outs, launches = counted(sess)
    st = sess.last_stats
    peak = torch.cuda.max_memory_allocated()
    if arch == "qwen3-1.7b":
        cache_bound_vs_held(sess, "serve actors dense")
    sess.close()
    del sess
    torch.cuda.empty_cache()

    for i, (o, (_, g)) in enumerate(zip(outs, requests)):
        if len(o) != g or (o < 0).any() or (o >= cfg.vocab_size).any():
            raise AssertionError(f"request {i}: {len(o)} ids (want {g}), "
                                 f"range [{o.min()}, {o.max()}]")
    if st["admitted_mid_flight"] < 1:
        raise AssertionError("no request was admitted mid-flight")
    print(f"actors: {st['requests']} requests, {st['tokens']} tokens in "
          f"{st['rounds']} rounds, {st['wall_s']:.3f} s wall, "
          f"{st['tok_per_s']:.2f} tok/s, {st['prefill_items']} prefill + "
          f"{st['decode_items']} decode items, {st['admitted_mid_flight']} "
          f"admitted mid-flight, peak memory {peak / 2**30:.2f} GiB")

    mono = api.compile(cfg, mode="serve", backend="monolithic", **geo)
    ref, _ = counted(mono)
    ms = mono.last_stats
    same = all(np.array_equal(a, b) for a, b in zip(outs, ref))
    print(f"monolithic: {ms['tokens']} tokens, {ms['wall_s']:.3f} s wall, "
          f"{ms['tok_per_s']:.2f} tok/s; tokens identical to actors: {same}")
    if not same:
        raise AssertionError("actors and monolithic tokens differ")
    # the idle share from the first 4 requests, the device traced alone:
    # the host's op events of a whole run take minutes to post-process
    profile_device(f"{mono.backend} generate (requests 0-3)",
                   lambda: mono.generate(requests[:4]), cpu=False)
    mono.close()
    return launches, {"outs": outs, "tok_per_s": st["tok_per_s"],
                      "mono_tok_per_s": ms["tok_per_s"]}


def profile_device(what: str, fn, top: int = 8, cpu: bool = True):
    """Where the time goes: the device's busy time and its kernels by name
    over one more run of ``fn``, from torch.profiler's device trace (the
    profiler's own cost is in the wall time): the ``top`` kernels by time,
    then the port's own kernels (``PORT_KERNELS``) that are not among
    them. ``cpu=False`` traces the device alone, which spares the host's
    op events their post-processing."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    t_start = time.perf_counter()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        print(f"profiled {what}: {wall:.3f} s wall; the trace holds no "
              "device events, so the idle share is not measured")
        return
    busy = sum(e.self_device_time_total for e in kern) / 1e6
    print(f"profiled {what}: {wall:.3f} s wall (profiler on), device busy "
          f"{busy:.3f} s, idle share {1 - busy / wall:.3f} (the profile "
          f"took {time.perf_counter() - t_start:.1f} s in all)")
    ranked = sorted(kern, key=lambda e: -e.self_device_time_total)
    for i, e in enumerate(ranked):
        if i < top or any(k in e.key for k in PORT_KERNELS):
            print(f"  {e.self_device_time_total / 1e3:10.3f} ms  "
                  f"{e.count:6d} x  {e.key[:90]}")


# the paged, chunked and sampled serving phases: qwen3-1.7b's paged pool
# holds half of what a dense reservation of its 8 slots does, at a cache_len
# that 16 divides (569, the serve phase's, is prime, so its largest page
# length up to 16 would be 1); their dense baselines run at the same 576,
# since the decode kernel's split count follows the cache length
PAGED_GEO = dict(num_groups=2, group_size=4, max_prompt_len=512,
                 max_new_tokens=48, cache_len=576, seed=SEED)
PAGED = dict(cache="paged", page_len=16, num_pages=144)
CHUNK = 16
SAMPLING = dict(temperature=0.8, top_k=50, top_p=0.95, seed=1)


def check_outputs(cfg, outs, requests, what: str) -> None:
    for i, (o, (_, g)) in enumerate(zip(outs, requests)):
        if len(o) != g or (o < 0).any() or (o >= cfg.vocab_size).any():
            raise AssertionError(f"{what} request {i}: {len(o)} ids (want "
                                 f"{g}), range [{o.min()}, {o.max()}]")


def same_tokens(a, b) -> bool:
    return len(a) == len(b) and all(np.array_equal(x, y)
                                    for x, y in zip(a, b))


def counted_run(cfg, session, requests, what: str):
    """One ``generate`` with the launch counters zeroed just before and
    read just after, held to the launches the scheduler's work implies:
    per layer one attention forward (or SSD scan) per unchunked prefill,
    one decode per decode item and per chunk token. Returns the tokens,
    the counts and the run's peak memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sec0 = dict(getattr(session.executor, "item_seconds", None) or {})
    zero_serve_counts()
    out = session.generate(requests)
    got = serve_counts()
    peak = torch.cuda.max_memory_allocated()
    st = session.last_stats
    L, ssm = cfg.num_layers, cfg.family == "ssm"
    pre = L * st["prefill_items"]
    steps = L * (st["decode_items"] + st["chunk_tokens"])
    # MLA decodes by absorbed einsums over its latent cache (as the
    # reference), no decode kernel
    want = {"flash_attention": 0 if ssm else pre,
            "flash_fwd_wgmma_kernel": 0 if ssm else pre,
            "flash_decode": 0 if ssm or cfg.use_mla else steps,
            "ssd_scan": pre if ssm else 0, "ssd_scan_wgmma": pre if ssm else 0}
    print(f"{what}: launches {got} (expected {want}: {L} layers, "
          f"{st['prefill_items']} prefills, {st['decode_items']} decode "
          f"items, {st['chunk_items']} chunks of {st['chunk_tokens']} "
          f"tokens)")
    if got != want:
        raise AssertionError(f"{what}: kernel launches {got}, expected "
                             f"{want}")
    check_outputs(cfg, out, requests, what)
    extra = ""
    if "peak_pages" in st:
        extra = (f", peak pages {st['peak_pages']}, shared pages "
                 f"{st['shared_pages']}")
    sec = getattr(session.executor, "item_seconds", None)
    if sec is not None:                 # the inline engine times its items
        extra += ", ms an item: " + ", ".join(
            f"{k} {(sec[k] - sec0[k]) * 1e3 / n:.2f}" for k, n in (
                ("prefill", st["prefill_items"]),
                ("decode", st["decode_items"]),
                ("chunk", st["chunk_tokens"])) if n)
    print(f"{what}: {st['requests']} requests, {st['tokens']} tokens in "
          f"{st['rounds']} rounds, {st['wall_s']:.3f} s wall, "
          f"{st['tok_per_s']:.2f} tok/s, peak memory "
          f"{peak / 2**30:.2f} GiB{extra}")
    return out, got, peak


def seeded_model(arch: str, dev):
    """The port's seeded init of ``arch`` (what ``compile(seed=SEED)``
    builds), made once and shared by a phase's sessions. A model with no
    float32-read params is drawn in its compute dtype, each leaf cast as
    it is drawn (the values of the float32 init's cast, what a serve stage
    holds), so its sessions share those weights and no float32 copy is
    ever resident (deepseek-v2-lite would need 62.8 GB of it)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.common import MeshPlan
    from repro_torch.models.model_zoo import build_model
    from repro_torch.models.transformer import compute_dtype, has_ssm_layers
    cfg = get_config(arch)
    model = build_model(cfg, MeshPlan.single_device(), seed=SEED, device=dev,
                        dtype=None if has_ssm_layers(cfg)
                        else compute_dtype(cfg))
    return cfg, model


def compile_serve(cfg, model, backend: str, **kw):
    from repro_torch import api
    extra = dict(stages=2) if backend == "actors" else {}
    return api.compile(cfg, mode="serve", backend=backend, params=model,
                       **extra, **kw)


def closed(session) -> None:
    session.close()
    gc.collect()
    torch.cuda.empty_cache()


DEEPSEEK = "deepseek-v2-lite-16b"
# the kernels-line label of the xent rows at deepseek-v2-lite's vocabulary
DEEPSEEK_XENT = " (deepseek-v2-lite vocab)"


def deepseek_vocab() -> int:
    """deepseek-v2-lite's padded vocabulary, the train logits' columns."""
    from repro_torch.configs.registry import get_config
    return get_config(DEEPSEEK).padded_vocab()


def serve_deepseek(dev):
    """deepseek-v2-lite-16b at full width and depth (27 layers: one dense
    layer, then 26 of MLA with 64 routed experts top-6 and 2 shared; 15.7 B
    params in bf16, seeded and drawn in bf16), in qwen3's serve geometry
    and requests: the stage actors (2 stages), then the monolithic engine
    on the same weights, tokens identical. Each run's launches are counted
    as the other serve phases' are: every prefill's MLA attention on the
    tensor-core kernel at (192, 128), 27 x 12 = 324 a run, and no decode
    kernel (MLA decodes by absorbed einsums over its latent cache, as the
    reference does); tok/s, peak memory, then a device profile of the
    first 4 requests. The model is freed before it returns. Returns the
    actor run's launches."""
    phase(f"serve ({DEEPSEEK}, full width, bf16, actors x 2 stages, then "
          "monolithic)")
    t0 = time.perf_counter()
    cfg, model = seeded_model(DEEPSEEK, dev)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    held = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"seeded {n:,} params ({held / 2**30:.2f} GiB in bf16) in "
          f"{time.perf_counter() - t0:.1f} s; peak memory so far "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    requests = serve_requests(cfg)
    geo = dict(num_groups=2, group_size=4, max_prompt_len=512,
               max_new_tokens=48, seed=SEED)
    outs, counts = {}, {}
    for backend in ("actors", "monolithic"):
        sess = compile_serve(cfg, model, backend, **geo)
        if backend == "actors":
            print(f"cache_len {sess.cache_len}")
            print(sess.describe())
        outs[backend], counts[backend], _ = counted_run(
            cfg, sess, requests, f"{DEEPSEEK} {backend}")
        st = sess.last_stats
        if (counts[backend]["flash_fwd_wgmma_kernel"]
                != cfg.num_layers * len(requests)
                or st["admitted_mid_flight"] < 1):
            raise AssertionError(f"{DEEPSEEK} {backend}: {st['prefill_items']}"
                                 f" prefills, {st['admitted_mid_flight']} "
                                 "admitted mid-flight")
        if backend == "monolithic":
            profile_device(f"{DEEPSEEK} monolithic generate (requests 0-3)",
                           lambda: sess.generate(requests[:4]), cpu=False)
        closed(sess)
    same = same_tokens(outs["actors"], outs["monolithic"])
    print(f"{DEEPSEEK}: tokens identical on actors and monolithic: {same}")
    if not same:
        raise AssertionError(f"{DEEPSEEK}: actors and monolithic tokens "
                             "differ")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return counts["actors"]


def check_paged_decode(dev):
    """The decode kernel at the paged path's shape: qwen3's window of 576
    positions gathered from 36 pages of 16 by the paged index program (4
    slots, one unmapped and parked) against the plain version on the same
    window, timed as the other kernels are."""
    from repro_torch.serve.paged_cache import PagedCacheSpec, _build_paged_ops
    B, H, KV, D, L = 4, 16, 8, 128, PAGED_GEO["cache_len"]
    pl, n_pages = PAGED["page_len"], PAGED["num_pages"]
    spec = PagedCacheSpec(page_len=pl, num_pages=n_pages, max_requests=8,
                          pages_per_req=L // pl)
    rng = np.random.default_rng(SEED + 6)
    mk = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.normal(size=shape).astype(np.float32)).to(dev, torch.bfloat16)
    slabs = [{key: mk(n_pages * pl + 2, KV, D) for key in ("k", "v")}]
    for t in slabs[0].values():
        t[-2:] = 0                                  # the sentinel rows
    rows = rng.permutation(n_pages)[:B * spec.pages_per_req]
    rows = torch.as_tensor(rows.reshape(B, -1), dtype=torch.int32,
                           device=dev)
    rows[3] = -1
    sids = torch.tensor([0, 1, 2, -1], dtype=torch.int32, device=dev)
    win = _build_paged_ops(spec, B, L, dev)["gather"](slabs, rows, sids)[0]
    k, v = win["k"], win["v"]
    q = mk(B, H, D)
    cur = torch.tensor([70, 300, 511, L - 1], dtype=torch.int32, device=dev)
    return decode_row({"name": "flash_decode (paged window)"}, q, k, v,
                      cur, f"flash_decode on a gathered paged window "
                      f"q{tuple(q.shape)} window{tuple(k.shape)} cur_pos "
                      f"{cur.tolist()}")


def serve_paged(dev, cfg, model):
    """qwen3-1.7b paged: the serve phase's 12 requests plus 3 repeating the
    prompt of its longest-lived request, queued last so that request is
    still live (and donates its prompt's pages) when they are admitted.
    Dense monolithic at cache_len 576, then paged on the actors and paged
    monolithic: the same tokens, pages shared, the pool half the dense
    reservation (plus its page table). Returns the paged actors run's
    launches."""
    phase("serve paged (qwen3-1.7b, full width, bf16, page_len 16, "
          "144 pages)")
    requests = serve_requests(cfg)
    donor = max(range(len(requests)), key=lambda i: requests[i][1])
    requests += [(requests[donor][0], g) for g in (8, 12, 16)]
    dense = compile_serve(cfg, model, "monolithic", **PAGED_GEO)
    ref, _, _ = counted_run(cfg, dense, requests, "dense monolithic (576)")
    dense_bytes = dense.cache_bytes()
    closed(dense)
    launches = None
    for backend in ("actors", "monolithic"):
        sess = compile_serve(cfg, model, backend, **PAGED_GEO, **PAGED)
        if backend == "actors":
            print(sess.describe())
        out, got, _ = counted_run(cfg, sess, requests, f"paged {backend}")
        st = sess.last_stats
        same = same_tokens(out, ref)
        print(f"paged {backend}: tokens identical to dense: {same}; cache "
              f"bytes {sess.cache_bytes()} paged vs {dense_bytes} dense "
              f"({sess.cache_bytes() / dense_bytes:.4f})")
        if not same:
            raise AssertionError(f"paged {backend} tokens differ from dense")
        if not (0 < st["peak_pages"] <= PAGED["num_pages"]
                and st["shared_pages"] > 0):
            raise AssertionError(f"paged {backend}: peak pages "
                                 f"{st['peak_pages']}, shared pages "
                                 f"{st['shared_pages']}")
        if backend == "actors":
            launches = got
            cache_bound_vs_held(sess, "serve actors paged")
        else:
            profile_device("paged monolithic generate (requests 0-3)",
                           lambda: sess.generate(requests[:4]), cpu=False)
        closed(sess)
    return launches


def serve_chunked(dev, cfg, model):
    """qwen3-1.7b paged with chunked prefill: 4 requests of 24-64 prompt
    tokens (every prompt longer than the chunk) and 8-16 new tokens, on the
    actors and monolithic (the same tokens), then unchunked (fewer
    rounds). Returns the requests and the actors run's launches."""
    phase(f"serve chunked (qwen3-1.7b, paged, prefill_chunk {CHUNK})")
    requests = serve_requests(cfg, 4, SEED + 5, (24, 64), (8, 16))
    outs, stats = {}, {}
    for backend in ("actors", "monolithic"):
        sess = compile_serve(cfg, model, backend, prefill_chunk=CHUNK,
                             **PAGED_GEO, **PAGED)
        outs[backend], got, _ = counted_run(cfg, sess, requests,
                                            f"chunked {backend}")
        stats[backend] = st = sess.last_stats
        if backend == "actors":
            launches = got
        else:
            print(f"chunked monolithic: {st['chunk_tokens']} chunk tokens "
                  f"in {st['chunk_items']} chunks")
        closed(sess)
    same = same_tokens(outs["actors"], outs["monolithic"])
    print(f"chunked: actors and monolithic tokens identical: {same}")
    if not same:
        raise AssertionError("chunked actors and monolithic tokens differ")
    sess = compile_serve(cfg, model, "monolithic", **PAGED_GEO, **PAGED)
    counted_run(cfg, sess, requests, "unchunked monolithic")
    rounds = sess.last_stats["rounds"]
    closed(sess)
    print(f"chunked: {stats['monolithic']['rounds']} rounds, unchunked "
          f"{rounds}")
    if stats["monolithic"]["rounds"] <= rounds:
        raise AssertionError("chunked prefill took no more rounds than "
                             "whole prompts")
    return requests, launches


def serve_sampled(dev, cfg, model, requests):
    """qwen3-1.7b dense, sampled (temperature 0.8, top-k 50, top-p 0.95,
    seed 1): the actors and monolithic give the same tokens, a second
    session with seed 1 repeats them, seed 2 differs somewhere, and
    temperature 0 gives the greedy tokens."""
    from repro_torch.serve import SamplingSpec
    phase("serve sampled (qwen3-1.7b, dense, " + ", ".join(
        f"{k} {v}" for k, v in SAMPLING.items()) + ")")
    spec = SamplingSpec(**SAMPLING)

    def run(backend, what, **kw):
        sess = compile_serve(cfg, model, backend, **PAGED_GEO, **kw)
        out, got, _ = counted_run(cfg, sess, requests, what)
        closed(sess)
        return out, got

    actors, launches = run("actors", "sampled actors", sampling=spec)
    mono, _ = run("monolithic", "sampled monolithic", sampling=spec)
    again, _ = run("monolithic", "sampled monolithic, seed 1 again",
                   sampling=spec)
    other, _ = run("monolithic", "sampled monolithic, seed 2",
                   sampling=SamplingSpec(**dict(SAMPLING, seed=2)))
    greedy, _ = run("monolithic", "greedy monolithic")
    zero, _ = run("monolithic", "temperature 0 monolithic",
                  sampling=SamplingSpec(temperature=0.0, seed=1))
    checks = {"actors == monolithic": same_tokens(actors, mono),
              "seed 1 repeats": same_tokens(again, mono),
              "seed 2 differs": not same_tokens(other, mono),
              "temperature 0 == greedy": same_tokens(zero, greedy)}
    print(f"sampled: {checks}")
    if not all(checks.values()):
        raise AssertionError(f"sampled serving: {checks}")
    return launches


def serve_paged_mamba(dev):
    """mamba2-370m paged: 4 of the serve phase's requests, dense
    monolithic at cache_len 576 and paged on the actors: the same tokens,
    one SSD scan per layer per prefill on the tensor-core kernels (the
    state lives in the row pool, no page slab)."""
    phase("serve paged (mamba2-370m, full width, bf16, page_len 16)")
    cfg, model = seeded_model("mamba2-370m", dev)
    requests = serve_requests(cfg)[:4]
    dense = compile_serve(cfg, model, "monolithic", **PAGED_GEO)
    ref, _, _ = counted_run(cfg, dense, requests, "mamba2 dense monolithic")
    closed(dense)
    sess = compile_serve(cfg, model, "actors", **PAGED_GEO, **PAGED)
    out, launches, _ = counted_run(cfg, sess, requests, "mamba2 paged actors")
    closed(sess)
    same = same_tokens(out, ref)
    print(f"mamba2 paged actors: tokens identical to dense: {same}")
    if not same:
        raise AssertionError("mamba2 paged tokens differ from dense")
    return launches


TRAIN_B, TRAIN_S, TRAIN_STEPS = 2, 2048, 4
# The kernel path's 4 full-width bf16 steps against the same steps through
# the plain versions on the card, relative to the plain path's numbers:
# step 0 sees only the rounding of one forward and backward; from step 1 on,
# AdamW's first update (about lr times the sign of each gradient) turns that
# rounding into different weights, so later steps are held looser. Set at
# about 10x the measured worst: 9.6e-5 at step 0 (grad_norm), 4.3e-4 after.
CURVE_RTOL_FIRST, CURVE_RTOL = 1e-3, 5e-3
# the mesh train phase: qwen3-1.7b at full width and depth on 2 ranks of
# "model" (tp = 2), then data parallelism on (2, 2) at qwen3's widths cut
# to 4 layers (two full-depth replicas would not fit), 2 steps beside a
# 1 x 1 twin of the cut config; the loss curves held at the limits above
MESH_TRAIN, MESH_TRAIN_CUT = (1, 2), (2, 2)
CUT_LAYERS, CUT_STEPS = 4, 2


# the mesh serve phase: qwen3-1.7b on 2 ranks of "model" (tp = 2), its
# cache_len (569 + 9 tokens of headroom, as the 1 x 1 phase) rounded up to
# a multiple of tp, as the reference's api does
MESH_SERVE = (1, 2)
MESH_CACHE_LEN = 570
#: the mesh serve phase runs qwen3-1.7b at full width cut to this depth (of
#: 28 layers): it took 151-200 s of the script's 1,200 at full depth, and
#: the process runtime's phases needed the time; its launch checks follow
#: the cut
MESH_SERVE_LAYERS = 4
# first-token logits of the mesh session against the 1 x 1 session's, bf16:
# each rank's P(sum) branch output is rounded to bf16 before the psum adds
# it, one rounding more per branch than one device's matmul, over 56
# branches; the logits are ~N(0, 1) at the seeded init
MESH_LOGITS_ATOL, MESH_LOGITS_RTOL = 0.25, 0.05


def check_mesh_kernels(dev):
    """The two kernels of the mesh serve path at a rank's shapes: decode on
    the rank-1 shard of qwen3's tp = 2 cache (q (4, 16, 128), shard (4,
    285, 8, 128) bf16 at ``k_offset`` 285, one row wholly masked there),
    with both shards' partials also combined across two virtual ranks of
    the card and held to the plain decode over the whole (4, 570) cache;
    and the attention forward at the local heads of a 512-token prefill
    (q (1, 512, 8, 128), 4 kv heads)."""
    from repro_torch.core.mesh import spmd
    from repro_torch.core.placement import Placement
    from repro_torch.kernels.flash_decode import kernel as fd
    from repro_torch.kernels.flash_decode.ref import (combine_partials,
                                                      flash_decode_partial_ref)
    tp = MESH_SERVE[1]
    B, H, KV, D, L = 4, 16, 8, 128, MESH_CACHE_LEN
    Ll = L // tp
    rng = np.random.default_rng(SEED + 12)
    mk = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.normal(size=shape).astype(np.float32)).to(dev, torch.bfloat16)
    q, k, v = mk(B, H, D), mk(B, L, KV, D), mk(B, L, KV, D)
    cur = torch.tensor([70, 300, 511, L - 1], dtype=torch.int32, device=dev)
    shards = [tuple(t[:, r * Ll:(r + 1) * Ll].contiguous() for t in (k, v))
              for r in range(tp)]
    mesh = Placement(("model",), (tp,)).to_mesh(dev, timeout=60.0)
    outs = spmd(lambda r: combine_partials(*fd.flash_decode(
        q, *shards[r], cur_pos=cur, k_offset=r * Ll), axis_name="model"),
        mesh)(list(range(tp)))
    whole = combine_partials(*(t[None] for t in flash_decode_partial_ref(
        q, k, v, cur_pos=cur)))
    err = agree(f"flash_decode: {tp} shards of cache{tuple(k.shape)} at "
                f"k_offset 0 / {Ll}, combined across {tp} ranks, vs the "
                "plain decode over the whole cache", outs[0], whole,
                ATOL, RTOL)
    if not all(torch.equal(o, outs[0]) for o in outs):
        raise AssertionError("flash_decode: the ranks' combines differ")
    splits = fd.split_plan(B, KV, Ll, fd.sm_count(q.device))
    print(f"flash_decode at the shard: split plan {splits} (cluster "
          f"legal: {1 <= splits <= fd.MAX_SPLITS}), clusters resident at "
          f"once {fd.resident_clusters(q.dtype, D, splits, q.device)}")
    entry = decode_row({
        "name": f"flash_decode (tp={tp} rank-1 shard)", **DECODE_ROW,
        "splits": splits, "k_offset": Ll, "combined_max_abs_err": err},
        q, *shards[1], cur,
        f"flash_decode q{tuple(q.shape)} shard{tuple(shards[1][0].shape)} "
        f"k_offset {Ll} cur_pos {cur.tolist()} (row 0 wholly masked)",
        k_offset=Ll)
    attn = {"name": f"flash_attention (tp={tp} local heads)",
            **ATTENTION_ROW}
    attn.update(attention_row(dev, 1, 512, H // tp, KV // tp, D, SEED + 13))
    return entry, attn


def check_mesh_train_kernels(dev):
    """The kernels of the mesh train path at a rank's shapes on
    ``MESH_TRAIN`` (tp = 2): the attention forward and backward at the
    local heads of a training layer (q (2, 2048, 8, 128), 4 kv heads), and
    the bf16 xent forward and backward on the rank-1 vocab shard (4,096 x
    75,968 at offset 75,968)."""
    from repro_torch.configs.registry import get_config
    cfg = get_config("qwen3-1.7b")
    tp = MESH_TRAIN[1]
    H, KV = cfg.num_heads // tp, cfg.num_kv_heads // tp
    Vl = cfg.padded_vocab() // tp
    fwd = {"name": f"flash_attention (tp={tp} local heads, training)",
           **ATTENTION_ROW}
    fwd.update(attention_row(dev, TRAIN_B, TRAIN_S, H, KV, cfg.head_dim,
                             SEED + 14))
    bwd = check_flash_attention_bwd(
        dev, H=H, KV=KV, seed=SEED + 15,
        name=f"flash_attention_bwd (tp={tp} local heads)")
    xent = check_xent(dev, Vl=Vl, offset=Vl,
                      label=f" (tp={tp} vocab shard, bf16)")
    return fwd, bwd, *xent


def first_token_logits(sess, requests, dev):
    """Each request's first-token logits, float32, through the session's
    stage prefills (on a mesh the last stage assembles the ranks' vocab
    blocks)."""
    out = []
    with torch.inference_mode():
        for toks, _ in requests:
            x = torch.as_tensor(toks[None], dtype=torch.int32, device=dev)
            for st in sess.sstaged.stages:
                x, _ = st.prefill(st.params, x, toks.size - 1)
            out.append(x.float())
    return out


def serve_mesh(dev, cfg):
    """The mesh serve phase: qwen3-1.7b at full width cut to
    MESH_SERVE_LAYERS layers (the port's seeded init of the cut config) on
    ``Placement(("data", "model"), MESH_SERVE)``, 2 virtual ranks of the
    card (heads, MLP units, vocabulary and the KV cache by sequence split
    over them), on the actors (2 stages) and the monolithic engine, the
    serve phase's requests; each run's launches counted (per rank and
    layer one attention forward per prefill, one decode per decode item,
    half of them at each shard's ``k_offset``). Tokens actors ≡
    monolithic; every first-token logit within MESH_LOGITS_* of the 1 x 1
    session's; how many generated tokens match 1 x 1 (no gate: bf16 sums
    split over two ranks round differently). Returns the actor run's
    counts, with ``offsets``."""
    import dataclasses

    from repro_torch.core.placement import Placement
    from repro_torch.kernels.flash_decode import kernel as fd
    from repro_torch.models.common import MeshPlan
    from repro_torch.models.model_zoo import build_model
    from repro_torch.models.transformer import compute_dtype
    placement = Placement(("data", "model"), MESH_SERVE)
    ranks, tp = placement.num_devices, MESH_SERVE[1]
    phase(f"serve on a {MESH_SERVE} mesh ({cfg.name}, full width cut to "
          f"{MESH_SERVE_LAYERS} of its {cfg.num_layers} layers, bf16, "
          f"{ranks} virtual ranks on one card, actors x 2 stages and "
          "monolithic)")
    cfg = dataclasses.replace(cfg, num_layers=MESH_SERVE_LAYERS)
    model = build_model(cfg, MeshPlan.single_device(), seed=SEED,
                        device=dev, dtype=compute_dtype(cfg))
    requests = serve_requests(cfg)
    geo = dict(num_groups=2, group_size=4, max_prompt_len=512,
               max_new_tokens=48)
    L = cfg.num_layers
    runs, logits = {}, {}
    for backend in ("actors", "monolithic"):
        t0 = time.perf_counter()
        sess = compile_serve(cfg, model, backend, mesh=placement,
                             device=dev, **geo)
        torch.cuda.synchronize()
        print(f"{backend}: compiled in {time.perf_counter() - t0:.1f} s "
              f"(cache_len {sess.cache_len}, reserved dense cache "
              f"{sess.cache_bytes() / 2**30:.2f} GiB over the ranks)")
        if sess.cache_len != MESH_CACHE_LEN:
            raise AssertionError(f"cache_len {sess.cache_len}, expected "
                                 f"{MESH_CACHE_LEN} (569 rounded up to tp)")
        if backend == "actors":
            print(sess.describe())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_serve_counts()
        out = sess.generate(requests)
        got = serve_counts()
        offsets = dict(fd.offset_launches)
        peak = torch.cuda.max_memory_allocated()
        st = sess.last_stats
        items = st["decode_items"]
        want = {"flash_attention": ranks * L * st["prefill_items"],
                "flash_fwd_wgmma_kernel": ranks * L * st["prefill_items"],
                "flash_decode": ranks * L * items, "ssd_scan": 0,
                "ssd_scan_wgmma": 0}
        shard = MESH_CACHE_LEN // tp
        want_off = {r * shard: ranks // tp * L * items for r in range(tp)}
        print(f"mesh {backend}: launches {got} at decode offsets {offsets} "
              f"(expected {want} at {want_off}: {ranks} ranks x {L} layers,"
              f" {st['prefill_items']} prefills, {items} decode items)")
        if got != want or offsets != want_off \
                or st["prefill_items"] != len(requests):
            raise AssertionError(f"mesh {backend}: kernel launches {got} "
                                 f"at {offsets}, expected {want} at "
                                 f"{want_off}")
        check_outputs(cfg, out, requests, f"mesh {backend}")
        col = st["collectives"]
        print(f"mesh {backend}: {st['requests']} requests, {st['tokens']} "
              f"tokens in {st['rounds']} rounds, {st['wall_s']:.3f} s wall, "
              f"{st['tok_per_s']:.2f} tok/s, peak memory "
              f"{peak / 2**30:.2f} GiB; collectives "
              f"{sum(col['bytes'].values()) / 2**20:,.1f} MiB (Table 2 "
              f"volume) in {sum(col['calls'].values())} calls "
              f"{col['calls']}, the ranks {col['seconds']:.3f} s in them")
        runs[backend] = (out, got, offsets, st)
        if backend == "monolithic":
            logits["mesh"] = first_token_logits(sess, requests, dev)
            # the idle share from the first 4 requests, the device traced
            # alone: the host's op events of a whole run take minutes to
            # post-process
            profile_device(f"mesh {backend} generate (requests 0-3)",
                           lambda: sess.generate(requests[:4]), cpu=False)
        closed(sess)
    if not same_tokens(runs["actors"][0], runs["monolithic"][0]):
        raise AssertionError("mesh: actors and monolithic tokens differ")
    print("mesh: tokens identical on the actors and the monolithic engine")

    one = compile_serve(cfg, model, "monolithic", cache_len=MESH_CACHE_LEN,
                        device=dev, **geo)
    ref = one.generate(requests)
    logits["one"] = first_token_logits(one, requests, dev)
    print(f"1 x 1 monolithic at cache_len {MESH_CACHE_LEN}: "
          f"{one.last_stats['tok_per_s']:.2f} tok/s")
    closed(one)
    worst, worst_rel = 0.0, 0.0
    for i, (a, b) in enumerate(zip(logits["mesh"], logits["one"])):
        diff = (a - b).abs()
        worst = max(worst, diff.max().item())
        worst_rel = max(worst_rel, (torch.linalg.vector_norm(a - b)
                                    / torch.linalg.vector_norm(b)).item())
        if not torch.allclose(a, b, atol=MESH_LOGITS_ATOL,
                              rtol=MESH_LOGITS_RTOL):
            raise AssertionError(
                f"mesh request {i}: first-token logits max abs err "
                f"{diff.max().item():.3e} past atol {MESH_LOGITS_ATOL} + "
                f"rtol {MESH_LOGITS_RTOL} of the 1 x 1 session's")
    same = sum(int((np.asarray(a) == np.asarray(b)).sum())
               for a, b in zip(runs["actors"][0], ref))
    total = sum(len(b) for b in ref)
    whole = sum(np.array_equal(a, b) for a, b in zip(runs["actors"][0], ref))
    print(f"mesh vs 1 x 1: first-token logits max abs err {worst:.3e}, "
          f"worst relative norm error {worst_rel:.3e} (limit atol "
          f"{MESH_LOGITS_ATOL} + rtol {MESH_LOGITS_RTOL}); generated tokens "
          f"equal at {same} of {total} positions, {whole} of "
          f"{len(ref)} requests whole (not a gate)")
    counts = dict(runs["actors"][1])
    counts["offsets"] = runs["actors"][2]
    del model
    return counts


@contextlib.contextmanager
def plain_versions():
    """The model's kernel call sites (attention, decode, and the loss's
    local stats) take the plain PyTorch versions on the card while the
    block runs: the reference the kernel path's training curve and the
    classic loop's logits are held to."""
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_decode.ref import flash_decode_partial_ref
    from repro_torch.kernels.softmax_xent.ref import local_stats_ref
    from repro_torch.models import attention, transformer
    saved = (attention.flash_attention, attention.flash_decode,
             transformer.xent_local_stats)
    attention.flash_attention = fa.plain_flash_attention
    attention.flash_decode = flash_decode_partial_ref
    transformer.xent_local_stats = local_stats_ref
    try:
        yield
    finally:
        (attention.flash_attention, attention.flash_decode,
         transformer.xent_local_stats) = saved


def train_counts():
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.softmax_xent import kernel as xk
    from repro_torch.kernels.ssd_scan import kernel as ssd
    return {"flash_attention": fa.launches,
            "flash_bwd_dq_kernel": fa.bwd_dq_launches,
            "flash_bwd_dkdv_kernel": fa.bwd_dkdv_launches,
            "flash_fwd_wgmma_kernel": fa.wgmma_launches,
            "flash_bwd_dq_wgmma_kernel": fa.bwd_dq_wgmma_launches,
            "flash_bwd_dkdv_wgmma_kernel": fa.bwd_dkdv_wgmma_launches,
            "xent_local_stats": xk.launches,
            "xent_local_stats_bwd": xk.bwd_launches,
            "ssd_scan": ssd.launches, "ssd_scan_wgmma": ssd.wgmma_launches,
            **ssd.bwd_launches,
            "ssd_scan_bwd_wgmma": ssd.bwd_wgmma_launches}


def zero_train_counts():
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.softmax_xent import kernel as xk
    from repro_torch.kernels.ssd_scan import kernel as ssd
    fa.launches = fa.bwd_dq_launches = fa.bwd_dkdv_launches = 0
    fa.wgmma_launches = fa.bwd_dq_wgmma_launches = 0
    fa.bwd_dkdv_wgmma_launches = 0
    xk.reset_counts()
    ssd.reset_counts()


def xent_offsets():
    """The xent launches by vocab offset, forward and backward."""
    from repro_torch.kernels.softmax_xent import kernel as xk
    return dict(xk.offset_launches), dict(xk.bwd_offset_launches)


def train_steps(dev, what: str, want: dict, cfg=None, shape=(1, 1),
                steps: int = TRAIN_STEPS, falls: bool = True,
                want_offsets=None, zero: bool = False, aux: bool = False):
    """``cfg`` (default qwen3-1.7b at full width and depth) through
    make_train_step on the ``("data", "model")`` mesh ``shape`` (1 x 1: one
    device) from the seeded init, fed by the actor data pipeline, ``steps``
    steps with the kernels' launches counted on every step and held to
    ``want``; on a mesh also the xent launches by vocab offset, held to
    ``want_offsets``, and the collectives' calls, bytes and the seconds the
    ranks waited in them. ``zero``: the ZeRO step (float32 master rows and
    moments sharded over ``data``), else the plain one. ``falls``: the
    loss must fall over the run; ``aux``: every step's ``aux_loss`` (the
    routers' load-balance loss) must be above 0. Returns (step, params, opt
    state, source, [(loss, grad_norm)], total launches with the xent
    ``offsets``)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import ActorDataPipeline, SyntheticLM
    from repro_torch.models.common import MeshPlan
    from repro_torch.train.steps import make_train_step

    cfg = cfg or get_config("qwen3-1.7b")
    B, S = TRAIN_B, TRAIN_S
    t0 = time.perf_counter()
    ts = make_train_step(cfg, MeshPlan(("data", "model"), shape), zero=zero,
                         device=dev)
    params = ts.init_params(SEED)
    opt = ts.init_opt(params)
    torch.cuda.synchronize()
    mesh = ts.mesh
    n_params = params.numel() if mesh else sum(
        p.numel() for p in params.parameters())
    print(f"{what}: params and AdamW state initialised in "
          f"{time.perf_counter() - t0:.1f} s: {n_params:,} "
          + ("float32 master elements (padding included)" if zero
             else "params")
          + (f" over the {mesh.size} ranks of {mesh}" if mesh else ""))
    src = SyntheticLM(cfg.vocab_size, B, S, seed=SEED)
    pipe = ActorDataPipeline(src, num_batches=steps)
    curve = []
    torch.cuda.reset_peak_memory_stats()
    zero_train_counts()
    prev, prev_off = train_counts(), xent_offsets()
    for step, tokens in enumerate(pipe):
        if mesh:
            mesh.stats.reset()
        t = time.perf_counter()
        params, opt, m = ts.step_fn(params, opt, {"tokens": tokens})
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        aux_loss = float(m["aux_loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        now, off = train_counts(), xent_offsets()
        per = {k: now[k] - prev[k] for k in now}
        per_off = [{o: n - p.get(o, 0) for o, n in a.items()}
                   for a, p in zip(off, prev_off)]
        prev, prev_off = now, off
        curve.append((loss, gnorm))
        col = ""
        if mesh:
            st = mesh.stats
            col = (f"; xent launches by offset {per_off[0]} forward, "
                   f"{per_off[1]} backward; collectives {st.calls} calls, "
                   f"{st.total_bytes() / 2**20:,.1f} MiB {st.bytes}, the "
                   f"ranks {st.wait_s:.3f} s in them")
        print(f"{what} step {step}: loss {loss:.4f}, grad_norm {gnorm:.4f}, "
              + (f"aux_loss {aux_loss:.4f}, " if aux else "")
              + f"wall {wall:.3f} s, {B * S / wall:,.0f} tokens/s, launches "
              f"{per}{col}")
        if aux and not aux_loss > 0:
            raise AssertionError(f"{what} step {step}: aux_loss {aux_loss}")
        if per != want:
            raise AssertionError(f"{what} step {step}: kernel launches {per},"
                                 f" expected {want}")
        if want_offsets is not None and per_off != [want_offsets] * 2:
            raise AssertionError(f"{what} step {step}: xent launches by "
                                 f"offset {per_off}, expected "
                                 f"{want_offsets} each way")
    total = train_counts()
    total["offsets"] = xent_offsets()
    print(f"{what}: launches over the {steps} steps: {total}; peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    losses = [c[0] for c in curve]
    if not all(np.isfinite(curve).ravel()) or (
            falls and not losses[-1] < losses[0]):
        raise AssertionError(f"{what}: (loss, grad_norm) {curve}: not "
                             "finite, or the loss did not fall")
    return ts, params, opt, src, curve, total


def train(dev):
    """The main path of training: full-width, full-depth qwen3-1.7b through
    make_train_step, fed by the actor data pipeline, with the kernels'
    launches counted on every step, then one profiled step. Returns the
    run's launch counts and its (loss, grad_norm) curve."""
    phase(f"train (qwen3-1.7b, full width and depth, bf16 compute, float32 "
          f"params and AdamW, {TRAIN_STEPS} steps)")
    from repro_torch.configs.registry import get_config
    want, _ = train_want(get_config("qwen3-1.7b"), 1, 1)
    ts, params, opt, src, curve, total = train_steps(dev, "kernels", want)
    batch = {"tokens": src(TRAIN_STEPS)}
    profile_device("train step", lambda: float(
        ts.step_fn(params, opt, batch)[2]["loss"]), top=10)
    return total, curve


def train_plain(dev, kernel_curve):
    """The same steps, from the same init and batches, with the model's call
    sites on the plain versions (autograd through them) on the card; the
    kernel path's loss and grad_norm are held to them step by step."""
    phase(f"train, plain versions (qwen3-1.7b, full width and depth, bf16, "
          f"the same {TRAIN_STEPS} steps)")
    with plain_versions():
        *_, curve, _ = train_steps(dev, "plain", {
            k: 0 for k in train_counts()})
    worst = [0.0, 0.0]
    for step, (got, want) in enumerate(zip(kernel_curve, curve)):
        errs = [abs(g - w) / abs(w) for g, w in zip(got, want)]
        limit = CURVE_RTOL_FIRST if step == 0 else CURVE_RTOL
        print(f"step {step}: kernels (loss, grad_norm) {got}, plain {want}: "
              f"relative err {errs[0]:.3e}, {errs[1]:.3e} (limit {limit})")
        worst = [max(a, b) for a, b in zip(worst, errs)]
        if max(errs) > limit:
            raise AssertionError(f"step {step}: the kernel path's training "
                                 "curve left the plain path's")
    print(f"kernel path vs plain path over {TRAIN_STEPS} steps: max relative "
          f"err loss {worst[0]:.3e}, grad_norm {worst[1]:.3e}")


def train_want(cfg, ranks: int, tp: int):
    """A train step's launches on ``ranks`` ranks, ``tp`` over ``model``:
    per rank, each layer's attention forward and its remat recompute, each
    backward kernel once a layer, and one loss (the xent kernels on the
    rank's vocab shard), every attention launch on the tensor-core
    kernels; the xent launches by vocab offset, each shard's ``ranks /
    tp`` a step."""
    L = cfg.num_layers
    want = dict.fromkeys(train_counts(), 0)
    want.update({"flash_attention": 2 * L * ranks,
                 "flash_bwd_dq_kernel": L * ranks,
                 "flash_bwd_dkdv_kernel": L * ranks,
                 "flash_fwd_wgmma_kernel": 2 * L * ranks,
                 "flash_bwd_dq_wgmma_kernel": L * ranks,
                 "flash_bwd_dkdv_wgmma_kernel": L * ranks,
                 "xent_local_stats": ranks, "xent_local_stats_bwd": ranks})
    Vl = cfg.padded_vocab() // tp
    return want, {m * Vl: ranks // tp for m in range(tp)}


def held_curves(what: str, got, want):
    """``got``'s (loss, grad_norm) steps against ``want``'s: the loss at
    CURVE_RTOL_FIRST on step 0 and CURVE_RTOL after; grad_norm printed."""
    for step, ((lg, gg), (lw, gw)) in enumerate(zip(got, want)):
        err, gerr = abs(lg - lw) / abs(lw), abs(gg - gw) / abs(gw)
        limit = CURVE_RTOL_FIRST if step == 0 else CURVE_RTOL
        print(f"{what} step {step}: (loss, grad_norm) {(lg, gg)} vs "
              f"{(lw, gw)}: relative err loss {err:.3e} (limit {limit}), "
              f"grad_norm {gerr:.3e} (not held)")
        if err > limit:
            raise AssertionError(f"{what} step {step}: loss {lg} left "
                                 f"{lw}")


def train_mesh(dev, curve):
    """Training on a mesh of ranks: qwen3-1.7b at full width and depth on
    ``MESH_TRAIN`` (2 virtual ranks of the card, heads, MLP units and the
    vocabulary split over ``model``), the train phase's steps and batches,
    held to its 1 x 1 ``curve``; then ``MESH_TRAIN_CUT`` at qwen3's widths
    cut to ``CUT_LAYERS`` layers, held to a 1 x 1 twin. Launches counted on
    every step. Returns the full-depth run's launch counts."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    cfg = get_config("qwen3-1.7b")
    ranks, tp = int(np.prod(MESH_TRAIN)), MESH_TRAIN[1]
    phase(f"train on a {MESH_TRAIN} mesh ({cfg.name}, full width and depth, "
          f"{ranks} virtual ranks on one card, bf16 compute, float32 params "
          f"and AdamW, {TRAIN_STEPS} steps); then {MESH_TRAIN_CUT} at "
          f"{CUT_LAYERS} of its {cfg.num_layers} layers (cut: two "
          f"full-depth replicas would not fit), {CUT_STEPS} steps beside "
          "its 1 x 1 twin")
    want, offsets = train_want(cfg, ranks, tp)
    ts, params, opt, src, got, total = train_steps(
        dev, f"mesh {MESH_TRAIN}", want, shape=MESH_TRAIN,
        want_offsets=offsets)
    held_curves(f"mesh {MESH_TRAIN} vs 1 x 1", got, curve)
    batch = {"tokens": src(TRAIN_STEPS)}
    profile_device(f"mesh {MESH_TRAIN} train step", lambda: float(
        ts.step_fn(params, opt, batch)[2]["loss"]), top=10)
    del ts, params, opt
    gc.collect()
    torch.cuda.empty_cache()

    cut = dataclasses.replace(cfg, num_layers=CUT_LAYERS)
    runs = {}
    for shape in (MESH_TRAIN_CUT, (1, 1)):
        n = int(np.prod(shape))
        w, off = train_want(cut, n, shape[1])
        *_, runs[shape], _ = train_steps(
            dev, f"{CUT_LAYERS} layers on {shape}", w, cfg=cut, shape=shape,
            steps=CUT_STEPS, falls=False,
            want_offsets=off if n > 1 else None)
        gc.collect()
        torch.cuda.empty_cache()
    held_curves(f"{CUT_LAYERS} layers, {MESH_TRAIN_CUT} vs 1 x 1",
                runs[MESH_TRAIN_CUT], runs[(1, 1)])
    return total, runs[MESH_TRAIN_CUT]


# phase 7b: ZeRO on a (2, 1) mesh at full width and depth (each rank holds
# half of every leaf's float32 master rows and moments; two plain replicas
# of params and moments alone would be 48.8 GB), then ZeRO on the (2, 2)
# cut of phase 7, held to its plain run at the same limits
ZERO_TRAIN = (2, 1)


def check_zero_train_kernels(dev):
    """The kernels of the ZeRO (2, 1) train path at a rank's shapes: one
    row of 2,048 tokens a rank, all 16 q and 8 kv heads -- the attention
    forward and backward at q (1, 2048, 16, 128) and the bf16 xent forward
    and backward at (2,048 x 151,936), offset 0."""
    from repro_torch.configs.registry import get_config
    cfg = get_config("qwen3-1.7b")
    B_l = TRAIN_B // ZERO_TRAIN[0]
    fwd = {"name": "flash_attention (zero (2, 1) rank, training)",
           **ATTENTION_ROW}
    fwd.update(attention_row(dev, B_l, TRAIN_S, cfg.num_heads,
                             cfg.num_kv_heads, cfg.head_dim, SEED + 16))
    bwd = check_flash_attention_bwd(
        dev, seed=SEED + 17, B=B_l,
        name="flash_attention_bwd (zero (2, 1) rank)")
    xent = check_xent(dev, N=B_l * TRAIN_S,
                      label=" (zero (2, 1) rank, bf16)")
    return fwd, bwd, *xent


def train_zero(dev, curve, cut_curve):
    """Phase 7b: qwen3-1.7b at full width and depth with
    ``make_train_step(zero=True)`` on ``ZERO_TRAIN`` (2 virtual ranks of
    the card over ``data``, one row each), the train phase's init,
    batches and steps, held to its 1 x 1 ``curve``; each rank's held
    masters and moments beside two plain replicas'; one profiled step.
    Then ZeRO on ``MESH_TRAIN_CUT`` at ``CUT_LAYERS`` layers held to phase
    7's plain run there (``cut_curve``). Launches counted on every step.
    Returns the full-depth run's launch counts."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    cfg = get_config("qwen3-1.7b")
    ranks = int(np.prod(ZERO_TRAIN))
    phase(f"train with ZeRO on a {ZERO_TRAIN} mesh ({cfg.name}, full width "
          f"and depth, {ranks} virtual ranks on one card, float32 master "
          f"rows and moments sharded over data, bf16 gathers, "
          f"{TRAIN_STEPS} steps); then ZeRO on {MESH_TRAIN_CUT} at "
          f"{CUT_LAYERS} layers, {CUT_STEPS} steps beside phase 7's plain run")
    want, offsets = train_want(cfg, ranks, ZERO_TRAIN[1])
    ts, params, opt, src, got, total = train_steps(
        dev, f"zero {ZERO_TRAIN}", want, shape=ZERO_TRAIN,
        want_offsets=offsets, zero=True)
    held_curves(f"zero {ZERO_TRAIN} vs 1 x 1", got, curve)
    n = sum(int(np.prod(s)) for s in params.shapes.values())
    held = [nbytes(*mine.values(), *st.mu.values(), *st.nu.values())
            for mine, st in zip(params.ranks, opt)]
    print(f"zero {ZERO_TRAIN}: each rank holds "
          f"{[round(b / 1e9, 3) for b in held]} GB of float32 master rows "
          f"and moments (12 B x {n:,} params / {ranks} = "
          f"{12 * n / ranks / 1e9:.2f} GB); two plain replicas would hold "
          f"{2 * 12 * n / 1e9:.2f} GB of params and moments, "
          f"{2 * 16 * n / 1e9:.2f} GB with their float32 gradients")
    batch = {"tokens": src(TRAIN_STEPS)}
    profile_device(f"zero {ZERO_TRAIN} train step", lambda: float(
        ts.step_fn(params, opt, batch)[2]["loss"]), top=10)
    del ts, params, opt
    gc.collect()
    torch.cuda.empty_cache()

    cut = dataclasses.replace(cfg, num_layers=CUT_LAYERS)
    w, off = train_want(cut, int(np.prod(MESH_TRAIN_CUT)), MESH_TRAIN_CUT[1])
    *_, zc, _ = train_steps(
        dev, f"zero {CUT_LAYERS} layers on {MESH_TRAIN_CUT}", w, cfg=cut,
        shape=MESH_TRAIN_CUT, steps=CUT_STEPS, falls=False,
        want_offsets=off, zero=True)
    held_curves(f"{CUT_LAYERS} layers on {MESH_TRAIN_CUT}, zero vs plain",
                zc, cut_curve)
    gc.collect()
    torch.cuda.empty_cache()
    return total


# deepseek-v2-lite-16b trained at full width, cut to 4 layers (the dense
# one and 3 MLA + MoE): its 15.7 B params need 234 GiB at 16 bytes a
# parameter, 4 layers 2,254,979,072 params, 33.6 GiB; then the same model's
# first steps on the plain versions
DEEPSEEK_TRAIN_LAYERS, DEEPSEEK_PLAIN_STEPS = 4, 2


def train_deepseek(dev):
    """deepseek-v2-lite-16b at full width cut to ``DEEPSEEK_TRAIN_LAYERS``
    layers through ``make_train_step`` (ZeRO at 1 x 1, the default: bf16
    compute over float32 masters and moments, remat), ``TRAIN_STEPS``
    steps of ``TRAIN_B x TRAIN_S`` ``SyntheticLM`` tokens: every step's
    launches held (each layer's attention forward and its remat rerun at
    (192, 128) on the tensor cores, dq and dk/dv once a layer, the xent
    kernels once each way), finite losses and ``aux_loss`` above 0, wall,
    tokens/s and peak memory, one profiled step. Then the same init and
    batches through the plain versions for ``DEEPSEEK_PLAIN_STEPS`` steps:
    step 0's loss within ``CURVE_RTOL_FIRST``, the later steps' difference
    printed (a top-k pick that flips on a bf16 rounding moves it). Returns
    the kernel run's launch counts."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    cfg = dataclasses.replace(get_config(DEEPSEEK),
                              num_layers=DEEPSEEK_TRAIN_LAYERS)
    phase(f"train {DEEPSEEK} (full width, {DEEPSEEK_TRAIN_LAYERS} of its 27 "
          f"layers, {cfg.param_count():,} params; ZeRO 1 x 1, bf16 compute, "
          f"float32 masters and moments, {TRAIN_STEPS} steps), then "
          f"{DEEPSEEK_PLAIN_STEPS} steps on the plain versions")
    want, _ = train_want(cfg, 1, 1)
    print(f"{DEEPSEEK}: expected launches a step {want}")
    ts, params, opt, src, curve, total = train_steps(
        dev, f"{DEEPSEEK} kernels", want, cfg=cfg, falls=False, zero=True,
        aux=True)
    batch = {"tokens": src(TRAIN_STEPS)}
    profile_device(f"{DEEPSEEK} train step", lambda: float(
        ts.step_fn(params, opt, batch)[2]["loss"]), top=10)
    del ts, params, opt
    gc.collect()
    torch.cuda.empty_cache()
    with plain_versions():
        *_, plain, _ = train_steps(
            dev, f"{DEEPSEEK} plain", dict.fromkeys(train_counts(), 0),
            cfg=cfg, steps=DEEPSEEK_PLAIN_STEPS, falls=False, zero=True,
            aux=True)
    gc.collect()
    torch.cuda.empty_cache()
    for step, ((lk, gk), (lp, gp)) in enumerate(zip(curve, plain)):
        err, gerr = abs(lk - lp) / abs(lp), abs(gk - gp) / abs(gp)
        print(f"{DEEPSEEK} step {step}: kernels (loss, grad_norm) "
              f"{(lk, gk)}, plain {(lp, gp)}: relative err loss {err:.3e}"
              + (f" (limit {CURVE_RTOL_FIRST})" if step == 0
                 else " (not held)") + f", grad_norm {gerr:.3e} (not held)")
        if step == 0 and err > CURVE_RTOL_FIRST:
            raise AssertionError(f"{DEEPSEEK} step 0: the kernel path's loss "
                                 f"{lk} left the plain path's {lp}")
    return total


# the Mamba-2 phases: mamba2-370m trained on one device; then served and
# trained on 2 ranks of "model" (tp = 2, each rank 16 of the 32 heads)
MAMBA = "mamba2-370m"
MAMBA_MESH, MAMBA_MESH_STEPS = (1, 2), 2
# a float32 train step on the card against the CPU's plain path: the same
# arithmetic summed in other orders (the reduced qwen3 check's limit)
REF_TRAIN_RTOL = 1e-4


def mamba_train_want(cfg, ranks: int, tp: int, tc: bool = True):
    """A train step's launches of an SSM stack on ``ranks`` ranks, ``tp``
    over ``model``: per rank and layer the SSD forward twice (the forward
    and its remat rerun inside the backward, both through ``SsdScan``) and
    each backward kernel of the route once -- for bf16 (``tc``) the
    tensor-core forward and ``BWD_TC_KERNELS``, for float32 the CUDA-core
    forward and ``BWD_KERNELS``, none of the other route's; one loss (the
    xent kernels on the rank's vocab shard); no attention. Also the xent
    launches by vocab offset, each shard's ``ranks / tp``."""
    from repro_torch.kernels.ssd_scan import kernel as ssd
    L = cfg.num_layers
    want = dict.fromkeys(train_counts(), 0)
    want.update({"ssd_scan": 2 * L * ranks,
                 "ssd_scan_wgmma": 2 * L * ranks if tc else 0,
                 "ssd_scan_bwd_wgmma": L * ranks if tc else 0,
                 "xent_local_stats": ranks, "xent_local_stats_bwd": ranks,
                 **dict.fromkeys(ssd.BWD_TC_KERNELS if tc
                                 else ssd.BWD_KERNELS, L * ranks)})
    Vl = cfg.padded_vocab() // tp
    return want, {m * Vl: ranks // tp for m in range(tp)}


def check_reference_mamba_train(dev, shape=(1, 1), steps: int = 2):
    """``steps`` ZeRO train steps (the default) of reduced mamba2 (float32)
    on the ``("data", "model")`` mesh ``shape`` on the card -- the SSD
    forward on its CUDA-core kernel, the backward kernels, on a mesh each
    rank's shards and the ``model`` sums of the replicated leaves --
    against the same steps on the CPU's plain path, from the same initial
    weights and batches: each step's loss and grad_norm within
    REF_TRAIN_RTOL (a step's loss after the first also reads the update
    the previous step's gradients made)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.common import MeshPlan
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train.steps import make_train_step

    ranks, tp = int(np.prod(shape)), shape[1]
    phase(f"reference train (reduced mamba2 on {shape}, card vs CPU plain "
          f"path, {steps} steps)")
    cfg = get_config(MAMBA).reduced()
    # SyntheticLM draws from one stream: make the batches once, for both
    src = SyntheticLM(cfg.vocab_size, 2, 64, seed=SEED + 20)
    batches = [{"tokens": src(step)} for step in range(steps)]
    state = build_model(cfg, MeshPlan.single_device(), seed=SEED,
                        device="cpu").state_dict()
    runs, counts = {}, {}
    for d in ("cpu", dev):
        zero_train_counts()
        ts = make_train_step(cfg, MeshPlan(("data", "model"), shape),
                             device=d)
        params = ts.shard_params_fn(state)
        opt = ts.init_opt(params)
        runs[d] = []
        for batch in batches:
            params, opt, m = ts.step_fn(params, opt, batch)
            runs[d].append((float(m["loss"]), float(m["grad_norm"])))
        counts[d] = train_counts()
    step_want = mamba_train_want(cfg, ranks, tp, tc=False)[0]
    want = {"cpu": dict.fromkeys(counts["cpu"], 0),
            dev: {k: steps * n for k, n in step_want.items()}}
    print(f"reduced mamba2 float32 on {shape}: launches on the card "
          f"{counts[dev]} (expected {want[dev]}: {steps} steps x {ranks} "
          "ranks, float32 forwards on the CUDA-core kernel), on the CPU "
          "none")
    if counts != want:
        raise AssertionError(f"reduced mamba2 train on {shape}: launches "
                             f"{counts}, expected {want}")
    err = max(abs(a - b) / abs(b) for got, ref in zip(runs[dev], runs["cpu"])
              for a, b in zip(got, ref))
    print(f"reduced mamba2 on {shape}, {steps} train steps: card (loss, "
          f"grad_norm) {runs[dev]}, CPU {runs['cpu']}; max relative err "
          f"{err:.3e} (bound {REF_TRAIN_RTOL}, float32)")
    if not err <= REF_TRAIN_RTOL:
        raise AssertionError(f"reduced mamba2 train on {shape}: card "
                             f"{runs[dev]} vs CPU {runs['cpu']}")


def train_mamba(dev):
    """mamba2-370m at full width and depth (48 SSM layers, d_model 1024,
    bf16 compute) through ``make_train_step`` with ZeRO's float32 master
    rows and moments (the default), TRAIN_STEPS steps of TRAIN_B x TRAIN_S
    ``SyntheticLM`` tokens from the seeded init, the launches of every step
    held to ``mamba_train_want`` (the loss's trend is not gated: the seeded
    init's early steps need not fall), then one profiled step. Returns the
    run's launch counts."""
    from repro_torch.configs.registry import get_config
    cfg = get_config(MAMBA)
    phase(f"train ({MAMBA}, full width and depth, bf16 compute, ZeRO's "
          f"float32 master rows and moments, {TRAIN_STEPS} steps of "
          f"{TRAIN_B} x {TRAIN_S} tokens)")
    want, _ = mamba_train_want(cfg, 1, 1)
    ts, params, opt, src, curve, total = train_steps(
        dev, MAMBA, want, cfg=cfg, zero=True, falls=False)
    print(f"{MAMBA}: losses {[round(c[0], 4) for c in curve]}; SSD launches "
          f"a step: {2 * cfg.num_layers} forward ({cfg.num_layers} layers x "
          f"the forward and its remat rerun), {cfg.num_layers} of each "
          "bf16 backward kernel (tensor-core state and chunk, carry, "
          "reduce)")
    batch = {"tokens": src(TRAIN_STEPS)}
    profile_device(f"{MAMBA} train step", lambda: float(
        ts.step_fn(params, opt, batch)[2]["loss"]), top=10)
    del ts, params, opt
    gc.collect()
    torch.cuda.empty_cache()
    return total


@contextlib.contextmanager
def ssd_heads_seen():
    """The heads of every SSD scan call the model makes while the block
    runs (a list, filled in call order)."""
    from repro_torch.models import mamba
    seen, scan = [], mamba.ssd_scan

    def spy(x, *args, **kw):
        seen.append(x.shape[2])
        return scan(x, *args, **kw)
    mamba.ssd_scan = spy
    try:
        yield seen
    finally:
        mamba.ssd_scan = scan


def serve_mesh_mamba(dev):
    """mamba2-370m at full width and depth on ``MAMBA_MESH`` (2 virtual
    ranks of the card, 16 SSM heads a rank, the vocabulary split), 4
    requests of 64-256 prompt and 8-16 new tokens on the actors and the
    monolithic engine: tokens identical, one SSD scan per rank, layer and
    prefill on the tensor-core kernels at 16 heads. Then reduced mamba2
    (float32) on the same mesh on the card and on the CPU: the same tokens.
    Returns the actor run's launch counts."""
    from repro_torch import api
    from repro_torch.configs.registry import get_config
    from repro_torch.core.placement import Placement
    from repro_torch.models.common import MeshPlan
    from repro_torch.models.model_zoo import build_model
    placement = Placement(("data", "model"), MAMBA_MESH)
    ranks, tp = placement.num_devices, MAMBA_MESH[1]
    phase(f"serve on a {MAMBA_MESH} mesh ({MAMBA}, full width and depth, "
          f"bf16, {ranks} virtual ranks on one card, actors x 2 stages and "
          "monolithic)")
    cfg, model = seeded_model(MAMBA, dev)
    requests = serve_requests(cfg, 4, SEED + 21, (64, 256), (8, 16))
    geo = dict(num_groups=2, group_size=2, max_prompt_len=256,
               max_new_tokens=16)
    L, heads = cfg.num_layers, cfg.ssm_heads // tp
    runs = {}
    for backend in ("actors", "monolithic"):
        sess = compile_serve(cfg, model, backend, mesh=placement,
                             device=dev, **geo)
        if backend == "actors":
            print(sess.describe())
        torch.cuda.synchronize()
        zero_serve_counts()
        with ssd_heads_seen() as seen:
            out = sess.generate(requests)
        got, st = serve_counts(), sess.last_stats
        n = ranks * L * st["prefill_items"]
        want = {"flash_attention": 0, "flash_fwd_wgmma_kernel": 0,
                "flash_decode": 0, "ssd_scan": n, "ssd_scan_wgmma": n}
        print(f"mamba2 mesh {backend}: launches {got} (expected {want}: "
              f"{ranks} ranks x {L} layers, {st['prefill_items']} "
              f"prefills); SSD scans at {sorted(set(seen))} heads "
              f"(expected [{heads}])")
        if got != want or seen != [heads] * n:
            raise AssertionError(f"mamba2 mesh {backend}: launches {got}, "
                                 f"heads {sorted(set(seen))}")
        check_outputs(cfg, out, requests, f"mamba2 mesh {backend}")
        col = st["collectives"]
        print(f"mamba2 mesh {backend}: {st['tokens']} tokens in "
              f"{st['rounds']} rounds, {st['wall_s']:.3f} s wall, "
              f"{st['tok_per_s']:.2f} tok/s; collectives "
              f"{sum(col['calls'].values())} calls {col['calls']}, the "
              f"ranks {col['seconds']:.3f} s in them")
        runs[backend] = (out, got)
        closed(sess)
    if not same_tokens(runs["actors"][0], runs["monolithic"][0]):
        raise AssertionError("mamba2 mesh: actors and monolithic differ")
    print("mamba2 mesh: tokens identical on the actors and the monolithic "
          "engine")
    del model
    gc.collect()
    torch.cuda.empty_cache()

    red = get_config(MAMBA).reduced()
    rng = np.random.default_rng(SEED + 22)
    reqs = [(rng.integers(0, red.vocab_size, (k,)).astype(np.int32), g)
            for k, g in ((37, 6), (100, 3), (5, 8), (64, 4))]
    state = build_model(red, MeshPlan.single_device(), seed=SEED,
                        device="cpu").state_dict()
    outs = {}
    for d in ("cpu", dev):
        with api.compile(red, mode="serve", backend="monolithic",
                         params=state, mesh=placement, device=d,
                         num_groups=2, group_size=1, max_prompt_len=128,
                         max_new_tokens=8) as sess:
            outs[d] = sess.generate(reqs)
    same = same_tokens(outs["cpu"], outs[dev])
    print(f"reduced mamba2 float32 on {MAMBA_MESH}: card tokens identical "
          f"to the CPU's: {same}")
    if not same:
        raise AssertionError(f"reduced mamba2 on {MAMBA_MESH}: card "
                             f"{outs[dev]} vs CPU {outs['cpu']}")
    return runs["actors"][1]


def train_mesh_mamba(dev):
    """mamba2-370m at full width and depth on ``MAMBA_MESH`` with ZeRO (the
    default; dp = 1, so each rank keeps its shards' whole master rows),
    MAMBA_MESH_STEPS steps of the train phase's batches: losses and each
    step's time printed, every step's launches held to 2 ranks' (each
    rank's backward kernels once a layer at its 16 heads). Returns the
    run's launch counts."""
    from repro_torch.configs.registry import get_config
    cfg = get_config(MAMBA)
    ranks, tp = int(np.prod(MAMBA_MESH)), MAMBA_MESH[1]
    phase(f"train on a {MAMBA_MESH} mesh ({MAMBA}, full width and depth, "
          f"{ranks} virtual ranks on one card, ZeRO, bf16 compute, "
          f"{MAMBA_MESH_STEPS} steps)")
    want, offsets = mamba_train_want(cfg, ranks, tp)
    with ssd_heads_seen() as seen:
        *_, curve, total = train_steps(
            dev, f"{MAMBA} zero {MAMBA_MESH}", want, cfg=cfg,
            shape=MAMBA_MESH, steps=MAMBA_MESH_STEPS, falls=False,
            want_offsets=offsets, zero=True)
    heads = cfg.ssm_heads // tp
    print(f"{MAMBA} on {MAMBA_MESH}: losses {[round(c[0], 4) for c in curve]};"
          f" each backward kernel {cfg.num_layers} launches a rank a step; "
          f"SSD scans at {sorted(set(seen))} heads (expected [{heads}])")
    if set(seen) != {heads}:
        raise AssertionError(f"mamba2 mesh train: SSD scans at "
                             f"{sorted(set(seen))} heads")
    gc.collect()
    torch.cuda.empty_cache()
    return total


GRAPH_N, GRAPH_V, GRAPH_D, GRAPH_F, GRAPH_BLOCKS = 4096, 151936, 2048, 6144, 4
GRAPH_M, GRAPH_STAGES, GRAPH_STEPS = 8, 4, 3


def xent_counts():
    from repro_torch.kernels.softmax_xent import kernel as xk
    return {"xent_local_stats": xk.launches,
            "xent_local_stats_bwd": xk.bwd_launches}


def zero_xent_counts():
    from repro_torch.kernels.softmax_xent import kernel as xk
    xk.reset_counts()


def check_xent_graph(dev, N=GRAPH_N // GRAPH_M, V=GRAPH_V, offset=0,
                     label="graph", dtype="float32"):
    """The xent forward and backward kernels at a graph path's shape
    against the plain version: one microbatch's logits of the qwen3-width
    graph (512 x 151,936; float32, or bf16 as the mixed-precision phase
    gives them), or one rank's vocab shard of the mesh phase (``N`` x
    ``V`` at ``offset``, labels over the two shards)."""
    from repro_torch.kernels.softmax_xent import kernel as xk
    from repro_torch.kernels.softmax_xent.ref import local_stats_ref
    rng = np.random.default_rng(SEED + 7)
    logits = (torch.from_numpy(
        rng.standard_normal((N, V), dtype=np.float32)).to(dev) * 3).to(
        getattr(torch, dtype))
    labels = torch.as_tensor(rng.integers(0, offset + V, N),
                             dtype=torch.int32, device=dev)
    ds = torch.as_tensor(rng.normal(size=N), dtype=torch.float32, device=dev)
    dz = torch.as_tensor(rng.normal(size=N), dtype=torch.float32, device=dev)
    what = f"logits ({N}, {V}) {dtype} at offset {offset} ({label} path)"
    tol = (F32_TOL, F32_TOL) if dtype == "float32" else (ATOL, RTOL)

    def through_autograd(stats):
        leaf = logits.detach().requires_grad_(True)
        m, s_, z = stats(leaf, labels, offset)
        (g,) = torch.autograd.grad((s_, z), leaf, (ds, dz))
        return (m, s_.detach(), z.detach()), g

    got, g = through_autograd(xk.xent_local_stats)
    want, wg = through_autograd(local_stats_ref)
    err = max(agree(f"xent_local_stats {name} {what}", a, b, *tol)
              for name, a, b in zip("msz", got, want))
    if dtype != "float32":
        agree(f"xent_local_stats backward {what}", g, wg, *tol)
    # dlogits = ds * exp(x - m) + dz at the label: most entries lie near
    # 1e-6 of their row's scale |ds| + |dz|, far under an atol of F32_TOL.
    # Held per row to that scale with an atol of F32_TOL * 1e-6, so a wrong
    # entry anywhere in the vocabulary fails, not only near the row's max.
    if dtype == "float32":
        scale = (ds.abs() + dz.abs())[:, None]
        agree(f"xent_local_stats backward {what} (per row / (|ds| + |dz|))",
              g / scale, wg / scale, F32_TOL * 1e-6, F32_TOL)
    gerr = (g.float() - wg.float()).abs().max().item()
    del got, g, want, wg
    m, s_, z = xk.xent_local_stats_cuda(logits, labels, offset)
    fwd_bytes = nbytes(logits, labels, m, s_, z)
    fb_ms, fb_by = bound_ms(fwd_bytes, 4 * N * V, PEAK_F32_FLOPS)
    bb_ms, bb_by = bound_ms(fwd_bytes - nbytes(s_, z) + nbytes(ds, dz)
                            + nbytes(logits), 4 * N * V, PEAK_F32_FLOPS)
    # the library yardstick at the shard's shape: labels inside the shard
    lab = (labels.long() - offset).clamp(0, V - 1)

    def plain_bwd():
        leaf = logits.detach().requires_grad_(True)
        _, s2, z2 = local_stats_ref(leaf, labels, offset)
        return lambda: torch.autograd.grad((s2, z2), leaf, (ds, dz),
                                           retain_graph=True)

    def library_bwd():
        leaf = logits.detach().requires_grad_(True)
        loss = torch.nn.functional.cross_entropy(leaf, lab, reduction="none")
        return lambda: torch.autograd.grad(loss, leaf, ds, retain_graph=True)

    fwd = timed({
        "name": f"xent_local_stats ({label}, {dtype})", "route": "cuda",
        "source": "src/repro_torch/csrc/softmax_xent.cu",
        "replaces": "src/repro/kernels/softmax_xent/kernel.py:67",
        "shape": [N, V], "vocab_offset": offset, "dtype": dtype,
        "max_abs_err": err,
        "plain_ms": cuda_ms(lambda: local_stats_ref(logits, labels, offset),
                            iters=5),
        "bound_ms": fb_ms, "bound_by": fb_by,
        "library_ms": cuda_ms(lambda: torch.nn.functional.cross_entropy(
            logits, lab, reduction="none"), iters=5),
    }, "xent_fwd_kernel",
        lambda: xk.xent_local_stats_cuda(logits, labels, offset),
        lambda: xk.xent_local_stats(logits, labels, offset))
    bwd_launch = lambda: xk.xent_local_stats_bwd_cuda(  # noqa: E731
        logits, labels, offset, m, ds, dz)
    bwd = timed({
        "name": f"xent_local_stats_bwd ({label}, {dtype})", "route": "cuda",
        "source": "src/repro_torch/csrc/softmax_xent.cu",
        "replaces": "src/repro/kernels/softmax_xent/kernel.py:67 (its "
                    "backward; no Pallas counterpart)",
        "shape": [N, V], "vocab_offset": offset, "dtype": dtype,
        "max_abs_err": gerr,
        "plain_ms": cuda_ms(plain_bwd(), iters=5),
        "bound_ms": bb_ms, "bound_by": bb_by,
        "library_ms": cuda_ms(library_bwd(), iters=5),
    }, "xent_bwd_kernel", bwd_launch, bwd_launch)
    del logits, m, s_, z
    torch.cuda.empty_cache()
    return fwd, bwd


#: the mesh phase: rows over ``data``, the vocabulary over ``model``
MESH_SHAPE = (2, 2)
MESH_PINS = {"ids": "S(0),B", "labels": "S(0),B", "E": "B,S(0)",
             "W_out": "B,S(1)"}


def qwen3_width_graph(placement=None, pins=None):
    """The graph path's configuration: a LogicalGraph at qwen3-1.7b's
    published widths (d_model 2048, d_ff 6144, vocab 151,936), built from
    the graph layer's ops -- embedding, GRAPH_BLOCKS x [matmul up, gelu,
    matmul down, residual add], the vocab matmul, softmax_xent -- over
    GRAPH_N rows, on one device, or on ``placement`` with the inputs in
    ``pins`` pinned to their signatures."""
    from repro_torch.core.graph import LogicalGraph
    from repro_torch.core.placement import Placement
    g = LogicalGraph(placement or Placement(("d",), (1,)))
    pins = pins or {}
    ids = g.input("ids", (GRAPH_N,), dtype="int32", sbp=pins.get("ids"))
    labels = g.input("labels", (GRAPH_N,), dtype="int32",
                     sbp=pins.get("labels"))
    h = g.embedding(g.input("E", (GRAPH_V, GRAPH_D), sbp=pins.get("E")), ids,
                    name="embed")
    for i in range(GRAPH_BLOCKS):
        a = g.unary(g.matmul(h, g.input(f"w_up{i}", (GRAPH_D, GRAPH_F)),
                             name=f"up{i}"), "gelu", name=f"gelu{i}")
        d = g.matmul(a, g.input(f"w_down{i}", (GRAPH_F, GRAPH_D)),
                     name=f"down{i}")
        h = g.add(d, h, name=f"res{i}")
    logits = g.matmul(h, g.input("W_out", (GRAPH_D, GRAPH_V),
                                 sbp=pins.get("W_out")), name="head")
    g.softmax_xent(logits, labels, name="loss")
    return g


def seeded_graph_inputs(g, seed: int):
    """Float32 params, each N(0, 1) over sqrt(fan-in) but the embedding
    (N(0, 1)), and int32 ids and labels, from numpy."""
    rng = np.random.default_rng(seed)
    params, data = {}, {}
    for t in g.inputs:
        if t.dtype == "int32":
            data[t.name] = rng.integers(0, GRAPH_V, t.shape).astype(np.int32)
        else:
            x = rng.standard_normal(t.shape, dtype=np.float32)
            if t.name != "E":
                x *= np.float32(1 / np.sqrt(t.shape[0]))
            params[t.name] = x
    return params, data


def check_graph_reference(dev):
    """A small graph with an embedding, a residual across the stage
    boundary and softmax_xent trains 2 AdamW steps on the card (actors,
    through the xent kernels) and on the CPU's plain path, from the same
    params and batch: loss and grad_norm within 1e-4 relative each step,
    the first step's post-clip gradients within 1e-4."""
    phase("graph reference (small graph, card vs CPU plain path, 2 steps)")
    from repro_torch import api
    from repro_torch.core.graph import LogicalGraph
    from repro_torch.core.lowering import OptimizerSpec
    from repro_torch.core.placement import Placement
    N, V, D, F = 256, 4096, 64, 128
    g = LogicalGraph(Placement(("d",), (1,)))
    ids = g.input("ids", (N,), dtype="int32")
    labels = g.input("labels", (N,), dtype="int32")
    with g.stage(0):
        h = g.embedding(g.input("E", (V, D)), ids, name="emb")
        a = g.unary(g.matmul(h, g.input("w1", (D, F)), name="up"), "gelu",
                    name="act")
    with g.stage(1):
        r = g.add(g.matmul(a, g.input("w2", (F, D)), name="down"), h,
                  name="res")
        g.softmax_xent(g.matmul(r, g.input("wo", (D, V)), name="head"),
                       labels, name="loss")
    rng = np.random.default_rng(SEED + 8)
    params = {t.name: (rng.standard_normal(t.shape, dtype=np.float32)
                       * np.float32(0.3)) for t in g.inputs
              if t.dtype == "float32"}
    data = {n: rng.integers(0, V, N).astype(np.int32)
            for n in ("ids", "labels")}
    runs = {}
    zero_xent_counts()
    for d in ("cpu", dev):
        sess = api.compile(g, mode="train", params=params, num_microbatches=4,
                           optimizer=OptimizerSpec.adamw(lr=1e-2,
                                                         grad_clip=1.0),
                           device=d)
        runs[d] = []
        for _ in range(2):
            r = sess.step(**data)
            runs[d].append((float(r.loss), float(r.metrics["grad_norm"]),
                            {n: v.cpu() for n, v in r.grads.items()}))
        sess.close()
    n = xent_counts()
    if n != {"xent_local_stats": 8, "xent_local_stats_bwd": 8}:
        raise AssertionError(f"graph reference: xent launches {n}, expected "
                             "8 forward and 8 backward (2 steps x 4 "
                             "microbatches on the card)")
    worst = 0.0
    for (lc, gc, _), (lg, gg, _) in zip(runs["cpu"], runs[dev]):
        err = max(abs(lg - lc) / abs(lc), abs(gg - gc) / abs(gc))
        worst = max(worst, err)
        if err > 1e-4:
            raise AssertionError(f"graph reference: card {runs[dev][:2]} vs "
                                 f"CPU {runs['cpu'][:2]}")
    gerr = max(agree(f"graph reference step-0 grad {k}", runs[dev][0][2][k],
                     runs["cpu"][0][2][k], 1e-4, 1e-4)
               for k in params)
    print(f"graph reference, 2 AdamW steps: card (loss, grad_norm) "
          f"{[r[:2] for r in runs[dev]]}, CPU {[r[:2] for r in runs['cpu']]}"
          f"; max relative err {worst:.3e} (bound 1e-4), step-0 grads max "
          f"abs err {gerr:.3e}; xent launches {n}")


def graph_train(dev):
    """The paper's own path at qwen3-1.7b's widths:
    ``api.compile(graph, mode="train")`` -- SBP plan, 4 stages,
    ``lower_train_stages``, the 1F1B TrainPipelineExecutor -- on
    ``backend="actors"`` with ``regs="1f1b"`` and with the planned quotas
    (``regs=None``), and on ``backend="monolithic"``, GRAPH_STEPS AdamW
    steps each, in lockstep from the same seeded params and batch. Every
    loss, post-clip gradient and updated param must be bitwise equal across
    the three; each step launches the xent kernels exactly GRAPH_M times
    forward and backward; the forward registers in flight stay within the
    quotas. Then one profiled step of the 1F1B session. Returns the xent
    launches of the run and the monolithic session's per-step losses and
    step-0 post-clip gradients (on the host), which the mesh phase is held
    to."""
    phase(f"graph train (qwen3-1.7b widths, {GRAPH_BLOCKS} blocks, "
          f"{GRAPH_M} x {GRAPH_N // GRAPH_M} rows, {GRAPH_STAGES} stages, "
          f"float32, AdamW, {GRAPH_STEPS} steps x 3 backends)")
    from repro_torch import api
    from repro_torch.core.lowering import OptimizerSpec
    g = qwen3_width_graph()
    t0 = time.perf_counter()
    params, data = seeded_graph_inputs(g, SEED + 9)
    n_params = sum(v.size for v in params.values())
    print(f"graph: {len(g.ops)} ops, {n_params:,} params "
          f"({n_params * 4 / 1e9:.2f} GB float32), made in "
          f"{time.perf_counter() - t0:.1f} s")
    common = dict(mode="train", params=params, num_microbatches=GRAPH_M,
                  optimizer=OptimizerSpec.adamw(lr=3e-4, grad_clip=1.0),
                  device=dev)
    sessions = {
        "actors 1f1b": api.compile(g, backend="actors", stages=GRAPH_STAGES,
                                   regs="1f1b", **common),
        "actors planned": api.compile(g, backend="actors",
                                      stages=GRAPH_STAGES, regs=None,
                                      **common),
        "monolithic": api.compile(g, backend="monolithic", **common)}
    del params
    batch = {n: torch.as_tensor(v, device=dev) for n, v in data.items()}
    for name, sess in sessions.items():
        if sess.partition is not None:
            print(f"{name}: regs {sess.regs}, stages "
                  + str([len(sess.partition.ops_in(g, s))
                         for s in range(GRAPH_STAGES)]) + " ops")
    torch.cuda.synchronize()
    zero_xent_counts()
    kept = {"loss": [], "wall": {name: [] for name in sessions}}
    for step in range(GRAPH_STEPS):
        results = {}
        for name, sess in sessions.items():
            before = xent_counts()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t = time.perf_counter()
            res = sess.step(**batch)
            loss = float(res.loss)
            wall = time.perf_counter() - t
            kept["wall"][name].append(wall)
            peak = (torch.cuda.max_memory_allocated() - base) / 2**30
            per = {k: v - before[k] for k, v in xent_counts().items()}
            results[name] = res
            extra = ""
            if sess.regs is not None:
                pk = sess.executor.last_peak_regs
                inflight = [pk[f"f{s}"] for s in range(GRAPH_STAGES)]
                extra = f", in flight {inflight} (quotas {sess.regs})"
                if any(i > r for i, r in zip(inflight, sess.regs)):
                    raise AssertionError(f"{name}: in flight {inflight} "
                                         f"past the quotas {sess.regs}")
            print(f"{name} step {step}: loss {loss:.6f}, grad_norm "
                  f"{float(res.metrics['grad_norm']):.6f}, wall {wall:.3f} s,"
                  f" {GRAPH_N / wall:,.0f} tokens/s, peak above the step's "
                  f"start {peak:.2f} GiB, xent launches {per}{extra}")
            if per != {"xent_local_stats": GRAPH_M,
                       "xent_local_stats_bwd": GRAPH_M}:
                raise AssertionError(f"{name} step {step}: xent launches "
                                     f"{per}, expected {GRAPH_M} + {GRAPH_M}")
            if not np.isfinite(loss):
                raise AssertionError(f"{name} step {step}: loss {loss}")
        ref = results["monolithic"]
        for name, res in results.items():
            for what, a, b in [("loss", res.loss, ref.loss)] + [
                    (f"grad {k}", res.grads[k], ref.grads[k])
                    for k in ref.grads] + [
                    (f"param {k}", res.params[k], ref.params[k])
                    for k in ref.params]:
                if not torch.equal(a, b):
                    raise AssertionError(
                        f"step {step}: {name} and monolithic disagree on "
                        f"{what} (max abs diff "
                        f"{(a - b).abs().max().item():.3e})")
        print(f"step {step}: losses, {len(ref.grads)} post-clip grads and "
              f"{len(ref.params)} params bitwise equal across "
              f"{list(sessions)}")
        kept["loss"].append(float(ref.loss))
        if step == 0:
            kept["grads0"] = {k: v.cpu() for k, v in ref.grads.items()}
        del results, ref, res
    total = xent_counts()
    print(f"graph train: xent launches over the run {total}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB with "
          f"{len(sessions)} sessions alive")
    one = sessions.pop("actors 1f1b")
    for name in list(sessions):
        sessions.pop(name).close()
    del sess
    gc.collect()        # a closed session's actor graph holds cycles
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    profile_device("graph train step (actors 1f1b)",
                   lambda: float(one.step(**batch).loss), top=10)
    print(f"graph train step (actors 1f1b) alone: peak above its start "
          f"{(torch.cuda.max_memory_allocated() - base) / 2**30:.2f} GiB, "
          f"{base / 2**30:.2f} GiB held before it (params, AdamW moments, "
          "gradient sums)")
    one.close()
    del one
    torch.cuda.empty_cache()
    return total, kept


def rank_bytes(sess) -> list:
    """Bytes each rank of a train session holds between steps: its param
    shards and AdamW moments (once the first step made them)."""
    ex = sess.executor
    n = sess.meshes[0].size
    held = [sum(v[r].numel() * v[r].element_size()
                for v in ex.shards.values()) for r in range(n)]
    states = ex.opt_states
    per_stage = states.values() if isinstance(states, dict) else [states]
    for ranks in per_stage:
        for r, st in enumerate(ranks or []):
            held[r] += nbytes(*st.mu.values(), *st.nu.values())
    return held


def graph_train_mesh(dev, ref):
    """Phase 9: the qwen3-width graph on a (2, 2) mesh of 4 virtual ranks
    on the card, rows over ``data`` and the vocabulary over ``model``,
    GRAPH_STEPS AdamW steps on the actors (1F1B) and on the monolithic
    engine, one session after the other; held bitwise to each other and to
    the 1 x 1 monolithic run of :func:`graph_train` (``ref``) within the
    stated tolerances, with the xent kernels' launches and offsets counted
    each step. Returns the xent launches of the run."""
    phase(f"graph train on a {MESH_SHAPE} mesh (qwen3-1.7b widths, "
          f"{int(np.prod(MESH_SHAPE))} virtual ranks on one card, "
          f"{GRAPH_M} microbatches, {GRAPH_STAGES} stages, AdamW, "
          f"{GRAPH_STEPS} steps x 2 backends)")
    from repro_torch import api
    from repro_torch.core.lowering import OptimizerSpec
    from repro_torch.core.placement import Placement
    from repro_torch.core.sbp import ndsbp
    from repro_torch.kernels.softmax_xent import kernel as xk
    placement = Placement(("data", "model"), MESH_SHAPE)
    g = qwen3_width_graph(placement, MESH_PINS)
    params, data = seeded_graph_inputs(g, SEED + 9)
    batch = {n: torch.as_tensor(v, device=dev) for n, v in data.items()}
    ranks = placement.num_devices
    shard = GRAPH_V // MESH_SHAPE[1]
    want_offsets = {0: ranks // 2 * GRAPH_M, shard: ranks // 2 * GRAPH_M}
    adamw = OptimizerSpec.adamw(lr=3e-4, grad_clip=1.0)
    kept = []
    total = {"xent_local_stats": 0, "xent_local_stats_bwd": 0}
    for name, kw in (("actors 1f1b", dict(backend="actors",
                                          stages=GRAPH_STAGES, regs="1f1b")),
                     ("monolithic", dict(backend="monolithic"))):
        sess = api.compile(g, mode="train", params=params,
                           num_microbatches=GRAPH_M, optimizer=adamw,
                           device=dev, **kw)
        mesh = sess.meshes[0]
        if not kept:
            print(sess.plan.describe())
            xin = sess.plan.op_in_sbp["loss"][0]
            if xin != ndsbp("S(0),S(1)"):
                raise AssertionError(f"softmax_xent input planned {xin}, "
                                     "expected (S(0), S(1))")
            shards = nbytes(*(v for vs in sess.executor.shards.values()
                              for v in vs))
            results = 2 * 4 * sum(v.size for v in params.values())
            print(f"reckoned: {shards / 2**30:.2f} GiB of param shards over "
                  f"{ranks} ranks (replicas over data included), x 4 with "
                  f"the AdamW moments and gradient sums = "
                  f"{4 * shards / 2**30:.2f} GiB a session, and "
                  f"{results / 2**30:.2f} GiB of global grads and params a "
                  "step, assembled when read after the timed step; two "
                  "sessions at once would hold "
                  f"{(8 * shards + 2 * results) / 2**30:.1f} GiB of the "
                  "card's 80 GB before activations and the step's "
                  "temporaries, so they run one after the other and the "
                  "second is held to the first's kept copies")
        print(f"{name}: {mesh}, regs {sess.regs}")
        for step in range(GRAPH_STEPS):
            zero_xent_counts()
            mesh.stats.reset()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t = time.perf_counter()
            res = sess.step(**batch)
            loss = float(res.loss)
            wall = time.perf_counter() - t
            peak = (torch.cuda.max_memory_allocated() - base) / 2**30
            counts = xent_counts()
            offsets = (dict(xk.offset_launches), dict(xk.bwd_offset_launches))
            total = {k: v + counts[k] for k, v in total.items()}
            st = mesh.stats
            # the global grads and params, outside the step's wall and peak
            t = time.perf_counter()
            grads, new_params = res.grads, res.params
            torch.cuda.synchronize()
            assembly = time.perf_counter() - t
            print(f"{name} step {step}: loss {loss:.6f}, grad_norm "
                  f"{float(res.metrics['grad_norm']):.6f}, wall {wall:.3f} s,"
                  f" {GRAPH_N / wall:,.0f} rows/s, peak above the step's "
                  f"start {peak:.2f} GiB (global grads and params assembled "
                  f"after it in {assembly:.3f} s), xent launches {counts} "
                  "at offsets "
                  f"{offsets[0]} / {offsets[1]}; collectives "
                  f"{st.total_bytes() / 2**20:,.1f} MiB (Table 2 volume) in "
                  f"{sum(st.calls.values())} calls {st.calls}, the ranks "
                  f"{st.wait_s:.3f} s in them in all")
            if counts != {"xent_local_stats": ranks * GRAPH_M,
                          "xent_local_stats_bwd": ranks * GRAPH_M} \
                    or offsets != (want_offsets, want_offsets):
                raise AssertionError(
                    f"{name} step {step}: xent launches {counts} at "
                    f"{offsets}, expected {ranks * GRAPH_M} each way at "
                    f"{want_offsets}")
            if not np.isfinite(loss):
                raise AssertionError(f"{name} step {step}: loss {loss}")
            rel = abs(loss - ref["loss"][step]) / abs(ref["loss"][step])
            bound = 1e-5 if step == 0 else 1e-4
            if rel > bound:
                raise AssertionError(
                    f"{name} step {step}: loss {loss} vs the 1 x 1 "
                    f"session's {ref['loss'][step]} ({rel:.2e} relative, "
                    f"bound {bound})")
            if step == 0:
                # post-clip entries are ~1 / sqrt(723 M) ~ 4e-5: an atol of
                # 1e-7 sits between that and float32 summation order, and
                # each gradient's relative norm error is held too, so a
                # wrong block of small entries cannot pass
                gerr, nerr = 0.0, 0.0
                for k, gk in grads.items():
                    want = ref["grads0"][k].to(dev)
                    gerr = max(gerr, agree(f"{name} step-0 grad {k} vs 1 x 1",
                                           gk, want, 1e-7, 1e-4))
                    rn = (torch.linalg.vector_norm(gk - want)
                          / torch.linalg.vector_norm(want)).item()
                    print(f"{name} step-0 grad {k}: |diff| / |ref| {rn:.3e}"
                          " (limit 1e-4)")
                    if not rn <= 1e-4:
                        raise AssertionError(
                            f"{name} step-0 grad {k}: relative norm error "
                            f"{rn:.3e} vs the 1 x 1 session")
                    nerr = max(nerr, rn)
                    del want, gk
                print(f"{name} step 0: loss {rel:.2e} relative of the 1 x 1 "
                      f"session's, post-clip grads max abs err {gerr:.3e}, "
                      f"worst relative norm error {nerr:.3e}")
            if len(kept) < GRAPH_STEPS:
                kept.append((res.loss.cpu(),
                             {k: v.cpu() for k, v in grads.items()},
                             {k: v.cpu() for k, v in new_params.items()}))
                del res, grads, new_params
                continue
            k_loss, k_grads, k_params = kept[step]
            for what, a, b in [("loss", res.loss, k_loss)] + [
                    (f"grad {k}", grads[k], k_grads[k])
                    for k in k_grads] + [
                    (f"param {k}", new_params[k], k_params[k])
                    for k in k_params]:
                if not torch.equal(a, b.to(dev)):
                    raise AssertionError(
                        f"step {step}: monolithic and actors disagree on "
                        f"{what} on the mesh")
            print(f"step {step}: loss, {len(k_grads)} post-clip grads and "
                  f"{len(k_params)} params bitwise equal across the actors "
                  "and the monolithic engine on the mesh")
            del res, grads, new_params
        held = rank_bytes(sess)
        print(f"{name}: each rank holds {[round(b / 2**30, 3) for b in held]}"
              f" GiB of param shards and AdamW moments; the session's peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated "
              "after its last step")
        if sess.regs is not None:
            profile_device(f"graph train step on the {MESH_SHAPE} mesh "
                           f"({name})", lambda: float(sess.step(**batch).loss),
                           top=10)
        sess.close()
        del sess
        gc.collect()
        torch.cuda.empty_cache()
    print(f"graph train on the mesh: xent launches over the run {total}")
    return total


# phase 9b: float32 masters, bf16 compute and dynamic loss scaling on the
# paper's path. Step 0's loss against phase 9's float32 one: each row's
# loss is a logsumexp minus the label's logit over bf16-rounded operands,
# its rounding errors of either sign, and the step sums 4,096 rows, so the
# sum stays within one bf16 unit (2^-8) of the float32 loss; it must also
# differ from it (otherwise the cast is not happening)
GRAPH_MP_RTOL = 2.0 ** -8


def graph_train_mp(dev, ref):
    """Phase 9b: the qwen3-width graph and params of phase 9 with
    ``zero=True, precision="bf16", loss_scale="dynamic"``, GRAPH_STEPS
    AdamW steps on ``backend="actors"`` (1F1B) and ``"monolithic"`` in
    lockstep. Losses, the float32 masters, the moments and the loss-scale
    trajectory must be bitwise equal across the two, masters and moments
    float32, step 0's loss off phase 9's float32 loss (``ref``) but within
    GRAPH_MP_RTOL of it; the bf16 xent kernels launch exactly GRAPH_M times
    each way a step a backend. Prints ``opt_state_bytes`` beside the dense
    figure and each step's wall beside phase 9's. Returns the xent
    launches of the run."""
    phase(f"graph train, mixed precision (qwen3-1.7b widths, zero, bf16 "
          f"compute over float32 masters, dynamic loss scale, "
          f"{GRAPH_STEPS} steps x 2 backends)")
    from repro_torch import api
    from repro_torch.core.lowering import OptimizerSpec
    g = qwen3_width_graph()
    params, data = seeded_graph_inputs(g, SEED + 9)
    n = sum(v.size for v in params.values())
    common = dict(mode="train", params=params, num_microbatches=GRAPH_M,
                  optimizer=OptimizerSpec.adamw(lr=3e-4, grad_clip=1.0),
                  device=dev, zero=True, precision="bf16",
                  loss_scale="dynamic")
    sessions = {
        "actors 1f1b": api.compile(g, backend="actors", stages=GRAPH_STAGES,
                                   regs="1f1b", **common),
        "monolithic": api.compile(g, backend="monolithic", **common)}
    del params
    batch = {k: torch.as_tensor(v, device=dev) for k, v in data.items()}
    torch.cuda.reset_peak_memory_stats()
    print("\n".join(ln for ln in sessions["actors 1f1b"].describe()
                    .splitlines() if ln.startswith(("precision", "zero"))))
    torch.cuda.synchronize()
    zero_xent_counts()
    for step in range(GRAPH_STEPS):
        results = {}
        for name, sess in sessions.items():
            before = xent_counts()
            t = time.perf_counter()
            res = sess.step(**batch)
            loss = float(res.loss)
            wall = time.perf_counter() - t
            per = {k: v - before[k] for k, v in xent_counts().items()}
            m = res.metrics
            print(f"{name} step {step}: loss {loss:.6f}, grad_norm "
                  f"{float(m['grad_norm']):.6f}, loss_scale "
                  f"{m['loss_scale']}, skipped {m['skipped']}, wall "
                  f"{wall:.3f} s (phase 9's float32 step "
                  f"{ref['wall'][name][step]:.3f} s), "
                  f"{GRAPH_N / wall:,.0f} tokens/s, xent launches {per}")
            if per != {"xent_local_stats": GRAPH_M,
                       "xent_local_stats_bwd": GRAPH_M}:
                raise AssertionError(f"{name} step {step}: xent launches "
                                     f"{per}, expected {GRAPH_M} + {GRAPH_M}")
            if not np.isfinite(loss) or m["skipped"]:
                raise AssertionError(f"{name} step {step}: loss {loss}, "
                                     f"skipped {m['skipped']}")
            results[name] = res
        a, b = (results[k] for k in sessions)
        sa, sb = (s.opt_state for s in sessions.values())
        pairs = [("loss", a.loss, b.loss)] + [
            (f"master {k}", a.params[k], b.params[k]) for k in b.params] + [
            (f"mu {k}", sa.mu[k], sb.mu[k]) for k in sb.mu] + [
            (f"nu {k}", sa.nu[k], sb.nu[k]) for k in sb.nu]
        for what, x, y in pairs:
            if not torch.equal(x, y):
                raise AssertionError(f"step {step}: actors and monolithic "
                                     f"disagree on {what}")
        wrong = [w for w, x, _ in pairs[1:] if x.dtype != torch.float32]
        if wrong or a.metrics["loss_scale"] != b.metrics["loss_scale"] \
                or {int(sa.step), int(sb.step)} != {step + 1}:
            raise AssertionError(f"step {step}: not float32 {wrong[:3]}, or "
                                 "the scales or step counts differ")
        print(f"step {step}: loss, {len(b.params)} float32 masters and "
              f"{2 * len(sb.mu)} moments bitwise equal across the actors and "
              f"the monolithic engine, loss scale {a.metrics['loss_scale']}")
        if step == 0:
            rel = abs(float(b.loss) - ref["loss"][0]) / abs(ref["loss"][0])
            print(f"step 0: bf16 loss {float(b.loss):.6f} vs phase 9's "
                  f"float32 {ref['loss'][0]:.6f}: {rel:.3e} relative (must "
                  f"differ; bound {GRAPH_MP_RTOL:.3e}, one bf16 unit)")
            if not 0 < rel <= GRAPH_MP_RTOL:
                raise AssertionError("graph train, mixed precision: step 0's "
                                     "loss is not off the float32 loss by "
                                     "less than one bf16 unit")
        if step == GRAPH_STEPS - 1:
            zero_bound_vs_held(sessions["actors 1f1b"], a,
                               "graph train mp actors")
        del results, a, b, sa, sb, pairs
    per = sessions["actors 1f1b"].executor.opt_state_bytes()
    mono = sessions["monolithic"].executor.opt_state_bytes()
    print(f"opt_state_bytes: actors {per} (total {sum(per.values()):,}), "
          f"monolithic {mono}; float32 masters and moments 3 x 4 x {n:,} = "
          f"{12 * n:,}, plain AdamW's moments 2 x 4 x {n:,} = {8 * n:,}")
    if {sum(per.values()), sum(mono.values())} != {12 * n}:
        raise AssertionError("opt_state_bytes disagree with 12 B a param")
    total = xent_counts()
    print(f"graph train, mixed precision: xent launches over the run "
          f"{total}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB with {len(sessions)} sessions alive")
    for sess in sessions.values():
        sess.close()
    del sessions
    gc.collect()
    torch.cuda.empty_cache()
    return total


#: elements a fingerprint reads at a time (512 MiB of int64 on the card)
FP_CHUNK = 1 << 26


def bits_fingerprint(t) -> tuple:
    """Two int64 sums over ``t``'s bit patterns, computed on the card: the
    plain one and one weighted by position (both wrapping), so a changed
    bit or a moved element changes them; with the dtype and shape. Lets a
    phase hold a session's state to one that is no longer alive (a state
    is 8.7 GB; one session lives at a time) without a copy to the host."""
    flat = t.detach().contiguous().reshape(-1)
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    bits = flat.view(ints[flat.element_size()])
    total = torch.zeros(2, dtype=torch.int64, device=flat.device)
    for lo in range(0, bits.numel(), FP_CHUNK):
        c = bits[lo:lo + FP_CHUNK].long()
        w = torch.arange(lo + 1, lo + 1 + c.numel(), dtype=torch.int64,
                         device=c.device)
        total[0] += c.sum()
        total[1] += (c * w).sum()
    return tuple(total.tolist()) + (str(t.dtype), tuple(t.shape))


def session_fingerprint(sess, res) -> dict:
    """A train session's state after step ``res``: the loss and loss
    scale, the optimizer's step, and the fingerprint of every float32
    master and moment."""
    st = sess.opt_state
    fp = {"loss": float(res.loss), "loss_scale": res.metrics["loss_scale"],
          "step": int(st.step)}
    fp.update({f"master {p}": bits_fingerprint(v)
               for p, v in sess.params.items()})
    fp.update({f"mu {p}": bits_fingerprint(v) for p, v in st.mu.items()})
    fp.update({f"nu {p}": bits_fingerprint(v) for p, v in st.nu.items()})
    return fp


def held_to(what: str, got: dict, want: dict) -> None:
    """Raise unless two fingerprints are equal; print what was held."""
    bad = [k for k in want if got.get(k) != want[k]]
    if bad or set(got) != set(want):
        raise AssertionError(f"{what}: differs in {bad[:4]} "
                             f"({len(bad)} of {len(want)} entries)")
    n = sum(k.startswith(("master", "mu", "nu")) for k in want)
    print(f"{what}: loss {got['loss']:.6f}, loss scale "
          f"{got['loss_scale']}, step {got['step']} and {n} float32 "
          "masters and moments bitwise equal")


def dir_bytes(path) -> int:
    """Bytes of the files under ``path``."""
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def graph_snapshot_resume(dev, smi: str):
    """Phase 9c: snapshots, a kill and a resume on the graph path at full
    width -- phase 9b's configuration (qwen3-width graph, 4 stages, 1F1B,
    ``zero=True, precision="bf16", loss_scale="dynamic"``) in four
    sessions stepped in lockstep: U uninterrupted for GRAPH_STEPS steps; K
    snapshotting at step 2 and killed in step 3; R restored from K's
    snapshot for step 3; C under a delayed and a duplicated Req for step
    1. Every comparison is bitwise: loss, loss scale, every float32 master
    and moment. Returns the xent launches of the run, and U's
    fingerprint after each step (``session_fingerprint``) with K's and
    U's snapshot step walls, which the processes phase is held to."""
    phase("graph snapshot and resume (qwen3-1.7b widths, zero, bf16, "
          "dynamic loss scale; uninterrupted U, snapshot-and-kill K, "
          "restored R, chaos C)")
    from repro_torch import api
    from repro_torch.core.lowering import OptimizerSpec
    from repro_torch.runtime.base import WorkerError
    from repro_torch.runtime.chaos import (DelayEdge, DuplicateReq,
                                           FaultPlan, KillWorker)
    from repro_torch.runtime.snapshot import (latest_snapshot,
                                              load_snapshot, step_dir)
    g = qwen3_width_graph()
    params, data = seeded_graph_inputs(g, SEED + 9)
    n = sum(v.size for v in params.values())
    want_bytes = 12 * n           # float32 masters, mu and nu
    root = tempfile.mkdtemp(prefix="graph-snapshot-")
    sessions = {}
    try:
        free = shutil.disk_usage(root).free
        print(f"snapshot directory {root}: {free:,} bytes free, the "
              f"snapshot needs {want_bytes:,} (3 x 4 x {n:,}); "
              f"asked for twice that")
        if free < 2 * want_bytes:
            raise AssertionError(
                f"graph snapshot: {free:,} bytes free under {root}, less "
                f"than twice the snapshot's {want_bytes:,}")
        common = dict(mode="train", params=params, num_microbatches=GRAPH_M,
                      optimizer=OptimizerSpec.adamw(lr=3e-4, grad_clip=1.0),
                      device=dev, zero=True, precision="bf16",
                      loss_scale="dynamic", backend="actors",
                      stages=GRAPH_STAGES, regs="1f1b")
        kill = KillWorker("b1", fire=2 * GRAPH_M + 3)
        chaos = FaultPlan([DelayEdge("f1", "f2", seconds=0.05, version=3),
                           DuplicateReq("b2", "b1", version=5)])
        sessions["U"] = api.compile(g, **common)
        sessions["K"] = api.compile(g, snapshot_dir=root, snapshot_every=2,
                                    faults=FaultPlan([kill]), **common)
        sessions["C"] = api.compile(g, faults=chaos, **common)
        batch = {k: torch.as_tensor(v, device=dev) for k, v in data.items()}
        torch.cuda.synchronize()
        zero_xent_counts()
        walls = {}

        def step(name, k):
            before = xent_counts()
            t = time.perf_counter()
            res = sessions[name].step(**batch)
            loss = float(res.loss)
            walls[name, k] = time.perf_counter() - t
            per = {key: v - before[key] for key, v in xent_counts().items()}
            print(f"{name} step {k}: loss {loss:.6f}, loss_scale "
                  f"{res.metrics['loss_scale']}, wall {walls[name, k]:.3f} "
                  f"s, xent launches {per}")
            if per != {"xent_local_stats": GRAPH_M,
                       "xent_local_stats_bwd": GRAPH_M}:
                raise AssertionError(f"{name} step {k}: xent launches "
                                     f"{per}, expected {GRAPH_M} + {GRAPH_M}")
            if not np.isfinite(loss) or res.metrics["skipped"]:
                raise AssertionError(f"{name} step {k}: loss {loss}")
            return res

        def bitwise(name, k, res, ref):
            a, b = sessions[name], sessions["U"]
            sa, sb = a.opt_state, b.opt_state
            pairs = [("loss", res.loss, ref.loss)] + [
                (f"master {p}", a.params[p], b.params[p])
                for p in b.params] + [
                (f"mu {p}", sa.mu[p], sb.mu[p]) for p in sb.mu] + [
                (f"nu {p}", sa.nu[p], sb.nu[p]) for p in sb.nu]
            bad = [w for w, x, y in pairs
                   if x.dtype != y.dtype or not torch.equal(x, y)]
            if (bad or res.metrics["loss_scale"] != ref.metrics["loss_scale"]
                    or int(sa.step) != int(sb.step)):
                raise AssertionError(
                    f"{name} step {k} differs from U's: {bad[:4]}, scales "
                    f"{res.metrics['loss_scale']} / "
                    f"{ref.metrics['loss_scale']}")
            print(f"{name} step {k}: loss, loss scale, {len(b.params)} "
                  f"float32 masters and {2 * len(sb.mu)} moments bitwise "
                  "U's")

        record = {"fp": {}}
        for k in (1, 2):
            ref = step("U", k)
            record["fp"][k] = session_fingerprint(sessions["U"], ref)
            for name in ("K", "C") if k == 1 else ("K",):
                bitwise(name, k, step(name, k), ref)
            if k == 1:
                applied = sessions["C"].executor.runtime.fault_injector \
                    .applied
                print(f"C: faults applied {applied}")
                if len(applied) != 2:
                    raise AssertionError(f"chaos: applied {applied}, "
                                         f"planned {chaos.faults}")
                sessions.pop("C").close()
            del ref
        hist = sessions["K"].executor.last_history
        writes = {a: round(e - b, 3) for a, spans in hist.items()
                  if a.startswith("snap") for b, e in spans}
        on_disk = dir_bytes(step_dir(root, 2))
        print(f"snapshot step 2: {on_disk:,} bytes on disk ({want_bytes:,} "
              f"of float32 masters and moments), K's step wall "
              f"{walls['K', 2]:.3f} s beside U's {walls['U', 2]:.3f} s "
              f"({walls['K', 2] / walls['U', 2]:.2f}x), the snap actors' "
              f"write seconds {writes}; {smi}")
        record.update(k_wall=walls["K", 2], u_wall=walls["U", 2])
        ref3 = step("U", 3)
        record["fp"][3] = session_fingerprint(sessions["U"], ref3)
        scale, good = (sessions["U"].executor.loss_scale,
                       sessions["U"].executor.scale_good_steps)
        before = xent_counts()
        try:
            sessions["K"].step(**batch)
        except WorkerError as e:
            print(f"K step 3: {type(e).__name__}: {e}; xent launches "
                  f"before the kill "
                  f"{ {k: v - before[k] for k, v in xent_counts().items()} }")
        else:
            raise AssertionError("K step 3 was not killed")
        sessions.pop("K").close()
        gc.collect()
        torch.cuda.empty_cache()
        if latest_snapshot(root) != 2:
            raise AssertionError(f"latest snapshot {latest_snapshot(root)}"
                                 ", expected 2")
        t = time.perf_counter()
        loaded = load_snapshot(root)
        t_load = time.perf_counter() - t
        del loaded
        t = time.perf_counter()
        sessions["R"] = api.compile(g, restore=root, **common)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t
        r = sessions["R"]
        print(f"load_snapshot {t_load:.3f} s; compile(restore=) "
              f"{t_restore:.3f} s (params placed, snapshot loaded, masters "
              f"and moments on the card); step_count {r.step_count}, loss "
              f"scale {r.executor.loss_scale} (U's after step 2 "
              f"{ref3.metrics['loss_scale']}); {smi}")
        if r.step_count != 2:
            raise AssertionError(f"R: step_count {r.step_count}")
        bitwise("R", 3, step("R", 3), ref3)
        if (r.executor.loss_scale, r.executor.scale_good_steps) != (
                scale, good):
            raise AssertionError("R: the scale trajectory forked from U's")
        total = xent_counts()
        print(f"graph snapshot and resume: xent launches over the run "
              f"{total}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        return total, record
    finally:
        for sess in sessions.values():
            sess.close()
        sessions.clear()
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


def graph_infer(dev):
    """The same graph under ``mode="infer"``: actors (4 stages, 1F1B
    quotas) and monolithic must give bitwise equal per-row losses, each run
    launching the xent forward kernel GRAPH_M times and its backward none."""
    phase(f"graph infer (qwen3-1.7b widths, {GRAPH_M} microbatches, actors "
          "vs monolithic)")
    from repro_torch import api
    g = qwen3_width_graph()
    params, data = seeded_graph_inputs(g, SEED + 9)
    inputs = {n: torch.as_tensor(v, device=dev)
              for n, v in {**params, **data}.items()}
    del params
    outs, counts = {}, {}
    for backend in ("actors", "monolithic"):
        kw = dict(stages=GRAPH_STAGES) if backend == "actors" else {}
        with api.compile(g, mode="infer", backend=backend,
                         num_microbatches=GRAPH_M,
                         microbatch_inputs=["ids", "labels"], device=dev,
                         **kw) as sess:
            zero_xent_counts()
            t = time.perf_counter()
            outs[backend] = sess.run(**inputs)["loss.out"]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            counts[backend] = xent_counts()
            print(f"{backend}: {GRAPH_N / wall:,.0f} rows/s ({wall:.3f} s), "
                  f"xent launches {counts[backend]}, mean loss "
                  f"{outs[backend].mean().item():.6f}")
        if counts[backend] != {"xent_local_stats": GRAPH_M,
                               "xent_local_stats_bwd": 0}:
            raise AssertionError(f"graph infer {backend}: xent launches "
                                 f"{counts[backend]}")
    a, b = outs["actors"], outs["monolithic"]
    if a.shape != (GRAPH_N, 1) or not torch.isfinite(a).all() \
            or not torch.equal(a, b):
        raise AssertionError("graph infer: actors and monolithic disagree")
    print(f"graph infer: actors == monolithic bitwise over {GRAPH_N} rows")
    del inputs, outs
    torch.cuda.empty_cache()
    return counts["actors"]


def worker_lines(rt, dev) -> None:
    """Each worker process of a process runtime: its pid, which must not
    be this process's, and its device, which must be the card."""
    for node, w in sorted(rt.workers.items()):
        print(f"  node {node}: pid {w['pid']} on {w['device']} "
              f"({w.get('device_name')}); started "
              + ", ".join(f"{k} {v:.2f} s" for k, v in w["start_s"].items()))
    if any(w["pid"] == os.getpid() for w in rt.workers.values()):
        raise AssertionError("a worker runs in the driver's process")
    if not all(w["device"].startswith("cuda")
               and torch.device(w["device"]).type == torch.device(dev).type
               for w in rt.workers.values()):
        raise AssertionError(f"workers not on the card: {rt.workers}")


def all_stopped(rt, what: str) -> None:
    """No worker process of ``rt`` may be alive."""
    alive = [n for n, p in rt._procs.items() if p.is_alive()]
    if alive:
        raise AssertionError(f"{what}: worker processes {alive} alive")
    print(f"{what}: every worker process stopped (exit codes "
          f"{ {n: p.exitcode for n, p in rt._procs.items()} })")


#: bytes a worker's allocated memory may grow between the two halves of a
#: serve run (a run whose blocks leaked in IPC limbo would grow by its
#: logits, 1.2 MB a round, over some 300 rounds)
FLAT_SLACK = 64 << 20


def serve_processes(dev, cfg, model, threads_launches, threads_run):
    """The serve phase's model and 12 requests on ``runtime="processes"``:
    2 stages, so 3 worker processes (node 0 ``admit``, nodes 1-2 the
    stages), each mapping the driver's weights by CUDA IPC and running its
    stage's kernels. Tokens must equal the serve phase's threads session's,
    and the launches summed from the workers its 336 attention forwards
    and 2,632 decodes; each worker's allocated memory must stay flat over
    the run. Returns the run's counts."""
    phase(f"serve on worker processes ({cfg.name}, full width and depth, "
          "bf16, runtime='processes', 2 stages: 3 worker processes)")
    requests = serve_requests(cfg)
    geo = dict(num_groups=2, group_size=4, max_prompt_len=512,
               max_new_tokens=48)
    t0 = time.perf_counter()
    sess = compile_serve(cfg, model, "actors", runtime="processes", **geo)
    rt = sess.executor.runtime          # the workers start here
    print(f"compiled and {len(rt.workers)} workers started in "
          f"{time.perf_counter() - t0:.1f} s (workers alone "
          f"{rt.start_seconds:.1f} s)")
    print(sess.describe().splitlines()[0])
    worker_lines(rt, dev)
    allocated = {n: [] for n in rt.nodes}
    edges: dict = {}
    run_round = sess.executor.run_round

    def traced_round(work, timeout=300.0):
        out = run_round(work, timeout)
        for n, info in rt.last_worker_stats.items():
            allocated[n].append(info["allocated_bytes"])
        for k, v in sess.executor.last_edge_bytes.items():
            edges[k] = edges.get(k, 0) + v
        return out

    sess.executor.run_round = traced_round
    try:
        out, got, peak = counted_run(cfg, sess, requests, "processes")
        st = sess.last_stats
        peaks = {n: info["peak_bytes"]
                 for n, info in rt.last_worker_stats.items()}
    finally:
        sess.close()
    all_stopped(rt, "serve processes")
    want = {k: threads_launches[k] for k in got}
    if got != want:
        raise AssertionError(f"processes: launches {got}, the threads "
                             f"run's {want}")
    if not same_tokens(out, threads_run["outs"]):
        raise AssertionError("processes: tokens differ from the threads "
                             "session's")
    print(f"processes: tokens identical to the threads session's; "
          f"launches {got} summed from the workers, as the threads run's")
    for n, seq in sorted(allocated.items()):
        half = len(seq) // 2
        first, second = max(seq[:half]), max(seq[half:])
        print(f"  node {n}: allocated {seq[0] / 2**20:,.1f} MiB after round "
              f"1, {first / 2**20:,.1f} max over the first {half} rounds, "
              f"{second / 2**20:,.1f} over the last {len(seq) - half}; peak "
              f"{peaks[n] / 2**30:.2f} GiB")
        if second > first + FLAT_SLACK:
            raise AssertionError(f"node {n}: allocated memory grew by "
                                 f"{(second - first) / 2**20:,.1f} MiB")
    print(f"processes: {st['tok_per_s']:.2f} tok/s against the threads "
          f"session's {threads_run['tok_per_s']:.2f} and the monolithic "
          f"{threads_run['mono_tok_per_s']:.2f} (this run); workers started "
          f"in {rt.start_seconds:.1f} s; peak memory: driver "
          f"{peak / 2**30:.2f} GiB, workers "
          + ", ".join(f"node {n} {b / 2**30:.2f} GiB"
                      for n, b in sorted(peaks.items()))
          + "; edge bytes over the run "
          + ", ".join(f"{a}->{b} {v:,}" for (a, b), v in sorted(
              edges.items())))
    gc.collect()
    torch.cuda.empty_cache()
    return got


def graph_processes(dev, smi: str, threads):
    """The graph snapshot phase's configuration (qwen3-width graph, 4
    stages, ZeRO, bf16, dynamic loss scale) on ``runtime="processes"``:
    one worker process per stage node, one session alive at a time. P
    runs GRAPH_STEPS steps uninterrupted, each held bitwise to the threads
    run U (its fingerprints, ``threads["fp"]``); K snapshots every step
    from the stage workers and is killed in step 3 by KillWorker, a real
    ``os._exit(57)`` of b1's worker: a WorkerError naming the node and the
    code, no worker left alive, K's steps 1-2 bitwise P's; R
    (``compile(runtime="processes", restore=)``) resumes from the files
    the workers wrote and its step 3 is bitwise P's. 8 + 8 xent launches
    (in the last stage's worker, summed in the driver) every completed
    step. Returns the run's xent launches."""
    phase("graph train on worker processes (qwen3-1.7b widths, zero, bf16, "
          "dynamic loss scale; uninterrupted P, snapshot-and-kill K, "
          "restored R; one session at a time)")
    from repro_torch import api
    from repro_torch.core.lowering import OptimizerSpec
    from repro_torch.runtime.base import WorkerError
    from repro_torch.runtime.chaos import KILL_EXIT_CODE, FaultPlan, KillWorker
    from repro_torch.runtime.snapshot import latest_snapshot, step_dir
    g = qwen3_width_graph()
    params, data = seeded_graph_inputs(g, SEED + 9)
    n = sum(v.size for v in params.values())
    want_bytes = 12 * n
    root = tempfile.mkdtemp(prefix="graph-processes-")
    common = dict(mode="train", params=params, num_microbatches=GRAPH_M,
                  optimizer=OptimizerSpec.adamw(lr=3e-4, grad_clip=1.0),
                  device=dev, zero=True, precision="bf16",
                  loss_scale="dynamic", backend="actors",
                  stages=GRAPH_STAGES, regs="1f1b", runtime="processes")
    batch = {k: torch.as_tensor(v, device=dev) for k, v in data.items()}
    zero_xent_counts()
    fps, walls = {}, {}

    def compiled(name, **kw):
        t = time.perf_counter()
        sess = api.compile(g, **common, **kw)
        rt = sess.executor.runtime      # the workers start here
        print(f"{name}: compiled and {len(rt.workers)} workers started in "
              f"{time.perf_counter() - t:.1f} s (workers alone "
              f"{rt.start_seconds:.1f} s)")
        return sess, rt

    def step(name, sess, k):
        before = xent_counts()
        t = time.perf_counter()
        res = sess.step(**batch)
        walls[name, k] = time.perf_counter() - t
        t = time.perf_counter()
        fp = session_fingerprint(sess, res)
        t_fp = time.perf_counter() - t
        per = {key: v - before[key] for key, v in xent_counts().items()}
        rt = sess.executor.runtime
        longest = sorted(((e - b, a) for a, spans in
                          sess.executor.last_history.items()
                          for b, e in spans), reverse=True)[:3]
        print(f"{name} step {k}: loss {fp['loss']:.6f}, loss_scale "
              f"{fp['loss_scale']}, wall {walls[name, k]:.3f} s (the "
              f"fingerprint {t_fp:.3f} s more), xent launches {per}; the "
              "workers' seconds copying ctx / in the epoch "
              + ", ".join(f"{n_} {i['own_s']:.2f}/{i['epoch_s']:.2f}"
                          for n_, i in sorted(rt.last_worker_stats.items()))
              + "; the longest fires " + ", ".join(
                  f"{a} {d:.3f} s" for d, a in longest))
        if per != {"xent_local_stats": GRAPH_M,
                   "xent_local_stats_bwd": GRAPH_M}:
            raise AssertionError(f"{name} step {k}: xent launches {per}, "
                                 f"expected {GRAPH_M} + {GRAPH_M}")
        return fp

    try:
        free = shutil.disk_usage(root).free
        print(f"snapshot directory {root}: {free:,} bytes free; K writes "
              f"two snapshots of {want_bytes:,}, asked for 2.5 of them")
        if free < 2.5 * want_bytes:
            raise AssertionError(f"graph processes: {free:,} bytes free "
                                 f"under {root}")
        sess, rt = compiled("P")
        worker_lines(rt, dev)
        try:
            for k in range(1, GRAPH_STEPS + 1):
                fps[k] = step("P", sess, k)
                held_to(f"P step {k} vs the threads run U", fps[k],
                        threads["fp"][k])
            peaks = {n_: info["peak_bytes"]
                     for n_, info in rt.last_worker_stats.items()}
        finally:
            sess.close()
        all_stopped(rt, "P")
        print("P: worker peak memory " + ", ".join(
            f"node {n_} {b / 2**30:.2f} GiB" for n_, b in sorted(
                peaks.items())))
        gc.collect()
        torch.cuda.empty_cache()

        kill = KillWorker("b1", fire=2 * GRAPH_M + 3)
        sess, rt = compiled("K", snapshot_dir=root, snapshot_every=1,
                            faults=FaultPlan([kill]))
        killed = None
        try:
            for k in (1, 2):
                held_to(f"K step {k} vs P", step("K", sess, k), fps[k])
            hist = sess.executor.last_history
            writes = {a: round(e - b, 3) for a, spans in hist.items()
                      if a.startswith("snap") for b, e in spans}
            print(f"K: snapshot step walls {walls['K', 1]:.3f} / "
                  f"{walls['K', 2]:.3f} s, each stage written from its own "
                  f"worker (the snap actors' seconds in step 2: {writes}), "
                  f"beside P's {walls['P', 2]:.3f} s and the threads "
                  f"phase's snapshot step {threads['k_wall']:.3f} s (U "
                  f"{threads['u_wall']:.3f} s) in this run; "
                  f"{dir_bytes(step_dir(root, 2)):,} bytes on disk a "
                  f"snapshot; {smi}")
            before = xent_counts()
            try:
                sess.step(**batch)
            except WorkerError as e:
                killed = e
        finally:
            sess.close()
        if killed is None:
            raise AssertionError("K step 3 was not killed")
        node = rt._spec_by_name["b1"].node
        print(f"K step 3: {type(killed).__name__}: {killed} (node "
              f"{killed.node}; xent launches counted before the kill "
              f"{ {k: v - before[k] for k, v in xent_counts().items()} })")
        if killed.node != node or \
                f"exit code {KILL_EXIT_CODE}" not in str(killed):
            raise AssertionError(f"K: the kill of node {node} was reported "
                                 f"as {killed!r}")
        if rt._procs[node].exitcode != KILL_EXIT_CODE:
            raise AssertionError(f"K: node {node} exited with "
                                 f"{rt._procs[node].exitcode}")
        all_stopped(rt, "K")
        if latest_snapshot(root) != 2:
            raise AssertionError(f"latest snapshot {latest_snapshot(root)}"
                                 ", expected 2")
        gc.collect()
        torch.cuda.empty_cache()

        t = time.perf_counter()
        sess, rt = compiled("R", restore=root)
        print(f"R: compile(restore=) with the workers started "
              f"{time.perf_counter() - t:.1f} s; step_count "
              f"{sess.step_count}, loss scale {sess.executor.loss_scale}")
        try:
            if sess.step_count != 2:
                raise AssertionError(f"R: step_count {sess.step_count}")
            held_to("R step 3 vs P's", step("R", sess, 3), fps[3])
        finally:
            sess.close()
        all_stopped(rt, "R")
        total = xent_counts()
        print(f"graph processes: xent launches over the run {total} "
              f"(P {GRAPH_STEPS}, K 2 and R 1 completed steps, and K's "
              f"launches before the kill); driver peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        return total
    finally:
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# The static plan verifier: every compile of the run is checked
# (``check="static"``, the default), and phase 12 reads what it recorded.
# ---------------------------------------------------------------------------

#: one entry per static check the run's compiles made: what was compiled,
#: the verdict and passes, the check's and its compile's seconds, the bytes
#: the check allocated on the card and whether it launched a kernel
STATIC_CHECKS = []
#: seconds the static_check phase may take (the bad plans and the CLI)
STATIC_PHASE_S = 30.0


def session_label(sess) -> str:
    """What a compiled session is, for the static check's lines: mode,
    model or graph, backend, stages, cache or ZeRO, mesh, runtime."""
    if sess.mode == "serve":
        what = (f"serve {sess.cfg.name} {sess.backend}"
                f" {sess.sstaged.num_stages} stages {sess.cache}")
        meshes = [] if sess.sstaged.mesh is None else [sess.sstaged.mesh]
    else:
        stages = (f" {sess.partition.num_stages} stages"
                  if sess.partition is not None else "")
        what = f"{sess.mode} graph {sess.backend}{stages}"
        if sess.optimizer is not None and sess.optimizer.zero:
            what += " zero"
        meshes = sess.meshes
    if len(meshes) > 1:
        what += f" on {len(meshes)} stage meshes"
    elif meshes and meshes[0].size > 1:
        what += f" on a {tuple(meshes[0].shape)} mesh"
    if sess.runtime is not None:
        what += f" ({sess.runtime})"
    return what


def watch_static_checks() -> None:
    """Wrap ``repro_torch.analysis.run_session_checks``, which every
    ``api.compile`` runs before it returns, and ``api.compile``: each
    compile then prints its check's verdict, passes and seconds beside the
    compile's seconds, and the bytes the check allocated on the card
    (``memory_allocated`` before and after, the card synchronized) and
    whether it launched a kernel (every launch counter before and after).
    A check that allocates or launches fails the run there."""
    from repro_torch import analysis, api
    from repro_torch.kernels import counters
    run_checks, compile_ = analysis.run_session_checks, api.compile

    def checked(sess):
        torch.cuda.synchronize()
        mem, launches = torch.cuda.memory_allocated(), counters.snapshot()
        t = time.perf_counter()
        report = run_checks(sess)
        seconds = time.perf_counter() - t
        torch.cuda.synchronize()
        STATIC_CHECKS.append({
            "what": session_label(sess), "verdict": report.verdict,
            "passes": report.passes, "check_s": seconds,
            "bytes": torch.cuda.memory_allocated() - mem,
            "launched": counters.snapshot() != launches,
            "bound": dict(report.peak_bytes_per_device)})
        return report

    def compiled(*args, **kw):
        n = len(STATIC_CHECKS)
        t = time.perf_counter()
        try:
            return compile_(*args, **kw)
        finally:
            if len(STATIC_CHECKS) > n:
                e = STATIC_CHECKS[-1]
                e["compile_s"] = time.perf_counter() - t
                print(f"static check of {e['what']}: {e['verdict']} "
                      f"({', '.join(e['passes'])}) in "
                      f"{e['check_s'] * 1e3:.2f} ms of a "
                      f"{e['compile_s']:.3f} s compile (host); "
                      f"{e['bytes']} B allocated on the card, "
                      f"{'a' if e['launched'] else 'no'} kernel launched")
                if e["bytes"] or e["launched"]:
                    raise AssertionError(f"the static check of {e['what']} "
                                         "touched the card")

    analysis.run_session_checks = checked
    api.compile = compiled


def tensor_bytes(tree) -> int:
    """Bytes of every tensor in a cache tree (dicts and lists of tensors),
    each checked to lie on the card."""
    if torch.is_tensor(tree):
        if tree.device.type != "cuda":
            raise AssertionError(f"a cache tensor on {tree.device}")
        return tree.nbytes
    values = tree.values() if isinstance(tree, dict) else tree
    return sum(tensor_bytes(v) for v in values)


def cache_bound_vs_held(sess, what: str) -> None:
    """Each stage's cache term of the static serve bound
    (``membound.serve_cache_bound``, the reference's count) beside the
    bytes its actor's cache holds on the card after the run. Dense: the
    group blocks, which must equal the term (every group was used). Paged:
    the term is the pages plus the page table and cursors (int32, which
    the port keeps on the host); the pages on the card must equal it less
    those, and the slabs' two sentinel rows each, which the count leaves
    out, are printed beside it."""
    from repro_torch.analysis import membound
    terms = membound.serve_cache_bound(sess.sstaged, sess.num_groups,
                                       sess.cache, sess.cache_spec)
    bound = sess.static_report.peak_bytes_per_device
    for s, cache in enumerate(sess.executor.stage_caches):
        name = f"stage{s}"
        term = terms[name]
        if sess.cache == "dense":
            held = tensor_bytes(list(cache.caches.values()))
            print(f"{what} {name}: bound {bound[name]:,} B, of it the cache "
                  f"term {term:,} B; the group caches hold {held:,} B on "
                  "the card")
            if held != term:
                raise AssertionError(f"{what} {name}: cache term {term} != "
                                     f"held {held}")
            continue
        spec = sess.cache_spec
        index = spec.max_requests * (spec.pages_per_req + 2) * 4
        pages = tensor_bytes(cache.pages())
        slabs = tensor_bytes(cache.slabs)
        print(f"{what} {name}: bound {bound[name]:,} B, of it the cache "
              f"term {term:,} B = pages {term - index:,} + page table and "
              f"cursors {index:,} (host-side in the port); the pages hold "
              f"{pages:,} B on the card, the slabs {slabs:,} B with their "
              f"sentinel rows ({slabs - pages:,} B the count leaves out)")
        if pages != term - index:
            raise AssertionError(f"{what} {name}: pages {pages} != the "
                                 f"cache term's {term - index}")


def zero_bound_vs_held(sess, res, what: str) -> None:
    """Each parameterized stage's ``train_memory_bound`` beside the bytes
    its float32 masters and moments (their storages) and its float32
    gradient sums (the accumulator's size, read from the step's result)
    hold on the card; the bound must be at least that."""
    eng = sess.executor
    bound = sess.static_report.peak_bytes_per_device
    grads = res.grads
    for st in eng.tstaged.stages:
        name = f"stage{st.index}"
        if not st.param_names:
            print(f"{what} {name}: bound {bound[name]:,} B (its activation "
                  "and cotangent registers; no params)")
            continue
        ranks = eng.opt_states[st.index]
        moments = max(sum(t.untyped_storage().nbytes() for t in
                          (*rs.mu.values(), *rs.nu.values())) for rs in ranks)
        masters = max(sum(eng.shards[n][r].untyped_storage().nbytes()
                          for n in st.param_names)
                      for r in range(st.mesh.size))
        acc = sum(grads[n].nbytes for n in st.param_names)
        if any(grads[n].dtype != torch.float32 for n in st.param_names):
            raise AssertionError(f"{what} {name}: gradients not float32")
        held = masters + moments + acc
        print(f"{what} {name}: bound {bound[name]:,} B; held on the card: "
              f"masters {masters:,} + moments {moments:,} + float32 "
              f"gradient sums {acc:,} = {held:,} B "
              f"({held / bound[name]:.4f} of the bound)")
        if not 0 < held <= bound[name]:
            raise AssertionError(f"{what} {name}: held {held} exceeds the "
                                 f"bound {bound[name]}")


def static_check(dev, smi: str) -> dict:
    """Phase 12: every compile of the run passed its static check without
    touching the card (the summary of :data:`STATIC_CHECKS`); a small graph
    on the card whose sink leaks a partial value, and a quota vector with
    a zero, are stopped at compile time -- the first with an
    ``AnalysisError`` naming the sink, the second naming the minimal
    feasible quotas -- before any actor engine starts an epoch and with no
    kernel launched; and the CLI on two zoo configs (its milliseconds are
    host time). Returns the summary."""
    phase("static check (the plan verifier: every compile, bad plans, CLI)")
    t_phase = time.perf_counter()
    from repro_torch import analysis, api
    from repro_torch.core.graph import LogicalGraph
    from repro_torch.core.placement import Placement
    from repro_torch.core.planner import plan as plan_sbp
    from repro_torch.core.sbp import NdSbp
    from repro_torch.kernels import counters
    from repro_torch.runtime.threaded import _LocalEngine
    import dataclasses
    checks = list(STATIC_CHECKS)
    bad = [e for e in checks if e["verdict"] != "PASS" or e["bytes"]
           or e["launched"]]
    kinds = sorted({e["what"] for e in checks})
    ms = sorted(e["check_s"] * 1e3 for e in checks)
    print(f"{len(checks)} compiles checked, {len(kinds)} kinds of session, "
          f"all PASS with 0 B and no launch: {not bad}; check ms (host) "
          f"median {ms[len(ms) // 2]:.2f}, max {ms[-1]:.2f}, total "
          f"{sum(ms):.1f}")
    for kind in kinds:
        got = [e for e in checks if e["what"] == kind]
        print(f"  {kind}: {len(got)} x, passes {', '.join(got[0]['passes'])}"
              f", check {max(e['check_s'] for e in got) * 1e3:.2f} ms max, "
              f"compile {max(e['compile_s'] for e in got):.3f} s max")
    if bad or not checks:
        raise AssertionError(f"static checks failed or touched the card: "
                             f"{bad[:3]}")

    g = LogicalGraph(Placement(("d",), (1,)))
    h = g.input("x", (64, 256))
    labels = g.input("labels", (64,), dtype="int32")
    for i in range(2):
        h = g.matmul(h, g.input(f"w{i}", (256, 256)), name=f"mm{i}")
    g.softmax_xent(h, labels, name="loss")
    rng = np.random.default_rng(SEED + 12)
    params = {f"w{i}": (rng.standard_normal((256, 256)) / 16).astype(
        np.float32) for i in range(2)}
    planned = plan_sbp(g)
    sink = g.sinks()[0].name
    leaky = dataclasses.replace(
        planned, tensor_sbp={**planned.tensor_sbp, sink: NdSbp.parse("P")},
        boxings=[b for b in planned.boxings if b[1] != "__epilogue__"])
    epochs = []
    start_epoch = _LocalEngine.start_epoch
    _LocalEngine.start_epoch = \
        lambda self, *a, **k: epochs.append(self) or start_epoch(self, *a, **k)
    before = counters.snapshot()
    try:
        try:
            api.compile(g, mode="train", params=params, stages=2,
                        num_microbatches=2, plan=leaky, device=dev)
            raise AssertionError("the leaky plan compiled")
        except analysis.AnalysisError as e:
            print(f"leaky sink: AnalysisError: {e}")
            if sink not in str(e) or "leaks through a graph sink" \
                    not in str(e):
                raise AssertionError("the error does not name the sink")
        try:
            api.compile(g, mode="train", params=params, stages=2,
                        num_microbatches=2, regs=[1, 0], device=dev)
            raise AssertionError("regs=[1, 0] compiled")
        except ValueError as e:
            print(f"regs=[1, 0]: ValueError: {e}")
            if "minimal feasible quotas for 2 stages: [1, 1]" not in str(e):
                raise AssertionError("the error does not name the minimal "
                                     "feasible quotas")
    finally:
        _LocalEngine.start_epoch = start_epoch
    if epochs or counters.snapshot() != before:
        raise AssertionError(f"a bad plan fired: {len(epochs)} epochs "
                             "started, or a kernel launched")
    print("both bad plans stopped at compile time: no actor epoch started, "
          "no kernel launched")

    cli = {}
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t = time.perf_counter()
    procs = {args[0]: (args, subprocess.Popen(
        [sys.executable, "-m", "repro_torch.analysis", *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env))
        for args in (["deepseek-v3-671b", "--stages", "8"],
                     ["qwen3-1.7b", "--stages", "4"])}
    for name, (args, proc) in procs.items():
        try:
            out, err = proc.communicate(timeout=120)
        finally:
            proc.kill()
        print(f"python -m repro_torch.analysis {' '.join(args)}: exit "
              f"{proc.returncode}, read {time.perf_counter() - t:.2f} s after "
              "both CLIs started together (host time, the interpreters' "
              "start included)")
        print("\n".join("  " + ln for ln in out.splitlines()))
        if proc.returncode != 0 or "static analysis: PASS" not in out:
            raise AssertionError(f"the CLI on {name} failed: {err[-2000:]}")
        cli[name] = float(out.rsplit("analyzer wall time: ", 1)[1].split()[0])
    took = time.perf_counter() - t_phase
    print(f"static check phase: {took:.1f} s (limit {STATIC_PHASE_S:.0f} "
          f"s); the analyzer's own ms (host): {cli}; {smi}")
    if took > STATIC_PHASE_S:
        raise AssertionError(f"the static check phase took {took:.1f} s")
    return {"checks": len(checks), "cli_ms": cli}


# ---------------------------------------------------------------------------
# the frontend architectures: whisper-medium (an encoder-decoder) and
# pixtral-12b (an embed frontend), served through the reference's classic
# loop and whisper trained through make_train_step
# ---------------------------------------------------------------------------

WHISPER, PIXTRAL = "whisper-medium", "pixtral-12b"
WHISPER_ENC = "flash_attention (non-causal, whisper encoder)"
WHISPER_ENC_BWD = "flash_attention_bwd (non-causal, whisper encoder)"
WHISPER_CROSS = "flash_attention (cross, whisper decoder)"
WHISPER_CROSS_BWD = "flash_attention_bwd (cross, whisper decoder)"
WHISPER_XDECODE = "flash_decode (whisper cross cache)"
WHISPER_XENT = " (whisper vocab)"
# the classic loop's geometry: 4 prompts of 32 tokens (or patch
# embeddings), 16 new tokens; whisper's 1,500 encoder frames
CLASSIC_B, CLASSIC_PROMPT, CLASSIC_GEN = 4, 32, 16
# whisper's training: 2 x 448 decoder tokens (its context) over 2 x 1,500
# frames, 4 steps on the kernels, then 2 on the plain versions
WHISPER_B, WHISPER_S, WHISPER_PLAIN_STEPS = 2, 448, 2


def check_whisper_kernels(dev):
    """The kernels at whisper-medium's shapes: the attention forward and
    backward non-causal at the encoder's q/k/v (2, 1500, 16, 64) and as
    cross-attention at q (2, 448, 16, 64) over k/v (2, 1500, 16, 64), bf16
    on the tensor cores and on float32 copies, the float32 kernels at the
    same shapes and at small ragged ones within 1e-4; the decode kernel
    over the cross cache, q (4, 16, 64), cache (4, 1500, 16, 64) bf16,
    every row at ``cur_pos`` 1499 (its mask then passes every key, as the
    reference's non-causal dense attention); the xent kernels at its
    training logits (896 x 51,968)."""
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_decode import kernel as fd
    phase("kernels (whisper-medium: non-causal and cross attention, the "
          "cross-cache decode, its vocabulary)")
    enc = {"name": WHISPER_ENC, **ATTENTION_ROW}
    enc.update(attention_row(dev, 2, 1500, 16, 16, 64, SEED + 41,
                             causal=False))
    enc_bwd = check_flash_attention_bwd(
        dev, H=16, KV=16, seed=SEED + 42, name=WHISPER_ENC_BWD, D=64,
        S=1500, causal=False)
    cross = {"name": WHISPER_CROSS, **ATTENTION_ROW}
    cross.update(attention_row(dev, 2, 448, 16, 16, 64, SEED + 43, Sk=1500,
                               causal=False))
    cross_bwd = check_flash_attention_bwd(
        dev, H=16, KV=16, seed=SEED + 44, name=WHISPER_CROSS_BWD, D=64,
        S=448, Sk=1500, causal=False)
    # float32 on the CUDA-core kernels at small ragged shapes (GQA 2)
    rng = np.random.default_rng(SEED + 45)
    for row, (Sq, Sk) in ((enc_bwd, (300, 300)), (cross_bwd, (37, 300))):
        q, do = (torch.from_numpy(rng.normal(size=(2, Sq, 4, 64)).astype(
            np.float32)).to(dev) for _ in range(2))
        k, v = (torch.from_numpy(rng.normal(size=(2, Sk, 2, 64)).astype(
            np.float32)).to(dev) for _ in range(2))

        def grads(attn):
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            return torch.autograd.grad(attn(*leaves, causal=False), leaves,
                                       do)
        n0 = (fa.bwd_dq_launches, fa.bwd_dq_wgmma_launches)
        got = grads(fa.flash_attention)
        torch.cuda.synchronize()
        if (fa.bwd_dq_launches - n0[0], fa.bwd_dq_wgmma_launches - n0[1]) \
                != (1, 0):
            raise AssertionError("flash_attention backward float32 did not "
                                 "run the CUDA-core kernels once")
        row["f32_max_abs_err_small"] = max(agree(
            f"flash_attention backward d{n} float32 q{tuple(q.shape)} "
            f"kv{tuple(k.shape)} {mask_name(False, Sq, Sk)}", a, b, F32_TOL,
            F32_TOL) for n, a, b in zip("qkv", got, grads(
                fa.plain_flash_attention)))
    B, H, KV, D, L = 4, 16, 16, 64, 1500
    rng = np.random.default_rng(SEED + 46)
    mk = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.normal(size=shape).astype(np.float32)).to(dev, torch.bfloat16)
    q, k, v = mk(B, H, D), mk(B, L, KV, D), mk(B, L, KV, D)
    cur = torch.full((B,), L - 1, dtype=torch.int32, device=dev)
    xdec = decode_row({
        "name": WHISPER_XDECODE, **DECODE_ROW,
        "splits": fd.split_plan(B, KV, L, fd.sm_count(q.device))},
        q, k, v, cur, f"flash_decode q{tuple(q.shape)} cross cache"
        f"{tuple(k.shape)} cur_pos {L - 1}")
    torch.cuda.empty_cache()
    from repro_torch.configs.registry import get_config
    xent = check_xent(dev, Vl=get_config(WHISPER).padded_vocab(),
                      label=WHISPER_XENT, N=WHISPER_B * WHISPER_S)
    return [enc, enc_bwd, cross, cross_bwd, xdec, *xent]


def check_reference_classic(dev, arch: str):
    """Reduced ``arch`` (float32) through the kernels on the card against
    the same weights on the CPU's plain path, through ``make_serve_step``
    (the classic loop's whole-model prefill and decode): the first
    token's logits, then two decode steps fed the CPU's greedy tokens,
    within 1e-3 (the reduced qwen3 check's limit). Every attention forward
    on the float32 CUDA-core kernel, the decodes on the decode kernel
    (whisper's cross-attention over its 64-frame cache at ``cur_pos`` 63)."""
    phase(f"reference (reduced {arch}, classic loop, card vs CPU plain path)")
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_decode import kernel as fd
    from repro_torch.launch.serve import classic_batch
    from repro_torch.models.common import MeshPlan
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train.steps import greedy_from_logits, make_serve_step

    cfg = get_config(arch).reduced()
    batch = classic_batch(cfg, 2, 37, np.random.default_rng(SEED + 13))
    init = build_model(cfg, MeshPlan.single_device(), seed=SEED,
                       device="cpu")
    out = {}
    for d in ("cpu", dev):
        ss = make_serve_step(cfg, cache_len=48, device=d)
        model = init.to(d)
        zero_serve_counts()
        fa.reset_counts()
        h, caches = ss.prefill_fn(model, batch)
        steps = [ss.logits_fn(model, h).float().cpu()]
        pos = torch.full((2,), 37, dtype=torch.int32, device=d)
        for _ in range(2):
            tok = greedy_from_logits(out["cpu"][len(steps) - 1] if d != "cpu"
                                     else steps[-1], cfg.vocab_size).to(d)
            logits, caches = ss.decode_fn(model, caches, tok, pos)
            steps.append(logits.float().cpu())
            pos = pos + 1
        out[d] = steps
    torch.cuda.synchronize()
    worst = 0.0
    for i, (a, b) in enumerate(zip(out[dev], out["cpu"])):
        err = (a - b).abs().max().item()
        worst = max(worst, err)
        if not torch.allclose(a, b, rtol=1e-3, atol=1e-3):
            raise AssertionError(f"reduced {arch} classic loop, "
                                 f"{'first token' if i == 0 else f'decode {i}'}"
                                 f": card and CPU disagree ({err:.3e})")
    xattn = cfg.num_layers if cfg.encoder_decoder else 0
    want_fa = cfg.num_layers + xattn + (cfg.num_encoder_layers
                                        if cfg.encoder_decoder else 0)
    want = (want_fa, 0, 2 * (cfg.num_layers + xattn))
    got = (fa.launches, fa.wgmma_launches, fd.launches)
    if got != want:
        raise AssertionError(f"reduced {arch} classic loop: (attention, "
                             f"tensor-core, decode) launches {got}, "
                             f"expected {want}")
    print(f"reduced {arch} classic loop, prefill + 2 decode steps: logits "
          f"agree, max abs err {worst:.3e} (bound 1e-3 + 1e-3*|ref|, "
          f"float32); launches (attention, of them tensor-core, decode) "
          f"{got}, by mask {dict(fa.mask_launches)}, decode by cache "
          f"length {dict(fd.length_launches)}")


def classic_counts():
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_decode import kernel as fd
    return {**serve_counts(), "by_mask": dict(fa.mask_launches),
            "decode_by_length": dict(fd.length_launches)}


def serve_classic(dev, arch: str):
    """``arch`` at full width and depth in bf16 (the port's seeded init,
    drawn in bf16 on the card: pixtral's 12.2 B params are 24.5 GB, a
    float32 build and cast would peak near 73 GB) through the port's
    ``classic_loop`` (``make_serve_step``): 4 prompts of 32 tokens (pixtral:
    patch embeddings; whisper: over 1,500 frame embeddings too), 16 new
    tokens. Its launches are counted from zero, exactly: a prefill runs
    one attention forward a decoder layer (whisper: and one a cross layer,
    one an encoder layer: 24 causal + 24 cross + 24 non-causal), every one
    on the tensor cores; a decode step one decode a decoder layer (whisper:
    and one over its cross cache). Prefill seconds and tok/s (the loop's
    lines), the peak memory, the idle share of a profiled run; then the
    first token's logits and one decode step's against the same calls on
    the plain versions, within ``MESH_LOGITS_ATOL`` + ``MESH_LOGITS_RTOL``
    (the serve phases' bf16 limits). Returns the run's launches."""
    import argparse

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.launch.serve import classic_batch, classic_loop
    from repro_torch.train.steps import greedy_from_logits, make_serve_step
    cfg = get_config(arch)
    frames = (f", {cfg.encoder_seq:,} encoder frames"
              if cfg.encoder_decoder else "")
    phase(f"serve classic ({arch}, full width and depth, bf16, batch "
          f"{CLASSIC_B}, prompt {CLASSIC_PROMPT}{frames}, gen {CLASSIC_GEN})")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, model = seeded_model(arch, dev)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    held = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"seeded {n:,} params ({held / 2**30:.2f} GiB in bf16) in "
          f"{time.perf_counter() - t0:.1f} s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    args = argparse.Namespace(batch=CLASSIC_B, prompt_len=CLASSIC_PROMPT,
                              gen=CLASSIC_GEN, cache_len=0, seed=SEED,
                              device=dev, mesh="1x1")
    zero_serve_counts()
    fa.reset_counts()
    t0 = time.perf_counter()
    gen = classic_loop(cfg, args, params=model)
    wall = time.perf_counter() - t0
    counts = classic_counts()
    L, enc = cfg.num_layers, cfg.num_encoder_layers if cfg.encoder_decoder \
        else 0
    cross = L if cfg.encoder_decoder else 0
    cache_len = CLASSIC_PROMPT + CLASSIC_GEN + 8
    want = {"flash_attention": L + cross + enc,
            "flash_fwd_wgmma_kernel": L + cross + enc,
            "flash_decode": CLASSIC_GEN * (L + cross), "ssd_scan": 0,
            "ssd_scan_wgmma": 0,
            "by_mask": {"causal": L, "non_causal": enc, "cross": cross},
            "decode_by_length": {cache_len: CLASSIC_GEN * L,
                                 **({cfg.encoder_seq: CLASSIC_GEN * cross}
                                    if cross else {})}}
    print(f"{arch} classic loop: {wall:.2f} s in all; launches {counts}; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if counts != want:
        raise AssertionError(f"{arch} classic loop: launches {counts}, "
                             f"expected {want}")
    if not (gen < cfg.vocab_size).all():
        raise AssertionError(f"{arch}: an id past the vocabulary")
    profile_device(f"{arch} classic loop", lambda: classic_loop(
        cfg, args, params=model), cpu=False)
    # the first token's logits and one decode step's, kernels vs plain
    ss = make_serve_step(cfg, cache_len=cache_len, device=dev)
    batch = classic_batch(cfg, CLASSIC_B, CLASSIC_PROMPT,
                          np.random.default_rng(SEED))
    pos = torch.full((CLASSIC_B,), CLASSIC_PROMPT, dtype=torch.int32,
                     device=dev)

    def first_two(tok=None):
        h, caches = ss.prefill_fn(model, batch)
        first = ss.logits_fn(model, h).float()
        tok = greedy_from_logits(first, cfg.vocab_size) if tok is None \
            else tok
        nxt, _ = ss.decode_fn(model, caches, tok, pos)
        return first, nxt.float(), tok
    first, nxt, tok = first_two()
    with plain_versions():
        p_first, p_nxt, _ = first_two(tok)
    for what, a, b in (("first-token", first, p_first),
                       ("decode step", nxt, p_nxt)):
        err = (a - b).abs().max().item()
        ok = torch.allclose(a, b, atol=MESH_LOGITS_ATOL, rtol=MESH_LOGITS_RTOL)
        print(f"{arch} {what} logits, kernels vs plain versions: max abs err "
              f"{err:.3e}, scale {b.abs().max().item():.2f} (limit atol "
              f"{MESH_LOGITS_ATOL} + rtol {MESH_LOGITS_RTOL}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{arch}: {what} logits left the plain "
                                 "versions'")
    del model, ss
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def train_whisper(dev):
    """whisper-medium at full width and depth (24 encoder and 24 decoder
    layers, 1,012,523,008 params) through ``make_train_step`` with ZeRO at
    1 x 1 (the default: bf16 compute over float32 masters and moments,
    remat), 4 steps of 2 x 448 decoder tokens over 2 x 1,500 frame
    embeddings, numpy-seeded: every step's launches held (each attention's
    forward and its remat rerun, 144, on the tensor cores: 48 causal, 48
    non-causal, 48 cross; a backward call an attention, 72, whose dq and
    dk/dv kernels are 48 non-causal; the xent kernels once each way),
    wall, tokens/s, peak memory and one profiled step; step 1's loss and
    gradients computed twice, bitwise equal (the encoder's gradient sums
    its 24 cross-attentions in the tape's one order); then the same init
    and batches through the plain versions for ``WHISPER_PLAIN_STEPS``
    steps, the loss curves held as the qwen3 train phases hold them.
    Returns the kernel run's launches (by mask too)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.launch.serve import classic_batch
    from repro_torch.train.steps import make_train_step
    cfg = get_config(WHISPER)
    steps = TRAIN_STEPS
    phase(f"train ({WHISPER}, full width and depth, ZeRO 1 x 1, bf16 "
          f"compute, float32 masters and moments, {steps} steps of "
          f"{WHISPER_B} x {WHISPER_S} tokens over {WHISPER_B} x "
          f"{cfg.encoder_seq:,} frames), then {WHISPER_PLAIN_STEPS} steps on "
          "the plain versions")
    rng = np.random.default_rng(SEED + 17)
    batches = [classic_batch(cfg, WHISPER_B, WHISPER_S, rng, "train")
               for _ in range(steps + 1)]
    L, E = cfg.num_layers, cfg.num_encoder_layers
    n_attn = 2 * L + E
    want = dict.fromkeys(train_counts(), 0)
    want.update({"flash_attention": 2 * n_attn,
                 "flash_fwd_wgmma_kernel": 2 * n_attn,
                 "flash_bwd_dq_kernel": n_attn, "flash_bwd_dkdv_kernel": n_attn,
                 "flash_bwd_dq_wgmma_kernel": n_attn,
                 "flash_bwd_dkdv_wgmma_kernel": n_attn,
                 "xent_local_stats": 1, "xent_local_stats_bwd": 1})
    want_mask = ({"causal": 2 * L, "non_causal": 2 * E, "cross": 2 * L},
                 {"causal": L, "non_causal": E, "cross": L})

    def run(what: str, n_steps: int, want, want_mask):
        t0 = time.perf_counter()
        ts = make_train_step(cfg, device=dev)
        params = ts.init_params(SEED)
        opt = ts.init_opt(params)
        torch.cuda.synchronize()
        print(f"{what}: {params.numel():,} float32 master elements and "
              f"their moments initialised in "
              f"{time.perf_counter() - t0:.1f} s")
        torch.cuda.reset_peak_memory_stats()
        zero_train_counts()
        fa.reset_counts()
        curve = []
        for step in range(n_steps):
            prev = train_counts()
            prev_mask = (dict(fa.mask_launches), dict(fa.bwd_mask_launches))
            t = time.perf_counter()
            params, opt, m = ts.step_fn(params, opt, batches[step])
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            now = train_counts()
            per = {k: now[k] - prev[k] for k in now}
            per_mask = tuple({k: c[k] - p[k] for k in c} for c, p in zip(
                (fa.mask_launches, fa.bwd_mask_launches), prev_mask))
            curve.append((loss, gnorm))
            print(f"{what} step {step}: loss {loss:.4f}, grad_norm "
                  f"{gnorm:.4f}, wall {wall:.3f} s, "
                  f"{WHISPER_B * WHISPER_S / wall:,.0f} decoder tokens/s, "
                  f"launches {per}, by mask forward {per_mask[0]}, "
                  f"backward {per_mask[1]}")
            if per != want or (want_mask and per_mask != want_mask):
                raise AssertionError(f"{what} step {step}: launches {per} "
                                     f"{per_mask}, expected {want} "
                                     f"{want_mask}")
        print(f"{what}: peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if not all(np.isfinite(curve).ravel()):
            raise AssertionError(f"{what}: (loss, grad_norm) {curve}")
        return ts, params, opt, curve

    ts, params, opt, curve = run(f"{WHISPER} kernels", steps, want,
                                 want_mask)
    total = {**train_counts(), "by_mask": dict(fa.mask_launches),
             "bwd_by_mask": dict(fa.bwd_mask_launches)}
    profile_device(f"{WHISPER} train step", lambda: float(
        ts.step_fn(params, opt, batches[steps])[2]["loss"]), top=10)
    # step 1's loss and gradients, twice: bitwise
    loss_a, g_a = ts.grad_fn(params, batches[1])
    loss_b, g_b = ts.grad_fn(params, batches[1])
    same = bool(torch.equal(loss_a, loss_b)) and all(
        torch.equal(g_a[n], g_b[n]) for n in g_a)
    print(f"{WHISPER}: step 1's loss and {len(g_a)} gradients computed "
          f"twice: bitwise equal {same}")
    if not same:
        raise AssertionError(f"{WHISPER}: two runs of step 1 differ")
    del ts, params, opt, g_a, g_b
    gc.collect()
    torch.cuda.empty_cache()
    with plain_versions():
        *_, plain = run(f"{WHISPER} plain", WHISPER_PLAIN_STEPS,
                        dict.fromkeys(train_counts(), 0), None)
    gc.collect()
    torch.cuda.empty_cache()
    held_curves(f"{WHISPER} kernels vs plain", curve, plain)
    return total


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs an "
              "NVIDIA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")
    dev = "cuda"
    smi = device_and_build()
    watch_static_checks()
    phase("kernels (path shapes)")
    kernels = [check_flash_attention(dev), check_flash_decode(dev),
               *check_mesh_kernels(dev), *check_mesh_train_kernels(dev),
               *check_xent(dev),
               *check_xent_graph(dev),
               *check_xent_graph(dev, N=GRAPH_N // GRAPH_M // MESH_SHAPE[0],
                                 V=GRAPH_V // MESH_SHAPE[1],
                                 offset=GRAPH_V // MESH_SHAPE[1],
                                 label="vocab shard"),
               *check_zero_train_kernels(dev),
               *check_xent_graph(dev, dtype="bfloat16"),
               check_flash_attention_bwd(dev), check_ssd_scan(dev),
               check_ssd_scan(dev, H=16, long_prompt=False,
                              name=f"ssd_scan (tp={MAMBA_MESH[1]} local "
                                   "heads)"),
               check_ssd_scan_bwd(dev),
               check_ssd_scan_bwd(dev, H=16,
                                  name=f"ssd_scan_bwd (tp={MAMBA_MESH[1]} "
                                       "local heads)")]
    kernels.append(check_flash_attention_mla(dev))
    kernels += [*check_flash_attention_mla_train(dev),
                *check_xent(dev, Vl=deepseek_vocab(), label=DEEPSEEK_XENT)]
    kernels += check_whisper_kernels(dev)
    kernels[1]["paged_shape"] = check_paged_decode(dev)
    ssd_row = next(k for k in kernels if k["name"] == "ssd_scan")
    for kr in kernels + [dict(kernels[0]["train_shape"],
                              name="flash_attention (training shape)"),
                         kernels[1]["paged_shape"],
                         kernels[1]["long_cache"],
                         dict(ssd_row["long_prompt"],
                              name="ssd_scan (2048-token prompt)")]:
        lib = kr["library_ms"]
        print(f"{kr['name']}: kernel {kr['ms']:.4f} ms, wrapper call "
              f"{kr['wrapper_ms']:.4f} ms, plain {kr['plain_ms']:.4f} "
              f"ms, bound {kr['bound_ms']:.4f} ms ({kr['bound_by']}; "
              f"{kr['bound_share']:.1%} of the kernel's time), library "
              + ("none" if lib is None else
                 f"{lib:.4f} ms (kernel / library {kr['vs_library']:.2f}, "
                 f"call / library {kr['wrapper_vs_library']:.2f})"))
    check_reference(dev)
    check_reference(dev, DEEPSEEK)
    check_reference_train(dev)
    check_reference_train(dev, DEEPSEEK, zero=True)
    check_reference_mamba(dev)
    check_reference_mamba_train(dev)
    check_reference_mamba_train(dev, MAMBA_MESH)
    for arch in (WHISPER, PIXTRAL):
        check_reference_classic(dev, arch)
        check_reference_train(dev, arch, zero=True)
    served, threads_run = serve(dev, "qwen3-1.7b")
    threads_launches = dict(served)
    torch.cuda.empty_cache()
    mamba, _ = serve(dev, "mamba2-370m")
    served.update(ssd_scan=mamba["ssd_scan"],
                  ssd_scan_wgmma=mamba["ssd_scan_wgmma"])
    torch.cuda.empty_cache()
    cfg, model = seeded_model("qwen3-1.7b", dev)
    paths = {}
    paths["serve paged"] = serve_paged(dev, cfg, model)
    chunk_requests, paths["serve chunked"] = serve_chunked(dev, cfg, model)
    paths["serve sampled"] = serve_sampled(dev, cfg, model, chunk_requests)
    torch.cuda.empty_cache()
    proc_served = serve_processes(dev, cfg, model, threads_launches,
                                  threads_run)
    del model, threads_run
    gc.collect()
    torch.cuda.empty_cache()
    meshed = serve_mesh(dev, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    paths["serve paged (mamba2)"] = serve_paged_mamba(dev)
    torch.cuda.empty_cache()
    mamba_meshed = serve_mesh_mamba(dev)
    deepseek = serve_deepseek(dev)
    classic = {arch: serve_classic(dev, arch) for arch in (WHISPER, PIXTRAL)}
    trained, curve = train(dev)
    torch.cuda.empty_cache()
    train_plain(dev, curve)
    torch.cuda.empty_cache()
    mesh_train, cut_curve = train_mesh(dev, curve)
    torch.cuda.empty_cache()
    zero_trained = train_zero(dev, curve, cut_curve)
    torch.cuda.empty_cache()
    deepseek_trained = train_deepseek(dev)
    torch.cuda.empty_cache()
    whisper_trained = train_whisper(dev)
    torch.cuda.empty_cache()
    mamba_trained = train_mamba(dev)
    mamba_mesh_trained = train_mesh_mamba(dev)
    check_graph_reference(dev)
    graph_trained, one_device = graph_train(dev)
    mesh_trained = graph_train_mesh(dev, one_device)
    graph_mp = graph_train_mp(dev, one_device)
    del one_device
    graph_snap, threads_graph = graph_snapshot_resume(dev, smi)
    graph_proc = graph_processes(dev, smi, threads_graph)
    del threads_graph
    graph_infer(dev)
    static_check(dev, smi)
    # each row's launches from the run of its path; the attention forward's
    # row is the serving shape and serve run, its training shape's the train
    # run; the backward's row holds each of its two kernels' counts
    from repro_torch.kernels.ssd_scan.kernel import BWD_TC_KERNELS
    from repro_torch.configs.registry import get_config
    ws, wt = classic[WHISPER], whisper_trained
    frontend_rows = {
        # whisper's serve run (one classic-loop prefill, 16 decode steps)
        # and its train run, by mask; the backward rows by call
        WHISPER_ENC: {"launches": ws["by_mask"]["non_causal"],
                      "launches_by_path": {
                          f"serve classic ({WHISPER})":
                              ws["by_mask"]["non_causal"],
                          f"train ({WHISPER})": wt["by_mask"]["non_causal"]}},
        WHISPER_CROSS: {"launches": ws["by_mask"]["cross"],
                        "launches_by_path": {
                            f"serve classic ({WHISPER})": ws["by_mask"]["cross"],
                            f"train ({WHISPER})": wt["by_mask"]["cross"]}},
        WHISPER_ENC_BWD: {"launches": wt["bwd_by_mask"]["non_causal"],
                          "launches_per_step":
                              wt["bwd_by_mask"]["non_causal"] // TRAIN_STEPS},
        WHISPER_CROSS_BWD: {"launches": wt["bwd_by_mask"]["cross"],
                            "launches_per_step":
                                wt["bwd_by_mask"]["cross"] // TRAIN_STEPS},
        WHISPER_XDECODE: {"launches": ws["decode_by_length"][
            get_config(WHISPER).encoder_seq]},
        "xent_local_stats" + WHISPER_XENT: {
            "launches": wt["xent_local_stats"]},
        "xent_local_stats_bwd" + WHISPER_XENT: {
            "launches": wt["xent_local_stats_bwd"]}}
    for kr in kernels:
        name = kr["name"]
        if name in frontend_rows:
            kr.update(frontend_rows[name])
            continue
        if name == MLA_ROW_NAME:
            # the deepseek-v2-lite serve run (actors), every launch wgmma
            kr["launches"] = deepseek["flash_fwd_wgmma_kernel"]
            continue
        if name in (MLA_TRAIN_FWD, MLA_TRAIN_BWD) or name.endswith(
                DEEPSEEK_XENT):
            # the deepseek-v2-lite train run (4 layers, TRAIN_STEPS steps)
            if name == MLA_TRAIN_BWD:
                kr["launches_by_kernel"] = {
                    k: deepseek_trained[k] for k in (
                        "flash_bwd_dq_wgmma_kernel",
                        "flash_bwd_dkdv_wgmma_kernel")}
                kr["launches"] = min(kr["launches_by_kernel"].values())
            elif name == MLA_TRAIN_FWD:
                kr["launches"] = deepseek_trained["flash_fwd_wgmma_kernel"]
            else:
                kr["launches"] = deepseek_trained[name.split(" ")[0]]
            kr["launches_per_step"] = kr["launches"] // TRAIN_STEPS
            continue
        if name == "ssd_scan_bwd":
            # the mamba2 train run (one device, full depth); the mesh run's
            # beside it, both ranks
            kr["launches_by_kernel"] = {k: mamba_trained[k]
                                        for k in BWD_TC_KERNELS}
            kr["launches"] = min(kr["launches_by_kernel"].values())
            kr["launches_per_step"] = kr["launches"] // TRAIN_STEPS
            kr["launches_by_path"] = {
                "train (mamba2)": kr["launches"],
                f"train mesh {MAMBA_MESH} (mamba2)": min(
                    mamba_mesh_trained[k] for k in BWD_TC_KERNELS)}
            continue
        if name.startswith("ssd_scan_bwd (tp="):
            # the mamba2 mesh train run (full depth): both ranks
            kr["launches_by_kernel"] = {k: mamba_mesh_trained[k]
                                        for k in BWD_TC_KERNELS}
            kr["launches"] = min(kr["launches_by_kernel"].values())
            kr["launches_per_step"] = kr["launches"] // MAMBA_MESH_STEPS
            continue
        if name.startswith("ssd_scan (tp="):
            kr["launches"] = mamba_meshed["ssd_scan"]
            kr["wgmma_launches"] = mamba_meshed["ssd_scan_wgmma"]
            continue
        if "(zero (2, 1) rank" in name:
            # the ZeRO (2, 1) train run, full depth: both ranks
            if name.startswith("flash_attention_bwd"):
                kr["launches_by_kernel"] = {
                    k: zero_trained[k] for k in (
                        "flash_bwd_dq_wgmma_kernel",
                        "flash_bwd_dkdv_wgmma_kernel")}
                kr["launches"] = min(kr["launches_by_kernel"].values())
            elif name.startswith("flash_attention"):
                kr["launches"] = zero_trained["flash_fwd_wgmma_kernel"]
            else:
                kr["launches"] = zero_trained[name.split(" ")[0]]
        elif name.endswith(" (graph, bfloat16)"):
            # the mixed-precision graph run: 2 backends x GRAPH_STEPS steps;
            # the snapshot-and-resume run beside it
            kr["launches"] = graph_mp[name.split(" ")[0]]
            kr["launches_per_step"] = GRAPH_M
            kr["launches_by_path"] = {
                "graph train mp": kr["launches"],
                "graph snapshot resume": graph_snap[name.split(" ")[0]],
                "graph processes": graph_proc[name.split(" ")[0]]}
        elif name == "flash_attention_bwd":
            kr["launches_by_kernel"] = {
                k: trained[k] for k in ("flash_bwd_dq_wgmma_kernel",
                                        "flash_bwd_dkdv_wgmma_kernel")}
            kr["launches"] = min(kr["launches_by_kernel"].values())
        elif name == "flash_attention":
            kr["launches"] = served["flash_fwd_wgmma_kernel"]
        elif name == "ssd_scan":
            kr["launches"] = served["ssd_scan"]
            kr["wgmma_launches"] = served["ssd_scan_wgmma"]
        elif name.endswith(" (graph, float32)"):
            # the graph train run: 3 backends x GRAPH_STEPS steps
            kr["launches"] = graph_trained[name.split(" ")[0]]
            kr["launches_per_step"] = GRAPH_M
        elif name.endswith("local heads, training)"):
            # the mesh train run (MESH_TRAIN, full depth): both ranks
            kr["launches"] = mesh_train["flash_fwd_wgmma_kernel"]
        elif name.startswith("flash_attention_bwd (tp="):
            kr["launches_by_kernel"] = {
                k: mesh_train[k] for k in ("flash_bwd_dq_wgmma_kernel",
                                           "flash_bwd_dkdv_wgmma_kernel")}
            kr["launches"] = min(kr["launches_by_kernel"].values())
        elif name.endswith("vocab shard, bf16)"):
            # the mesh train run: this shard's launches, and each shard's
            fwd, bwd = mesh_train["offsets"]
            kr["launches_by_offset"] = bwd if "_bwd" in name else fwd
            kr["launches"] = kr["launches_by_offset"][kr["vocab_offset"]]
        elif name.startswith("flash_decode (tp="):
            # the mesh serve run: this shard's launches, and each shard's
            kr["launches"] = meshed["offsets"][kr["k_offset"]]
            kr["launches_by_offset"] = meshed["offsets"]
        elif name.startswith("flash_attention (tp="):
            kr["launches"] = meshed["flash_fwd_wgmma_kernel"]
        elif name.endswith(" (vocab shard, float32)"):
            # the mesh phase: 2 backends x GRAPH_STEPS steps, every rank
            kr["launches"] = mesh_trained[name.split(" ")[0]]
            kr["launches_per_step"] = int(np.prod(MESH_SHAPE)) * GRAPH_M
        else:
            kr["launches"] = (served if name in served else trained)[name]
    kernels[0]["train_shape"]["launches"] = trained["flash_fwd_wgmma_kernel"]
    # the serving paths of the paged, chunked and sampled phases, each run's
    # counts zeroed just before it and read just after
    for kr, key in ((kernels[0], "flash_fwd_wgmma_kernel"),
                    (kernels[1], "flash_decode"),
                    (next(k for k in kernels if k["name"] == "ssd_scan"),
                     "ssd_scan")):
        kr["launches_by_path"] = {"serve": served[key], **{
            path: counts[key] for path, counts in paths.items()},
            "serve mesh": meshed[key], "serve processes": proc_served[key]}
    # the classic loop's causal prefills (pixtral at D 128, whisper's
    # decoder at D 64) and its decodes, each run's own counts
    for arch, counts in classic.items():
        kernels[0]["launches_by_path"][f"serve classic ({arch}), causal"] = \
            counts["by_mask"]["causal"]
        kernels[1]["launches_by_path"][f"serve classic ({arch})"] = \
            counts["flash_decode"]
    ssd_row["launches_by_path"].update({
        f"serve mesh {MAMBA_MESH} (mamba2)": mamba_meshed["ssd_scan"],
        "train (mamba2)": mamba_trained["ssd_scan"],
        f"train mesh {MAMBA_MESH} (mamba2)": mamba_mesh_trained["ssd_scan"]})
    kernels[1]["paged_shape"]["launches"] = paths["serve paged"][
        "flash_decode"]
    print(f"all phases passed in {time.perf_counter() - _START:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
