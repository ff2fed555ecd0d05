#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA card and the CUDA
toolkit::

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package.  Phases, in order; any
failure exits non-zero:

1. Environment: the card's name and power limit, torch's version, and the
   build of the CUDA kernels from ``src/repro_torch/kernels/csrc``.
2. Each kernel against its plain PyTorch version on the card, at the
   main path's shapes, and timed with CUDA events beside its plain
   version, one PyTorch call computing the same function where there is
   one, and its bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense).
   Each time is the median of 25 samples of 10 calls that the device runs
   back to back: every sample is queued behind a device-side wait that
   outlasts the host's enqueue of its calls (the script fails if it does
   not), so the events time the device and not the host's launch rate;
   the host's time to enqueue one call is printed beside it.  The
   splices' yardsticks are timed too: a bf16 ``copy_`` of a splice's bytes
   (into one buffer, and into the slab slots the splice-admit writes) and
   an empty kernel launched back to back.  Each
   kernel's share of its bound, and its registers, shared memory and
   spills from ``nvcc -Xptxas -v``, are printed too; the grouped GEMM is
   timed with its contraction slices both walked by one CTA and spread
   over CTAs (the bits are held equal), and a repeated ``zip_gemm`` launch
   is held bit-equal.  The two MLA decode kernels (``mla_rope_write``,
   ``mla_absorbed_attend``) at both benchmark cells' attention shapes
   (deepseekv2-lite, 16 heads; kanana-2-30b-a3b, 32; 16 rows over a T_pad
   of 1,536): each against its plain version on the card (the written
   latent bit-equal, the rope within one ulp, the output within 2^-7 of
   the largest), timed beside its bound (bytes at 3.35 TB/s or f32
   operations at 67 TFLOP/s, whichever is larger), and, kernel and plain
   version alike, on the host clock a call (the plain versions
   synchronise, so ``med_ms`` cannot time them).
3. The main path at full width: qwen2-moe-a2.7b with every width as
   published, depth cut to 2 layers, seeded random weights.  Build ONE
   compressed store (groups compressed in parallel), check every expert
   tensor loads bit-exactly, then serve a batch of 4 requests of greedy
   tokens through each ``ZipServer`` path, each from that store:

   * ``device_cache=True, ffn_impl="ragged"`` with an F pool smaller than a
     step's distinct experts (8 tokens), held against the resident model
     under teacher forcing;
   * ``fused_recovery=True, ffn_impl="grouped"`` (8 tokens), held against
     the resident model, with no standalone splice;
   * ``fused_recovery=True, ffn_impl="loop"`` (8 tokens), bit-identical to
     the batched fused path;
   * every expert slab-resident, ``ffn_impl="ragged"`` and ``"grouped"``
     (4 tokens): bit-identical to each other, zero h2d bytes on the hit
     steps, zero weight-copy bytes on the ragged path and the gather copy
     on the grouped one;
   * ``profile_p_times=True`` (3 tokens): measured p-time buckets;
   * ``device_recovery=True, ffn_impl="grouped"`` (8 tokens): the engine's
     I/O and decompression workers splice each recovered tensor on the
     card; logits bit-identical to the ragged path's, and one splice
     launch per splice the engine counts;
   * ``device_cache=True, ffn_impl="ragged", mem_budget=...`` (8 tokens,
     a forced re-plan before step 4): live §3.4 planning with the host's
     profiled u/c; logits bit-identical to the ragged path's, at least two
     plans and one re-plan, resident bytes within the budget.  The
     profiled PlanConsts, each plan's sizes and each re-plan's wall time
     are printed.

   Then the serving phase, from the same store: 8 requests (prompt
   lengths 4..12 from a seeded rng, 8 greedy tokens each, at most 4 at
   once, arrivals staggered by 0.5 s) through ``BatchServer``:

   * ``continuous``: continuous batching over ``ZipServer(device_cache=
     True, ffn_impl="ragged")`` (``decode_rows``, KV pages on the card):
     every request completes, the page pool returns to 0 bytes, the
     ragged path's three kernels launch, and each request's logits are
     held against the resident model fed its prompt and outputs (``prefill``
     + ``decode_step``) on identically routed positions;
   * ``continuous-solo``: two of the requests alone through fresh servers:
     bit-identical logits or the largest difference, and the same tokens
     wherever the logits decide them; a probe prints which of the step's
     products give a row other bits in a batch than alone on the card;
   * ``static``: the epoch baseline (``continuous=False``) over a fresh
     ``ZipServer``; ``resident``: prefill + decode on resident weights;
   * the port's CLI once as a subprocess (``zipmoe-batch``): exit 0 and
     its ``metrics:`` and ``cache:`` lines.

   Each path prints TTFT, TPOT and queue-delay percentiles, throughput,
   hit rate, KV pool bytes and its per-request table.

   Each path's launch counts are reset just before its first step and
   read just after its last (after its prefetch jobs are drained where
   the counts are compared with the engine's); every kernel must launch
   on the paths that run it.
4. Slab migration, on the engine directly, from the same store: planning
   constants pinned to a decompression-bound persona (so F pools get
   bytes and slabs are built), a drifting trace (the popular set flips at
   mid-trace, layer 1 goes idle).  Every re-plan is watched from outside:
   a drift re-plan must happen, at least one re-plan must carry residents
   from an old slab into a new one, layer 0's F residents must read back
   bit for bit equal to the store after every re-plan, and layer 1's slab
   must exist during the trace, be freed at its end, and every SlotRef
   into it taken before a re-plan must be stale.
5. The MLA MoE family: deepseekv2-lite with every width as published
   (16 MLA heads, kv_lora 512, rope 64, nope 128, v 128; 64 experts
   top-6, 2 shared; a dense first layer of d_ff 10944), depth cut to 3
   layers (one dense, two MoE), seeded random weights.  Its own store
   under ``build/``, every tensor loaded back bit-exactly; then

   * ``mla-ragged``: ``ZipServer(device_cache=True, ffn_impl="ragged")``,
     the ragged path's pools and 8 greedy tokens for a batch of 4 from an
     empty cache, held against the resident model (absorbed MLA decode)
     under teacher forcing;
   * ``mla-continuous``: the serving phase's 8 requests through
     ``BatchServer`` over ``decode_rows``, each held against the resident
     model fed its prompt one decode step per token (as the server reads
     it; the comparison against ``prefill`` is reported too); the KV page
     pool over the latent returns to 0 bytes and its page holds exactly
     ``(kv_lora + rope) x 2 B`` per token and layer;
   * MLA decode with ``absorb=True`` against ``absorb=False`` on one layer
     at the full attention widths of deepseekv2-lite and deepseek-v2-236b
     (q-LoRA), and the batch-invariance probe of the absorbed products
     and of the attend kernel (a row alone, in the batch and under a
     padded T: bit-equal, checked);
   * ``mla-resident``: the same requests through the resident
     ``BatchServer`` (MLA ``prefill`` + ``decode_step``), and the CLI once
     with ``--arch deepseekv2-lite`` at its own smoke size.

   Both paths must launch the splice, the splice-admit, the ragged GEMM
   and the two MLA decode kernels.
6. The SSM and hybrid families, and the dense GQA configs:
   jamba-v0.1-52b with every width as published (d_model 4096; Mamba2
   d_inner 8192, 128 heads x 64, state 16; 32 heads / 8 KV x 128 with no
   positional encoding; 16 experts top-2 of d_expert 14336; dense d_ff
   14336), depth cut 32 -> 4 (Mamba2 at 0-2, attention at 3, MoE at 1 and
   3, dense MLPs at 0 and 2), seeded random weights.  Phase 6 first runs
   the checks of the other configs on the card: mamba2-370m's SSD prefill
   of 512 tokens (two 256-token chunks) against 512 single decode steps
   at full width and depth, in f32 and
   bf16, each within its stated tolerance; qwen3-14b (qk-norm) and
   starcoder2-3b (LayerNorm + GELU) at full width, depth 2, resident:
   ``prefill(S-1)`` + ``decode_step`` against ``forward(S)``, logits
   finite.  Then jamba's store (11.98 GB of bf16, zlib at level 1 where
   the other stores take the default level 9) is built, loaded back
   bit-exactly and served:

   * ``jamba-ragged``: as ``mla-ragged`` with 4 greedy tokens, against the
     resident model under teacher forcing;
   * ``jamba-continuous``: the serving phase's first 4 requests through
     ``BatchServer`` over ``decode_rows``, at most 2 at once, so later
     requests take slots earlier ones held: the pool returns to 0 bytes
     and holds exactly the Mamba2 layers' state and conv ring per slot and
     the attention layer's K/V per page; each request against the
     resident model fed its prompt one decode step per token; the last
     request (in a recycled slot) against itself alone on a fresh server:
     routes, then logits within 2% and tokens where decided;
   * ``jamba-resident``: the same requests through the resident
     ``BatchServer`` (SSD prefill + decode).

   Both served paths must launch the splice, the splice-admit and the
   ragged GEMM.  mamba2-370m at full width and depth: its store (the SSM
   projections of every layer, 604 MB of bf16) loaded back bit-exactly,
   ``ZipServer.decode_step`` bit-identical to the resident model with no
   kernel launched, and the resident ``BatchServer`` over the serving
   traffic.  Last, the CLI with ``--arch jamba-v0.1-52b``.  Phase 2 also
   times kernels 1-3 at jamba's expert shapes (d 4096, f 14336, 4 tokens
   x top-2) and at switch-large-128's (d 1024, f 2816, 4 tokens x top-1)
   against their plain versions and ``torch.bmm``, each with its bound.
7. The encoder-decoder and M-RoPE families.  switch-large-128 (the
   paper's third evaluation model) with every width as published (d_model
   1024, 16 heads x 64, 128 experts top-1 of d_expert 2816 with GELU,
   learned positions, vocab 32128, 512 encoder frames), depth cut: decoder
   24 -> 4 (dense MLPs at 0 and 2, MoE at 1 and 3), encoder 24 -> 2,
   seeded random weights.  Its store (2.95 GB of expert bf16, zlib at
   level 1) is loaded back bit-exactly; a resident prefill of 8 tokens
   over seeded encoder inputs fills the caches, cross-attention K/V
   (``xkv``) included; then

   * ``switch-ragged``: 8 greedy ``ZipServer.decode_step``s (device slabs,
     ragged FFN, the phase-3 pools) over those caches, each decoder layer
     attending over ``xkv`` between its mixer and its FFN, held against
     the resident model under teacher forcing (a top-1 near-tie flip is
     reported, not compared); ``xkv`` must come back unchanged, and the
     splice, the splice-admit and the ragged GEMM must launch.

   whisper-small at every width and depth (12 + 12 layers, 1500 encoder
   frames): ``prefill(S-1)`` + ``decode_step`` against ``forward(S)``, and
   ``ZipServer.decode_step`` bit-identical to the resident model with no
   kernel launched (its FFNs are dense).  qwen2-vl-2b at every width and
   depth (28 layers) fed seeded embeddings with M-RoPE positions of one
   image grid then text (three channels that differ): ``prefill(S-1)`` +
   ``decode_step`` against ``forward(S)``.
8. Training, on the card (plain PyTorch: no kernel of the port may
   launch; the reference's training path runs no Pallas kernel either):

   * qwen2-moe-a2.7b with every width as published, depth cut 24 -> 2
     (1,763,426,304 params), seeded ``init_params`` on the card, 8 steps
     of ``make_train_step(remat=True, moe_impl="einsum", warmup=2)`` on
     one fixed seeded batch of 4 x 512 tokens: every loss and gradient
     norm finite, the last loss at least ``TRAIN_MIN_DROP`` below the
     first; the median step time over steps 2-8, tokens/s, the share of
     989 TFLOP/s the step's reckoned matmul FLOPs reach
     (``train_step_flops``), and the peak allocation against the 21.2 GB
     of bf16 params and grads and f32 moments;
   * at the same width, one step each way: remat against no remat (loss
     and gradients bit-identical but for the token embedding's, whose
     backward adds with atomics), the scatter dispatch's loss against the
     einsum's, and the int8 error feedback's residuals within half a
     quantisation step of every gradient, then one compressed step;
   * at the train CLI's ``tiny`` preset: 8 steps straight through against
     4 steps, a checkpoint, a restore into a fresh state (bit-equal to the
     saved one) and 4 more steps;
   * the train CLI once as a subprocess (granite-8b, ``tiny``, 20 steps,
     checkpoints): its final loss below its step-0 loss.
9. The multi-rank layer, as 4 ranks that share the card over ``gloo``
   (NCCL refuses two ranks on one GPU), spawned once
   (``repro_torch.distributed.launch.spawn_ranks``); the parent runs each
   path's one-process counterpart first, on the same seeded inputs:

   * (a) sequence-sharded GQA decode: qwen2-moe-a2.7b at every published
     width, depth 24 -> 2, f32, B = 4, a seeded cache of T = 4096 split
     1024 positions a rank over a 4-wide ``model`` mesh axis; three
     ``decode_step(attn_impl="seqshard")`` steps writing in shard 0, an
     interior shard and the last one.  Each rank's logits within 1e-5 of
     the parent's default ``decode_step`` (the reference test's limit);
     the gathered shards bit-equal to the default path's cache but for
     the rows written after the first layer, whose inputs carry the
     combine's other summation order (within 1e-5);
   * (b) the same for sequence-sharded MLA decode: deepseekv2-lite at
     every width, depth 27 -> 3;
   * (c) the GPipe pipeline: qwen2-moe-a2.7b at every width, depth 24 ->
     4, bf16, 2 stage ranks, 4 micro-batches of [2, 128]: bit-identical to
     the parent's sequential pass over the stack;
   * (d) each rank's collective ledger against the reckoning: 3 f32
     all-reduces per attention layer and step; M + P - 1 permutes of one
     micro-batch's activation and one all-reduce of the result a stage;
   * (e) no kernel launches, in the parent or a rank, but the two MLA
     decode kernels in the parent's default MLA decode, once a layer and
     step each.

   Wall and per-step times print beside the default path's; they are 4
   processes sharing one card, not a speedup measurement.  On a machine
   with a card for each rank the ranks take a card each over NCCL;
   ``python3 chip_smoke.py --phase 9`` runs phase 9 alone.
10. The peer-HBM (P) tier and the dry run, from phase 3's store and
    seeded weights (the store stays on disk until this phase): serving 4
    requests of 8 greedy tokens at qwen2-moe-a2.7b's full width, depth 2,
    ``device_cache=True, ffn_impl="ragged"``, pools F2/C2/S2/E2:

   * (a) ``mesh_devices=1``, the baseline;
   * (b) ``mesh_devices=4``: four peer rows, a card each where the
     machine has four cards (``can_device_access_peer`` printed), else
     all four on the one card (``peer_devices=["cuda:0"] * 4``: each fetch
     a device-local copy, no link); the P pool holds every expert.
     Logits bit-identical to (a) at every step, experts link-served, the
     ledger's ``collective-permute`` bytes equal to fetches x an expert's
     bytes; then every expert made resident and 3 hit steps: h2d bytes
     0, logits bit-identical to (a)'s, experts link-served; every PeerRef
     valid, and one expert a row fetched back equal to the store's bits;
   * (c) (b) planned: ``mem_budget`` of 24 experts' bf16 bytes,
     ``peer_budget`` of 8 a row, a forced re-plan before step 4: logits
     bit-identical to (a); after the re-plan each row's grant is the
     per-device solver's over that row's shard under its layer's row
     budget, the row budgets within ``peer_budget``, and the slab gating
     on the grants; between steps no row grows past its grant; each row's
     resident bytes within its budget;
   * (d) ``python -m repro_torch.launch.dryrun --arch qwen2-moe-a2.7b
     --shape decode_32k`` as a subprocess: exit 0 and its record.

   TPOT, blocked time, hit rates by pool, served and fallbacks, ledger
   bytes and ops, put bytes and the link model's bandwidth, latency and
   fetch wall time print for each path.  The mesh-4 path must launch the
   splice-admit and the ragged GEMM.  ``python3 chip_smoke.py --phase
   10`` runs phase 10 alone, from a store of its own.
11. One JSON line with each kernel's launches on its path, error, times
   and bound; then the result line.  Each phase's wall time is printed as
   it ends.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ARCH = "qwen2-moe-a2.7b"
N_LAYERS = 2                 # the only cut: depth (24 published)
BATCH = 4                    # requests served together
NEW_TOKENS = 8
SEED = 0
POOLS_SMALL = {"F": 8, "C": 8, "S": 16, "E": 16}   # F < a step's ~16 experts
PROFILE_STEPS = 3            # the measured-p path needs only a few steps
# the planned path: one global budget of 24 experts' bf16 bytes (a fifth
# of the two layers' 120 experts), the probe every 4 steps, and a forced
# re-plan before step 4
PLAN_BUDGET_EXPERTS = 24
PLAN_REPLAN_EVERY = 4
PLAN_FORCED_AT = 4
# the slab-migration run: the JAX package's drift test (two 40-step zipf
# phases, seeds 5 and 99, top-2; 10 experts' bytes; a probe every 8 steps)
MIGRATION_PHASE = 40
MIGRATION_BUDGET_EXPERTS = 10
MIGRATION_REPLAN_EVERY = 8
# the serving phase's traffic: 8 requests, prompt lengths drawn from a
# seeded rng over 4..12, 8 greedy tokens each, at most 4 decoding at once,
# arrivals staggered by half a second; two requests are also served alone
SERVE_REQUESTS = 8
SERVE_PROMPT_LENS = (4, 12)
SERVE_NEW_TOKENS = 8
SERVE_CONCURRENCY = 4
SERVE_ARRIVALS = (0.0, 0.0, 0.0, 0.0, 0.5, 0.5, 1.0, 1.0)
SERVE_SOLO = (0, SERVE_REQUESTS - 1)       # indices of the solo requests
# the port's CLI, once, at its own smoke size
CLI_ARGS = ("--mode", "zipmoe-batch", "--device-cache", "--requests", "4",
            "--max-new", "4")
CLI_TIMEOUT_S = 300
# the kernels each served path must launch (phases 3 and 4); the planned
# path must also launch the splice-admit when its plans give F bytes, the
# standalone splice when they do not
PATH_KERNELS = {
    "ragged": ("splice", "splice_admit", "slab_gemm"),
    "fused-grouped": ("zip_gemm_grouped",),
    "fused-loop": ("zip_gemm",),
    "grouped-cache-hit": ("grouped_gemm",),
    "profile": ("grouped_gemm", "slab_gemm"),
    "device-recovery": ("splice", "grouped_gemm"),
    "planned": ("slab_gemm",),
    "migration": ("splice_admit",),
    "continuous": ("splice", "splice_admit", "slab_gemm"),
    "mla-ragged": ("splice", "splice_admit", "slab_gemm", "mla_rope_write",
                   "mla_absorbed_attend"),
    "mla-continuous": ("splice", "splice_admit", "slab_gemm",
                       "mla_rope_write", "mla_absorbed_attend"),
    "jamba-ragged": ("splice", "splice_admit", "slab_gemm"),
    "jamba-continuous": ("splice", "splice_admit", "slab_gemm"),
    "switch-ragged": ("splice", "splice_admit", "slab_gemm"),
    "peer": ("splice_admit", "slab_gemm"),
}
# phase 5: deepseekv2-lite, every width as published, depth 27 -> 3 (one
# dense layer, two MoE layers, so the cross-layer prefetch stays real)
MLA_ARCH = "deepseekv2-lite"
MLA_LAYERS = 3
# absorbed vs unabsorbed MLA decode: both sum in f32 in another order, then
# round the per-head output to bf16 once and multiply by wo in bf16; one
# bf16 ulp of the head output (2^-8 relative) moves y by less than that,
# so allow 2^-7 of the largest |y|
MLA_ABSORB_REL_TOL = 2.0 ** -7
MLA_CHECK_POSITIONS = (5, 63, 20, 40)       # B = 4 rows' positions
MLA_CHECK_T = 64
# phase 6: jamba-v0.1-52b, every width as published, depth 32 -> 4 (layers
# 0-3: Mamba2 at 0-2, attention at 3, MoE at 1 and 3, dense MLPs at 0 and
# 2: the shallowest cut that keeps an attention layer and two MoE layers)
JAMBA_ARCH = "jamba-v0.1-52b"
JAMBA_LAYERS = 4
# jamba's store (11.98 GB of bf16) is compressed with zlib at level 1: at
# the default level 9 its exponent planes compress at ~28 MB/s of bf16 on
# the 8 host cores (412-432 s, ratio 0.6888, on the H100's host), most of
# the script's 1200 s.  The manifest records "zlib" either way, and
# decompression does not depend on the level
JAMBA_ZLIB_LEVEL = 1
# jamba-ragged decodes 4 tokens, not 8: a step reconstructs ~13 experts of
# 352 MB (6.4-8.6 s a step on the H100), and the script must stay well
# inside its 1200 s
JAMBA_NEW_TOKENS = 4
# jamba-continuous serves the first 4 of the serving traffic's requests, at
# most 2 at once (all 8, at most 4 at once, took 136 s on the H100);
# requests 3 and 4 run in slots 1 and 2 held
JAMBA_REQUESTS = 4
JAMBA_CONCURRENCY = 2
# mamba2-370m at every width and depth (48 layers); its SSD prefill of two
# 256-token chunks against as many single decode steps.  In f32 the two
# compute one function in other orders (1.5e-5 of max |logit| on the
# H100): allow 1e-3.  In bf16 the prefill's conv rounds each product to
# bf16 where decode sums in f32, as the JAX package does, and the
# difference grows through 48 layers (7.7% on the H100): allow 0.15, a
# check of the state handed across the chunk boundary, not of rounding
MAMBA_ARCH = "mamba2-370m"
MAMBA_PREFILL = 512
MAMBA_F32_REL_TOL = 1e-3
MAMBA_BF16_REL_TOL = 0.15
# the dense GQA configs, every width as published, resident, depth cut to 2
DENSE_ARCHS = ("qwen3-14b", "starcoder2-3b")
DENSE_LAYERS = 2
DENSE_SEQ = 16
# phase 7: switch-large-128 (the paper's third evaluation model), every
# width as published, depth cut: decoder 24 -> 4 (dense MLPs at 0 and 2,
# MoE at 1 and 3, so the cross-layer prefetch stays real), encoder 24 -> 2;
# its store (256 experts, 2.95 GB of bf16) at zlib level 1 as jamba's.  A
# resident prefill of SWITCH_PROMPT tokens over seeded encoder inputs of
# enc_seq_len frames, then NEW_TOKENS greedy ZipServer steps
SWITCH_ARCH = "switch-large-128"
SWITCH_LAYERS = 4
SWITCH_ENC_LAYERS = 2
SWITCH_PROMPT = 8
SWITCH_ZLIB_LEVEL = 1
# whisper-small and qwen2-vl-2b at every width and depth, resident
# (whisper's ZipServer too): prompts of ENCDEC_SEQ positions; qwen2-vl's
# M-RoPE positions lay out one VLM_GRID image, then text
WHISPER_ARCH = "whisper-small"
WHISPER_STEPS = 4
VLM_ARCH = "qwen2-vl-2b"
VLM_GRID = (3, 4)
ENCDEC_SEQ = 16
# phase 8: training qwen2-moe-a2.7b at full width, depth as the serving
# phases; one fixed seeded batch fed TRAIN_STEPS times
TRAIN_LAYERS = N_LAYERS
TRAIN_BATCH, TRAIN_SEQ = 4, 512
TRAIN_STEPS = 8
TRAIN_LR = 1e-3
# the last loss must be below the first by at least this (nats): the
# model fits one batch it sees 8 times
TRAIN_MIN_DROP = 0.25
# remat against no remat: the same forward, recomputed, so the loss and
# every gradient are bit-identical, except the token embedding's
# gradient, which the embedding lookup's backward accumulates with
# atomic adds in an order that varies from run to run (repeated tokens)
REMAT_EMBED_REL = 2.0 ** -7
# scatter against einsum dispatch: the same routes and drops, the combine
# summed in another order in bf16
SCATTER_LOSS_REL = 1e-3
# a checkpoint's resumed run against the straight one: the restored
# state is bit-equal, but the embedding backward's atomics may change
# the last bits of a later step
CKPT_LOSS_ABS = 1e-3
TRAIN_CLI_ARGS = ("--arch", "granite-8b", "--preset", "tiny", "--steps",
                  "20")
# phase 9: the multi-rank layer as ranks sharing the card over gloo
MR_RANKS = 4                 # the seq-sharded decode's model axis
MR_BATCH, MR_SEQ = 4, 4096   # 1024 cache positions a rank
MR_GQA_LAYERS = N_LAYERS     # qwen2-moe-a2.7b, depth 24 -> 2
MR_MLA_LAYERS = MLA_LAYERS   # deepseekv2-lite, depth 27 -> 3
MR_PIPE_LAYERS = 4           # qwen2-moe-a2.7b, depth 24 -> 4, bf16
MR_PIPE_STAGES = 2
MR_PIPE_MICRO, MR_PIPE_MB = 4, (2, 128)
MR_FILL_STD = 0.5            # the seeded cache's entries
# seq-sharded vs default decode in f32: one function, the softmax and the
# value sum added in another order (per shard, then across ranks); the
# reference's seq-sharded test holds its decode to this
MR_REL = 1e-5
MR_TIMEOUT_S = 600
MR_PROBE_REPS = 20
# phase 10: the peer-HBM tier on the main path's store and weights
PEER_MESH = 4                # peer rows: a card each, or all on one card
PEER_POOLS = {"F": 2, "C": 2, "S": 2, "E": 2}   # P: every expert (default)
PEER_BUDGET_EXPERTS = 8      # planned path: each row's budget, in experts
PEER_WARM_STEPS = 4          # 1 + 3 hit steps with every expert resident
DRYRUN_SHAPE = "decode_32k"
DRYRUN_TIMEOUT_S = 120
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12     # dense bf16 tensor-core peak
F32_FLOP_PER_S = 67e12       # f32 outside the tensor cores
# phase 2: the MLA decode kernels at the benchmark cells' attention shapes
# (deepseekv2-lite: 16 heads; kanana-2-30b-a3b: 32): 16 rows at positions
# spread evenly over T_pad = 1,536, 0 and T_pad - 1 among them; the timed
# calls rotate over MLA_KERNEL_SETS latent caches and wkv_b's, past the L2
MLA_KERNEL_ARCHS = (("deepseekv2-lite", "dsv2lite"),
                    ("kanana-2-30b-a3b", "kanana2"))
MLA_KERNEL_B, MLA_KERNEL_T = 16, 1536
MLA_KERNEL_SETS = 4
# a host-clock time of a call that synchronises (the plain versions): the
# mean over this many calls, after as many untimed ones
WALL_CALLS = 50
# ragged GEMM vs its f32 plain version: both sum in f32 but in another
# order, and both round once to bf16, so outputs may differ by a bf16 ulp
# of the largest outputs; allow two (2^-7 of the largest |output|)
GEMM_REL_TOL = 2.0 ** -7
# served vs resident logits: bf16 activations (ulp 2^-8 relative) through
# 2 layers whose expert sums run in other orders (slab kernel vs bmm) and
# whose gates are rounded at other places.  Measured 0.74% of the largest
# |logit| on the H100; the CPU parity tests hold the port to 2% of it
LOGIT_REL_TOL = 0.02
# phase 2's device-side wait before each timed sample (med_ms): 8x the
# host's calibrated enqueue; a host hiccup on the H100's host has made one
# sample's enqueue outlast a 4x wait
WAIT_MIN_MS = 1.0
WAIT_FACTOR = 8.0
CALIBRATE_WAIT_MS = 50.0


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg: str):
    if not cond:
        fail(msg)


def sleep_rate(torch) -> float:
    """Cycles of ``torch.cuda._sleep`` per millisecond on this card."""
    cycles = 2_000_000
    torch.cuda._sleep(cycles)
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    torch.cuda._sleep(cycles)
    e.record()
    e.synchronize()
    return cycles / s.elapsed_time(e)


def med_ms(fn, torch, cycles_per_ms: float, samples: int = 25,
           per: int = 10, warm: int = 5):
    """Device time of one call of `fn`, and the host's time to enqueue one:
    medians over `samples` of the mean over `per` calls, after `warm`
    untimed calls.

    The device runs each sample's `per` calls back to back: a device-side
    wait (``torch.cuda._sleep``) is queued before the start event, so the
    host has queued every call before the device reaches the first, and
    the events time the device, not the host's launch rate.  The wait is
    WAIT_FACTOR times the host's enqueue of `per` calls behind a long wait
    (the device busy, as in a sample; the larger of two), and at least
    WAIT_MIN_MS.  A sample whose enqueue (the wait's own included) outlasts
    its wait fails the script; so does an `fn` that synchronises with the
    device."""
    where = f"chip_smoke.py:{fn.__code__.co_firstlineno}"
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    busy = []
    for _ in range(2):
        torch.cuda._sleep(int(CALIBRATE_WAIT_MS * cycles_per_ms))
        t0 = time.perf_counter()
        for _ in range(per):
            fn()
        busy.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    wait_ms = max(WAIT_MIN_MS, WAIT_FACTOR * max(busy))
    cycles = int(wait_ms * cycles_per_ms)
    dev, host = [], []
    gc.disable()
    try:
        for _ in range(samples):
            w = torch.cuda.Event(enable_timing=True)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            w.record()
            torch.cuda._sleep(cycles)
            s.record()
            t1 = time.perf_counter()
            for _ in range(per):
                fn()
            e.record()
            t2 = time.perf_counter()
            e.synchronize()
            waited = w.elapsed_time(s)
            check((t2 - t0) * 1e3 < waited,
                  f"timing the call at {where}: the host took "
                  f"{(t2 - t0) * 1e3:.4f} ms to enqueue {per} calls, longer "
                  f"than the device's {waited:.4f} ms wait (enqueue behind "
                  f"a long wait: {max(busy):.4f} ms): the events would time "
                  f"the host")
            dev.append(s.elapsed_time(e) / per)
            host.append((t2 - t1) * 1e3 / per)
    finally:
        gc.enable()
    return statistics.median(dev), statistics.median(host)


def bound(nbytes: float, flops: float):
    t_b = nbytes / HBM_BYTES_PER_S
    t_o = flops / BF16_FLOP_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


# ----------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ----------------------------------------------------------------------------
def ragged_gemm_rows(torch, dev, timed, g, d, f, n_e, ts, make_x, what):
    """The slot-indexed ragged GEMM over the 8-row tiles of slot vector
    `ts` against a stack of `n_e` experts, gate/up ([d] -> [f]) then down
    ([f] -> [d]) with ``make_x(K)`` the rows: each held against its plain
    version (GEMM_REL_TOL), then the pair timed with `timed` beside the
    plain version and ``torch.bmm`` over the gathered slots.  Returns the
    pair's numbers and its bound from these inputs."""
    from repro_torch.kernels import _build, moe_gemm, ref
    lib = _build.library()
    stream = torch.cuda.current_stream().cuda_stream
    T = ts.size * 8
    out = {"ms": 0.0, "host_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
           "max_abs_err": 0.0}
    flops = nbytes = 0.0
    for (dd, ff) in ((d, f), (f, d)):           # gate/up, then down
        x = make_x(dd)
        wb = (torch.randn((n_e, dd, ff), device=dev, generator=g)
              * 0.02).to(torch.bfloat16)
        k = moe_gemm.slab_ragged_gemm(x, wb, ts).float()
        r = ref.slab_gemm_ref(x, wb, ts).float()
        err = (k - r).abs().max().item()
        scale = r.abs().max().item()
        check(err <= GEMM_REL_TOL * scale,
              f"{what} [{dd}->{ff}] error {err} > {GEMM_REL_TOL} x {scale}")
        out["max_abs_err"] = max(out["max_abs_err"], err)
        ts_d = torch.from_numpy(ts).to(dev)
        ts_l = ts_d.long()
        o = torch.empty((T, ff), dtype=torch.bfloat16, device=dev)
        # sa keeps the bounds and scratch alive for the raw pointers in
        # sargs, taken once so that the timed calls hold no Python work
        sa = moe_gemm.split_args(T // 8, dd, ff, dev)
        sargs = sa.args
        ms, hms = timed(lambda: lib.zipmoe_slab_gemm(
            x.data_ptr(), wb.data_ptr(), ts_d.data_ptr(), o.data_ptr(),
            T // 8, dd, ff, dd * ff, *sargs, stream))
        out["ms"] += ms
        out["host_ms"] += hms
        # the slots as a device tensor: from numpy the plain version would
        # copy them to the card and synchronise on every call
        out["plain_ms"] += timed(lambda: ref.slab_gemm_ref(x, wb, ts_l))[0]
        out["library_ms"] += timed(lambda: torch.bmm(
            x.view(T // 8, 8, dd), wb.index_select(0, ts_l)))[0]
        distinct = len(set(ts.tolist()))
        nbytes += 2.0 * T * dd + 2.0 * distinct * dd * ff + 4 * ts.size \
            + 2.0 * T * ff
        flops += 2.0 * T * dd * ff
        print(f"{what} [{T}, {dd}] x slab[{n_e}, {dd}, {ff}] "
              f"({len(sa.bounds) - 1} contraction slices): max abs err "
              f"{err:.3g} (max |out| {scale:.3g}, tolerance "
              f"{GEMM_REL_TOL:.3g} x max |out|)", flush=True)
        del wb
    out["bound_ms"], out["bound_by"] = bound(nbytes, flops)
    out["shape"] = [T, d, f, "+", T, f, d]
    return out


def kernel_phase(torch, np, dev, cfg):
    from repro_torch.core import bitfield
    from repro_torch.kernels import _build, moe_gemm, recovery, ref
    lib = _build.library()
    d, f = cfg.d_model, cfg.d_expert
    g = torch.Generator(device=dev).manual_seed(SEED)
    res = {}
    rate = sleep_rate(torch)

    def timed(fn):
        return med_ms(fn, torch, rate)

    # -- splice: all 65,536 bit patterns, then full-width tensors ----------
    u = torch.arange(65536, dtype=torch.int32, device=dev).to(torch.int16)
    e, s = bitfield.decompose(u.view(torch.bfloat16))
    got = recovery.recover_bf16(e, s)
    check(torch.equal(got.view(torch.int16), u),
          "splice differs from the bit pattern it should rebuild")
    n_sets = 16    # distinct full-width plane pairs: 92 MB, past the L2
    sets = []
    for _ in range(n_sets):
        sets.append((torch.randint(0, 256, (d * f,), dtype=torch.uint8,
                                   device=dev, generator=g),
                     torch.randint(0, 256, (d * f,), dtype=torch.uint8,
                                   device=dev, generator=g)))
    e, s = sets[0]
    k = recovery.recover_bf16(e, s)
    r = ref.recover_bf16_ref(e, s)
    check(torch.equal(k.view(torch.int16), r.view(torch.int16)),
          "splice [2048, 1408] not bit-exact against its plain version")
    print(f"splice: 65536 patterns and [{d}, {f}] bit-exact", flush=True)
    out = torch.empty(d * f, dtype=torch.bfloat16, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    it = [0]

    def splice_k():
        a, b = sets[it[0] % n_sets]
        it[0] += 1
        lib.zipmoe_splice(a.data_ptr(), b.data_ptr(), out.data_ptr(), d * f,
                          stream)

    def splice_p():
        a, b = sets[it[0] % n_sets]
        it[0] += 1
        ref.recover_bf16_ref(a, b)

    ms, hms = timed(splice_k)
    bms, by = bound(4.0 * d * f, 0.0)
    res["splice"] = dict(
        name="splice", route="cuda",
        source="src/repro_torch/kernels/csrc/recovery.cu",
        replaces="src/repro/kernels/recovery.py:44",
        max_abs_err=0.0, ms=ms, host_ms=hms, plain_ms=timed(splice_p)[0],
        bound_ms=bms, bound_by=by, library_ms=None, shape=[d, f])

    # -- the copy yardstick: one streaming pass of a splice's bytes --------
    # dst.copy_(src) on bf16 [d * f] moves the 11.53 MB a splice moves,
    # with its sources rotating over 92 MB as the splice's planes do.  Not
    # the same function, so no kernel's library_ms: it shows what one
    # streaming pass of this size reaches on this card
    srcs = [torch.cat(pair).view(torch.bfloat16) for pair in sets]
    dst = torch.empty(d * f, dtype=torch.bfloat16, device=dev)

    def copy_k():
        dst.copy_(srcs[it[0] % len(srcs)])
        it[0] += 1

    copy_ms, copy_hms = timed(copy_k)
    check(torch.equal(dst.view(torch.int16),
                      srcs[(it[0] - 1) % len(srcs)].view(torch.int16)),
          "the copy yardstick did not copy")
    # the floor under every row: an empty kernel, launched back to back
    launch_ms = timed(lambda: torch.cuda._sleep(0))[0]
    print(f"copy yardstick: bf16 [{d * f}] dst.copy_(src) {copy_ms:.6g} ms "
          f"({4.0 * d * f / copy_ms / 1e9:.4g} TB/s), host "
          f"{copy_hms:.6g} ms to enqueue one; an empty kernel "
          f"{launch_ms:.6g} ms", flush=True)

    # -- splice-admit into a [cap, 2048, 1408] slab ------------------------
    cap, slot = 8, 5
    buf = torch.randn((cap, d, f), device=dev, generator=g).to(torch.bfloat16)
    before = buf.clone()
    w = torch.randn((d, f), device=dev, generator=g).to(torch.bfloat16)
    e, s = bitfield.decompose(w)
    want = ref.splice_admit_ref(buf, e, s, slot)
    ptr = buf.data_ptr()
    moe_gemm.slab_splice_admit(buf, e, s, slot)
    torch.cuda.synchronize()
    check(buf.data_ptr() == ptr, "splice-admit moved the slab")
    check(torch.equal(buf.view(torch.int16), want.view(torch.int16)),
          "splice-admit differs from its plain version")
    check(torch.equal(buf[slot].view(torch.int16), w.view(torch.int16)),
          "splice-admit slot does not hold the spliced tensor")
    others = [i for i in range(cap) if i != slot]
    check(torch.equal(buf[others].view(torch.int16),
                      before[others].view(torch.int16)),
          "splice-admit touched another slot")
    print(f"splice-admit: slot {slot} of [{cap}, {d}, {f}] bit-exact, other "
          f"slots byte-identical, data_ptr unchanged", flush=True)
    del before, want

    # the admit's own yardstick: the same copy into the slots it rotates
    # over, which are cold in the L2 as a slab slot is
    def copy_slot():
        buf[it[0] % cap].view(-1).copy_(srcs[it[0] % len(srcs)])
        it[0] += 1

    copy_slot_ms = timed(copy_slot)[0]
    del srcs, dst

    def admit_k():
        a, b = sets[it[0] % n_sets]
        it[0] += 1
        lib.zipmoe_splice_admit(buf.data_ptr(), it[0] % cap, d * f,
                                a.data_ptr(), b.data_ptr(), stream)

    def admit_p():
        a, b = sets[it[0] % n_sets]
        it[0] += 1
        buf[it[0] % cap] = ref.recover_bf16_ref(a, b).view(d, f)

    ms, hms = timed(admit_k)
    res["splice_admit"] = dict(
        name="splice_admit", route="cuda",
        source="src/repro_torch/kernels/csrc/moe_gemm.cu",
        replaces="src/repro/kernels/moe_gemm.py:172",
        max_abs_err=0.0, ms=ms, host_ms=hms, plain_ms=timed(admit_p)[0],
        bound_ms=bms, bound_by=by, library_ms=None, shape=[cap, d, f])
    for name, yard in (("splice", copy_ms), ("splice_admit", copy_slot_ms)):
        print(f"{name}: {res[name]['ms']:.6g} ms on the device, "
              f"{res[name]['ms'] / copy_ms:.4g}x the copy yardstick, "
              f"{res[name]['ms'] / yard:.4g}x the copy into its own output "
              f"({yard:.6g} ms), {res[name]['bound_ms'] / res[name]['ms']:.4g}"
              f" of the bound; the host takes {res[name]['host_ms']:.6g} ms "
              f"to enqueue one", flush=True)
    del buf, sets

    # -- slot-indexed ragged GEMM at the main path's shapes ----------------
    # a decode step of 4 tokens x top-4: 16 (token, expert) pairs, one
    # 8-row tile each; here 14 distinct slots, a repeated slot and a pad
    # tile, against a stack of 16 experts
    ts = np.asarray(list(range(14)) + [3, 0], np.int32)

    def main_rows(dd):
        x = torch.randn((ts.size * 8, dd), device=dev, generator=g).to(
            torch.bfloat16)
        x[8:16] = 0                              # a singleton group
        x[9] = torch.randn((dd,), device=dev, generator=g).to(torch.bfloat16)
        x[-8:] = 0                               # the pad tile
        return x

    res["slab_gemm"] = dict(
        name="slab_gemm", route="cuda",
        source="src/repro_torch/kernels/csrc/moe_gemm.cu",
        replaces="src/repro/kernels/moe_gemm.py:123",
        **ragged_gemm_rows(torch, dev, timed, g, d, f, 16, ts, main_rows,
                           "ragged GEMM"))

    # -- grouped and fused GEMMs at the main path's shapes ------------------
    # a decode step's padded batch: 16 active experts x C = 8 rows (4
    # tokens x top-4 spread one or two per expert), gate/up then down
    n_e, C = 16, 8
    acc = {k: {"ms": 0.0, "host_ms": 0.0, "plain_ms": 0.0,
               "library_ms": 0.0, "err": 0.0, "bytes": 0.0, "flops": 0.0}
           for k in ("grouped_gemm", "zip_gemm_grouped", "zip_gemm")}
    for (dd, ff) in ((d, f), (f, d)):
        x = torch.randn((n_e, C, dd), device=dev, generator=g).to(
            torch.bfloat16)
        x[:, 2:] = 0                             # pad rows of each group
        wb = (torch.randn((n_e, dd, ff), device=dev, generator=g)
              * 0.02).to(torch.bfloat16)
        e8, s8 = (p.view(n_e, dd, ff) for p in bitfield.decompose(wb))
        o = torch.empty((n_e, C, ff), dtype=torch.bfloat16, device=dev)
        # the grouped GEMM against its plain version and torch.bmm
        k = moe_gemm.grouped_gemm(x, wb)
        r = ref.moe_gemm_ref(x, wb)
        err = (k.float() - r.float()).abs().max().item()
        scale = r.float().abs().max().item()
        check(err <= GEMM_REL_TOL * scale, f"grouped GEMM [{dd}->{ff}] "
              f"error {err} > {GEMM_REL_TOL} x {scale}")
        a = acc["grouped_gemm"]
        a["err"] = max(a["err"], err)
        sa = moe_gemm.split_args(n_e * C // 8, dd, ff, dev)
        sargs = sa.args
        own_ms, hms = timed(lambda: lib.zipmoe_grouped_gemm(
            x.data_ptr(), wb.data_ptr(), o.data_ptr(), n_e, C, dd, ff,
            *sargs, stream))
        a["ms"] += own_ms
        a["host_ms"] += hms
        # the other distribution of the same slices: the same bits
        other = moe_gemm.split_args(n_e * C // 8, dd, ff, dev,
                                    spread=not sa.spread)
        oargs = other.args
        o.zero_()
        check(lib.zipmoe_grouped_gemm(
            x.data_ptr(), wb.data_ptr(), o.data_ptr(), n_e, C, dd, ff,
            *oargs, stream) == 0, "grouped GEMM launch refused")
        check(torch.equal(o.view(torch.int16), k.view(torch.int16)),
              f"grouped GEMM [{dd}->{ff}] differs between its slice "
              f"distributions")
        alt_ms = timed(lambda: lib.zipmoe_grouped_gemm(
            x.data_ptr(), wb.data_ptr(), o.data_ptr(), n_e, C, dd, ff,
            *oargs, stream))[0]
        dist = {True: "spread", False: "walked"}
        print(f"grouped GEMM [{n_e}, {C}, {dd}] x [{n_e}, {dd}, {ff}]: "
              f"{len(sa.bounds) - 1} slices {dist[sa.spread]} (the "
              f"wrapper's choice) {own_ms:.6g} ms, "
              f"{dist[other.spread]} {alt_ms:.6g} ms, bit-equal", flush=True)
        a["plain_ms"] += timed(lambda: ref.moe_gemm_ref(x, wb))[0]
        a["library_ms"] += timed(lambda: torch.bmm(x, wb))[0]
        a["bytes"] += 2.0 * n_e * (C * dd + dd * ff + C * ff)
        a["flops"] += 2.0 * n_e * C * dd * ff
        # the fused splice + grouped GEMM: the same bits as splicing first
        kz = moe_gemm.zip_gemm_grouped(x, e8, s8)
        check(torch.equal(kz.view(torch.int16), k.view(torch.int16)),
              f"zip_gemm_grouped [{dd}->{ff}] differs from the grouped GEMM "
              f"on the spliced weights")
        rz = ref.zip_gemm_grouped_ref(x, e8, s8)
        err = (kz.float() - rz.float()).abs().max().item()
        check(err <= GEMM_REL_TOL * scale, f"zip_gemm_grouped [{dd}->{ff}] "
              f"error {err} > {GEMM_REL_TOL} x {scale}")
        a = acc["zip_gemm_grouped"]
        a["err"] = max(a["err"], err)
        ms, hms = timed(lambda: lib.zipmoe_zip_gemm_grouped(
            x.data_ptr(), e8.data_ptr(), s8.data_ptr(), o.data_ptr(), n_e, C,
            dd, ff, *sargs, stream))
        a["ms"] += ms
        a["host_ms"] += hms
        a["plain_ms"] += timed(lambda: ref.zip_gemm_grouped_ref(x, e8,
                                                                 s8))[0]
        a["bytes"] += 2.0 * n_e * (C * dd + dd * ff + C * ff)
        a["flops"] += 2.0 * n_e * C * dd * ff
        # one expert at a time: the batched kernel's rows, bit for bit;
        # timed launches rotate over the 16 experts (92 MB, past the L2)
        for e in range(n_e):
            one = moe_gemm.zip_gemm(x[e], e8[e], s8[e])
            check(torch.equal(one.view(torch.int16), kz[e].view(torch.int16)),
                  f"zip_gemm expert {e} [{dd}->{ff}] differs from its row "
                  f"of zip_gemm_grouped")
        # a repeated launch gives the same bits, whatever order its CTAs
        # (slices spread over them) arrive in
        reps = [moe_gemm.zip_gemm(x[5], e8[5], s8[5]) for _ in range(10)]
        check(all(torch.equal(r_.view(torch.int16), kz[5].view(torch.int16))
                  for r_ in reps), f"zip_gemm [{dd}->{ff}] differs between "
              f"repeated launches")
        a = acc["zip_gemm"]
        a["err"] = max(a["err"], acc["zip_gemm_grouped"]["err"])
        one_sa = moe_gemm.split_args(C // 8, dd, ff, dev)
        one_args = one_sa.args
        ptrs = [(x[e].data_ptr(), e8[e].data_ptr(), s8[e].data_ptr(),
                 o[e].data_ptr()) for e in range(n_e)]

        def zip_rotating(split):
            def launch():
                p_ = ptrs[it[0] % n_e]
                it[0] += 1
                lib.zipmoe_zip_gemm(*p_, C, dd, ff, *split, stream)
            return launch

        zip_one = zip_rotating(one_args)

        def zip_one_plain():
            e = it[0] % n_e
            it[0] += 1
            ref.zip_gemm_grouped_ref(x[e:e + 1], e8[e:e + 1], s8[e:e + 1])

        one_ms, host_ms = timed(zip_one)
        a["ms"] += one_ms
        a["host_ms"] += host_ms
        a["plain_ms"] += timed(zip_one_plain)[0]
        # the same launches with one CTA walking every slice (what the
        # wrapper does at E = 16): the same bits, and the host's own time
        # per launch, which a one-tile launch comes close to
        walk_sa = moe_gemm.split_args(C // 8, dd, ff, dev, spread=False)
        walk_args = walk_sa.args
        o.zero_()
        check(lib.zipmoe_zip_gemm(*ptrs[5], C, dd, ff, *walk_args,
                                  stream) == 0, "zip_gemm launch refused")
        check(torch.equal(o[5].view(torch.int16), kz[5].view(torch.int16)),
              f"zip_gemm [{dd}->{ff}] differs between its slice "
              f"distributions")
        walk_ms = timed(zip_rotating(walk_args))[0]
        print(f"zip_gemm one tile [{dd}->{ff}]: {len(one_sa.bounds) - 1} "
              f"slices spread (the wrapper's choice) {one_ms:.6g} ms, "
              f"walked {walk_ms:.6g} ms, bit-equal; the host takes "
              f"{host_ms:.6g} ms to enqueue one", flush=True)
        a["bytes"] += 2.0 * (C * dd + dd * ff + C * ff)
        a["flops"] += 2.0 * C * dd * ff
        print(f"grouped / zip GEMMs [{n_e}, {C}, {dd}] x [{n_e}, {dd}, {ff}]: "
              f"grouped max abs err {acc['grouped_gemm']['err']:.3g} (max "
              f"|out| {scale:.3g}); zip_gemm_grouped bit-equal to the "
              f"grouped GEMM, zip_gemm bit-equal to its rows", flush=True)
        del wb, e8, s8
    lines = {"grouped_gemm": "src/repro/kernels/moe_gemm.py:76",
             "zip_gemm_grouped": "src/repro/kernels/moe_gemm.py:268",
             "zip_gemm": "src/repro/kernels/moe_gemm.py:227"}
    for name, a in acc.items():
        bms, by = bound(a["bytes"], a["flops"])
        res[name] = dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/moe_gemm.cu",
            replaces=lines[name], max_abs_err=a["err"], ms=a["ms"],
            host_ms=a["host_ms"], plain_ms=a["plain_ms"], bound_ms=bms,
            bound_by=by,
            # no single PyTorch call splices and multiplies
            library_ms=a["library_ms"] if name == "grouped_gemm" else None)
    # each kernel's share of its bound and the host's time to enqueue one
    # launch (a GEMM row: its d->f + f->d pair), the copy yardstick, and
    # the registers, shared memory and spills of every kernel
    print(json.dumps({
        "bound_share": {n: r["bound_ms"] / r["ms"] for n, r in res.items()},
        "host_enqueue_ms": {n: r["host_ms"] for n, r in res.items()},
        "copy_yardstick_ms": copy_ms, "copy_into_slot_ms": copy_slot_ms,
        "empty_kernel_ms": launch_ms, "ptxas": ptxas_usage(_build)}),
        flush=True)
    return res


def expert_kernel_shapes(torch, np, dev, arch: str, label: str, ts):
    """Kernels 1-3 at `arch`'s expert shapes, each against its plain
    version and timed with ``med_ms`` beside its plain version and its
    bound: the splice of one [d_model, d_expert] tensor, the splice-admit
    into an 8-slot slab, and the ragged GEMM over the one-row 8-row tiles
    of slot vector `ts` (a decode step's (token, expert) pairs) against the
    layer's whole expert stack, d -> f, then f -> d with K = d_expert.
    jamba-v0.1-52b: d 4096, f 14336, 4 tokens x top-2 = 8 tiles over 16
    experts; switch-large-128: d 1024, f 2816, 4 tokens x top-1 = 4 tiles
    over 128.  Returns each kernel's numbers."""
    from repro_torch.configs import get_config
    from repro_torch.core import bitfield
    from repro_torch.kernels import _build, moe_gemm, recovery, ref
    lib = _build.library()
    cfg = get_config(arch)
    d, f, n_e = cfg.d_model, cfg.d_expert, cfg.n_experts
    g = torch.Generator(device=dev).manual_seed(SEED)
    rate = sleep_rate(torch)
    stream = torch.cuda.current_stream().cuda_stream
    res, it = {}, [0]

    def timed(fn):
        return med_ms(fn, torch, rate)

    # rotate over > 60 MB of planes, far past the L2 (jamba: 4 sets of
    # 117 MB; switch: 11 of 5.8 MB)
    n_sets = max(4, -(-60_000_000 // (2 * d * f)))
    sets = [(torch.randint(0, 256, (d * f,), dtype=torch.uint8, device=dev,
                           generator=g),
             torch.randint(0, 256, (d * f,), dtype=torch.uint8, device=dev,
                           generator=g)) for _ in range(n_sets)]
    e, s = sets[0]
    check(torch.equal(recovery.recover_bf16(e, s).view(torch.int16),
                      ref.recover_bf16_ref(e, s).view(torch.int16)),
          f"splice [{d}, {f}] not bit-exact against its plain version")
    out = torch.empty(d * f, dtype=torch.bfloat16, device=dev)

    def splice_k():
        a, b = sets[it[0] % n_sets]
        it[0] += 1
        lib.zipmoe_splice(a.data_ptr(), b.data_ptr(), out.data_ptr(), d * f,
                          stream)

    def splice_p():
        a, b = sets[it[0] % n_sets]
        it[0] += 1
        ref.recover_bf16_ref(a, b)

    bms, by = bound(4.0 * d * f, 0.0)
    ms, hms = timed(splice_k)
    res["splice"] = dict(ms=ms, host_ms=hms, plain_ms=timed(splice_p)[0],
                         bound_ms=bms, bound_by=by, max_abs_err=0.0,
                         library_ms=None, shape=[d, f])

    cap, slot = 8, 5
    buf = torch.empty((cap, d, f), dtype=torch.bfloat16, device=dev)
    buf.view(torch.int16).random_(generator=g)
    w = (torch.randn((d, f), device=dev, generator=g) * 0.01).to(
        torch.bfloat16)
    e, s = bitfield.decompose(w)
    moe_gemm.slab_splice_admit(buf, e, s, slot)
    check(torch.equal(buf[slot].view(torch.int16), w.view(torch.int16)),
          f"splice-admit into [{cap}, {d}, {f}] does not hold the spliced "
          f"tensor")
    del w, e, s

    def admit_k():
        a, b = sets[it[0] % n_sets]
        it[0] += 1
        lib.zipmoe_splice_admit(buf.data_ptr(), it[0] % cap, d * f,
                                a.data_ptr(), b.data_ptr(), stream)

    def admit_p():
        a, b = sets[it[0] % n_sets]
        it[0] += 1
        buf[it[0] % cap] = ref.recover_bf16_ref(a, b).view(d, f)

    ms, hms = timed(admit_k)
    res["splice_admit"] = dict(ms=ms, host_ms=hms,
                               plain_ms=timed(admit_p)[0], bound_ms=bms,
                               bound_by=by, max_abs_err=0.0, library_ms=None,
                               shape=[cap, d, f])
    del buf, sets

    def one_row_per_tile(dd):
        x = torch.zeros((ts.size * 8, dd), dtype=torch.bfloat16, device=dev)
        x[::8] = torch.randn((ts.size, dd), device=dev, generator=g).to(
            torch.bfloat16)
        return x

    res["slab_gemm"] = ragged_gemm_rows(torch, dev, timed, g, d, f, n_e, ts,
                                        one_row_per_tile,
                                        f"{label} shapes: ragged GEMM")
    for name, r in res.items():
        lib_ms = "" if r["library_ms"] is None else \
            f", torch.bmm {r['library_ms']:.6g} ms"
        print(f"{label} shapes: {name} {r['ms']:.6g} ms on the device "
              f"(plain {r['plain_ms']:.6g} ms{lib_ms}), bound "
              f"{r['bound_ms']:.6g} ms ({r['bound_by']}), "
              f"{r['bound_ms'] / r['ms']:.4g} of the bound; the host takes "
              f"{r['host_ms']:.6g} ms to enqueue one", flush=True)
    print(json.dumps({f"kernels_at_{label}_shapes": res}), flush=True)
    del g
    gc.collect()
    torch.cuda.empty_cache()
    return res


def wall_ms(fn, torch, calls: int = WALL_CALLS) -> float:
    """Host-clock ms per call of `fn`, synchronised before and after
    `calls` calls (after as many untimed ones): what a call costs the
    decode thread, launches and synchronisations included."""
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / calls


def mla_kernel_rows(torch, np, dev):
    """The two MLA decode kernels at each benchmark cell's attention
    widths (MLA_KERNEL_ARCHS; B 16, T_pad 1,536): each against its plain
    version on the card (the written latent bit-equal, the rope key and
    query within one bf16 ulp, the output within MLA_ABSORB_REL_TOL of the
    largest |output|), then timed with ``med_ms`` (device time; latent
    caches and ``wkv_b`` rotating past the L2) beside its bound, and both
    kernels and plain versions on the host clock (``wall_ms``: the plain
    versions synchronise three times a call, so ``med_ms`` cannot time
    them).  Returns each kernel's row at deepseekv2-lite's shapes, with
    kanana-2's numbers under ``kanana2``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import mla_decode, ref
    rate = sleep_rate(torch)
    rows = {"mla_rope_write": {}, "mla_absorbed_attend": {}}
    B, T = MLA_KERNEL_B, MLA_KERNEL_T
    for arch, label in MLA_KERNEL_ARCHS:
        cfg = get_config(arch)
        H, C, Dr = cfg.n_heads, cfg.kv_lora_rank, cfg.qk_rope_dim
        Dn, Dv = cfg.qk_nope_dim, cfg.v_head_dim
        g = torch.Generator(device=dev).manual_seed(SEED)

        def rnd(shape, std=1.0):
            return (torch.randn(shape, generator=g, device=dev) * std).to(
                torch.bfloat16)

        pos = torch.linspace(0, T - 1, B, device=dev).round().long()
        q, kv = rnd((B, 1, H * (Dn + Dr))), rnd((B, 1, C + Dr))
        kv_norm = torch.rand(C, generator=g, device=dev) + 0.5
        sets = [(rnd((C, H * (Dn + Dv)), 0.05), rnd((B, T, C)),
                 rnd((B, T, Dr))) for _ in range(MLA_KERNEL_SETS)]
        scale = float(np.float32(1.0) / np.sqrt(np.float32(Dn + Dr)))
        wkv_b, ckv, k_rope = sets[0]
        plain = (ckv.clone(), k_rope.clone())
        qr_p = ref.mla_rope_write_ref(q, kv, kv_norm, pos, *plain,
                                      n_heads=H, rope_theta=cfg.rope_theta)
        qr_k = mla_decode.rope_write(q, kv, kv_norm, pos, ckv, k_rope,
                                     n_heads=H, rope_theta=cfg.rope_theta)
        torch.cuda.synchronize()
        ulp = {n: int((a.view(torch.int16).int() - b.view(torch.int16).int())
                      .abs().max()) for n, a, b in (
                          ("k_rope", k_rope, plain[1]), ("q_rope", qr_k, qr_p))}
        check(torch.equal(ckv.view(torch.int16), plain[0].view(torch.int16)),
              f"mla_rope_write at {label} shapes: the written latent differs "
              f"from its plain version")
        check(max(ulp.values()) <= 1, f"mla_rope_write at {label} shapes: "
              f"rope more than one ulp from its plain version: {ulp}")
        y_p = ref.mla_absorbed_attend_ref(q, qr_p, wkv_b, *plain, pos,
                                          n_heads=H, v_head_dim=Dv,
                                          scale=scale).float()
        y_k = mla_decode.absorbed_attend(q, qr_p, wkv_b, *plain, pos,
                                         n_heads=H, v_head_dim=Dv,
                                         scale=scale).float()
        err = (y_k - y_p).abs().max().item()
        top = y_p.abs().max().item()
        check(err <= MLA_ABSORB_REL_TOL * top, f"mla_absorbed_attend at "
              f"{label} shapes: error {err} > {MLA_ABSORB_REL_TOL} x {top}")
        it = [0]

        def write_k():
            mla_decode.rope_write(q, kv, kv_norm, pos, ckv, k_rope,
                                  n_heads=H, rope_theta=cfg.rope_theta)

        def write_p():
            ref.mla_rope_write_ref(q, kv, kv_norm, pos, *plain, n_heads=H,
                                   rope_theta=cfg.rope_theta)

        def attend_k():
            w, c, r = sets[it[0] % MLA_KERNEL_SETS]
            it[0] += 1
            mla_decode.absorbed_attend(q, qr_k, w, c, r, pos, n_heads=H,
                                       v_head_dim=Dv, scale=scale)

        def attend_p():
            w, c, r = sets[it[0] % MLA_KERNEL_SETS]
            it[0] += 1
            ref.mla_absorbed_attend_ref(q, qr_k, w, c, r, pos, n_heads=H,
                                        v_head_dim=Dv, scale=scale)

        n_read = float((pos + 1).sum().item())   # positions the rows read
        work = {
            "mla_rope_write": (
                2.0 * B * (2 * H * Dr + 2 * (C + Dr)) + 4.0 * C + 2.0 * Dr
                + 8.0 * B, 0.0, write_k, write_p, 0.0),
            "mla_absorbed_attend": (
                2.0 * B * H * (Dn + Dr + Dv) + 2.0 * C * H * (Dn + Dv)
                + 2.0 * n_read * (C + Dr) + 8.0 * B,
                2.0 * H * (B * C * (Dn + Dv) + n_read * (2 * C + Dr)),
                attend_k, attend_p, err)}
        for name, (nbytes, flops, kern, pl, e) in work.items():
            ms, hms = med_ms(kern, torch, rate)
            t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
            row = dict(ms=ms, host_ms=hms, wall_ms=wall_ms(kern, torch),
                       plain_ms=wall_ms(pl, torch),
                       bytes_bound_ms=t_b * 1e3,
                       f32_ops_bound_ms=t_o * 1e3,
                       bound_ms=max(t_b, t_o) * 1e3,
                       bound_by="bytes" if t_b >= t_o else "f32 operations",
                       max_abs_err=e, shape=[B, T, H, C, Dr, Dn, Dv])
            print(f"{label} shapes: {name} {ms:.6g} ms on the device, bound "
                  f"{row['bound_ms']:.6g} ms ({row['bound_by']}; bytes "
                  f"{row['bytes_bound_ms']:.6g} ms), "
                  f"{row['bound_ms'] / ms:.4g} of the bound; host clock a "
                  f"call: kernel {row['wall_ms']:.6g} ms, plain "
                  f"{row['plain_ms']:.6g} ms; the host takes {hms:.6g} ms "
                  f"to enqueue one", flush=True)
            rows[name][label] = row
        del sets, ckv, k_rope, plain, wkv_b
        gc.collect()
        torch.cuda.empty_cache()
    out = {}
    for name, by in rows.items():
        first = by["dsv2lite"]
        out[name] = dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/mla_decode.cu",
            replaces="none (MLA decode was eager PyTorch)",
            library_ms=None, kanana2=by["kanana2"],
            **{k: first[k] for k in ("ms", "host_ms", "plain_ms", "bound_ms",
                                     "bound_by", "max_abs_err", "shape")})
    print(json.dumps({"mla_kernels": rows}), flush=True)
    return out


# the kernels' entry functions in the ptxas log, by the name phase 2 gives
PTXAS_NAMES = {"splice": r"zipmoe_splice_kernel",
               "splice_admit": r"zipmoe_splice_admit_kernel",
               "SlabSource": r"gemm_kernel\w*SlabSource",
               "StackSource": r"gemm_kernel\w*StackSource",
               "PlaneSource": r"gemm_kernel\w*PlaneSource",
               "mla_rope_write": r"mla_rope_write_kernelI13__nv_bfloat16E",
               "mla_absorbed_attend":
                   r"mla_absorbed_attend_kernelI13__nv_bfloat16E"}


def ptxas_usage(_build):
    """Registers, static shared memory and spill bytes of each kernel (the
    two splices and the three GEMM instantiations), from the build's
    ``nvcc -Xptxas -v`` log."""
    log = (Path(_build.BUILD_INFO["path"]).parent / "ptxas.log").read_text()
    out = {}
    for entry in log.split("Compiling entry function")[1:]:
        head = entry.splitlines()[0]
        name = next((n for n, pat in PTXAS_NAMES.items()
                     if re.search(pat, head)), None)
        if name is None:
            continue
        regs = re.search(r"Used (\d+) registers", entry)
        smem = re.search(r"(\d+) bytes smem", entry)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", entry)
        check(regs is not None and spill is not None,
              f"ptxas log has no register line for {name}")
        out[name] = {"registers": int(regs.group(1)),
                     "static_smem": int(smem.group(1)) if smem else 0,
                     "spill_stores": int(spill.group(1)),
                     "spill_loads": int(spill.group(2))}
    check(sorted(out) == sorted(PTXAS_NAMES),
          f"ptxas log names {sorted(out)}, expected {sorted(PTXAS_NAMES)}")
    return out


# ----------------------------------------------------------------------------
# phase 3: the main path at full width
# ----------------------------------------------------------------------------
def serve(torch, zs, prompt, steps, t_len, before_step=None, drain=False,
          caches=None, start=0):
    """Greedy decode of `prompt` for `steps` tokens from position `start`
    (over `caches`, or an empty cache of `t_len`); the launch counters are
    reset just before the first step and read just after the last (after
    the prefetch jobs still in flight finished, with `drain`).  A step
    ends when its token is known on the host; ``before_step(zs, i)`` runs
    before step i, outside its time.  Returns the step inputs, logits, host
    step times, served tokens, launches, stats and the final caches."""
    from repro_torch.kernels import _build
    if caches is None:
        caches = zs.init_cache(prompt.shape[0], t_len)
    tok = prompt
    inputs, logits, times = [], [], []
    torch.cuda.synchronize()
    _build.reset_launches()
    for i in range(steps):
        if before_step is not None:
            before_step(zs, i)
        t1 = time.perf_counter()
        inputs.append(tok)
        lg, caches = zs.decode_step(tok, caches, start + i)
        tok = torch.argmax(lg[:, -1], dim=-1)[:, None]
        tok.cpu()
        times.append(time.perf_counter() - t1)
        logits.append(lg)
    if drain:
        zs.drain_pending()
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    served = torch.cat(inputs[1:] + [tok], dim=1).cpu().numpy()
    return dict(inputs=inputs, logits=logits, times=times, served=served,
                launches=launches, stats=list(zs.stats),
                overlap=zs.overlap_summary(), cache=zs.cache_summary(),
                caches=caches)


def path_numbers(run, n_moe: int):
    """TPOT over steps 2.., blocked time per step, traffic counters."""
    steps = len(run["times"])
    stats, ov = run["stats"], run["overlap"]
    return {"tpot_ms": statistics.mean(run["times"][1:]) * 1e3,
            "blocked_ms": sum(s["blocked_s"] for s in stats[n_moe:])
            / (steps - 1) * 1e3,
            "first_step_ms": run["times"][0] * 1e3,
            "h2d_bytes": ov["h2d_bytes"], "w_copy_bytes": ov["w_copy_bytes"],
            "splice_ops": ov["splice_ops"], "steps": steps,
            "hit_rate": run["cache"].get("hit_rate")}


def check_resident(torch, np, dev, cfg, params, run, what: str,
                   caches=None, start=0):
    """Hold a served run's logits against the resident model under teacher
    forcing, from position `start` over `caches` (or an empty cache).
    Rows are independent requests.  A token whose router picks
    another expert set in the two models (a near-tie in router
    probabilities flipped by bf16 noise) takes another FFN, and its row's
    KV cache differs from then on: such a row is reported and left out of
    the logit comparison for the rest of the run."""
    from repro_torch.models import decode_step, init_cache
    n_moe = len(cfg_moe_layers(cfg))
    steps = len(run["inputs"])
    rcache = init_cache(cfg, BATCH, steps + 1, device=dev) \
        if caches is None else caches
    served_routes = [s["routes"] for s in run["stats"]]
    live = np.ones(BATCH, bool)
    worst, agree, compared, flips = 0.0, 0, 0, []
    for i in range(steps):
        ids = []
        rl, rcache = decode_step(params, cfg, run["inputs"][i], rcache,
                                 start + i, router_ids=ids)
        for j, r_ids in enumerate(ids):
            mine = served_routes[i * n_moe + j]
            theirs = r_ids.reshape(BATCH, -1).cpu().numpy()
            for b in range(BATCH):
                if live[b] and set(mine[b]) != set(theirs[b]):
                    live[b] = False
                    flips.append((i, j, b))
        a, b_ = run["logits"][i].float(), rl.float()
        check(bool(torch.isfinite(a).all()),
              f"{what}: non-finite logits at step {i}")
        check(a.shape == (BATCH, 1, cfg.vocab_size), f"logits {a.shape}")
        agree += int((a.argmax(-1) == b_.argmax(-1)).sum().item())
        if not live.any():
            continue
        rows = torch.from_numpy(np.flatnonzero(live)).to(dev)
        err = (a[rows] - b_[rows]).abs().max().item()
        scale = b_[rows].abs().max().item()
        worst = max(worst, err / scale)
        compared += int(live.sum())
        check(err <= LOGIT_REL_TOL * scale,
              f"{what} step {i}: served vs resident logits differ by {err} "
              f"(> {LOGIT_REL_TOL} x {scale}) on identically routed rows "
              f"{np.flatnonzero(live).tolist()}")
    check(compared >= BATCH * steps // 2,
          f"{what}: only {compared} (step, row) pairs routed identically")
    print(f"{what}: served vs resident logits on identically routed rows "
          f"({compared}/{BATCH * steps} (step, row) pairs; routing flips at "
          f"(step, layer, row) {flips}): max |diff| / max |logit| = "
          f"{worst:.4g} (tolerance {LOGIT_REL_TOL}); greedy tokens agree "
          f"{agree}/{BATCH * steps}", flush=True)
    return worst


def same_logits(torch, a, b) -> bool:
    return all(torch.equal(x.view(torch.int16), y.view(torch.int16))
               for x, y in zip(a["logits"], b["logits"]))


def warm_hit_run(torch, zs, cfg, prompt, steps: int = 4):
    """Warm every expert into F (the slab in device mode), then serve
    `steps` steps; steps 2.. are full cache hits.  Returns the run plus
    the h2d / weight-copy bytes of those hit steps and their host and
    stream times."""
    from repro_torch.kernels import _build
    for l in zs._moe_layers:
        zs.engine.fetch_experts(l, list(range(cfg.n_experts)))
    caches = zs.init_cache(BATCH, steps + 1)
    lg, caches = zs.decode_step(prompt, caches, 0)
    tok = torch.argmax(lg[:, -1], dim=-1)[:, None]
    logits = [lg]
    h2d0, w0 = zs.engine.h2d_bytes, zs.engine.w_copy_bytes
    torch.cuda.synchronize()
    _build.reset_launches()
    host_ms, dev_ms = [], []
    for i in range(1, steps):
        torch.cuda.synchronize()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        t1 = time.perf_counter()
        ev0.record()
        lg, caches = zs.decode_step(tok, caches, i)
        tok = torch.argmax(lg[:, -1], dim=-1)[:, None]
        ev1.record()
        tok.cpu()
        host_ms.append((time.perf_counter() - t1) * 1e3)
        dev_ms.append(ev0.elapsed_time(ev1))
        logits.append(lg)
    torch.cuda.synchronize()
    return {"logits": logits, "launches": dict(_build.LAUNCHES),
            "h2d_bytes": zs.engine.h2d_bytes - h2d0,
            "w_copy_bytes": zs.engine.w_copy_bytes - w0,
            "tpot_ms": statistics.mean(host_ms),
            "stream_ms": statistics.mean(dev_ms)}


def check_lossless(torch, store, params, cfg, dev):
    """Every tensor of every store group (a MoE layer's experts, a dense
    layer's FFN as group (l, 0)) loads back bit-exactly."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.core import bitfield
    from repro_torch.core.store import iter_expert_groups
    want = {(l, e): t for l, e, t in iter_expert_groups(params, cfg)}
    keys = sorted(store.groups)
    check(keys == sorted(want), f"store groups {len(keys)} != the model's "
          f"{len(want)}")
    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        loaded = pool.map(lambda key: (key, store.load_group(key)), keys)
        n_t = 0
        for key, group in loaded:
            for name, bits in group.items():
                got = bitfield.from_bits(bits).to(dev)
                check(torch.equal(got.view(torch.int16),
                                  want[key][name].view(torch.int16)),
                      f"store tensor {key + (name,)} not bit-exact")
                n_t += 1
    print(f"lossless: {n_t} expert tensors load bit-exactly", flush=True)
    return n_t


def main_path(torch, np, dev, cfg, store_dir):
    """Build one full-width store, then serve every path from it.  Returns
    each path's launch counts and numbers."""
    from repro_torch.core.codec import DEFAULT_CODEC
    from repro_torch.core.store import build_store
    from repro_torch.models import init_params
    from repro_torch.serving.zipserve import ZipServer

    t0 = time.perf_counter()
    params = init_params(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    print(f"init_params: {time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    store = build_store(params, cfg, store_dir, device=dev)
    build_s = time.perf_counter() - t0
    print(f"build_store: codec {store.codec.name} (default {DEFAULT_CODEC}), "
          f"{len(store.groups)} groups, {os.cpu_count()} threads, "
          f"{build_s:.1f} s, ratio {store.ratio():.4f}", flush=True)

    check_lossless(torch, store, params, cfg, dev)
    store.close()

    rng = np.random.default_rng(SEED)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (BATCH, 1))
                              ).to(dev)
    n_moe = len(cfg_moe_layers(cfg))
    launches, numbers = {}, {"build_store_s": build_s}

    def server(**kw):
        return ZipServer(params, cfg, store_dir, L=6, prefetch=True,
                         device=dev, **kw)

    def run_path(name, steps, before_step=None, drain=False, inspect=None,
                 **kw):
        zs = server(**kw)
        try:
            run = serve(torch, zs, prompt, steps, steps + 1, before_step,
                        drain)
            if kw.get("profile_p_times"):
                run["p_times"] = zs.p_time_summary()
            if inspect is not None:
                run["inspect"] = inspect(zs)
        finally:
            zs.close()
        launches[name] = run["launches"]
        numbers[name] = path_numbers(run, n_moe)
        print(f"{name}: served {run['served'].tolist()}; launches "
              f"{run['launches']}; {json.dumps(numbers[name])}", flush=True)
        return run

    # -- the slice-1 path: small pools, device slabs, ragged FFN -----------
    ragged = run_path("ragged", NEW_TOKENS, pool_sizes=POOLS_SMALL,
                      device_cache=True, ffn_impl="ragged")
    numbers["ragged"]["logit_rel_err"] = check_resident(
        torch, np, dev, cfg, params, ragged, "ragged")

    # -- (a) fused recovery, one batched zip GEMM per projection -----------
    fused = run_path("fused-grouped", NEW_TOKENS, pool_sizes=POOLS_SMALL,
                     fused_recovery=True, ffn_impl="grouped")
    numbers["fused-grouped"]["logit_rel_err"] = check_resident(
        torch, np, dev, cfg, params, fused, "fused-grouped")
    check(numbers["fused-grouped"]["splice_ops"] == 0,
          "the fused path ran standalone splices")

    # -- (b) fused recovery, one zip GEMM per expert: the same bits --------
    loop = run_path("fused-loop", NEW_TOKENS, pool_sizes=POOLS_SMALL,
                    fused_recovery=True, ffn_impl="loop")
    check(same_logits(torch, fused, loop),
          "fused loop logits differ from the fused batched path")
    check(numbers["fused-loop"]["h2d_bytes"]
          == numbers["fused-grouped"]["h2d_bytes"],
          "fused loop and batched paths uploaded other plane bytes")
    print("fused-loop: logits bit-identical to fused-grouped", flush=True)
    del fused, loop

    # -- (c) every expert slab-resident: ragged vs grouped FFN -------------
    ample = {"F": cfg.n_experts, "C": 0, "S": 0, "E": 0}
    hits = {}
    for impl in ("ragged", "grouped"):
        zs = server(pool_sizes=ample, device_cache=True, ffn_impl=impl)
        try:
            hits[impl] = warm_hit_run(torch, zs, cfg, prompt)
        finally:
            zs.close()
        name = f"{impl}-cache-hit"
        launches[name] = hits[impl]["launches"]
        numbers[name] = {k: v for k, v in hits[impl].items()
                         if k not in ("logits", "launches")}
        print(f"{name}: launches {launches[name]}; "
              f"{json.dumps(numbers[name])}", flush=True)
    check(hits["ragged"]["h2d_bytes"] == 0
          and hits["ragged"]["w_copy_bytes"] == 0,
          f"ragged cache-hit steps moved {hits['ragged']}")
    check(hits["grouped"]["h2d_bytes"] == 0
          and hits["grouped"]["w_copy_bytes"] > 0,
          "grouped cache-hit steps: expected 0 h2d and a weight copy, got "
          f"{numbers['grouped-cache-hit']}")
    check(same_logits(torch, hits["ragged"], hits["grouped"]),
          "grouped cache-hit logits differ from the ragged ones")
    n_hit = 3 * 3 * n_moe                 # steps x projections x layers
    check(launches["ragged-cache-hit"]["slab_gemm"] == n_hit,
          f"ragged cache-hit steps: {launches['ragged-cache-hit']}")
    check(launches["grouped-cache-hit"]["grouped_gemm"] == n_hit,
          f"grouped cache-hit steps: {launches['grouped-cache-hit']}")
    print("grouped-cache-hit: logits bit-identical to ragged-cache-hit",
          flush=True)
    del hits

    # -- (d) measured p-times ----------------------------------------------
    prof = run_path("profile", PROFILE_STEPS, pool_sizes=POOLS_SMALL,
                    device_cache=True, profile_p_times=True)
    pt = prof["p_times"]
    measured = {k: b for k, b in pt["buckets"].items()
                if "measured" in b["source"]}
    check(pt["n_measurements"] > 0 and measured,
          f"profile_p_times measured no bucket: {pt}")
    numbers["profile"]["p_time_buckets"] = pt["buckets"]
    print(f"profile: {pt['n_measurements']} buckets measured in "
          f"{pt['measure_wall_s'] * 1e3:.1f} ms: {pt['buckets']}", flush=True)
    del prof

    # -- (e) device recovery: splices on the engine's worker threads -------
    # each worker launches on its thread's current stream and synchronises
    # it before handing the tensor over; bit-identical logits show the
    # decode thread never read a tensor whose splice was still queued
    devrec = run_path("device-recovery", NEW_TOKENS, drain=True,
                      pool_sizes=POOLS_SMALL, device_recovery=True,
                      ffn_impl="grouped")
    lr = devrec["launches"]
    check(same_logits(torch, ragged, devrec),
          "device-recovery logits differ from the ragged path's")
    check(lr["splice"] == devrec["overlap"]["splice_ops"] > 0,
          f"device-recovery: {lr['splice']} splice launches, the engine "
          f"counted {devrec['overlap']['splice_ops']} splices")
    check(lr["grouped_gemm"] > 0, f"device-recovery launches {lr}")
    print("device-recovery: logits bit-identical to ragged; splice launches "
          f"= engine splices = {lr['splice']}", flush=True)
    del devrec

    # -- (f) live §3.4 planning under one byte budget ----------------------
    f_bytes = store.groups[min(store.groups)].full_bytes
    budget = PLAN_BUDGET_EXPERTS * f_bytes

    def forced_replan(zs, i):
        if i == PLAN_FORCED_AT:
            zs.engine.replan(reason="forced")

    def plan_info(zs):
        return {"plan": zs.plan_summary(),
                "consts": {l: dataclasses.asdict(zs.engine.plan_consts(l))
                           for l in zs._moe_layers}}

    # earlier servers' slabs live until the collector breaks their
    # engine <-> cache cycles: collect first, so the peak is this path's
    gc.collect()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    planned = run_path("planned", NEW_TOKENS, before_step=forced_replan,
                       inspect=plan_info, device_cache=True,
                       ffn_impl="ragged", mem_budget=budget,
                       replan_every=PLAN_REPLAN_EVERY)
    peak = torch.cuda.max_memory_allocated()
    ps, consts = planned["inspect"]["plan"], planned["inspect"]["consts"]
    events = [{"step": ev["step"], "reason": ev["reason"],
               "wall_ms": ev["wall_s"] * 1e3,
               "sizes": {str(l): sz for l, sz in ev["sizes"].items()}}
              for ev in ps["replans"]]
    gave_f = any(sz.get("F", 0) > 0 for ev in ps["replans"]
                 for sz in ev["sizes"].values())
    print(f"planned: budget {budget} B ({PLAN_BUDGET_EXPERTS} experts x "
          f"{f_bytes} B); profiled PlanConsts per layer {consts}", flush=True)
    for ev in events:
        print(f"planned: plan at step {ev['step']} ({ev['reason']}) in "
              f"{ev['wall_ms']:.3f} ms: sizes {ev['sizes']}", flush=True)
    check(same_logits(torch, ragged, planned),
          "planned logits differ from the ragged path's")
    check(ps["n_plans"] >= 2 and ps["n_replans"] >= 1,
          f"planned: {ps['n_plans']} plans, {ps['n_replans']} re-plans")
    check(ps["bytes_resident"] <= budget,
          f"planned: {ps['bytes_resident']} B resident > budget {budget} B")
    need = "splice_admit" if gave_f else "splice"
    check(planned["launches"][need] > 0,
          f"planned: plans {'gave' if gave_f else 'did not give'} F bytes "
          f"but {need} never launched: {planned['launches']}")
    numbers["planned"].update(
        budget_bytes=budget, plans=events, consts=consts, f_gets_bytes=gave_f,
        bytes_resident=ps["bytes_resident"], peak_mem_bytes=peak,
        mem_before_bytes=base_mem,
        replan_ms=[ev["wall_ms"] for ev in events])
    print(f"planned: logits bit-identical to ragged; F bytes planned: "
          f"{gave_f}; resident {ps['bytes_resident']} B; device memory "
          f"{base_mem} B allocated before the path, {peak} B at its peak",
          flush=True)
    del planned

    # -- (g) the serving front end: continuous, solo, static, resident -----
    launches["continuous"], numbers["serving"] = serving_phase(
        torch, np, dev, cfg, params, store_dir)

    # -- (h) slab migration on the engine, with pinned planning constants --
    launches["migration"], numbers["migration"] = migration_run(
        torch, np, dev, cfg, store_dir, store.groups[min(store.groups)])
    return launches, numbers


# ----------------------------------------------------------------------------
# phase 3, the serving front end
# ----------------------------------------------------------------------------
def serve_requests(torch, cfg, prompts, arrivals, max_len, *, params=None,
                   zs=None, continuous=True, count=False,
                   concurrency=SERVE_CONCURRENCY):
    """One BatchServer run of `prompts` (greedy, each recording its logits,
    at most `concurrency` at once); with `count` the launch counters are
    reset just before ``run()`` and read just after it (prefetch jobs
    drained first).  Returns the server, its finished requests in rid
    order, launches, and the wall seconds and device memory (allocated
    before, peak) of the run."""
    from repro_torch.kernels import _build
    from repro_torch.serving.server import BatchServer
    srv = BatchServer(params if zs is None else None, cfg,
                      max_batch=concurrency, max_len=max_len,
                      zip_server=zs, max_concurrency=concurrency,
                      continuous=continuous)
    for p, a in zip(prompts, arrivals):
        srv.submit(p, SERVE_NEW_TOKENS, arrival_s=a, record_logits=True)
    torch.cuda.synchronize()
    mem = {"mem_before_bytes": torch.cuda.memory_allocated()}
    torch.cuda.reset_peak_memory_stats()
    if count:
        _build.reset_launches()
    t0 = time.perf_counter()
    done = sorted(srv.run(), key=lambda r: r.rid)
    if zs is not None:
        zs.drain_pending()
    torch.cuda.synchronize()
    mem["wall_s"] = time.perf_counter() - t0
    mem["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    return srv, done, dict(_build.LAUNCHES) if count else None, mem


def serving_numbers(name, srv, done, run):
    """Print and return a serving path's end-to-end numbers (with the
    run's wall time and memory from `serve_requests`) and its per-request
    table."""
    m = srv.metrics()
    keys = ("ttft_p50_s", "ttft_p95_s", "tpot_p50_s", "tpot_p95_s",
            "queue_delay_p50_s", "queue_delay_p95_s", "throughput_tok_s",
            "mean_ttft_s", "mean_tpot_s", "cache_hit_rate",
            "overlap_blocking_s", "overlap_fetch_wait_s",
            "overlap_h2d_bytes", "overlap_splice_ops")
    out = {k: m[k] for k in keys if k in m}
    out.update(run)
    pool = getattr(srv, "pool", None)
    out["kv_pool_bytes"] = pool.pool_bytes() if pool is not None else None
    out["kv_used_bytes_after"] = pool.used_bytes() if pool is not None \
        else None
    if srv.zip is not None:
        stats = srv.zip.stats
        out["decode_steps"] = steps = len(stats) // max(
            1, len(srv.zip._moe_layers))
        out["blocked_ms_per_step"] = sum(s["blocked_s"] for s in stats) \
            / steps * 1e3
    table = srv.request_summary()
    out["requests"] = {str(rid): {k: v for k, v in d.items()
                                  if k != "error"} for rid, d in
                       table.items()}
    print(f"{name}: {json.dumps({k: v for k, v in out.items() if k != 'requests'})}",
          flush=True)
    for rid, d in sorted(table.items()):
        r = next(r for r in done if r.rid == rid)
        cells = [f"S={len(r.prompt)}", f"toks={d['n_tokens']}"]
        for key, label in (("ttft_s", "ttft"), ("tpot_s", "tpot"),
                           ("queue_delay_s", "qdelay")):
            if d[key] is not None:
                cells.append(f"{label}={d[key] * 1e3:.3f}ms")
        if "cache_hit_rate" in d:
            cells.append(f"hit_rate={d['cache_hit_rate']:.3f} "
                         f"({d['cache_hits']}/{d['cache_accesses']})")
        print(f"{name}: request[{rid}] " + " ".join(cells), flush=True)
    return out


def served_routes(zs):
    """Per request: per MoE layer, the expert set routed at each of its
    positions, from the server's per-step stats (rows mapped by owner)."""
    out = {}
    for st in zs.stats:
        for b, rid in enumerate(st["owners"]):
            out.setdefault(rid, {}).setdefault(st["layer"], []).append(
                set(int(e) for e in st["routes"][b]))
    return out


def check_requests_resident(torch, np, dev, cfg, params, done, routes,
                            what: str = "continuous",
                            prefill_as_decode: bool = False,
                            min_share: float = 0.5):
    """Hold each served request against the resident model fed its prompt
    and outputs (teacher forcing): ``prefill`` then ``decode_step``, or
    with `prefill_as_decode` one ``decode_step`` per prompt token as the
    server reads it.  A position whose routed experts differ in the two
    models (a router near-tie flipped by bf16 noise), or whose (token,
    slot) the resident prefill drops past its group capacity, takes
    another FFN and is reported.  In the last layer that changes only the
    position's own output (no later layer caches it), which is left out;
    in an earlier layer the request is compared only before it.  Fails
    unless at least `min_share` of the outputs were compared."""
    from repro_torch.models import decode_step, init_cache, prefill
    from repro_torch.models.moe import _positions, group_capacity
    from repro_torch.serving.kv_cache import grow_cache
    moe_layers = cfg_moe_layers(cfg)
    last = cfg.n_layers - 1
    worst, compared, total, flips = 0.0, 0, 0, []
    for r in done:
        S, N = len(r.prompt), len(r.output)
        total += N
        resident = {l: [] for l in moe_layers}
        first_bad, skip = S + N, set()
        if prefill_as_decode:
            caches = init_cache(cfg, 1, S + N, device=dev)
            logits = []
            seq = list(r.prompt) + list(r.output[:-1])
            for s_, tok_id in enumerate(seq):
                step_ids = []
                tok = torch.tensor([[int(tok_id)]], dtype=torch.long,
                                   device=dev)
                lg, caches = decode_step(params, cfg, tok, caches, s_,
                                         router_ids=step_ids)
                if s_ >= S - 1:
                    logits.append(lg[0, -1])
                for l, ti in zip(moe_layers, step_ids):
                    resident[l].append(set(int(e)
                                           for e in ti[0, 0].tolist()))
        else:
            ids = []
            prompt = torch.as_tensor(r.prompt, dtype=torch.long,
                                     device=dev)[None]
            lg, caches = prefill(params, cfg, prompt, router_ids=ids)
            for l, ti in zip(moe_layers, ids):
                resident[l] = [set(int(e) for e in ti[0, s].tolist())
                               for s in range(S)]
            cap = group_capacity(S, cfg)
            for l, ti in zip(moe_layers, ids):
                kept = (_positions(ti, cfg.n_experts) < cap)[0].all(-1)
                if not bool(kept.all()):
                    s = int((~kept).nonzero()[0, 0])
                    first_bad = min(first_bad, s)
                    flips.append((r.rid, s, l, "dropped"))
            caches = grow_cache(cfg, caches, 1, S + N)
            logits = [lg[0, -1]]
            for t in range(N - 1):
                step_ids = []
                tok = torch.tensor([[r.output[t]]], dtype=torch.long,
                                   device=dev)
                lg, caches = decode_step(params, cfg, tok, caches, S + t,
                                         router_ids=step_ids)
                logits.append(lg[0, -1])
                for l, ti in zip(moe_layers, step_ids):
                    resident[l].append(set(int(e)
                                           for e in ti[0, 0].tolist()))
        for l in moe_layers:
            mine = routes[r.rid][l]
            check(len(mine) == S + N - 1,
                  f"request {r.rid}: {len(mine)} served positions in layer "
                  f"{l}, expected {S + N - 1}")
            for s, (a, b) in enumerate(zip(mine, resident[l])):
                if a == b or s >= first_bad:
                    continue
                flips.append((r.rid, s, l, "flip"))
                if l == last:
                    skip.add(s)
                    continue
                first_bad = s
                break
        for t in range(N):
            want = logits[t].float()
            got = torch.from_numpy(r.logits[t]).to(dev)
            check(bool(torch.isfinite(got).all()),
                  f"request {r.rid}: non-finite logits at output {t}")
            if S - 1 + t >= first_bad:
                break
            if S - 1 + t in skip:
                continue
            err = (got - want).abs().max().item()
            scale = want.abs().max().item()
            worst = max(worst, err / scale)
            compared += 1
            check(err <= LOGIT_REL_TOL * scale,
                  f"{what} request {r.rid} output {t}: served vs "
                  f"resident logits differ by {err} (> {LOGIT_REL_TOL} x "
                  f"{scale}) on an identically routed prefix")
    print(f"{what}: served vs resident ({'prefill as decode' if prefill_as_decode else 'prefill'}) "
          f"logits on identically routed positions ({compared}/{total} "
          f"outputs; flips and drops at (rid, position, layer) {flips}): max "
          f"|diff| / max |logit| = {worst:.4g} (tolerance {LOGIT_REL_TOL})",
          flush=True)
    check(compared >= min_share * total,
          f"{what}: only {compared} of {total} outputs routed "
          f"identically to the resident model")
    return worst, compared, flips


def batch_variance_probe(torch, dev, cfg, params):
    """Which of a decode step's products give a row other bits in a batch
    of SERVE_CONCURRENCY than alone, on this card at the served widths:
    row 0 of each batched product against the same row computed alone.
    With MLA the attention probes are the absorbed f32 products and the
    whole absorbed attention."""
    lp = next(lay for lay in params["layers"]
              if "router" in lay.get("ffn", {}))
    g = torch.Generator(device=dev).manual_seed(SEED)
    B, d = SERVE_CONCURRENCY, cfg.d_model
    x = torch.randn((B, 1, d), generator=g, device=dev).to(torch.bfloat16)
    probes = {
        "router f32 (x.float() @ router)":
            lambda v: v.float() @ lp["ffn"]["router"],
        "q projection bf16": lambda v: v @ lp["attn"]["wq"],
        "shared-expert gate bf16": lambda v: v @ lp["ffn"]["shared"]["w_gate"],
        "lm head bf16": lambda v: v @ params["lm_head"]["w"],
    }
    if cfg.attn == "mla":
        probes["latent projection bf16 (wkv_a)"] = \
            lambda v: v @ lp["attn"]["wkv_a"]
    out = {}
    for name, fn in probes.items():
        out[name] = bool(torch.equal(fn(x)[:1], fn(x[:1])))
    if cfg.attn == "mla":
        out.update(mla_variance_probe(torch, dev, cfg, lp["attn"], x, g))
        print(f"batch-invariance on the card, {cfg.name} (row alone == row "
              f"in a batch of {B}): {out}", flush=True)
        return out
    # attention: row 0 at position 5 over T = 16 in a batch padded to 32
    from repro_torch.models.attention import _gqa_scores_to_out
    shape = (B, 32, cfg.n_kv_heads, cfg.head_dim)
    q = torch.randn((B, 1, cfg.n_heads, cfg.head_dim), generator=g,
                    device=dev).to(torch.bfloat16)
    k = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    pos = torch.tensor([5, 31, 20, 9], device=dev)[:B]
    mask = (torch.arange(32, device=dev)[None] <= pos[:, None])[:, None]
    full = _gqa_scores_to_out(q, k, v, mask)
    alone = _gqa_scores_to_out(q[:1], k[:1, :16], v[:1, :16],
                               mask[:1, :, :16])
    out["attention over a padded T"] = bool(torch.equal(
        full[:1].view(torch.int16), alone.view(torch.int16)))
    print(f"batch-invariance on the card (row alone == row in a batch of "
          f"{B}): {out}", flush=True)
    return out


def mla_variance_probe(torch, dev, cfg, p, x, g):
    """The absorbed MLA decode's f32 products as its plain version takes
    them, row 0 in a batch of B against row 0 alone, over a random latent
    cache of T = 32; and the attend kernel (``ops.mla_absorbed_attend``)
    on row 0 at position 5 alone over T = 6, in the batch over T = 32 and
    in the batch over a T of 48 padded with junk: bit-equal on the card
    (checked there)."""
    from repro_torch.kernels import ops
    from repro_torch.models.attention import _mla_q, _mla_q_proj, _mla_scale
    B, T = x.shape[0], 32
    q_nope, q_rope = _mla_q(p, x, cfg)
    ckv = torch.randn((B, T, cfg.kv_lora_rank), generator=g,
                      device=dev).to(torch.bfloat16)
    k_rope = torch.randn((B, T, cfg.qk_rope_dim), generator=g,
                         device=dev).to(torch.bfloat16)
    wkv_b = p["wkv_b"].reshape(cfg.kv_lora_rank, cfg.n_heads,
                               cfg.qk_nope_dim + cfg.v_head_dim).float()
    w_k, w_v = wkv_b[:, :, :cfg.qk_nope_dim], wkv_b[:, :, cfg.qk_nope_dim:]
    q_c = torch.einsum("bshd,chd->bshc", q_nope.float(), w_k)
    sc = torch.einsum("bshc,btc->bhst", q_c, ckv.float())
    attn = torch.softmax(sc, dim=-1)
    o_c = torch.einsum("bhst,btc->bshc", attn, ckv.float())
    probes = {
        "MLA q absorption f32 (q_nope . w_k)": lambda n: torch.einsum(
            "bshd,chd->bshc", q_nope[:n].float(), w_k),
        "MLA scores over the latent f32": lambda n: torch.einsum(
            "bshc,btc->bhst", q_c[:n], ckv[:n].float()),
        "MLA latent weighted sum f32": lambda n: torch.einsum(
            "bhst,btc->bshc", attn[:n], ckv[:n].float()),
        "MLA value absorption f32 (o_c . w_v)": lambda n: torch.einsum(
            "bshc,chd->bshd", o_c[:n], w_v),
    }
    out = {name: bool(torch.equal(fn(B)[:1], fn(1)))
           for name, fn in probes.items()}
    q = _mla_q_proj(p, x, cfg)
    qr = q_rope.contiguous()
    pos = torch.tensor([5, 31, 20, 9], device=dev)[:B]

    def attend(n, c, r):
        return ops.mla_absorbed_attend(
            q[:n], qr[:n], p["wkv_b"], c, r, pos[:n], n_heads=cfg.n_heads,
            v_head_dim=cfg.v_head_dim, scale=_mla_scale(cfg))

    full = attend(B, ckv, k_rope)
    junk = torch.full((B, 16, cfg.kv_lora_rank + cfg.qk_rope_dim), 7.0,
                      device=dev, dtype=torch.bfloat16)
    padded = attend(B, torch.cat([ckv, junk[..., :cfg.kv_lora_rank]], 1),
                    torch.cat([k_rope, junk[..., cfg.kv_lora_rank:]], 1))
    alone = attend(1, ckv[:1, :6].contiguous(), k_rope[:1, :6].contiguous())
    name = ("MLA attend kernel: row alone == row in the batch == row under "
            "a padded T")
    out[name] = bool(torch.equal(full.view(torch.int16),
                                 padded.view(torch.int16))
                     and torch.equal(full[:1].view(torch.int16),
                                     alone.view(torch.int16)))
    if dev.type == "cuda":
        check(out[name], f"{name}: does not hold on the card")
    return out


def serving_traffic(np, cfg):
    """The serving phase's requests: prompt lengths, prompts drawn from
    `cfg`'s vocabulary, and the longest request's length."""
    rng = np.random.default_rng(SEED)
    lo, hi = SERVE_PROMPT_LENS
    lens = rng.integers(lo, hi + 1, SERVE_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)) for n in lens]
    return lens, prompts, int(max(lens)) + SERVE_NEW_TOKENS


def serving_phase(torch, np, dev, cfg, params, store_dir):
    """Continuous batching, two requests alone, the static baseline, the
    resident server and the CLI.  Returns the continuous path's launches
    and every path's numbers."""
    from repro_torch.serving.zipserve import ZipServer
    lens, prompts, max_len = serving_traffic(np, cfg)
    print(f"serving: {SERVE_REQUESTS} requests, prompt lengths "
          f"{lens.tolist()}, {SERVE_NEW_TOKENS} greedy tokens each, "
          f"concurrency {SERVE_CONCURRENCY}, arrivals {list(SERVE_ARRIVALS)} "
          f"s, pools {POOLS_SMALL}", flush=True)
    numbers = {"prompt_lens": lens.tolist()}

    def zip_server():
        gc.collect()
        return ZipServer(params, cfg, store_dir, L=6, prefetch=True,
                         device=dev, pool_sizes=POOLS_SMALL,
                         device_cache=True, ffn_impl="ragged")

    # -- continuous batching over the ragged device-slab path --------------
    zs = zip_server()
    try:
        srv, cont, launches, run = serve_requests(
            torch, cfg, prompts, SERVE_ARRIVALS, max_len, zs=zs, count=True)
        routes = served_routes(zs)
    finally:
        zs.close()
    numbers["continuous"] = serving_numbers("continuous", srv, cont, run)
    print(f"continuous: launches {launches}", flush=True)
    for r in cont:
        check(r.error is None and len(r.output) == SERVE_NEW_TOKENS
              and len(r.logits) == SERVE_NEW_TOKENS,
              f"continuous request {r.rid}: {len(r.output)} tokens, error "
              f"{r.error}")
    check(srv.pool.used_bytes() == 0,
          f"continuous: {srv.pool.used_bytes()} KV bytes still held")
    worst, compared, flips = check_requests_resident(
        torch, np, dev, cfg, params, cont, routes)
    numbers["continuous"].update(logit_rel_err=worst, outputs_compared=compared,
                                 flips=flips)

    # -- two requests alone: continuous == solo? ---------------------------
    solo_out = {}
    for i in SERVE_SOLO:
        zs = zip_server()
        try:
            _, solo, _, _ = serve_requests(torch, cfg, [prompts[i]], [0.0],
                                           max_len, zs=zs)
        finally:
            zs.close()
        a, b = solo[0], cont[i]
        diffs = [float(np.abs(x - y).max()) for x, y in zip(a.logits,
                                                            b.logits)]
        same_bits = all(np.array_equal(x, y) for x, y in zip(a.logits,
                                                             b.logits))
        decided = 0
        for t, (x, y) in enumerate(zip(a.logits, b.logits)):
            top = np.sort(x)[::-1]
            if a.output[t] != b.output[t]:
                check(top[0] - top[1] <= 2 * diffs[t],
                      f"continuous-solo request {b.rid}: token {t} differs "
                      f"({a.output[t]} alone, {b.output[t]} batched) where "
                      f"the logits decide it")
                break
            decided += int(top[0] - top[1] > 2 * diffs[t])
        rel = max(diffs) / max(float(np.abs(x).max()) for x in a.logits)
        solo_out[str(b.rid)] = {"bit_identical": same_bits,
                                "max_abs_diff": max(diffs),
                                "max_rel_diff": rel,
                                "tokens_equal": a.output == b.output,
                                "decided_equal": decided}
        print(f"continuous-solo: request {b.rid} (S={len(b.prompt)}) alone: "
              f"logits bit-identical to the batched run: {same_bits}; "
              f"largest |diff| {max(diffs)} ({rel:.4g} of max |logit|); "
              f"tokens equal {a.output == b.output}", flush=True)
    numbers["continuous-solo"] = solo_out
    numbers["batch_invariance"] = batch_variance_probe(torch, dev, cfg,
                                                       params)

    # -- the static-batch baseline over a fresh server ---------------------
    zs = zip_server()
    try:
        srv, static, _, run = serve_requests(
            torch, cfg, prompts, SERVE_ARRIVALS, max_len, zs=zs,
            continuous=False)
    finally:
        zs.close()
    numbers["static"] = serving_numbers("static", srv, static, run)
    for r in static:
        check(len(r.output) == SERVE_NEW_TOKENS,
              f"static request {r.rid}: {len(r.output)} tokens")
    numbers["static"]["tokens_equal_continuous"] = sum(
        a.output == b.output for a, b in zip(static, cont))

    # -- resident weights: prefill + decode --------------------------------
    gc.collect()
    srv, resident, _, run = serve_requests(
        torch, cfg, prompts, SERVE_ARRIVALS, max_len, params=params,
        continuous=False)
    numbers["resident"] = serving_numbers("resident", srv, resident, run)
    for r in resident:
        check(len(r.output) == SERVE_NEW_TOKENS,
              f"resident request {r.rid}: {len(r.output)} tokens")
    numbers["resident"]["tokens_equal_continuous"] = sum(
        a.output == b.output for a, b in zip(resident, cont))

    # -- the port's CLI ----------------------------------------------------
    numbers["cli_s"] = run_cli(torch, CLI_ARGS, "cli")
    return launches, numbers


def run_cli(torch, args, what: str) -> float:
    """The port's serve CLI once as a subprocess: exit 0 and its
    ``metrics:`` and ``cache:`` lines.  Returns its wall seconds."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=CLI_TIMEOUT_S)
    cli_s = time.perf_counter() - t0
    lines = cli.stdout.splitlines()
    for ln in lines[-12:]:
        print(f"{what}: {ln}", flush=True)
    check(cli.returncode == 0,
          f"{what}: the CLI exited {cli.returncode}: {cli.stderr[-2000:]}")
    for head in ("metrics:", "cache:"):
        check(any(ln.startswith(head) for ln in lines),
              f"{what}: the CLI printed no {head!r} line")
    print(f"{what}: python -m repro_torch.launch.serve {' '.join(args)}: "
          f"exit 0 in {cli_s:.1f} s", flush=True)
    return cli_s


def migration_run(torch, np, dev, cfg, store_dir, group):
    """The JAX package's drift test at full width, on the port's engine in
    device-slab mode, with every re-plan checked from outside.  Returns the
    launches and numbers of the run."""
    from repro_torch.core import bitfield
    from repro_torch.core.engine import ZipMoEEngine
    from repro_torch.core.planner import PlanConsts
    from repro_torch.core.slab import SlotRef
    from repro_torch.core.store import ExpertStore
    from repro_torch.core.workload import zipf_trace
    from repro_torch.kernels import _build
    truth = ExpertStore(store_dir)
    eng = ZipMoEEngine(ExpertStore(store_dir), n_experts=cfg.n_experts,
                       n_layers=cfg.n_layers, L=6, freq_decay=0.9,
                       device_cache=True, device=dev)
    want = {}

    def store_bits(l, e):
        if (l, e) not in want:
            grp = truth.load_group((l, e))
            want[(l, e)] = [bitfield.from_bits(grp[t.name]).to(dev)
                            for t in group.tensors]
        return want[(l, e)]

    def as_tensor(v):
        if isinstance(v, SlotRef):
            return v.read()
        if isinstance(v, np.ndarray):
            return bitfield.from_bits(v).to(dev)
        return v

    watched, migrations, l1_refs = [], [], []
    plain_replan = eng.replan

    def replan(reason="manual", hit_rate=None):
        before = {l: eng._slabs.get(l) for l in (0, 1)}
        slots = {l: dict(s.slot_of) if s is not None else {}
                 for l, s in before.items()}
        if before[1] is not None:
            l1_refs.extend(v for ent in eng.caches[1].pools["F"].values()
                           if ent.payload is not None
                           for v in ent.payload.full.values()
                           if isinstance(v, SlotRef) and v.slab is before[1])
        out = plain_replan(reason=reason, hit_rate=hit_rate)
        torch.cuda.synchronize()
        caps = {}
        for l in (0, 1):
            old, new = before[l], eng._slabs.get(l)
            caps[l] = [old.capacity if old is not None else None,
                       new.capacity if new is not None else None]
            if old is not None and new is not None and new is not old:
                carried = set(slots[l]) & set(new.slot_of)
                if carried:
                    migrations.append({"layer": l, "carried": len(carried),
                                       "from": old.capacity,
                                       "to": new.capacity})
        checked = 0
        for e, ent in eng.caches[0].pools["F"].items():
            if ent.payload is None:
                continue
            ref_t = store_bits(0, e)
            for tidx, v in ent.payload.full.items():
                check(not isinstance(v, SlotRef) or v.valid,
                      f"migration: layer 0 expert {e} holds a stale SlotRef "
                      f"after the {reason} re-plan")
                check(torch.equal(as_tensor(v).view(torch.int16),
                                  ref_t[tidx].view(torch.int16)),
                      f"migration: layer 0 expert {e} tensor {tidx} differs "
                      f"from the store after the {reason} re-plan")
                checked += 1
        watched.append({"reason": reason, "wall_ms":
                        eng.planner.replans[-1]["wall_s"] * 1e3,
                        "slab_caps": caps, "checked_tensors": checked})
        return out

    eng.replan = replan
    eng.plan_consts = lambda layer: PlanConsts(u=1.0, v=0.1, c=1.0, L=4, K=4,
                                               n_tensors=3)
    phase1 = zipf_trace(cfg.n_experts, 2, MIGRATION_PHASE, alpha=1.4, seed=5)
    phase2 = zipf_trace(cfg.n_experts, 2, MIGRATION_PHASE, alpha=1.4,
                        seed=99)
    slab1_seen = False
    try:
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        eng.configure_planner(MIGRATION_BUDGET_EXPERTS * group.full_bytes,
                              replan_every=MIGRATION_REPLAN_EVERY,
                              plan_step=0.25, drift_margin=0.05,
                              profile_per_layer=False)
        for i, sel in enumerate(phase1 + phase2):
            eng.fetch_experts(0, sorted(sel))
            if i < len(phase1) and i % 3 == 0:      # layer 1 idles at T/2
                eng.fetch_experts(1, sorted(sel))
            slab1_seen = slab1_seen or eng._slabs.get(1) is not None
            eng.note_step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        ps = eng.plan_summary()
        final_slab1 = eng._slabs.get(1)
    finally:
        eng.shutdown()
        truth.close()
    reasons = [ev["reason"] for ev in ps["replans"]]
    for w in watched:
        print(f"migration: re-plan ({w['reason']}) in {w['wall_ms']:.3f} ms, "
              f"slab capacities [before, after] {w['slab_caps']}, "
              f"{w['checked_tensors']} layer-0 F tensors bit-exact", flush=True)
    print(f"migration: trace {len(phase1)} + {len(phase2)} steps (the JAX "
          f"package's drift test; not cut) in {wall:.1f} s; re-plan reasons "
          f"{reasons}; migrations {migrations}; launches {launches}",
          flush=True)
    check("drift" in reasons, f"migration: no drift re-plan in {reasons}")
    check(slab1_seen and final_slab1 is None,
          f"migration: layer 1's slab seen {slab1_seen}, at the end "
          f"{final_slab1}")
    check(l1_refs and not any(r.valid for r in l1_refs),
          f"migration: {len(l1_refs)} SlotRefs into layer 1's slabs taken "
          f"before a re-plan, {sum(r.valid for r in l1_refs)} still valid")
    check(migrations, "migration: no re-plan carried residents into a new "
          "slab")
    return launches, {"reasons": reasons, "migrations": migrations,
                      "replans": watched, "stale_refs_checked": len(l1_refs),
                      "wall_s": wall}


# ----------------------------------------------------------------------------
# phase 5: the MLA MoE family, deepseekv2-lite at full width
# ----------------------------------------------------------------------------
def mla_absorb_check(torch, dev, arch: str):
    """MLA decode with ``absorb=True`` against ``absorb=False`` on one
    layer of `arch` at its full attention widths, random weights, B = 4
    rows at positions MLA_CHECK_POSITIONS over a random latent cache of
    MLA_CHECK_T: the same function computed in another order.  Returns
    max |diff| / max |y| of each form (``mla_decode_rows`` and
    ``mla_decode``)."""
    from repro_torch.configs import get_config
    from repro_torch.models import attention as attn_lib
    cfg = dataclasses.replace(get_config(arch), n_layers=1)
    g = torch.Generator(device=dev).manual_seed(SEED)
    p = attn_lib.init_attn(g, cfg, dev)
    B, T = len(MLA_CHECK_POSITIONS), MLA_CHECK_T
    x = torch.randn((B, 1, cfg.d_model), generator=g, device=dev).to(
        torch.bfloat16)
    cache = {"ckv": torch.randn((B, T, cfg.kv_lora_rank), generator=g,
                                device=dev).to(torch.bfloat16),
             "k_rope": torch.randn((B, T, cfg.qk_rope_dim), generator=g,
                                   device=dev).to(torch.bfloat16)}
    positions = torch.tensor(MLA_CHECK_POSITIONS, device=dev)
    out = {}
    for form, run in (
            ("decode_rows", lambda c, a: attn_lib.mla_decode_rows(
                p, x, cfg, c, positions, absorb=a)),
            ("decode", lambda c, a: attn_lib.mla_decode(
                p, x, cfg, c, T - 1, absorb=a))):
        ys = {}
        for absorb in (True, False):
            c = {k: v.clone() for k, v in cache.items()}
            ys[absorb], _ = run(c, absorb)
        a, b = ys[True].float(), ys[False].float()
        check(bool(torch.isfinite(a).all()) and a.shape == (
            B, 1, cfg.d_model), f"{arch} MLA {form}: {a.shape}")
        rel = (a - b).abs().max().item() / b.abs().max().item()
        check(rel <= MLA_ABSORB_REL_TOL,
              f"{arch} MLA {form}: absorbed vs unabsorbed differ by {rel} "
              f"of max |y| (> {MLA_ABSORB_REL_TOL})")
        out[form] = rel
    print(f"mla-absorb: {arch} (d_model {cfg.d_model}, {cfg.n_heads} heads, "
          f"kv_lora {cfg.kv_lora_rank}, q_lora {cfg.q_lora_rank}, rope "
          f"{cfg.qk_rope_dim}, nope {cfg.qk_nope_dim}, v {cfg.v_head_dim}), "
          f"B {B}, T {T}: absorbed vs unabsorbed max |diff| / max |y| = "
          f"{out} (tolerance {MLA_ABSORB_REL_TOL})", flush=True)
    return out


def mla_phase(torch, np, dev):
    """deepseekv2-lite at every published width, depth cut to MLA_LAYERS:
    its own store (built under build/, checked lossless), the ragged
    device-slab path from an empty cache and continuous batching over
    ``decode_rows``, each held against the resident model, and the
    resident BatchServer over the same requests; then absorbed against
    unabsorbed MLA decode at both MLA configs' widths, the
    batch-invariance probe of the absorbed products, and the CLI with
    ``--arch deepseekv2-lite``.  Returns each path's launches and the
    phase's numbers."""
    from repro_torch.configs import get_config
    from repro_torch.core.store import build_store
    from repro_torch.models import init_params
    from repro_torch.serving.zipserve import ZipServer
    full = get_config(MLA_ARCH)
    cfg = dataclasses.replace(full, n_layers=MLA_LAYERS)
    moe = cfg_moe_layers(cfg)
    print(f"config {MLA_ARCH}: d_model {cfg.d_model}, {cfg.n_heads} MLA "
          f"heads (kv_lora {cfg.kv_lora_rank}, q_lora {cfg.q_lora_rank}, "
          f"rope {cfg.qk_rope_dim}, nope {cfg.qk_nope_dim}, v "
          f"{cfg.v_head_dim}), {cfg.n_experts} experts top-{cfg.top_k}, "
          f"d_expert {cfg.d_expert}, {cfg.n_shared_experts} shared, first "
          f"{cfg.first_dense} dense (d_ff {cfg.d_ff}), vocab "
          f"{cfg.vocab_size}; depth cut {full.n_layers} -> {MLA_LAYERS} "
          f"layers (MoE layers {moe})", flush=True)
    launches, numbers = {}, {}
    gc.collect()
    torch.cuda.empty_cache()
    params = init_params(cfg, seed=SEED, device=dev)
    with tempfile.TemporaryDirectory(prefix="smoke_store_mla_",
                                     dir=ROOT / "build") as store_dir:
        t0 = time.perf_counter()
        store = build_store(params, cfg, store_dir, device=dev)
        build_s = time.perf_counter() - t0
        ratio = store.ratio()
        print(f"mla build_store: codec {store.codec.name}, "
              f"{len(store.groups)} groups, {build_s:.1f} s, ratio "
              f"{ratio:.4f}", flush=True)
        check_lossless(torch, store, params, cfg, dev)
        store.close()
        numbers.update(build_store_s=build_s, store_ratio=ratio)

        def zip_server():
            gc.collect()
            return ZipServer(params, cfg, store_dir, L=6, prefetch=True,
                             device=dev, pool_sizes=POOLS_SMALL,
                             device_cache=True, ffn_impl="ragged")

        # -- mla-ragged: a batch of 4 greedy requests from an empty cache --
        rng = np.random.default_rng(SEED)
        prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                               (BATCH, 1))).to(dev)
        zs = zip_server()
        try:
            run = serve(torch, zs, prompt, NEW_TOKENS, NEW_TOKENS + 1)
        finally:
            zs.close()
        launches["mla-ragged"] = run["launches"]
        nums = path_numbers(run, len(moe))
        nums["splice_launches"] = run["launches"]["splice"] + \
            run["launches"]["splice_admit"]
        nums["logit_rel_err"] = check_resident(torch, np, dev, cfg, params,
                                               run, "mla-ragged")
        numbers["mla-ragged"] = nums
        print(f"mla-ragged: served {run['served'].tolist()}; TPOT "
              f"{nums['tpot_ms']} ms, blocked {nums['blocked_ms']} ms per "
              f"step, hit rate {nums['hit_rate']}, splice launches "
              f"{run['launches']['splice']} + splice-admit "
              f"{run['launches']['splice_admit']}; launches "
              f"{run['launches']}; {json.dumps(nums)}", flush=True)
        del run

        # -- mla-continuous: the serving phase's traffic -------------------
        lens, prompts, max_len = serving_traffic(np, cfg)
        zs = zip_server()
        try:
            srv, cont, cl, served = serve_requests(
                torch, cfg, prompts, SERVE_ARRIVALS, max_len, zs=zs,
                count=True)
            routes = served_routes(zs)
        finally:
            zs.close()
        launches["mla-continuous"] = cl
        out = serving_numbers("mla-continuous", srv, cont, served)
        print(f"mla-continuous: prompt lengths {lens.tolist()}; metrics "
              f"{json.dumps(srv.metrics())}; launches {cl}", flush=True)
        for r in cont:
            check(r.error is None and len(r.output) == SERVE_NEW_TOKENS
                  and len(r.logits) == SERVE_NEW_TOKENS,
                  f"mla-continuous request {r.rid}: {len(r.output)} tokens, "
                  f"error {r.error}")
        check(srv.pool.used_bytes() == 0,
              f"mla-continuous: {srv.pool.used_bytes()} KV bytes still held")
        page = srv.pool.page_nbytes()
        want_page = cfg.n_layers * (cfg.kv_lora_rank + cfg.qk_rope_dim) \
            * 2 * srv.pool.page_size
        check(page == want_page, f"mla-continuous: a KV page holds {page} B, "
              f"expected {want_page} B")
        # the server reads a prompt one decode step per token (absorbed
        # MLA throughout); the resident prefill's full-sequence MLA rounds
        # each token's K/V to bf16 instead: held to the same tolerance and
        # reported, the comparison that must cover half the outputs is the
        # one fed as the server reads
        worst_pf, compared_pf, flips_pf = check_requests_resident(
            torch, np, dev, cfg, params, cont, routes, "mla-continuous",
            min_share=0.0)
        worst, compared, flips = check_requests_resident(
            torch, np, dev, cfg, params, cont, routes, "mla-continuous",
            prefill_as_decode=True)
        out.update(logit_rel_err=worst, outputs_compared=compared,
                   flips=flips, prefill_logit_rel_err=worst_pf,
                   prefill_outputs_compared=compared_pf,
                   prefill_flips=flips_pf, kv_page_bytes=page,
                   kv_page_bytes_per_layer=page // cfg.n_layers)
        print(f"mla-continuous: KV page {page} B ({page // cfg.n_layers} B "
              f"per layer, {srv.pool.page_size} tokens), pool "
              f"{srv.pool.pool_bytes()} B, {srv.pool.used_bytes()} B held "
              f"after serving", flush=True)
        numbers["mla-continuous"] = out

        # -- the resident BatchServer: MLA prefill + decode ---------------
        gc.collect()
        srv, resident, _, served = serve_requests(
            torch, cfg, prompts, SERVE_ARRIVALS, max_len, params=params,
            continuous=False)
        numbers["mla-resident"] = serving_numbers("mla-resident", srv,
                                                  resident, served)
        for r in resident:
            check(len(r.output) == SERVE_NEW_TOKENS,
                  f"mla-resident request {r.rid}: {len(r.output)} tokens")
        numbers["mla-resident"]["tokens_equal_continuous"] = sum(
            a.output == b.output for a, b in zip(resident, cont))
        numbers["batch_invariance"] = batch_variance_probe(torch, dev, cfg,
                                                           params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    numbers["absorb"] = {arch: mla_absorb_check(torch, dev, arch)
                         for arch in (MLA_ARCH, "deepseek-v2-236b")}
    numbers["cli_s"] = run_cli(torch, ("--arch", MLA_ARCH) + CLI_ARGS,
                               "mla-cli")
    return launches, numbers


# ----------------------------------------------------------------------------
# phase 6: the SSM and hybrid families (jamba-v0.1-52b, mamba2-370m) and
# the dense GQA configs
# ----------------------------------------------------------------------------
def recycled_solo_check(np, cont, solo, cont_routes, solo_routes, what):
    """A request served in a recycled slot of the continuous run (`cont`)
    against the same request alone on a fresh server (`solo`): routes
    compared per MoE layer and position; before the first position whose
    routes differ, logits within LOGIT_REL_TOL of the largest |logit| and
    tokens equal wherever the logits decide them.  Fails unless at least
    half of the outputs are compared."""
    S, N = len(cont.prompt), len(cont.output)
    first_flip = S + N
    for layer, mine in cont_routes.items():
        theirs = solo_routes[layer]
        for s_, (a, b) in enumerate(zip(mine, theirs)):
            if a != b:
                first_flip = min(first_flip, s_)
                break
    worst, compared, decided = 0.0, 0, 0
    for t, (x, y) in enumerate(zip(cont.logits, solo.logits)):
        if S - 1 + t >= first_flip:
            break
        diff = float(np.abs(x - y).max())
        scale = float(np.abs(y).max())
        worst = max(worst, diff / scale)
        check(diff <= LOGIT_REL_TOL * scale,
              f"{what}: request {cont.rid} output {t} differs from the "
              f"request alone by {diff} (> {LOGIT_REL_TOL} x {scale})")
        top = np.sort(y)[::-1]
        if top[0] - top[1] > 2 * diff:
            decided += 1
            check(cont.output[t] == solo.output[t],
                  f"{what}: request {cont.rid} token {t} differs from the "
                  f"request alone where the logits decide it")
        compared += 1
    bits = all(np.array_equal(x, y) for x, y in zip(cont.logits,
                                                   solo.logits))
    print(f"{what}: request {cont.rid} (S={S}, a recycled slot) against "
          f"itself alone: first route difference at position "
          f"{first_flip if first_flip < S + N else None}; {compared}/{N} "
          f"outputs compared, max |diff| / max |logit| = {worst:.4g} "
          f"(tolerance {LOGIT_REL_TOL}), {decided} decided tokens equal; "
          f"logits bit-identical {bits}; tokens equal "
          f"{cont.output == solo.output}", flush=True)
    check(2 * compared >= N, f"{what}: only {compared} of {N} outputs "
          f"routed identically to the request alone")
    return {"rid": cont.rid, "first_route_difference": first_flip,
            "outputs_compared": compared, "max_rel_diff": worst,
            "decided_equal": decided, "bit_identical": bits,
            "tokens_equal": cont.output == solo.output}


def mamba_prefill_check(torch, np, dev, cfg, dtype: str):
    """mamba2's SSD prefill of MAMBA_PREFILL tokens (two chunks) against
    MAMBA_PREFILL single decode steps from the zero state, every layer at
    once, on seeded random weights in `dtype`.  Returns max |diff| / max
    |logit| over every position and the share of equal greedy tokens."""
    from repro_torch.models import decode_step, init_cache, init_params
    from repro_torch.models import prefill
    cfg = dataclasses.replace(cfg, dtype=dtype)
    params = init_params(cfg, seed=SEED, device=dev)
    rng = np.random.default_rng(SEED)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (1, MAMBA_PREFILL))).to(dev)
    t0 = time.perf_counter()
    lg, _ = prefill(params, cfg, toks)
    torch.cuda.synchronize()
    pf_s = time.perf_counter() - t0
    caches = init_cache(cfg, 1, MAMBA_PREFILL, device=dev)
    worst = torch.zeros((), device=dev)
    agree = torch.zeros((), dtype=torch.long, device=dev)
    t0 = time.perf_counter()
    for i in range(MAMBA_PREFILL):
        step, caches = decode_step(params, cfg, toks[:, i:i + 1], caches, i)
        worst = torch.maximum(worst, (step[0, 0].float()
                                      - lg[0, i].float()).abs().max())
        agree += (step[0, 0].argmax() == lg[0, i].argmax()).long()
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    check(bool(torch.isfinite(lg).all()), f"mamba2 {dtype}: non-finite "
          f"prefill logits")
    rel = worst.item() / lg.float().abs().max().item()
    share = agree.item() / MAMBA_PREFILL
    tol = MAMBA_F32_REL_TOL if dtype == "float32" else MAMBA_BF16_REL_TOL
    print(f"mamba2 prefill vs decode ({dtype}): SSD prefill of "
          f"{MAMBA_PREFILL} tokens ({MAMBA_PREFILL // cfg.ssm_chunk} chunks "
          f"of {cfg.ssm_chunk}) in {pf_s:.3f} s against {MAMBA_PREFILL} "
          f"decode steps in {dec_s:.3f} s: max |diff| / max |logit| = "
          f"{rel:.4g} (tolerance {tol}), greedy tokens equal at "
          f"{share:.4g} of positions", flush=True)
    check(rel <= tol, f"mamba2 {dtype}: prefill and step-by-step decode "
          f"differ by {rel} of max |logit| (> {tol})")
    del params, lg, caches
    return {"max_rel_diff": rel, "token_share": share, "prefill_s": pf_s,
            "decode_s": dec_s}


def dense_check(torch, np, dev, arch: str):
    """`arch` at every published width, depth cut to DENSE_LAYERS,
    resident: ``prefill`` of S - 1 tokens then one ``decode_step`` against
    ``forward`` of all S, on seeded random weights.  Returns max |diff| /
    max |logit| of the last position."""
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, forward, init_params
    from repro_torch.models import prefill
    from repro_torch.serving.kv_cache import grow_cache
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=DENSE_LAYERS)
    params = init_params(cfg, seed=SEED, device=dev)
    rng = np.random.default_rng(SEED)
    S = DENSE_SEQ
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (BATCH, S))
                            ).to(dev)
    want, _, _ = forward(params, cfg, toks)
    _, caches = prefill(params, cfg, toks[:, :S - 1])
    caches = grow_cache(cfg, caches, BATCH, S)
    got, _ = decode_step(params, cfg, toks[:, S - 1:], caches, S - 1)
    a, b = got[:, 0].float(), want[:, -1].float()
    check(bool(torch.isfinite(a).all()) and bool(torch.isfinite(want).all()),
          f"{arch}: non-finite logits")
    rel = (a - b).abs().max().item() / b.abs().max().item()
    check(rel <= LOGIT_REL_TOL, f"{arch}: prefill + decode_step differs "
          f"from forward by {rel} of max |logit| (> {LOGIT_REL_TOL})")
    print(f"dense {arch}: d_model {cfg.d_model}, {cfg.n_heads} heads / "
          f"{cfg.n_kv_heads} KV x {cfg.head_dim}, d_ff {cfg.d_ff} "
          f"({cfg.act}, {cfg.norm}, qk_norm {cfg.qk_norm}), vocab "
          f"{cfg.vocab_size}; depth cut {full.n_layers} -> {DENSE_LAYERS}: "
          f"prefill({S - 1}) + decode_step vs forward({S}) max |diff| / max "
          f"|logit| = {rel:.4g} (tolerance {LOGIT_REL_TOL}), logits finite",
          flush=True)
    del params
    return rel


def mamba_phase(torch, np, dev, tmp):
    """mamba2-370m at every published width and depth: its store (the SSM
    projections of every layer, checked lossless), ``ZipServer.
    decode_step`` against the resident model (no kernel may launch: there
    is no routed expert), and the resident BatchServer over the serving
    traffic.  Returns the phase's numbers."""
    from repro_torch.configs import get_config
    from repro_torch.core.store import build_store
    from repro_torch.models import decode_step, init_cache, init_params
    from repro_torch.serving.zipserve import ZipServer
    cfg = get_config(MAMBA_ARCH)
    params = init_params(cfg, seed=SEED, device=dev)
    numbers = {}
    t0 = time.perf_counter()
    store = build_store(params, cfg, tmp, device=dev)
    numbers["build_store_s"] = time.perf_counter() - t0
    numbers["store_ratio"] = store.ratio()
    bf16 = sum(g.full_bytes for g in store.groups.values())
    print(f"mamba2 build_store: {len(store.groups)} groups (the SSM "
          f"projections w_z, w_x, w_out of each layer), {bf16} B of bf16, "
          f"{numbers['build_store_s']:.1f} s, ratio "
          f"{numbers['store_ratio']:.4f}", flush=True)
    check_lossless(torch, store, params, cfg, dev)
    store.close()
    rng = np.random.default_rng(SEED)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (BATCH, 1))
                              ).to(dev)
    zs = ZipServer(params, cfg, tmp, L=6, prefetch=True, device=dev,
                   pool_sizes=POOLS_SMALL, device_cache=True,
                   ffn_impl="ragged")
    try:
        run = serve(torch, zs, prompt, NEW_TOKENS, NEW_TOKENS + 1)
    finally:
        zs.close()
    check(not any(run["launches"].values()),
          f"mamba2: kernels launched with no routed expert: "
          f"{run['launches']}")
    rcache = init_cache(cfg, BATCH, NEW_TOKENS + 1, device=dev)
    same = True
    for i, (inp, lg) in enumerate(zip(run["inputs"], run["logits"])):
        rl, rcache = decode_step(params, cfg, inp, rcache, i)
        check(bool(torch.isfinite(lg).all()), f"mamba2: non-finite logits "
              f"at step {i}")
        same = same and torch.equal(lg.view(torch.int16),
                                    rl.view(torch.int16))
    check(same, "mamba2: ZipServer.decode_step differs from the resident "
          "model although both run the same layers")
    numbers["zipserver"] = {"tpot_ms": statistics.mean(run["times"][1:])
                            * 1e3, "launches": run["launches"],
                            "bit_identical_to_resident": same}
    print(f"mamba2 zipserver: TPOT {numbers['zipserver']['tpot_ms']:.4f} ms "
          f"(batch {BATCH}, {NEW_TOKENS} tokens), logits bit-identical to "
          f"the resident model: {same}, launches {run['launches']}",
          flush=True)
    lens, prompts, max_len = serving_traffic(np, cfg)
    gc.collect()
    srv, resident, _, served = serve_requests(
        torch, cfg, prompts, SERVE_ARRIVALS, max_len, params=params,
        continuous=False)
    numbers["mamba2-resident"] = serving_numbers("mamba2-resident", srv,
                                                 resident, served)
    for r in resident:
        check(len(r.output) == SERVE_NEW_TOKENS,
              f"mamba2-resident request {r.rid}: {len(r.output)} tokens")
    del params
    return numbers


def ssm_phase(torch, np, dev, store_dir):
    """The checks of mamba2-370m's SSD prefill against step-by-step decode
    (f32 and bf16) and of the dense configs; then jamba-v0.1-52b at every
    published width, depth cut to JAMBA_LAYERS (Mamba2 mixers at 0-2,
    attention at 3, MoE at 1 and 3, dense MLPs at 0 and 2): its store
    built into `store_dir` with zlib at JAMBA_ZLIB_LEVEL and checked
    lossless; ``jamba-ragged`` from an empty cache against the resident
    model; ``jamba-continuous`` over ``decode_rows`` with SSM state in
    recycled slots, one recycled request against itself alone;
    ``jamba-resident``; mamba2-370m served (``mamba_phase``); the CLI with
    ``--arch jamba-v0.1-52b``.  Returns each path's launches and the
    phase's numbers."""
    from repro_torch.configs import get_config
    from repro_torch.core.codec import ZlibCodec
    from repro_torch.core.store import build_store
    from repro_torch.models import init_params
    from repro_torch.serving.zipserve import ZipServer
    full = get_config(JAMBA_ARCH)
    cfg = dataclasses.replace(full, n_layers=JAMBA_LAYERS)
    moe = cfg_moe_layers(cfg)
    kinds = ["attn" if cfg.attn_layer(i) else "mamba"
             for i in range(cfg.n_layers)]
    print(f"config {JAMBA_ARCH}: d_model {cfg.d_model}, {cfg.n_heads} heads "
          f"/ {cfg.n_kv_heads} KV x {cfg.head_dim} (pos {cfg.pos}), Mamba2 "
          f"d_inner {cfg.d_inner}, {cfg.ssm_heads} heads x "
          f"{cfg.ssm_headdim}, state {cfg.ssm_state}, conv {cfg.ssm_conv}; "
          f"{cfg.n_experts} experts top-{cfg.top_k}, d_expert "
          f"{cfg.d_expert}, dense d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; "
          f"depth cut {full.n_layers} -> {JAMBA_LAYERS} layers (mixers "
          f"{kinds}, MoE layers {moe})", flush=True)
    launches, numbers = {}, {}
    gc.collect()
    torch.cuda.empty_cache()
    mcfg = get_config(MAMBA_ARCH)
    numbers["mamba2-prefill"] = {
        dt: mamba_prefill_check(torch, np, dev, mcfg, dt)
        for dt in ("float32", "bfloat16")}
    numbers["dense"] = {arch: dense_check(torch, np, dev, arch)
                        for arch in DENSE_ARCHS}
    params = init_params(cfg, seed=SEED, device=dev)
    t0 = time.perf_counter()
    store = build_store(params, cfg, store_dir, device=dev,
                        codec=ZlibCodec(JAMBA_ZLIB_LEVEL))
    build_s = time.perf_counter() - t0
    ratio = store.ratio()
    bf16 = sum(g.full_bytes for g in store.groups.values())
    print(f"jamba build_store: codec {store.codec.name} at level "
          f"{JAMBA_ZLIB_LEVEL}, {len(store.groups)} groups, {bf16} B of "
          f"bf16, {os.cpu_count()} threads, {build_s:.1f} s, ratio "
          f"{ratio:.4f}", flush=True)
    check_lossless(torch, store, params, cfg, dev)
    store.close()
    numbers.update(build_store_s=build_s, store_ratio=ratio,
                   store_bf16_bytes=bf16, zlib_level=JAMBA_ZLIB_LEVEL)

    def zip_server():
        gc.collect()
        return ZipServer(params, cfg, store_dir, L=6, prefetch=True,
                         device=dev, pool_sizes=POOLS_SMALL,
                         device_cache=True, ffn_impl="ragged")

    # -- jamba-ragged: a batch of 4 greedy requests from an empty cache
    rng = np.random.default_rng(SEED)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (BATCH, 1))).to(dev)
    zs = zip_server()
    try:
        run = serve(torch, zs, prompt, JAMBA_NEW_TOKENS,
                    JAMBA_NEW_TOKENS + 1)
    finally:
        zs.close()
    launches["jamba-ragged"] = run["launches"]
    nums = path_numbers(run, len(moe))
    nums["splice_launches"] = run["launches"]["splice"] + \
        run["launches"]["splice_admit"]
    nums["logit_rel_err"] = check_resident(torch, np, dev, cfg, params,
                                           run, "jamba-ragged")
    numbers["jamba-ragged"] = nums
    print(f"jamba-ragged: served {run['served'].tolist()}; TPOT "
          f"{nums['tpot_ms']} ms, blocked {nums['blocked_ms']} ms per "
          f"step, hit rate {nums['hit_rate']}, splice launches "
          f"{run['launches']['splice']} + splice-admit "
          f"{run['launches']['splice_admit']}; launches "
          f"{run['launches']}; {json.dumps(nums)}", flush=True)
    del run

    # -- jamba-continuous: the serving traffic, slots recycled --------
    lens, prompts, max_len = serving_traffic(np, cfg)
    prompts = prompts[:JAMBA_REQUESTS]
    arrivals = SERVE_ARRIVALS[:JAMBA_REQUESTS]
    max_len = int(max(lens[:JAMBA_REQUESTS])) + SERVE_NEW_TOKENS
    zs = zip_server()
    try:
        srv, cont, cl, served = serve_requests(
            torch, cfg, prompts, arrivals, max_len, zs=zs, count=True,
            concurrency=JAMBA_CONCURRENCY)
        routes = served_routes(zs)
    finally:
        zs.close()
    launches["jamba-continuous"] = cl
    out = serving_numbers("jamba-continuous", srv, cont, served)
    for r in cont:
        check(r.error is None and len(r.output) == SERVE_NEW_TOKENS
              and len(r.logits) == SERVE_NEW_TOKENS,
              f"jamba-continuous request {r.rid}: {len(r.output)} "
              f"tokens, error {r.error}")
    check(srv.pool.used_bytes() == 0,
          f"jamba-continuous: {srv.pool.used_bytes()} bytes still held")
    slot_b, page_b = srv.pool.slot_nbytes(), srv.pool.page_nbytes()
    c_width = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    want_slot = kinds.count("mamba") * (
        cfg.ssm_heads * cfg.ssm_headdim * cfg.ssm_state * 4
        + (cfg.ssm_conv - 1) * c_width * 2)
    want_page = kinds.count("attn") * srv.pool.page_size * 2 \
        * cfg.n_kv_heads * cfg.head_dim * 2
    check(slot_b == want_slot and page_b == want_page,
          f"jamba-continuous: slot {slot_b} B (expected {want_slot}), "
          f"page {page_b} B (expected {want_page})")
    # fed as the server reads a prompt, one decode step per token: the
    # resident prefill's SSD rounds the conv to bf16 per product where
    # decode sums it in f32 (as in the JAX package), which alone moves
    # logits by more than LOGIT_REL_TOL through 3 Mamba2 layers
    worst, compared, flips = check_requests_resident(
        torch, np, dev, cfg, params, cont, routes, "jamba-continuous",
        prefill_as_decode=True)
    out.update(logit_rel_err=worst, outputs_compared=compared,
               flips=flips, slot_bytes=slot_b, page_bytes=page_b)
    print(f"jamba-continuous: prompt lengths "
          f"{lens[:JAMBA_REQUESTS].tolist()}, concurrency "
          f"{JAMBA_CONCURRENCY}; SSM slot {slot_b} B, KV page {page_b} "
          f"B; pool {srv.pool.pool_bytes()} B, {srv.pool.used_bytes()} "
          f"B held after serving; launches {cl}", flush=True)
    # the last request ran in a slot freed by an earlier one
    r = cont[-1]
    check(r.rid > JAMBA_CONCURRENCY, "jamba-continuous: the last request "
          "did not run in a recycled slot")
    zs = zip_server()
    try:
        _, solo, _, _ = serve_requests(torch, cfg, [r.prompt], [0.0],
                                       max_len, zs=zs)
        solo_routes = served_routes(zs)
    finally:
        zs.close()
    out["recycled_solo"] = recycled_solo_check(
        np, r, solo[0], routes[r.rid], solo_routes[solo[0].rid],
        "jamba-continuous")
    numbers["jamba-continuous"] = out

    # -- jamba-resident: SSD prefill + decode on resident weights ------
    gc.collect()
    srv, resident, _, served = serve_requests(
        torch, cfg, prompts, arrivals, max_len, params=params,
        continuous=False, concurrency=JAMBA_CONCURRENCY)
    numbers["jamba-resident"] = serving_numbers("jamba-resident", srv,
                                                resident, served)
    for r in resident:
        check(len(r.output) == SERVE_NEW_TOKENS,
              f"jamba-resident request {r.rid}: {len(r.output)} tokens")
    numbers["jamba-resident"]["tokens_equal_continuous"] = sum(
        a.output == b.output for a, b in zip(resident, cont))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="smoke_store_mamba_",
                                     dir=ROOT / "build") as tmp:
        # its own key: build_store_s and store_ratio above stay jamba's
        numbers["mamba2"] = mamba_phase(torch, np, dev, tmp)
    numbers["cli_s"] = run_cli(torch, ("--arch", JAMBA_ARCH) + CLI_ARGS,
                               "jamba-cli")
    return launches, numbers


def seeded_embeds(torch, rng, shape, dev):
    """N(0, 0.02²) inputs drawn with numpy, rounded once to bf16."""
    return torch.from_numpy(rng.standard_normal(shape) * 0.02).to(
        torch.bfloat16).to(dev)


def mrope_grid(np, batch: int, seq: int, grid):
    """[3, batch, seq] int32 M-RoPE positions: a ``grid[0] x grid[1]``
    image (temporal 0, its row, its column) followed by text starting one
    past the image's largest position, on all three channels."""
    gh, gw = grid
    n_img = gh * gw
    pos = np.zeros((3, seq), np.int32)
    idx = np.arange(n_img)
    pos[1, :n_img], pos[2, :n_img] = idx // gw, idx % gw
    pos[:, n_img:] = max(gh, gw) + np.arange(seq - n_img)
    return np.ascontiguousarray(np.broadcast_to(pos[:, None],
                                                (3, batch, seq)))


def logit_rel(torch, got, want) -> float:
    check(bool(torch.isfinite(got).all()) and bool(torch.isfinite(want).all()),
          "non-finite logits")
    return (got.float() - want.float()).abs().max().item() \
        / want.float().abs().max().item()


def switch_phase(torch, np, dev, store_dir):
    """switch-large-128 at every published width, depth cut to
    SWITCH_LAYERS decoder and SWITCH_ENC_LAYERS encoder layers: its store
    (zlib level SWITCH_ZLIB_LEVEL) checked lossless; a resident prefill of
    SWITCH_PROMPT tokens over seeded encoder inputs; then ``switch-ragged``,
    NEW_TOKENS greedy ``ZipServer.decode_step``s over the prefill's caches
    (cross-attention over their ``xkv``), against the resident model under
    teacher forcing; the caches' ``xkv`` must come back unchanged.
    Returns the path's launches and numbers."""
    from repro_torch.configs import get_config
    from repro_torch.core.codec import ZlibCodec
    from repro_torch.core.store import build_store
    from repro_torch.models import init_params, prefill
    from repro_torch.serving.kv_cache import grow_cache
    from repro_torch.serving.zipserve import ZipServer
    full = get_config(SWITCH_ARCH)
    cfg = dataclasses.replace(full, n_layers=SWITCH_LAYERS,
                              n_enc_layers=SWITCH_ENC_LAYERS)
    moe = cfg_moe_layers(cfg)
    check(moe == [1, 3], f"switch MoE layers {moe}")
    print(f"config {SWITCH_ARCH}: d_model {cfg.d_model}, {cfg.n_heads} heads "
          f"/ {cfg.n_kv_heads} KV x {cfg.head_dim} (pos {cfg.pos}, "
          f"{cfg.norm}, {cfg.act}); {cfg.n_experts} experts top-"
          f"{cfg.top_k}, d_expert {cfg.d_expert}, dense d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab_size}, enc_seq_len {cfg.enc_seq_len}; depth cut "
          f"decoder {full.n_layers} -> {SWITCH_LAYERS} (MoE layers {moe}), "
          f"encoder {full.n_enc_layers} -> {SWITCH_ENC_LAYERS}", flush=True)
    params = init_params(cfg, seed=SEED, device=dev)
    t0 = time.perf_counter()
    store = build_store(params, cfg, store_dir, device=dev,
                        codec=ZlibCodec(SWITCH_ZLIB_LEVEL))
    nums = {"build_store_s": time.perf_counter() - t0,
            "store_ratio": store.ratio(),
            "store_bf16_bytes": sum(g.full_bytes
                                    for g in store.groups.values())}
    print(f"switch build_store: codec {store.codec.name} at level "
          f"{SWITCH_ZLIB_LEVEL}, {len(store.groups)} groups, "
          f"{nums['store_bf16_bytes']} B of bf16, {nums['build_store_s']:.1f} "
          f"s, ratio {nums['store_ratio']:.4f}", flush=True)
    check_lossless(torch, store, params, cfg, dev)
    store.close()
    rng = np.random.default_rng(SEED)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (BATCH, SWITCH_PROMPT))).to(dev)
    enc = seeded_embeds(torch, rng, (BATCH, cfg.enc_seq_len, cfg.d_model),
                        dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, caches = prefill(params, cfg, prompt, enc_embeds=enc)
    torch.cuda.synchronize()
    nums["prefill_s"] = time.perf_counter() - t0
    check(bool(torch.isfinite(lg).all()), "switch: non-finite prefill logits")
    t_len = SWITCH_PROMPT + NEW_TOKENS
    served = grow_cache(cfg, caches, BATCH, t_len)
    resident = grow_cache(cfg, caches, BATCH, t_len)
    tok = torch.argmax(lg[:, -1], dim=-1)[:, None]
    gc.collect()
    zs = ZipServer(params, cfg, store_dir, L=6, prefetch=True, device=dev,
                   pool_sizes=POOLS_SMALL, device_cache=True,
                   ffn_impl="ragged")
    try:
        run = serve(torch, zs, tok, NEW_TOKENS, t_len, caches=served,
                    start=SWITCH_PROMPT)
    finally:
        zs.close()
    same = all(torch.equal(c["xkv"][n].view(torch.int16),
                           p["xkv"][n].view(torch.int16))
               for c, p in zip(run["caches"], caches) for n in ("k", "v"))
    check(same, "switch-ragged: the caches' cross-attention K/V changed "
          "while serving")
    nums.update(path_numbers(run, len(moe)))
    nums["splice_launches"] = run["launches"]["splice"] + \
        run["launches"]["splice_admit"]
    nums["logit_rel_err"] = check_resident(
        torch, np, dev, cfg, params, run, "switch-ragged", caches=resident,
        start=SWITCH_PROMPT)
    nums["xkv_unchanged"] = same
    print(f"switch-ragged: prefill {nums['prefill_s']:.3f} s over "
          f"{cfg.enc_seq_len} encoder frames; served "
          f"{run['served'].tolist()}; TPOT {nums['tpot_ms']} ms, blocked "
          f"{nums['blocked_ms']} ms per step, hit rate {nums['hit_rate']}, "
          f"splice ops {nums['splice_ops']}, h2d {nums['h2d_bytes']} B; "
          f"xkv unchanged: {same}; launches {run['launches']}; "
          f"{json.dumps(nums)}", flush=True)
    return run["launches"], nums


def whisper_check(torch, np, dev, store_dir):
    """whisper-small at every width and depth: resident ``prefill(S-1)`` +
    ``decode_step`` against ``forward(S)`` (LOGIT_REL_TOL), then
    ``ZipServer.decode_step`` over the prefill's caches bit-identical to
    the resident ``decode_step`` for WHISPER_STEPS greedy steps, with no
    kernel launched (its FFNs are dense and stay resident; the store holds
    them as groups ``(layer, 0)``)."""
    from repro_torch.configs import get_config
    from repro_torch.core.codec import ZlibCodec
    from repro_torch.core.store import build_store
    from repro_torch.models import decode_step, forward, init_params
    from repro_torch.models import prefill
    from repro_torch.serving.kv_cache import grow_cache
    from repro_torch.serving.zipserve import ZipServer
    cfg = get_config(WHISPER_ARCH)
    params = init_params(cfg, seed=SEED, device=dev)
    rng = np.random.default_rng(SEED)
    S = ENCDEC_SEQ
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (BATCH, S))
                            ).to(dev)
    enc = seeded_embeds(torch, rng, (BATCH, cfg.enc_seq_len, cfg.d_model),
                        dev)
    want, _, _ = forward(params, cfg, toks, enc_embeds=enc)
    _, caches = prefill(params, cfg, toks[:, :S - 1], enc_embeds=enc)
    t_len = S + WHISPER_STEPS
    served, resident = (grow_cache(cfg, caches, BATCH, t_len)
                        for _ in range(2))
    got, _ = decode_step(params, cfg, toks[:, S - 1:],
                         grow_cache(cfg, caches, BATCH, t_len), S - 1)
    rel = logit_rel(torch, got[:, 0], want[:, -1])
    check(rel <= LOGIT_REL_TOL, f"whisper: prefill + decode_step differs "
          f"from forward by {rel} of max |logit| (> {LOGIT_REL_TOL})")
    store = build_store(params, cfg, store_dir, device=dev,
                        codec=ZlibCodec(SWITCH_ZLIB_LEVEL))
    n_groups = len(store.groups)
    check_lossless(torch, store, params, cfg, dev)
    store.close()
    zs = ZipServer(params, cfg, store_dir, L=6, prefetch=True, device=dev,
                   pool_sizes=POOLS_SMALL, device_cache=True,
                   ffn_impl="ragged")
    try:
        run = serve(torch, zs, toks[:, S - 1:], WHISPER_STEPS, t_len,
                    caches=served, start=S - 1)
    finally:
        zs.close()
    check(not any(run["launches"].values()),
          f"whisper: kernels launched with no routed expert: "
          f"{run['launches']}")
    same = True
    for i, (inp, lg) in enumerate(zip(run["inputs"], run["logits"])):
        rl, resident = decode_step(params, cfg, inp, resident, S - 1 + i)
        same = same and torch.equal(lg.view(torch.int16),
                                    rl.view(torch.int16))
    check(same, "whisper: ZipServer.decode_step differs from the resident "
          "model although both run the same layers")
    print(f"whisper-small: d_model {cfg.d_model}, {cfg.n_heads} heads x "
          f"{cfg.head_dim}, {cfg.n_enc_layers} + {cfg.n_layers} layers "
          f"({cfg.norm}, {cfg.act}), enc_seq_len {cfg.enc_seq_len}, vocab "
          f"{cfg.vocab_size}: prefill({S - 1}) + decode_step vs "
          f"forward({S}) max |diff| / max |logit| = {rel:.4g} (tolerance "
          f"{LOGIT_REL_TOL}); store of {n_groups} dense FFN groups; "
          f"ZipServer over {WHISPER_STEPS} steps bit-identical to the "
          f"resident model: {same}, TPOT "
          f"{statistics.mean(run['times'][1:]) * 1e3:.4f} ms, launches "
          f"{run['launches']}", flush=True)
    return {"prefill_decode_rel": rel, "zipserver_bit_identical": same,
            "zipserver_tpot_ms": statistics.mean(run["times"][1:]) * 1e3}


def vlm_check(torch, np, dev):
    """qwen2-vl-2b at every width and depth, fed seeded embeddings with
    M-RoPE positions of one VLM_GRID image then text: resident
    ``prefill(S-1)`` + ``decode_step`` against ``forward(S)``
    (LOGIT_REL_TOL).  The same forward with the plain sequence index on
    every channel is printed beside it, to show the channels matter."""
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, forward, init_params
    from repro_torch.models import prefill
    from repro_torch.serving.kv_cache import grow_cache
    cfg = get_config(VLM_ARCH)
    params = init_params(cfg, seed=SEED, device=dev)
    rng = np.random.default_rng(SEED)
    S = ENCDEC_SEQ
    emb = seeded_embeds(torch, rng, (BATCH, S, cfg.d_model), dev)
    pos3 = torch.from_numpy(mrope_grid(np, BATCH, S, VLM_GRID)).to(dev)
    check(not torch.equal(pos3[0], pos3[1])
          and not torch.equal(pos3[1], pos3[2]),
          "qwen2-vl: the M-RoPE channels do not differ")
    want, _, _ = forward(params, cfg, embeds=emb, mrope_positions=pos3)
    plain, _, _ = forward(params, cfg, embeds=emb)
    _, caches = prefill(params, cfg, embeds=emb[:, :S - 1],
                        mrope_positions=pos3[:, :, :S - 1])
    caches = grow_cache(cfg, caches, BATCH, S)
    got, _ = decode_step(params, cfg, None, caches, S - 1,
                         embeds=emb[:, S - 1:],
                         mrope_positions=pos3[:, :, S - 1:])
    rel = logit_rel(torch, got[:, 0], want[:, -1])
    moved = logit_rel(torch, plain, want)
    check(rel <= LOGIT_REL_TOL, f"qwen2-vl: prefill + decode_step differs "
          f"from forward by {rel} of max |logit| (> {LOGIT_REL_TOL})")
    print(f"qwen2-vl-2b: d_model {cfg.d_model}, {cfg.n_heads} heads / "
          f"{cfg.n_kv_heads} KV x {cfg.head_dim}, {cfg.n_layers} layers, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; M-RoPE positions of a "
          f"{VLM_GRID[0]} x {VLM_GRID[1]} image then text: prefill({S - 1}) "
          f"+ decode_step vs forward({S}) max |diff| / max |logit| = "
          f"{rel:.4g} (tolerance {LOGIT_REL_TOL}); the forward with plain "
          f"positions moves the logits by {moved:.4g} of max |logit|",
          flush=True)
    return {"prefill_decode_rel": rel, "plain_rope_moves": moved}


def encdec_phase(torch, np, dev, store_dir):
    """Phase 7: switch-ragged (``switch_phase``), whisper-small
    (``whisper_check``) and qwen2-vl-2b (``vlm_check``).  Returns the
    served path's launches and the phase's numbers."""
    numbers, walls = {}, {}
    t0 = time.perf_counter()
    launches, numbers["switch-ragged"] = switch_phase(torch, np, dev,
                                                      store_dir)
    walls["switch"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="smoke_store_whisper_",
                                     dir=ROOT / "build") as tmp:
        numbers["whisper"] = whisper_check(torch, np, dev, tmp)
    walls["whisper"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    numbers["qwen2-vl"] = vlm_check(torch, np, dev)
    walls["qwen2-vl"] = time.perf_counter() - t0
    numbers["wall_s"] = walls
    print(f"phase 7 parts (s): {json.dumps(walls)}", flush=True)
    return {"switch-ragged": launches}, numbers


# ----------------------------------------------------------------------------
# phase 8: training
# ----------------------------------------------------------------------------
def named_leaves(tree, path=""):
    """(path, tensor) of every leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from named_leaves(v, f"{path}/{i}")
    elif tree is not None:
        yield path, tree


def train_step_flops(cfg, B: int, S: int, remat: bool) -> dict:
    """Matmul FLOPs (2 per multiply-add) of one train step of `cfg` on a
    [B, S] batch: forward, backward (twice the forward) and, under remat,
    the stack's forward again.  Attention scores count every [S, S]
    product (the plain attention computes the masked half too).  The
    einsum MoE counts every one of its E x G x C capacity slots through
    the expert FFN, filled or not, and the full one-hot contraction of its
    dispatch and combine einsums."""
    from repro_torch.models.moe import group_capacity
    T, d = B * S, cfg.d_model
    n_mm = 3 if cfg.act == "swiglu" else 2
    attn = 2 * T * d * (2 * cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim \
        + 2 * 2 * B * cfg.n_heads * S * S * cfg.head_dim
    g = cfg.moe_group_size
    G, s = (B * (S // g), g) if g and S > g and S % g == 0 else (B, S)
    C = group_capacity(s, cfg)
    slots = cfg.n_experts * G * C
    moe = 2 * T * d * cfg.n_experts + 2 * (2 * G * s * cfg.n_experts * C * d) \
        + n_mm * 2 * slots * d * cfg.d_expert \
        + n_mm * 2 * T * d * cfg.d_expert * cfg.n_shared_experts
    mlp = n_mm * 2 * T * d * cfg.d_ff
    layers = [attn + (moe if cfg.moe_layer(i) else mlp)
              for i in range(cfg.n_layers)]
    head = 2 * T * d * cfg.vocab_size
    fwd = sum(layers) + head
    recompute = sum(layers[cfg.first_dense:]) if remat else 0
    return {"forward": fwd, "step": 3 * fwd + recompute,
            "capacity_slots": slots, "routed_pairs": T * cfg.top_k,
            "capacity": C}


def train_full_width(torch, np, dev):
    """Phase 8 (a) and (b): qwen2-moe-a2.7b at every published width,
    depth TRAIN_LAYERS, seeded init on the card; TRAIN_STEPS steps of
    ``make_train_step(remat=True, moe_impl="einsum")`` on one fixed seeded
    batch, then one step each way: remat against no remat, scatter against
    einsum, and the int8 error feedback's residual bound."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.models.model import train_loss
    from repro_torch.training.optimizer import (adamw_update, cosine_lr,
                                                tree_leaves)
    from repro_torch.training.train_step import (_compress_ef,
                                                 init_train_state,
                                                 loss_and_grads,
                                                 make_train_step)
    cfg = dataclasses.replace(get_config(ARCH), n_layers=TRAIN_LAYERS)
    n_params = cfg.param_counts()["total"]
    reckoned = 12 * n_params          # bf16 params + bf16 grads + f32 m, v
    rng = np.random.default_rng(SEED)
    toks = rng.integers(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1),
                        dtype=np.int32)
    batch = {"tokens": torch.from_numpy(toks[:, :-1].copy()).to(dev),
             "labels": torch.from_numpy(toks[:, 1:].copy()).to(dev)}
    numbers = {"params": n_params, "reckoned_bytes": reckoned}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=SEED, device=dev)
    # param_counts() counts the matrices; the norm scales come on top
    check(sum(p.numel() for p in tree_leaves(params) if p.ndim >= 2)
          == n_params, "train: the parameter count is not param_counts()'s")
    numbers["params_with_norms"] = sum(p.numel()
                                       for p in tree_leaves(params))
    state = init_train_state(params)
    step = make_train_step(cfg, lr=TRAIN_LR, warmup=2,
                           total_steps=TRAIN_STEPS, remat=True,
                           moe_impl="einsum")
    torch.cuda.synchronize()
    numbers["init_s"] = time.perf_counter() - t0
    losses, gnorms, times = [], [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        loss, gnorm = float(m["loss"]), float(m["gnorm"])
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        gnorms.append(gnorm)
        check(np.isfinite(loss) and np.isfinite(gnorm),
              f"train: step {i}: loss {loss}, gnorm {gnorm}")
    peak = torch.cuda.max_memory_allocated() - base
    # where a step's time goes: one more step, its halves timed apart
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, grads = loss_and_grads(state.params, cfg, batch, remat=True)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    adamw_update(grads, state.opt, state.params,
                 lr=cosine_lr(state.opt.step, peak=TRAIN_LR, warmup=2,
                              total=TRAIN_STEPS))
    torch.cuda.synchronize()
    split = {"loss_and_grads_s": t1 - t0,
             "adamw_s": time.perf_counter() - t1}
    del grads
    check(losses[-1] < losses[0] - TRAIN_MIN_DROP,
          f"train: loss fell from {losses[0]} to {losses[-1]}, less than "
          f"{TRAIN_MIN_DROP}")
    flops = train_step_flops(cfg, TRAIN_BATCH, TRAIN_SEQ, remat=True)
    step_s = statistics.median(times[1:])
    numbers.update(
        losses=losses, gnorms=gnorms, step_s=times,
        median_step_s=step_s,
        tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / step_s,
        step_flops=flops["step"], flop_share=flops["step"] / step_s
        / BF16_FLOP_PER_S, capacity_slots=flops["capacity_slots"],
        routed_pairs=flops["routed_pairs"], capacity=flops["capacity"],
        peak_bytes=peak, peak_over_reckoned=peak / reckoned, split=split)
    print(f"train (a): {ARCH} at full width, depth {TRAIN_LAYERS}: "
          f"{n_params} params, batch {TRAIN_BATCH} x {TRAIN_SEQ}, "
          f"lr {TRAIN_LR} (warmup 2 of {TRAIN_STEPS}); losses "
          f"{[round(x, 4) for x in losses]}, gnorms "
          f"{[round(x, 4) for x in gnorms]}", flush=True)
    print(f"train (a): median step {step_s * 1e3:.2f} ms over steps 2-"
          f"{TRAIN_STEPS} ({[round(t * 1e3, 2) for t in times]} ms), "
          f"{numbers['tokens_per_s']:.0f} tokens/s, "
          f"{flops['step'] / 1e12:.3f} TFLOP a step (every one of the "
          f"{flops['capacity_slots']} E x G x C = {cfg.n_experts} x "
          f"{TRAIN_BATCH} x {flops['capacity']} capacity slots counted; "
          f"{flops['routed_pairs']} routed pairs), "
          f"{numbers['flop_share'] * 100:.2f}% of "
          f"{BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s; peak allocated "
          f"{peak / 1e9:.3f} GB against {reckoned / 1e9:.3f} GB of params, "
          f"grads and moments; a 9th step: loss and grads "
          f"{split['loss_and_grads_s'] * 1e3:.2f} ms, AdamW "
          f"{split['adamw_s'] * 1e3:.2f} ms", flush=True)

    # -- (b): one step each way at the same width ----------------------
    params = state.params
    del state, step, m
    gc.collect()
    torch.cuda.empty_cache()
    la, _, ga = loss_and_grads(params, cfg, batch, remat=True)
    lb, _, gb = loss_and_grads(params, cfg, batch, remat=False)
    check(torch.equal(la, lb), f"train (b): remat loss {float(la)} != "
          f"no-remat loss {float(lb)}")
    differ = {}
    for (path, a), (_, b) in zip(named_leaves(ga), named_leaves(gb)):
        if not torch.equal(a, b):
            differ[path] = float((a.float() - b.float()).abs().max()
                                 / b.float().abs().max())
    del gb
    check(set(differ) <= {"/embed/tok"} and
          all(v <= REMAT_EMBED_REL for v in differ.values()),
          f"train (b): remat and no-remat gradients differ: {differ}")
    numbers["remat"] = {"loss_equal": True,
                        "leaves": len(tree_leaves(ga)),
                        "leaves_differing": differ}
    print(f"train (b): remat == no remat: loss bit-identical "
          f"({float(la):.6f}), {len(tree_leaves(ga)) - len(differ)} of "
          f"{len(tree_leaves(ga))} gradient leaves bit-identical, "
          f"differing: {differ or 'none'}", flush=True)
    with torch.no_grad():
        le = float(train_loss(params, cfg, batch, remat=False,
                              moe_impl="einsum")[0])
        ls = float(train_loss(params, cfg, batch, remat=False,
                              moe_impl="scatter")[0])
    rel = abs(ls - le) / abs(le)
    check(rel <= SCATTER_LOSS_REL, f"train (b): scatter loss {ls} against "
          f"einsum loss {le}: {rel}")
    numbers["scatter"] = {"loss_einsum": le, "loss_scatter": ls, "rel": rel}
    print(f"train (b): scatter loss {ls:.6f} against einsum {le:.6f}: "
          f"{rel:.3e} relative (limit {SCATTER_LOSS_REL})", flush=True)
    worst = 0.0
    for path, g in named_leaves(ga):
        deq, res = _compress_ef(g, torch.zeros(g.shape, dtype=torch.float32,
                                               device=dev))
        scale = float(g.float().abs().max()) / 127.0
        r = float(res.abs().max())
        check(r <= scale * (0.5 + 2.0 ** -16),
              f"train (b): {path}: residual {r} above scale/2 = "
              f"{scale / 2}")
        worst = max(worst, r / scale if scale else 0.0)
        del deq, res
    del ga
    gc.collect()
    torch.cuda.empty_cache()
    state = init_train_state(params, grad_compress=True)
    step = make_train_step(cfg, lr=TRAIN_LR, warmup=2,
                           total_steps=TRAIN_STEPS, remat=True,
                           grad_compress=True)
    state, m = step(state, batch)
    check(np.isfinite(float(m["loss"])) and all(
        bool(torch.isfinite(e).all()) for e in tree_leaves(state.err)),
        "train (b): the compressed step is not finite")
    numbers["compress"] = {"residual_over_scale": worst,
                           "loss": float(m["loss"])}
    print(f"train (b): int8 error feedback: every residual within "
          f"{worst:.6f} x scale (bound 0.5 + 2^-16); one compressed step, "
          f"loss "
          f"{float(m['loss']):.6f}", flush=True)
    del state, step, m, params
    gc.collect()
    torch.cuda.empty_cache()
    return numbers


def train_checkpoint(torch, np, dev, tmp):
    """Phase 8 (c): at the train CLI's ``tiny`` preset, 8 steps straight
    through against 4 steps, a save, a restore into a fresh state and 4
    more steps."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.train import preset_config
    from repro_torch.models import init_params
    from repro_torch.training.checkpoint import CheckpointManager
    from repro_torch.training.data import data_iter
    from repro_torch.training.train_step import (TrainState, as_tensors,
                                                 init_train_state,
                                                 make_train_step)
    cfg, B, S = preset_config(ARCH, "tiny")
    it = data_iter(cfg, ShapeConfig("train", S, B, "train"), seed=SEED)
    batches = [as_tensors(next(it), cfg, dev) for _ in range(8)]

    def fresh(seed):
        return init_train_state(init_params(cfg, seed=seed, device=dev))

    def run(state, bs):
        step = make_train_step(cfg, lr=3e-3, warmup=2, total_steps=8)
        out = []
        for b in bs:
            state, m = step(state, b)
            out.append(float(m["loss"]))
        return state, out

    _, straight = run(fresh(SEED), batches)
    state, first = run(fresh(SEED), batches[:4])
    mgr = CheckpointManager(tmp, async_write=True)
    mgr.save(4, state._asdict(), extra={"loss": first[-1]})
    mgr.wait()
    other = fresh(SEED + 1)               # the fresh state to restore into
    restored, step, extra = mgr.restore(other._asdict(), device=dev)
    check(step == 4 and extra == {"loss": first[-1]},
          f"train (c): restored step {step}, extra {extra}")
    saved = dict(named_leaves(state._asdict()))
    n = 0
    for path, t in named_leaves(restored):
        check(t.device == dev and t.dtype == saved[path].dtype
              and torch.equal(t.view(torch.int16) if t.dtype ==
                              torch.bfloat16 else t,
                              saved[path].view(torch.int16)
                              if t.dtype == torch.bfloat16 else saved[path]),
              f"train (c): restored {path} differs from the saved state")
        n += 1
    check(n == len(saved), "train (c): leaves missing from the restore")
    del state, other
    _, second = run(TrainState(**restored), batches[4:])
    resumed = first + second
    diff = max(abs(a - b) for a, b in zip(straight, resumed))
    equal = sum(a == b for a, b in zip(straight, resumed))
    check(diff <= CKPT_LOSS_ABS, f"train (c): resumed losses {resumed} "
          f"against straight {straight}")
    check(straight[-1] < straight[0], f"train (c): loss {straight}")
    print(f"train (c): {ARCH} tiny preset ({cfg.d_model} wide, "
          f"{cfg.n_layers} layers, batch {B} x {S}): restored state "
          f"bit-equal ({n} leaves); losses straight {straight}, resumed "
          f"{resumed}: {equal} of 8 bit-equal, largest difference {diff}",
          flush=True)
    return {"straight": straight, "resumed": resumed, "bit_equal": equal,
            "max_abs_diff": diff, "leaves": n}


def train_cli(torch, tmp):
    """Phase 8 (d): the train CLI once as a subprocess."""
    gc.collect()
    torch.cuda.empty_cache()
    args = TRAIN_CLI_ARGS + ("--ckpt-dir", tmp)
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=CLI_TIMEOUT_S)
    cli_s = time.perf_counter() - t0
    lines = cli.stdout.splitlines()
    for ln in lines[-6:]:
        print(f"train-cli: {ln}", flush=True)
    check(cli.returncode == 0, f"train-cli: exited {cli.returncode}: "
          f"{cli.stderr[-2000:]}")
    steps = [ln for ln in lines if ln.startswith("step")]
    check(steps and steps[0].startswith("step     0") and lines[-1]
          .startswith("done in"), "train-cli: no step-0 or final line")
    first = float(steps[0].split("loss=")[1].split()[0])
    final = float(lines[-1].rsplit("final loss", 1)[1])
    check(final < first, f"train-cli: final loss {final} not below the "
          f"step-0 loss {first}")
    print(f"train-cli: python -m repro_torch.launch.train {' '.join(args)}: "
          f"exit 0 in {cli_s:.1f} s, loss {first} -> {final}", flush=True)
    return {"first_loss": first, "final_loss": final, "wall_s": cli_s}


def train_phase(torch, np, dev):
    """Phase 8: training on the card.  Every kernel count must stay 0:
    the training path runs plain PyTorch (the reference's train_loss runs
    no Pallas kernel either)."""
    from repro_torch.kernels import _build
    numbers, walls = {}, {}
    _build.reset_launches()
    t0 = time.perf_counter()
    numbers["full_width"] = train_full_width(torch, np, dev)
    walls["full_width"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="smoke_ckpt_",
                                     dir=ROOT / "build") as tmp:
        numbers["checkpoint"] = train_checkpoint(torch, np, dev, tmp)
    walls["checkpoint"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="smoke_train_cli_",
                                     dir=ROOT / "build") as tmp:
        numbers["cli"] = train_cli(torch, tmp)
    walls["cli"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    check(not any(_build.LAUNCHES.values()),
          f"train: a kernel launched on the training path: "
          f"{dict(_build.LAUNCHES)}")
    numbers["wall_s"] = walls
    print(f"phase 8 parts (s): {json.dumps(walls)}", flush=True)
    return numbers


# ----------------------------------------------------------------------------
# phase 9: the multi-rank layer
# ----------------------------------------------------------------------------
def mr_plan() -> dict:
    """Phase 9's sizes, handed to the ranks (a rank imports this file
    afresh): batch, cache length, the seq-sharded steps' write positions
    (in shard 0, an interior shard and the last of MR_RANKS), the
    pipeline's stages, micro-batches and micro-batch shape."""
    return {"batch": MR_BATCH, "seq": MR_SEQ,
            "positions": (int(0.17 * MR_SEQ), int(0.61 * MR_SEQ),
                          MR_SEQ - 1),
            "stages": MR_PIPE_STAGES, "micro": MR_PIPE_MICRO,
            "mb": MR_PIPE_MB}


def mr_configs():
    """(seq-sharded GQA, seq-sharded MLA, pipeline) configs: every width
    as published, depth cut."""
    from repro_torch.configs import get_config
    return (dataclasses.replace(get_config(ARCH), n_layers=MR_GQA_LAYERS,
                                dtype="float32"),
            dataclasses.replace(get_config(MLA_ARCH),
                                n_layers=MR_MLA_LAYERS, dtype="float32"),
            dataclasses.replace(get_config(ARCH), n_layers=MR_PIPE_LAYERS))


def mr_decode_inputs(torch, np, dev, cfg, plan):
    """Seeded params, full caches filled with seeded values, and the
    steps' (pos, tokens): the same bits in every process."""
    from repro_torch.models import init_cache, init_params
    from repro_torch.serving.kv_cache import tree_leaves
    params = init_params(cfg, seed=SEED, device=dev)
    caches = init_cache(cfg, plan["batch"], plan["seq"], device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 1)
    for t in tree_leaves(caches):
        t.copy_(torch.randn(t.shape, generator=g, device=dev) * MR_FILL_STD)
    rng = np.random.default_rng(SEED)
    steps = [(pos, torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (plan["batch"], 1))).to(dev))
        for pos in plan["positions"]]
    return params, caches, steps


def mr_pipe_inputs(torch, dev, cfg, plan):
    """Seeded params and micro-batches [M, B, S, d] of the pipeline."""
    from repro_torch.models import init_params
    from repro_torch.models.layers import dtype_of
    params = init_params(cfg, seed=SEED, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 2)
    x = torch.randn((plan["micro"], *plan["mb"], cfg.d_model), generator=g,
                    device=dev).to(dtype_of(cfg))
    return params, x


def mr_where(plan) -> str:
    """How phase 9's ranks sit on the cards, for its printed lines."""
    if plan["backend"] == "gloo":
        return (f"{MR_RANKS} processes sharing one card over gloo: not a "
                f"speedup measurement")
    return f"{MR_RANKS} processes, a card each, over {plan['backend']}"


def mr_timed(torch, dev, fn):
    """(fn(), wall ms) with the card synchronised on both sides."""
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, (time.perf_counter() - t0) * 1e3


def mr_rank_decode(torch, np, dev, cfg, mesh, plan):
    """One rank's seq-sharded decode steps: logits, its cache shards,
    step times and ledger."""
    from repro_torch.distributed.collectives import CollectiveLedger
    from repro_torch.models import decode_step
    from repro_torch.models.decode_attention import seqshard_caches
    from repro_torch.serving.kv_cache import map_tree
    params, caches, steps = mr_decode_inputs(torch, np, dev, cfg, plan)
    local = seqshard_caches(caches, mesh)
    del caches
    torch.cuda.empty_cache()
    ledger = CollectiveLedger()
    logits, ms = [], []
    for pos, tok in steps:
        (lg, local), t = mr_timed(torch, dev, lambda: decode_step(
            params, cfg, tok, local, pos, attn_impl="seqshard", mesh=mesh,
            ledger=ledger))
        logits.append(lg.cpu().numpy())
        ms.append(t)
    # what one of the step's all-reduces costs alone: the numerator's
    # shape, crossing the host over gloo (median of MR_PROBE_REPS)
    width = cfg.kv_lora_rank if cfg.attn == "mla" else cfg.head_dim
    probe = torch.zeros((plan["batch"], 1, cfg.n_heads, width), device=dev)
    group = mesh.get_group("model")
    ar_ms = statistics.median(
        mr_timed(torch, dev, lambda: torch.distributed.all_reduce(
            probe, group=group))[1] for _ in range(MR_PROBE_REPS))
    out = {"logits": logits, "step_ms": ms, "ledger": ledger.summary(),
           "allreduce_ms": ar_ms,
           "caches": map_tree(lambda t: t.cpu().numpy(),
                              [c["kv"] for c in local])}
    del params, local
    torch.cuda.empty_cache()
    return out


def multirank_rank(rank, world, dev_type, cfgs, plan):
    """Phase 9's rank body (run by ``spawn_ranks``): (a) and (b) on a
    4-wide ``model`` axis, then (c) on ranks 0..MR_PIPE_STAGES-1."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.distributed.collectives import CollectiveLedger
    from repro_torch.distributed.pipeline import (pipeline_forward,
                                                  stage_layers)
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_mesh
    dev = torch.device("cpu")
    if dev_type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        # a card of its own where there are enough, else the one card
        dev = torch.device("cuda", rank % plan["cards"])
        torch.cuda.set_device(dev)
    t_start = time.perf_counter()
    mesh = make_mesh((world,), ("model",), dev_type)
    n_st = plan["stages"]
    stages = dist.new_group(list(range(n_st)))
    out = {"ready_s": time.perf_counter() - t_start}
    out["gqa"] = mr_rank_decode(torch, np, dev, cfgs[0], mesh, plan)
    out["mla"] = mr_rank_decode(torch, np, dev, cfgs[1], mesh, plan)
    cfg = cfgs[2]
    if rank < n_st:
        params, x = mr_pipe_inputs(torch, dev, cfg, plan)
        layers = stage_layers(params["layers"], cfg, rank, n_st)
        del params
        torch.cuda.empty_cache()
        # a first pass warms the shapes and the links; the second is timed,
        # charged and checked
        _, cold_ms = mr_timed(torch, dev, lambda: pipeline_forward(
            layers, x, cfg, stages))
        ledger = CollectiveLedger()
        y, ms = mr_timed(torch, dev, lambda: pipeline_forward(
            layers, x, cfg, stages, ledger=ledger))
        out["pipe"] = {"bits": y.view(torch.int16).cpu().numpy(),
                       "ms": ms, "cold_ms": cold_ms,
                       "ledger": ledger.summary()}
        del layers, x, y
        torch.cuda.empty_cache()
    dist.barrier()
    out["launches"] = dict(_build.LAUNCHES)
    out["wall_s"] = time.perf_counter() - t_start
    return out


def mr_default_decode(torch, np, dev, cfg, plan):
    """The one-process counterpart of a rank's decode: the default
    ``decode_step`` on the same inputs."""
    from repro_torch.models import decode_step
    from repro_torch.serving.kv_cache import map_tree
    params, caches, steps = mr_decode_inputs(torch, np, dev, cfg, plan)
    logits, ms = [], []
    for pos, tok in steps:
        (lg, caches), t = mr_timed(torch, dev, lambda: decode_step(
            params, cfg, tok, caches, pos))
        logits.append(lg.cpu().numpy())
        ms.append(t)
    out = {"logits": logits, "step_ms": ms,
           "caches": map_tree(lambda t: t.cpu().numpy(),
                              [c["kv"] for c in caches])}
    del params, caches
    torch.cuda.empty_cache()
    return out


def mr_reckon_decode(cfg, plan) -> dict:
    """A seq-sharded rank's collectives over the steps (the reckoning the
    dry run shares: ``decode_attention.reckon_seqshard_decode``)."""
    from repro_torch.models.decode_attention import reckon_seqshard_decode
    return reckon_seqshard_decode(cfg, plan["batch"],
                                  len(plan["positions"]))


def mr_check_decode(np, what, cfg, plan, want, ranks) -> dict:
    """Phase 9 (a)/(b): every rank's logits against the default path's,
    the gathered cache shards against its cache, and the ledgers."""
    worst = 0.0
    for r, res in enumerate(ranks):
        for i, (got, ref) in enumerate(zip(res["logits"], want["logits"])):
            check(got.shape == ref.shape and np.isfinite(got).all(),
                  f"multirank {what}: rank {r} step {i}: logits "
                  f"{got.shape}")
            rel = float(np.abs(got - ref).max() / np.abs(ref).max())
            check(rel <= MR_REL, f"multirank {what}: rank {r} step {i}: "
                  f"logits {rel:.3e} of max |logit| off the default "
                  f"decode (limit {MR_REL})")
            worst = max(worst, rel)
    written = np.zeros(plan["seq"], bool)
    written[list(plan["positions"])] = True
    differ, written_rel = {}, 0.0
    for layer, leaves in enumerate(want["caches"]):
        for name, ref in leaves.items():
            got = np.concatenate([res["caches"][layer][name]
                                  for res in ranks], axis=1)
            check(got.shape == ref.shape, f"multirank {what}: layer "
                  f"{layer} {name}: gathered {got.shape} != {ref.shape}")
            g32, r32 = got.view(np.uint32), ref.view(np.uint32)
            same = g32 == r32
            check(same[:, ~written].all(), f"multirank {what}: layer "
                  f"{layer} {name}: a row no step wrote differs")
            n_diff = int((~same[:, written]).sum())
            check(layer > 0 or n_diff == 0, f"multirank {what}: layer 0 "
                  f"{name}: {n_diff} written entries differ from the "
                  f"default path's")
            differ[f"{layer}/{name}"] = n_diff
            written_rel = max(written_rel, float(
                np.abs(got[:, written] - ref[:, written]).max()
                / np.abs(ref[:, written]).max()))
    check(written_rel <= MR_REL, f"multirank {what}: written cache rows "
          f"{written_rel:.3e} off")
    reckoned = mr_reckon_decode(cfg, plan)
    for r, res in enumerate(ranks):
        got = {k: res["ledger"][k] for k in reckoned}
        check(got == reckoned, f"multirank {what}: rank {r} ledger {got} "
              f"!= the reckoning {reckoned}")
    numbers = {
        "logits_rel_max": worst, "written_rows_rel_max": written_rel,
        "written_entries_differing": differ,
        "default_step_ms": want["step_ms"],
        "rank_step_ms": [res["step_ms"] for res in ranks],
        "rank_allreduce_ms": [res["allreduce_ms"] for res in ranks],
        "ledger": reckoned}
    print(f"multirank {what}: {cfg.name}, depth {cfg.n_layers}, f32, B "
          f"{plan['batch']}, T {plan['seq']} in {len(ranks)} shards of "
          f"{plan['seq'] // len(ranks)}, writes at {plan['positions']}: every "
          f"rank's logits within {worst:.3e} of max |logit| of the default "
          f"decode; cache shards bit-equal but for the written rows of "
          f"layers > 0 (entries differing: {differ}; within "
          f"{written_rel:.3e}); ledger per rank {reckoned}; step ms "
          f"default {[round(t, 2) for t in want['step_ms']]}, rank 0 "
          f"{[round(t, 2) for t in ranks[0]['step_ms']]}, one "
          f"all-reduce of the numerator alone "
          f"{[round(r['allreduce_ms'], 3) for r in ranks]} ms a rank, "
          f"{reckoned['collective_ops']['all-reduce'] // len(plan['positions'])}"
          f" a step ({mr_where(plan)})", flush=True)
    return numbers


def mr_check_pipe(torch, np, dev, cfg, plan, ranks) -> dict:
    """Phase 9 (c): the stage ranks' results against the parent's
    sequential pass over the same stack and micro-batches."""
    from repro_torch.distributed.pipeline import reckon_pipeline
    from repro_torch.models.model import _superblock
    params, x = mr_pipe_inputs(torch, dev, cfg, plan)
    B, S = plan["mb"]
    n_st, micro = plan["stages"], plan["micro"]
    positions = torch.arange(S, dtype=torch.int32, device=dev)[None].expand(
        B, S)
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    def sequential():
        return torch.stack([_superblock(params["layers"], xm, aux, cfg,
                                        positions, None, None, "einsum")[0]
                            for xm in x])
    _, seq_cold_ms = mr_timed(torch, dev, sequential)     # as the ranks
    seq, seq_ms = mr_timed(torch, dev, sequential)
    want = seq.view(torch.int16).cpu().numpy()
    check(bool(torch.isfinite(seq).all()), "multirank pipe: the sequential "
          "pass is not finite")
    del params, x, seq
    torch.cuda.empty_cache()
    reckoned = reckon_pipeline(cfg, n_st, micro, (B, S))
    for r in range(n_st):
        res = ranks[r]["pipe"]
        n_diff = int((res["bits"] != want).sum())
        check(n_diff == 0, f"multirank pipe: stage rank {r}: {n_diff} of "
              f"{want.size} values differ from the sequential pass")
        got = {k: res["ledger"][k] for k in reckoned}
        check(got == reckoned, f"multirank pipe: rank {r} ledger {got} != "
              f"the reckoning {reckoned}")
    for r in range(n_st, len(ranks)):
        check("pipe" not in ranks[r], f"multirank pipe: rank {r} ran a "
              f"stage")
    numbers = {"sequential_ms": seq_ms, "sequential_cold_ms": seq_cold_ms,
               "pipeline_ms": [ranks[r]["pipe"]["ms"] for r in range(n_st)],
               "pipeline_cold_ms": [ranks[r]["pipe"]["cold_ms"]
                                    for r in range(n_st)],
               "ledger": reckoned}
    print(f"multirank pipe: {cfg.name}, depth {cfg.n_layers}, bf16, "
          f"{n_st} stages, {micro} micro-batches of "
          f"{list(plan['mb'])}: every stage rank's result bit-identical to "
          f"the sequential pass; ledger per stage {reckoned}; sequential "
          f"{seq_ms:.2f} ms (first pass {seq_cold_ms:.2f}), pipeline "
          f"{[round(t, 2) for t in numbers['pipeline_ms']]} ms (first pass "
          f"{[round(t, 2) for t in numbers['pipeline_cold_ms']]}) "
          f"({mr_where(plan)})", flush=True)
    return numbers


def multirank_phase(torch, np, dev):
    """Phase 9: the parent's one-process runs, then the ranks, then the
    checks; no kernel may launch but the parent's MLA decode kernels."""
    import importlib
    from repro_torch.distributed.launch import spawn_ranks
    from repro_torch.kernels import _build
    _build.reset_launches()
    cfgs, plan = mr_configs(), mr_plan()
    plan["cards"] = torch.cuda.device_count() if dev.type == "cuda" else 0
    # NCCL where each rank has a card of its own; else every rank shares
    # the one card over gloo (NCCL refuses two ranks on one GPU)
    plan["backend"] = "nccl" if plan["cards"] >= MR_RANKS else "gloo"
    walls = {}
    t0 = time.perf_counter()
    want = {"gqa": mr_default_decode(torch, np, dev, cfgs[0], plan),
            "mla": mr_default_decode(torch, np, dev, cfgs[1], plan)}
    walls["default"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    # by module name, so the ranks import this file as ``chip_smoke``
    body = importlib.import_module("chip_smoke").multirank_rank
    ranks = spawn_ranks(body, MR_RANKS, backend=plan["backend"],
                        timeout_s=MR_TIMEOUT_S, args=(dev.type, cfgs, plan))
    walls["ranks"] = time.perf_counter() - t0
    numbers = {
        "ranks": MR_RANKS, "backend": plan["backend"],
        "cards": plan["cards"],
        "rank_ready_s": [r["ready_s"] for r in ranks],
        "rank_wall_s": [r["wall_s"] for r in ranks],
        # process start, imports, the card's context and the group, and
        # the results' trip back
        "spawn_overhead_s": walls["ranks"] - max(r["wall_s"]
                                                 for r in ranks),
        "seqshard_gqa": mr_check_decode(np, "(a) gqa", cfgs[0], plan,
                                        want["gqa"],
                                        [r["gqa"] for r in ranks]),
        "seqshard_mla": mr_check_decode(np, "(b) mla", cfgs[1], plan,
                                        want["mla"],
                                        [r["mla"] for r in ranks])}
    del want
    t0 = time.perf_counter()
    numbers["pipeline"] = mr_check_pipe(torch, np, dev, cfgs[2], plan,
                                        ranks)
    walls["pipe_sequential"] = time.perf_counter() - t0
    # the parent's default MLA decode runs the two MLA decode kernels once
    # a layer and step on the card; nothing else launches a kernel
    parent = dict(_build.LAUNCHES)
    mla = MR_MLA_LAYERS * len(plan["positions"]) if dev.type == "cuda" \
        else 0
    check((parent.pop("mla_rope_write"), parent.pop("mla_absorbed_attend"))
          == (mla, mla), f"multirank: the default MLA decode launched "
          f"{dict(_build.LAUNCHES)}, expected {mla} of each MLA kernel")
    launched = [parent] + [r["launches"] for r in ranks]
    check(not any(any(c.values()) for c in launched),
          f"multirank: a kernel launched on the multi-rank paths: "
          f"{launched}")
    numbers["wall_s"] = walls
    print(f"phase 9 parts (s): {json.dumps(walls)}; each rank's mesh "
          f"ready after {[round(r['ready_s'], 1) for r in ranks]} s, done "
          f"after {[round(r['wall_s'], 1) for r in ranks]} s; spawn "
          f"overhead {numbers['spawn_overhead_s']:.1f} s", flush=True)
    return numbers


# ----------------------------------------------------------------------------
# phase 10: the peer-HBM (P) tier and the dry run
# ----------------------------------------------------------------------------
def peer_rows(torch, dev):
    """The peer rows' devices and how they are joined: a card each where
    there are PEER_MESH cards, else PEER_MESH rows on the one card."""
    n = torch.cuda.device_count() if dev.type == "cuda" else 0
    if n >= PEER_MESH:
        rows = [torch.device("cuda", i) for i in range(PEER_MESH)]
        access = {f"0->{i}": torch.cuda.can_device_access_peer(0, i)
                  for i in range(1, PEER_MESH)}
        return rows, (f"{PEER_MESH} rows a card each; "
                      f"can_device_access_peer {access}")
    return [dev] * PEER_MESH, (f"{PEER_MESH} rows on one {dev.type} device: "
                               f"each fetch is a device-local copy, no link")


def peer_numbers(run, zs, n_moe: int) -> dict:
    """A peer path's numbers: path_numbers, the hits by pool, the peer
    telemetry (ledger, link model, puts) and the row occupancy."""
    out = path_numbers(run, n_moe)
    ps = zs.peer_summary()
    out["hits"] = dict(run["cache"]["hits"])
    if ps["enabled"]:
        out.update(served=ps["served"], fallbacks=ps["fallbacks"],
                   collective_bytes=ps["collective_bytes"],
                   collective_ops=ps["collective_ops"],
                   peer_put_bytes=ps["peer_put_bytes"],
                   link_failures=ps["link_failures"], link=ps["link"],
                   rows_resident=[s["resident"]
                                  for s in ps["slabs"].values()])
    return out


def check_peer_refs(np, zs, store_dir, what: str) -> int:
    """Every PeerRef in a P-pool payload is valid and names its expert's
    slot; one expert a row fetched back equals the store's bits (the
    fetches are charged to the ledger, so this runs after the numbers
    were read).  Returns the experts checked against the store."""
    from repro_torch.core.bitfield import to_bits
    from repro_torch.core.slab import PeerRef
    from repro_torch.core.store import ExpertStore
    eng = zs.engine
    store = ExpertStore(store_dir)
    n_refs = checked = 0
    try:
        for l, slab in eng.peer.slabs.items():
            if slab is None:
                continue
            for e, ent in eng.caches[l].pools["P"].items():
                refs = [v for v in (ent.payload.full.values()
                                    if ent.payload is not None else ())
                        if isinstance(v, PeerRef)]
                for r in refs:
                    check(r.valid and slab.slot_of.get(e) == (r.dev, r.slot),
                          f"{what}: layer {l} expert {e}: a stale or "
                          f"misplaced PeerRef {r.dev}/{r.slot}")
                n_refs += len(refs)
            seen = set()
            for e, (row, _) in sorted(slab.slot_of.items()):
                if row in seen:
                    continue
                seen.add(row)
                got = slab.fetch(e)
                want = store.load_group((l, e))
                for name, arr in want.items():
                    check(np.array_equal(to_bits(got[name]), arr),
                          f"{what}: layer {l} expert {e} {name}: the peer "
                          f"row's bytes differ from the store's")
                checked += 1
    finally:
        store.close()
    check(n_refs > 0 and checked > 0,
          f"{what}: {n_refs} PeerRefs, {checked} experts fetched back")
    return checked


def peer_phase(torch, np, dev, cfg, store_dir):
    """Phase 10: (a) mesh 1, (b) mesh 4 with a warm-hit run, (c) mesh 4
    planned, all from phase 3's store and weights; (d) the dry run as a
    subprocess.  Returns the peer path's launches and the numbers."""
    from repro_torch.models import init_params
    from repro_torch.serving.zipserve import ZipServer
    params = init_params(cfg, seed=SEED, device=dev)
    rng = np.random.default_rng(SEED)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (BATCH, 1))
                              ).to(dev)
    n_moe = len(cfg_moe_layers(cfg))
    rows, where = peer_rows(torch, dev)
    print(f"peer: {where}", flush=True)
    numbers = {"rows": [str(r) for r in rows], "where": where}

    def server(**kw):
        return ZipServer(params, cfg, store_dir, L=6, prefetch=True,
                         device=dev, device_cache=True, ffn_impl="ragged",
                         **kw)

    # -- (a) the baseline: one device ---------------------------------------
    zs = server(pool_sizes=PEER_POOLS)
    try:
        base = serve(torch, zs, prompt, NEW_TOKENS, NEW_TOKENS + 1)
        check(zs.engine.peer is None and zs.peer_summary() == {
            "enabled": False}, "peer (a): a one-device server has a peer "
            "context")
        numbers["baseline"] = peer_numbers(base, zs, n_moe)
    finally:
        zs.close()
    print(f"peer (a) mesh 1: {json.dumps(numbers['baseline'])}", flush=True)

    # -- (b) four peer rows; then every expert resident and 3 hit steps ----
    zs = server(pool_sizes=PEER_POOLS, mesh_devices=PEER_MESH,
                peer_devices=rows)
    try:
        mesh = serve(torch, zs, prompt, NEW_TOKENS, NEW_TOKENS + 1)
        b = numbers["mesh"] = peer_numbers(mesh, zs, n_moe)
        nbytes = {s.expert_nbytes() for s in zs.engine.peer.slabs.values()
                  if s is not None}
        check(same_logits(torch, base, mesh),
              "peer (b): mesh-4 logits differ from mesh 1's")
        check(b["served"] > 0, f"peer (b): no expert link-served: {b}")
        n_fetch = b["collective_ops"].get("collective-permute", 0)
        check(len(nbytes) == 1 and b["collective_bytes"] == {
            "collective-permute": n_fetch * min(nbytes)},
            f"peer (b): ledger {b['collective_bytes']} != {n_fetch} "
            f"fetches x {nbytes} B")
        served0 = zs.peer_summary()["served"]
        warm = warm_hit_run(torch, zs, cfg, prompt, PEER_WARM_STEPS)
        ps = zs.peer_summary()
        w = numbers["mesh_warm"] = {
            k: v for k, v in warm.items() if k not in ("logits", "launches")}
        w.update(served=ps["served"] - served0, link=ps["link"],
                 hits=zs.cache_summary()["hits"])
        check(all(torch.equal(x.view(torch.int16), y.view(torch.int16))
                  for x, y in zip(warm["logits"], base["logits"])),
              "peer (b): warm-hit logits differ from mesh 1's")
        check(w["h2d_bytes"] == 0, f"peer (b): warm hit steps moved "
              f"{w['h2d_bytes']} h2d bytes")
        check(w["served"] > 0, "peer (b): the warm steps link-served no "
              "expert")
        numbers["mesh"]["checked_experts"] = check_peer_refs(
            np, zs, store_dir, "peer (b)")
    finally:
        zs.close()
    print(f"peer (b) mesh {PEER_MESH}: logits bit-identical to mesh 1; "
          f"{json.dumps(b)}", flush=True)
    print(f"peer (b) warm: {PEER_WARM_STEPS - 1} hit steps, h2d 0 B, "
          f"logits bit-identical; {json.dumps(w)}", flush=True)

    # -- (c) planned: a host budget and a per-row peer budget ---------------
    from repro_torch.core.planner import plan_peer_shards
    f_bytes = min(nbytes)
    budget, peer_budget = PLAN_BUDGET_EXPERTS * f_bytes, \
        PEER_BUDGET_EXPERTS * f_bytes
    row_peak = [0] * PEER_MESH
    gated = {}          # layer -> (grants, occupancy) when last watched
    solved = []         # layers whose grants were re-solved and matched

    def occupancy(slab):
        return [sum(1 for r, _ in slab.slot_of.values() if r == dev)
                for dev in range(PEER_MESH)]

    def watch_rows(zs, i):
        eng = zs.engine
        slabs = {l: s for l, s in eng.peer.slabs.items() if s is not None}
        for r in range(PEER_MESH):
            row_peak[r] = max(row_peak[r], sum(s.resident_bytes(r)
                                               for s in slabs.values()))
        # a row admits only under its grant: since the last watch it grew
        # to its grant at most (a shrunk grant evicts nothing)
        for l, slab in slabs.items():
            if l in gated:
                caps, occ = gated[l]
                now = occupancy(slab)
                check(all(a <= max(c, b) for a, b, c in zip(now, occ, caps)),
                      f"peer (c): layer {l} rows {now} outgrew grants {caps} "
                      f"from {occ}")
        if i == PLAN_FORCED_AT:
            eng.replan(reason="forced")
            # each grant is the solver's over that row's shard alone, under
            # the row budget its layer got; the budgets split peer_budget
            for l in zs._moe_layers:
                caps, rb = eng.peer.dev_caps[l], eng.peer.row_budgets[l]
                full = eng._bytes_per_state(l)["F"]
                check(caps == plan_peer_shards(
                    eng._peer_shard_stats(l), rb, full,
                    eng.plan_consts(l)) and all(c * full <= rb
                                                for c in caps),
                      f"peer (c): layer {l} grants {caps} are not the "
                      f"per-row solve under {rb} B")
                slab = eng.peer.slabs.get(l)
                gate = None if slab is None else slab.dev_caps
                check(gate is None or gate == [min(slab.capacity, c)
                                               for c in caps],
                      f"peer (c): layer {l} slab gates on {gate}, not the "
                      f"grants {caps}")
                solved.append(l)
            check(sum(eng.peer.row_budgets.values()) <= peer_budget * (
                1 + 1e-12), f"peer (c): row budgets "
                f"{eng.peer.row_budgets} exceed {peer_budget} B")
        for l, slab in slabs.items():
            gated[l] = (list(slab.dev_caps), occupancy(slab))

    zs = server(mem_budget=budget, peer_budget=peer_budget,
                replan_every=PLAN_REPLAN_EVERY, mesh_devices=PEER_MESH,
                peer_devices=rows)
    try:
        planned = serve(torch, zs, prompt, NEW_TOKENS, NEW_TOKENS + 1,
                        before_step=watch_rows)
        watch_rows(zs, -1)
        c = numbers["planned"] = peer_numbers(planned, zs, n_moe)
        pls = zs.plan_summary()
        eng = zs.engine
        c.update(dev_caps={l: eng.peer.dev_caps[l] for l in zs._moe_layers},
                 row_budgets={l: eng.peer.row_budgets[l]
                              for l in zs._moe_layers},
                 plan_sizes={l: eng.planner.plans[l].sizes
                             for l in zs._moe_layers},
                 n_plans=pls["n_plans"], n_replans=pls["n_replans"],
                 row_peak_bytes=row_peak, peer_budget_bytes=peer_budget,
                 budget_bytes=budget)
    finally:
        zs.close()
    check(sorted(solved) == sorted(zs._moe_layers) and gated,
          f"peer (c): grants re-solved for layers {solved}, rows watched "
          f"for {sorted(gated)}")
    check(same_logits(torch, base, planned),
          "peer (c): planned mesh-4 logits differ from mesh 1's")
    check(pls["n_replans"] >= 1, f"peer (c): {pls['n_replans']} re-plans")
    check(max(row_peak) <= peer_budget, f"peer (c): a row held "
          f"{max(row_peak)} B > its budget {peer_budget} B: {row_peak}")
    print(f"peer (c) planned: logits bit-identical to mesh 1; "
          f"{json.dumps(c)}", flush=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # -- (d) the dry run: a shape pass on the meta device -------------------
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="dryrun_",
                                     dir=ROOT / "build") as out:
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             ARCH, "--shape", DRYRUN_SHAPE, "--out-dir", out], env=env,
            capture_output=True, text=True, timeout=DRYRUN_TIMEOUT_S)
        check(proc.returncode == 0, f"peer (d): the dry run exited "
              f"{proc.returncode}: {proc.stderr[-2000:]}")
        rec = json.loads((Path(out) / f"{ARCH}__{DRYRUN_SHAPE}__single.json"
                          ).read_text())
    check(rec["status"] == "ok" and rec["flops_per_device"] > 0,
          f"peer (d): dry-run record {rec}")
    numbers["dryrun"] = {k: rec[k] for k in (
        "flops_per_device", "argument_bytes_per_device", "roofline",
        "useful_flop_ratio", "collective_note")}
    numbers["dryrun"]["wall_s"] = time.perf_counter() - t0
    print(f"peer (d) dry run ({ARCH} x {DRYRUN_SHAPE} x single): "
          f"{json.dumps(numbers['dryrun'])}", flush=True)
    return mesh["launches"], numbers


def peer_alone(torch, np, dev, cfg, card):
    """``--phase 10``: phase 10 by itself, from a store of its own (phase
    3's, as phase 3 builds it), with the peer path's launch check."""
    from repro_torch.core.store import build_store
    from repro_torch.models import init_params
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="smoke_store_",
                                     dir=ROOT / "build") as tmp:
        params = init_params(cfg, seed=SEED, device=dev)
        build_store(params, cfg, tmp, device=dev).close()
        del params
        torch.cuda.empty_cache()
        print(f"store: {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        launches, numbers = peer_phase(torch, np, dev, cfg, tmp)
    numbers["wall_s"] = phase_wall("10", t0)
    for name in PATH_KERNELS["peer"]:
        check(launches[name] > 0, f"kernel {name} was not launched on the "
              f"peer path: {launches}")
    numbers["launches"] = launches
    print(json.dumps({"peer": numbers, "card": card}), flush=True)


def cfg_moe_layers(cfg):
    return [i for i in range(cfg.n_layers) if cfg.moe_layer(i)]


def phase_wall(name: str, t0: float) -> float:
    wall = time.perf_counter() - t0
    print(f"phase {name}: {wall:.1f} s", flush=True)
    return wall


def main():
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"{ROOT / 'src' / 'repro_torch'} not found: run from a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a CUDA "
             "card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        f"nvidia-smi failed: {smi.stderr.strip()}"
    print(card, flush=True)
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}), python "
          f"{sys.version.split()[0]}", flush=True)
    dev = torch.device("cuda", 0)
    if sys.argv[1:] == ["--phase", "9"]:
        t0 = time.perf_counter()
        numbers = multirank_phase(torch, np, dev)
        phase_wall("9", t0)
        print(json.dumps({"multirank": numbers, "card": card}), flush=True)
        return
    if sys.argv[1:] not in ([], ["--phase", "10"]):
        fail(f"unknown arguments {sys.argv[1:]}: run with none, or with "
             f"--phase 9 or --phase 10")
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    cfg = dataclasses.replace(get_config(ARCH), n_layers=N_LAYERS)
    print(f"config {ARCH}: d_model {cfg.d_model}, {cfg.n_heads} heads x "
          f"{cfg.head_dim}, {cfg.n_experts} experts top-{cfg.top_k}, "
          f"d_expert {cfg.d_expert}, {cfg.n_shared_experts} shared, vocab "
          f"{cfg.vocab_size}; depth cut {get_config(ARCH).n_layers} -> "
          f"{N_LAYERS} layers", flush=True)

    t0 = time.perf_counter()
    _build.library()
    print(f"kernels: built={_build.BUILD_INFO['built']} in "
          f"{time.perf_counter() - t0:.1f} s -> {_build.BUILD_INFO['path']}",
          flush=True)
    (ROOT / "build").mkdir(exist_ok=True)
    if sys.argv[1:] == ["--phase", "10"]:
        peer_alone(torch, np, dev, cfg, card)
        return

    walls = {}
    t0 = time.perf_counter()
    kres = kernel_phase(torch, np, dev, cfg)
    # 4 tokens x top-2 = 8 (token, expert) pairs, one tile each; 7
    # distinct experts (one chosen twice)
    expert_kernel_shapes(torch, np, dev, JAMBA_ARCH, "jamba", np.asarray(
        [0, 3, 5, 9, 12, 14, 15, 3], np.int32))
    # 4 tokens x top-1 = 4 tiles, 4 distinct experts of 128
    expert_kernel_shapes(torch, np, dev, SWITCH_ARCH, "switch", np.asarray(
        [7, 40, 93, 127], np.int32))
    kres.update(mla_kernel_rows(torch, np, dev))
    gc.collect()
    torch.cuda.empty_cache()
    walls["2"] = phase_wall("2", t0)
    t0 = time.perf_counter()
    # phase 3's store stays on disk until phase 10 has served from it
    with tempfile.TemporaryDirectory(prefix="smoke_store_",
                                     dir=ROOT / "build") as main_store:
        launches, e2e = main_path(torch, np, dev, cfg, main_store)
        walls["3-4"] = phase_wall("3-4", t0)
        t0 = time.perf_counter()
        mla_launches, e2e["mla"] = mla_phase(torch, np, dev)
        launches.update(mla_launches)
        walls["5"] = phase_wall("5", t0)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="smoke_store_jamba_",
                                         dir=ROOT / "build") as tmp:
            ssm_launches, e2e["ssm"] = ssm_phase(torch, np, dev, tmp)
        launches.update(ssm_launches)
        walls["6"] = phase_wall("6", t0)
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="smoke_store_switch_",
                                         dir=ROOT / "build") as tmp:
            encdec_launches, e2e["encdec"] = encdec_phase(torch, np, dev,
                                                          tmp)
        launches.update(encdec_launches)
        walls["7"] = phase_wall("7", t0)
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        e2e["train"] = train_phase(torch, np, dev)
        walls["8"] = phase_wall("8", t0)
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        e2e["multirank"] = multirank_phase(torch, np, dev)
        walls["9"] = phase_wall("9", t0)
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        launches["peer"], e2e["peer"] = peer_phase(torch, np, dev, cfg,
                                                   main_store)
        walls["10"] = phase_wall("10", t0)
    e2e["phase_wall_s"] = walls
    # every kernel runs on some path, and every path runs its kernels; a
    # kernel's launches are its count on the first path that runs it
    for path, names in PATH_KERNELS.items():
        for name in names:
            check(launches[path][name] > 0,
                  f"kernel {name} was not launched on the {path} path: "
                  f"{launches[path]}")
    for name in _build.LAUNCHES:
        path = next((p for p, names in PATH_KERNELS.items()
                     if name in names), None)
        check(path is not None, f"kernel {name} is on no served path")
        check(name in kres, f"kernel {name} was not held against its plain "
              f"version")
        kres[name]["launches"] = launches[path][name]
        kres[name]["path"] = path
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"]
    check("jax" not in sys.modules, "jax was imported")
    check(not any(m == "repro" or m.startswith("repro.")
                  for m in sys.modules), "the JAX package was imported")
    print(json.dumps({"kernel_paths": {k: r["path"]
                                       for k, r in kres.items()}}),
          flush=True)
    print(json.dumps({"main_path": e2e, "card": card}), flush=True)
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in kres.values()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
