#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (llm_inference_lab_tpu_torch) on one
NVIDIA card: the quickest proof that the port builds and runs on the GPU.

    python3 chip_smoke.py                    # phases 0-13, last line a JSON result
    python3 chip_smoke.py --profile          # also a torch.profiler breakdown of runs
    python3 chip_smoke.py --profile=gemma    # the breakdown of the Gemma-2 runs only
    python3 chip_smoke.py --profile=mistral  # the breakdown of the Mistral B=1 run only
    python3 chip_smoke.py --profile=sampling # the breakdown of phase 11's sampled run only
    python3 chip_smoke.py --profile=heads    # the breakdown of phases 12 and 13's runs only

Phases, in order (any failure exits non-zero; nothing is caught and ignored):
 0. the card: nvidia-smi name and power limit, torch's device name, and
    cuBLAS's bf16 product with f32 output (the head's f32 logits);
 1. build every kernel from csrc/ (one nvcc per source, in parallel);
 2. each kernel against its plain PyTorch version on the card, at the
    shapes its path gives it (rms_norm at every model's width, rows
    bit-independent of M; the fused add_rms_norm bit for bit torch's add
    then rms_norm at every width and M = 1 to 2048, with Gemma-2's post
    weight), with its time, the plain version's, one
    library call's and the bound (bytes at 3.35 TB/s, operations at 989
    TFLOP/s bf16): quant_matmul_int4 (kernel A: its decode body,
    csrc/qmm_decode.cuh, at every width's projections, 3B, 1B, Gemma-2 9B
    and 2B, Mistral-7B and its head, every row within tolerance and with
    its bits alone at M = 1 to 63, timed at each path's rows with the step
    sums of the B=1, serving and Mistral ring steps; its tensor-core path,
    csrc/qmm_mma.cuh, at M = 64, 160, 512 and 2048 at the 3B, 1B, Gemma-2 9B and Mistral-7B
    widths, every row's bits independent of M within each, the rows that
    differ between the two counted, timed at M = 160, 512, 2048),
    flash_decode at the B=1 main path's shapes, verify_prefix (split over
    V) exactly its plain version at every vocabulary of the paths and its
    edge cases (ties across splits, NaN, unaligned and strided rows),
    flash_prefill at admission prefills (and resumed chunks), paged_flash
    at the serving step's (F gives D's bits on the same keys); then the int8
    kernels: quant_matmul_int8 (kernel B, the same decode body) at every
    projection of the int8 path, checked at M = 1 to 63 and timed at 1, 5,
    8, 40 and 63, every row's bits independent of M, and its
    tensor-core path as kernel A's, and the int8-cache variants of
    flash_decode, flash_prefill and paged_flash, each beside its bf16 kernel
    on the same positions (D and E within their tolerances of one another,
    F with D's bits; each kernel's rows are bit-independent of S, T and the
    rows beside them); then
    D, E and F at head dim 256 with Gemma-2's options (scale 1/16, softcap
    50, window 4096 or none: a local and a global layer) and geometries
    (16/8 and 8/4 heads), bf16 and int8, over T = 4608 with POISON at every
    key a sequence's rows do not see (below their window, past their
    position), D and E within tolerance of one another and F with D's
    bits, timed at the Gemma-2 paths' shapes; then D and E with ring_len at Mistral-7B's geometry (32 / 8
    heads of 128, window 4096, ring R = 4736), bf16 and int8: decode rows
    near 5400 and a 512-row chunk across the wrap on a ring of T = R, and
    rows on one of T = 256 < R, POISON at every slot a row does not see,
    each within its tolerance of its plain version and of the other, D at
    S = 1 equal to its row of S = 5, and equal to their own results over
    the same keys laid out by position (bits); timed at the
    long prompt's K=4 step and its 11 prefill chunks beside SDPA given the
    same boolean ring mask; then the ngram path's verify shapes (the int8
    3B at K=12): kernel B's decode body at M = 13 (checked and timed with
    the int8 3B's other M), D at S = 13 over T = 256 (within tolerance,
    every row the bits of that row alone) and C at [1, 12, 128256] (exactly
    its plain and split plain versions), each timed beside its library
    call and bound; and sampling: sample_tokens on the card against its
    own distribution (2**16 draws from one 128256-logit row under phase
    11's filters, total variation < 0.02, as JAX's tests/test_policies.py
    bounds its own check; the card's uniforms the CPU's bits) and the
    sampling ops of phase 11's step timed (the top_p sort of a row, a
    draw, the rejection policy's two distributions and its residual bonus);
    then D's and F's tree variants (the tree speculation's verify chunk,
    tree [3, 2], S = 10, at the 3B's geometry, bf16 and int8, POISON in V
    at every leaf's slot, which only that leaf may see, and past the
    chunk): D at T = 256 and 4096 (chunks mid-cache, at the cache's end and
    at slot -1), F through pages of 16 and 64 with D's bits, each within
    check_attn's tolerance of its plain version, timed at the tree paths'
    shapes beside SDPA given the same boolean mask and the bound; and A's
    decode body at Llama-3.1-8B's widths (4096 -> 6144, 4096, 28672,
    14336 -> 4096, the untied head 4096 -> 128256) at M = 1 to 3 and the
    decode checks' M, timed beside its bound and library call;
 3. end to end at full width: Engine with an int4 llama-3.2-3b target and
    llama-3.2-1b draft (random weights from a seed, int8 embedding/tied
    head), K=1, greedy, 64 new tokens, max_seq_len 512, on bench.py's
    prompt: one warm-up, three timed generate calls with every kernel's
    launch count set to 0 just before and read just after (rms_norm once a
    forward, add_rms_norm twice a layer, asserted on every path, and each
    path's ids logged as a digest to compare commits); greedy spec ids
    must equal a baseline run's and repeat exactly, logprobs finite, and a
    run drafting with the target's own weights must accept drafts and give
    the same ids;
 3b. serving at full width, the same weights: ContinuousBatcher over a paged
    KV cache (page 64, max_seq_len 1024, 8 slots), 16 requests of 45-360
    tokens and 16-64 new tokens, so that 8 wait and are admitted as slots
    retire; every kernel's count set to 0 just before run() and read just
    after. All requests retire with finite logprobs; each request's ids
    equal the start of phase 3's B=1 Engine.generate ids for its prompt (a
    difference must be a near tie at an op found to round a row differently
    at another batch shape, or between A's or B's decode body and
    tensor-core path; D and F must not differ in any row at the serving
    shapes, nor A's or B's decode rows across M, asserted); a
    contiguous-layout batcher (which decodes through D where the paged one
    uses F) gives the same ids, or ids that part only at such a near tie;
 4. the int8 path end to end at full width: configs/llama32_int8.yaml (int8
    3B target + 1B draft, K=4, max_seq_len 512, bf16 tied head) with an int8
    KV cache, random int8 weights from a seed, phase 3's prompt and checks;
    kernel A launches no time there; kv_alignment_report on the final cache
    of a generate is within KV_ALIGN_STEPS int8 steps of a fresh prefill
    (its decoded rows come from B's decode body, the fresh ones from its
    tensor-core path);
 5. int8 serving: phase 3b's requests and checks over paged int8 pools (page
    64, max_seq_len 512) on phase 4's weights, against phase 4's generate;
 6. Gemma-2 at full width: an int4 gemma-2-9b target and gemma-2-2b draft
    (random weights from a seed, bf16 tied embedding/head), K=1, greedy,
    max_seq_len 8192: phase 3's checks on its prompt, then one speculative
    and one baseline run on a 4320-token prompt (cache T = 4480), where the
    window of 4096 binds in the prefill (kernel E) and at every decode step
    (kernel D): their ids must be equal;
 7. Gemma-2 serving: phase 3b's requests and checks on phase 6's weights;
 8. Mistral-7B with the rolling-buffer cache at full width: an int4
    mistral-7b target and a mistral-7b draft from the next seed (int4 head,
    bf16 embedding), K=4, max_seq_len 8192, prefill_chunk 512, kv_ring (R =
    4736 on both models): phase 3's checks on its prompt (T = 256 < R),
    then on a 5400-token prompt (11 chunks, the ring wraps) spec and
    baseline on the ring (equal ids), a baseline on the full cache and int8
    KV baselines on the ring and the full cache: ring ids == full-cache ids
    for bf16 and int8, or a near tie of at most 2 bf16 ulps; and ngram
    drafting (K=4, no draft model) on the ring: ids == the ring baseline's;
10. ngram at the JAX package's ngram_3b_int8_k12 configuration (int8
    llama-3.2-3b, int8 embedding and tied head, bf16 KV, no draft model,
    K=12, max_seq_len 512, 64 new tokens, PROMPT): a warm-up, three timed
    generate calls and the host loop in turns; graph == host loop (ids,
    steps, proposed, accepted), ids == a greedy baseline's, acceptance > 0
    and more than one token committed a step (ms/step, tok/s, tokens a
    step, acceptance, polls a generate, capture ms and graph pool MB
    logged); then phase 3b's 16 requests through the 8-slot paged batcher
    on the same engine, each request's ids the start of this phase's B=1
    ids under the near-tie rule (occupancy and aggregate tok/s logged);
11. sampling and the policies on phase 3's weights (run after phase 3b):
    greedy=False, temperature 0.8, top_p 0.95, policy rejection, the
    device-side adaptive controller, K up to 4: graph ids == host loop
    ids, a repeat with the seed gives its ids and another seed others,
    logprobs finite, the final K in [min_k, max_k]; then greedy runs of
    conf_threshold, topk_agree, typical and the host adaptive controller
    (a one-step graph a K), graph against host loop;
12. EAGLE at the JAX package's eagle_8b_int4 (llama-3.1-8b, int4
    projections and untied head through A, int8 embedding, no draft model,
    K=2, max_seq_len 512, 64 new tokens, PROMPT; run after phase 10): a
    warm-up, three timed generate calls and the host loop in turns; graph
    == host loop (ids, steps, proposed, accepted), ids == a greedy
    baseline's on the same weights exactly, acceptance > 0 (ms/step, tok/s,
    tokens a step, acceptance, polls, capture ms, graph pool MB, peak
    memory and launches a forward logged); the batched head call's rows
    against one head call a draft position (rows that differ logged);
13. Medusa and tree speculation on phase 3's int4 3B target (no draft
    model; run after phase 11): Medusa K=4 with identity ("tie") heads and
    the tree [3, 2], each with phase 12's checks; then phase 3b's 16
    requests through the 8-slot paged batcher with the tree and with
    Medusa, each request's ids the start of that mode's B=1 ids under the
    near-tie rule (and D's and F's tree variants with the same bits at the
    serving shapes); then self_distill_medusa (2 heads, three seed
    prompts, 30 steps) under a 60 s cap: the loss falls, the ids stay,
    Medusa's acceptance before and after logged;
 9. the kernels' JSON line (every kernel, launches by path; the Gemma-2
    variants of D, E and F, the ring variants of D and E, the ngram
    verify shapes of B, D and C, D's and F's tree variants and A at the 8B
    widths on rows of their own), then the result line.

Every B=1 and serving path (phases 3-8, 10-13) decodes through the decode
loop of core/specstep.py: CUDA-graph replays of the step, captured once a
shape (the host adaptive controller: a one-step graph a K).
count_launches adds each replay's captured launches to the wrappers' eager
counts (and the captured forwards and layers to the eager ones), and
asserts that the path replayed, that no wrapper's count moves across a
chunk of replays and that no decode-only kernel launched eagerly outside a
capture's warm-up step. Each path runs once more on the host loop
(EnvFlags(sync_steps=True)) in the same process, in turns with the graph
runs: ids, steps, proposed and accepted must be equal, and both timings
are logged, with each capture's time and graph pool memory.

Without CUDA it exits non-zero before printing any result.
"""

import hashlib
import json
import math
import statistics
import subprocess
import sys
import time
from dataclasses import replace

import torch

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate
SPIN_CYCLES_PER_S = 1.98e9  # H100 SXM top SM clock: a spin lasts at least this long
L2_BYTES = 50 << 20
PROMPT = "The quick brown fox jumps over the lazy dog. " * 3
T_MAIN = 256  # cache length of the main path (P = 160, 64 new tokens, K = 1)
P_MAIN = 167  # a mid-generation position: prompt (135) + 32 tokens

# (K, N) of every projection: 3B target, 1B draft; Gemma-2 9B and its 2B
# draft; Mistral-7B and its untied head.
QMM_3B = [(3072, 5120), (3072, 3072), (3072, 16384), (8192, 3072)]
QMM_1B = [(2048, 3072), (2048, 2048), (2048, 16384), (8192, 2048)]
QMM_9B = [(3584, 8192), (4096, 3584), (3584, 28672), (14336, 3584)]
QMM_2B = [(2304, 4096), (2048, 2304), (2304, 18432), (9216, 2304)]
QMM_MISTRAL = [(4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096)]
MISTRAL_HEAD = (4096, 32000)
# Llama-3.1-8B (phase 12): the projections of Mistral-7B's widths and the
# untied int4 head of the 128256-token vocabulary; A's decode body at the
# EAGLE step's M: 2 head rows (K=2), 3 verify rows (K+1).
QMM_8B = QMM_MISTRAL + [(4096, 128256)]
QMM_8B_M = (1, 2, 3)
QMM_WIDTHS = {"3B": QMM_3B, "1B": QMM_1B, "Gemma-2 9B": QMM_9B,
              "Mistral-7B": QMM_MISTRAL + [MISTRAL_HEAD]}
# Kernels A and B below MMA_MIN_M rows (the decode body, csrc/qmm_decode.cuh):
# every row checked at DECODE_CHECK_M against the plain version and against
# itself computed alone; A timed at each width's path rows (B=1 draft and
# verify, 8-slot draft and verify: K=1 on the Llama and Gemma-2 paths, K=4
# at B=1 on Mistral's), B at QMM8_M and 63.
DECODE_CHECK_M = (1, 2, 5, 8, 16, 40, 63)
QMM_DECODE = {"3B": (QMM_3B, (1, 2, 8, 16)), "1B": (QMM_1B, (1, 2, 8, 16)),
              "Gemma-2 9B": (QMM_9B, (1, 2, 8, 16)), "Gemma-2 2B": (QMM_2B, (1, 2, 8, 16)),
              "Mistral-7B": (QMM_MISTRAL + [MISTRAL_HEAD], (1, 5))}
# Prefill rows the tensor-core path of kernels A and B is timed at: the
# main path's 160-row prompt, a Mistral chunk of 512, an admission wave of
# 8 prompts of 256 rows; and the rows it is checked at (from MMA_MIN_M).
PREFILL_M = (160, 512, 2048)
MMA_CHECK_M = (64, 160, 512, 2048)
# Tolerances. quant_matmul (kernel A): 1e-2 of the output's largest
# magnitude (bf16 output rounding, 2^-8 relative, plus f32 summation
# order). verify_prefix: exact.
QMM_RTOL = 1e-2
# Attention (kernels D, E and F) keeps f32 scores and sums and rounds its
# output to bf16 (FLASH_RTOL |ref|, f32 order FLASH_ATOL), and rounds p
# (for int8 p times v's scale) to bf16 before P.V, as Pallas does: at most
# 2^-9 sum_j P_j |v_j| an output. Each is held to FLASH_RTOL |ref| +
# ATTN_VTOL sum_j P_j |v_j| + FLASH_ATOL against the plain version on f32
# copies (twice the p term), and D and E to twice the sum of both
# tolerances against each other on the same rows (check_attn_pair); F
# gives D's bits.
FLASH_RTOL, FLASH_ATOL = 2.0 ** -8, 2.0 ** -16
ATTN_VTOL = 2.0 ** -8
# The attention checks fill V past the last position with this value, so a
# mask that lets one masked key in moves an output by about POISON / T.
POISON = 64.0
GEOMS = {64: (32, 8), 128: (24, 8)}  # head dim: (H, KVH) of the 1B and the 3B
LAYERS = {64: 16, 128: 28}  # layers of the model with that head dim
# Serving (phase 3b): request i's prompt and budget.
SERVE_PROMPTS = ["The quick brown fox jumps over the lazy dog. " * (1 + i % 8) for i in range(16)]
SERVE_BUDGETS = [(16, 32, 48, 64)[i % 4] for i in range(16)]
SERVE_SLOTS, SERVE_PAGE, SERVE_MAX_LEN = 8, 64, 1024
# The main path (phases 3 and 3b): bench.py's int4 3B + 1B at K=1.
INT4_CFG = dict(base_model="llama-3.2-3b", draft_model="llama-3.2-1b", max_draft=1,
                max_new_tokens=64, max_seq_len=512, quantization="int4", quantized_init=True,
                quantize_embed=True, seed=0)
# The int8 path (phases 4 and 5): configs/llama32_int8.yaml's engine
# settings with the int8 KV cache.
INT8_CFG = dict(base_model="llama-3.2-3b", draft_model="llama-3.2-1b", max_draft=4,
                max_new_tokens=64, max_seq_len=512, quantization="int8", quantized_init=True,
                kv_quantization="int8", seed=0)
INT8_MAX_LEN = 512  # serving lanes of the int8 path
# The ngram path (phase 10): the JAX package's ngram_3b_int8_k12
# (scripts/headline_suite.py): an int8 3B with the int8 embedding and tied
# head, no draft model, prompt-lookup drafts of K=12, bf16 KV.
NGRAM_CFG = dict(base_model="llama-3.2-3b", draft_model=None, draft_mode="ngram", max_draft=12,
                 max_new_tokens=64, max_seq_len=512, quantization="int8", quantized_init=True,
                 quantize_embed=True, seed=0)
NGRAM_K = 12
NGRAM_P = P_MAIN + NGRAM_K  # the last position of a mid-generation verify block
# Phase 11: sampling on the main path's weights (int4 3B + 1B), the
# rejection policy and the device-side adaptive K; then greedy runs of the
# other policies and the host adaptive controller, all at K=4.
SAMPLED = dict(greedy=False, temperature=0.8, top_p=0.95, policy="rejection",
               controller="adaptive-device", max_draft=4, controller_params={"max_k": 4})
GREEDY_POLICIES = {"conf_threshold": dict(policy="conf_threshold"),
                   "topk_agree": dict(policy="topk_agree"), "typical": dict(policy="typical"),
                   "host adaptive K": dict(controller="adaptive", controller_params={"max_k": 4})}
SAMPLE_DRAWS = 1 << 16  # draws of phase 2's sampling check
SAMPLE_TV = 0.02  # their total variation bound (JAX's tests/test_policies.py's)
KV_ALIGN_STEPS = 4  # kv_alignment_report's tolerance, in int8 steps (phase_kv_alignment)
# Kernel B's decode checks: the path's M (B=1 draft and verify, 8-slot draft
# and verify).
QMM8_M = (1, 5, 8, 40)
QMM8_TIME_M = QMM8_M + (63,)
QMM8_NGRAM_M = NGRAM_K + 1  # the ngram path's verify rows (phase 10)
# Kernel B per element: 2^-8 |ref| (the bf16 output's rounding) + 2^-14 of
# the largest |ref| (f32 sums of up to 8192 products in another order).
QMM8_RTOL, QMM8_MTOL = 2.0 ** -8, 2.0 ** -14
# int8 POISON: keys and values past the last position hold bytes 127 with a
# scale of 0.5 (63.5, 18x the scale of an N(0, 1) row), in K and V.
POISON_BYTE, POISON_SCALE = 127, 0.5
# Gemma-2 (phases 2, 6 and 7): the 9B target and the 2B draft, int4
# projections, bf16 tied embedding and head, K=1.
GEMMA_CFG = dict(base_model="gemma-2-9b", draft_model="gemma-2-2b", max_draft=1,
                 max_new_tokens=64, max_seq_len=8192, quantization="int4", quantized_init=True,
                 quantize_embed=False, seed=0)
GEMMA_GEOMS = {"9b": (16, 8, 42), "2b": (8, 4, 26)}  # H, KVH, layers (half of them local)
GEMMA_OPTS = dict(scale=256.0 ** -0.5, softcap=50.0)  # query_pre_attn_scalar, attn softcap
GEMMA_WINDOW = 4096
LONG_PROMPT = PROMPT * 32  # 4320 byte tokens; Engine.decode's cache T = 4480
T_LONG = 4480
P_LONG = 4352  # a mid-generation position of the long-prompt run: 4320 + 32
# Mistral-7B with the rolling-buffer cache (phases 2 and 8): the 7B target
# and a 7B draft from the next seed (acceptance 0: every step writes K+1
# rows to the ring and commits one), int4 projections and head, bf16
# embedding, K=4, chunked prefill of 512, the ring.
MISTRAL_CFG = dict(base_model="mistral-7b", draft_model="mistral-7b", max_draft=4,
                   max_new_tokens=64, max_seq_len=8192, quantization="int4", quantized_init=True,
                   quantize_embed=False, prefill_chunk=512, kv_ring=True, seed=0)
MISTRAL_GEOM = (32, 8, 32)  # H, KVH, layers
MISTRAL_WINDOW = 4096
RING_LEN = 4736  # round_up(window 4096 + chunk 512 + K 4 + 2, 128)
MISTRAL_LONG = PROMPT * 40  # 5400 byte tokens: P = 5632 (11 chunks of 512), max_len 5760
MISTRAL_LONG_SHAPE = (5400, 5632, 5760)  # tokens, prompt block P, max_len
P_RING = 5400  # a decode position of the long prompt: its window wraps the ring
# Phase 12: EAGLE at the JAX package's eagle_8b_int4 (scripts/headline_suite.py):
# Llama-3.1-8B, int4 projections and untied head, int8 embedding, no draft
# model, K=2.
EAGLE_CFG = dict(base_model="llama-3.1-8b", draft_model=None, draft_mode="eagle", max_draft=2,
                 max_new_tokens=64, max_seq_len=512, quantization="int4", quantized_init=True,
                 quantize_embed=True, seed=0)
# Phase 13 on phase 3's int4 3B target (no draft model): Medusa at K=4 with
# identity ("tie") heads, and the JAX package's default tree.
MEDUSA_K = 4
TREE_BRANCHING = (3, 2)  # S = num_nodes + 1 = 10 verify rows, depth 2
TREE_S = 10
# self_distill_medusa's settings. Adam moves every entry of a [D, D] head by
# about lr a step, so h @ proj moves by up to lr * D: the tiny model's lr of
# 5e-3 (D = 64) is 5e-3 * 64 / 3072 ~ 1e-4 at the 3B's width; 5e-3 there
# diverged (loss 11.5 -> 180).
DISTILL = dict(num_heads=2, tokens_per_prompt=32, steps=30, lr=5e-5)
DISTILL_CAP_S = 60.0  # its time cap on the card, asserted
# The kernels each path must launch (and no other): the norms (rms_norm
# once a forward, add_rms_norm twice a layer a forward) and the
# projections' two kernels (decode rows through the decode body, prefill
# rows through the tensor-core path) on every path, then its attention.
INT4 = {"rms_norm", "add_rms_norm", "quant_matmul_int4", "quant_matmul_int4_mma"}
INT8 = {"rms_norm", "add_rms_norm", "quant_matmul_int8", "quant_matmul_int8_mma"}
SPEC = {"flash_decode", "flash_prefill", "verify_prefix"}
SERVE = {"flash_prefill", "paged_flash", "verify_prefix"}
PATH_KERNELS = {
    "generate int4 (3 runs)": INT4 | SPEC,
    "serving int4 (16 requests)": INT4 | SERVE,
    "generate int8 (3 runs)": INT8 | {"flash_decode_int8", "flash_prefill_int8", "verify_prefix"},
    "serving int8 (16 requests)": INT8 | {"flash_prefill_int8", "paged_flash_int8",
                                          "verify_prefix"},
    "generate gemma-2 (3 runs)": INT4 | SPEC,
    "generate gemma-2 long prompt (spec + baseline)": INT4 | SPEC,
    "serving gemma-2 (16 requests)": INT4 | SERVE,
    "generate mistral-7b ring (3 runs)": INT4 | SPEC,
    "generate mistral-7b ring long prompt (spec + baseline)": INT4 | SPEC,
    "generate mistral-7b full cache long prompt (baseline)": INT4 | {"flash_decode",
                                                                     "flash_prefill"},
    "generate mistral-7b int8 ring long prompt (baseline)": INT4 | {"flash_decode_int8",
                                                                    "flash_prefill_int8"},
    "generate mistral-7b int8 full cache long prompt (baseline)": INT4 | {"flash_decode_int8",
                                                                          "flash_prefill_int8"},
    "generate mistral-7b ngram K=4 ring long prompt": INT4 | SPEC,
    "generate int8 ngram K=12 (3 runs)": INT8 | SPEC,
    # 8 slots x 13 verify rows: B only through its tensor-core path.
    "serving int8 ngram K=12 (16 requests)": INT8 - {"quant_matmul_int8"} | SERVE,
    # rejection compares probabilities, not argmaxes: no kernel C.
    "generate int4 sampled rejection adaptive-device K=4 (3 runs)": INT4 | {"flash_decode",
                                                                             "flash_prefill"},
    "generate int4 greedy conf_threshold, topk_agree, typical, host adaptive K": INT4 | SPEC,
    "generate llama-3.1-8b int4 eagle K=2 (3 runs)": INT4 | SPEC,
    "generate int4 medusa K=4 (3 runs)": INT4 | SPEC,
    # The tree walks its own path (no C), and its verify chunk attends
    # through D's tree variant only.
    "generate int4 tree [3, 2] (3 runs)": INT4 | {"flash_prefill", "flash_decode_tree"},
    # 8 slots x 10 tree rows: A only through its tensor-core path.
    "serving int4 tree [3, 2] (16 requests)": INT4 - {"quant_matmul_int4"} | {
        "flash_prefill", "paged_flash_tree"},
    "serving int4 medusa K=4 (16 requests)": INT4 | SERVE,
}
GEMMA_PATHS = [path for path in PATH_KERNELS if "gemma-2" in path]
MISTRAL_PATHS = [path for path in PATH_KERNELS if "mistral" in path]
RING_PATHS = [path for path in MISTRAL_PATHS if "ring" in path]
# The phase-10 paths: the K=12 verify shapes have rows of their own.
NGRAM_PATHS = [path for path in PATH_KERNELS if "K=12" in path]
# The phase-12 path: A's decode body at the 8B widths has a row of its own.
EAGLE_PATHS = [path for path in PATH_KERNELS if "llama-3.1-8b" in path]
HEAD_PATHS = [path for path in PATH_KERNELS if "medusa" in path or "tree" in path]


T_START = time.perf_counter()


def log(*a):
    print(f"[{time.perf_counter() - T_START:7.1f} s]", *a, flush=True)


def median_ms(fn, iters=25, warmup=3):
    """Median device time of one call, from CUDA events recorded between
    back-to-back calls. A first pass measures how long the host takes to
    enqueue the calls; the timed pass then queues behind a spin kernel three
    times that long, so the events time the device's work and not the
    host's launch rate. If the spin did not cover the enqueue (the host
    stalled), the pass is repeated behind a longer spin; raises if it never
    does."""
    for _ in range(warmup):
        fn()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(iters + 2)]

    def enqueue():
        t0 = time.perf_counter()
        for i in range(iters):
            events[i + 1].record()
            fn()
        events[-1].record()
        return time.perf_counter() - t0

    torch.cuda.synchronize()
    spin_s = 3 * enqueue()
    for _ in range(4):
        torch.cuda.synchronize()
        events[0].record()
        torch.cuda._sleep(int(spin_s * SPIN_CYCLES_PER_S))
        took_s = enqueue()
        torch.cuda.synchronize()
        spun_s = events[0].elapsed_time(events[1]) / 1e3
        if spun_s > took_s:
            return statistics.median(events[i].elapsed_time(events[i + 1])
                                     for i in range(1, iters + 1))
        spin_s = 3 * max(spin_s, took_s)
    raise AssertionError(f"timing: enqueue {took_s:.6f} s outlasted the spin {spun_s:.6f} s")


def bound_ms(nbytes, nops):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, nops / PEAK_BF16_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Cycle:
    """Hands out views of L stacked copies in turn, so that timed calls read
    from device memory as the layer loop does, not from the 50 MB L2."""

    def __init__(self, n):
        self.i, self.n = 0, n

    def __call__(self):
        self.i = (self.i + 1) % self.n
        return self.i


def qmm_within(bits, got, ref):
    """Kernel A: within QMM_RTOL of the output's largest magnitude; kernel
    B: QMM8_RTOL |ref| + QMM8_MTOL max |ref| per element. Returns max abs err."""
    err = (got.float() - ref).abs()
    if bits == 4:
        ok = err.max() <= QMM_RTOL * ref.abs().max()
    else:
        ok = (err <= QMM8_RTOL * ref.abs() + QMM8_MTOL * ref.abs().max()).all()
    assert torch.isfinite(got).all() and bool(ok), (bits, tuple(got.shape), err.max().item())
    return err.max().item()


def qmm_prefill(dev, bits, g):
    """Kernel A (bits 4) or B (bits 8) at the prefill shapes of every width
    in QMM_WIDTHS: within tolerance of the plain version at MMA_CHECK_M
    (the first M rows of one x), every row with the same bits at each of
    those M, and the rows that differ between the decode body (those rows
    at M = MMA_MIN_M - 1) and the tensor-core path (at MMA_MIN_M)
    counted; timed at PREFILL_M beside the plain version, the library call
    (A: dequantize, then torch.matmul; B: torch.matmul(x, w.to(bf16)) *
    scale) and the bound. Returns ({(K, N, M): numbers}, max abs err,
    rows across the paths)."""
    from llm_inference_lab_tpu_torch.ops.quant import QuantTensor, dequantize
    from llm_inference_lab_tpu_torch.ops.quant_matmul import (
        MMA_MIN_M,
        quant_matmul,
        quant_matmul_int8,
        quant_matmul_plain,
        quant_matmul_plain_int8,
    )

    kernel, plain = ((quant_matmul, quant_matmul_plain) if bits == 4 else
                     (quant_matmul_int8, quant_matmul_plain_int8))

    def library(x, w, sc):
        if bits == 4:
            return torch.matmul(x, dequantize(QuantTensor(w, sc, 4), torch.bfloat16))
        return torch.matmul(x, w.to(torch.bfloat16)) * sc

    rows, max_err, across = {}, 0.0, 0
    name = f"quant_matmul_int{bits}"
    for width, shapes in QMM_WIDTHS.items():
        for K, N in shapes:
            wrows = K // 2 if bits == 4 else K
            L = max(2, (200 << 20) // (wrows * N))  # > 200 MB of weights: beyond L2
            w = torch.randint(-128, 128, (L, wrows, N), generator=g, dtype=torch.int8, device=dev)
            sc = torch.rand((L, N), generator=g, device=dev) * (0.02 / (7 if bits == 4 else 127))
            sc += 1e-5
            x = torch.randn((max(MMA_CHECK_M), K), generator=g, device=dev).bfloat16()
            outs = {}
            for M in MMA_CHECK_M:
                outs[M] = kernel(x[:M], w[0], sc[0])
                max_err = max(max_err, qmm_within(bits, outs[M], plain(x[:M].float(), w[0], sc[0])))
            for M in MMA_CHECK_M[:-1]:  # the same bits for a row at every M of the path
                assert torch.equal(outs[M], outs[MMA_CHECK_M[-1]][:M]), (name, K, N, M)
            decode = kernel(x[:MMA_MIN_M - 1], w[0], sc[0])
            n_across = int((decode != outs[MMA_MIN_M][:MMA_MIN_M - 1]).any(-1).sum())
            across += n_across
            cyc = Cycle(L)
            line = []
            for M in PREFILL_M:
                xm = x[:M]
                ms = median_ms(lambda: kernel(xm, w[cyc()], sc[cyc.i]))
                pl = median_ms(lambda: plain(xm, w[cyc()], sc[cyc.i]), iters=5, warmup=1)
                lib = median_ms(lambda: library(xm, w[cyc()], sc[cyc.i]), iters=10)
                b, by = bound_ms(wrows * N + 4 * N + 2 * M * K + 2 * M * N, 2 * M * K * N)
                rows[(K, N, M)] = dict(ms=ms, plain_ms=pl, library_ms=lib, bound_ms=b, bound_by=by)
                line.append(f"M={M} {ms:.4f} ms ({2 * M * K * N / ms / 1e9:.0f} TFLOP/s, "
                            f"{b / ms:.3f} of the bound {b:.4f} {by}) plain {pl:.4f} library "
                            f"{lib:.4f} ({ms / lib:.2f}x)")
            log(f"{name} tensor-core path {width} K={K} N={N}: within tolerance at M = "
                f"{MMA_CHECK_M}, every row the same bits at each; rows differing from the "
                f"decode body's (M = {MMA_MIN_M - 1} vs {MMA_MIN_M}): {n_across} of "
                f"{MMA_MIN_M - 1}; " + "; ".join(line))
            del w, sc, x, outs
    return rows, max_err, across


def sum_rows(rows, work, max_err):
    """Sum the numbers of rows[(K, N, M)] over work [(K, N, M, count)]."""
    agg = {key: sum(rows[(k, n, m)][key] * c for k, n, m, c in work)
           for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    by_ops = sum(c for k, n, m, c in work if rows[(k, n, m)]["bound_by"] == "operations")
    agg["bound_by"] = "operations" if by_ops > sum(c for *_, c in work) // 2 else "bytes"
    agg["max_abs_err"] = max_err
    return agg


def qmm_decode(dev, bits, g, widths):
    """Kernel A (bits 4) or B (bits 8) below MMA_MIN_M rows, the decode body
    (csrc/qmm_decode.cuh), at every projection of widths {name: (shapes,
    timed M)}: within tolerance of the plain version at DECODE_CHECK_M (the
    first M rows of one x), every row with the same bits as the row alone
    (asserted), and a second call on the same weights with the same bits
    (the split's tickets reset), and so at every timed M; timed at the
    width's M beside the plain
    version, the library call (A: dequantize, then torch.matmul; B:
    torch.matmul(x, w.to(bf16)) * scale) and the bound. Returns ({(K, N,
    M): numbers}, max abs err)."""
    from llm_inference_lab_tpu_torch.ops.quant import QuantTensor, dequantize
    from llm_inference_lab_tpu_torch.ops.quant_matmul import (
        decode_plan,
        quant_matmul,
        quant_matmul_int8,
        quant_matmul_plain,
        quant_matmul_plain_int8,
    )

    kernel, plain = ((quant_matmul, quant_matmul_plain) if bits == 4 else
                     (quant_matmul_int8, quant_matmul_plain_int8))

    def library(x, w, sc):
        if bits == 4:
            return torch.matmul(x, dequantize(QuantTensor(w, sc, 4), torch.bfloat16))
        return torch.matmul(x, w.to(torch.bfloat16)) * sc

    rows, max_err = {}, 0.0
    name = f"quant_matmul_int{bits}"
    for width, (shapes, time_m) in widths.items():
        for K, N in shapes:
            wrows = K // 2 if bits == 4 else K
            L = max(2, (200 << 20) // (wrows * N))  # > 200 MB of weights: beyond L2
            w = torch.randint(-128, 128, (L, wrows, N), generator=g, dtype=torch.int8, device=dev)
            sc = torch.rand((L, N), generator=g, device=dev) * (0.02 / (7 if bits == 4 else 127))
            sc += 1e-5
            x = torch.randn((max(DECODE_CHECK_M), K), generator=g, device=dev).bfloat16()
            alone = torch.cat([kernel(x[i:i + 1], w[0], sc[0]) for i in range(len(x))])
            for M in sorted(set(DECODE_CHECK_M) | set(time_m)):
                got = kernel(x[:M], w[0], sc[0])
                max_err = max(max_err, qmm_within(bits, got, plain(x[:M].float(), w[0], sc[0])))
                assert torch.equal(got, alone[:M]), (name, K, N, M, "M-dependent rounding")
            again = kernel(x[:40], w[0], sc[0])
            assert torch.equal(again, kernel(x[:40], w[0], sc[0])), (name, K, N, "repeat")
            cyc = Cycle(L)
            line = []
            for M in time_m:
                xm = x[:M]
                ms = median_ms(lambda: kernel(xm, w[cyc()], sc[cyc.i]))
                pl = median_ms(lambda: plain(xm, w[cyc()], sc[cyc.i]), iters=5, warmup=1)
                lib = median_ms(lambda: library(xm, w[cyc()], sc[cyc.i]), iters=10)
                b, by = bound_ms(wrows * N + 4 * N + 2 * M * K + 2 * M * N, 2 * M * K * N)
                rows[(K, N, M)] = dict(ms=ms, plain_ms=pl, library_ms=lib, bound_ms=b, bound_by=by)
                line.append(f"M={M} {ms:.4f} ms (bound {b:.4f} {by}, {b / ms:.3f} of it) plain "
                            f"{pl:.4f} library {lib:.4f} ({ms / lib:.2f}x)")
            log(f"{name} decode body {width} K={K} N={N} (K split {decode_plan(K, N, bits)}): "
                f"within tolerance and every row the same bits as alone at M = "
                f"{DECODE_CHECK_M}; " + "; ".join(line))
            del w, sc, x, alone
    return rows, max_err


def calls(work):
    """[(shapes, M, count)] -> [(K, N, M, count)], the form sum_rows takes."""
    return [(k, n, m, c) for shapes, m, c in work for k, n in shapes]


def log_step(name, what, rows, work):
    agg = sum_rows(rows, calls(work), 0.0)
    log(f"{name} {what}: " + ", ".join(f"{key} {agg[key]:.4f}" for key in
                                       ("ms", "bound_ms", "plain_ms", "library_ms")))


def phase_quant_matmul(dev):
    """Kernel A: the decode body at every width's decode shapes
    (qmm_decode), with the step sums of each path; then the tensor-core path
    at every width's prefill shapes (qmm_prefill). Returns (one K=1 B=1
    step's numbers, the Mistral-7B long prompt's prefill projections through
    one model: 11 chunks of 512 rows, 32 layers and the head)."""
    g = torch.Generator(device=dev).manual_seed(1)
    rows, max_err = qmm_decode(dev, 4, g, QMM_DECODE)
    layers = {"1B": 16, "3B": 28, "2B": GEMMA_GEOMS["2b"][2], "9B": GEMMA_GEOMS["9b"][2],
              "7B": MISTRAL_GEOM[2]}
    # One K=1 decode step: 16 draft layers at M=1, 28 target layers at M=2.
    step = [(QMM_1B, 1, layers["1B"]), (QMM_3B, 2, layers["3B"])]
    log_step("quant_matmul_int4", "one K=1 B=1 step (1B draft M = 1, 3B verify M = 2)", rows,
             step)
    log_step("quant_matmul_int4", "one 8-slot K=1 serving step (M = 8 draft, 16 verify)", rows,
             [(QMM_1B, 8, layers["1B"]), (QMM_3B, 16, layers["3B"])])
    log_step("quant_matmul_int4", "one Gemma-2 K=1 B=1 step (2B draft M = 1, 9B verify M = 2)",
             rows, [(QMM_2B, 1, layers["2B"]), (QMM_9B, 2, layers["9B"])])
    log_step("quant_matmul_int4", "one Gemma-2 8-slot K=1 serving step (M = 8 draft, 16 verify)",
             rows, [(QMM_2B, 8, layers["2B"]), (QMM_9B, 16, layers["9B"])])
    log_step("quant_matmul_int4", "one Mistral-7B K=4 B=1 step on the ring (4 x 32 draft "
             "layers and the head at M = 1, 32 verify layers and the head at M = 5)", rows,
             [(QMM_MISTRAL, 1, 4 * layers["7B"]), ([MISTRAL_HEAD], 1, 4),
              (QMM_MISTRAL, 5, layers["7B"]), ([MISTRAL_HEAD], 5, 1)])
    pre, pre_err, across = qmm_prefill(dev, 4, g)
    log(f"quant_matmul_int4: {across} rows differ between the decode body and the "
        f"tensor-core path over {sum(map(len, QMM_WIDTHS.values()))} shapes")
    chunks = -(-MISTRAL_LONG_SHAPE[1] // 512)
    mistral = [(k, n, 512, layers["7B"] * chunks) for k, n in QMM_MISTRAL]
    mistral.append((*MISTRAL_HEAD, 512, chunks))
    return sum_rows(rows, calls(step), max_err), sum_rows(pre, mistral, pre_err)


def flash_inputs(g, dev, B, S, H, KVH, T, D, p_last, L=1):
    q = torch.randn((B, S, H, D), generator=g, device=dev).bfloat16()
    k = torch.randn((L, B, KVH, T, D), generator=g, device=dev).bfloat16()
    v = torch.randn((L, B, KVH, T, D), generator=g, device=dev).bfloat16()
    pos = (p_last - S + 1 + torch.arange(S, device=dev, dtype=torch.int32))[None].repeat(B, 1)
    return q, k, v, pos.contiguous()


def sdpa(q, k, v, pos):
    """One library call for the same function (timed only, never used)."""
    T = k.shape[2]
    mask = torch.arange(T, device=q.device)[None, None, None, :] <= pos[:, None, :, None]
    out = torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k, v, attn_mask=mask, enable_gqa=True)
    return out.transpose(1, 2)


def phase_flash_decode(dev):
    from llm_inference_lab_tpu_torch.ops.flash_decode import flash_decode, flash_decode_plain

    g = torch.Generator(device=dev).manual_seed(2)
    geoms = {64: (32, 8), 128: (24, 8)}  # D: (H, KVH) of the 1B and the 3B
    max_err = 0.0
    for S in (1, 2, 160):
        for D, (H, KVH) in geoms.items():
            for T in (256, 4096):
                # The last position ends 8 keys into a 32-key tile: a partial
                # tile is read, and keys past it hold POISON.
                p_last = T - 57
                q, k, v, pos = flash_inputs(g, dev, 2, S, H, KVH, T, D, p_last)
                v[..., p_last + 1:, :] = POISON
                pos[1, 0] = -1  # a dead row: must be zeros
                got = flash_decode(q, k[0], v[0], pos)
                err = check_attn(got, q, k[0], v[0], pos, what=("flash_decode", S, D, T))
                assert torch.all(got[1, 0] == 0), (S, D, T, "dead row not zero")
                if S == 2:  # row 0 is the same alone and inside the batch
                    one = flash_decode(q[:, :1].contiguous(), k[0], v[0],
                                       pos[:, :1].contiguous())
                    assert torch.equal(one, got[:, :1]), (D, T, "S-dependent rounding")
                max_err = max(max_err, err)
                log(f"flash_decode S={S} D={D} T={T}: max_abs_err {err:.3g} (dead row zero)")
    # Timing at the main path's shapes, B=1, T=256: the draft (S=1, D=64)
    # and verify (S=2, D=128) calls of one step at position P_MAIN, and the
    # S=160 prefill of each model (once per request: not in the step's sum).
    agg = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, bound_by="bytes",
               max_abs_err=max_err)
    for S, D, n in ((1, 64, 16), (2, 128, 28), (160, 64, 0), (160, 128, 0)):
        H, KVH = geoms[D]
        p_last = P_MAIN if S <= 2 else S - 1
        L = 2 * L2_BYTES // (2 * KVH * T_MAIN * D * 2) + 1  # K+V copies twice the L2
        q, k, v, pos = flash_inputs(g, dev, 1, S, H, KVH, T_MAIN, D, p_last, L=L)
        cyc = Cycle(L)
        ms = median_ms(lambda: flash_decode(q, k[cyc()], v[cyc.i], pos))
        plain = median_ms(lambda: flash_decode_plain(q, k[cyc()], v[cyc.i], pos), iters=10)
        lib = median_ms(lambda: sdpa(q, k[cyc()], v[cyc.i], pos), iters=10)
        kv = p_last + 1  # keys the positions reach
        seen = sum(p_last - S + 2 + i for i in range(S))  # keys summed over the query rows
        b, by = bound_ms(2 * KVH * kv * D * 2 + 2 * 2 * S * H * D + 4 * S, 4 * H * seen * D)
        log(f"flash_decode S={S} D={D} T={T_MAIN} p={p_last}: {ms:.4f} ms  plain {plain:.4f}  "
            f"library {lib:.4f}  bound {b:.5f} ({by})")
        for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib), ("bound_ms", b)):
            agg[key] += n * val
    return agg


VERIFY_V = (128256, 256000, 32000)  # the Llama-3, Gemma-2 and Mistral vocabularies
VERIFY_ODD_V = 50257  # a vocabulary whose rows leave 16-byte alignment (gpt2's)


def verify_cases(g, dev):
    """Kernel C's cases: {name: (draft, logits)}. The main path's [1, 1, V]
    view of [1, 2, V] for each of VERIFY_V; [8, 4, V] as the first K rows of
    [8, 5, V] with a forced tie, a mismatch, a NaN in a matching row, an
    all-NaN row and an all -inf row; V = 50257 from a buffer 4 bytes past a
    16-byte boundary; a tie across a split boundary (the lower index in the
    earlier split, and the draft naming the higher one: reject); a NaN only
    in the last split."""
    from llm_inference_lab_tpu_torch.ops.verify import split_width, verify_plan

    cases = {}
    for V in VERIFY_V:
        lg = torch.randn((1, 2, V), generator=g, device=dev)[:, :-1]
        cases[f"[1,1,{V}]"] = (torch.argmax(lg, -1).to(torch.int32), lg)
    V = VERIFY_V[0]
    lg = torch.randn((8, 5, V), generator=g, device=dev)[:, :4]
    d = torch.argmax(lg, -1).to(torch.int32)
    d[1, 2] += 1
    lg[3, 1, 7] = lg[3, 1, 9000] = lg[3, 1].max() + 1
    d[3, 1] = 7
    lg[0, 3, 5] = float("nan")
    lg[2, 0, :] = float("nan")
    lg[4, 3, :] = float("-inf")
    d[4, 3] = 0
    cases[f"[8,4,{V}] strided"] = (d, lg)
    B, K, V = 2, 3, VERIFY_ODD_V
    flat = torch.randn((B * K * V + 1,), generator=g, device=dev)
    lg = flat[1:].view(B, K, V)
    cases[f"[{B},{K},{V}] unaligned"] = (torch.argmax(lg, -1).to(torch.int32), lg)
    B, K, V = 2, 2, VERIFY_V[0]
    n = verify_plan(B * K, V)
    w = split_width(V, n)
    lg = torch.randn((B, K + 1, V), generator=g, device=dev)[:, :K]
    d = torch.argmax(lg, -1).to(torch.int32)
    top = float(lg.max()) + 1
    lg[0, 0, w - 1] = lg[0, 0, w] = top
    lg[0, 1, 2 * w - 1] = lg[0, 1, 2 * w] = top
    lg[1, 1, (n - 1) * w] = float("nan")
    d[0, 0], d[0, 1] = w - 1, 2 * w
    cases[f"[{B},{K},{V}] tie across splits, NaN in the last"] = (d, lg)
    return cases


def phase_verify_prefix(dev):
    """Kernel C split over V (verify_plan) at every case of verify_cases:
    equal to the plain version and to its split plain version exactly, one
    launch a call, the ticket counters back at 0; timed at the main path's
    [1, 1, 128256] (and the other vocabularies) beside the plain version,
    torch.argmax and the bound (the logits read once)."""
    from llm_inference_lab_tpu_torch.ops.flash_decode import ticket_counters
    from llm_inference_lab_tpu_torch.ops.verify import (
        verify_plan,
        verify_prefix,
        verify_prefix_plain,
        verify_prefix_split_plain,
    )

    g = torch.Generator(device=dev).manual_seed(3)
    cases = verify_cases(g, dev)
    for name, (d, lg) in cases.items():
        B, K, V = lg.shape
        ref = verify_prefix_plain(d, lg)
        split = verify_prefix_split_plain(d, lg, verify_plan(B * K, V))
        before = verify_prefix.launches
        got = verify_prefix(d, lg)
        assert verify_prefix.launches == before + 1, (name, "launches")
        torch.cuda.synchronize()
        for a, b in ((got, ref), (split, ref)):
            assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]), (name, a, b)
        assert not ticket_counters(dev, B)[:B].any(), (name, "tickets not reset")
        log(f"verify_prefix {name} ({verify_plan(B * K, V)} splits a row): accept_len "
            f"{got[0].tolist()} == plain == split plain, one launch")
    assert not cases["[8,4,128256] strided"][1].is_contiguous()
    assert verify_prefix(*cases["[8,4,128256] strided"])[0].tolist() == [3, 2, 0, 4, 4, 4, 4, 4]
    assert verify_prefix(*cases["[2,2,128256] tie across splits, NaN in the last"])[1].tolist() \
        == [[True, False], [True, False]]
    agg = None
    for V in VERIFY_V:
        d, lg = cases[f"[1,1,{V}]"]
        ms = median_ms(lambda: verify_prefix(d, lg))
        plain = median_ms(lambda: verify_prefix_plain(d, lg))
        lib = median_ms(lambda: torch.argmax(lg, -1))
        b, by = bound_ms(V * 4 + 4 + 1 + 4, V)
        log(f"verify_prefix [1,1,{V}] ({verify_plan(1, V)} splits): {ms:.4f} ms  plain "
            f"{plain:.4f}  library {lib:.4f} (torch.argmax)  bound {b:.5f} ({by})  exact")
        if agg is None:  # the main path's vocabulary
            agg = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b, bound_by=by,
                       max_abs_err=0.0)
    return agg


def phase_ngram_shapes(dev):
    """Kernels D and C at the ngram path's verify shapes (phase 10: the
    int8 3B, K=12, B=1, T = 256): D at S = 13 over a bf16 cache with
    POISON past the last position, within tolerance of its plain version,
    a dead row zero, and each of its rows the bits of that row alone (S =
    1); C at [1, 12, 128256] as the first 12 rows of [1, 13, V], exactly its
    plain version and its split plain version. Each timed beside its plain
    version, its library call and its bound. Returns {row: numbers} for
    one ngram step (D: 28 layers; C: one call)."""
    from llm_inference_lab_tpu_torch.ops.flash_decode import flash_decode, flash_decode_plain
    from llm_inference_lab_tpu_torch.ops.verify import (
        verify_plan,
        verify_prefix,
        verify_prefix_plain,
        verify_prefix_split_plain,
    )

    g = torch.Generator(device=dev).manual_seed(12)
    S, (H, KVH), D = NGRAM_K + 1, (24, 8), 128
    q, k, v, pos = flash_inputs(g, dev, 2, S, H, KVH, T_MAIN, D, NGRAM_P)
    v[..., NGRAM_P + 1:, :] = POISON
    pos[1, 0] = -1
    got = flash_decode(q, k[0], v[0], pos)
    err = check_attn(got, q, k[0], v[0], pos, what=("flash_decode", S, D, T_MAIN))
    assert torch.all(got[1, 0] == 0), "dead row not zero"
    for i in range(S):
        one = flash_decode(q[:, i:i + 1].contiguous(), k[0], v[0], pos[:, i:i + 1].contiguous())
        assert torch.equal(one, got[:, i:i + 1]), (i, "S-dependent rounding")
    L = 2 * L2_BYTES // (2 * KVH * T_MAIN * D * 2) + 1
    q, k, v, pos = flash_inputs(g, dev, 1, S, H, KVH, T_MAIN, D, NGRAM_P, L=L)
    cyc = Cycle(L)
    ms = median_ms(lambda: flash_decode(q, k[cyc()], v[cyc.i], pos))
    plain = median_ms(lambda: flash_decode_plain(q, k[cyc()], v[cyc.i], pos), iters=10)
    lib = median_ms(lambda: sdpa(q, k[cyc()], v[cyc.i], pos), iters=10)
    seen = sum(NGRAM_P - S + 2 + i for i in range(S))
    b, by = bound_ms(2 * KVH * (NGRAM_P + 1) * D * 2 + 2 * 2 * S * H * D + 4 * S,
                     4 * H * seen * D)
    log(f"flash_decode S={S} D={D} T={T_MAIN} p={NGRAM_P}: max_abs_err {err:.3g}, every row the "
        f"bits of S = 1; {ms:.4f} ms  plain {plain:.4f}  library {lib:.4f}  bound {b:.5f} ({by})")
    rows = {"flash_decode": dict(ms=28 * ms, plain_ms=28 * plain, library_ms=28 * lib,
                                 bound_ms=28 * b, bound_by=by, max_abs_err=err)}
    V = VERIFY_V[0]
    lg = torch.randn((1, NGRAM_K + 1, V), generator=g, device=dev)[:, :NGRAM_K]
    d = torch.argmax(lg, -1).to(torch.int32)
    d[0, 7] = (d[0, 7] + 1) % V  # accept 7
    ref = verify_prefix_plain(d, lg)
    split = verify_prefix_split_plain(d, lg, verify_plan(NGRAM_K, V))
    got = verify_prefix(d, lg)
    for a in (got, split):
        assert torch.equal(a[0], ref[0]) and torch.equal(a[1], ref[1]), (a, ref)
    assert got[0].tolist() == [7]
    ms = median_ms(lambda: verify_prefix(d, lg))
    plain = median_ms(lambda: verify_prefix_plain(d, lg))
    lib = median_ms(lambda: torch.argmax(lg, -1))
    b, by = bound_ms(NGRAM_K * V * 4 + 4 * NGRAM_K + NGRAM_K + 4, NGRAM_K * V)
    log(f"verify_prefix [1,{NGRAM_K},{V}] ({verify_plan(NGRAM_K, V)} splits a row): accept_len "
        f"7 == plain == split plain; {ms:.4f} ms  plain {plain:.4f}  library {lib:.4f} "
        f"(torch.argmax)  bound {b:.5f} ({by})")
    rows["verify_prefix"] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b, bound_by=by,
                                 max_abs_err=0.0)
    return rows


def phase_sampling_ops(dev):
    """sample_tokens on the card against its own distribution: SAMPLE_DRAWS
    draws (chunks of 2048 rows, each chunk its own key) from one fixed row
    of 128256 logits (48 live ones) under phase 11's filters (temperature
    0.8, top_p 0.95), within total variation SAMPLE_TV of
    exp(proposal_log_probs);
    the card's uniforms are the CPU's bits. Then the plain PyTorch sampling
    ops of phase 11's step timed at its shapes (no Pallas kernel in JAX
    either): a draft or bonus draw [1, V] (top_p's sort of the row),
    rejection's proposal distributions [1, 4, V] and its residual bonus."""
    from llm_inference_lab_tpu_torch.core.policies import rejection_bonus_logits, rejection_ratio
    from llm_inference_lab_tpu_torch.ops.sampling import (
        filtered_logits,
        fold,
        proposal_log_probs,
        sample_tokens,
        seed_key,
        uniform,
    )

    g = torch.Generator(device=dev).manual_seed(13)
    V = VERIFY_V[0]
    kw = {key: SAMPLED[key] for key in ("temperature", "top_p")}
    # 48 logits from 3 down to -1 spread over the row, the rest at -30: the
    # filters keep 28 tokens, and 2**16 draws give a total variation of
    # about 0.0074 from sampling alone.
    row = torch.full((V,), -30.0, device=dev)
    row[torch.arange(48, device=dev) * (V // 48)] = torch.linspace(3.0, -1.0, 48, device=dev)
    key = torch.tensor(seed_key(13), device=dev)
    assert torch.equal(uniform(key, (4, V)).cpu(), uniform(key.cpu(), (4, V)))
    counts = torch.zeros(V, dtype=torch.int64, device=dev)
    chunk = 2048
    for i in range(SAMPLE_DRAWS // chunk):
        ids = sample_tokens(fold(key, i), row.expand(chunk, V), **kw)
        counts += torch.bincount(ids.long(), minlength=V)
    want = proposal_log_probs(row, **kw).exp().double()
    tv = 0.5 * float((counts.double() / SAMPLE_DRAWS - want).abs().sum())
    support = int((want > 0).sum())
    assert tv < SAMPLE_TV, ("sample_tokens on the card is off its distribution", tv)
    log(f"sample_tokens on the card: {SAMPLE_DRAWS} draws from one row of {V} logits "
        f"(temperature {kw['temperature']}, top_p {kw['top_p']}: {support} tokens kept), "
        f"total variation {tv:.4f} < {SAMPLE_TV}; uniforms == the CPU's bits")
    x1 = torch.randn((1, V), generator=g, device=dev) * 3
    dl = torch.randn((1, 4, V), generator=g, device=dev) * 3
    tl = torch.randn((1, 5, V), generator=g, device=dev) * 3
    d = torch.randint(0, V, (1, 4), generator=g, device=dev, dtype=torch.int32)
    a = torch.tensor([2], device=dev, dtype=torch.int32)
    rej = dict(kw, draft_temperature=kw["temperature"] / 1.5)
    # 15-70 launches a call, more than median_ms's spin can keep ahead of:
    # CUDA events around 20 back-to-back calls instead (the host's enqueue
    # time shows where it is the longer).
    def loop_ms(fn, iters=20):
        fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    times = {
        "argmax [1, V] (greedy)": loop_ms(lambda: sample_tokens(None, x1, greedy=True)),
        "filtered_logits [1, V] (the top_p sort)": loop_ms(lambda: filtered_logits(x1, **kw)),
        "sample_tokens [1, V]": loop_ms(lambda: sample_tokens(key, x1, **kw)),
        "rejection_ratio [1, 4, V]": loop_ms(lambda: rejection_ratio(d, dl, tl, **rej)),
        "rejection_bonus_logits [1, 4, V]": loop_ms(
            lambda: rejection_bonus_logits(dl, tl, a, **rej)),
    }
    log("sampling ops at phase 11's shapes (plain PyTorch; CUDA events around 20 calls): "
        + "; ".join(f"{what} {ms:.4f} ms" for what, ms in times.items()))
    return times


# d_model of every model on a path, with Gemma's one-offset weights.
NORM_WIDTHS = ((2048, False), (3072, False), (2304, True), (3584, True), (4096, False))
NORM_M = (1, 2, 5, 8, 16, 40, 512)
ADD_NORM_M = (1, 2, 5, 8, 16, 40, 63, 512, 2048)


def phase_rms_norm(dev):
    """The rms_norm kernel at every path's width (1B, 3B, Gemma-2 2B and 9B
    with one-offset weights, Mistral-7B), bf16 rows and weights: within one
    bf16 step of the plain formula per element, and every row with the same
    bits alone and among M = 2, 5, 8, 16, 40, 512 rows. Then the fused
    add_rms_norm at the same widths (the Gemma-2 widths also with the post
    weight), M = ADD_NORM_M, bf16 and f32 weights: its residual bit for bit
    torch's x + a' and its norm the rms_norm kernel's on that residual, one
    launch a call. Times at the B=1 main path's K=1 step: rms_norm, the
    first norm of each forward, once at M = 1 (1B draft) and once at M = 2
    (3B verify); add_rms_norm 32 times at M = 1 and 56 at M = 2, beside the
    unfused pair it replaced (torch's add, then the rms_norm kernel), its
    plain version, the library pair (torch's add, then F.rms_norm) and the
    bound. Returns (the rms_norm row, the add_rms_norm row)."""
    from llm_inference_lab_tpu_torch.ops.rms_norm import (
        add_rms_norm,
        add_rms_norm_plain,
        rms_norm,
        rms_norm_plain,
    )

    g = torch.Generator(device=dev).manual_seed(7)
    max_err = 0.0
    for N, one_offset in NORM_WIDTHS:
        x = (torch.randn((max(NORM_M), N), generator=g, device=dev) * 3).bfloat16()
        w = (torch.randn((N,), generator=g, device=dev) * 0.1 + (0 if one_offset else 1))
        w = w.bfloat16()
        got = rms_norm(x, w, 1e-6, one_offset)
        ref = rms_norm_plain(x, w, 1e-6, one_offset).float()
        step = 2.0 ** (torch.floor(torch.log2(ref.abs().clamp_min(1e-30))) - 7)
        err = (got.float() - ref).abs()
        assert torch.all(err <= step), (N, "rms_norm beyond one bf16 step")
        max_err = max(max_err, err.max().item())
        alone = torch.cat([rms_norm(x[i:i + 1], w, 1e-6, one_offset) for i in range(40)])
        differ = {M: int((rms_norm(x[:M], w, 1e-6, one_offset) != alone[:M]).any(-1).sum())
                  for M in NORM_M[1:6]}
        differ[512] = int((got[:40] != alone).any(-1).sum())
        assert not any(differ.values()), (N, "rows depend on M", differ)
        log(f"rms_norm N={N} one_offset={one_offset}: within one bf16 step of the plain formula "
            f"(max abs err {err.max().item():.3g}); rows differing from the row alone at M = "
            f"2/5/8/16/40/512: {'/'.join(str(differ[m]) for m in NORM_M[1:])}")
    add_err = 0.0
    for N, one_offset in NORM_WIDTHS:
        x = (torch.randn((max(ADD_NORM_M), N), generator=g, device=dev) * 3).bfloat16()
        a = (torch.randn((max(ADD_NORM_M), N), generator=g, device=dev) * 2).bfloat16()
        for w_dtype in (torch.bfloat16, torch.float32):
            w = (torch.randn((N,), generator=g, device=dev) * 0.1 + (0 if one_offset else 1))
            pw = (torch.randn((N,), generator=g, device=dev) * 0.3 + (0 if one_offset else 1))
            w, pw = w.to(w_dtype), pw.to(w_dtype)
            for post in ((None, pw) if one_offset else (None,)):
                for M in ADD_NORM_M:
                    before = add_rms_norm.launches
                    res, norm = add_rms_norm(x[:M], a[:M], w, 1e-6, one_offset, post)
                    assert add_rms_norm.launches == before + 1, (N, M, "launches")
                    a2 = a[:M] if post is None else rms_norm(a[:M], post, 1e-6, one_offset)
                    ref = x[:M] + a2
                    assert torch.equal(res, ref), (N, M, w_dtype, post is None, "residual bits")
                    assert torch.equal(norm, rms_norm(ref, w, 1e-6, one_offset)), (
                        N, M, w_dtype, post is None, "norm bits")
                    plain = rms_norm_plain(ref, w, 1e-6, one_offset).float()
                    add_err = max(add_err, (norm.float() - plain).abs().max().item())
            log(f"add_rms_norm N={N} one_offset={one_offset} {str(w_dtype)[6:]} weights"
                f"{' (and the post weight)' if one_offset else ''}: residual and norm bit for "
                f"bit torch's add then the rms_norm kernel at M = {ADD_NORM_M}, one launch a call")
    norm_row = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, bound_by="bytes",
                    max_abs_err=max_err)
    add_row = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, bound_by="bytes",
                   max_abs_err=add_err)
    unfused = 0.0
    for M, N, n in ((1, 2048, 16 * 2), (2, 3072, 28 * 2)):
        x = torch.randn((M, N), generator=g, device=dev).bfloat16()
        a = torch.randn((M, N), generator=g, device=dev).bfloat16()
        w = torch.ones((N,), device=dev, dtype=torch.bfloat16)
        ms = median_ms(lambda: rms_norm(x, w, 1e-5))
        plain = median_ms(lambda: rms_norm_plain(x, w, 1e-5))
        lib = median_ms(lambda: torch.nn.functional.rms_norm(x, (N,), w, 1e-5))
        b, by = bound_ms(2 * 2 * M * N + 2 * N, 4 * M * N)
        log(f"rms_norm M={M} N={N}: {ms:.4f} ms  plain {plain:.4f}  library {lib:.4f} "
            f"(F.rms_norm)  bound {b:.6f} ({by})")
        for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib), ("bound_ms", b)):
            norm_row[key] += val
        ms = median_ms(lambda: add_rms_norm(x, a, w, 1e-5))
        pair = median_ms(lambda: rms_norm(x + a, w, 1e-5))
        plain = median_ms(lambda: add_rms_norm_plain(x, a, w, 1e-5))
        lib = median_ms(lambda: torch.nn.functional.rms_norm(x + a, (N,), w, 1e-5))
        b, by = bound_ms(8 * M * N + 2 * N, 5 * M * N)
        log(f"add_rms_norm M={M} N={N}: {ms:.4f} ms  unfused (torch add + rms_norm kernel) "
            f"{pair:.4f}  plain {plain:.4f}  library {lib:.4f} (x + a, F.rms_norm)  bound "
            f"{b:.6f} ({by}); x {n} calls a K=1 step")
        for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib), ("bound_ms", b)):
            add_row[key] += n * val
        unfused += n * pair
    log(f"add_rms_norm a K=1 step (88 calls): {add_row['ms']:.4f} ms; the unfused pairs it "
        f"replaced {unfused:.4f} ms; the step's norms: {add_row['ms'] + norm_row['ms']:.4f} ms "
        f"in 90 launches (unfused: {unfused + norm_row['ms']:.4f} ms in 178)")
    for M, N in ((1, 2304), (2, 3584)):  # Gemma-2's sandwich variant at its K=1 step's M
        x, a = (torch.randn((M, N), generator=g, device=dev).bfloat16() for _ in "xa")
        w = torch.zeros((N,), device=dev, dtype=torch.bfloat16)
        ms = median_ms(lambda: add_rms_norm(x, a, w, 1e-6, True, w))
        pair = median_ms(lambda: rms_norm(x + rms_norm(a, w, 1e-6, True), w, 1e-6, True))
        lib = median_ms(lambda: torch.nn.functional.rms_norm(
            x + torch.nn.functional.rms_norm(a, (N,), w + 1, 1e-6), (N,), w + 1, 1e-6))
        log(f"add_rms_norm with the post weight M={M} N={N}: {ms:.4f} ms  unfused (rms_norm "
            f"kernel, torch add, rms_norm kernel) {pair:.4f}  library {lib:.4f}")
    return norm_row, add_row


def f32_plain(q, k, v, pos, ks=None, vs=None, **opts):
    """The plain attention on f32 copies (an int8 cache dequantized in f32)
    and the same with |v|: (ref, sum_j P_j |v_j|) per output element."""
    from llm_inference_lab_tpu_torch.ops.flash_decode import flash_decode_plain

    kf, vf = k.float(), v.float()
    if ks is not None:
        kf, vf = kf * ks[..., None], vf * vs[..., None]
    ref = flash_decode_plain(q.float(), kf, vf, pos, **opts)
    return ref, flash_decode_plain(q.float(), kf, vf.abs(), pos, **opts)


def check_attn(got, q, k, v, pos, ks=None, vs=None, what="", **opts):
    """Kernel D or E against the plain version on f32 copies, per element
    within FLASH_RTOL |ref| + ATTN_VTOL sum_j P_j |v_j| + FLASH_ATOL, and
    finite; returns the max abs err."""
    ref, mag = f32_plain(q, k, v, pos, ks, vs, **opts)
    got = got.float()
    excess = ((got - ref).abs() - FLASH_RTOL * ref.abs() - ATTN_VTOL * mag - FLASH_ATOL).max()
    assert torch.isfinite(got).all() and excess.item() <= 0, (what, excess.item())
    return (got - ref).abs().max().item()


def check_attn_pair(a, b, q, k, v, pos, ks=None, vs=None, what="", **opts):
    """D and E on the same rows: each within its tolerance of the plain
    version, so within twice both of each other (2 FLASH_RTOL |b| +
    ATTN_VTOL sum_j P_j |v_j| + 2 FLASH_ATOL). A row of E's 64-row block
    and the same row through D's split need not share bits."""
    _, mag = f32_plain(q, k, v, pos, ks, vs, **opts)
    a, b = a.float(), b.float()
    excess = ((a - b).abs() - 2 * FLASH_RTOL * b.abs() - ATTN_VTOL * mag - 2 * FLASH_ATOL).max()
    assert excess.item() <= 0, (what, excess.item())


def sdpa_causal(q, k, v):
    """The library call for a prefill from position 0 (timed only)."""
    out = torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k, v, is_causal=True, enable_gqa=True)
    return out.transpose(1, 2)


def phase_flash_prefill(dev):
    from llm_inference_lab_tpu_torch.ops.flash_decode import flash_decode, flash_decode_plain
    from llm_inference_lab_tpu_torch.ops.flash_prefill import flash_prefill

    g = torch.Generator(device=dev).manual_seed(4)
    max_err = 0.0
    for S in (64, 160, 512):
        for D, (H, KVH) in GEOMS.items():
            # Sequence 0 prefills from position 0, sequence 1 is a chunk
            # resuming at 128; row 0 of sequence 1 is dead. T is the last
            # position rounded up to 32, or 1024.
            q, k, v, _ = flash_inputs(g, dev, 2, S, H, KVH, 1024, D, 0)
            k, v = k[0], v[0]
            ar = torch.arange(S, device=dev, dtype=torch.int32)
            pos = torch.stack([ar, 128 + ar]).contiguous()
            v[0, :, S:] = POISON
            v[1, :, 128 + S:] = POISON
            pos[1, 0] = -1
            outs = {}
            for T in (128 + S + 3, 1024):  # T just past the positions (not a tile multiple)
                outs[T] = flash_prefill(q, k[:, :, :T], v[:, :, :T], pos)
                err = check_attn(outs[T], q, k, v, pos, what=("flash_prefill", S, D, T))
                max_err = max(max_err, err)
                assert torch.all(outs[T][1, 0] == 0), (S, D, T, "dead row not zero")
            small, full = outs.values()
            assert torch.equal(small, full), (S, D, "depends on T past the positions")
            # A chunk of the rows equals the same rows of the whole call.
            c0, c1 = S // 3, S // 3 + 40
            chunk = flash_prefill(q[:, c0:c1].contiguous(), k, v, pos[:, c0:c1].contiguous())
            assert torch.equal(chunk, full[:, c0:c1]), (S, D, "chunk != the same rows of the whole")
            # A row alone equals the row inside its block; flash_decode on it
            # is within both kernels' tolerances.
            for j in (1, S // 2 + 3, S - 1):
                qj, pj = q[:, j:j + 1].contiguous(), pos[:, j:j + 1].contiguous()
                assert torch.equal(flash_prefill(qj, k, v, pj), full[:, j:j + 1]), (S, D, j)
                check_attn_pair(flash_decode(qj, k, v, pj), full[:, j:j + 1], qj, k, v, pj,
                                what=("flash_decode vs flash_prefill", S, D, j))
            log(f"flash_prefill S={S} D={D}: max_abs_err {err:.3g}; T-independent, "
                f"chunk- and row-independent (bits), flash_decode per row within tolerance "
                f"(dead row zero)")
    # The B=1 main path's prompt prefill (S=160 at T=256), which E took over
    # from D: E beside D on the same inputs (per request, not in the wave).
    for D, (H, KVH) in GEOMS.items():
        L = 2 * L2_BYTES // (2 * KVH * T_MAIN * D * 2) + 1
        q, k, v, pos = flash_inputs(g, dev, 1, 160, H, KVH, T_MAIN, D, 159, L=L)
        cyc = Cycle(L)
        ms = median_ms(lambda: flash_prefill(q, k[cyc()], v[cyc.i], pos))
        ms_d = median_ms(lambda: flash_decode(q, k[cyc()], v[cyc.i], pos))
        lib = median_ms(lambda: sdpa_causal(q, k[cyc()][:, :, :160], v[cyc.i][:, :, :160]),
                        iters=10)
        b, by = bound_ms(2 * 2 * KVH * 160 * D + 2 * 2 * 160 * H * D + 4 * 160,
                         4 * H * 160 * 161 // 2 * D)
        log(f"flash_prefill main-path prefill S=160 T={T_MAIN} D={D}: {ms:.4f} ms  "
            f"flash_decode {ms_d:.4f}  library {lib:.4f} (SDPA causal)  bound {b:.5f} ({by})")
        del k, v
    # Timing at admission prefills: G prompts of P = 256 positions into a
    # [G, KVH, 256, D] scratch. One wave = 28 3B layers and 16 1B layers.
    P = 256
    per = {}
    for G in (1, 4):
        for D, (H, KVH) in GEOMS.items():
            L = 2 * L2_BYTES // (2 * G * KVH * P * D * 2) + 1
            q = torch.randn((G, P, H, D), generator=g, device=dev).bfloat16()
            k = torch.randn((L, G, KVH, P, D), generator=g, device=dev).bfloat16()
            v = torch.randn((L, G, KVH, P, D), generator=g, device=dev).bfloat16()
            pos = torch.arange(P, device=dev, dtype=torch.int32)[None].repeat(G, 1).contiguous()
            cyc = Cycle(L)
            ms = median_ms(lambda: flash_prefill(q, k[cyc()], v[cyc.i], pos))
            plain = median_ms(lambda: flash_decode_plain(q, k[cyc()], v[cyc.i], pos), iters=10)
            lib = median_ms(lambda: sdpa_causal(q, k[cyc()], v[cyc.i]), iters=10)
            seen = G * H * P * (P + 1) // 2  # (query row, key) pairs the mask keeps
            b, by = bound_ms(2 * 2 * G * P * H * D + 2 * 2 * G * KVH * P * D + 4 * G * P,
                             4 * seen * D)
            per[(G, D)] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b, bound_by=by)
            log(f"flash_prefill G={G} P={P} D={D}: {ms:.4f} ms  plain {plain:.4f}  "
                f"library {lib:.4f} (SDPA causal)  bound {b:.5f} ({by})")
            del k, v
    agg = {key: sum(per[(4, D)][key] * LAYERS[D] for D in GEOMS)
           for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    agg["bound_by"] = per[(4, 128)]["bound_by"]
    agg["max_abs_err"] = max_err
    return agg


def paged_inputs(g, dev, B, S, H, KVH, D, P, last, L=1):
    """q [B, S, H, D]; contiguous K/V [L, B, KVH, 1024, D] with V past each
    sequence's last position set to POISON; the same keys in page pools
    [L, N, KVH, P, D] through one shuffled table [B, M] (page 0 unused);
    positions [B, S] ending at last[b]."""
    M = SERVE_MAX_LEN // P
    N = B * M + 1
    q = torch.randn((B, S, H, D), generator=g, device=dev).bfloat16()
    kc = torch.randn((L, B, KVH, M * P, D), generator=g, device=dev).bfloat16()
    vc = torch.randn((L, B, KVH, M * P, D), generator=g, device=dev).bfloat16()
    for b in range(B):
        vc[:, b, :, last[b] + 1:] = POISON
    table = (torch.randperm(N - 1, generator=g, device=dev)[: B * M] + 1).reshape(B, M)
    table = table.to(torch.int32).contiguous()
    kp = torch.zeros((L, N, KVH, P, D), device=dev, dtype=torch.bfloat16)
    vp = torch.zeros_like(kp)
    for src, dst in ((kc, kp), (vc, vp)):
        dst[:, table.flatten().long()] = (src.reshape(L, B, KVH, M, P, D).transpose(2, 3)
                                          .reshape(L, B * M, KVH, P, D))
    pos = torch.tensor(last, device=dev, dtype=torch.int32)[:, None] - S + 1
    pos = (pos + torch.arange(S, device=dev, dtype=torch.int32)[None]).contiguous()
    return q, kc, vc, kp, vp, table, pos


def phase_paged_flash(dev):
    from llm_inference_lab_tpu_torch.models.paged import gather_pages
    from llm_inference_lab_tpu_torch.ops.flash_decode import flash_decode
    from llm_inference_lab_tpu_torch.ops.paged_flash import paged_flash, paged_flash_plain

    g = torch.Generator(device=dev).manual_seed(5)
    B, max_err = 8, 0.0
    for S in (1, 2, 5):
        for D, (H, KVH) in GEOMS.items():
            for P in (16, 64):
                last = torch.randint(S, 1001, (B,), generator=g, device=dev).tolist()
                q, kc, vc, kp, vp, table, pos = paged_inputs(g, dev, B, S, H, KVH, D, P, last)
                kc, vc, kp, vp = kc[0], vc[0], kp[0], vp[0]
                assert torch.equal(gather_pages(kp, table), kc)
                pos[1, 0] = -1
                got = paged_flash(q, kp, vp, pos, table)
                err = check_attn(got, q, kc, vc, pos, what=("paged_flash", S, D, P))
                max_err = max(max_err, err)
                assert torch.all(got[1, 0] == 0), (S, D, P, "dead row not zero")
                assert torch.equal(flash_decode(q, kc, vc, pos), got), (S, D, P, "D != F")
                log(f"paged_flash B={B} S={S} D={D} P={P} (last positions up to {max(last)}): "
                    f"max_abs_err {err:.3g}; flash_decode's bits on the gathered keys (dead row "
                    f"zero)")
    # Timing at the serving step's shapes: 8 slots at positions near 250,
    # 64-row pages, 1024 positions a sequence: the draft (S=1, D=64) and
    # verify (S=2, D=128) calls of one K=1 step.
    agg = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, bound_by="bytes",
               max_abs_err=max_err)
    last = [246 + b for b in range(B)]
    for S, D in ((1, 64), (2, 128)):
        H, KVH = GEOMS[D]
        M = SERVE_MAX_LEN // SERVE_PAGE
        L = 2 * L2_BYTES // (2 * (B * M + 1) * KVH * SERVE_PAGE * D * 2) + 1
        q, _, _, kp, vp, table, pos = paged_inputs(g, dev, B, S, H, KVH, D, SERVE_PAGE, last, L=L)
        cyc = Cycle(L)
        ms = median_ms(lambda: paged_flash(q, kp[cyc()], vp[cyc.i], pos, table))
        plain = median_ms(lambda: paged_flash_plain(q, kp[cyc()], vp[cyc.i], pos, table),
                          iters=10)
        lib = median_ms(lambda: sdpa(q, gather_pages(kp[cyc()], table),
                                     gather_pages(vp[cyc.i], table), pos), iters=10)
        keys = sum(p + 1 for p in last)  # keys the positions reach, over the sequences
        seen = sum(p - S + 2 + i for p in last for i in range(S)) * H
        b, by = bound_ms(2 * KVH * keys * D * 2 + 2 * 2 * B * S * H * D + 4 * B * S
                         + 4 * table.numel(), 4 * seen * D)
        log(f"paged_flash B={B} S={S} D={D} P={SERVE_PAGE} p~250: {ms:.4f} ms  plain "
            f"{plain:.4f}  library {lib:.4f} (gather + SDPA)  bound {b:.5f} ({by})")
        for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib), ("bound_ms", b)):
            agg[key] += LAYERS[D] * val
        del kp, vp
    return agg


# ---------------------------------------------------------------- int8 kernels
def phase_quant_matmul_int8(dev):
    """Kernel B: the decode body at every projection of the int8 path
    (qmm_decode), timed at QMM8_TIME_M, with the K=4 B=1 and 8-slot serving
    step sums; then the tensor-core path at every width's prefill shapes
    (qmm_prefill). Returns (one K=4 B=1 step's numbers, one admission
    wave's: 8 prompts of 256 rows through the 3B's 28 and the 1B's 16
    layers, one ngram K=12 step's: 28 3B layers at M = 13)."""
    g = torch.Generator(device=dev).manual_seed(11)
    rows, max_err = qmm_decode(dev, 8, g, {"3B": (QMM_3B, QMM8_TIME_M + (QMM8_NGRAM_M,)),
                                            "1B": (QMM_1B, QMM8_TIME_M)})
    # One K=4 decode step at B=1: 4 draft forwards of 16 1B layers at M=1,
    # one verify of 28 3B layers at M=5.
    step = [(QMM_1B, 1, 4 * 16), (QMM_3B, 5, 28)]
    log_step("quant_matmul_int8", "one K=4 B=1 step (M = 1 draft, 5 verify)", rows, step)
    log_step("quant_matmul_int8", "one 8-slot K=4 serving step (M = 8 draft, 40 verify)", rows,
             [(QMM_1B, 8, 4 * 16), (QMM_3B, 40, 28)])
    pre, pre_err, across = qmm_prefill(dev, 8, g)
    log(f"quant_matmul_int8: {across} rows differ between the decode body and the "
        f"tensor-core path over {sum(map(len, QMM_WIDTHS.values()))} shapes")
    wave = [(k, n, 2048, 28) for k, n in QMM_3B] + [(k, n, 2048, 16) for k, n in QMM_1B]
    ngram = [(QMM_3B, QMM8_NGRAM_M, 28)]
    log_step("quant_matmul_int8", f"one ngram K={NGRAM_K} B=1 step (28 verify layers at M = "
             f"{QMM8_NGRAM_M})", rows, ngram)
    return (sum_rows(rows, calls(step), max_err), sum_rows(pre, wave, pre_err),
            sum_rows(rows, calls(ngram), max_err))


def int8_kv(g, dev, shape, last=None):
    """N(0, 1) rows quantized per row (int8 values, f32 scales) of shape
    [.., B, KVH, T, D]; with `last` (one position per sequence of axis -4),
    keys past it are int8 POISON in values and scales."""
    from llm_inference_lab_tpu_torch.models.base import quantize_rows

    vals, scales = quantize_rows(torch.randn(shape, generator=g, device=dev))
    for b, p in enumerate(last or []):
        vals[..., b, :, p + 1:, :] = POISON_BYTE
        scales[..., b, :, p + 1:] = POISON_SCALE
    return vals, scales


def sdpa_int8(q, k, v, ks, vs, pos, causal=False):
    """The library yardstick for an int8 cache (timed only, never used):
    dequantize to bf16, then SDPA with the position mask (or causal)."""
    kd = (k.float() * ks[..., None]).to(q.dtype)
    vd = (v.float() * vs[..., None]).to(q.dtype)
    return sdpa_causal(q, kd, vd) if causal else sdpa(q, kd, vd, pos)


def attn_bound(S, H, KVH, D, keys, seen, extra_bytes=0):
    """Bytes: int8 K and V up to the last positions plus 8 bytes of scales a
    key, q and out bf16, positions and extra_bytes; operations: 4 D per
    (query row, visible key)."""
    kv = 2 * KVH * keys * D + 8 * KVH * keys
    return bound_ms(kv + 2 * 2 * S * H * D + 4 * S + extra_bytes, 4 * seen * D)


def phase_flash_decode_int8(dev):
    """D-int8: checks at S = 1, 5 (draft, verify), D = 64, 128, T = 256 and
    4096; times at the int8 B=1 path's shapes beside D-bf16 on the same
    positions."""
    from llm_inference_lab_tpu_torch.ops.flash_decode import (
        flash_decode,
        flash_decode_int8,
        flash_decode_plain,
    )

    g = torch.Generator(device=dev).manual_seed(12)
    max_err = 0.0
    for S in (1, 5):
        for D, (H, KVH) in GEOMS.items():
            for T in (256, 4096):
                p_last = T - 57  # 8 keys into a 32-key tile
                q = torch.randn((2, S, H, D), generator=g, device=dev).bfloat16()
                k, ks = int8_kv(g, dev, (2, KVH, T, D), [p_last] * 2)
                v, vs = int8_kv(g, dev, (2, KVH, T, D), [p_last] * 2)
                pos = (p_last - S + 1 + torch.arange(S, device=dev, dtype=torch.int32))[None]
                pos = pos.repeat(2, 1).contiguous()
                pos[1, 0] = -1
                got = flash_decode_int8(q, k, v, pos, ks, vs)
                err = check_attn(got, q, k, v, pos, ks, vs, what=("flash_decode_int8", S, D, T))
                assert torch.all(got[1, 0] == 0), (S, D, T, "dead row not zero")
                if S == 5:
                    one = flash_decode_int8(q[:, :1].contiguous(), k, v, pos[:, :1].contiguous(),
                                            ks, vs)
                    assert torch.equal(one, got[:, :1]), (D, T, "S-dependent rounding")
                max_err = max(max_err, err)
                log(f"flash_decode_int8 S={S} D={D} T={T}: max_abs_err {err:.3g} (dead row zero)")
    agg = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, bound_by="bytes",
               max_abs_err=max_err)
    for S, D, n in ((1, 64, 4 * 16), (5, 128, 28)):
        H, KVH = GEOMS[D]
        L = 2 * L2_BYTES // (2 * KVH * T_MAIN * D) + 1
        q = torch.randn((1, S, H, D), generator=g, device=dev).bfloat16()
        k, ks = int8_kv(g, dev, (L, 1, KVH, T_MAIN, D))
        v, vs = int8_kv(g, dev, (L, 1, KVH, T_MAIN, D))
        nb = 2 * L2_BYTES // (4 * KVH * T_MAIN * D) + 1  # bf16 copies, twice the L2 too
        kb, vb = k[:nb].bfloat16(), v[:nb].bfloat16()
        pos = (P_MAIN - S + 1 + torch.arange(S, device=dev, dtype=torch.int32))[None].contiguous()
        cyc, cyb = Cycle(L), Cycle(nb)
        ms = median_ms(lambda: flash_decode_int8(q, k[cyc()], v[cyc.i], pos, ks[cyc.i], vs[cyc.i]))
        bf16 = median_ms(lambda: flash_decode(q, kb[cyb()], vb[cyb.i], pos))
        plain = median_ms(lambda: flash_decode_plain(q, k[cyc()], v[cyc.i], pos, ks[cyc.i],
                                                     vs[cyc.i]), iters=10)
        lib = median_ms(lambda: sdpa_int8(q, k[cyc()], v[cyc.i], ks[cyc.i], vs[cyc.i], pos),
                        iters=10)
        seen = H * sum(P_MAIN - S + 2 + i for i in range(S))
        b, by = attn_bound(S, H, KVH, D, P_MAIN + 1, seen)
        log(f"flash_decode_int8 S={S} D={D} T={T_MAIN} p={P_MAIN}: {ms:.4f} ms  (bf16 kernel "
            f"{bf16:.4f})  plain {plain:.4f}  library {lib:.4f} (dequant + SDPA)  "
            f"bound {b:.5f} ({by})")
        for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib), ("bound_ms", b)):
            agg[key] += n * val
        del k, v, kb, vb
    return agg


def phase_flash_prefill_int8(dev):
    """E-int8: checks at S = 64, 160, 512 (a chunk resuming at 128, a dead
    row, T cut and full, row by row equal to D-int8); times at the int8 B=1
    prompt prefill and an admission wave, beside E-bf16."""
    from llm_inference_lab_tpu_torch.ops.flash_decode import flash_decode_int8, flash_decode_plain
    from llm_inference_lab_tpu_torch.ops.flash_prefill import flash_prefill, flash_prefill_int8

    g = torch.Generator(device=dev).manual_seed(13)
    max_err = 0.0
    for S in (64, 160, 512):
        for D, (H, KVH) in GEOMS.items():
            q = torch.randn((2, S, H, D), generator=g, device=dev).bfloat16()
            last = [S - 1, 128 + S - 1]
            k, ks = int8_kv(g, dev, (2, KVH, 1024, D), last)
            v, vs = int8_kv(g, dev, (2, KVH, 1024, D), last)
            ar = torch.arange(S, device=dev, dtype=torch.int32)
            pos = torch.stack([ar, 128 + ar]).contiguous()
            pos[1, 0] = -1
            outs = {}
            for T in (128 + S + 3, 1024):
                outs[T] = flash_prefill_int8(q, k[:, :, :T], v[:, :, :T], pos, ks[:, :, :T],
                                             vs[:, :, :T])
                err = check_attn(outs[T], q, k, v, pos, ks, vs,
                                 what=("flash_prefill_int8", S, D, T))
                max_err = max(max_err, err)
                assert torch.all(outs[T][1, 0] == 0), (S, D, T, "dead row not zero")
            small, full = outs.values()
            assert torch.equal(small, full), (S, D, "depends on T past the positions")
            for j in (1, S // 2 + 3, S - 1):
                qj, pj = q[:, j:j + 1].contiguous(), pos[:, j:j + 1].contiguous()
                assert torch.equal(flash_prefill_int8(qj, k, v, pj, ks, vs), full[:, j:j + 1])
                check_attn_pair(flash_decode_int8(qj, k, v, pj, ks, vs), full[:, j:j + 1], qj, k,
                                v, pj, ks, vs, what=("D-int8 vs E-int8", S, D, j))
            log(f"flash_prefill_int8 S={S} D={D}: max_abs_err {err:.3g}; T-independent, "
                f"row-independent (bits), flash_decode_int8 per row within tolerance (dead row "
                f"zero)")
    per = {}
    for G, P, T in ((1, 160, T_MAIN), (4, 256, 256)):  # B=1 prompt prefill; admission wave
        for D, (H, KVH) in GEOMS.items():
            L = 2 * L2_BYTES // (2 * G * KVH * T * D) + 1
            q = torch.randn((G, P, H, D), generator=g, device=dev).bfloat16()
            k, ks = int8_kv(g, dev, (L, G, KVH, T, D))
            v, vs = int8_kv(g, dev, (L, G, KVH, T, D))
            nb = 2 * L2_BYTES // (4 * G * KVH * T * D) + 1
            kb, vb = k[:nb].bfloat16(), v[:nb].bfloat16()
            pos = torch.arange(P, device=dev, dtype=torch.int32)[None].repeat(G, 1).contiguous()
            cyc, cyb = Cycle(L), Cycle(nb)
            ms = median_ms(lambda: flash_prefill_int8(q, k[cyc()], v[cyc.i], pos, ks[cyc.i],
                                                      vs[cyc.i]))
            bf16 = median_ms(lambda: flash_prefill(q, kb[cyb()], vb[cyb.i], pos))
            plain = median_ms(lambda: flash_decode_plain(q, k[cyc()], v[cyc.i], pos, ks[cyc.i],
                                                         vs[cyc.i]), iters=10)
            lib = median_ms(lambda: sdpa_int8(q, k[cyc()][:, :, :P], v[cyc.i][:, :, :P],
                                              ks[cyc.i][:, :, :P], vs[cyc.i][:, :, :P], pos,
                                              causal=True), iters=10)
            b, by = attn_bound(G * P, H, KVH, D, G * P, G * H * P * (P + 1) // 2)
            per[(G, D)] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b, bound_by=by)
            log(f"flash_prefill_int8 G={G} P={P} T={T} D={D}: {ms:.4f} ms  (bf16 kernel "
                f"{bf16:.4f})  plain {plain:.4f}  library {lib:.4f} (dequant + SDPA causal)  "
                f"bound {b:.5f} ({by})")
            del k, v, kb, vb
    agg = {key: sum(per[(4, D)][key] * LAYERS[D] for D in GEOMS)
           for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    agg["bound_by"] = per[(4, 128)]["bound_by"]
    agg["max_abs_err"] = max_err
    return agg


def paged_int8_inputs(g, dev, B, S, H, KVH, D, P, last, max_len, L=1):
    """The int8 counterpart of paged_inputs: contiguous int8 K/V and scales
    [L, B, KVH, max_len(, D)] with POISON past each last position, the same
    keys and scales in pools [L, N, KVH, P(, D)] through one shuffled table
    [B, M] (page 0 unused), positions [B, S] ending at last[b]."""
    M = max_len // P
    N = B * M + 1
    q = torch.randn((B, S, H, D), generator=g, device=dev).bfloat16()
    kc, ksc = int8_kv(g, dev, (L, B, KVH, M * P, D), last)
    vc, vsc = int8_kv(g, dev, (L, B, KVH, M * P, D), last)
    table = (torch.randperm(N - 1, generator=g, device=dev)[: B * M] + 1).reshape(B, M)
    table = table.to(torch.int32).contiguous()

    def pool(src):
        tail = src.shape[4:]
        dst = torch.zeros((L, N, KVH, P, *tail), device=dev, dtype=src.dtype)
        dst[:, table.flatten().long()] = (src.reshape(L, B, KVH, M, P, *tail).transpose(2, 3)
                                          .reshape(L, B * M, KVH, P, *tail))
        return dst

    pos = torch.tensor(last, device=dev, dtype=torch.int32)[:, None] - S + 1
    pos = (pos + torch.arange(S, device=dev, dtype=torch.int32)[None]).contiguous()
    return q, (kc, vc, ksc, vsc), tuple(pool(t) for t in (kc, vc, ksc, vsc)), table, pos


def phase_paged_flash_int8(dev):
    """F-int8: checks at B=8, S = 1, 5, D = 64, 128, P = 16, 64, positions up
    to 1000, D-int8 on the gathered keys and scales within tolerance; times at
    the int8 serving step's shapes beside F-bf16 on the same positions."""
    from llm_inference_lab_tpu_torch.models.paged import gather_pages
    from llm_inference_lab_tpu_torch.ops.flash_decode import flash_decode_int8
    from llm_inference_lab_tpu_torch.ops.paged_flash import (
        paged_flash,
        paged_flash_int8,
        paged_flash_plain,
    )

    g = torch.Generator(device=dev).manual_seed(14)
    B, max_err = 8, 0.0
    for S in (1, 5):
        for D, (H, KVH) in GEOMS.items():
            for P in (16, 64):
                last = torch.randint(S, 1001, (B,), generator=g, device=dev).tolist()
                q, cont, pools, table, pos = paged_int8_inputs(g, dev, B, S, H, KVH, D, P, last,
                                                               SERVE_MAX_LEN)
                cont, pools = [t[0] for t in cont], [t[0] for t in pools]
                assert torch.equal(gather_pages(pools[2], table), cont[2])
                pos[1, 0] = -1
                got = paged_flash_int8(q, pools[0], pools[1], pos, table, pools[2], pools[3])
                err = check_attn(got, q, *cont[:2], pos, *cont[2:],
                                 what=("paged_flash_int8", S, D, P))
                max_err = max(max_err, err)
                assert torch.all(got[1, 0] == 0), (S, D, P, "dead row not zero")
                assert torch.equal(flash_decode_int8(q, cont[0], cont[1], pos, cont[2], cont[3]),
                                   got), (S, D, P, "D-int8 != F-int8")
                log(f"paged_flash_int8 B={B} S={S} D={D} P={P} (last positions up to "
                    f"{max(last)}): max_abs_err {err:.3g}; flash_decode_int8's bits on the "
                    f"gathered keys and scales (dead row zero)")
    agg = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, bound_by="bytes",
               max_abs_err=max_err)
    last = [246 + b for b in range(B)]
    M = INT8_MAX_LEN // SERVE_PAGE
    for S, D, n in ((1, 64, 4 * 16), (5, 128, 28)):
        H, KVH = GEOMS[D]
        L = 2 * L2_BYTES // (2 * (B * M + 1) * KVH * SERVE_PAGE * D) + 1
        q, _, (kp, vp, ksp, vsp), table, pos = paged_int8_inputs(
            g, dev, B, S, H, KVH, D, SERVE_PAGE, last, INT8_MAX_LEN, L=L)
        nb = L // 2 + 1
        kb, vb = kp[:nb].bfloat16(), vp[:nb].bfloat16()
        cyc, cyb = Cycle(L), Cycle(nb)
        ms = median_ms(lambda: paged_flash_int8(q, kp[cyc()], vp[cyc.i], pos, table, ksp[cyc.i],
                                                vsp[cyc.i]))
        bf16 = median_ms(lambda: paged_flash(q, kb[cyb()], vb[cyb.i], pos, table))
        plain = median_ms(lambda: paged_flash_plain(q, kp[cyc()], vp[cyc.i], pos, table,
                                                    ksp[cyc.i], vsp[cyc.i]), iters=10)
        lib = median_ms(lambda: sdpa_int8(
            q, gather_pages(kp[cyc()], table), gather_pages(vp[cyc.i], table),
            gather_pages(ksp[cyc.i], table), gather_pages(vsp[cyc.i], table), pos), iters=10)
        keys = sum(p + 1 for p in last)
        seen = sum(p - S + 2 + i for p in last for i in range(S)) * H
        b, by = attn_bound(B * S, H, KVH, D, keys, seen, extra_bytes=4 * table.numel())
        log(f"paged_flash_int8 B={B} S={S} D={D} P={SERVE_PAGE} p~250: {ms:.4f} ms  (bf16 "
            f"kernel {bf16:.4f})  plain {plain:.4f}  library {lib:.4f} (gather + dequant + "
            f"SDPA)  bound {b:.5f} ({by})")
        for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib), ("bound_ms", b)):
            agg[key] += n * val
        del kp, vp, kb, vb
    return agg


# ------------------------------------------------------- Gemma-2 attention
def gemma_keys(g, dev, cache, B, KVH, T, pos, window, D=256):
    """K, V [B, KVH, T, D] (bf16, or int8 with f32 scales) of N(0, 1)
    rows, with POISON at the keys no live row of a sequence sees: past its
    largest position and, with a window, at or below its smallest position
    minus the window. POISON is in K and V (bf16: POISON in every element;
    int8: POISON_BYTE at POISON_SCALE), so a masked key let in takes over
    its row's softmax (its score reaches the softcap) and its output."""
    from llm_inference_lab_tpu_torch.models.base import quantize_rows

    k = torch.randn((B, KVH, T, D), generator=g, device=dev)
    v = torch.randn((B, KVH, T, D), generator=g, device=dev)
    unseen = torch.zeros((B, KVH, T), dtype=torch.bool, device=dev)
    for b in range(B):
        live = pos[b][pos[b] >= 0]
        unseen[b, :, int(live.max()) + 1:] = True
        if window:
            unseen[b, :, : max(int(live.min()) - window + 1, 0)] = True
    if cache == "int8":
        (k, ks), (v, vs) = quantize_rows(k), quantize_rows(v)
        for t, st in ((k, ks), (v, vs)):
            t[unseen] = POISON_BYTE
            st[unseen] = POISON_SCALE
        return k, v, ks, vs
    k[unseen] = POISON
    v[unseen] = POISON
    return k.bfloat16(), v.bfloat16(), None, None


def to_pages(g, dev, tensors, P):
    """The same keys (and scales) [B, KVH, T(, D)] in shuffled P-row pages
    [B * M + 1, KVH, P(, D)] (page 0 unused) through a table [B, M]."""
    B, KVH, T = tensors[0].shape[:3]
    M = T // P
    table = (torch.randperm(B * M, generator=g, device=dev) + 1).reshape(B, M)
    table = table.to(torch.int32).contiguous()
    pools = []
    for src in tensors:
        tail = src.shape[3:]
        dst = torch.zeros((B * M + 1, KVH, P, *tail), device=dev, dtype=src.dtype)
        dst[table.flatten().long()] = (src.reshape(B, KVH, M, P, *tail).transpose(1, 2)
                                       .reshape(B * M, KVH, P, *tail))
        pools.append(dst)
    return pools, table


def seen_keys(pos, window):
    """(keys from the lowest first visible key to the largest position, per
    sequence, summed; (row, key) pairs the mask keeps) for positions [B, S]."""
    keys = pairs = 0
    for row in pos.tolist():
        live = [p for p in row if p >= 0]
        lo = max(min(live) - window + 1, 0) if window else 0
        keys += max(live) - lo + 1
        pairs += sum(min(p + 1, window) if window else p + 1 for p in live)
    return keys, pairs


def sdpa_masked(q, k, v, pos, window):
    """The library yardstick for Gemma-2's attention (timed only, never
    used): SDPA with the position and window mask as a boolean mask. It
    computes less than the kernels: no softcap."""
    T = k.shape[2]
    kv = torch.arange(T, device=q.device)[None, None, None, :]
    p = pos[:, None, :, None]
    mask = (kv <= p) & (kv > p - window) if window else kv <= p
    out = torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k, v, attn_mask=mask, scale=GEMMA_OPTS["scale"], enable_gqa=True)
    return out.transpose(1, 2)


def phase_gemma_attention(dev):
    """D, E and F at head dim 256 with Gemma-2's options. Checks: both
    geometries, bf16 and int8 caches, window 4096 (a local layer) and none
    (a global one), T = 4608: decode rows (S = 1, 2) of four sequences
    ending at 4096 (the window cuts key 0), 4200, 4607 and 300, one row
    dead; prefill rows (S = 160) at 4000..4159 (crossing 4096) and
    4448..4607 with a dead row. Each within check_attn's tolerance of its
    plain version on f32 q, finite, dead rows zero; E vs D on the decode
    rows and D vs E on single prefill rows within both tolerances
    (check_attn_pair); F (shuffled 64-row pages) gives D's bits on the
    decode rows; E's single prefill rows equal its block's bits.
    Times (bf16): D at the long-prompt decode step, E at the long prompt's
    prefill, F at the Gemma-2 serving step."""
    from llm_inference_lab_tpu_torch.models.paged import gather_pages
    from llm_inference_lab_tpu_torch.ops.flash_decode import (
        flash_decode,
        flash_decode_int8,
        flash_decode_plain,
    )
    from llm_inference_lab_tpu_torch.ops.flash_prefill import flash_prefill, flash_prefill_int8
    from llm_inference_lab_tpu_torch.ops.paged_flash import (
        paged_flash,
        paged_flash_int8,
        paged_flash_plain,
    )

    g = torch.Generator(device=dev).manual_seed(21)
    kernels = {"bf16": (flash_decode, flash_prefill, paged_flash),
               "int8": (flash_decode_int8, flash_prefill_int8, paged_flash_int8)}
    errs = {"flash_decode": 0.0, "flash_prefill": 0.0, "paged_flash": 0.0}
    T = 4608
    for H, KVH, _ in GEMMA_GEOMS.values():
        for cache, (dk, ek, fk) in kernels.items():
            for window in (GEMMA_WINDOW, None):
                opts = dict(GEMMA_OPTS, window=window)
                what = f"H={H} KVH={KVH} {cache} window={window}"
                for S, last in ((1, (4096, 4200, 4607, 300)), (2, (4096, 4200, 4607, 300)),
                                (160, (4159, 4607))):
                    B = len(last)
                    pos = (torch.tensor(last, device=dev, dtype=torch.int32)[:, None] - S + 1
                           + torch.arange(S, device=dev, dtype=torch.int32)[None]).contiguous()
                    if S > 1:
                        pos[-1, 0] = -1
                    k, v, ks, vs = gemma_keys(g, dev, cache, B, KVH, T, pos, window)
                    q = torch.randn((B, S, H, 256), generator=g, device=dev).bfloat16()
                    sc = (ks, vs) if cache == "int8" else ()
                    got = (dk if S <= 32 else ek)(q, k, v, pos, *sc, **opts)
                    name = "flash_decode" if S <= 32 else "flash_prefill"
                    errs[name] = max(errs[name], check_attn(got, q, k, v, pos, *sc,
                                                            what=(name, what, S), **opts))
                    if S > 1:
                        assert torch.all(got[-1, 0] == 0), (what, S, "dead row not zero")
                    if S <= 32:
                        check_attn_pair(ek(q, k, v, pos, *sc, **opts), got, q, k, v, pos, *sc,
                                        what=(what, S, "E vs D"), **opts)
                        pools, table = to_pages(g, dev, (k, v, *sc), SERVE_PAGE)
                        paged = fk(q, pools[0], pools[1], pos, table, *pools[2:], **opts)
                        assert torch.equal(got, paged), (what, S, "D != F")
                        errs["paged_flash"] = max(errs["paged_flash"], check_attn(
                            paged, q, k, v, pos, *sc, what=("F", what, S), **opts))
                        del pools
                    else:
                        for j in (0, 95, 96, 159):  # row 96 of sequence 0 is at 4096
                            qj, pj = q[:, j:j + 1].contiguous(), pos[:, j:j + 1].contiguous()
                            assert torch.equal(ek(qj, k, v, pj, *sc, **opts), got[:, j:j + 1]), \
                                (what, j, "E alone != E on a prefill row")
                            check_attn_pair(dk(qj, k, v, pj, *sc, **opts), got[:, j:j + 1], qj, k,
                                            v, pj, *sc, what=(what, j, "D vs E"), **opts)
                    del k, v
                log(f"gemma-2 attention D=256 {what}: D (S=1, 2), E (S=160) and F within "
                    f"tolerance of their plain versions with POISON outside every row's keys; "
                    f"E vs D, F vs D, D vs E per prefill row within both tolerances; E's rows "
                    f"alone == in the block; dead rows zero")
    timed = {name: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, bound_by="bytes",
                        max_abs_err=err) for name, err in errs.items()}

    def add(name, n, ms, plain, lib, b, by, what):
        log(f"{name} gemma-2 {what}: {ms:.4f} ms  plain {plain:.4f}  library {lib:.4f} "
            f"(SDPA + mask, no softcap)  bound {b:.5f} ({by})")
        agg = timed[name]
        for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib), ("bound_ms", b)):
            agg[key] += n * val
        if by == "operations":
            agg["bound_by"] = by

    # D at the long-prompt decode step (p = P_LONG, T = T_LONG): the 2B
    # draft's S=1 and the 9B verify's S=2, on local and global layers; E at
    # the long prompt's prefill (S = 4320 from position 0, T = T_LONG).
    for (H, KVH, layers), S in zip(GEMMA_GEOMS.values(), (2, 1)):
        for window in (GEMMA_WINDOW, None):
            opts = dict(GEMMA_OPTS, window=window)
            L = 2 * L2_BYTES // (2 * KVH * T_LONG * 256 * 2) + 1
            for Sq, p_last, name in ((S, P_LONG, "flash_decode"), (4320, 4319, "flash_prefill")):
                q, k, v, pos = flash_inputs(g, dev, 1, Sq, H, KVH, T_LONG, 256, p_last, L=L)
                fn = flash_decode if name == "flash_decode" else flash_prefill
                cyc = Cycle(L)
                ms = median_ms(lambda: fn(q, k[cyc()], v[cyc.i], pos, **opts),
                               iters=25 if Sq <= 32 else 5, warmup=3 if Sq <= 32 else 1)
                plain = median_ms(lambda: flash_decode_plain(q, k[cyc()], v[cyc.i], pos, **opts),
                                  iters=10 if Sq <= 32 else 3, warmup=1)
                lib = median_ms(lambda: sdpa_masked(q, k[cyc()], v[cyc.i], pos, window),
                                iters=10 if Sq <= 32 else 3, warmup=1)
                keys, pairs = seen_keys(pos, window)
                b, by = bound_ms(2 * KVH * keys * 256 * 2 + 2 * 2 * Sq * H * 256 + 4 * Sq,
                                 4 * H * pairs * 256)
                add(name, layers // 2, ms, plain, lib, b, by,
                    f"H={H} S={Sq} T={T_LONG} p_last={p_last} window={window}")
                del q, k, v
    # F at the serving step: 8 slots near position 250, 64-row pages,
    # 1024 positions a sequence (the window does not bind: scale + softcap).
    B = 8
    last = [246 + b for b in range(B)]
    for (H, KVH, layers), S in zip(GEMMA_GEOMS.values(), (2, 1)):
        M = SERVE_MAX_LEN // SERVE_PAGE
        L = 2 * L2_BYTES // (2 * (B * M + 1) * KVH * SERVE_PAGE * 256 * 2) + 1
        q, _, _, kp, vp, table, pos = paged_inputs(g, dev, B, S, H, KVH, 256, SERVE_PAGE, last, L=L)
        cyc = Cycle(L)
        ms = median_ms(lambda: paged_flash(q, kp[cyc()], vp[cyc.i], pos, table, **GEMMA_OPTS))
        plain = median_ms(lambda: paged_flash_plain(q, kp[cyc()], vp[cyc.i], pos, table,
                                                    **GEMMA_OPTS), iters=10)
        lib = median_ms(lambda: sdpa_masked(q, gather_pages(kp[cyc()], table),
                                            gather_pages(vp[cyc.i], table), pos, None), iters=10)
        keys, pairs = seen_keys(pos, None)
        b, by = bound_ms(2 * KVH * keys * 256 * 2 + 2 * 2 * B * S * H * 256 + 4 * B * S
                         + 4 * table.numel(), 4 * H * pairs * 256)
        add("paged_flash", layers, ms, plain, lib, b, by, f"B={B} H={H} S={S} P={SERVE_PAGE} p~250")
        del kp, vp
    return timed


# --------------------------------------------------- Mistral's ring attention
def ring_keys(g, dev, cache, B, KVH, T, pos, window, R, D=128):
    """The same keys two ways: by position, [B, KVH, Tf, D] with Tf past
    every position and POISON where no live row of a sequence sees
    (gemma_keys); and as the engine's ring of R slots leaves them, [B, KVH,
    T, D]: slot s holds the latest position at most the sequence's largest
    one congruent to s mod R, POISON where there is none. Returns (full,
    ring), each [k, v, k_scale, v_scale] (scales None for bf16)."""
    Tf = int(pos.max()) + 2  # position Tf - 1 is past every row: POISON
    full = gemma_keys(g, dev, cache, B, KVH, Tf, pos, window, D=D)
    slots = torch.arange(T, device=dev)
    idx = torch.stack([int(p.max()) - (int(p.max()) - slots) % R for p in pos])
    idx = torch.where(idx >= 0, idx, Tf - 1)
    ring = [None if t is None else torch.stack([t[b][:, idx[b]] for b in range(B)]).contiguous()
            for t in full]
    return list(full), ring


def ring_mask(pos, T, window, R):
    """[B, 1, S, T] bool: attend_xla's ring rule, slot s seen by a row at p
    iff rel = (p - s) mod R < window and rel <= p."""
    rel = (pos[:, None, :, None] - torch.arange(T, device=pos.device)) % R
    return (rel < window) & (rel <= pos[:, None, :, None])


def sdpa_ring(q, k, v, mask, ks=None, vs=None):
    """The library yardstick for ring attention (timed only, never used):
    SDPA given the boolean ring mask; an int8 cache dequantized first."""
    if ks is not None:
        k = (k.float() * ks[..., None]).to(q.dtype)
        v = (v.float() * vs[..., None]).to(q.dtype)
    out = torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k, v, attn_mask=mask, enable_gqa=True)
    return out.transpose(1, 2)


def phase_ring_attention(dev):
    """D and E with ring_len at Mistral-7B's geometry (32 / 8 heads of 128,
    window 4096, R = RING_LEN = 4736), bf16 and int8. Checks on a ring of
    T = R slots: decode rows (S = 1, 5) at 5400 (the window wraps the ring)
    and near 300 with a dead row, a 512-row chunk at 4608..5119 (it crosses
    the wrap at 4736) beside one at 0..511 with a dead row; on a ring of
    T = 256 < R (the short prompt's cache): S = 5 at 130..134 and 196..200,
    S = 160 at 0..159 and 96..255. POISON at every position and slot no
    live row sees. Each within check_attn's tolerance of its plain version
    on f32 q, finite, dead rows zero; E vs D on the decode rows and D vs E
    row by row in the chunks within both tolerances, D at S = 1 equal to its
    row of S = 5 and E's rows alone equal to the chunk's (bits); at T = R
    each equals its own result over the same
    keys laid out by position with the window alone (the body walks
    positions, so the wrap costs no bits). Times: D at the long prompt's
    K=4 step (p = 5400), E at the long prompt's 11 chunks of 512."""
    from llm_inference_lab_tpu_torch.ops.flash_decode import (
        flash_decode,
        flash_decode_int8,
        flash_decode_plain,
    )
    from llm_inference_lab_tpu_torch.ops.flash_prefill import flash_prefill, flash_prefill_int8

    g = torch.Generator(device=dev).manual_seed(41)
    H, KVH, layers = MISTRAL_GEOM
    D, W, R = 128, MISTRAL_WINDOW, RING_LEN
    opts = dict(window=W, ring_len=R)
    kernels = {"bf16": (flash_decode, flash_prefill), "int8": (flash_decode_int8,
                                                               flash_prefill_int8)}
    errs = {name: 0.0 for name in ("flash_decode", "flash_prefill", "flash_decode_int8",
                                   "flash_prefill_int8")}
    cases = {R: ((1, (5400, 300)), (5, (5400, 304)), (512, (5119, 511))),
             256: ((5, (134, 200)), (160, (159, 255)))}
    for cache, (dk, ek) in kernels.items():
        for T, shapes in cases.items():
            for S, last in shapes:
                pos = (torch.tensor(last, device=dev, dtype=torch.int32)[:, None] - S + 1
                       + torch.arange(S, device=dev, dtype=torch.int32)[None]).contiguous()
                if S > 1:
                    pos[1, 0] = -1
                full, (k, v, ks, vs) = ring_keys(g, dev, cache, 2, KVH, T, pos, W, R)
                q = torch.randn((2, S, H, D), generator=g, device=dev).bfloat16()
                sc = (ks, vs) if cache == "int8" else ()
                kernel = dk if S <= 32 else ek
                name = kernel.__name__
                got = kernel(q, k, v, pos, *sc, **opts)
                what = (name, "ring", cache, T, S)
                errs[name] = max(errs[name], check_attn(got, q, k, v, pos, *sc, what=what, **opts))
                if S > 1:
                    assert torch.all(got[1, 0] == 0), (what, "dead row not zero")
                if S <= 32:
                    check_attn_pair(ek(q, k, v, pos, *sc, **opts), got, q, k, v, pos, *sc,
                                    what=(what, "E vs D"), **opts)
                    if S > 1:  # D at S = 1 on the last position: that row of the verify
                        one = dk(q[:, -1:].contiguous(), k, v, pos[:, -1:].contiguous(), *sc,
                                 **opts)
                        assert torch.equal(one, got[:, -1:]), (what, "S-dependent rounding")
                else:
                    for j in (0, S // 4 - 1, S // 4, S - 1):  # 4608 + 128 = 4736: the wrap
                        qj, pj = q[:, j:j + 1].contiguous(), pos[:, j:j + 1].contiguous()
                        assert torch.equal(ek(qj, k, v, pj, *sc, **opts), got[:, j:j + 1]), \
                            (what, j, "E alone != E on a chunk row")
                        check_attn_pair(dk(qj, k, v, pj, *sc, **opts), got[:, j:j + 1], qj, k, v,
                                        pj, *sc, what=(what, j, "D vs E"), **opts)
                if T == R:
                    fk, fv, fks, fvs = full
                    fsc = (fks, fvs) if sc else ()
                    assert torch.equal(kernel(q, fk, fv, pos, *fsc, window=W), got), \
                        (what, "ring != the same keys by position")
                log(f"ring attention {cache} T={T} S={S} last={last}: {name} within tolerance "
                    f"of its plain version, POISON unseen, dead rows zero, D vs E within "
                    f"tolerance, rows alone == among others"
                    + (", == the same keys by position (bits)" if T == R else ""))
                del full, k, v
    timed = {name: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, bound_by="bytes",
                        max_abs_err=err) for name, err in errs.items()}

    def add(name, n, ms, plain, lib, b, by, what, full=""):
        log(f"{name} ring {what}: {ms:.4f} ms  plain {plain:.4f}  library {lib:.4f} "
            f"(SDPA + the ring mask)  bound {b:.5f} ({by}){full}")
        agg = timed[name]
        for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib), ("bound_ms", b)):
            agg[key] += n * val
        if by == "operations":
            agg["bound_by"] = by

    # D at the long prompt's K=4 step (draft S = 1 four times, verify S = 5,
    # at p = P_RING); E at its 11 chunks of 512 (T = R: the ring is full).
    # D and E's chunk across the wrap are timed again over a full cache (T =
    # the long prompt's 5760, the window alone, the same positions): the
    # ring's own cost.
    work = [(S, P_RING, 4 * layers if S == 1 else layers) for S in (1, 5)]
    work += [(512, 512 * c + 511, layers) for c in range(11)]
    Tf = 5760
    for cache, (dk, ek) in kernels.items():
        esize = 1 if cache == "int8" else 2

        def keys(T):
            L = 2 * L2_BYTES // (2 * KVH * T * D * esize) + 1
            if cache == "int8":
                (k, ks), (v, vs) = (int8_kv(g, dev, (L, 1, KVH, T, D)) for _ in "kv")
                return Cycle(L), k, v, ks, vs
            k, v = (torch.randn((L, 1, KVH, T, D), generator=g, device=dev).bfloat16()
                    for _ in "kv")
            return Cycle(L), k, v, None, None

        (cyc, k, v, ks, vs), (cyf, kf, vf, ksf, vsf) = keys(R), keys(Tf)

        def scales():
            return (ks[cyc.i], vs[cyc.i]) if ks is not None else ()

        def full_scales():
            return (ksf[cyf.i], vsf[cyf.i]) if ksf is not None else ()

        for S, p_last, n in work:
            q = torch.randn((1, S, H, D), generator=g, device=dev).bfloat16()
            pos = (p_last - S + 1 + torch.arange(S, device=dev, dtype=torch.int32))[None]
            pos = pos.contiguous()
            mask = ring_mask(pos, R, W, R)
            fn = dk if S <= 32 else ek
            big = S > 32
            ms = median_ms(lambda: fn(q, k[cyc()], v[cyc.i], pos, *scales(), **opts),
                           iters=5 if big else 25, warmup=1 if big else 3)
            plain = median_ms(lambda: flash_decode_plain(q, k[cyc()], v[cyc.i], pos, *scales(),
                                                         **opts), iters=3 if big else 10, warmup=1)
            lib = median_ms(lambda: sdpa_ring(q, k[cyc()], v[cyc.i], mask, *scales()),
                            iters=3 if big else 10, warmup=1)
            keys, pairs = seen_keys(pos, W)  # the ring holds every position a window reaches
            if cache == "int8":
                b, by = attn_bound(S, H, KVH, D, keys, pairs * H)
            else:
                b, by = bound_ms(2 * KVH * keys * D * 2 + 2 * 2 * S * H * D + 4 * S,
                                 4 * H * pairs * D)
            full = ""
            if S <= 32 or p_last == 5119:
                full_ms = median_ms(lambda: fn(q, kf[cyf()], vf[cyf.i], pos, *full_scales(),
                                               window=W), iters=5 if big else 25,
                                    warmup=1 if big else 3)
                full = f"; full cache (T={Tf}, window alone) {full_ms:.4f} ms"
            name = fn.__name__
            add(name, n, ms, plain, lib, b, by, f"{cache} H={H} S={S} T={R} p_last={p_last}", full)
        del k, v, ks, vs, kf, vf, ksf, vsf
    return timed


# The kernels that only a decode step launches: outside the decode loop's
# replays they launch only in the eager warm-up step before a capture.
DECODE_ONLY = {"quant_matmul_int4", "quant_matmul_int8", "flash_decode", "flash_decode_int8",
               "paged_flash", "paged_flash_int8", "verify_prefix", "flash_decode_tree",
               "flash_decode_tree_int8", "paged_flash_tree", "paged_flash_tree_int8"}


def count_launches(path, run):
    """Set every kernel's launch count to 0, call run(), read the counts, and
    check that exactly the kernels of `path` launched, rms_norm once a
    forward and add_rms_norm twice a layer a forward. A count is the eager
    launches (the wrappers' counters, models/transformer.py's forward counts)
    plus the decode loops' replays, each replay counting the launches,
    forwards and layers of its captured step (DecodeLoop.per_replay). The
    path must decode through replays; no wrapper's counter may move across
    a chunk of replays; and a decode-only kernel (DECODE_ONLY) may launch
    eagerly only in the warm-up step of a loop bound inside run()."""
    from llm_inference_lab_tpu_torch.core.specstep import DecodeLoop
    from llm_inference_lab_tpu_torch.models import transformer

    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    transformer.forward.calls = transformer.forward.layers = 0
    DecodeLoop.replayed.clear()
    inner_replay, inner_bind, bound = DecodeLoop.replay, DecodeLoop.bind, []

    def replay(loop, n):
        before = [w.launches for w in wrappers.values()]
        inner_replay(loop, n)
        assert [w.launches for w in wrappers.values()] == before, (
            path, "a wrapper launched eagerly inside a chunk of replays")

    def bind(loop, state):
        inner_bind(loop, state)
        bound.append(loop)

    DecodeLoop.replay, DecodeLoop.bind = replay, bind
    try:
        out = run()
    finally:
        DecodeLoop.replay, DecodeLoop.bind = inner_replay, inner_bind
    replayed = dict(DecodeLoop.replayed)
    eager = {name: w.launches for name, w in wrappers.items()}
    launches = {name: eager[name] + replayed.get(name, 0) for name in wrappers}
    forwards = transformer.forward.calls + replayed.get("forwards", 0)
    layers = transformer.forward.layers + replayed.get("layers", 0)
    log(f"launches in {path}: {launches}; {forwards} forwards of {layers} layers in all; "
        f"{replayed.get('replays', 0)} graph replays ({replayed.get('forwards', 0)} forwards) "
        f"and {len(bound)} captures in the run; eager launches "
        f"{ {name: n for name, n in eager.items() if n} }")
    assert replayed.get("replays", 0) > 0, (path, "decoded through no graph replay")
    warm_up = {name: sum(loop.per_replay[name] for loop in bound) for name in DECODE_ONLY}
    assert all(eager[name] == warm_up[name] for name in DECODE_ONLY), (
        path, "decode kernels launched eagerly outside the loops' warm-up steps", eager, warm_up)
    launched = {name for name, n in launches.items() if n}
    assert launched == PATH_KERNELS[path], (path, "launched", launched,
                                            "expected", PATH_KERNELS[path])
    assert launches["rms_norm"] == forwards, (path, "rms_norm once a forward", forwards)
    assert launches["add_rms_norm"] == 2 * layers, (path, "add_rms_norm twice a layer", layers)
    return out, launches


def graph_report(what, loops):
    """Log each decode loop's capture: host seconds, the memory its capture
    reserved in the engine's graph pool, the kernels a replay launches, and
    its replays so far."""
    for shape, loop in loops:
        per = loop.per_replay
        kernels = sum(n for name, n in per.items() if name not in ("forwards", "layers"))
        log(f"graph of {what} {shape}: capture {loop.capture_s * 1e3:.1f} ms, graph pool "
            f"+{loop.pool_bytes / 1e6:.1f} MB, {kernels} launches of the port's kernels a "
            f"replay ({per['forwards']} forwards, {per['layers']} layers), {loop.replays} "
            f"replays")


def engine_loops(what, eng, T=None):
    """(shape, loop) of each decode state an engine holds, or of those of
    buffer length T, for graph_report."""
    return [((what,) + key, loop) for key, (_, loop) in eng._decode_states.items()
            if T is None or key[1] == T]


def draft_params_of(eng):
    """What an engine drafts with, to build another on the same weights: the
    draft model's params, the medusa or tree heads, or None."""
    return eng.draft.params if eng.draft is not None else eng._draft_params


def host_engine(eng):
    """An engine with eng's weights and settings on the host loop
    (EnvFlags(sync_steps=True)): the eager reference of the graph path."""
    from llm_inference_lab_tpu_torch.config import EnvFlags
    from llm_inference_lab_tpu_torch.core.engine import Engine

    return Engine(eng.config, device=eng.device, flags=EnvFlags(sync_steps=True),
                  target_params=eng.target.params, draft_params=draft_params_of(eng))


def same_decode(what, graph, host):
    """Graph-path results against the host loop's: equal ids, steps,
    proposed and accepted."""
    for g, h in zip(graph, host, strict=True):
        for key in ("generated_ids", "steps", "proposed", "accepted"):
            assert g[key] == h[key], (what, "graph path != host loop", key, g[key], h[key])


def ids_digest(path, id_lists):
    """Log a digest of a path's generated ids (a list of id lists, in request
    or run order), so that two commits' runs can be compared line by line."""
    digest = hashlib.sha256(json.dumps(id_lists).encode()).hexdigest()[:16]
    log(f"ids digest {path}: {digest} ({len(id_lists)} sequences, "
        f"{sum(map(len, id_lists))} ids)")


def timing(rs):
    """Median tok/s and ms/step of generate results, with each run's tok/s."""
    tps = statistics.median(r["tokens_per_sec"] for r in rs)
    step_ms = statistics.median(r["generation_time_ms"] / r["steps"] for r in rs)
    return (f"median {tps:.2f} tok/s, {step_ms:.3f} ms/step, "
            f"runs tok/s {[round(r['tokens_per_sec'], 2) for r in rs]}, ms/step "
            f"{[round(r['generation_time_ms'] / r['steps'], 3) for r in rs]}")


def phase_end_to_end(dev, profile, cfg, path, label):
    """Phases 3 and 4: Engine.generate at B=1, warm-up then three timed
    runs, against a baseline and a self-drafted run."""
    from llm_inference_lab_tpu_torch.config import EngineConfig
    from llm_inference_lab_tpu_torch.core.engine import Engine

    cfg = EngineConfig(**cfg)
    t0 = time.perf_counter()
    eng = Engine(cfg, device=dev)
    torch.cuda.synchronize()
    log(f"engine init (random {cfg.quantization} weights on the card): "
        f"{time.perf_counter() - t0:.1f} s")
    eng.generate(PROMPT)  # warm-up, and the decode loop's capture
    graph_report(f"generate ({label})", engine_loops("B, max_len", eng))
    torch.cuda.reset_peak_memory_stats()
    runs, launches = count_launches(path, lambda: [eng.generate(PROMPT) for _ in range(3)])
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    ids = runs[0]["generated_ids"]
    assert all(r["generated_ids"] == ids for r in runs), "repeated runs differ"
    for r in runs:
        lp = torch.tensor(r["token_logprobs"])
        assert len(lp) == r["generated_tokens"] and torch.isfinite(lp).all(), "bad logprobs"
    assert runs[0]["generated_tokens"] >= 1
    ids_digest(path, [ids])
    # The baseline is timed as the spec run is: one warm-up, median of 3.
    base_eng = Engine(replace(cfg, draft_model=None), device=dev, target_params=eng.target.params)
    base_eng.generate(PROMPT)
    bases = [base_eng.generate(PROMPT) for _ in range(3)]
    assert all(b["generated_ids"] == ids for b in bases), "speculative output differs from baseline"
    # The random draft never agrees with the random target, so the run
    # above rejects every draft. Drafting with the target's own weights
    # accepts drafts and runs the accept and full-accept bonus paths. (Not
    # every draft: after a full accept the draft cache lacks the last
    # draft's row, in the JAX package as in the port.)
    same = Engine(replace(cfg, draft_model=cfg.base_model), device=dev,
                  target_params=eng.target.params,
                  draft_params=eng.target.params).generate(PROMPT)
    assert same["generated_ids"] == ids, "self-drafted output differs from baseline"
    assert same["accepted"] > 0, "the self-drafted run accepted no draft"
    log(f"self-drafted (target weights as draft): acceptance {same['acceptance_rate']:.4f}, "
        f"steps {same['steps']}, {same['tokens_per_sec']:.2f} tok/s; ids == baseline ids")

    log(f"end to end ({label}, B=1, {cfg.max_new_tokens} new tokens): {timing(runs)}, "
        f"steps {runs[0]['steps']}, acceptance {runs[0]['acceptance_rate']:.4f}, "
        f"generated {runs[0]['generated_tokens']}, peak memory {peak_mb:.1f} MB; "
        f"baseline (target alone): {timing(bases)}, steps {bases[0]['steps']}; "
        f"spec ids == baseline ids")
    # The graph path against the host loop in one process, in turns: host,
    # graph, graph, host (the host engine's first run is its own warm-up).
    host = host_engine(eng)
    host.generate(PROMPT)
    turns = [e.generate(PROMPT) for e in (host, eng, eng, host)]
    same_decode(label, turns, [runs[0]] * 4)
    log(f"graph path against the host loop ({label}, in turns host, graph, graph, host; ids, "
        f"steps, proposed, accepted equal): graph {timing(turns[1:3])}; host loop "
        f"{timing(turns[::3])}")
    if profile:
        profile_run(f"generate ({label})", lambda: eng.generate(PROMPT),
                    statistics.median(r["latency_ms"] for r in runs))
    return eng, launches


def step_stats(rs):
    """Tokens a step and acceptance of generate results (their medians are
    the runs' values: the runs repeat exactly)."""
    r = rs[0]
    return (f"{r['generated_tokens'] / r['steps']:.3f} tokens a step, acceptance "
            f"{r['acceptance_rate']:.4f} ({r['accepted']} of {r['proposed']})")


def phase_ngram(dev, profile, path):
    """Phase 10: ngram drafting at the JAX package's ngram_3b_int8_k12
    configuration (NGRAM_CFG) on PROMPT: one warm-up and three timed
    generate calls on the graph path in one launch count, a greedy baseline
    (no drafts) timed alike, then the host loop in turns with the graph
    path. The ids must equal the baseline's (A's and B's decode rows keep
    their bits at every M, D at S = 1 those of its row of S = 13), graph
    and host loop must agree, and acceptance must be above 0 with more than
    one token committed a step."""
    from llm_inference_lab_tpu_torch.config import EngineConfig
    from llm_inference_lab_tpu_torch.core.engine import Engine

    cfg = EngineConfig(**NGRAM_CFG)
    eng = Engine(cfg, device=dev)
    label = f"3B int8 ngram K={NGRAM_K}"
    eng.generate(PROMPT)  # warm-up, and the decode loop's capture
    graph_report(f"generate ({label})", engine_loops("B, max_len", eng))
    torch.cuda.reset_peak_memory_stats()
    runs, launches = count_launches(path, lambda: [eng.generate(PROMPT) for _ in range(3)])
    polls = eng.polls
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    ids = runs[0]["generated_ids"]
    assert all(r["generated_ids"] == ids for r in runs), "repeated runs differ"
    for r in runs:
        lp = torch.tensor(r["token_logprobs"])
        assert len(lp) == r["generated_tokens"] and torch.isfinite(lp).all(), "bad logprobs"
    ids_digest(path, [ids])
    base_eng = Engine(replace(cfg, draft_mode="vanilla"), device=dev,
                      target_params=eng.target.params)
    base_eng.generate(PROMPT)
    bases = [base_eng.generate(PROMPT) for _ in range(3)]
    assert all(b["generated_ids"] == ids for b in bases), "ngram output differs from baseline"
    r = runs[0]
    log(f"end to end ({label}, B=1, {cfg.max_new_tokens} new tokens): {timing(runs)}, steps "
        f"{r['steps']}, {step_stats(runs)}, {polls} polls a generate, peak memory "
        f"{peak_mb:.1f} MB; baseline (no drafts): {timing(bases)}, steps {bases[0]['steps']}; "
        f"ngram ids == baseline ids; ids {ids}")
    assert r["accepted"] > 0 and r["generated_tokens"] > r["steps"], (
        "ngram accepted no draft on the seed's weights", ids)
    host = host_engine(eng)
    host.generate(PROMPT)
    turns = [e.generate(PROMPT) for e in (host, eng, eng, host)]
    same_decode(label, turns, [r] * 4)
    log(f"graph path against the host loop ({label}, in turns host, graph, graph, host; ids, "
        f"steps, proposed, accepted equal): graph {timing(turns[1:3])}; host loop "
        f"{timing(turns[::3])}")
    if profile:
        profile_run(f"generate ({label})", lambda: eng.generate(PROMPT),
                    statistics.median(r["latency_ms"] for r in runs))
    return eng, launches


def phase_sampling(dev, eng, profile, paths):
    """Phase 11 on the main path's weights (eng: phase 3's engine):
    SAMPLED (temperature 0.8, top_p 0.95, rejection, device-side adaptive
    K up to 4) through three timed generate calls with one seed, then the
    host loop in turns; graph ids == host loop ids, a repeat with the seed
    gives its ids and another seed others, logprobs finite, the final K of
    the device controller in [min_k, max_k]. Then greedy runs of the other
    policies and the host adaptive controller (K from 4, a one-step graph a
    K), graph path against host loop, in one launch count."""
    from llm_inference_lab_tpu_torch.core.engine import Engine

    def engine(**kw):
        return Engine(replace(eng.config, **kw), device=dev, target_params=eng.target.params,
                      draft_params=eng.draft.params)

    label = "3B int4 + 1B draft, sampled, rejection, adaptive-device K<=4"
    samp = engine(**SAMPLED)
    samp.generate(PROMPT, seed=1)  # warm-up, and the capture
    graph_report(f"generate ({label})", engine_loops("B, max_len", samp))
    runs, launches = {}, {}
    runs[paths[0]], launches[paths[0]] = count_launches(
        paths[0], lambda: [samp.generate(PROMPT, seed=1) for _ in range(3)])
    rs = runs[paths[0]]
    ids = rs[0]["generated_ids"]
    assert all(r["generated_ids"] == ids for r in rs), "a seed's runs differ"
    other = samp.generate(PROMPT, seed=2)
    assert other["generated_ids"] != ids, "another seed gave the same ids"
    ctl = samp.controller
    for r in rs + [other]:
        lp = torch.tensor(r["token_logprobs"])
        assert len(lp) == r["generated_tokens"] and torch.isfinite(lp).all(), "bad logprobs"
        assert ctl.min_k <= r["controller"]["final_k"] <= ctl.max_k, r["controller"]
    ids_digest(paths[0], [ids, other["generated_ids"]])
    host = host_engine(samp)
    host.generate(PROMPT, seed=1)
    turns = [e.generate(PROMPT, seed=1) for e in (host, samp, samp, host)]
    same_decode(label, turns, [rs[0]] * 4)
    log(f"end to end ({label}, B=1): {timing(rs)}, steps {rs[0]['steps']}, {step_stats(rs)}, "
        f"final K {rs[0]['controller']['final_k']}, {samp.polls} polls a generate; seed 2: "
        f"other ids, acceptance {other['acceptance_rate']:.4f}; graph path against the host "
        f"loop in turns (ids, steps, proposed, accepted equal): graph {timing(turns[1:3])}; "
        f"host loop {timing(turns[::3])}")
    if profile:
        profile_run(f"generate ({label})", lambda: samp.generate(PROMPT, seed=1),
                    statistics.median(r["latency_ms"] for r in rs))
    greedy = {what: engine(max_draft=4, **kw) for what, kw in GREEDY_POLICIES.items()}
    # The first run of each (the warm-up and the captures) against a fresh
    # host-loop engine's: the host adaptive controller keeps its K and
    # window from call to call, as JAX's does.
    hosts = [host_engine(e).generate(PROMPT) for e in greedy.values()]
    same_decode("greedy policies", [e.generate(PROMPT) for e in greedy.values()], hosts)
    runs[paths[1]], launches[paths[1]] = count_launches(
        paths[1], lambda: [e.generate(PROMPT) for e in greedy.values()])
    ids_digest(paths[1], [r["generated_ids"] for r in runs[paths[1]]])
    adaptive = greedy["host adaptive K"]
    log("greedy policies at K=4 (graph == host loop): " + "; ".join(
        f"{what}: {timing([r])}, steps {r['steps']}, {step_stats([r])}"
        for what, r in zip(greedy, runs[paths[1]])) + f"; host adaptive K: one-step graphs at K "
        f"{sorted({k for _, _, k in adaptive.adaptive_loops})}, final K "
        f"{runs[paths[1]][-1]['controller']['k']}, {adaptive.polls} polls")
    graph_report("the host adaptive controller", [(("K",) + key, loop) for key, loop in
                                                  adaptive.adaptive_loops.items()])
    return launches


def secs(r):
    """Prefill and decode seconds of a generate result."""
    decode = r["generation_time_ms"] / 1e3
    return (f"prefill {r['latency_ms'] / 1e3 - decode:.3f} s, decode {decode:.3f} s "
            f"({r['tokens_per_sec']:.2f} tok/s, {r['steps']} steps, "
            f"{r['generation_time_ms'] / r['steps']:.3f} ms/step)")


def phase_long_prompt(dev, eng, path):
    """Phase 6's long prompt: one speculative and one baseline generate on
    LONG_PROMPT (4320 tokens, cache T = 4480 > the window), in one launch
    count. Their ids must be equal and every logprob finite."""
    from llm_inference_lab_tpu_torch.core.engine import Engine, _round_up

    cfg = eng.config
    n = len(eng.encode(LONG_PROMPT, cfg.max_new_tokens, cfg.max_seq_len))
    T = _round_up(_round_up(n, 32) + cfg.max_new_tokens + cfg.max_draft + 2, 128)
    assert n == 4320 and T == T_LONG > GEMMA_WINDOW, (n, T)
    base = Engine(replace(cfg, draft_model=None), device=dev, target_params=eng.target.params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (spec, bl), launches = count_launches(
        path, lambda: (eng.generate(LONG_PROMPT), base.generate(LONG_PROMPT)))
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    assert spec["generated_ids"] == bl["generated_ids"], "long prompt: spec ids != baseline ids"
    ids_digest(path, [spec["generated_ids"], bl["generated_ids"]])
    for r in (spec, bl):
        lp = torch.tensor(r["token_logprobs"] + r["prompt_logprobs"][1:])
        assert r["generated_tokens"] >= 1 and torch.isfinite(lp).all(), "bad long-prompt logprobs"

    log(f"long prompt ({n} tokens, T={T}, window {GEMMA_WINDOW} binds): spec {secs(spec)}, "
        f"acceptance {spec['acceptance_rate']:.4f}; baseline {secs(bl)}; peak memory "
        f"{peak_mb:.1f} MB; spec ids == baseline ids")
    graph_report("the long prompt", engine_loops("spec", eng, T) + engine_loops("baseline", base))
    # In turns: the graph runs above (their decode time holds the capture of
    # the new shape), the host loop, the graph path again (captured).
    hosts = [host_engine(e).generate(LONG_PROMPT) for e in (eng, base)]
    again = [e.generate(LONG_PROMPT) for e in (eng, base)]
    same_decode("long prompt", (spec, bl) * 2, hosts + again)
    log(f"long prompt, the host loop after the graph runs, then the graph path again (ids, "
        f"steps, proposed, accepted equal): host loop spec {secs(hosts[0])}, baseline "
        f"{secs(hosts[1])}; graph again spec {secs(again[0])}, baseline {secs(again[1])}")
    return launches


def cache_mb(cfg, T, kv_bytes=2):
    """MB of one model's K and V for one sequence of T slots (int8: 1 byte
    a value and 8 bytes of scales a row)."""
    rows = 2 * cfg.n_layers * cfg.n_kv_heads * T
    return rows * (cfg.head_dim * kv_bytes + (4 if kv_bytes == 1 else 0)) / 1e6


def phase_mistral_long(dev, eng, paths):
    """Phase 8's long prompt (MISTRAL_LONG, 5400 tokens: P = 5632 in 11
    chunks of 512, max_len 5760, ring T = R = 4736; it wraps the ring at
    position 4736 and its decode sees two ends of the buffer). Spec and
    baseline on the ring (spec ids == ring baseline ids); a baseline on the
    full cache (T = 5760); int8-KV baselines on the ring and on the full
    cache. Ring ids must equal the full cache's for bf16 and for int8;
    where a pair parts, near_tie on the full-cache engine (a ring cannot
    hold a one-shot forward of the prompt) must find a gap of at most 2
    bf16 ulps of the top logit. Then ngram drafting (K=4, no draft model) on
    the ring: its ids must equal the ring baseline's. Each run in its own
    launch count."""
    from llm_inference_lab_tpu_torch.core.engine import Engine, _round_up

    cfg = eng.config
    n = len(eng.encode(MISTRAL_LONG, cfg.max_new_tokens, cfg.max_seq_len))
    P = _round_up(_round_up(n, 32), cfg.prefill_chunk)
    T = _round_up(P + cfg.max_new_tokens + cfg.max_draft + 2, 128)
    assert (n, P, T) == MISTRAL_LONG_SHAPE, (n, P, T)
    tp = eng.target.params

    def engine(**kw):
        return Engine(replace(cfg, draft_model=None, **kw), device=dev, target_params=tp)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = engine()
    launches = {}
    (spec, ring), launches[paths[0]] = count_launches(
        paths[0], lambda: (eng.generate(MISTRAL_LONG), base.generate(MISTRAL_LONG)))
    assert spec["generated_ids"] == ring["generated_ids"], "long prompt: spec ids != ring baseline"
    full_eng = engine(kv_ring=False)
    full, launches[paths[1]] = count_launches(paths[1], lambda: full_eng.generate(MISTRAL_LONG))
    ring8_eng, full8_eng = engine(kv_quantization="int8"), engine(kv_quantization="int8",
                                                                 kv_ring=False)
    ring8, launches[paths[2]] = count_launches(paths[2], lambda: ring8_eng.generate(MISTRAL_LONG))
    full8, launches[paths[3]] = count_launches(paths[3], lambda: full8_eng.generate(MISTRAL_LONG))
    # ngram drafts on the ring (K=4, no draft model): the ring baseline's ids.
    ngram_eng = engine(draft_mode="ngram")
    ngram, launches[paths[4]] = count_launches(paths[4], lambda: ngram_eng.generate(MISTRAL_LONG))
    assert ngram["generated_ids"] == ring["generated_ids"], "long prompt: ngram ids != ring baseline"
    assert ngram_eng.target.config.kv_ring_len == RING_LEN
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    for path, runs in zip(paths, ((spec, ring), (full,), (ring8,), (full8,), (ngram,))):
        ids_digest(path, [r["generated_ids"] for r in runs])
    assert base.target.config.kv_ring_len == RING_LEN and full_eng.target.config.kv_ring_len is None
    for r in (spec, ring, full, ring8, full8):
        lp = torch.tensor(r["token_logprobs"] + r["prompt_logprobs"][1:])
        assert r["generated_tokens"] >= 1 and torch.isfinite(lp).all(), "bad long-prompt logprobs"
    for kv, a, b, ref_eng in (("bf16", ring, full, full_eng), ("int8", ring8, full8, full8_eng)):
        gap = max(abs(x - y) for x, y in zip(a["token_logprobs"] + a["prompt_logprobs"][1:],
                                             b["token_logprobs"] + b["prompt_logprobs"][1:]))
        if a["generated_ids"] == b["generated_ids"]:
            log(f"long prompt {kv} KV: ring ids == full-cache ids; largest logprob difference "
                f"{gap:.3g}")
            continue
        tie = near_tie(ref_eng, dev, MISTRAL_LONG, b["generated_ids"], a["generated_ids"])
        log(f"long prompt {kv} KV: ring ids differ from the full cache's: {tie}")
        assert tie["gap_ulps"] <= 2, ("ring != full cache, not a near tie", kv, tie)
    engines = {"spec": eng, "ring baseline": base, "full-cache baseline": full_eng,
               "int8 ring baseline": ring8_eng, "int8 full-cache baseline": full8_eng,
               "ngram K=4": ngram_eng}
    graph_report("the mistral long prompt",
                 [shaped for what, e in engines.items() for shaped in engine_loops(what, e, T)])
    # In turns, as phase 6's long prompt: graph (with the capture), host
    # loop, graph again.
    hosts = {what: host_engine(e).generate(MISTRAL_LONG) for what, e in engines.items()}
    again = {what: e.generate(MISTRAL_LONG) for what, e in engines.items()}
    graph_runs = (spec, ring, full, ring8, full8, ngram)
    same_decode("mistral long prompt", graph_runs * 2,
                [*hosts.values(), *again.values()])
    log("mistral long prompt, the host loop after the graph runs, then the graph path again "
        "(ids, steps, proposed, accepted equal): host loop "
        + "; ".join(f"{what} {secs(r)}" for what, r in hosts.items()) + "; graph again "
        + "; ".join(f"{what} {secs(r)}" for what, r in again.items()))

    mc = eng.target.config
    log(f"mistral long prompt ({n} tokens, P={P}, ring T={RING_LEN}, full T={T}): spec "
        f"{secs(spec)}, acceptance {spec['acceptance_rate']:.4f}; ring baseline {secs(ring)}; "
        f"full-cache baseline {secs(full)}; int8 ring baseline {secs(ring8)}; int8 full-cache "
        f"baseline {secs(full8)}; peak memory {peak_mb:.1f} MB; cache a model: ring "
        f"{cache_mb(mc, RING_LEN):.1f} MB, full {cache_mb(mc, T):.1f} MB (at max_seq_len "
        f"{cfg.max_seq_len}: {cache_mb(mc, cfg.max_seq_len):.1f} MB), int8 ring "
        f"{cache_mb(mc, RING_LEN, 1):.1f} MB; spec ids == ring baseline ids; ngram K=4 on the "
        f"ring {secs(ngram)}, {step_stats([ngram])}, ids == ring baseline ids")
    return launches


def phase_kv_alignment(eng):
    """kv_alignment_report on the final state of one generate: the committed
    rows of the target cache against a fresh prefill of the committed
    tokens, dequantized, each element's difference relative to
    max(|fresh|, 1). The live rows come from forwards of 160 and 5 rows,
    the fresh ones from one of 256. torch's mean in rms_norm used to round a
    row differently with the number of rows (1.87 int8 steps at one
    position on an H100 80GB HBM3, tests/torch_kv_align_probe.py); the
    rms_norm kernel sums each row in a fixed order, but an op that rounds a
    row differently at another M (kernel B: the 5-row verify through its
    decode body, the 256-row prefill through its tensor-core path)
    still moves bf16 values by a bf16 step,
    about one int8 step of their row, and the int8 rounding adds up to one
    more. So the tolerance stays KV_ALIGN_STEPS steps of the largest
    committed row scale (the log gives the largest difference in steps); a
    stale, misplaced or unquantized row is off by O(1) of its values."""
    from llm_inference_lab_tpu_torch.core.kv_verify import kv_alignment_report

    state, plens, _, _ = eng.decode([PROMPT])
    cache, n = state.target_cache, int(state.lengths[0]) - 1
    step = max(float(sc[:, :, :, :n].max()) for sc in (cache.k_scale, cache.v_scale))
    tol = KV_ALIGN_STEPS * step
    rep = kv_alignment_report(eng.target, state, atol=tol, rtol=tol)
    log(f"kv_alignment_report (int8 cache, {rep['committed_rows']} committed rows, largest "
        f"row scale {step:.4f}, tolerance {KV_ALIGN_STEPS} steps = {tol:.4f}): {rep}; "
        f"largest difference {max(rep['max_rel_diff_k'], rep['max_rel_diff_v']) / step:.2f} "
        f"steps")
    assert rep["aligned"] and rep["committed_rows"] > int(plens[0]), rep
    return rep


def kernel_wrappers():
    from llm_inference_lab_tpu_torch.ops import kernel_wrappers as wrappers

    return wrappers()


RMS_NORM_OP = "rms_norm (kernel, fixed order)"
ADD_NORM_OP = "add_rms_norm (kernel, fixed order)"
D_VS_F = "D vs F rows at the serving shapes"
ACROSS_MMA = "kernel {} across MMA_MIN_M (decode body alone vs tensor-core path)"


def row_stability(eng, dev):
    """Each dense op of a forward on 40 random rows, computed one row at a
    time (M = 1) and together as the first M = 2, 5, 8, 16, 40 rows (B=1
    generate runs M = 1, 2 at K=1 and 1, 5 at K=4; the 8-slot batcher 8, 16
    or 8, 40), and the projection kernel also at 63 (its decode body's
    largest M): for each M, how many rows differ in any bit from the row
    alone; 0 for rms_norm, add_rms_norm and the projection kernel
    (asserted). Random rows
    can miss a rounding that a real row shows (tests/torch_kv_align_probe.py).
    Then the projection kernel across MMA_MIN_M: MMA_MIN_M rows together
    (its tensor-core path, which every prefill takes) against the same rows
    alone (its decode body, which every decode step takes); a row that one
    run prefills and another decodes through this op can part there. Then D
    against F over the same keys at the serving step's shapes: F runs D's
    body, so no row may differ (asserted)."""
    from llm_inference_lab_tpu_torch.models.transformer import (
        add_rms_norm,
        lm_head_logits,
        rms_norm,
    )
    from llm_inference_lab_tpu_torch.ops.quant import dense
    from llm_inference_lab_tpu_torch.ops.quant_matmul import MMA_MIN_M

    cfg, params = eng.target.config, eng.target.params
    g = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn((MMA_MIN_M, cfg.d_model), generator=g, device=dev).bfloat16()
    w = params["layers"]["w_qkv"].layer(0)
    kernel = "quant_matmul_int4 (kernel A)" if w.bits == 4 else "quant_matmul_int8 (kernel B)"
    head = ("tied int8 head (cast + torch.mm, f32 out)" if cfg.tie_word_embeddings
            and not isinstance(params["embed"], torch.Tensor) else
            "tied bf16 head (torch.mm, f32 out)" if cfg.tie_word_embeddings else
            "untied head (dense)")
    layer0 = params["layers"]
    post = layer0["post_attn_norm_scale"][0] if cfg.post_norms else None
    ops = {
        RMS_NORM_OP:
            lambda a: rms_norm(a, layer0["attn_norm_scale"][0], cfg.rms_norm_eps,
                               cfg.rms_one_offset),
        ADD_NORM_OP:  # the residual a + a' and its norm, side by side
            lambda a: torch.cat(add_rms_norm(a, a, layer0["mlp_norm_scale"][0],
                                             cfg.rms_norm_eps, cfg.rms_one_offset, post), -1),
        head: lambda a: lm_head_logits(cfg, params, a),
        kernel: lambda a: dense(a, w),
    }
    out = {}
    for name, fn in ops.items():
        n = MMA_MIN_M if name == kernel else 40
        alone = torch.cat([fn(x[i:i + 1].contiguous()) for i in range(n)])
        out[name] = {M: int((fn(x[:M].contiguous()) != alone[:M]).any(-1).sum())
                     for M in (2, 5, 8, 16, 40) + ((MMA_MIN_M - 1,) if name == kernel else ())}
        if name == kernel:
            out[ACROSS_MMA.format("A" if w.bits == 4 else "B")] = {
                MMA_MIN_M: int((fn(x) != alone).any(-1).sum())}
    for op in (RMS_NORM_OP, ADD_NORM_OP):
        assert not any(out[op].values()), (op, "rows depend on M", out[op])
    assert not any(out[kernel].values()), ("projection rows depend on M", out[kernel])
    out[D_VS_F] = attention_rows(eng, dev)
    assert not any(out[D_VS_F].values()), ("D and F differ", out[D_VS_F])
    return out


def attention_rows(eng, dev):
    """Kernel D over contiguous keys against kernel F over the same keys in
    shuffled pages, at the serving step's shapes (SERVE_SLOTS sequences at
    positions near 250, SERVE_PAGE-row pages, the target's heads, cache type
    and options, S = 1 and S = K+1): for each S, how many query rows
    (position, head) differ in any bit (row_stability requires 0)."""
    from llm_inference_lab_tpu_torch.models.base import quantize_rows
    from llm_inference_lab_tpu_torch.ops.flash_decode import flash_decode
    from llm_inference_lab_tpu_torch.ops.paged_flash import paged_flash

    cfg = eng.target.config
    B, H, KVH, D = SERVE_SLOTS, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    opts = dict(scale=(cfg.query_pre_attn_scalar ** -0.5 if cfg.query_pre_attn_scalar else None),
                softcap=cfg.attn_logit_softcap)
    g = torch.Generator(device=dev).manual_seed(16)
    T = 1024
    k, v = (torch.randn((B, KVH, T, D), generator=g, device=dev) for _ in "kv")
    sc = ()
    if eng.kv_dtype == torch.int8:
        (k, ks), (v, vs) = quantize_rows(k), quantize_rows(v)
        sc = (ks, vs)
    else:
        k, v = k.bfloat16(), v.bfloat16()
    pools, table = to_pages(g, dev, (k, v, *sc), SERVE_PAGE)
    out = {}
    for S in (1, eng.config.max_draft + 1):
        q = torch.randn((B, S, H, D), generator=g, device=dev).bfloat16()
        pos = (torch.arange(246, 246 + B, device=dev, dtype=torch.int32)[:, None] - S + 1
               + torch.arange(S, device=dev, dtype=torch.int32)[None]).contiguous()
        a = flash_decode(q, k, v, pos, *sc, **opts)
        b = paged_flash(q, pools[0], pools[1], pos, table, *pools[2:], **opts)
        out[S] = int((a != b).any(-1).sum())
    if eng.tree is not None:  # the tree variants, at the tree's verify chunk
        from llm_inference_lab_tpu_torch.ops.flash_decode import flash_decode_tree
        from llm_inference_lab_tpu_torch.ops.paged_flash import paged_flash_tree

        anc = torch.from_numpy(eng.tree.build()[3]).to(dev)
        S = anc.shape[0]
        q = torch.randn((B, S, H, D), generator=g, device=dev).bfloat16()
        start = torch.arange(240, 240 + B, device=dev, dtype=torch.int32)
        a = flash_decode_tree(q, k, v, anc, start, *sc, **opts)
        b = paged_flash_tree(q, pools[0], pools[1], table, anc, start, *pools[2:], **opts)
        out[f"tree {S}"] = int((a != b).any(-1).sum())
    return out


def row_key(m):
    """Order row_stability's keys: the M (or S) in order, then the named
    ones (the tree variants')."""
    return (1, m) if isinstance(m, str) else (0, str(m).zfill(8))


def near_tie(eng, dev, prompt, ids_a, ids_b):
    """At the first position where two greedy runs of one prompt differ: the
    two top target logits from a fresh B=1 forward over the common prefix,
    their gap and the gap in bf16 ulps of the top logit (the head's logits
    are f32, as in JAX; a bf16 step of the top logit is the scale at which
    the bf16 activations feeding it round)."""
    j = next(i for i, (a, b) in enumerate(zip(ids_a, ids_b)) if a != b)
    ctx = eng.tokenizer.encode(prompt) + ids_a[:j]
    n = len(ctx)
    cache = eng.target.init_cache(1, -(-n // 32) * 32, dev, dtype=eng.kv_dtype)
    logits, _ = eng.target.forward(
        torch.tensor([ctx], device=dev, dtype=torch.int32),
        torch.arange(n, device=dev, dtype=torch.int32)[None],
        cache, torch.zeros((1,), device=dev, dtype=torch.int32))
    top = torch.topk(logits[0, -1], 2)
    (v1, v2), (t1, t2) = top.values.tolist(), top.indices.tolist()
    ulp = 2.0 ** (math.floor(math.log2(abs(v1))) - 7)
    return dict(position=j, tokens=(ids_a[j], ids_b[j]), top2=((t1, v1), (t2, v2)),
                gap=v1 - v2, gap_ulps=(v1 - v2) / ulp)


def phase_serving(dev, eng, profile, max_len, path, label):
    """Phases 3b and 5: the paged serving path at full width, on the B=1
    phase's weights and engine settings, lanes of max_len."""
    from llm_inference_lab_tpu_torch.config import EnvFlags
    from llm_inference_lab_tpu_torch.core.batching import ContinuousBatcher
    from llm_inference_lab_tpu_torch.core.engine import Engine

    def batcher(layout, flags=None):
        cfg = replace(eng.config, max_seq_len=max_len, kv_layout=layout, kv_page_size=SERVE_PAGE)
        b = ContinuousBatcher(Engine(cfg, device=dev, flags=flags,
                                     target_params=eng.target.params,
                                     draft_params=draft_params_of(eng)),
                              n_slots=SERVE_SLOTS)
        for prompt, budget in zip(SERVE_PROMPTS, SERVE_BUDGETS):
            b.submit(prompt, max_new_tokens=budget)
        return b

    # The contiguous batcher's run is the warm-up and the layout reference.
    contiguous = batcher("contiguous").run()
    paged = batcher("paged")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    results, launches = count_launches(path, paged.run)
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    st = paged.stats.report()
    assert len(results) == len(SERVE_PROMPTS) == st["retired"], "not every request retired"
    ids_digest(path, [r["generated_ids"] for r in sorted(results, key=lambda r: r["req_id"])])
    for r in results:
        lp = torch.tensor(r["token_logprobs"] + r["prompt_logprobs"][1:])
        assert r["generated_tokens"] >= 1 and torch.isfinite(lp).all(), ("bad result", r["req_id"])
    log(f"serving ({label}, paged KV page {SERVE_PAGE}, {SERVE_SLOTS} slots, "
        f"max_seq_len {max_len}): {len(results)} requests, {st['committed_tokens']} "
        f"generated tokens in {st['wall_s']:.3f} s = {st['tok_s']:.2f} tok/s aggregate; "
        f"{st['steps']} steps, {st['admit_waves']} admission waves, mean occupied slots "
        f"{st['mean_occupied_slots']:.2f}, peak memory {peak_mb:.1f} MB")
    graph_report(f"serving ({label})", [(("paged", SERVE_SLOTS, max_len), paged._loop)])
    # The graph path against the host loop in one process, in turns: graph
    # (the counted run above), host, graph.
    turns = {"graph": st["tok_s"]}
    for what, flags in (("host loop", EnvFlags(sync_steps=True)), ("graph again", None)):
        b = batcher("paged", flags)
        again = b.run()
        turns[what] = b.stats.report()["tok_s"]
        for r, a in zip(results, again, strict=True):
            assert r["generated_ids"] == a["generated_ids"], (what, "ids differ", r["req_id"])
    log(f"serving, graph path against the host loop in turns (equal ids): "
        + ", ".join(f"{what} {tps:.2f} tok/s" for what, tps in turns.items()))
    # The ops that round a row differently at another M, or between the
    # decode body and the tensor-core path of A or B (D and F must give the
    # same bits, and A's or B's decode body a row's bits at every M:
    # row_stability asserts both): where two runs of one prompt part, the
    # gap must be a near tie and one of these must have rounded differently.
    stability = row_stability(eng, dev)
    log("row stability (rows of M that differ from the row alone, M = 2/5/8/16/40 (and 63 "
        f"for A or B, asserted 0, as for the norms), and at MMA_MIN_M across A's or B's two "
        f"kernels; {D_VS_F}: rows that differ at S = 1/K+1, asserted 0): "
        + "; ".join(f"{op}: {'/'.join(str(d[m]) for m in sorted(d, key=row_key))}"
                    for op, d in stability.items()))
    unstable = [op for op, d in stability.items() if any(d.values())]

    def parted(what, rid, prompt, ref, ids):
        if ids == ref:
            return 0
        tie = near_tie(eng, dev, prompt, ref, ids)
        log(f"request {rid} differs from {what}: {tie}; ops that round rows differently at "
            f"another M or across A's or B's two kernels: {unstable}")
        assert tie["gap_ulps"] <= 2 and unstable, ("not a near tie at a named op", what, tie)
        return 1

    layout = sum(parted("the contiguous-layout batcher", r["req_id"], prompt,
                        c["generated_ids"], r["generated_ids"])
                 for r, c, prompt in zip(results, contiguous, SERVE_PROMPTS))
    log(f"paged ids == contiguous-layout batcher ids for {len(results) - layout} of "
        f"{len(results)} requests (the rest near ties)")
    # Each request against the B=1 phase's Engine.generate (contiguous, 64
    # new tokens) on its prompt.
    reference = {p: eng.generate(p)["generated_ids"] for p in dict.fromkeys(SERVE_PROMPTS)}
    differ = sum(parted("generate", r["req_id"], prompt,
                        reference[prompt][: len(r["generated_ids"])], r["generated_ids"])
                 for r, prompt in zip(results, SERVE_PROMPTS))
    log(f"serving ids == the start of B=1 generate ids for {len(results) - differ} of "
        f"{len(results)} requests (the rest near ties)")
    if profile:
        profiled = batcher("paged")  # its capture stays out of the profile
        profile_run(f"serving run ({label})", profiled.run, st["wall_s"] * 1e3)
    return launches


# ------------------------------------------------- tree attention (D and F)
def tree_inputs(g, dev, B, H, KVH, T, D, start, int8=False, L=1):
    """q [B, S, H, D] bf16 and keys [L, B, KVH, T, D] (bf16, or int8 with f32
    scales) for the tree's verify chunk at slots start[b] .. start[b] + S - 1
    (TREE_BRANCHING), with POISON in V (int8: bytes and scales) at every
    leaf's slot, which only that leaf may see, and at every slot past the
    chunk; the ancestry mask and the starts on the card."""
    from llm_inference_lab_tpu_torch.core.treespec import TreeConfig

    _, depths, _, anc = TreeConfig(TREE_BRANCHING).build()
    S = len(depths)
    q = torch.randn((B, S, H, D), generator=g, device=dev).bfloat16()
    shape = (L, B, KVH, T, D)
    if int8:
        (k, ks), (v, vs) = int8_kv(g, dev, shape), int8_kv(g, dev, shape)
    else:
        k, v = (torch.randn(shape, generator=g, device=dev).bfloat16() for _ in "kv")
        ks = vs = None
    leaves = [i for i in range(S) if depths[i] == depths.max()]
    for b, c in enumerate(start):
        hidden = [c + i for i in leaves if c + i >= 0] + list(range(max(c + S, 0), T))
        idx = torch.tensor(hidden, device=dev, dtype=torch.long)
        if int8:
            v[:, b, :, idx] = POISON_BYTE
            vs[:, b, :, idx] = POISON_SCALE
        else:
            v[:, b, :, idx] = POISON
    return (q, k, v, ks, vs, torch.from_numpy(anc).to(dev),
            torch.tensor(start, device=dev, dtype=torch.int32))


def tree_mask_of(anc, start, T):
    """The tree's boolean mask [B, 1, S, T] for SDPA (the library yardstick)."""
    from llm_inference_lab_tpu_torch.ops.flash_decode import tree_visible

    return tree_visible(T, anc, start)[:, None]


def sdpa_tree(q, k, v, mask, ks=None, vs=None):
    """SDPA given the tree's boolean mask (timed only, never used); an int8
    cache dequantized to bf16 first."""
    if ks is not None:
        k, v = (k.float() * ks[..., None]).to(q.dtype), (v.float() * vs[..., None]).to(q.dtype)
    out = torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k, v, attn_mask=mask, enable_gqa=True)
    return out.transpose(1, 2)


def tree_bound(anc, start, H, KVH, D, int8=False, extra_bytes=0):
    """Bytes: K and V of the keys [0, start + S) of every sequence (int8: a
    byte a value and 8 bytes of scales a key), q and out bf16, the tree's
    words and starts; operations: 4 D per (query row, visible key), a row
    seeing the keys before its chunk and its ancestors' in it."""
    S = anc.shape[0]
    keys = sum(max(c + S, 0) for c in start.tolist())
    per_key = 2 * D + 8 if int8 else 4 * D
    anc_n = anc.sum(-1).tolist()
    seen = sum(max(c, 0) + n for c in start.tolist() for n in anc_n) * H
    return bound_ms(KVH * keys * per_key + 2 * 2 * len(start) * S * H * D + 4 * S
                    + 4 * len(start) + extra_bytes, 4 * seen * D)


def phase_tree_attention(dev):
    """D's and F's tree variants (the tree's verify chunk, S = 10 at the 3B's
    geometry, 24 / 8 heads of 128): each within check_attn's tolerance of
    its plain version, bf16 and int8, with POISON at every leaf's slot and
    past the chunk (tree_inputs); D at T = 256 (one split) and 4096 (16
    splits, those past the chunk empty), chunks mid-cache, ending at the
    cache's last slot and at slot -1 (an empty batcher slot's); F over
    pages of 16 and 64 through a shuffled table, with D's bits on the same
    keys. Timed beside SDPA given the same boolean mask and the bound: D at
    the B=1 tree path's shapes (T = 256, chunk at P_MAIN), F at the 8-slot
    serving step's (page 64, chunks near 240). Returns {name: numbers of
    one tree step's 28 layers}."""
    from llm_inference_lab_tpu_torch.models.paged import gather_pages
    from llm_inference_lab_tpu_torch.ops.flash_decode import (
        flash_decode_plain,
        flash_decode_tree,
        tree_bits,
    )
    from llm_inference_lab_tpu_torch.ops.paged_flash import paged_flash_plain, paged_flash_tree

    g = torch.Generator(device=dev).manual_seed(21)
    H, KVH = GEOMS[128]
    D, layers = 128, LAYERS[128]
    errs = {}
    for int8 in (False, True):
        name = "_int8" if int8 else ""
        for T in (256, 4096):
            start = [T // 2 + 5, T - TREE_S, -1]
            q, k, v, ks, vs, anc, st = tree_inputs(g, dev, 3, H, KVH, T, D, start, int8)
            sc = (ks[0], vs[0]) if int8 else ()
            got = flash_decode_tree(q, k[0], v[0], anc, st, *sc)
            pos = torch.zeros(q.shape[:2], device=dev, dtype=torch.int32)
            err = check_attn(got, q, k[0], v[0], pos, *sc, what=("flash_decode_tree" + name, T),
                             tree_mask=anc, chunk_start=st)
            errs["flash_decode_tree" + name] = max(errs.get("flash_decode_tree" + name, 0.0), err)
            log(f"flash_decode_tree{name} S={TREE_S} D={D} T={T} chunks at {start}: max_abs_err "
                f"{err:.3g} (POISON at every leaf's slot and past the chunk)")
        for P in (16, 64):
            start = torch.randint(0, SERVE_MAX_LEN - TREE_S, (SERVE_SLOTS,), generator=g,
                                  device=dev).tolist()
            start[1] = -1
            q, k, v, ks, vs, anc, st = tree_inputs(g, dev, SERVE_SLOTS, H, KVH, SERVE_MAX_LEN, D,
                                                   start, int8)
            sc = (ks[0], vs[0]) if int8 else ()
            pools, table = to_pages(g, dev, (k[0], v[0], *sc), P)
            got = paged_flash_tree(q, pools[0], pools[1], table, anc, st, *pools[2:])
            pos = torch.zeros(q.shape[:2], device=dev, dtype=torch.int32)
            err = check_attn(got, q, k[0], v[0], pos, *sc, what=("paged_flash_tree" + name, P),
                             tree_mask=anc, chunk_start=st)
            assert torch.equal(gather_pages(pools[0], table), k[0])
            assert torch.equal(flash_decode_tree(q, k[0], v[0], anc, st, *sc), got), (
                "paged_flash_tree" + name, P, "F != D on the same keys")
            errs["paged_flash_tree" + name] = max(errs.get("paged_flash_tree" + name, 0.0), err)
            log(f"paged_flash_tree{name} B={SERVE_SLOTS} S={TREE_S} D={D} P={P}: max_abs_err "
                f"{err:.3g}; flash_decode_tree's bits on the gathered keys")
    aggs = {}
    for int8 in (False, True):
        name = "_int8" if int8 else ""
        # D: the B=1 tree path's verify call, T = 256, the chunk at P_MAIN.
        per_layer = 2 * KVH * T_MAIN * D * (1 if int8 else 2)
        L = 2 * L2_BYTES // per_layer + 1
        q, k, v, ks, vs, anc, st = tree_inputs(g, dev, 1, H, KVH, T_MAIN, D, [P_MAIN], int8, L=L)
        sc = (lambda i: (ks[i], vs[i])) if int8 else (lambda i: ())
        pos = torch.zeros(q.shape[:2], device=dev, dtype=torch.int32)
        mask = tree_mask_of(anc, st, T_MAIN)
        bits = tree_bits(anc)  # as the forward passes it: once a forward, not a layer
        cyc = Cycle(L)
        ms = median_ms(lambda: flash_decode_tree(q, k[cyc()], v[cyc.i], anc, st, *sc(cyc.i),
                                                 bits=bits))
        plain = median_ms(lambda: flash_decode_plain(q, k[cyc()], v[cyc.i], pos, *sc(cyc.i),
                                                     tree_mask=anc, chunk_start=st), iters=10)
        lib = median_ms(lambda: sdpa_tree(q, k[cyc()], v[cyc.i], mask, *sc(cyc.i)), iters=10)
        b, by = tree_bound(anc, st, H, KVH, D, int8)
        log(f"flash_decode_tree{name} B=1 S={TREE_S} D={D} T={T_MAIN} chunk at {P_MAIN}: "
            f"{ms:.4f} ms  plain {plain:.4f}  library {lib:.4f} (SDPA, boolean mask)  bound "
            f"{b:.5f} ({by})")
        aggs["flash_decode_tree" + name] = dict(
            ms=layers * ms, plain_ms=layers * plain, library_ms=layers * lib,
            bound_ms=layers * b, bound_by=by, max_abs_err=errs["flash_decode_tree" + name])
        del k, v, ks, vs
        # F: the 8-slot serving step's verify call, pages of 64, chunks near 240.
        M = SERVE_MAX_LEN // SERVE_PAGE
        start = [240 + b for b in range(SERVE_SLOTS)]
        q, k, v, ks, vs, anc, st = tree_inputs(g, dev, SERVE_SLOTS, H, KVH, SERVE_MAX_LEN, D,
                                               start, int8)
        pools, table = to_pages(g, dev, (k[0], v[0]) + ((ks[0], vs[0]) if int8 else ()),
                                SERVE_PAGE)
        L = 2 * L2_BYTES // sum(p.numel() * p.element_size() for p in pools) + 1
        pools = [p_.expand(L, *p_.shape).clone() for p_ in pools]
        pos = torch.zeros(q.shape[:2], device=dev, dtype=torch.int32)
        mask = tree_mask_of(anc, st, M * SERVE_PAGE)
        cyc = Cycle(L)
        scp = (lambda i: (pools[2][i], pools[3][i])) if int8 else (lambda i: ())
        bits = tree_bits(anc)
        ms = median_ms(lambda: paged_flash_tree(q, pools[0][cyc()], pools[1][cyc.i], table, anc,
                                                st, *scp(cyc.i), bits=bits))
        plain = median_ms(lambda: paged_flash_plain(q, pools[0][cyc()], pools[1][cyc.i], pos,
                                                    table, *scp(cyc.i), tree_mask=anc,
                                                    chunk_start=st), iters=10)
        gathered = (lambda i: tuple(gather_pages(t[i], table) for t in pools[2:])) if int8 \
            else (lambda i: ())
        lib = median_ms(lambda: sdpa_tree(q, gather_pages(pools[0][cyc()], table),
                                          gather_pages(pools[1][cyc.i], table), mask,
                                          *gathered(cyc.i)), iters=10)
        b, by = tree_bound(anc, st, H, KVH, D, int8, extra_bytes=4 * table.numel())
        log(f"paged_flash_tree{name} B={SERVE_SLOTS} S={TREE_S} D={D} P={SERVE_PAGE} chunks at "
            f"{start[0]}..{start[-1]}: {ms:.4f} ms  plain {plain:.4f}  library {lib:.4f} "
            f"(gather + SDPA, boolean mask)  bound {b:.5f} ({by})")
        aggs["paged_flash_tree" + name] = dict(
            ms=layers * ms, plain_ms=layers * plain, library_ms=layers * lib,
            bound_ms=layers * b, bound_by=by, max_abs_err=errs["paged_flash_tree" + name])
        del pools
    return aggs


def phase_quant_matmul_8b(dev):
    """Kernel A's decode body at Llama-3.1-8B's widths (its projections and
    the untied 128256-token head) at M = 1 to 3 and the decode checks'
    M (qmm_decode); returns the numbers of one EAGLE K=2 step: 32 verify
    layers and the head at M = 3, the head call of the K=2 EAGLE inputs at
    M = 2."""
    g = torch.Generator(device=dev).manual_seed(22)
    rows, max_err = qmm_decode(dev, 4, g, {"Llama-3.1-8B": (QMM_8B, QMM_8B_M)})
    head = [QMM_8B[-1]]
    step = [(QMM_MISTRAL, 3, 32), (head, 3, 1), (head, 2, 1)]
    log_step("quant_matmul_int4", "one Llama-3.1-8B EAGLE K=2 step (32 verify layers and the "
             "head at M = 3, the EAGLE head call at M = 2)", rows, step)
    return sum_rows(rows, calls(step), max_err)


# ------------------------------------------------- Medusa, EAGLE and the tree
def head_rows(eng, dev, B=4):
    """The step's one head call over [B * K, D] rows against one head call a
    draft position ([B, D] each), on a random hidden carry: the rows whose
    logits differ in any bit and the proposals (argmax) that differ. A
    proposal that differs can move acceptance, never the ids
    (verification is exact)."""
    cfg = eng.config
    D = eng.target.config.d_model
    K = cfg.max_draft
    g = torch.Generator(device=dev).manual_seed(23)
    with torch.inference_mode():
        h = torch.randn((B, D), generator=g, device=dev)
        if cfg.draft_mode == "medusa":
            proj = eng._draft_params["medusa_proj"][:K]
            inputs = torch.matmul(h.to(eng.target.config.dtype), proj).transpose(0, 1)
        else:
            h_prev, h_cur, hs = torch.randn((B, D), generator=g, device=dev), h, []
            for _ in range(K):
                h_prev, h_cur = h_cur, h_cur + 0.7 * (h_cur - h_prev)
                hs.append(h_cur)
            inputs = torch.stack(hs, 1).to(eng.target.config.dtype)
        batched = eng.target.head(inputs.reshape(B * K, D)).reshape(B, K, -1)
        per = torch.stack([eng.target.head(inputs[:, i].contiguous()) for i in range(K)], 1)
    return (int((batched != per).any(-1).sum()),
            int((batched.argmax(-1) != per.argmax(-1)).sum()), B * K)


def phase_head_generate(dev, profile, eng, path, label):
    """A head mode (Medusa, EAGLE or the tree) at B=1 on PROMPT: a warm-up
    (the capture), three timed generate calls in one launch count, a greedy
    baseline on the same weights (vanilla, no draft model) timed alike, the
    host loop in turns with the graph path. The ids must equal the
    baseline's exactly, the graph's the host loop's (ids, steps, proposed,
    accepted), and acceptance must be above 0 (asserted; the ids are logged
    when it is not). Logs ms/step, tok/s, tokens a step, acceptance, polls,
    capture ms and graph pool MB, peak memory and kernel launches a
    forward. Returns the launches."""
    from llm_inference_lab_tpu_torch.core.engine import Engine

    eng.generate(PROMPT)  # warm-up, and the decode loop's capture
    loops = engine_loops("B, max_len", eng)
    graph_report(f"generate ({label})", loops)
    torch.cuda.reset_peak_memory_stats()
    runs, launches = count_launches(path, lambda: [eng.generate(PROMPT) for _ in range(3)])
    polls = eng.polls
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    ids = runs[0]["generated_ids"]
    assert all(r["generated_ids"] == ids for r in runs), "repeated runs differ"
    for r in runs:
        lp = torch.tensor(r["token_logprobs"])
        assert len(lp) == r["generated_tokens"] and torch.isfinite(lp).all(), "bad logprobs"
    ids_digest(path, [ids])
    base_eng = Engine(replace(eng.config, draft_mode="vanilla", draft_model=None), device=dev,
                      target_params=eng.target.params)
    base_eng.generate(PROMPT)
    bases = [base_eng.generate(PROMPT) for _ in range(3)]
    assert all(b["generated_ids"] == ids for b in bases), (
        label, "ids differ from the greedy baseline's", ids, bases[0]["generated_ids"])
    r = runs[0]
    per = loops[0][1].per_replay
    kernels = sum(n for name, n in per.items() if name not in ("forwards", "layers"))
    log(f"end to end ({label}, B=1, {eng.config.max_new_tokens} new tokens): {timing(runs)}, "
        f"steps {r['steps']}, {step_stats(runs)}, {polls} polls a generate, capture "
        f"{loops[0][1].capture_s * 1e3:.1f} ms, graph pool {loops[0][1].pool_bytes / 1e6:.1f} MB, "
        f"peak memory {peak_mb:.1f} MB, {kernels / per['forwards']:.1f} kernel launches a "
        f"forward ({kernels} a step of {per['forwards']} forward); baseline (no drafts): "
        f"{timing(bases)}, steps {bases[0]['steps']}; ids == baseline ids; ids {ids}")
    assert r["accepted"] > 0, (label, "accepted no draft on the seed's weights", ids)
    host = host_engine(eng)
    host.generate(PROMPT)
    turns = [e.generate(PROMPT) for e in (host, eng, eng, host)]
    same_decode(label, turns, [r] * 4)
    log(f"graph path against the host loop ({label}, in turns host, graph, graph, host; ids, "
        f"steps, proposed, accepted equal): graph {timing(turns[1:3])}; host loop "
        f"{timing(turns[::3])}")
    if profile:
        profile_run(f"generate ({label})", lambda: eng.generate(PROMPT),
                    statistics.median(r["latency_ms"] for r in runs))
    return launches


def phase_eagle(dev, profile, path):
    """Phase 12: EAGLE at the JAX package's eagle_8b_int4 (EAGLE_CFG):
    phase_head_generate, and the batched head call against one a position."""
    from llm_inference_lab_tpu_torch.config import EngineConfig
    from llm_inference_lab_tpu_torch.core.engine import Engine

    t0 = time.perf_counter()
    eng = Engine(EngineConfig(**EAGLE_CFG), device=dev)
    torch.cuda.synchronize()
    log(f"engine init (random int4 Llama-3.1-8B on the card): {time.perf_counter() - t0:.1f} s")
    launches = phase_head_generate(dev, profile, eng, path, "Llama-3.1-8B int4 EAGLE K=2")
    logits, props, n = head_rows(eng, dev)
    log(f"EAGLE head call, batched ([B*K, D]) against one a position ([B, D]): {logits} of {n} "
        f"rows differ in some logit, {props} proposals differ")
    return launches


def phase_heads(dev, eng, profile, paths):
    """Phase 13 on phase 3's int4 3B target (eng: phase 3's engine; no draft
    model): Medusa at K=4 with identity heads and the tree TREE_BRANCHING,
    each through phase_head_generate; then phase 3b's requests through the
    8-slot paged batcher with the tree and with Medusa (phase_serving: each
    request's ids the start of that mode's B=1 ids under the near-tie rule);
    then self_distill_medusa (DISTILL: 2 heads, PROMPT's three shortest
    serving prompts, 30 steps) under DISTILL_CAP_S: the loss must fall;
    Medusa's acceptance is logged before and after."""
    from llm_inference_lab_tpu_torch.core.engine import Engine
    from llm_inference_lab_tpu_torch.core.head_training import self_distill_medusa

    def engine(**kw):
        return Engine(replace(eng.config, draft_model=None, **kw), device=dev,
                      target_params=eng.target.params)

    launches = {}
    medusa = engine(draft_mode="medusa", max_draft=MEDUSA_K)
    launches[paths[0]] = phase_head_generate(dev, profile, medusa, paths[0],
                                             f"3B int4 Medusa K={MEDUSA_K} tie heads")
    logits, props, n = head_rows(medusa, dev)
    log(f"Medusa head call, batched ([B*K, D]) against one a position ([B, D]): {logits} of "
        f"{n} rows differ in some logit, {props} proposals differ")
    tree = engine(draft_mode="tree", tree={"branching": list(TREE_BRANCHING)})
    launches[paths[1]] = phase_head_generate(dev, profile, tree, paths[1],
                                             f"3B int4 tree {list(TREE_BRANCHING)}")
    launches[paths[2]] = phase_serving(dev, tree, profile, SERVE_MAX_LEN, paths[2],
                                       f"3B int4 tree {list(TREE_BRANCHING)}")
    launches[paths[3]] = phase_serving(dev, medusa, profile, SERVE_MAX_LEN, paths[3],
                                       f"3B int4 Medusa K={MEDUSA_K}")
    before = medusa.generate(PROMPT)
    t0 = time.perf_counter()
    _, hist = self_distill_medusa(medusa, sorted(set(SERVE_PROMPTS), key=len)[:3], **DISTILL)
    torch.cuda.synchronize()
    took = time.perf_counter() - t0
    after = medusa.generate(PROMPT)
    log(f"self_distill_medusa ({DISTILL}): {took:.1f} s (cap {DISTILL_CAP_S} s), loss "
        f"{[round(x, 4) for x in hist]}; Medusa K={MEDUSA_K} acceptance before "
        f"{before['acceptance_rate']:.4f}, after {after['acceptance_rate']:.4f}; ids unchanged")
    assert hist[-1] < hist[0], ("self-distillation's loss did not fall", hist)
    assert took <= DISTILL_CAP_S, ("self-distillation outran its cap", took)
    assert after["generated_ids"] == before["generated_ids"], "trained heads changed the ids"
    return launches


def profile_run(what, fn, latency_ms):
    """Kernel time by name over one profiled call of fn, and the device's
    busy share: the union of the kernels' intervals over the latency of an
    unprofiled call (latency_ms; the profiler slows the host, not the
    kernels). GPU-side annotations of PyTorch ops are left out: they would
    count their kernels twice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        log("profile: no device time recorded (not measured)")
        return
    busy_us, end = 0.0, float("-inf")
    for s, e in sorted((k.time_range.start, k.time_range.end) for k in kernels):
        busy_us += max(0.0, e - max(s, end))
        end = max(end, e)
    by_name = {}
    for k in kernels:
        t, n = by_name.get(k.name, (0.0, 0))
        by_name[k.name] = (t + k.time_range.elapsed_us(), n + 1)
    log(f"profile: {len(kernels)} kernels in one {what}, busy {busy_us / 1e3:.1f} ms; "
        f"wall {wall_ms:.1f} ms with the profiler, {latency_ms:.1f} ms without; "
        f"busy share {busy_us / 1e3 / latency_ms:.3f}")
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        log(f"  {t / 1e3:9.3f} ms  {n:6d} calls  {name[:90]}")
    ops = [e for e in prof.key_averages() if e.device_type == DeviceType.CPU]
    log("profile: host time by op (self, with the profiler's own overhead)")
    for e in sorted(ops, key=lambda e: -e.self_cpu_time_total)[:12]:
        log(f"  {e.self_cpu_time_total / 1e3:9.3f} ms  {e.count:6d} calls  {e.key[:90]}")


def main(argv):
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA card",
              file=sys.stderr)
        return 2
    from llm_inference_lab_tpu_torch import build

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}; device {kind}")
    # The head's f32 logits (ops/quant.py f32_logits) need cuBLAS's bf16
    # product with an f32 output: without it the run would carry on with
    # logits of another precision than the reference's.
    if not torch._C._dispatch_has_kernel_for_dispatch_key("aten::mm.dtype", "CUDA"):
        raise RuntimeError("this torch has no CUDA aten::mm.dtype: the head cannot give f32 logits")
    a = torch.randn((3, 64), device=dev).bfloat16()
    b = torch.randn((64, 5), device=dev).bfloat16()
    y = torch.mm(a, b, out_dtype=torch.float32)
    assert y.dtype == torch.float32 and torch.allclose(y, a.float() @ b.float(), atol=1e-4), y
    log("aten::mm.dtype on CUDA: bf16 x bf16 -> f32 logits")

    t0 = time.perf_counter()
    reports = build.build_all()
    log(f"build: {len(reports)} kernel libraries in {time.perf_counter() - t0:.1f} s")
    for name, out in reports.items():
        entry = ""
        for line in out.splitlines():
            if "Compiling entry function" in line:  # the mangled name carries D and the type
                entry = line.split("'")[1][:72] if "'" in line else line.strip()
            if "Used" in line or "spill" in line:
                log(f"  ptxas {name} {entry}: {line.strip()}")

    step = "one K=1 decode step (all of its calls at the B=1 main path's shapes)"
    step8 = "one K=4 decode step of the int8 B=1 path (4 x 16 draft layers, 28 verify layers)"
    wave = "one admission wave (G=4 prompts of P=256, both models' layers)"
    # name: (numbers, csrc file, the Pallas kernel it replaces, unit of work)
    t0 = time.perf_counter()
    qmm4_step, qmm4_prefill = phase_quant_matmul(dev)
    kernels = {
        "quant_matmul_int4": (qmm4_step, "qmm_decode.cuh", "ops/pallas/quant_matmul.py:76",
                              step),
        "quant_matmul_int4_mma": (
            qmm4_prefill, "qmm_mma.cuh", "ops/pallas/quant_matmul.py:76",
            "the Mistral-7B long prompt's prefill projections through one model: 11 chunks of "
            "512 rows through 32 layers and the int4 head"),
        "flash_decode": (phase_flash_decode(dev), "flash_decode.cu",
                         "ops/pallas/flash_decode.py:146", step),
        "flash_prefill": (phase_flash_prefill(dev), "flash_prefill.cu",
                          "ops/pallas/flash_prefill.py:86", wave),
        "paged_flash": (phase_paged_flash(dev), "paged_flash.cu", "ops/pallas/paged_flash.py:82",
                        "one K=1 decode step of the 8-slot serving batch (both models' layers)"),
        "verify_prefix": (phase_verify_prefix(dev), "verify_prefix.cu",
                          "ops/pallas/verify_pallas.py:46", step),
    }
    # No Pallas kernel: JAX's rms_norm is plain jnp (transformer.py:29), and
    # the residual add before each later norm too (transformer.py:424-435).
    norm_row, add_row = phase_rms_norm(dev)
    kernels |= {
        "rms_norm": (norm_row, "rms_norm.cu", "models/transformer.py:29",
                     step + ": the first norm of each forward"),
        "add_rms_norm": (add_row, "rms_norm.cu", "models/transformer.py:424",
                         step + ": the residual add and the norm after it, 2 a layer"),
    }
    qmm8_step, qmm8_prefill, qmm8_ngram = phase_quant_matmul_int8(dev)
    kernels |= {
        "quant_matmul_int8": (qmm8_step, "qmm_decode.cuh", "ops/pallas/quant_matmul.py:58",
                              step8),
        "quant_matmul_int8_mma": (
            qmm8_prefill, "qmm_mma.cuh", "ops/pallas/quant_matmul.py:58",
            "one admission wave of 8 prompts of 256 rows (M = 2048) through the int8 3B's 28 "
            "and the 1B's 16 layers"),
        "flash_decode_int8": (phase_flash_decode_int8(dev), "flash_decode.cu",
                              "ops/pallas/flash_decode.py:203", step8),
        "flash_prefill_int8": (phase_flash_prefill_int8(dev), "flash_prefill.cu",
                               "ops/pallas/flash_prefill.py:142", wave + ", int8 scratch"),
        "paged_flash_int8": (phase_paged_flash_int8(dev), "paged_flash.cu",
                             "ops/pallas/paged_flash.py:171",
                             "one K=4 decode step of the 8-slot int8 serving batch"),
    }
    gemma = phase_gemma_attention(dev)
    ring = phase_ring_attention(dev)
    kernels.update({
        "flash_decode/gemma-2": (
            gemma["flash_decode"], "flash_decode.cu", "ops/pallas/flash_decode.py:146",
            "one K=1 decode step of the Gemma-2 long-prompt path (p=4352, T=4480: 26 draft "
            "layers at S=1, 42 verify layers at S=2, half of each windowed)"),
        "flash_prefill/gemma-2": (
            gemma["flash_prefill"], "flash_prefill.cu", "ops/pallas/flash_prefill.py:86",
            "the Gemma-2 long prompt's prefill (S=4320, T=4480) through 26 + 42 layers, half "
            "windowed"),
        "paged_flash/gemma-2": (
            gemma["paged_flash"], "paged_flash.cu", "ops/pallas/paged_flash.py:82",
            "one K=1 decode step of the 8-slot Gemma-2 serving batch (26 + 42 layers)"),
    })
    ring_step = ("one K=4 decode step of the Mistral-7B long-prompt path on the ring (p=5400, "
                 "R=T=4736: 4 x 32 draft layers at S=1, 32 verify layers at S=5)")
    ring_prefill = ("the Mistral-7B long prompt's prefill on the ring (11 chunks of 512, R=T=4736) "
                    "through the 32 layers of one model")
    kernels.update({
        "flash_decode/ring": (ring["flash_decode"], "flash_decode.cu",
                              "ops/pallas/flash_decode.py:146", ring_step),
        "flash_prefill/ring": (ring["flash_prefill"], "flash_prefill.cu",
                               "ops/pallas/flash_prefill.py:86", ring_prefill),
        "flash_decode_int8/ring": (ring["flash_decode_int8"], "flash_decode.cu",
                                   "ops/pallas/flash_decode.py:203", ring_step + ", int8 KV"),
        "flash_prefill_int8/ring": (ring["flash_prefill_int8"], "flash_prefill.cu",
                                    "ops/pallas/flash_prefill.py:142",
                                    ring_prefill + ", int8 KV"),
    })
    ngram_step = f"one ngram K={NGRAM_K} B=1 step of the int8 3B (28 verify layers at S = 13)"
    ngram_rows = phase_ngram_shapes(dev)
    kernels.update({
        "quant_matmul_int8/ngram": (qmm8_ngram, "qmm_decode.cuh", "ops/pallas/quant_matmul.py:58",
                                    ngram_step + ", M = 13"),
        "flash_decode/ngram": (ngram_rows["flash_decode"], "flash_decode.cu",
                               "ops/pallas/flash_decode.py:146", ngram_step + ", T = 256"),
        "verify_prefix/ngram": (ngram_rows["verify_prefix"], "verify_prefix.cu",
                                "ops/pallas/verify_pallas.py:46",
                                ngram_step + f": C at [1, {NGRAM_K}, 128256]"),
    })
    phase_sampling_ops(dev)
    tree_rows = phase_tree_attention(dev)
    tree_step = (f"one tree {list(TREE_BRANCHING)} B=1 step of the 3B (28 verify layers at "
                 f"S = {TREE_S}, T = {T_MAIN})")
    tree_serve = (f"one tree {list(TREE_BRANCHING)} step of the 8-slot serving batch (28 "
                  f"layers at S = {TREE_S}, page {SERVE_PAGE})")
    kernels.update({
        "flash_decode_tree": (tree_rows["flash_decode_tree"], "flash_decode_tree.cu",
                              "ops/attention.py:94", tree_step),
        "flash_decode_tree_int8": (tree_rows["flash_decode_tree_int8"], "flash_decode_tree.cu",
                                   "ops/attention.py:94", tree_step + ", int8 KV"),
        "paged_flash_tree": (tree_rows["paged_flash_tree"], "paged_flash_tree.cu",
                             "ops/paged_attention.py:31", tree_serve),
        "paged_flash_tree_int8": (tree_rows["paged_flash_tree_int8"], "paged_flash_tree.cu",
                                  "ops/paged_attention.py:31", tree_serve + ", int8 KV"),
        "quant_matmul_int4/8b": (phase_quant_matmul_8b(dev), "qmm_decode.cuh",
                                 "ops/pallas/quant_matmul.py:76",
                                 "one Llama-3.1-8B EAGLE K=2 B=1 step (32 verify layers and the "
                                 "head at M = 3, the EAGLE head call at M = 2)"),
    })
    log(f"phase 2 took {time.perf_counter() - t0:.1f} s")
    profile = "--profile" in argv
    profile_gemma = profile or "--profile=gemma" in argv
    profile_mistral = profile or "--profile=mistral" in argv
    profile_sampling = profile or "--profile=sampling" in argv
    profile_heads = profile or "--profile=heads" in argv
    paths = list(PATH_KERNELS)
    on_path = {}
    t0 = time.perf_counter()
    eng, on_path[paths[0]] = phase_end_to_end(dev, profile, INT4_CFG, paths[0],
                                              "3B int4 + 1B draft, K=1")
    log(f"phase 3 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    on_path[paths[1]] = phase_serving(dev, eng, profile, SERVE_MAX_LEN, paths[1],
                                      "3B int4 + 1B draft, K=1")
    log(f"phase 3b took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    on_path.update(phase_sampling(dev, eng, profile_sampling, [
        path for path in paths if path.startswith(("generate int4 sampled", "generate int4 greedy"))]))
    log(f"phase 11 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    on_path.update(phase_heads(dev, eng, profile_heads, HEAD_PATHS))
    log(f"phase 13 took {time.perf_counter() - t0:.1f} s")
    del eng
    t0 = time.perf_counter()
    eng, on_path[paths[2]] = phase_end_to_end(dev, profile, INT8_CFG, paths[2],
                                              "3B int8 + 1B draft, K=4, int8 KV")
    phase_kv_alignment(eng)
    log(f"phase 4 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    on_path[paths[3]] = phase_serving(dev, eng, profile, INT8_MAX_LEN, paths[3],
                                      "3B int8 + 1B draft, K=4, int8 KV")
    log(f"phase 5 took {time.perf_counter() - t0:.1f} s")
    del eng
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    eng, on_path[NGRAM_PATHS[0]] = phase_ngram(dev, profile, NGRAM_PATHS[0])
    on_path[NGRAM_PATHS[1]] = phase_serving(dev, eng, profile, SERVE_MAX_LEN, NGRAM_PATHS[1],
                                            f"3B int8 ngram K={NGRAM_K}")
    log(f"phase 10 took {time.perf_counter() - t0:.1f} s")
    del eng
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    on_path[EAGLE_PATHS[0]] = phase_eagle(dev, profile_heads, EAGLE_PATHS[0])
    torch.cuda.empty_cache()
    log(f"phase 12 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    label = "Gemma-2 9B int4 + 2B draft, K=1"
    eng, on_path[paths[4]] = phase_end_to_end(dev, profile_gemma, GEMMA_CFG, paths[4], label)
    on_path[paths[5]] = phase_long_prompt(dev, eng, paths[5])
    log(f"phase 6 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    on_path[paths[6]] = phase_serving(dev, eng, profile_gemma, SERVE_MAX_LEN, paths[6], label)
    log(f"phase 7 took {time.perf_counter() - t0:.1f} s")
    del eng
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    eng, on_path[paths[7]] = phase_end_to_end(dev, profile_mistral, MISTRAL_CFG, paths[7],
                                              "Mistral-7B int4 + 7B draft, K=4, ring")
    lens = (eng.target.config.kv_ring_len, eng.draft.config.kv_ring_len)
    assert lens == (RING_LEN, RING_LEN), ("ring lengths", lens)
    on_path.update(phase_mistral_long(dev, eng, paths[8:13]))
    log(f"phase 8 took {time.perf_counter() - t0:.1f} s")

    def counted(name):
        """The paths whose launches a row counts: a Gemma-2 row its paths, a
        ring row the Mistral ring paths, an ngram row the phase-10 paths, an
        8b row the phase-12 path, the bf16 D, E and F rows the other Llama
        paths, the int8 ones the Llama and Gemma-2 paths (none launch
        there), every other row all (less the phase-10 and phase-12 paths
        where the kernel has a row of theirs)."""
        if name.endswith("/gemma-2"):
            return GEMMA_PATHS
        if name.endswith("/ring"):
            return RING_PATHS
        if name.endswith("/ngram"):
            return NGRAM_PATHS
        if name.endswith("/8b"):
            return EAGLE_PATHS
        rest = [path for path in paths
                if (f"{name}/ngram" not in kernels or path not in NGRAM_PATHS)
                and (f"{name}/8b" not in kernels or path not in EAGLE_PATHS)]
        if name in ("flash_decode", "flash_prefill", "paged_flash"):
            return [path for path in rest if path not in GEMMA_PATHS + MISTRAL_PATHS]
        if name in ("flash_decode_int8", "flash_prefill_int8", "paged_flash_int8"):
            return [path for path in rest if path not in MISTRAL_PATHS]
        return rest

    line = {"kernels": [
        {"name": name, "route": "cuda",
         "source": f"llm_inference_lab_tpu_torch/csrc/{src}",
         "replaces": f"llm_inference_lab_tpu/{where}",
         "launches": sum(on_path[path][name.split("/")[0]] for path in counted(name)),
         "launches_by_path": {path: on_path[path][name.split("/")[0]] for path in counted(name)},
         "max_abs_err": agg["max_abs_err"],
         "ms": agg["ms"], "plain_ms": agg["plain_ms"], "bound_ms": agg["bound_ms"],
         "bound_by": agg["bound_by"], "library_ms": agg["library_ms"], "per": per}
        for name, (agg, src, where, per) in kernels.items()]}
    log(f"whole run took {time.perf_counter() - T_START:.1f} s")
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
