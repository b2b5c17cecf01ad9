#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (llm_inference_lab_tpu_torch) on one
NVIDIA card: the quickest proof that the port builds and runs on the GPU.

    python3 chip_smoke.py                    # phases 0-25, last line a JSON result
    python3 chip_smoke.py --profile          # also a torch.profiler breakdown of runs
    python3 chip_smoke.py --profile=gemma    # the breakdown of the Gemma-2 runs only
    python3 chip_smoke.py --profile=mistral  # the breakdown of the Mistral B=1 run only
    python3 chip_smoke.py --profile=sampling # the breakdown of phase 11's sampled run only
    python3 chip_smoke.py --profile=heads    # the breakdown of phases 12 and 13's runs only
    python3 chip_smoke.py --profile=server   # the breakdown of phase 16's sampled step only

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
    decode checks' M, timed beside its bound and library call; and E at
    phase 14's prefix-cached admissions (phase_prefix_prefill): a suffix's
    queries from position 1024 over one sequence's gathered pages (T =
    2048), within check_attn's tolerance and the bits of E over the same
    keys laid out contiguously, a layer's gather timed beside E; and kernel
    A's f32-output instantiation (the EmbedQuant4 tied head) at N = 128,256
    and K = 3072 and 2048, M = 1, 2, 5 and 104 (both bodies): within the
    f32 summation bound of its plain version, the bf16 kernel's output its
    rounding bit for bit, timed beside the library call;
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
14. admission on phase 3's engine (run after phase 13), paged with pages
    of 64, ids held to phase 3's B=1 ids (or the other run's) under the
    near-tie rule: (a) phase 3b's 16 requests through 8 slots over a pool
    of about half the eager worst case, eager reservation and lazy pages
    (lazy must grow pages and preempt; every page comes back); (b) a
    1024-token system prompt ahead of each sentence (lanes of 2048),
    prefix caching off and on (on: every request after the first reuses
    pages); (c) a 3000-token prompt admitted in chunks of 512 while 7
    requests decode (decode steps run during it; its ids equal a B=1
    generate's), then a decoding request cancelled (finish_reason
    "cancelled", pages returned); tok/s, occupancy, steps, waves,
    admit_ms and peak memory logged for each run;
15. Mistral-7B served over the ring (run after phase 8, on its engine with
    admit_chunk 512: R stays 4736): 4 slots, two 5400-token prompts and six
    sentences; each long prompt admitted incrementally into a ring-sized
    scratch with decode steps between its chunks; ids == phase 8's ring B=1
    ids under the near-tie rule; tok/s, occupancy, admit_ms, the ring's KV
    MB and the full cache's logged;
16. the OpenAI server on phase 3's weights (run after phase 14; the port's
    server/serving.py with per-request sampling and the top-5 capture, 8
    paged slots, on 127.0.0.1 port 0, client threads over the loopback):
    (a) phase 3b's 16 requests at temperature 0, 8 in flight, each text its
    ids' and the ids phase 3's B=1 ids under the near-tie rule; (b) 8
    seeded sampled requests alone and among other traffic give the same
    ids, another seed others; (c) frequency_penalty 1e4 repeats no token,
    logit_bias +100 forces its id and -100 bans phase 3's repeated token;
    (d) stream == non-stream, a stop string cuts the text and frees the
    slot early; (e) top_logprobs 5 has the greedy token first, sorted;
    HTTP tok/s against a direct batcher's, the server's loop_ms, a step's
    device ms static against per-request (every row greedy, every row
    sampled) and the per-request ops' ms logged;
17. the Qwen2.5 pair at the JAX package's configs/qwen25_pair.yaml (7B
    target, 0.5B draft, int8 weights and embedding, K=4, greedy
    longest_prefix; random int8 bytes): phase 3's B=1 checks (graph ids ==
    host-loop ids == baseline ids, a self-drafted run accepts) and phase
    3b's serving checks; B at N = 896, 1152 and 151,936, C at V = 151,936,
    D, E and F at the GQA group of 7;
21. (on phase 17's engine) save_params of the int8 0.5B and load_params
    onto the card, every leaf byte-equal and one forward's logits equal;
    then a bf16 0.5B written as an HF snapshot (the port's safetensors
    writer, HF's names, a config.json from the preset) under a temporary
    HF_HOME: an Engine given no weights finds it, its weights_source is the
    snapshot and its ids equal an engine given the same weights;
18. Phi-3-mini-4k-instruct, int4 projections and head (A at N = 32,064),
    ngram K=4 on a 2385-token prompt (the window of 2047 binds in prefill
    and decode; D, E and F at head dim 96): phase 10's checks (acceptance
    > 0), then phase 3b's serving checks;
19. Mixtral-8x7B at full width, 16 of its 32 layers (32 bf16 layers are
    93 GB, more than the card's 80), bf16, ngram K=4 at B=1: phase 10's
    checks, then the MoE block's ms a forward against the dense bound (all
    8 experts read) and the routed bound (only the experts routed);
20. gpt2 and opt-125m (configs/baseline.yaml, configs/opt_baseline.yaml),
    bf16, no draft, full depth: phase 3's B=1 checks and phase 3b's
    serving checks (LayerNorm is plain ops: no norm kernel on these paths);
    phase 2 holds A and B at the tail widths (N = 896, 1152, 32,064,
    151,936; M = 1, 5, 64, 256) and times them at phases 17 and 18's
    steps, D, E and F at head dim 96 with the window of 2047 and at group
    7, and C at both vocabularies (rows "/qwen2.5" and "/phi3");
22. (after phase 16, on phase 3's weights) grammar-constrained decoding and
    forced tool calls: one engine a grammar (constrain json, json_object,
    json_schema, regex; tools), each compiling its tables (compile s and
    table MB logged); B=1 generate under every key, each output walked by
    the port's automaton and checked independently (json.loads, the
    schema's fields, re.fullmatch, the tool's name and arguments), its ids
    the constrained baseline's and the host loop's; an unconstrained call
    on a table engine gives phase 3's ids; the step ms of the constrained
    graph against the unconstrained one on the same engine and state, and
    the grammar's ops against their bound; phase 3b's batcher with
    constrained and free requests mixed (the free ones phase 3b's ids, all
    free on a table engine exactly phase 3b's); the server with
    response_format json_schema, guided_regex, tool_choice required, a
    named and a streamed named tool call; Medusa K=4 and (after phase 10)
    ngram K=12 under json_schema;
23. (after phase 22, on phase 3's weights) multi-LoRA, embeddings and the
    int4 embedding: (a) three rank-16 adapters on q, k, v, o, gate, up and
    down at full width (numpy seeds) in one pack: B=1 generate of the base
    (phase 3's ids) and of each adapter, each adapter biting on the first
    step's logits; a bf16 3B with one adapter against its merged weights;
    phase 3b's requests with the adapters round-robin, each its own B=1
    generate's ids; phase 14's system prompt under two adapters, prefix
    caching off and on (equal ids, pages hit only within an adapter);
    Medusa K=4 under an adapter (== the baseline under it); the server's
    /v1/models, `model` routing and 404; the step's device ms with and
    without the pack, base rows against adapted rows; (b) Engine.embed of
    64 texts of 9-135 tokens, mean and last (norms 1, each alone against
    its batch row), and /v1/embeddings (float == base64); (c) the main path
    with embed_bits=4 (the tied head through kernel A's f32 instantiation,
    held in phase 2 at the heads' widths and rows): B=1 generate in turns
    with phase 3's engine, graph == host loop, spec == baseline, phase 3b's
    batcher, and the table's checkpoint round trip;
24. (after phase 23, on phase 3's weights; (c) after phase 10 on its
    engine) JAX's pipelined serving loop, 8 paged slots of page 64: (a)
    phase 3b's 16 requests through run() in turns with the synchronous
    order (step_chunk(POLL_EVERY), _retire_finished(), _admit_pending()):
    tok/s, the report and the trace rows, ids equal to each other and to
    B=1 generate's under the near-tie rule; the chunk cost model's fit;
    (b) 32 staggered requests (budgets 16-128, two submitted after every
    chunk, JAX's server-loop order) with overlap_admit and fused_admit off
    and on, in turns: tok/s, the admit, poll-wait and retire shares, the
    admission calls' CUDA-event spans, the replays' device ms and the
    card's busy share, equal ids (near ties allowed); (c) both adaptive controllers in
    the ngram K=12 batcher: the K trajectory, ids equal to the fixed-K
    batcher's (near ties allowed); (d) phase 16's HTTP clients over the
    loop in turns with the direct batcher; (e) Engine.profile_phases on
    phase 3's engine (each phase a CUDA graph's replays), and a profiled
    generate whose phase_ms has no error;
 25. (after phase 5) the bench harness and the CLI at phase 3's main path
    (int4 3B + 1B, K=1, the int8 embedding and tied head): (a) `cli run`
    in two subprocesses, on configs/llama32_pair.yaml with phase 3's
    settings as flags and on configs/llama32_int8.yaml with phase 4's,
    each text equal to its phase's; (b) run_k_sweep for K = 1-4 over
    PROMPT_SUITE (B = 10), one iteration: every K a success with no
    error, one capture a K (the warm-up's shape replayed), tok/s,
    aggregate tok/s, step ms and each K's set-up seconds apart; (c)
    compare_to_baseline on bench.py's prompt; (d) run_stress, 200 requests
    of churn through 8 paged slots: every request completed and non-empty,
    latency degradation under JAX's 2.5, RSS and device-memory growth;
    (e) the perplexity of the 3B in bf16, int8 and int4 (quantized_clone)
    over 4 rows of 512 ids from the seed, each finite and above 1, the
    deltas and a forward's ms; (f) `cli serve` in a subprocess on a free
    port and BenchmarkRunner(mode="http") against it (healthy, every
    request a success; the subprocess killed in a finally);
 9. the kernels' JSON line (every kernel, launches by path; the Gemma-2
    variants of D, E and F, the ring variants of D and E, the ngram
    verify shapes of B, D and C, D's and F's tree variants and A at the 8B
    widths on rows of their own), then the result line.

Every B=1 and serving path (phases 3-8, 10-23) decodes through the decode
loop of core/specstep.py: CUDA-graph replays of the step, captured once a
shape (the host adaptive controller: a one-step graph a K).
count_launches adds each replay's captured launches to the wrappers' eager
counts (and the captured forwards and layers to the eager ones), and
asserts that the path replayed, that no wrapper's count moves across a
chunk of replays and that no decode-only kernel launched eagerly outside a
capture's warm-up step and a batcher's admission work (counted apart).
Each path of phases 3-13 runs once more on the host loop
(EnvFlags(sync_steps=True)) in the same process, in turns with the graph
runs: ids, steps, proposed and accepted must be equal, and both timings
are logged, with each capture's time and graph pool memory.

Without CUDA it exits non-zero before printing any result.
"""

import gc
import hashlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
import weakref
from dataclasses import replace

import torch

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate
SPIN_CYCLES_PER_S = 1.98e9  # H100 SXM top SM clock: a spin lasts at least this long
L2_BYTES = 50 << 20
ROOT = os.path.dirname(os.path.abspath(__file__))  # the checkout: phase 25's subprocesses run here
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
# Phase 14 (a)'s run() turn takes this many pages fewer than the synchronous
# order's pool (17 pages): at 17, run() grows pages twice and preempts
# nothing (it grows from lengths a chunk old and retires exactly); at 13 it
# must preempt (asserted).
RUN_POOL_CUT = 4
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
# Phase 14 (admission on phase 3's engine): (b) a system prompt of
# PREFIX_TOKENS byte tokens (16 pages of 64) ahead of phase 3b's sentences,
# lanes of PREFIX_MAX_LEN; (c) one prompt of 3000 byte tokens admitted in
# chunks of ADMIT_CHUNK beside 7 decoding requests, lanes of ADMIT_MAX_LEN.
SYSTEM_PREFIX = ("You are the help desk of a small bookshop. Answer in short plain sentences, "
                 "name the shelf where a book stands, and say so when you do not know. "
                 * 8)[:1024]
PREFIX_TOKENS, PREFIX_MAX_LEN = 1024, 2048
LONG_ADMIT = (PROMPT * 23)[:3000]
ADMIT_CHUNK, ADMIT_MAX_LEN = 512, 4096
# Phase 15: Mistral-7B served over the ring: 4 slots, two of phase 8's
# 5400-token prompts and six of phase 3b's sentences.
RING_SLOTS = 4
RING_REQUESTS = [(MISTRAL_LONG, 64), (MISTRAL_LONG, 64)] + [
    (SERVE_PROMPTS[i], SERVE_BUDGETS[i]) for i in range(6)]
# Phase 16: the OpenAI server (server/serving.py) on phase 3's weights with
# per-request sampling and the top-5 capture, 8 paged slots, pages of 64;
# (b)'s seeded requests sample under these filters.
SERVER_CFG = dict(per_request_sampling=True, logprobs_topk=5, kv_layout="paged",
                  kv_page_size=SERVE_PAGE, max_seq_len=SERVE_MAX_LEN)
SERVER_SAMPLING = dict(temperature=0.8, top_k=50, top_p=0.9, min_p=0.05)
SERVER_CLIENTS = 8  # client threads posting (a)'s 16 requests: 8 in flight
SERVER_BUDGET = 32  # new tokens of (b)-(e)'s requests
BIAS_ID = 12345  # (c): the id a +100 logit_bias forces
# Phase 17: the JAX package's configs/qwen25_pair.yaml (Qwen2.5-7B target,
# 0.5B draft, int8 weights, the int8 embedding and the 0.5B's tied head,
# K=4, greedy longest_prefix), random int8 bytes from the seed.
QWEN_CFG = dict(base_model="qwen2.5-7b", draft_model="qwen2.5-0.5b", max_draft=4,
                max_new_tokens=64, max_seq_len=512, quantization="int8", quantized_init=True,
                quantize_embed=True, policy="longest_prefix", seed=0)
QWEN_GEOMS = {"0.5b": (14, 2, 64, 24), "7b": (28, 4, 128, 28)}  # H, KVH, head dim, layers
QMM_QWEN_05 = [(896, 1152), (896, 896), (896, 9728), (4864, 896)]
QMM_QWEN_7 = [(3584, 4608), (3584, 3584), (3584, 37888), (18944, 3584)]
QWEN_HEAD = (3584, 151936)  # the 7B's untied int8 head (B); the 0.5B's is the tied int8 table
QWEN_V = 151936
# Phase 18: Phi-3-mini-4k-instruct, int4 projections and head (A at N =
# 32064), bf16 embedding, ngram K=4 (no draft in the registry shares its
# vocabulary), on a prompt of 2385 byte tokens, past the window of 2047.
PHI_CFG = dict(base_model="phi-3-mini-4k-instruct", draft_model=None, draft_mode="ngram",
               max_draft=4, max_new_tokens=64, max_seq_len=4096, quantization="int4",
               quantized_init=True, seed=0)
PHI_PROMPT = "The quick brown fox jumps over the lazy dog. " * 53  # 2385 byte tokens
PHI_GEOM = (32, 32, 96, 32)  # H, KVH, head dim, layers
PHI_WINDOW = 2047
QMM_PHI = [(3072, 9216), (3072, 3072), (3072, 16384), (8192, 3072)]
PHI_HEAD = (3072, 32064)
PHI_V = 32064
# Phase 19: Mixtral-8x7B at full width in bf16, 16 of its 32 layers (32
# layers of bf16 weights are 93 GB; 16 are 47 GB of the card's 80), ngram
# K=4, B=1. The cut preset is registered under MIXTRAL_CUT for the run.
MIXTRAL_LAYERS = 16
MIXTRAL_CUT = f"mixtral-8x7b-{MIXTRAL_LAYERS}-layers"
MIXTRAL_CFG = dict(base_model=MIXTRAL_CUT, draft_model=None, draft_mode="ngram", max_draft=4,
                   max_new_tokens=64, max_seq_len=512, seed=0)
# Phase 20: the JAX package's non-speculative baselines, bf16, at full depth
# (configs/baseline.yaml's gpt2, configs/opt_baseline.yaml's opt-125m).
BASELINE_CFGS = {name: dict(base_model=name, draft_model=None, max_new_tokens=64,
                            max_seq_len=512, seed=0) for name in ("gpt2", "opt-125m")}
# Phase 22: grammar-constrained decoding on phase 3's weights, one engine a
# grammar (constrain json, json_object, json_schema, regex; tools), with the
# keys generate is called with (GRAMMAR_KEYS; the first is the engine's
# main key). The schema, the regex and the tools are finite: their outputs
# end in EOS well inside 64 tokens; generic json may run to the budget.
GRAMMAR_SCHEMA = {"type": "object", "properties": {
    "ok": {"type": "boolean"}, "mode": {"enum": ["fast", "safe", "off"]}}}
GRAMMAR_REGEX = "(yes|no|maybe)"
GRAMMAR_TOOLS = [
    {"type": "function", "function": {"name": "get_weather", "parameters": {
        "type": "object", "properties": {"city": {"enum": ["Oslo", "Rome"]}}}}},
    {"type": "function", "function": {"name": "set_light", "parameters": {
        "type": "object", "properties": {"on": {"type": "boolean"}}}}},
]
GRAMMARS = {
    "json": (dict(constrain="json"), "json"),
    "json_object": (dict(constrain="json_object"), "json_object"),
    "json_schema": (dict(constrain="json_schema", constrain_schema=GRAMMAR_SCHEMA), "json_schema"),
    "regex": (dict(constrain="regex", constrain_regex=GRAMMAR_REGEX), "regex"),
    "tools": (dict(tools=GRAMMAR_TOOLS), "tool_call"),
}
GRAMMAR_KEYS = {name: [key] for name, (_, key) in GRAMMARS.items()}
GRAMMAR_KEYS["tools"] += ["tool_call:get_weather", "tool_call:set_light"]
GRAMMAR_SERVED = ("json_object", "json_schema", "tools")  # phase 22 (b)'s batchers
# Phase 23: LoRA adapters at the 3B's full width (make_adapter, numpy
# seeds), each row's delta held to bite (LORA_BITE: the first step's max
# |delta logit| against the base, about 1% of the logits' scale); the
# embeddings' alone-against-batch floor (cosine within 2^-8 of 1: bf16
# activations of another M); kernel A's f32 instantiation at the tied
# heads' widths and rows (K=1 B=1: M = 1 and 2; K=4: 5; ngram's 8-slot
# verify: 104).
LORA_N, LORA_RANK, LORA_ALPHA = 3, 16, 32.0
LORA_TARGETS = ("q", "k", "v", "o", "gate", "up", "down")
LORA_BITE = 1e-2
EMBED_COS = 1.0 - 2.0 ** -8
EMBED_TEXTS = [PROMPT[: 9 + (len(PROMPT) - 9) * i // 63] for i in range(64)]  # 9-135 tokens
HEAD_F32_K, HEAD_V, HEAD_F32_M = (3072, 2048), 128256, (1, 2, 5, 104)
# The kernels each path must launch (and no other): the norms (rms_norm
# once a forward, add_rms_norm twice a layer a forward) and the
# projections' two kernels (decode rows through the decode body, prefill
# rows through the tensor-core path) on every path, then its attention.
INT4 = {"rms_norm", "add_rms_norm", "quant_matmul_int4", "quant_matmul_int4_mma"}
TP_PATH = "generate int4 model=2 (2 ranks sharing the card over gloo)"
DP_PATH = "serving int4 MultiHostBatcher data=2 (16 requests, 2 ranks)"
TPDP_PATH = "serving int4 MultiHostBatcher data=2 x model=2 (16 requests, 4 ranks)"
PARALLEL_PATHS = [TP_PATH, DP_PATH, TPDP_PATH]
INT8 = {"rms_norm", "add_rms_norm", "quant_matmul_int8", "quant_matmul_int8_mma"}
HEAD4 = {"quant_matmul_int4_f32", "quant_matmul_int4_f32_mma"}  # the EmbedQuant4 head
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
    # Phase 14: admission on phase 3's engine (page 64: every admission
    # forward has 64 rows or more, so E and A's tensor-core path).
    "serving int4 lazy pages with preemption (16 requests)": INT4 | SERVE,
    "serving int4 prefix caching (16 requests)": INT4 | SERVE,
    "serving int4 incremental admission (3000-token prompt among 7)": INT4 | SERVE,
    # Phase 15: Mistral-7B served over the ring (contiguous: D decodes).
    "serving mistral-7b ring incremental admission (8 requests)": INT4 | SPEC,
    # Phase 16: the OpenAI server over HTTP (phase 3b's requests at
    # temperature 0, then (b)-(e)): the paged serving path's kernels.
    "serving int4 OpenAI server, per-request sampling (HTTP)": INT4 | SERVE,
    # Phases 17-20: the families. Qwen2.5's 8 slots x 5 verify rows stay
    # under MMA_MIN_M: B through both bodies.
    "generate qwen2.5-7b int8 + 0.5b draft K=4 (3 runs)": INT8 | SPEC,
    "serving qwen2.5-7b int8 + 0.5b draft K=4 (16 requests)": INT8 | SERVE,
    "generate phi-3-mini int4 ngram K=4 long prompt (3 runs)": INT4 | SPEC,
    "serving phi-3-mini int4 ngram K=4 (16 requests)": INT4 | SERVE,
    # bf16 weights: the projections and the experts are torch.matmul.
    f"generate mixtral-8x7b {MIXTRAL_LAYERS} layers bf16 ngram K=4 (3 runs)":
        {"rms_norm", "add_rms_norm"} | SPEC,
    # LayerNorm is plain ops, the projections bf16, no draft (no C).
    "generate gpt2 bf16 baseline (3 runs)": {"flash_decode", "flash_prefill"},
    "serving gpt2 bf16 baseline (16 requests)": {"flash_prefill", "paged_flash"},
    "generate opt-125m bf16 baseline (3 runs)": {"flash_decode", "flash_prefill"},
    "serving opt-125m bf16 baseline (16 requests)": {"flash_prefill", "paged_flash"},
    # Phase 22: the grammar's ops are plain torch ops inside the captured
    # step; the paths launch what phase 3's, 3b's, 16's, 13's and 10's do.
    "generate int4 grammars (json, json_object, json_schema, regex, tools)": INT4 | SPEC,
    "serving int4 grammars mixed with free requests (4 x 16 requests)": INT4 | SERVE,
    "serving int4 OpenAI server, grammars and tool calls (HTTP)": INT4 | SERVE,
    "generate int4 medusa K=4 under json_schema (3 runs)": INT4 | SPEC,
    "generate int8 ngram K=12 under json_schema (3 runs)": INT8 | SPEC,
    # Phase 23: LoRA on phase 3's weights (the deltas are plain torch ops in
    # the captured step), Engine.embed (eager, no head: E and A's
    # tensor-core path at 64 x 160 rows), and the int4 embedding, whose tied
    # head is kernel A's f32 instantiation (decode rows through its decode
    # body, prefill and admission rows through its tensor-core path).
    "generate int4 LoRA pack, base and 3 adapters (4 x 3 runs)": INT4 | SPEC,
    "serving int4 LoRA adapters round-robin (16 requests)": INT4 | SERVE,
    "serving int4 LoRA prefix caching under two adapters (16 requests)": INT4 | SERVE,
    "generate int4 medusa K=4 under a LoRA adapter (3 runs)": INT4 | SPEC,
    "serving int4 OpenAI server, LoRA model routing (HTTP)": INT4 | SERVE,
    "embed int4 64 texts, mean and last pooling": {"rms_norm", "add_rms_norm",
                                                   "quant_matmul_int4_mma", "flash_prefill"},
    "generate int4 embed_bits=4 (3 runs)": INT4 | SPEC | HEAD4,
    "serving int4 embed_bits=4 (16 requests)": INT4 | SERVE | HEAD4,
    # Phase 26: phase 3's engine and phase 3b's serving over a mesh of ranks
    # sharing the card over gloo. Under the model axis the output
    # projections' partial sums go through kernel A's f32 instantiation
    # (decode rows through its decode body, prefill and admission rows
    # through its tensor-core path).
    TP_PATH: INT4 | SPEC | HEAD4,
    DP_PATH: INT4 | SERVE,
    TPDP_PATH: INT4 | SERVE | HEAD4,
    # Phase 24: JAX's pipelined loop on phase 3's weights (the serving
    # path's kernels).
    "serving int4 pipelined loop (16 requests)": INT4 | SERVE,
    "serving int4 pipelined loop, staggered arrivals (32 requests)": INT4 | SERVE,
    # Phase 25: the bench harness on phase 3's engine settings. The sweep's
    # B = 10 rows stay under MMA_MIN_M at every K (verify 10 x (K + 1) <=
    # 50); its prefill (10 x 64 rows) and the baseline comparison's (160)
    # take A's tensor-core path. The perplexity forwards (S = 512: E, and
    # A's or B's tensor-core path) run eagerly on a bf16 3B and its int8 and
    # int4 clones (the bf16 projections and head are torch.matmul).
    "bench k_sweep int4 K=1-4 (10 prompts a batch)": INT4 | SPEC,
    "bench compare_to_baseline int4 (spec, then baseline)": INT4 | SPEC,
    "bench stress int4 paged (200 requests, 8 slots)": INT4 | SERVE,
    "bench perplexity 3B bf16, int8, int4 (4 x 512 ids)": {
        "rms_norm", "add_rms_norm", "flash_prefill", "quant_matmul_int8_mma",
        "quant_matmul_int4_mma"},
}
GEMMA_PATHS = [path for path in PATH_KERNELS if "gemma-2" in path]
MISTRAL_PATHS = [path for path in PATH_KERNELS if "mistral" in path]
RING_PATHS = [path for path in MISTRAL_PATHS if "ring" in path]
# The phase-10 paths: the K=12 verify shapes have rows of their own.
NGRAM_PATHS = [path for path in PATH_KERNELS if "K=12" in path]
# The phase-12 path: A's decode body at the 8B widths has a row of its own.
EAGLE_PATHS = [path for path in PATH_KERNELS if "llama-3.1-8b" in path]
HEAD_PATHS = [path for path in PATH_KERNELS if "medusa" in path or "tree" in path]
ADMISSION_PATHS = ["serving int4 lazy pages with preemption (16 requests)",
                   "serving int4 prefix caching (16 requests)",
                   "serving int4 incremental admission (3000-token prompt among 7)"]
RING_SERVING_PATH = "serving mistral-7b ring incremental admission (8 requests)"
SERVER_PATH = "serving int4 OpenAI server, per-request sampling (HTTP)"
QWEN_PATHS = [path for path in PATH_KERNELS if "qwen2.5" in path]
PHI_PATHS = [path for path in PATH_KERNELS if "phi-3" in path]
MIXTRAL_PATH = next(path for path in PATH_KERNELS if "mixtral" in path)
BASELINE_PATHS = {name: [path for path in PATH_KERNELS if f" {name} bf16" in path]
                  for name in BASELINE_CFGS}
GRAMMAR_PATHS = [path for path in PATH_KERNELS if "grammar" in path or "under json" in path]
LORA_PATHS = [path for path in PATH_KERNELS if "LoRA" in path]
EMBED_PATH = next(path for path in PATH_KERNELS if path.startswith("embed "))
EMBED4_PATHS = [path for path in PATH_KERNELS if "embed_bits=4" in path]
PATH_SERVE_INT4 = "serving int4 (16 requests)"
PATH_GENERATE_INT4 = "generate int4 (3 runs)"
# Phase 26 (a): the model=2 forward's logits against the whole model's on
# the same weights and input, as a share of the largest |logit|. The ranks
# add kernel A's f32 partials of wo and w_down and round once, the whole
# model's kernel rounds its own sum once: the bf16 activations round at
# other places, 28 layers deep. Measured 0.0039 of 3.305 at the prefill, 0
# at the decode chunk (H100, 700 W); the bound is ~13 times that.
TP_LOGIT_RTOL = 2.0 ** -6
PIPELINE_PATHS = [path for path in PATH_KERNELS if "pipelined loop" in path]
# Phase 24 (b): request i is phase 3b's prompt i % 16 with a budget of 16 to
# 128 tokens; STAGGER_ARRIVALS are submitted after every chunk.
STAGGER_N, STAGGER_ARRIVALS = 32, 2
STAGGER_BUDGETS = [16 + (37 * i) % 113 for i in range(STAGGER_N)]
ADAPTIVE_BUDGET = 192  # phase 24 (c): new tokens of each ngram request
# Phase 3b's ids by request (phase_serving), which phase 22 holds its free
# requests on a table-carrying engine to.
SERVED_IDS = {}
# Phases 3's and 4's B=1 text (phase_end_to_end), which phase 25 (a) holds
# the CLI's to, and ids, which phase 26 (a) holds its ranks' to.
END_TO_END_TEXT = {}
END_TO_END_IDS = {}
# Each serving path's ops that round a row differently at another M
# (phase_serving's row_stability), for phase 26's held_to.
UNSTABLE = {}
HARNESS_PATHS = [path for path in PATH_KERNELS if path.startswith("bench ")]
PPL_ROWS, PPL_S = 4, 512  # phase 25 (e): rows of ids a model, ids a row
HARNESS_TIMEOUT_S = 600  # a CLI subprocess's limit in phase 25


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


def f32_sum_bound(x, wint, scale):
    """Kernel A's f32 instantiation against the plain version: the f32
    summation bound K 2^-24 (|x| @ |w_int|) scale, per element (w_int the
    int4 values unscaled)."""
    return x.shape[1] * 2.0 ** -24 * (x.float().abs() @ wint.abs()) * scale + 1e-30


def qmm_prefill(dev, bits, g, widths=None, prefill_m=PREFILL_M):
    """Kernel A (bits 4) or B (bits 8) at the prefill shapes of every width
    in widths (QMM_WIDTHS by default): within tolerance of the plain version at MMA_CHECK_M
    (the first M rows of one x), every row with the same bits at each of
    those M, and the rows that differ between the decode body (those rows
    at M = MMA_MIN_M - 1) and the tensor-core path (at MMA_MIN_M)
    counted; timed at prefill_m beside the plain version, the library call
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
    for width, shapes in (widths or QMM_WIDTHS).items():
        for K, N in shapes:
            wrows = K // 2 if bits == 4 else K
            L = max(2, (200 << 20) // (wrows * N))  # > 200 MB of weights: beyond L2
            w = torch.randint(-128, 128, (L, wrows, N), generator=g, dtype=torch.int8, device=dev)
            sc = torch.rand((L, N), generator=g, device=dev) * (0.02 / (7 if bits == 4 else 127))
            sc += 1e-5
            x = torch.randn((max(MMA_CHECK_M + tuple(prefill_m)), K), generator=g,
                            device=dev).bfloat16()
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
            for M in prefill_m:
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
DECODE_ONLY = {"quant_matmul_int4", "quant_matmul_int8", "quant_matmul_int4_f32",
               "flash_decode", "flash_decode_int8",
               "paged_flash", "paged_flash_int8", "verify_prefix", "flash_decode_tree",
               "flash_decode_tree_int8", "paged_flash_tree", "paged_flash_tree_int8"}


def count_launches(path, run):
    """Set every kernel's launch count to 0, call run(), read the counts, and
    check that exactly the kernels of `path` launched, rms_norm once a
    forward and add_rms_norm twice a layer a forward (on the RMSNorm paths).
    A count is the eager
    launches (the wrappers' counters, models/transformer.py's forward counts)
    plus the decode loops' replays, each replay counting the launches,
    forwards and layers of its captured step (DecodeLoop.per_replay). The
    path must decode through replays; no wrapper's counter may move across
    a chunk of replays; and a decode-only kernel (DECODE_ONLY) may launch
    eagerly only in the warm-up step of a loop bound inside run() or in a
    serving batcher's admission work (ContinuousBatcher's admission calls:
    _execute_admissions, _admit_one, _admit_group (a fused wave too),
    _finish_admission and _advance_admission, whose launches are counted
    apart and logged: a forward of 32 rows or fewer takes the decode
    kernels)."""
    from llm_inference_lab_tpu_torch.core.batching import ContinuousBatcher
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

    # A serving batcher's admission work (waves, fused waves, prefix-cached
    # suffixes, incremental chunks and splices) launches eagerly: counted
    # apart, once (the outermost of these calls).
    admission = {name: 0 for name in wrappers}
    admit_calls = ("_execute_admissions", "_admit_one", "_admit_group", "_finish_admission",
                   "_advance_admission")
    inner_calls = {name: getattr(ContinuousBatcher, name) for name in admit_calls}
    depth = [0]

    def tallied(inner):
        def call(self, *a, **kw):
            before = {name: w.launches for name, w in wrappers.items()}
            depth[0] += 1
            try:
                return inner(self, *a, **kw)
            finally:
                depth[0] -= 1
                if not depth[0]:
                    for name, w in wrappers.items():
                        admission[name] += w.launches - before[name]
        return call

    DecodeLoop.replay, DecodeLoop.bind = replay, bind
    for name, inner in inner_calls.items():
        setattr(ContinuousBatcher, name, tallied(inner))
    try:
        out = run()
    finally:
        DecodeLoop.replay, DecodeLoop.bind = inner_replay, inner_bind
        for name, inner in inner_calls.items():
            setattr(ContinuousBatcher, name, inner)
    replayed = dict(DecodeLoop.replayed)
    eager = {name: w.launches for name, w in wrappers.items()}
    launches = {name: eager[name] + replayed.get(name, 0) for name in wrappers}
    forwards = transformer.forward.calls + replayed.get("forwards", 0)
    layers = transformer.forward.layers + replayed.get("layers", 0)
    log(f"launches in {path}: {launches}; {forwards} forwards of {layers} layers in all; "
        f"{replayed.get('replays', 0)} graph replays ({replayed.get('forwards', 0)} forwards) "
        f"and {len(bound)} captures in the run; eager launches "
        f"{ {name: n for name, n in eager.items() if n} }, of them in admission "
        f"{ {name: n for name, n in admission.items() if n} }")
    assert replayed.get("replays", 0) > 0, (path, "decoded through no graph replay")
    warm_up = {name: sum(loop.per_replay[name] for loop in bound) for name in DECODE_ONLY}
    assert all(eager[name] - admission[name] == warm_up[name] for name in DECODE_ONLY), (
        path, "decode kernels launched eagerly outside the loops' warm-up steps and admission",
        eager, admission, warm_up)
    launched = {name for name, n in launches.items() if n}
    assert launched == PATH_KERNELS[path], (path, "launched", launched,
                                            "expected", PATH_KERNELS[path])
    if "rms_norm" in PATH_KERNELS[path]:  # GPT-2's and OPT's LayerNorm is plain ops
        assert launches["rms_norm"] == forwards, (path, "rms_norm once a forward", forwards)
        assert launches["add_rms_norm"] == 2 * layers, (path, "add_rms_norm twice a layer",
                                                        layers)
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
    END_TO_END_TEXT[path] = runs[0]["text"]
    END_TO_END_IDS[path] = ids
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


def phase_ngram(dev, profile, path, cfg=None, label=f"3B int8 ngram K={NGRAM_K}", prompt=PROMPT,
                must_accept=True):
    """Phase 10: ngram drafting at the JAX package's ngram_3b_int8_k12
    configuration (NGRAM_CFG; phases 18 and 19 pass their own cfg, label
    and prompt) on PROMPT: one warm-up and three timed
    generate calls on the graph path in one launch count, a greedy baseline
    (no drafts) timed alike, then the host loop in turns with the graph
    path. The ids must equal the baseline's (A's and B's decode rows keep
    their bits at every M, D at S = 1 those of its row of S = 13), graph
    and host loop must agree, and (must_accept) acceptance must be above 0
    with more than one token committed a step."""
    from llm_inference_lab_tpu_torch.config import EngineConfig
    from llm_inference_lab_tpu_torch.core.engine import Engine

    cfg = EngineConfig(**(cfg or NGRAM_CFG))
    eng = Engine(cfg, device=dev)
    eng.generate(prompt)  # warm-up, and the decode loop's capture
    graph_report(f"generate ({label})", engine_loops("B, max_len", eng))
    torch.cuda.reset_peak_memory_stats()
    runs, launches = count_launches(path, lambda: [eng.generate(prompt) for _ in range(3)])
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
    base_eng.generate(prompt)
    bases = [base_eng.generate(prompt) for _ in range(3)]
    assert all(b["generated_ids"] == ids for b in bases), "ngram output differs from baseline"
    del base_eng
    r = runs[0]
    log(f"end to end ({label}, B=1, {cfg.max_new_tokens} new tokens): {timing(runs)}, steps "
        f"{r['steps']}, {step_stats(runs)}, {polls} polls a generate, peak memory "
        f"{peak_mb:.1f} MB; baseline (no drafts): {timing(bases)}, steps {bases[0]['steps']}; "
        f"ngram ids == baseline ids; ids {ids}")
    assert not must_accept or (r["accepted"] > 0 and r["generated_tokens"] > r["steps"]), (
        "ngram accepted no draft on the seed's weights", ids)
    host = host_engine(eng)
    host.generate(prompt)
    turns = [e.generate(prompt) for e in (host, eng, eng, host)]
    same_decode(label, turns, [r] * 4)
    log(f"graph path against the host loop ({label}, in turns host, graph, graph, host; ids, "
        f"steps, proposed, accepted equal): graph {timing(turns[1:3])}; host loop "
        f"{timing(turns[::3])}")
    if profile:
        profile_run(f"generate ({label})", lambda: eng.generate(prompt),
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
    return launches, spec["generated_ids"]


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
LAYER_NORM_OP = "layer_norm (plain ops)"
LIBRARY_M = (64, 256)  # prefill rows row_stability adds for a bf16 model's library ops
ADD_LAYER_NORM_OP = "residual add + layer_norm (plain ops)"
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
    run prefills and another decodes through this op can part there. A bf16
    model's ops are also taken at LIBRARY_M rows (a prompt's prefill). Then D
    against F over the same keys at the serving step's shapes: F runs D's
    body, so no row may differ (asserted). A model with bf16 projections
    (torch.matmul, a library call) or LayerNorm (plain ops) has those ops
    counted, not asserted: nothing fixes their order of sums across M."""
    from llm_inference_lab_tpu_torch.models.transformer import (
        add_rms_norm,
        layer_norm,
        lm_head_logits,
        rms_norm,
    )
    from llm_inference_lab_tpu_torch.ops.quant import EmbedQuant4, QuantTensor, dense
    from llm_inference_lab_tpu_torch.ops.quant_matmul import MMA_MIN_M

    cfg, params = eng.target.config, eng.target.params
    g = torch.Generator(device=dev).manual_seed(6)
    w = params["layers"]["w_qkv"]
    quant = isinstance(w, QuantTensor)
    # The library ops (bf16 projections and head, LayerNorm) at prefill M
    # too: cuBLAS picks its kernel by the shape.
    x = torch.randn((MMA_MIN_M if quant else LIBRARY_M[-1], cfg.d_model), generator=g,
                    device=dev).bfloat16()
    w = w.layer(0) if quant else w[0]
    kernel = ("bf16 projection (torch.matmul)" if not quant else
              "quant_matmul_int4 (kernel A)" if w.bits == 4 else "quant_matmul_int8 (kernel B)")
    head = ("tied int4 head (kernel A, f32 out)" if cfg.tie_word_embeddings
            and isinstance(params["embed"], EmbedQuant4) else
            "tied int8 head (cast + torch.mm, f32 out)" if cfg.tie_word_embeddings
            and not isinstance(params["embed"], torch.Tensor) else
            "tied bf16 head (torch.mm, f32 out)" if cfg.tie_word_embeddings else
            "untied head (dense)")
    layer0 = params["layers"]
    post = layer0["post_attn_norm_scale"][0] if cfg.post_norms else None
    if cfg.use_layernorm:
        ops = {
            LAYER_NORM_OP: lambda a: layer_norm(a, layer0["attn_norm_scale"][0],
                                                layer0["attn_norm_bias"][0], cfg.layer_norm_eps),
            ADD_LAYER_NORM_OP: lambda a: layer_norm(a + a, layer0["mlp_norm_scale"][0],
                                                    layer0["mlp_norm_bias"][0],
                                                    cfg.layer_norm_eps),
        }
    else:
        ops = {
            RMS_NORM_OP:
                lambda a: rms_norm(a, layer0["attn_norm_scale"][0], cfg.rms_norm_eps,
                                   cfg.rms_one_offset),
            ADD_NORM_OP:  # the residual a + a' and its norm, side by side
                lambda a: torch.cat(add_rms_norm(a, a, layer0["mlp_norm_scale"][0],
                                                 cfg.rms_norm_eps, cfg.rms_one_offset, post), -1),
        }
    ops |= {head: lambda a: lm_head_logits(cfg, params, a), kernel: lambda a: dense(a, w)}
    out = {}
    for name, fn in ops.items():
        ms = (2, 5, 8, 16, 40) + ((MMA_MIN_M - 1,) if name == kernel else ())
        if not quant:
            ms += LIBRARY_M
        n = MMA_MIN_M if name == kernel and quant else max(ms)  # the across check's rows too
        alone = torch.cat([fn(x[i:i + 1].contiguous()) for i in range(n)])
        out[name] = {M: int((fn(x[:M].contiguous()) != alone[:M]).any(-1).sum()) for M in ms}
        if name == kernel and quant:
            out[ACROSS_MMA.format("A" if w.bits == 4 else "B")] = {
                MMA_MIN_M: int((fn(x) != alone).any(-1).sum())}
    if not cfg.use_layernorm:
        for op in (RMS_NORM_OP, ADD_NORM_OP):
            assert not any(out[op].values()), (op, "rows depend on M", out[op])
    if quant:
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


def last_logits(eng, dev, ctx, adapter=None):
    """The target's f32 logits of the last of the token ids ctx, from a fresh
    B=1 forward (its rows under the LoRA adapter `adapter`, a name of the
    engine's pack; None: no adapter ids given)."""
    n = len(ctx)
    cache = eng.target.init_cache(1, -(-n // 32) * 32, dev, dtype=eng.kv_dtype)
    lid = (None if adapter is None
           else torch.tensor([eng.lora_id(adapter)], device=dev, dtype=torch.int32))
    logits, _ = eng.target.forward(
        torch.tensor([ctx], device=dev, dtype=torch.int32),
        torch.arange(n, device=dev, dtype=torch.int32)[None],
        cache, torch.zeros((1,), device=dev, dtype=torch.int32), lora_ids=lid)
    return logits[0, -1]


def near_tie(eng, dev, prompt, ids_a, ids_b, adapter=None):
    """At the first position where two greedy runs of one prompt differ: the
    two top target logits from a fresh B=1 forward over the common prefix
    (under `adapter`), their gap and the gap in bf16 ulps of the top logit
    (the head's logits are f32, as in JAX; a bf16 step of the top logit is
    the scale at which the bf16 activations feeding it round)."""
    j = next((i for i, (a, b) in enumerate(zip(ids_a, ids_b)) if a != b), None)
    assert j is not None, ("one run stops where the other goes on, with no parting",
                           len(ids_a), len(ids_b))
    top = torch.topk(last_logits(eng, dev, eng.tokenizer.encode(prompt) + ids_a[:j], adapter), 2)
    (v1, v2), (t1, t2) = top.values.tolist(), top.indices.tolist()
    ulp = 2.0 ** (math.floor(math.log2(abs(v1))) - 7)
    return dict(position=j, tokens=(ids_a[j], ids_b[j]), top2=((t1, v1), (t2, v2)),
                gap=v1 - v2, gap_ulps=(v1 - v2) / ulp)


def held_to(eng, dev, unstable, what, rid, prompt, ref, ids, tie_eng=None, adapter=None):
    """0 when a request's ids equal ref, 1 when they part at a near tie:
    near_tie on tie_eng (or eng; under `adapter`) finds a gap of at most 2
    bf16 ulps, and unstable() names an op that rounds a row differently at
    another M or across A's or B's two kernels (row_stability); otherwise
    it fails."""
    if ids == ref:
        return 0
    tie = near_tie(tie_eng or eng, dev, prompt, ref, ids, adapter)
    ops = unstable()
    log(f"request {rid} differs from {what}: {tie}; ops that round rows differently at "
        f"another M or across A's or B's two kernels: {ops}")
    assert tie["gap_ulps"] <= 2 and ops, ("not a near tie at a named op", what, tie)
    return 1


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
    st = paged.stats.report(SERVE_SLOTS)
    assert len(results) == len(SERVE_PROMPTS) == st["retired"], "not every request retired"
    SERVED_IDS[path] = [r["generated_ids"] for r in sorted(results, key=lambda r: r["req_id"])]
    ids_digest(path, SERVED_IDS[path])
    for r in results:
        lp = torch.tensor(r["token_logprobs"] + r["prompt_logprobs"][1:])
        assert r["generated_tokens"] >= 1 and torch.isfinite(lp).all(), ("bad result", r["req_id"])
    log(f"serving ({label}, paged KV page {SERVE_PAGE}, {SERVE_SLOTS} slots, "
        f"max_seq_len {max_len}): {len(results)} requests, {st['committed_tokens']} "
        f"generated tokens in {st['wall_s']:.3f} s = {st['tok_s']:.2f} tok/s aggregate; "
        f"{st['steps']} steps in {st['chunks']} chunks, {st['admit_waves']} admission waves, "
        f"mean occupied slots a poll {st['mean_occupancy']:.2f}, peak memory {peak_mb:.1f} MB")
    graph_report(f"serving ({label})", [(("paged", SERVE_SLOTS, max_len), paged._loop)])
    # The graph path against the host loop in one process, in turns: graph
    # (the counted run above), host, graph.
    turns = {"graph": st["tok_s"]}
    for what, flags in (("host loop", EnvFlags(sync_steps=True)), ("graph again", None)):
        b = batcher("paged", flags)
        again = b.run()
        turns[what] = b.stats.report(SERVE_SLOTS)["tok_s"]
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
    UNSTABLE[path] = unstable

    def parted(what, rid, prompt, ref, ids):
        return held_to(eng, dev, lambda: unstable, what, rid, prompt, ref, ids)

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


def serve_stats(b, peak_mb):
    """A batcher's throughput, occupancy, steps, waves, page growths,
    preemptions, admission time and peak memory, for the log."""
    st = b.stats.report(b.n_slots)
    return (f"{st['committed_tokens']} tokens in {st['wall_s']:.3f} s = {st['tok_s']:.2f} tok/s, "
            f"mean occupied slots a poll {st['mean_occupancy']:.2f}, {st['steps']} steps in "
            f"{st['chunks']} chunks, {st['admit_waves']} waves, {st['page_grows']} page growths, "
            f"{st['preemptions']} preemptions, admit_ms {st['admit_ms_total']:.1f} (host), peak "
            f"memory {peak_mb:.1f} MB")


def served(b, run):
    """run() on a batcher from a synchronized card with its peak memory
    reset: (its result, the peak MB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = run()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() / 1e6


def watch_chunks(b):
    """Record, for each incremental admission chunk a batcher runs, the
    request, the decode steps run before it and its device ms (CUDA events
    around the chunk's work, read once the run is over): {req_id: [(steps,
    ms), ...]}. The wrapper holds the batcher weakly: no reference cycle
    keeps a finished batcher (its graph and caches) alive."""
    chunks = {}
    ref = weakref.ref(b)

    def advance():
        b = ref()
        pf = b._prefilling
        off, steps = (pf["off"] if pf is not None else None), b.stats.steps
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        type(b)._advance_admission(b)
        e1.record()
        if pf is not None and pf["off"] > off:
            chunks.setdefault(pf["req"].req_id, []).append((steps, (e0, e1)))

    b._advance_admission = advance
    return chunks


def phase_admission(dev, eng, paths):
    """Phase 14 on phase 3's int4 3B + 1B engine (K=1; run after phase 13),
    every batcher paged with pages of 64 (so every admission forward has 64
    rows or more: E and A's tensor-core path), ids held to phase 3's B=1
    generate (or each other) under the near-tie rule (held_to):
    (a) phase 3b's 16 requests through 8 slots over a pool of about half
        the eager worst case of the first 8: eager reservation
        (kv_lazy_pages=False) and lazy pages, in the synchronous order
        (sync_serve: growth from the lengths now); lazy must grow pages and
        preempt, and every page comes back; then lazy pages through run()
        (JAX's loop: growth from a snapshot a chunk old) over RUN_POOL_CUT
        pages fewer, where it must grow pages and preempt too, return every
        page and give every request its whole budget, its ids held to the
        same rule;
    (b) SYSTEM_PREFIX ahead of each of phase 3b's sentences (lanes of
        PREFIX_MAX_LEN), the first request admitted alone so its pages are
        cached, prefix caching off and on: on, every later request reuses
        pages (prompt_tokens_reused > 0) and its ids are the off run's;
    (c) LONG_ADMIT (3000 tokens) admitted in chunks of ADMIT_CHUNK into the
        8th slot while 7 of phase 3b's sentences decode (64 new tokens
        each): decode steps run while it is in flight, its ids equal a B=1
        generate of it, the others' equal phase 3's; then one decoding
        request is cancelled: finish_reason "cancelled", pages returned.
    The lazy, prefix-cached and incremental runs each in their own launch
    count."""
    from llm_inference_lab_tpu_torch.core.batching import ContinuousBatcher
    from llm_inference_lab_tpu_torch.core.engine import Engine

    def engine(**kw):
        return Engine(replace(eng.config, kv_layout="paged", kv_page_size=SERVE_PAGE, **kw),
                      device=dev, target_params=eng.target.params,
                      draft_params=draft_params_of(eng))

    stability = []

    def unstable():
        if not stability:
            stability.append([op for op, d in row_stability(eng, dev).items()
                              if any(d.values())])
        return stability[0]

    reference = {p: eng.generate(p)["generated_ids"] for p in dict.fromkeys(SERVE_PROMPTS)}
    launches = {}
    # (a) lazy pages against eager reservation at the same constrained pool.
    probe = engine(max_seq_len=SERVE_MAX_LEN)
    worst = sum(-(-(len(probe.encode(p, m, SERVE_MAX_LEN)) + m + probe._max_k + 2) // SERVE_PAGE)
                for p, m in list(zip(SERVE_PROMPTS, SERVE_BUDGETS))[:SERVE_SLOTS])
    pool = worst // 2 + 1
    runs = {}
    for lazy in (False, True):
        b = ContinuousBatcher(engine(max_seq_len=SERVE_MAX_LEN, kv_pages=pool,
                                     kv_lazy_pages=lazy), SERVE_SLOTS)
        for p, m in zip(SERVE_PROMPTS, SERVE_BUDGETS):
            b.submit(p, max_new_tokens=m)
        if lazy:
            (results, peak), launches[paths[0]] = count_launches(
                paths[0], lambda: served(b, lambda: sync_serve(b)))
        else:
            results, peak = served(b, lambda: sync_serve(b))
        assert b.allocator.free_pages == pool - 1, ("pages not returned", lazy)
        runs[lazy] = (b, results, peak)
        log(f"admission (a), {'lazy' if lazy else 'eager'} pages over {pool} pages of "
            f"{SERVE_PAGE} (eager worst case of {SERVE_SLOTS} requests: {worst}): "
            + serve_stats(b, peak))
    b, results, _ = runs[True]
    assert b.stats.preemptions >= 1 and b.stats.page_grows > 0, b.stats.report(b.n_slots)
    ids_digest(paths[0], [r["generated_ids"] for r in results])
    run_pool = pool - RUN_POOL_CUT
    b = ContinuousBatcher(engine(max_seq_len=SERVE_MAX_LEN, kv_pages=run_pool), SERVE_SLOTS)
    for p, m in zip(SERVE_PROMPTS, SERVE_BUDGETS):
        b.submit(p, max_new_tokens=m)
    rs, peak = served(b, b.run)
    assert b.allocator.free_pages == run_pool - 1, "pages not returned (run)"
    assert b.stats.preemptions >= 1 and b.stats.page_grows > 0, b.stats.report(b.n_slots)
    runs["lazy, run()"] = (b, rs, peak)
    log(f"admission (a), lazy pages through run() over {run_pool} pages: "
        + serve_stats(b, peak))
    for lazy, (bb, rs, _) in runs.items():
        differ = sum(held_to(eng, dev, unstable, "generate", r["req_id"], p,
                             reference[p][: len(r["generated_ids"])], r["generated_ids"])
                     for r, p in zip(rs, SERVE_PROMPTS, strict=True))
        assert all(r["generated_tokens"] == m for r, m in zip(rs, SERVE_BUDGETS)), lazy
        what = lazy if isinstance(lazy, str) else "lazy" if lazy else "eager"
        log(f"admission (a) {what}: ids == the start of B=1 generate "
            f"ids for {len(rs) - differ} of {len(rs)} requests (the rest near ties); resumed "
            f"by recompute: {sorted(r.req_id for r in bb._done.values() if r.resume_ids)}")
    # (b) prefix caching off and on.
    prompts = [SYSTEM_PREFIX + p for p in SERVE_PROMPTS]
    assert len(probe.encode(SYSTEM_PREFIX, 64, PREFIX_MAX_LEN)) == PREFIX_TOKENS
    runs = {}
    for on in (False, True):
        b = ContinuousBatcher(engine(max_seq_len=PREFIX_MAX_LEN, prefix_caching=on),
                              SERVE_SLOTS)

        def serve(b=b):
            b.submit(prompts[0], max_new_tokens=SERVE_BUDGETS[0])
            b._admit_pending()  # the first request's pages are cached
            for p, m in zip(prompts[1:], SERVE_BUDGETS[1:]):
                b.submit(p, max_new_tokens=m)
            return b.run()

        if on:
            (results, peak), launches[paths[1]] = count_launches(paths[1],
                                                                 lambda: served(b, serve))
        else:
            results, peak = served(b, serve)
        runs[on] = (b, results)
        hits = f", pages hit {b.allocator.hits}, fresh {b.allocator.misses}" if on else ""
        log(f"admission (b), prefix caching {'on' if on else 'off'} ({PREFIX_TOKENS}-token "
            f"system prompt, lanes of {PREFIX_MAX_LEN}): " + serve_stats(b, peak) + hits)
    (_, off), (b, on) = runs[False], runs[True]
    reused = [r["prompt_tokens_reused"] for r in on]
    assert all(n > 0 for n in reused[1:]) and reused[0] == 0, reused
    assert all(r["prompt_tokens_reused"] == 0 for r in off)
    ids_digest(paths[1], [r["generated_ids"] for r in on])
    differ = sum(held_to(eng, dev, unstable, "the uncached batcher", r["req_id"], p,
                         o["generated_ids"], r["generated_ids"])
                 for r, o, p in zip(on, off, prompts, strict=True))
    log(f"admission (b): reused prompt tokens {reused}; prefix-cached ids == uncached ids for "
        f"{len(on) - differ} of {len(on)} requests (the rest near ties)")
    # (c) one long prompt admitted in chunks among 7 decoding requests.
    long_eng = engine(max_seq_len=ADMIT_MAX_LEN, admit_chunk=ADMIT_CHUNK)
    b = ContinuousBatcher(long_eng, SERVE_SLOTS)
    shorts = SERVE_PROMPTS[: SERVE_SLOTS - 1]
    seen = {}
    chunks = watch_chunks(b)

    def serve():
        rids = [b.submit(p, max_new_tokens=64) for p in shorts]
        b._admit_pending()
        b.step_chunk()
        b._retire_finished()
        long_id = b.submit(LONG_ADMIT, max_new_tokens=64)
        b._admit_pending()
        assert b._prefilling is not None and b._prefilling["req"].req_id == long_id
        steps0, chunks = b.stats.steps, 0
        while b._prefilling is not None:
            b.step_chunk()
            b._retire_finished()
            chunks += 1
            b._admit_pending()
        seen.update(steps=b.stats.steps - steps0, chunks=chunks, long_id=long_id)
        victim = next(r for r in b._slots if r is not None and r.req_id in rids)
        seen.update(victim=victim.req_id, victim_pages=len(victim.pages))
        assert b.cancel(victim.req_id)
        return b.run()

    (results, peak), launches[paths[2]] = count_launches(paths[2], lambda: served(b, serve))
    res = {r["req_id"]: r for r in results}
    assert seen["steps"] > 0 and seen["chunks"] >= -(-3000 // ADMIT_CHUNK), seen
    victim = res[seen["victim"]]
    assert victim["finish_reason"] == "cancelled" and len(victim["generated_ids"]) < 64, victim
    assert b._done[seen["victim"]].pages is None
    assert b.allocator.free_pages == b.allocator.n_pages - 1, "pages not returned"
    ids_digest(paths[2], [r["generated_ids"] for r in results])
    ref_eng = Engine(replace(long_eng.config, kv_layout="contiguous", admit_chunk=None),
                     device=dev, target_params=eng.target.params,
                     draft_params=draft_params_of(eng))
    long_ref = ref_eng.generate(LONG_ADMIT)
    long_res = res[seen["long_id"]]
    differ = held_to(ref_eng, dev, unstable, "B=1 generate", seen["long_id"], LONG_ADMIT,
                     long_ref["generated_ids"], long_res["generated_ids"])
    for rid, p in enumerate(shorts):
        r = res[rid]
        differ += held_to(eng, dev, unstable, "generate", rid, p,
                          reference[p][: len(r["generated_ids"])], r["generated_ids"])
    lp = torch.tensor(long_res["token_logprobs"] + long_res["prompt_logprobs"][1:])
    assert torch.isfinite(lp).all() and len(long_res["generated_ids"]) == 64
    chunk_ms = [round(e0.elapsed_time(e1), 3) for _, (e0, e1) in chunks[seen["long_id"]]]
    log(f"admission (c): the {len(LONG_ADMIT)}-token prompt in {seen['chunks']} chunks of "
        f"{ADMIT_CHUNK} (ms each {chunk_ms}) while {seen['steps']} decode steps ran; its ids "
        f"== B=1 generate's "
        f"({'a near tie' if differ else 'equal'} for the {len(shorts) + 1} requests: {differ} "
        f"parted); request {seen['victim']} cancelled after "
        f"{len(victim['generated_ids'])} tokens, its {seen['victim_pages']} pages returned; "
        f"B=1 generate of the long prompt {secs(long_ref)}; " + serve_stats(b, peak))
    return launches


def http_post(port, path, body):
    """POST a JSON body to the server on the loopback; its JSON answer."""
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return json.loads(resp.read())


def http_stream(port, path, body):
    """POST with stream: the deltas' text and the finish_reason."""
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(dict(body, stream=True)).encode(),
                                 headers={"Content-Type": "application/json"})
    text, finish = "", None
    with urllib.request.urlopen(req, timeout=600) as resp:
        for raw in resp:
            line = raw.decode().strip()
            if line == "data: [DONE]":
                return text, finish
            if line.startswith("data: "):
                ch = json.loads(line[6:])["choices"][0]
                text += ch["text"]
                finish = ch["finish_reason"] or finish
    raise AssertionError("the stream ended without [DONE]")


def post_all(port, bodies, clients):
    """Post the bodies from `clients` threads; (answers in order, wall s)."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(clients) as ex:
        outs = list(ex.map(lambda b: http_post(port, "/v1/completions", b), bodies))
    return outs, time.perf_counter() - t0


def replay_ms(loop, n=16):
    """Device ms of one replay of a decode loop's step (CUDA events around n
    replays)."""
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0.record()
    loop.replay(n)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def graph_ms(fn, n=20):
    """Device ms of fn as a captured step runs it: fn captured alone in a
    CUDA graph, n replays between CUDA events (a replay's launch, a few
    microseconds, included)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    graph.replay()
    torch.cuda.synchronize()
    e0.record()
    for _ in range(n):
        graph.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def phase_server(dev, eng, profile, path):
    """Phase 16 on phase 3's int4 3B + 1B weights (K=1; run after phase 14):
    the port's OpenAI server (server/serving.py InferenceServer) on the card
    with per-request sampling and the top-5 capture (SERVER_CFG: 8 paged
    slots, pages of 64), on 127.0.0.1 port 0, client threads posting over
    the loopback. What the engine thread finalizes is recorded (ids and
    all), so texts are held to ids. Asserted:
    (a) phase 3b's 16 requests at temperature 0, 8 in flight (launches
        counted): each text is its ids' and the ids equal phase 3's B=1
        generate ids under the near-tie rule;
    (b) 8 seeded requests (SERVER_SAMPLING) posted one at a time and again
        among 8 greedy ones: the same ids both times; another seed other
        ids;
    (c) frequency_penalty 1e4 repeats no token; logit_bias +100 on one id
        gives only that id; -100 on phase 3's most repeated token bans it;
    (d) stream equals non-stream; a stop string cuts the text before it,
        finish_reason "stop", the slot freed long before its budget;
    (e) top_logprobs 5 (chat): the greedy token first, with its token
        logprob, the values sorted.
    Logged: HTTP tok/s against a direct batcher's on (a)'s requests (in
    turns), the server's loop_ms, a replay's device ms of the static greedy
    step against the per-request step with every row greedy and every row
    sampled, the counts, bias, penalty, sort and top-N ops' ms at the step's
    shapes, each batcher's capture, graph pool and launches a replay;
    --profile=server profiles a chunk of sampled replays."""
    from collections import Counter

    from llm_inference_lab_tpu_torch.core.batching import ContinuousBatcher
    from llm_inference_lab_tpu_torch.core.engine import Engine
    from llm_inference_lab_tpu_torch.ops import sampling as ops
    from llm_inference_lab_tpu_torch.server import InferenceServer

    def engine(**kw):
        return Engine(replace(eng.config, **kw), device=dev, target_params=eng.target.params,
                      draft_params=eng.draft.params)

    srv_eng = engine(**SERVER_CFG)
    server = InferenceServer(srv_eng, n_slots=SERVE_SLOTS, port=0)  # captures its graphs
    direct = ContinuousBatcher(srv_eng, n_slots=SERVE_SLOTS)
    graph_report("the server's batcher", [
        (("per-request step", SERVE_SLOTS, SERVE_MAX_LEN), server.batcher._loop),
        (("plain greedy step", SERVE_SLOTS, SERVE_MAX_LEN), server.batcher._plain_loop)])
    records = []  # (prompt, max_tokens, sampling, result) of each finalized request
    inner_finalize = server._finalize

    def finalize(pend):
        records.append((pend.prompt, pend.max_tokens, json.dumps(pend.sampling, sort_keys=True),
                        pend.result))
        inner_finalize(pend)

    def ids_of(prompt, budget, sampling):
        key = json.dumps(sampling, sort_keys=True)
        got = [r["generated_ids"] for p, m, k, r in records if (p, m, k) == (prompt, budget, key)]
        assert got and all(g == got[0] for g in got), ("one request's runs differ", prompt, key)
        return got[0]

    server._finalize = finalize
    server.start()
    port = server.port
    unstable_ops = []

    def unstable():
        if not unstable_ops:
            unstable_ops.append([op for op, d in row_stability(eng, dev).items()
                                 if any(d.values())])
        return unstable_ops[0]

    try:
        greedy = dict(temperature=0.0)
        http_post(port, "/v1/completions", dict(prompt=PROMPT, max_tokens=8, **greedy))  # warm-up
        bodies = [dict(prompt=p, max_tokens=m, **greedy)
                  for p, m in zip(SERVE_PROMPTS, SERVE_BUDGETS)]

        def direct_run():
            for p, m in zip(SERVE_PROMPTS, SERVE_BUDGETS):
                direct.submit(p, max_new_tokens=m, **greedy)
            t0 = time.perf_counter()
            rs = direct.run()[-len(SERVE_PROMPTS):]
            return rs, time.perf_counter() - t0

        def tok_s(answers, wall):
            return sum(o["usage"]["completion_tokens"] for o in answers) / wall

        turns = {}
        rs, wall = direct_run()
        turns["direct"] = [sum(r["generated_tokens"] for r in rs) / wall]
        loop_before, plain_before = dict(server.loop_ms), server.batcher.stats.plain_steps
        steps_before = server.batcher.stats.steps
        (outs, wall), launches = count_launches(path, lambda: post_all(port, bodies,
                                                                       SERVER_CLIENTS))
        loop_ms = {k: v - loop_before[k] for k, v in server.loop_ms.items()}
        plain_steps = (server.batcher.stats.plain_steps - plain_before,
                       server.batcher.stats.steps - steps_before)
        http_tok_s = tok_s(outs, wall)
        turns["HTTP, 8 clients"] = [http_tok_s, tok_s(*post_all(port, bodies, SERVER_CLIENTS))]
        # Every request queued at once, as the direct batcher has them.
        turns["HTTP, 16 clients"] = [tok_s(*post_all(port, bodies, len(bodies)))]
        rs2, wall = direct_run()
        turns["direct"].append(sum(r["generated_tokens"] for r in rs2) / wall)
        turns["HTTP, 16 clients"].append(tok_s(*post_all(port, bodies, len(bodies))))
        # (a): every text is its ids'; the ids are phase 3's B=1 ids.
        reference = {p: eng.generate(p)["generated_ids"] for p in dict.fromkeys(SERVE_PROMPTS)}
        ids_a, differ = [], 0
        for rid, (o, p, m) in enumerate(zip(outs, SERVE_PROMPTS, SERVE_BUDGETS)):
            ids = ids_of(p, m, greedy)
            assert o["choices"][0]["text"] == srv_eng.tokenizer.decode(
                [t for t in ids if t != srv_eng.eos_token_id]), ("text is not its ids'", rid)
            assert len(ids) == o["usage"]["completion_tokens"] >= 1
            differ += held_to(eng, dev, unstable, "generate (HTTP)", rid, p,
                              reference[p][:len(ids)], ids)
            ids_a.append(ids)
        for r, ids in zip(rs, ids_a):
            differ += held_to(eng, dev, unstable, "the HTTP run (direct batcher)", r["req_id"],
                              SERVE_PROMPTS[r["req_id"] % len(SERVE_PROMPTS)], ids,
                              r["generated_ids"])
        ids_digest(path, ids_a)
        log(f"(a) HTTP ids == B=1 generate ids and == the direct batcher's for "
            f"{2 * len(outs) - differ} of {2 * len(outs)} (the rest near ties)")
        # (b) seeded requests alone, then among greedy traffic.
        seeded = [dict(prompt=SERVE_PROMPTS[i], max_tokens=SERVER_BUDGET, seed=100 + i,
                       **SERVER_SAMPLING) for i in range(8)]
        alone = [http_post(port, "/v1/completions", b) for b in seeded]
        traffic = [dict(prompt=SERVE_PROMPTS[8 + i], max_tokens=SERVER_BUDGET, **greedy)
                   for i in range(8)]
        mixed, _ = post_all(port, [b for pair in zip(traffic, seeded) for b in pair], 16)
        for i, b in enumerate(seeded):
            assert mixed[2 * i + 1]["choices"][0]["text"] == alone[i]["choices"][0]["text"], i
            ids_of(b["prompt"], SERVER_BUDGET, {k: v for k, v in b.items()
                                                if k not in ("prompt", "max_tokens")})
        other = dict(seeded[0], seed=999)
        http_post(port, "/v1/completions", other)
        sampled = {k: v for k, v in seeded[0].items() if k not in ("prompt", "max_tokens")}
        ids_seed = ids_of(seeded[0]["prompt"], SERVER_BUDGET, sampled)
        assert ids_of(other["prompt"], SERVER_BUDGET, dict(sampled, seed=999)) != ids_seed, (
            "another seed gave the same ids")
        greedy_like = sum(ids_of(b["prompt"], SERVER_BUDGET, {k: v for k, v in b.items() if k
                                 not in ("prompt", "max_tokens")})
                          == reference[b["prompt"]][:SERVER_BUDGET] for b in seeded)
        log(f"(b) 8 seeded requests (temperature 0.8, top_k 50, top_p 0.9, min_p 0.05): the same "
            f"ids alone and among 8 greedy ones; another seed other ids; {greedy_like} of 8 "
            "equal the greedy ids")
        # (c) penalties and biases.
        base_ids = eng.generate(PROMPT)["generated_ids"][:SERVER_BUDGET]
        top_token = Counter(base_ids).most_common(1)[0]
        cases = {"frequency_penalty 1e4": dict(frequency_penalty=1e4),
                 f"logit_bias +100 on {BIAS_ID}": dict(logit_bias={str(BIAS_ID): 100.0}),
                 f"logit_bias -100 on {top_token[0]}": dict(logit_bias={str(top_token[0]): -100.0})}
        got_c = {}
        for what, kw in cases.items():
            http_post(port, "/v1/completions", dict(prompt=PROMPT, max_tokens=SERVER_BUDGET,
                                                     **greedy, **kw))
            samp = dict(greedy, **kw)
            if "logit_bias" in samp:
                samp["logit_bias"] = {int(k): v for k, v in samp["logit_bias"].items()}
            got_c[what] = ids_of(PROMPT, SERVER_BUDGET, samp)
        freq = got_c["frequency_penalty 1e4"]
        assert len(set(freq)) == len(freq) == SERVER_BUDGET, ("a token repeats", freq)
        assert set(got_c[f"logit_bias +100 on {BIAS_ID}"]) == {BIAS_ID}
        assert top_token[0] not in got_c[f"logit_bias -100 on {top_token[0]}"]
        log(f"(c) phase 3's ids repeat {top_token[0]} {top_token[1]} times in {SERVER_BUDGET}; "
            f"frequency_penalty 1e4: {len(set(freq))} distinct ids; +100 on {BIAS_ID}: only it; "
            f"-100 on {top_token[0]}: absent")
        # (d) stream against non-stream; a stop string.
        body = dict(prompt=SERVE_PROMPTS[1], max_tokens=SERVER_BUDGET, **greedy)
        full = http_post(port, "/v1/completions", body)["choices"][0]
        text, finish = http_stream(port, "/v1/completions", body)
        assert (text, finish) == (full["text"], full["finish_reason"]), "stream != non-stream"
        long = http_post(port, "/v1/completions", dict(body, max_tokens=64))
        full_text = long["choices"][0]["text"]
        stop = full_text[4:6] if len(full_text) >= 6 else full_text[:1]
        cut = http_post(port, "/v1/completions", dict(body, max_tokens=64, stop=stop))
        assert cut["choices"][0]["text"] == full_text[:full_text.find(stop)]
        assert cut["choices"][0]["finish_reason"] == "stop"
        assert cut["usage"]["completion_tokens"] < 64 == long["usage"]["completion_tokens"], cut
        log(f"(d) stream == non-stream ({len(text)} chars, {finish}); stop {stop!r}: text cut "
            f"at {full_text.find(stop)}, the slot freed after "
            f"{cut['usage']['completion_tokens']} of 64 tokens")
        # (e) top_logprobs 5.
        chat = http_post(port, "/v1/chat/completions", dict(
            messages=[{"role": "user", "content": PROMPT}], max_tokens=16, logprobs=True,
            top_logprobs=5, **greedy))
        content = chat["choices"][0]["logprobs"]["content"]
        (res,) = [r for p, m, k, r in records if m == 16 and p.startswith("user: ")]
        assert len(content) == len(res["generated_ids"]) == len(res["top_logprobs"])
        for pos, tok, lp, tops in zip(content, res["generated_ids"], res["token_logprobs"],
                                      res["top_logprobs"]):
            assert len(pos["top_logprobs"]) == 5 and tops[0]["id"] == tok
            assert tops[0]["logprob"] == lp == pos["logprob"]
            vals = [a["logprob"] for a in tops]
            assert vals == sorted(vals, reverse=True) and all(math.isfinite(v) for v in vals)
        log(f"(e) top_logprobs 5 at {len(content)} positions: the greedy token first, sorted")
        stats = json.loads(urllib_get(port, "/stats"))
    finally:
        server.stop()
    assert server.failure is None, server.failure
    log(f"serving over HTTP (3B int4 + 1B, K=1, per-request sampling, top-5 capture, 8 slots, "
        f"8 client threads): {http_tok_s:.2f} tok/s in the counted run ({plain_steps[0]} of "
        f"{plain_steps[1]} steps on the plain greedy step); in turns direct, HTTP 8 clients "
        f"x2, HTTP 16 clients, direct, HTTP 16 clients (tok/s): "
        + "; ".join(f"{what} {', '.join(f'{x:.2f}' for x in v)}" for what, v in turns.items())
        + "; the server's loop_ms over (a): "
        + ", ".join(f"{k} {v:.1f}" for k, v in loop_ms.items())
        + f"; served {stats['served']}")
    # The per-request step against the static greedy step, one replay's
    # device time at 8 decoding slots (lanes of 1024, prompts of 45-360).
    reqs = [(p, 256) for p in SERVE_PROMPTS[:SERVE_SLOTS]]
    static = ContinuousBatcher(engine(kv_layout="paged", kv_page_size=SERVE_PAGE,
                                      max_seq_len=SERVE_MAX_LEN, kv_lazy_pages=False),
                               n_slots=SERVE_SLOTS)
    per_eng = engine(**SERVER_CFG, kv_lazy_pages=False)
    per_greedy = ContinuousBatcher(per_eng, n_slots=SERVE_SLOTS)
    per_sampled = ContinuousBatcher(per_eng, n_slots=SERVE_SLOTS)
    for b, kw in ((static, {}), (per_greedy, greedy), (per_sampled, SERVER_SAMPLING)):
        for p, m in reqs:
            b.submit(p, max_new_tokens=m, **kw)
        b._admit_pending()
    loops = {"static greedy": static._loop,
             "per-request, every row greedy": per_greedy._loop,
             "per-request, every row sampled": per_sampled._loop,
             "the plain greedy step the host picks for greedy rows": per_greedy._plain_loop}
    step = {what: [] for what in loops}
    for _ in range(3):
        for what, loop in loops.items():
            step[what].append(replay_ms(loop))
    graph_report("the step timings", [((what,), loop) for what, loop in loops.items()])
    log("a decode step's device ms at 8 slots (3 rounds in turns, 16 replays each): "
        + "; ".join(f"{what} {', '.join(f'{x:.3f}' for x in ms)}" for what, ms in step.items()))
    # The per-request work of a K=1 step at its shapes, op by op.
    V = eng.target.config.vocab_size
    st = per_sampled.state
    g = torch.Generator(device=dev).manual_seed(16)
    rows = torch.randn((SERVE_SLOTS, 2, V), generator=g, device=dev)
    counts = ops.token_counts(st.tokens, st.lengths, V)
    d = torch.randint(1, V, (SERVE_SLOTS, 1), generator=g, device=dev, dtype=torch.int32)
    from llm_inference_lab_tpu_torch.core.specstep import _Controls

    ctl = _Controls(V, True)
    samp = dict(temperature=st.temperature, top_k=st.top_k, top_p=st.top_p, min_p=st.min_p)
    window = ctl.window_counts(counts, d)
    row0 = rows[:, 0].contiguous()
    op_ms = {
        "token_counts [8, 1024] -> [8, V]": graph_ms(
            lambda: ops.token_counts(st.tokens, st.lengths, V)),
        "logit_bias_row [8, 32] -> [8, V]": graph_ms(
            lambda: ops.logit_bias_row(st.bias_ids, st.bias_vals, V)),
        "window counts [8, 2, V]": graph_ms(lambda: ctl.window_counts(counts, d)),
        "apply_penalties [8, 2, V]": graph_ms(lambda: ops.apply_penalties(
            rows, window, st.rep_penalty, st.presence_penalty, st.freq_penalty)),
        "the per-row sort alone [8, V]": graph_ms(
            lambda: torch.sort(row0, dim=-1, descending=True)),
        "per-row filters (the sort, softmax, cumsum, masks) [8, V]": graph_ms(
            lambda: ops.filtered_logits(row0, **samp)),
        "per-row draw (filters and noise) [8, V]": graph_ms(lambda: ops.sample_tokens(
            None, row0, **samp, row_keys=st.slot_rng)),
        "top-5 [8, 2, V]": graph_ms(lambda: torch.topk(rows, 5, dim=-1)),
    }
    log(f"per-request ops at a K=1 8-slot step's shapes (V = {V}; each captured alone in a "
        "graph, CUDA events around 20 replays; a step runs the counts, bias and window once, "
        "the penalties twice (draft and verify rows), the draw twice (draft and bonus), the "
        "top-5 once): "
        + "; ".join(f"{k} {v:.4f} ms" for k, v in op_ms.items()))
    if profile:
        profile_run("16 replays of the per-request sampled step",
                    lambda: per_sampled._loop.replay(16), 16 * statistics.median(
                        step["per-request, every row sampled"]))
    return launches


def urllib_get(port, path):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as resp:
        return resp.read().decode()


def phase_ring_serving(dev, eng, long_ids, path):
    """Phase 15: Mistral-7B served over the ring, on phase 8's engine and
    weights with admit_chunk = ADMIT_CHUNK (R stays RING_LEN: the chunk is
    prefill_chunk's), RING_SLOTS slots, RING_REQUESTS: each long prompt
    admitted incrementally into a ring-sized scratch (one at a time, decode
    steps between its chunks), each request's ids held to phase 8's ring
    B=1 ids for its prompt (long_ids: the spec run's on MISTRAL_LONG) under
    the near-tie rule (on a full-cache engine: a ring cannot hold a one-shot
    forward of the long prompt). Logs throughput, occupancy, admission time,
    the ring KV MB and the full cache's for the same batcher."""
    from llm_inference_lab_tpu_torch.core.batching import ContinuousBatcher
    from llm_inference_lab_tpu_torch.core.engine import Engine

    cfg = replace(eng.config, admit_chunk=ADMIT_CHUNK)
    ring_eng = Engine(cfg, device=dev, target_params=eng.target.params,
                      draft_params=eng.draft.params)
    lens = (ring_eng.target.config.kv_ring_len, ring_eng.draft.config.kv_ring_len)
    assert lens == (RING_LEN, RING_LEN), ("ring lengths with admit_chunk", lens)
    b = ContinuousBatcher(ring_eng, RING_SLOTS)
    assert b.state.target_cache.k.shape[3] == RING_LEN
    chunks = watch_chunks(b)
    for p, m in RING_REQUESTS:
        b.submit(p, max_new_tokens=m)
    (results, peak), launches = count_launches(path, lambda: served(b, b.run))
    ids_digest(path, [r["generated_ids"] for r in results])
    n_long = -(-len(MISTRAL_LONG) // ADMIT_CHUNK)
    assert sorted(chunks) == [0, 1], chunks
    for rid, runs in chunks.items():
        assert len(runs) == n_long and runs[-1][0] > runs[0][0], (rid, runs)
    refs = {MISTRAL_LONG: long_ids}
    for p, _ in RING_REQUESTS[2:]:
        refs[p] = eng.generate(p)["generated_ids"]
    tie_eng, stability = [], []

    def full_cache():
        if not tie_eng:
            tie_eng.append(Engine(replace(cfg, kv_ring=False, draft_model=None, admit_chunk=None),
                                  device=dev, target_params=eng.target.params))
        return tie_eng[0]

    def unstable():
        if not stability:
            stability.append([op for op, d in row_stability(eng, dev).items()
                              if any(d.values())])
        return stability[0]

    differ = 0
    for r, (p, m) in zip(results, RING_REQUESTS, strict=True):
        assert r["generated_tokens"] == m and r["finish_reason"] == "length", r["req_id"]
        lp = torch.tensor(r["token_logprobs"] + r["prompt_logprobs"][1:])
        assert torch.isfinite(lp).all(), r["req_id"]
        ref = refs[p][:m]
        if r["generated_ids"] != ref:
            differ += held_to(eng, dev, unstable, "phase 8's ring B=1 ids", r["req_id"], p,
                              ref, r["generated_ids"], tie_eng=full_cache())
    tc, dc = ring_eng.target.config, ring_eng.draft.config
    ring_mb = RING_SLOTS * (cache_mb(tc, RING_LEN) + cache_mb(dc, RING_LEN))
    full_mb = RING_SLOTS * (cache_mb(tc, cfg.max_seq_len) + cache_mb(dc, cfg.max_seq_len))
    log(f"ring serving (Mistral-7B int4 + 7B draft, K={cfg.max_draft}, ring R={RING_LEN}, "
        f"admit_chunk {ADMIT_CHUNK}, {RING_SLOTS} slots, {len(RING_REQUESTS)} requests): "
        + serve_stats(b, peak) + f"; long prompts in {n_long} chunks each (decode steps "
        f"before each {[[n for n, _ in runs] for runs in chunks.values()]}, ms each "
        f"{[[round(e0.elapsed_time(e1), 3) for _, (e0, e1) in runs] for runs in chunks.values()]}"
        f"); ids == phase "
        f"8's ring B=1 ids for "
        f"{len(results) - differ} of {len(results)} requests (the rest near ties); KV of "
        f"both models: ring {ring_mb:.1f} MB, full cache at max_seq_len {cfg.max_seq_len} "
        f"{full_mb:.1f} MB")
    return launches


# ------------------------------------------------- the families' kernels (phase 2)
# Kernels A and B at the widths that are not a multiple of 256 columns (a
# tail tile): Qwen2.5-0.5B's qkv (1152) and o (896), Phi-3-mini's head
# (32064), Qwen2.5-7B's head (151936); both bodies.
TAIL_SHAPES = [(896, 1152), (896, 896), (3072, 32064), (3584, 151936)]
TAIL_M = (1, 5, 64, 256)


def qmm_tails(dev, g):
    """A and B at TAIL_SHAPES and TAIL_M (the first M rows of one x, random
    bytes): within tolerance of the plain version, the last 64 columns
    included; a row with the same bits at M = 1 and 5 (the decode body) and
    at 64 and 256 (the tensor-core path). Returns {bits: max abs err}."""
    from llm_inference_lab_tpu_torch.ops.quant_matmul import (
        quant_matmul,
        quant_matmul_int8,
        quant_matmul_plain,
        quant_matmul_plain_int8,
    )

    errs = {}
    for bits in (4, 8):
        kernel, plain = ((quant_matmul, quant_matmul_plain) if bits == 4 else
                         (quant_matmul_int8, quant_matmul_plain_int8))
        err = 0.0
        for K, N in TAIL_SHAPES:
            wrows = K // 2 if bits == 4 else K
            w = torch.randint(-128, 128, (wrows, N), generator=g, dtype=torch.int8, device=dev)
            sc = torch.rand((N,), generator=g, device=dev) * (0.02 / (7 if bits == 4 else 127))
            sc += 1e-5
            x = torch.randn((max(TAIL_M), K), generator=g, device=dev).bfloat16()
            outs = {}
            for M in TAIL_M:
                outs[M] = kernel(x[:M], w, sc)
                ref = plain(x[:M].float(), w, sc)
                err = max(err, qmm_within(bits, outs[M], ref))
                assert ref[:, -64:].abs().max() > 0
            assert torch.equal(outs[5][:1], outs[1]), (bits, K, N, "decode body rows")
            assert torch.equal(outs[256][:64], outs[64]), (bits, K, N, "tensor-core rows")
            log(f"quant_matmul_int{bits} K={K} N={N} (N % 256 = {N % 256}): within tolerance "
                f"at M = {TAIL_M}, rows the same bits at M = 1, 5 and at 64, 256")
            del w, sc, x, outs
        errs[bits] = err
    return errs


def sdpa_window(q, k, v, pos, window):
    """The library yardstick for windowed GQA attention (timed only, never
    used): SDPA with the position and window mask as a boolean mask."""
    T = k.shape[2]
    kv = torch.arange(T, device=q.device)[None, None, None, :]
    p = pos[:, None, :, None]
    mask = (kv <= p) & (kv > p - window) if window else kv <= p
    out = torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k, v, attn_mask=mask, enable_gqa=True)
    return out.transpose(1, 2)


def family_attention_checks(dev, g, H, KVH, D, window, T, lasts, prefill_lasts, errs):
    """D (S = 1 and 5), E (S = 160) and F (D's bits through shuffled 64-row
    pages) at one geometry, bf16 and int8 caches, POISON outside every
    row's keys (gemma_keys), one row dead at S > 1: each within check_attn's
    tolerance of its plain version (F also equal to D's bits); errs
    {kernel: max abs err} updated."""
    from llm_inference_lab_tpu_torch.ops.flash_decode import flash_decode, flash_decode_int8
    from llm_inference_lab_tpu_torch.ops.flash_prefill import flash_prefill, flash_prefill_int8
    from llm_inference_lab_tpu_torch.ops.paged_flash import paged_flash, paged_flash_int8

    opts = {"window": window} if window else {}
    for cache, (dk, ek, fk) in {"bf16": (flash_decode, flash_prefill, paged_flash),
                                "int8": (flash_decode_int8, flash_prefill_int8,
                                         paged_flash_int8)}.items():
        for S, last in ((1, lasts), (5, lasts), (160, prefill_lasts)):
            B = len(last)
            pos = (torch.tensor(last, device=dev, dtype=torch.int32)[:, None] - S + 1
                   + torch.arange(S, device=dev, dtype=torch.int32)[None]).contiguous()
            if S > 1:
                pos[-1, 0] = -1  # a dead row beside live ones
            k, v, ks, vs = gemma_keys(g, dev, cache, B, KVH, T, pos, window, D=D)
            q = torch.randn((B, S, H, D), generator=g, device=dev).bfloat16()
            sc = (ks, vs) if cache == "int8" else ()
            name = "flash_decode" if S <= 32 else "flash_prefill"
            got = (dk if S <= 32 else ek)(q, k, v, pos, *sc, **opts)
            what = (name, cache, H, KVH, D, window, S)
            errs[name] = max(errs[name], check_attn(got, q, k, v, pos, *sc, what=what, **opts))
            assert S == 1 or torch.all(got[-1, 0] == 0), (what, "dead row not zero")
            if S <= 32:
                pools, table = to_pages(g, dev, (k, v, *sc), 64)
                paged = fk(q, pools[0], pools[1], pos, table, *pools[2:], **opts)
                assert torch.equal(got, paged), (what, "D != F")
                errs["paged_flash"] = max(errs["paged_flash"], check_attn(
                    paged, q, k, v, pos, *sc, what=("F",) + what[1:], **opts))
                del pools
            del k, v
    log(f"attention H={H} KVH={KVH} (group {H // KVH}) D={D} window={window} T={T}: D (S=1, 5), "
        f"E (S=160) and F within tolerance of their plain versions, bf16 and int8, POISON "
        f"outside every row's keys, dead rows zero, F == D")


def time_attention(dev, g, agg, kind, n, S, H, KVH, D, T, lasts, window, what):
    """Add n times one call's numbers (ms, plain, library, bound) of D, E
    or F (kind) at these shapes to agg: D and E over [B, KVH, T, D] planes
    with positions ending at lasts, F over 64-row pages of 1024-position
    lanes (paged_inputs)."""
    from llm_inference_lab_tpu_torch.models.paged import gather_pages
    from llm_inference_lab_tpu_torch.ops.flash_decode import flash_decode, flash_decode_plain
    from llm_inference_lab_tpu_torch.ops.flash_prefill import flash_prefill
    from llm_inference_lab_tpu_torch.ops.paged_flash import paged_flash, paged_flash_plain

    opts = {"window": window} if window else {}
    B = len(lasts)
    big = S > 32
    it = dict(iters=5, warmup=1) if big else {}
    pit = dict(iters=3 if big else 10, warmup=1)
    if kind == "F":
        M = SERVE_MAX_LEN // SERVE_PAGE
        L = 2 * L2_BYTES // (2 * (B * M + 1) * KVH * SERVE_PAGE * D * 2) + 1
        q, _, _, kp, vp, table, pos = paged_inputs(g, dev, B, S, H, KVH, D, SERVE_PAGE, lasts, L=L)
        cyc = Cycle(L)
        ms = median_ms(lambda: paged_flash(q, kp[cyc()], vp[cyc.i], pos, table, **opts))
        plain = median_ms(lambda: paged_flash_plain(q, kp[cyc()], vp[cyc.i], pos, table, **opts),
                          **pit)
        lib = median_ms(lambda: sdpa_window(q, gather_pages(kp[cyc()], table),
                                            gather_pages(vp[cyc.i], table), pos, window), **pit)
        extra = 4 * table.numel()
        del kp, vp
    else:
        L = 2 * L2_BYTES // (2 * B * KVH * T * D * 2) + 1
        q, k, v, pos = flash_inputs(g, dev, B, S, H, KVH, T, D, lasts[0], L=L)
        pos = (torch.tensor(lasts, device=dev, dtype=torch.int32)[:, None] - S + 1
               + torch.arange(S, device=dev, dtype=torch.int32)[None]).contiguous()
        fn = flash_decode if kind == "D" else flash_prefill
        cyc = Cycle(L)
        ms = median_ms(lambda: fn(q, k[cyc()], v[cyc.i], pos, **opts), **it)
        plain = median_ms(lambda: flash_decode_plain(q, k[cyc()], v[cyc.i], pos, **opts), **pit)
        lib = median_ms(lambda: sdpa_window(q, k[cyc()], v[cyc.i], pos, window), **pit)
        extra = 0
        del k, v
    keys, pairs = seen_keys(pos, window)
    b, by = bound_ms(2 * KVH * keys * D * 2 + 2 * 2 * B * S * H * D + 4 * B * S + extra,
                     4 * H * pairs * D)
    log(f"{kind} {what} (B={B} S={S} H={H} KVH={KVH} D={D} window={window}): {ms:.4f} ms  "
        f"plain {plain:.4f}  library {lib:.4f} (SDPA + mask)  bound {b:.5f} ({by}), x{n}")
    for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib), ("bound_ms", b)):
        agg[key] += n * val
    if by == "operations":
        agg["bound_by"] = by


def verify_row(dev, g, V, K=4):
    """Kernel C at a B=1 K-draft step's [1, K, V] (a view of [1, K+1, V]):
    equal to its plain and split plain versions, with a tie across a split
    boundary; timed beside the plain version and torch.argmax."""
    from llm_inference_lab_tpu_torch.ops.verify import (
        split_width,
        verify_plan,
        verify_prefix,
        verify_prefix_plain,
        verify_prefix_split_plain,
    )

    lg = torch.randn((1, K + 1, V), generator=g, device=dev)[:, :K]
    d = torch.argmax(lg, -1).to(torch.int32)
    n = verify_plan(K, V)
    w = split_width(V, n)
    lg[0, 1, w - 1] = lg[0, 1, min(w, V - 1)] = float(lg.max()) + 1  # a tie across a split
    d[0, 1] = min(w, V - 1)
    ref = verify_prefix_plain(d, lg)
    for got in (verify_prefix(d, lg), verify_prefix_split_plain(d, lg, n)):
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), (V, got, ref)
    got = verify_prefix(d, lg)
    err = max((a.double() - r.double()).abs().max().item() for a, r in zip(got, ref))
    ms = median_ms(lambda: verify_prefix(d, lg))
    plain = median_ms(lambda: verify_prefix_plain(d, lg))
    lib = median_ms(lambda: torch.argmax(lg, -1))
    b, by = bound_ms(K * V * 4 + 4 * K + K + 4, K * V)
    log(f"verify_prefix [1,{K},{V}] ({n} splits): accept_len {ref[0].tolist()} == plain == split "
        f"plain; {ms:.4f} ms  plain {plain:.4f}  library {lib:.4f} (torch.argmax)  bound "
        f"{b:.5f} ({by})")
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b, bound_by=by, max_abs_err=err)


def phase_family_kernels(dev):
    """Phase 2 for phases 17-19's shapes: A and B at the tail widths
    (qmm_tails); B's decode body at every Qwen2.5 projection and its
    tensor-core path at their prefill (qmm_decode / qmm_prefill), A's at
    Phi-3-mini's; D, E and F at head dim 96 with the window of 2047 and at
    Qwen2.5's GQA group of 7 (family_attention_checks), timed at the paths'
    shapes; C at the two vocabularies. Returns the kernels line's rows."""
    g = torch.Generator(device=dev).manual_seed(31)
    tails = qmm_tails(dev, g)
    L05, L7, LP = QWEN_GEOMS["0.5b"][3], QWEN_GEOMS["7b"][3], PHI_GEOM[3]
    rows = {}
    dec8, err8 = qmm_decode(dev, 8, g, {"Qwen2.5-0.5B": (QMM_QWEN_05, (1,)),
                                        "Qwen2.5-7B": (QMM_QWEN_7 + [QWEN_HEAD], (5,))})
    step8 = [(QMM_QWEN_05, 1, 4 * L05), (QMM_QWEN_7, 5, L7), ([QWEN_HEAD], 5, 1)]
    log_step("quant_matmul_int8", "one Qwen2.5 K=4 B=1 step (4 x 24 0.5B layers at M = 1, 28 7B "
             "layers and the head at M = 5)", dec8, step8)
    pre8, pre8_err, across8 = qmm_prefill(dev, 8, g, {"Qwen2.5-0.5B": QMM_QWEN_05,
                                                      "Qwen2.5-7B": QMM_QWEN_7 + [QWEN_HEAD]},
                                          prefill_m=(160,))
    wave8 = ([(k, n, 160, L05) for k, n in QMM_QWEN_05] + [(k, n, 160, L7) for k, n in QMM_QWEN_7]
             + [(*QWEN_HEAD, 160, 1)])
    dec4, err4 = qmm_decode(dev, 4, g, {"Phi-3-mini": (QMM_PHI + [PHI_HEAD], (5,))})
    step4 = [(QMM_PHI, 5, LP), ([PHI_HEAD], 5, 1)]
    pre4, pre4_err, across4 = qmm_prefill(dev, 4, g, {"Phi-3-mini": QMM_PHI + [PHI_HEAD]},
                                          prefill_m=(2400,))
    wave4 = [(k, n, 2400, LP) for k, n in QMM_PHI] + [(*PHI_HEAD, 2400, 1)]
    log(f"rows that differ between the decode body and the tensor-core path: B at Qwen2.5 "
        f"{across8}, A at Phi-3-mini {across4}")
    qmm = "ops/pallas/quant_matmul.py:"
    rows["quant_matmul_int8/qwen2.5"] = (
        sum_rows(dec8, calls(step8), max(err8, tails[8])), "qmm_decode.cuh", qmm + "58",
        "one Qwen2.5 K=4 B=1 step (4 x 24 0.5B layers at M = 1, 28 7B layers and the untied "
        "head, N = 151936, at M = 5)")
    rows["quant_matmul_int8_mma/qwen2.5"] = (
        sum_rows(pre8, wave8, pre8_err), "qmm_mma.cuh", qmm + "58",
        "the Qwen2.5 pair's 160-row prompt through the 0.5B's 24 and the 7B's 28 layers and "
        "the 7B's head")
    rows["quant_matmul_int4/phi3"] = (
        sum_rows(dec4, calls(step4), max(err4, tails[4])), "qmm_decode.cuh", qmm + "76",
        "one Phi-3-mini ngram K=4 B=1 step (32 layers and the untied head, N = 32064, at M = 5)")
    rows["quant_matmul_int4_mma/phi3"] = (
        sum_rows(pre4, wave4, pre4_err), "qmm_mma.cuh", qmm + "76",
        "Phi-3-mini's 2400-row prompt block through 32 layers and the head")

    # Each family's rows carry the errors of its own checks.
    errs = {fam: {"flash_decode": 0.0, "flash_prefill": 0.0, "paged_flash": 0.0}
            for fam in ("phi3", "qwen2.5")}
    H, KVH, D, _ = PHI_GEOM
    family_attention_checks(dev, g, H, KVH, D, PHI_WINDOW, 4096, (2417, 4095, 3000, 300),
                            (2559, 2399), errs["phi3"])
    for H, KVH, D, _ in QWEN_GEOMS.values():
        family_attention_checks(dev, g, H, KVH, D, None, 1024, (167, 1000, 611, 300),
                                (159, 511), errs["qwen2.5"])
    phi, qwen = ({k: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, bound_by="bytes",
                          max_abs_err=e) for k, e in errs[fam].items()}
                 for fam in ("phi3", "qwen2.5"))
    H, KVH, D, _ = PHI_GEOM
    time_attention(dev, g, phi["flash_decode"], "D", LP, 5, H, KVH, D, 2560, [2417], PHI_WINDOW,
                   "Phi-3-mini ngram verify, p = 2417")
    time_attention(dev, g, phi["flash_prefill"], "E", LP, 2400, H, KVH, D, 2560, [2399],
                   PHI_WINDOW, "Phi-3-mini prompt block from 0")
    time_attention(dev, g, phi["paged_flash"], "F", LP, 5, H, KVH, D, SERVE_MAX_LEN,
                   [246 + b for b in range(SERVE_SLOTS)], PHI_WINDOW, "Phi-3-mini serving step")
    for (H, KVH, D, layers), S, n in zip(QWEN_GEOMS.values(), (1, 5), (4 * L05, L7)):
        time_attention(dev, g, qwen["flash_decode"], "D", n, S, H, KVH, D, 256, [167], None,
                       "Qwen2.5 K=4 step, p = 167")
        time_attention(dev, g, qwen["flash_prefill"], "E", layers, 160, H, KVH, D, 256, [159],
                       None, "Qwen2.5 prompt block from 0")
        time_attention(dev, g, qwen["paged_flash"], "F", n, S, H, KVH, D, SERVE_MAX_LEN,
                       [246 + b for b in range(SERVE_SLOTS)], None, "Qwen2.5 serving step")
    att = {"flash_decode": ("flash_decode.cu", "ops/pallas/flash_decode.py:146"),
           "flash_prefill": ("flash_prefill.cu", "ops/pallas/flash_prefill.py:86"),
           "paged_flash": ("paged_flash.cu", "ops/pallas/paged_flash.py:82")}
    per = {"phi3": {"flash_decode": "one Phi-3-mini ngram K=4 B=1 step at p = 2417 (32 layers "
                                    "at S = 5, head dim 96, window 2047)",
                    "flash_prefill": "Phi-3-mini's 2400-row prompt block (32 layers, window "
                                     "2047 binding)",
                    "paged_flash": "one Phi-3-mini ngram K=4 step of the 8-slot serving batch "
                                   "(32 layers at S = 5)"},
           "qwen2.5": {"flash_decode": "one Qwen2.5 K=4 B=1 step at p = 167 (4 x 24 0.5B layers "
                                       "at S = 1, 28 7B layers at S = 5; GQA group 7)",
                       "flash_prefill": "the Qwen2.5 pair's 160-row prompt (24 + 28 layers)",
                       "paged_flash": "one Qwen2.5 K=4 step of the 8-slot serving batch"}}
    for fam, timed in (("phi3", phi), ("qwen2.5", qwen)):
        for name, (src, where) in att.items():
            rows[f"{name}/{fam}"] = (timed[name], src, where, per[fam][name])
    rows["verify_prefix/qwen2.5"] = (verify_row(dev, g, QWEN_V), "verify_prefix.cu",
                                     "ops/pallas/verify_pallas.py:46",
                                     f"one Qwen2.5 K=4 B=1 step: C at [1, 4, {QWEN_V}]")
    rows["verify_prefix/phi3"] = (verify_row(dev, g, PHI_V), "verify_prefix.cu",
                                  "ops/pallas/verify_pallas.py:46",
                                  f"one Phi-3-mini ngram K=4 B=1 step: C at [1, 4, {PHI_V}]")
    return rows


# ------------------------------------------------------- phases 17-21: the families
def tree_bytes(tree):
    """Bytes of a param tree's tensors (QuantTensor and EmbedQuant leaves
    included)."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return sum(tree_bytes(t) for t in vars(tree).values() if isinstance(t, torch.Tensor))


def model_report(eng, label, k_draft=0):
    """Log the models' weights, where they came from, and the bound of one
    decode step: the target's weights read once and the draft's k_draft
    times, at 3.35 TB/s (the KV cache and activations left out)."""
    t = tree_bytes(eng.target.params)
    d = tree_bytes(eng.draft.params) if eng.draft is not None else 0
    b = (t + k_draft * d) / PEAK_BYTES_PER_S * 1e3
    log(f"{label}: weights {t / 1e9:.3f} GB target + {d / 1e9:.3f} GB draft "
        f"(weights_source {eng.target.weights_source!r}); bound of one decode step "
        f"(the target's weights once, the draft's {k_draft} times) {b:.3f} ms")
    return b


def phase_qwen(dev, paths):
    """Phase 17: the Qwen2.5 pair (QWEN_CFG) through B=1 generate (phase 3's
    checks: graph == host loop == baseline ids, a self-drafted run
    accepts) and phase 3b's 16 requests through the 8-slot paged batcher
    (== B=1 under the near-tie rule). Returns (the engine, launches)."""
    label = "Qwen2.5-7B int8 + 0.5B draft, K=4"
    out = {}
    eng, out[paths[0]] = phase_end_to_end(dev, False, QWEN_CFG, paths[0], label)
    model_report(eng, label, k_draft=QWEN_CFG["max_draft"])
    out[paths[1]] = phase_serving(dev, eng, False, SERVE_MAX_LEN, paths[1], label)
    return eng, out


def phase_phi3(dev, paths):
    """Phase 18: Phi-3-mini-4k-instruct (PHI_CFG) on PHI_PROMPT, past the
    window (phase 10's checks: graph == host loop, ngram ids == baseline
    ids, acceptance > 0), then phase 3b's requests through the paged
    batcher (== B=1 under the near-tie rule)."""
    label = "Phi-3-mini int4 ngram K=4"
    out = {}
    eng, out[paths[0]] = phase_ngram(dev, False, paths[0], cfg=PHI_CFG, label=label,
                                     prompt=PHI_PROMPT)
    n = len(eng.encode(PHI_PROMPT, PHI_CFG["max_new_tokens"], PHI_CFG["max_seq_len"]))
    assert n > PHI_WINDOW, ("the window does not bind", n)
    model_report(eng, f"{label} ({n}-token prompt, window {PHI_WINDOW})")
    out[paths[1]] = phase_serving(dev, eng, False, SERVE_MAX_LEN, paths[1], label)
    del eng
    return out


def moe_block_report(dev, eng):
    """The MoE block of one layer (ops/moe.py) at B=1's rows: T = 1 (a
    baseline step) and T = 5 (an ngram K=4 verify), its ms a forward (x
    layers) beside two bounds: the dense read of all experts (what the
    block does) and the routed bound (only the experts its rows route to,
    counted from this run's routing)."""
    from llm_inference_lab_tpu_torch.ops.moe import moe_mlp, route

    cfg, layers = eng.target.config, eng.target.params["layers"]
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    per_expert = 3 * D * Fd * 2
    g = torch.Generator(device=dev).manual_seed(19)
    w = (layers["w_router"][0], layers["w_gate_up"][0], layers["w_down"][0])
    for T in (1, 5):
        x = torch.randn((T, D), generator=g, device=dev).bfloat16()
        ms = median_ms(lambda: moe_mlp(x, *w, top_k=cfg.experts_per_token), iters=10)
        routed = int(torch.unique(route(x, w[0], cfg.experts_per_token)[1]).numel())
        dense_b = (E * per_expert + D * E * 2) / PEAK_BYTES_PER_S * 1e3
        routed_b = (routed * per_expert + D * E * 2) / PEAK_BYTES_PER_S * 1e3
        log(f"MoE block (mixtral-8x7b, T={T}): {ms:.4f} ms a layer, {ms * cfg.n_layers:.3f} ms a "
            f"forward of {cfg.n_layers} layers; dense bound (all {E} experts read) "
            f"{dense_b * cfg.n_layers:.3f} ms a forward ({dense_b / ms:.3f} of it a layer); routed "
            f"bound ({routed} experts routed) {routed_b * cfg.n_layers:.3f} ms a forward "
            f"({dense_b / routed_b:.2f}x less than dense)")


def phase_mixtral(dev, path):
    """Phase 19: Mixtral-8x7B at full width, MIXTRAL_LAYERS of its 32
    layers (registered as MIXTRAL_CUT for the phase), bf16, ngram K=4 at
    B=1 (phase 10's checks but acceptance), then the MoE block's ms
    against its bounds."""
    from llm_inference_lab_tpu_torch.models import mixtral

    table = mixtral.MIXTRAL_CONFIGS
    table[MIXTRAL_CUT] = replace(table["mixtral-8x7b"], name=MIXTRAL_CUT, n_layers=MIXTRAL_LAYERS)
    try:
        label = f"Mixtral-8x7B ({MIXTRAL_LAYERS} of 32 layers) bf16 ngram K=4"
        # Random experts do not repeat a token as the dense models do: the
        # acceptance is logged, not asserted.
        eng, launches = phase_ngram(dev, False, path, cfg=MIXTRAL_CFG, label=label,
                                    must_accept=False)
        model_report(eng, label)
        moe_block_report(dev, eng)
        del eng
    finally:
        del table[MIXTRAL_CUT]
    return launches


def phase_baselines(dev):
    """Phase 20: gpt2 and opt-125m (BASELINE_CFGS), bf16, no draft, at full
    depth: phase 3's B=1 checks (graph == host loop; a self-drafted run
    equals the baseline and accepts), then phase 3b's requests through the
    paged batcher (== B=1 under the near-tie rule; prompts and budgets stay
    inside GPT-2's 1024 positions)."""
    out = {}
    for name, cfg in BASELINE_CFGS.items():
        paths, label = BASELINE_PATHS[name], f"{name} bf16 baseline"
        eng, out[paths[0]] = phase_end_to_end(dev, False, cfg, paths[0], label)
        model_report(eng, label)
        out[paths[1]] = phase_serving(dev, eng, False, SERVE_MAX_LEN, paths[1], label)
        del eng
        torch.cuda.empty_cache()
    return out


def hf_qwen_tensors(cfg, params):
    """A Qwen2 model's params under HF's names and layouts ([out, in]
    weights; q, k and v, their biases, gate and up split apart): what
    models/loader.py reads back."""
    H, KV, Dh, Fd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    lay = params["layers"]
    t = {"model.embed_tokens.weight": params["embed"],
         "model.norm.weight": params["final_norm_scale"]}
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        for part, w, b in zip("qkv", lay["w_qkv"][i].split([H * Dh, KV * Dh, KV * Dh], -1),
                              lay["b_qkv"][i].split([H * Dh, KV * Dh, KV * Dh], -1)):
            t[p + f"self_attn.{part}_proj.weight"] = w.t().contiguous()
            t[p + f"self_attn.{part}_proj.bias"] = b.contiguous()
        t[p + "self_attn.o_proj.weight"] = lay["wo"][i].t().contiguous()
        gate, up = lay["w_gate_up"][i].split([Fd, Fd], -1)
        t[p + "mlp.gate_proj.weight"] = gate.t().contiguous()
        t[p + "mlp.up_proj.weight"] = up.t().contiguous()
        t[p + "mlp.down_proj.weight"] = lay["w_down"][i].t().contiguous()
        t[p + "input_layernorm.weight"] = lay["attn_norm_scale"][i]
        t[p + "post_attention_layernorm.weight"] = lay["mlp_norm_scale"][i]
    return t


def same_leaves(a, b, path=""):
    """Two param trees with the same structure, leaf types and bytes."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, sorted(a), sorted(b))
        return sum(same_leaves(a[k], b[k], f"{path}/{k}") for k in a)
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b), path
        return 1
    assert type(a) is type(b) and getattr(a, "bits", None) == getattr(b, "bits", None), path
    return sum(same_leaves(x, y, f"{path}.{n}") for (n, x), y in
               zip(vars(a).items(), vars(b).values()) if isinstance(x, torch.Tensor))


def phase_checkpoints(dev, eng):
    """Phase 21. (a) save_params of phase 17's int8 Qwen2.5-0.5B draft and
    load_params back onto the card: every leaf byte-equal, and one
    forward's logits equal. (b) An HF-layout snapshot of a bf16 0.5B
    (random weights from seed 7, biases made nonzero) written by the port's
    writer under HF's names, with a config.json from the preset, in a
    temporary HF_HOME: an Engine with no params finds it
    (find_cached_checkpoint), its weights_source is the snapshot, and its
    ids equal an engine given the same weights directly. HF_HOME is
    restored afterwards."""
    import os
    import tempfile

    from llm_inference_lab_tpu_torch.config import EngineConfig
    from llm_inference_lab_tpu_torch.core.engine import Engine
    from llm_inference_lab_tpu_torch.models import checkpoint, loader, registry
    from llm_inference_lab_tpu_torch.models.base import Model
    from llm_inference_lab_tpu_torch.utils.safetensors import save_file

    draft = eng.draft
    old_home = os.environ.get("HF_HOME")
    with tempfile.TemporaryDirectory() as tmp:
        try:
            path = os.path.join(tmp, "qwen2.5-0.5b-int8.safetensors")
            t0 = time.perf_counter()
            checkpoint.save_params(draft.params, path)
            save_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            loaded = checkpoint.load_params(path, device=dev)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            n = same_leaves(draft.params, loaded)
            toks = torch.tensor([eng.tokenizer.encode(PROMPT)], device=dev, dtype=torch.int32)
            pos = torch.arange(toks.shape[1], device=dev, dtype=torch.int32)[None]
            logits = []
            for params in (draft.params, loaded):
                m = Model(config=draft.config, params=params)
                cache = m.init_cache(1, 256, dev)
                logits.append(m.forward(toks, pos, cache, torch.zeros((1,), device=dev,
                                                                      dtype=torch.int32))[0])
            assert torch.equal(logits[0], logits[1]), "logits of the loaded checkpoint differ"
            log(f"checkpoint: save_params of the int8 Qwen2.5-0.5B ({os.path.getsize(path) / 1e6:.1f}"
                f" MB) {save_s:.2f} s, load_params onto the card {load_s:.2f} s; {n} tensors "
                f"byte-equal, one forward's logits equal")
            del loaded
            # (b) an HF-layout snapshot in a temporary HF_HOME.
            os.environ["HF_HOME"] = os.path.join(tmp, "hf")
            ref = registry.create("qwen2.5-0.5b", device=dev, seed=7)
            assert ref.weights_source == "random", ref.weights_source  # the empty cache
            ref.params["layers"]["b_qkv"].normal_(0, 0.5, generator=torch.Generator(
                device=dev).manual_seed(8))
            cfg = ref.config
            snap = os.path.join(tmp, "hf", "hub", "models--Qwen--Qwen2.5-0.5B", "snapshots",
                                "0123456789abcdef")
            os.makedirs(snap)
            hf = dict(model_type="qwen2", vocab_size=cfg.vocab_size,
                      num_hidden_layers=cfg.n_layers, num_attention_heads=cfg.n_heads,
                      num_key_value_heads=cfg.n_kv_heads, hidden_size=cfg.d_model,
                      intermediate_size=cfg.d_ff,
                      max_position_embeddings=cfg.max_position_embeddings,
                      rope_theta=cfg.rope_theta, rms_norm_eps=cfg.rms_norm_eps,
                      tie_word_embeddings=cfg.tie_word_embeddings, use_sliding_window=False)
            with open(os.path.join(snap, "config.json"), "w") as f:
                json.dump(hf, f)
            t0 = time.perf_counter()
            save_file(hf_qwen_tensors(cfg, ref.params), os.path.join(snap, "model.safetensors"))
            write_s = time.perf_counter() - t0
            assert loader.find_cached_checkpoint("qwen2.5-0.5b") == snap
            ecfg = EngineConfig(base_model="qwen2.5-0.5b", draft_model=None, max_new_tokens=32,
                                max_seq_len=512)
            t0 = time.perf_counter()
            cached = Engine(ecfg, device=dev)
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            assert cached.target.weights_source == snap, cached.target.weights_source
            got = cached.target.config
            for field in ("n_layers", "n_heads", "n_kv_heads", "d_model", "d_ff", "vocab_size",
                          "rope_theta", "rms_norm_eps", "qkv_bias", "tie_word_embeddings"):
                assert getattr(got, field) == getattr(cfg, field), field
            n = same_leaves(cached.target.params, ref.params)
            a = cached.generate(PROMPT)
            b = Engine(ecfg, device=dev, target_params=ref.params).generate(PROMPT)
            assert a["weights_source"] == snap and b["weights_source"] == "given"
            assert a["generated_ids"] == b["generated_ids"], "cached snapshot ids differ"
            log(f"HF cache: a bf16 Qwen2.5-0.5B snapshot written in {write_s:.2f} s under a "
                f"temporary HF_HOME; Engine found it (weights_source {snap!r}), loaded it in "
                f"{init_s:.2f} s ({n} tensors byte-equal to the weights written), and its "
                f"{len(a['generated_ids'])} ids equal an engine given the weights directly")
            del cached, ref
        finally:
            if old_home is None:
                os.environ.pop("HF_HOME", None)
            else:
                os.environ["HF_HOME"] = old_home
    assert os.environ.get("HF_HOME") == old_home


# ------------------------------------------------------- phase 22: grammars
def grammar_valid(name, key, text):
    """The independent check of a completed constrained output (no port
    code): json.loads; a JSON object for json_object; the schema's fields in
    order with their types; a full regex match; a tool call naming a tool
    (the forced one) with arguments of its parameters' shape."""
    if name == "regex":
        return re.fullmatch(GRAMMAR_REGEX, text) is not None
    obj = json.loads(text)
    if key == "json_object":
        assert isinstance(obj, dict), text
    if name == "json_schema":
        assert list(obj) == ["ok", "mode"] and isinstance(obj["ok"], bool), text
        assert obj["mode"] in GRAMMAR_SCHEMA["properties"]["mode"]["enum"], text
    if name == "tools":
        assert set(obj) == {"name", "arguments"}, text
        if key.startswith("tool_call:"):
            assert obj["name"] == key.split(":", 1)[1], text
        args = obj["arguments"]
        if obj["name"] == "get_weather":
            assert list(args) == ["city"] and args["city"] in ("Oslo", "Rome"), text
        else:
            assert obj["name"] == "set_light" and list(args) == ["on"], text
            assert isinstance(args["on"], bool), text
    return True


def grammar_output(eng, name, key, ids, text, budget):
    """A constrained output against the port's automaton and the independent
    check: the committed ids (EOS included) walk from the key's initial
    state without dying (walk_tokens on the engine's host tables); one that
    ends in EOS passes grammar_valid; one that does not ran to its budget
    (None: the output must complete). Returns whether it completed."""
    from llm_inference_lab_tpu_torch.constrain.runtime import walk_tokens

    lex, _, _ = walk_tokens(eng.constrain_tables, eng._resolve_fsm_initial(key), ids)
    assert lex >= 0, (name, key, "the automaton refuses the committed ids", ids)
    done = bool(ids) and ids[-1] == eng.eos_token_id
    if done:
        assert grammar_valid(name, key, text), (name, key, text)
    else:
        assert budget is not None and len(ids) == budget, (name, key, "incomplete", ids, text)
    return done


def http_tool_stream(port, body):
    """POST a chat body with stream and a forced tool: the tool_calls chunks'
    name (from the first, with the call's id), the concatenated argument
    deltas and the last finish_reason."""
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/chat/completions",
                                 data=json.dumps(dict(body, stream=True)).encode(),
                                 headers={"Content-Type": "application/json"})
    name, args, finish = None, "", None
    with urllib.request.urlopen(req, timeout=600) as resp:
        for raw in resp:
            line = raw.decode().strip()
            if line == "data: [DONE]":
                return name, args, finish
            if line.startswith("data: "):
                ch = json.loads(line[6:])["choices"][0]
                for tc in ch["delta"].get("tool_calls", []):
                    if "id" in tc:
                        assert tc["id"].startswith("call_") and name is None, tc
                        name = tc["function"]["name"]
                    args += tc["function"]["arguments"]
                finish = ch["finish_reason"] or finish
    raise AssertionError("the stream ended without [DONE]")


def grammar_engine(base, name, dev, flags=None, own_draft=True, **kw):
    """An engine with base's weights and settings (own_draft: its draft's
    params too; False: none, a head mode's default heads) and the grammar
    `name` (GRAMMARS), tables compiled at construction."""
    from llm_inference_lab_tpu_torch.core.engine import Engine

    return Engine(replace(base.config, **GRAMMARS[name][0], **kw), device=dev, flags=flags,
                  target_params=base.target.params,
                  draft_params=draft_params_of(base) if own_draft else None)


def step_pair_ms(e):
    """(unconstrained, constrained) device ms of one replay of a grammar
    engine's two decode loops over its one B=1 decode state (replay_ms):
    the unconstrained loop is bound (captured) here when no unconstrained
    call ran; a replay after the run, every lane inactive, runs every op
    of the step (it is branch-free)."""
    (key,) = e._decode_states
    state, loop = e._decode_states[key]
    if loop.bound is None:
        loop(state, 1)
    return replay_ms(loop), replay_ms(e._fsm_loops[key])


def mask_ops_ms(dev, eng, rows):
    """Device ms of the grammar's ops on `rows` rows of the engine's tables
    (graph_ms: each captured alone): token_mask + apply_mask over [rows, V]
    f32 logits, transition, and walk_window over K=1; beside the bound of
    the mask (each table byte of the rows read once, 8 a vocabulary entry,
    plus the logits read and written: 16 bytes an entry, at 3.35 TB/s)."""
    from llm_inference_lab_tpu_torch.constrain import runtime as rt

    tbl = eng._constrain_tbl
    V = tbl["state_out"].shape[1]
    g = torch.Generator(device=dev).manual_seed(5)
    logits = torch.randn((rows, V), generator=g, device=dev)
    lex = torch.full((rows,), eng._resolve_fsm_initial(GRAMMARS["json"][1]), dtype=torch.int32,
                     device=dev)
    stack = torch.zeros((rows, rt.STACK_DEPTH), dtype=torch.int32, device=dev)
    sp = torch.zeros((rows,), dtype=torch.int32, device=dev)
    tok = torch.randint(0, V, (rows,), generator=g, device=dev, dtype=torch.int32)
    mask_ms = graph_ms(lambda: rt.apply_mask(logits, rt.token_mask(tbl, lex, stack, sp)))
    trans_ms = graph_ms(lambda: rt.transition(tbl, lex, stack, sp, tok))
    walk_ms = graph_ms(lambda: rt.walk_window(tbl, lex, stack, sp, tok[:, None]))
    table_b, full_b = rows * V * 8, rows * V * 16
    return dict(rows=rows, mask_ms=mask_ms, transition_ms=trans_ms, walk_ms=walk_ms,
                bound_ms=bound_ms(full_b, 0)[0], table_bound_ms=bound_ms(table_b, 0)[0])


def phase_grammars(dev, eng, paths):
    """Phase 22 on phase 3's int4 3B + 1B weights (K=1; eng: phase 3's
    engine): grammar-constrained decoding and forced tool calls.
    (a) one engine a grammar (GRAMMARS: json, json_object, json_schema,
    regex, tools), weights shared, each compiling its tables: compile s and
    table MB logged; B=1 generate under each key, three runs, one launch
    count; every output checked (grammar_output); greedy spec ids == the
    constrained baseline's; graph ids == the host loop's; an unconstrained
    call on the tools engine gives phase 3's ids; step ms of the
    constrained graph against the unconstrained one on the same engine and
    state; the grammar ops' ms against their bound at 3 and 24 rows.
    (b) phase 3b's 16 requests through 8-slot paged batchers of three
    grammars, even ones constrained, odd ones free: the free ones' ids are
    phase 3b's, the constrained ones the start of B=1 generate's under the
    same key (the near-tie rule), every output checked; phase 3b's requests
    all free on the tools engine give phase 3b's ids exactly (the
    unconstrained graph replays).
    (c) the OpenAI server (phase 16's settings) with a grammar:
    response_format json_schema, guided_regex, tool_choice required, a
    named tool, a streamed named tool call, a free request; ids (what the engine thread
    finalizes) against B=1 generate of the rendered prompt.
    (d) Medusa K=4 (phase 13's settings) under json_schema: its ids the
    constrained baseline's and the host loop's, acceptance logged.
    Returns the launches of each path."""
    from llm_inference_lab_tpu_torch.config import EnvFlags
    from llm_inference_lab_tpu_torch.constrain.runtime import table_bytes
    from llm_inference_lab_tpu_torch.core.batching import ContinuousBatcher
    from llm_inference_lab_tpu_torch.server import InferenceServer

    launches = {}
    sync = EnvFlags(sync_steps=True)
    ref_ids = eng.generate(PROMPT)["generated_ids"]
    unstable_ops = []

    def unstable():
        if not unstable_ops:
            unstable_ops.append([op for op, d in row_stability(eng, dev).items()
                                 if any(d.values())])
        return unstable_ops[0]

    # (a) B=1 generate under each grammar key.
    engines = {}
    for name in GRAMMARS:
        t0 = time.perf_counter()
        engines[name] = grammar_engine(eng, name, dev)
        torch.cuda.synchronize()
        e = engines[name]
        log(f"phase 22 engine {name}: tables compiled in {e.constrain_compile_s:.3f} s "
            f"(engine build {time.perf_counter() - t0:.2f} s), "
            f"{table_bytes(e._constrain_tbl) / 1e6:.1f} MB on the card, keys "
            f"{sorted(e._fsm_initial_map)}")
    keys = [(name, key) for name in GRAMMARS for key in GRAMMAR_KEYS[name]]
    for name, key in keys:
        engines[name].generate(PROMPT, response_format=key)  # warm-up, the captures
    engines["tools"].generate(PROMPT)
    for name, e in engines.items():
        graph_report(f"generate, grammar {name} (constrained step)",
                     [(("B, max_len",) + k, loop) for k, loop in e._fsm_loops.items()])

    def b1_runs():
        out = {(name, key): [engines[name].generate(PROMPT, response_format=key)
                             for _ in range(3 if key == GRAMMARS[name][1] else 1)]
               for name, key in keys}
        out[("tools", None)] = [engines["tools"].generate(PROMPT) for _ in range(3)]
        return out

    runs, launches[paths[0]] = count_launches(paths[0], b1_runs)
    b1 = {}
    for (name, key), rs in runs.items():
        ids = rs[0]["generated_ids"]
        assert all(r["generated_ids"] == ids for r in rs), (name, key, "repeated runs differ")
        if key is None:
            assert ids == ref_ids, ("an unconstrained call on a table engine differs from "
                                    "phase 3's ids", ids, ref_ids)
            continue
        # Generic json may run to the budget; the other grammars are finite.
        done = grammar_output(engines[name], name, key, ids, rs[0]["text"],
                              engines[name].config.max_new_tokens
                              if name in ("json", "json_object") else None)
        b1[(name, key)] = ids
        base = grammar_engine(eng, name, dev, draft_model=None)
        want = base.generate(PROMPT, response_format=key)["generated_ids"]
        assert ids == want, (name, key, "constrained spec ids != constrained baseline ids")
        del base
        checked = "constrained baseline"
        if key == GRAMMARS[name][1]:  # the host loop once a grammar
            host = grammar_engine(eng, name, dev, flags=sync)
            same_decode(f"grammar {name} {key}", [host.generate(PROMPT, response_format=key)],
                        rs[:1])
            checked += ", host loop"
            del host
        log(f"phase 22 generate {name} key {key}: {timing(rs)}, {len(ids)} ids, completed "
            f"{done}, text {rs[0]['text']!r}; ids == {checked}")
    ids_digest(paths[0], [b1[k] for k in sorted(b1, key=str)])
    for name, e in engines.items():
        plain_ms, fsm_ms = step_pair_ms(e)
        log(f"phase 22 step ms, engine {name}, one B=1 decode state: unconstrained graph "
            f"{plain_ms:.4f}, constrained graph {fsm_ms:.4f} (+{fsm_ms - plain_ms:.4f})")
    log(f"phase 22 generate on the tools engine: {timing(runs[('tools', None)])} unconstrained, "
        f"{timing(runs[('tools', 'tool_call')])} constrained (a chunk of replays runs to its "
        f"planned length past an early EOS: ms/step counts the active steps)")
    for rows in (3, 24):  # K=1: 1 draft row + 2 verify rows a slot; B=1 and 8 slots
        ops = mask_ops_ms(dev, engines["json"], rows)
        log(f"phase 22 grammar ops at {rows} rows of V = 128256 (json tables): mask "
            f"{ops['mask_ms']:.4f} ms (bound {ops['bound_ms']:.5f} ms: table bytes and the logits "
            f"once, {rows * 128256 * 16 / 1e6:.2f} MB; table bytes alone "
            f"{ops['table_bound_ms']:.5f} ms), transition {ops['transition_ms']:.4f} ms, "
            f"walk_window K=1 {ops['walk_ms']:.4f} ms")

    # (b) phase 3b's batcher, constrained and free requests mixed.
    serve_kw = dict(max_seq_len=SERVE_MAX_LEN, kv_layout="paged", kv_page_size=SERVE_PAGE)
    served_free = SERVED_IDS[PATH_SERVE_INT4]

    def mixed(name):
        e = grammar_engine(eng, name, dev, **serve_kw)
        b = ContinuousBatcher(e, n_slots=SERVE_SLOTS)
        want = []
        for i, (prompt, budget) in enumerate(zip(SERVE_PROMPTS, SERVE_BUDGETS)):
            key = GRAMMAR_KEYS[name][(i // 2) % len(GRAMMAR_KEYS[name])] if i % 2 == 0 else None
            b.submit(prompt, max_new_tokens=budget, response_format=key)
            want.append(key)
        return e, b, want

    batchers = {name: mixed(name) for name in GRAMMAR_SERVED}
    free_e = grammar_engine(eng, "tools", dev, **serve_kw)
    free_b = ContinuousBatcher(free_e, n_slots=SERVE_SLOTS)
    for prompt, budget in zip(SERVE_PROMPTS, SERVE_BUDGETS):
        free_b.submit(prompt, max_new_tokens=budget)

    def serve_all():
        return {name: b.run() for name, (_, b, _) in batchers.items()} | {"free": free_b.run()}

    served, launches[paths[1]] = count_launches(paths[1], serve_all)
    assert [r["generated_ids"] for r in served["free"]] == served_free, (
        "phase 3b's requests on a table-carrying engine differ from phase 3b's ids")
    assert free_b.stats.constrained_steps == 0
    ids_digest(paths[1] + " (all free: phase 3b's digest)",
               [r["generated_ids"] for r in served["free"]])
    refs = {}
    for name, (e, b, keys_b) in batchers.items():
        differ = completed = 0
        for r, key, prompt in zip(served[name], keys_b, SERVE_PROMPTS):
            ids = r["generated_ids"]
            if key is None:
                differ += held_to(eng, dev, unstable, "phase 3b (free request)", r["req_id"],
                                  prompt, served_free[r["req_id"]], ids)
                continue
            if (name, key, prompt) not in refs:
                refs[(name, key, prompt)] = engines[name].generate(
                    prompt, response_format=key)["generated_ids"]
            ref = refs[(name, key, prompt)][:len(ids)]
            differ += held_to(eng, dev, unstable, f"generate under {key}", r["req_id"], prompt,
                              ref, ids)
            completed += grammar_output(e, name, key, ids, r["text"], SERVE_BUDGETS[r["req_id"]])
        st = b.stats.report(b.n_slots)
        log(f"phase 22 serving {name}: 16 requests (8 under {GRAMMAR_KEYS[name]}, {completed} "
            f"completed), {st['tok_s']:.2f} tok/s, {st['steps']} steps ({st['constrained_steps']} "
            f"constrained), ids == B=1 / phase 3b for {16 - differ} of 16 (the rest near ties)")
        graph_report(f"serving, grammar {name}", [(("unconstrained", SERVE_SLOTS), b._loop),
                                                  (("constrained", SERVE_SLOTS), b._fsm_loop)])
        assert st["constrained_steps"] > 0
    b = batchers["json_schema"][1]
    fsm_ms, plain_ms = replay_ms(b._fsm_loop), replay_ms(b._loop)
    log(f"phase 22 step ms of the 8-slot serving state (json_schema): unconstrained graph "
        f"{plain_ms:.4f}, constrained graph {fsm_ms:.4f} (+{fsm_ms - plain_ms:.4f})")
    del batchers, free_b, free_e

    # (c) the OpenAI server with a grammar.
    def server(name):
        e = grammar_engine(eng, name, dev, **SERVER_CFG)
        srv = InferenceServer(e, n_slots=SERVE_SLOTS, port=0)
        records = []
        inner = srv._finalize

        def finalize(pend):
            records.append((pend.prompt, pend.max_tokens, pend.sampling.get("response_format"),
                            pend.result))
            inner(pend)

        srv._finalize = finalize
        srv.start()
        return srv, records

    servers = {name: server(name) for name in ("json_schema", "regex", "tools")}
    tool_req = dict(messages=[{"role": "user", "content": "What is the weather in Oslo?"}],
                    tools=GRAMMAR_TOOLS, max_tokens=64, temperature=0)
    named = {"type": "function", "function": {"name": "get_weather"}}

    def http_all():
        out = {}
        port = servers["json_schema"][0].port
        out["json_schema"] = [http_post(port, "/v1/completions", dict(
            prompt=p, max_tokens=48, temperature=0, response_format={
                "type": "json_schema", "json_schema": {"schema": GRAMMAR_SCHEMA}}))
            for p in SERVE_PROMPTS[:2]]
        out["free"] = http_post(port, "/v1/completions", dict(prompt=SERVE_PROMPTS[2],
                                                              max_tokens=16, temperature=0))
        port = servers["regex"][0].port
        out["regex"] = [http_post(port, "/v1/completions", dict(
            prompt=p, max_tokens=16, temperature=0, guided_regex=GRAMMAR_REGEX))
            for p in SERVE_PROMPTS[:2]]
        port = servers["tools"][0].port
        out["required"] = http_post(port, "/v1/chat/completions",
                                    dict(tool_req, tool_choice="required"))
        out["named"] = http_post(port, "/v1/chat/completions", dict(tool_req, tool_choice=named))
        out["stream"] = http_tool_stream(port, dict(tool_req, tool_choice=named))
        return out

    try:
        answers, launches[paths[2]] = count_launches(paths[2], http_all)
    finally:
        for srv, _ in servers.values():
            srv.stop()
    for o in answers["json_schema"]:
        assert grammar_valid("json_schema", "json_schema", o["choices"][0]["text"]), o
    for o in answers["regex"]:
        assert grammar_valid("regex", "regex", o["choices"][0]["text"]), o
    calls = []
    for what in ("required", "named"):
        ch = answers[what]["choices"][0]
        assert ch["finish_reason"] == "tool_calls" and ch["message"]["content"] is None, ch
        (tc,) = ch["message"]["tool_calls"]
        text = json.dumps({"name": tc["function"]["name"],
                           "arguments": json.loads(tc["function"]["arguments"])})
        assert grammar_valid("tools", "tool_call" if what == "required"
                             else "tool_call:get_weather", text)
        calls.append(tc["function"]["name"])
    name, args, finish = answers["stream"]
    assert name == "get_weather" and finish == "tool_calls", answers["stream"]
    assert json.loads(args)["city"] in ("Oslo", "Rome"), args
    differ = n = 0
    for srv_name, (srv, records) in servers.items():
        for prompt, budget, key, result in records:
            ref = (engines[srv_name].generate(prompt, response_format=key) if key is not None
                   else eng.generate(prompt))["generated_ids"]
            ids = result["generated_ids"]
            differ += held_to(eng, dev, unstable, f"generate under {key} (HTTP)", n, prompt,
                              ref[:len(ids)], ids)
            n += 1
            if key is not None:
                grammar_output(srv.engine, srv_name, key, ids, result["text"], budget)
    log(f"phase 22 server: json_schema {[o['choices'][0]['text'] for o in answers['json_schema']]}"
        f", guided_regex {[o['choices'][0]['text'] for o in answers['regex']]}, tool calls "
        f"{calls}, streamed call {name}({args}) finish {finish}; ids == B=1 generate for "
        f"{n - differ} of {n} (the rest near ties)")

    # (d) Medusa K=4 under json_schema.
    medusa = grammar_engine(eng, "json_schema", dev, own_draft=False, draft_model=None,
                            draft_mode="medusa", max_draft=MEDUSA_K)
    key = GRAMMARS["json_schema"][1]
    medusa.generate(PROMPT, response_format=key)
    rs, launches[paths[3]] = count_launches(paths[3], lambda: [
        medusa.generate(PROMPT, response_format=key) for _ in range(3)])
    ids = rs[0]["generated_ids"]
    assert all(r["generated_ids"] == ids for r in rs)
    assert ids == b1[("json_schema", key)], "Medusa under json_schema != the constrained baseline"
    host = grammar_engine(eng, "json_schema", dev, flags=sync, own_draft=False,
                          draft_model=None, draft_mode="medusa", max_draft=MEDUSA_K)
    same_decode("medusa json_schema", [host.generate(PROMPT, response_format=key)], rs[:1])
    grammar_output(medusa, "json_schema", key, ids, rs[0]["text"], None)
    plain_ms, fsm_ms = step_pair_ms(medusa)
    log(f"phase 22 Medusa K={MEDUSA_K} under json_schema: {timing(rs)}, {step_stats(rs)}; ids == "
        f"constrained baseline, == host loop; step ms unconstrained graph {plain_ms:.4f}, "
        f"constrained graph {fsm_ms:.4f} (+{fsm_ms - plain_ms:.4f})")
    return launches


def phase_grammar_ngram(dev, eng, path):
    """Phase 22 (e) on phase 10's weights and settings (int8 3B, ngram
    K=12): json_schema's tables on an engine of the same weights; B=1
    generate, its ids the constrained baseline's and the host loop's, the
    output checked."""
    from llm_inference_lab_tpu_torch.config import EnvFlags

    e = grammar_engine(eng, "json_schema", dev)
    key = GRAMMARS["json_schema"][1]
    e.generate(PROMPT, response_format=key)
    rs, launches = count_launches(path, lambda: [e.generate(PROMPT, response_format=key)
                                                 for _ in range(3)])
    ids = rs[0]["generated_ids"]
    assert all(r["generated_ids"] == ids for r in rs)
    base = grammar_engine(eng, "json_schema", dev, draft_mode="vanilla")
    assert base.generate(PROMPT, response_format=key)["generated_ids"] == ids, (
        "ngram under json_schema != the constrained baseline")
    host = grammar_engine(eng, "json_schema", dev, flags=EnvFlags(sync_steps=True))
    same_decode("ngram json_schema", [host.generate(PROMPT, response_format=key)], rs[:1])
    grammar_output(e, "json_schema", key, ids, rs[0]["text"], None)
    plain_ms, fsm_ms = step_pair_ms(e)
    log(f"phase 22 ngram K={NGRAM_K} under json_schema: {timing(rs)}, {step_stats(rs)}; ids "
        f"== constrained baseline, == host loop; step ms unconstrained graph {plain_ms:.4f}, "
        f"constrained graph {fsm_ms:.4f} (+{fsm_ms - plain_ms:.4f})")
    return launches


# ------------------------------------------- phase 23: LoRA, embed, int4 head
def lora_adapters(cfg):
    """LORA_N adapters of rank LORA_RANK on all seven matrices at cfg's full
    widths, from numpy seeds (models/lora.py make_adapter)."""
    import numpy as np

    from llm_inference_lab_tpu_torch.models.lora import make_adapter

    return [make_adapter(cfg, f"a{i}", rank=LORA_RANK, alpha=LORA_ALPHA, targets=LORA_TARGETS,
                         rng=np.random.default_rng(100 + i)) for i in range(LORA_N)]


def pack_bytes(eng):
    """Bytes of the target's LoRA pack (every site's A and B)."""
    return sum(v.numel() * v.element_size() for k, v in eng.target.params["layers"].items()
               if k.startswith("lora_"))


def count_eager(path, run):
    """count_launches for an entry point that runs no decode loop (embed):
    every count set to 0 just before run(), read just after; exactly the
    path's kernels launched, rms_norm once a forward and add_rms_norm
    twice a layer."""
    from llm_inference_lab_tpu_torch.models import transformer

    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    transformer.forward.calls = transformer.forward.layers = 0
    out = run()
    launches = {name: w.launches for name, w in wrappers.items()}
    log(f"launches in {path}: { {k: n for k, n in launches.items() if n} }; "
        f"{transformer.forward.calls} forwards of {transformer.forward.layers} layers")
    assert {name for name, n in launches.items() if n} == PATH_KERNELS[path], (path, launches)
    assert launches["rms_norm"] == transformer.forward.calls
    assert launches["add_rms_norm"] == 2 * transformer.forward.layers
    return out, launches


def phase_lora(dev, eng, paths):
    """Phase 23 (a) on phase 3's int4 3B + 1B weights (K=1): multi-LoRA.
    LORA_N adapters (lora_adapters: rank LORA_RANK on q, k, v, o, gate, up
    and down at full width, numpy seeds) in one pack on an engine sharing
    phase 3's weights. Asserted: B=1 generate of the base on the pack
    engine gives phase 3's ids (its rows' delta is an exact zero), and each
    adapter bites on the logits (the first step's max |delta logit| against
    the base above LORA_BITE); a bf16 3B (no draft) with adapter a0 gives
    the ids of the same model with a0 merged into its weights (near-tie
    rule; the logit difference logged); phase 3b's 16 requests through the
    8-slot paged batcher with the adapters round-robin (base, a0, a1, a2)
    each give their own B=1 generate's ids (near-tie rule); phase 14's
    1024-token system prompt under a0 and a1 alternately, prefix caching
    off and on: equal ids, and the first request of each adapter reuses no
    page (pages are hit only within an adapter), every later one does;
    Medusa K=4 under a1: ids == the baseline's under a1; the server:
    /v1/models lists the base and the adapters, `model` routes (8 greedy
    requests, each its B=1 generate's ids under the near-tie rule), an
    unknown model is a 404. Logged: a replay's device ms with the pack
    against the engine without it, base rows against adapted rows, at B=1
    and in the 8-slot batcher, beside the pack's bytes bound."""
    import urllib.error

    from llm_inference_lab_tpu_torch.core.batching import ContinuousBatcher
    from llm_inference_lab_tpu_torch.core.engine import Engine
    from llm_inference_lab_tpu_torch.server import InferenceServer

    launches = {}
    ads = lora_adapters(eng.target.config)
    names = [None] + [a.name for a in ads]

    def engine(**kw):
        return Engine(replace(eng.config, **kw), device=dev, target_params=eng.target.params,
                      draft_params=eng.draft.params, lora_adapters=ads)

    t0 = time.perf_counter()
    le = engine()
    torch.cuda.synchronize()
    log(f"phase 23 LoRA engine: {LORA_N} adapters of rank {LORA_RANK} on "
        f"{'/'.join(LORA_TARGETS)}, pack {pack_bytes(le) / 1e6:.1f} MB "
        f"({pack_bytes(le) / LORA_N / 1e6:.1f} MB an adapter), built in "
        f"{time.perf_counter() - t0:.2f} s")
    ref_ids = eng.generate(PROMPT)["generated_ids"]
    for name in names:
        le.generate(PROMPT, adapter=name)  # warm-up (one decode state: one capture)
    runs, launches[paths[0]] = count_launches(
        paths[0], lambda: {n: [le.generate(PROMPT, adapter=n) for _ in range(3)] for n in names})
    b1 = {}
    for n, rs in runs.items():
        assert all(r["generated_ids"] == rs[0]["generated_ids"] for r in rs), (n, "repeat")
        b1[n] = rs[0]["generated_ids"]
        log(f"phase 23 LoRA generate, adapter {n}: {timing(rs)}")
    assert b1[None] == ref_ids, "base rows on the pack engine differ from phase 3's ids"
    ids_digest(paths[0], [b1[n] for n in names])
    prompt_ids = le.tokenizer.encode(PROMPT)
    base_logits = last_logits(le, dev, prompt_ids, None)
    assert torch.equal(base_logits, last_logits(eng, dev, prompt_ids)), "base row's logits moved"
    for a in ads:
        bite = (last_logits(le, dev, prompt_ids, a.name) - base_logits).abs().max().item()
        log(f"phase 23 adapter {a.name}: first step's max |delta logit| against the base "
            f"{bite:.4f} (floor {LORA_BITE}); ids differ from the base's: {b1[a.name] != ref_ids}")
        assert bite > LORA_BITE, (a.name, bite)

    # Step ms: the pack engine's B=1 state, rows at -1 and at a0, against
    # phase 3's engine without a pack (replays over inactive lanes run every
    # op of the branch-free step).
    (key,) = [k for k in le._decode_states if k[0] == 1]
    state, loop = le._decode_states[key]
    _, plain_loop = eng._decode_states[key]
    times = {}
    for what in ("no pack", "pack, base rows", "pack, adapted rows", "pack, base rows again",
                 "no pack again"):
        if what.startswith("pack"):
            with torch.inference_mode():  # the engine's state is an inference tensor
                state.lora_ids.fill_(0 if "adapted" in what else -1)
        times[what] = replay_ms(plain_loop if what.startswith("no pack") else loop)
    tgt_bytes = pack_bytes(le)  # one target forward a K=1 step reads the pack once
    log(f"phase 23 K=1 B=1 step device ms (replays, in turns): "
        + ", ".join(f"{w} {ms:.4f}" for w, ms in times.items())
        + f"; the pack's bytes bound {bound_ms(tgt_bytes, 0)[0]:.4f} ms a step "
          f"({tgt_bytes / 1e6:.1f} MB); the port's kernels launch "
          f"{sum(v for k, v in loop.per_replay.items() if k not in ('forwards', 'layers'))} "
          f"times a replay with the pack and without (the deltas are library ops)")

    # A bf16 3B with a0 against the same model with a0 merged.
    cfg16 = replace(eng.config, quantization=None, quantized_init=False, quantize_embed=False,
                    draft_model=None)
    bf = Engine(cfg16, device=dev, lora_adapters=ads[:1])
    merged_layers = dict(bf.target.params["layers"])
    for site, key_ in (("qkv", "w_qkv"), ("o", "wo"), ("gate_up", "w_gate_up"),
                       ("down", "w_down")):
        A, B = (torch.from_numpy(m).to(dev) for m in ads[0].weights[site])
        merged_layers[key_] = (merged_layers[key_].float() + A @ B).bfloat16()
        del A, B
    merged_layers = {k: v for k, v in merged_layers.items() if not k.startswith("lora_")}
    merged = Engine(cfg16, device=dev, target_params=dict(bf.target.params,
                                                          layers=merged_layers))
    got = bf.generate(PROMPT, adapter="a0")["generated_ids"]
    want = merged.generate(PROMPT)["generated_ids"]
    diff = (last_logits(bf, dev, prompt_ids, "a0") - last_logits(merged, dev, prompt_ids))
    tie = near_tie(bf, dev, PROMPT, want, got, "a0") if got != want else None
    log(f"phase 23 bf16 3B: adapter a0 ids {'==' if tie is None else 'part from'} the merged "
        f"weights' ids ({len(got)} ids){'' if tie is None else f' at {tie}'}; first step's "
        f"max |logit difference| {diff.abs().max().item():.5f}")
    assert tie is None or tie["gap_ulps"] <= 2, ("not a near tie", tie)
    del bf, merged, merged_layers
    free_card()

    unstable_ops = []

    def unstable():
        if not unstable_ops:
            unstable_ops.append([op for op, d in row_stability(eng, dev).items()
                                 if any(d.values())])
        return unstable_ops[0]

    # Phase 3b's requests with the adapters round-robin.
    serve_kw = dict(max_seq_len=SERVE_MAX_LEN, kv_layout="paged", kv_page_size=SERVE_PAGE)
    se = engine(**serve_kw)
    b = ContinuousBatcher(se, n_slots=SERVE_SLOTS)
    rr = [names[i % len(names)] for i in range(len(SERVE_PROMPTS))]
    for p, m, n in zip(SERVE_PROMPTS, SERVE_BUDGETS, rr):
        b.submit(p, max_new_tokens=m, lora=n)
    (results, peak), launches[paths[1]] = count_launches(paths[1], lambda: served(b, b.run))
    ids_digest(paths[1], [r["generated_ids"] for r in results])
    ref = {(p, n): le.generate(p, adapter=n)["generated_ids"] for p, n in zip(SERVE_PROMPTS, rr)}
    differ = sum(held_to(le, dev, unstable, f"generate under {n}", r["req_id"], p,
                         ref[(p, n)][: len(r["generated_ids"])], r["generated_ids"], adapter=n)
                 for r, p, n in zip(results, SERVE_PROMPTS, rr))
    log(f"phase 23 serving, adapters round-robin: " + serve_stats(b, peak)
        + f"; ids == each request's B=1 generate under its adapter for "
          f"{len(results) - differ} of {len(results)} (the rest near ties)")
    sst, sloop = b.state, b._loop
    # The same batcher without a pack (lanes inactive: the step's every op).
    nb = ContinuousBatcher(Engine(replace(eng.config, **serve_kw), device=dev,
                                  target_params=eng.target.params,
                                  draft_params=eng.draft.params), n_slots=SERVE_SLOTS)
    with torch.inference_mode():
        nb._loop(nb.state, 1)  # its capture
    t8 = {"no pack": replay_ms(nb._loop)}
    for what, ids in (("pack, base rows", [-1] * SERVE_SLOTS),
                      ("pack, rows round-robin", [(-1, 0, 1, 2)[i % 4]
                                                  for i in range(SERVE_SLOTS)]),
                      ("pack, base rows again", [-1] * SERVE_SLOTS)):
        with torch.inference_mode():
            sst.lora_ids.copy_(torch.tensor(ids, dtype=torch.int32, device=dev))
        t8[what] = replay_ms(sloop)
    t8["no pack again"] = replay_ms(nb._loop)
    del nb
    log("phase 23 8-slot K=1 step device ms (replays, in turns): "
        + ", ".join(f"{w} {ms:.4f}" for w, ms in t8.items()))
    del b, se

    # Phase 14's system prompt under two adapters, prefix caching off and on.
    prompts = [SYSTEM_PREFIX + p for p in SERVE_PROMPTS]
    two = ["a0", "a1"]
    pre = {}
    for on in (False, True):
        pb = ContinuousBatcher(engine(kv_layout="paged", kv_page_size=SERVE_PAGE,
                                      max_seq_len=PREFIX_MAX_LEN, prefix_caching=on), SERVE_SLOTS)

        def serve(pb=pb):
            for i in range(2):  # each adapter's first request admitted alone, in turn
                pb.submit(prompts[i], max_new_tokens=SERVE_BUDGETS[i], lora=two[i])
                pb._admit_pending()
            for i in range(2, len(prompts)):
                pb.submit(prompts[i], max_new_tokens=SERVE_BUDGETS[i], lora=two[i % 2])
            return pb.run()

        if on:
            (rs, peak), launches[paths[2]] = count_launches(paths[2], lambda: served(pb, serve))
        else:
            rs, peak = served(pb, serve)
        pre[on] = rs
        log(f"phase 23 prefix caching {'on' if on else 'off'} under a0 and a1: "
            + serve_stats(pb, peak) + (f", pages hit {pb.allocator.hits}" if on else ""))
    reused = [r["prompt_tokens_reused"] for r in pre[True]]
    assert reused[0] == reused[1] == 0 and all(n > 0 for n in reused[2:]), reused
    assert all(r["prompt_tokens_reused"] == 0 for r in pre[False])
    ids_digest(paths[2], [r["generated_ids"] for r in pre[True]])
    differ = sum(held_to(le, dev, unstable, "the uncached batcher", r["req_id"], p,
                         o["generated_ids"], r["generated_ids"], adapter=two[i % 2])
                 for i, (r, o, p) in enumerate(zip(pre[True], pre[False], prompts)))
    log(f"phase 23 prefix caching under two adapters: reused {reused}; cached ids == uncached "
        f"for {len(prompts) - differ} of {len(prompts)} (the rest near ties); the second "
        f"adapter's first request reused none of the first's pages")

    # Medusa K=4 under a1.
    med = Engine(replace(eng.config, draft_model=None, draft_mode="medusa", max_draft=MEDUSA_K),
                 device=dev, target_params=eng.target.params, lora_adapters=ads)
    med.generate(PROMPT, adapter="a1")
    mrs, launches[paths[3]] = count_launches(
        paths[3], lambda: [med.generate(PROMPT, adapter="a1") for _ in range(3)])
    base_a1 = Engine(replace(eng.config, draft_model=None), device=dev,
                     target_params=eng.target.params, lora_adapters=ads)
    assert mrs[0]["generated_ids"] == base_a1.generate(PROMPT, adapter="a1")["generated_ids"], (
        "medusa under a1 differs from the baseline under a1")
    ids_digest(paths[3], [mrs[0]["generated_ids"]])
    log(f"phase 23 Medusa K={MEDUSA_K} under a1: {timing(mrs)}, {step_stats(mrs)}; ids == the "
        f"baseline's under a1")
    del med, base_a1

    # The server: /v1/models, `model` routing, the 404; embeddings ride it.
    srv_eng = engine(**serve_kw)
    server = InferenceServer(srv_eng, n_slots=SERVE_SLOTS, port=0)
    records = []
    inner_finalize = server._finalize

    def finalize(pend):
        records.append((pend.prompt, pend.sampling.get("lora"), pend.result["generated_ids"]))
        inner_finalize(pend)

    server._finalize = finalize
    server.start()
    try:
        port = server.port
        listed = json.loads(urllib_get(port, "/v1/models"))["data"]
        assert [m["id"] for m in listed] == [eng.config.base_model] + [a.name for a in ads]
        assert all(m.get("parent") == eng.config.base_model for m in listed[1:])
        models = [eng.config.base_model] + [a.name for a in ads]
        bodies = [dict(prompt=p, max_tokens=16, model=models[i % len(models)])
                  for i, p in enumerate(SERVE_PROMPTS[:8])]
        http_post(port, "/v1/completions", dict(prompt=PROMPT, max_tokens=4))  # warm-up
        records.clear()
        (outs, wall), launches[paths[4]] = count_launches(
            paths[4], lambda: post_all(port, bodies, SERVE_SLOTS))
        differ = 0
        for body in bodies:
            n = None if body["model"] == eng.config.base_model else body["model"]
            (got,) = [ids for p, lo, ids in records if p == body["prompt"] and lo == n]
            want = le.generate(body["prompt"], adapter=n)["generated_ids"][:16]
            differ += held_to(le, dev, unstable, "B=1 generate", body["model"],
                              body["prompt"], want, got, adapter=n)
        try:
            http_post(port, "/v1/completions", dict(prompt="x", model="ghost"))
            refused = None
        except urllib.error.HTTPError as err:
            refused = (err.code, json.loads(err.read())["error"])
        assert refused == (404, "model 'ghost' not found (base or a loaded LoRA adapter)"), (
            refused)
        log(f"phase 23 server: /v1/models {[m['id'] for m in listed]}; 8 requests routed by "
            f"model in {wall:.3f} s, ids == B=1 generate under the named adapter for "
            f"{8 - differ} of 8 (the rest near ties); 'ghost' -> 404")
        embed_over_http(port, srv_eng)
    finally:
        server.stop()
    del server, srv_eng, le
    free_card()
    return launches


def embed_over_http(port, eng):
    """/v1/embeddings on the server: float and base64 give the same vectors,
    equal to Engine.embed's on the engine thread."""
    import base64

    import numpy as np

    texts = EMBED_TEXTS[:8]
    fl = http_post(port, "/v1/embeddings", dict(input=texts))
    b64 = http_post(port, "/v1/embeddings", dict(input=texts, encoding_format="base64"))
    a = np.array([d["embedding"] for d in fl["data"]], np.float32)
    b = np.stack([np.frombuffer(base64.b64decode(d["embedding"]), "<f4") for d in b64["data"]])
    assert a.shape == (8, eng.target.config.d_model) and np.array_equal(a, b)
    np.testing.assert_allclose(np.linalg.norm(a, axis=-1), 1.0, atol=1e-5)
    log(f"phase 23 /v1/embeddings: 8 inputs, float == base64 vectors, norms 1, usage "
        f"{fl['usage']}")


def phase_embed(dev, eng, path):
    """Phase 23 (b) on phase 3's target: Engine.embed of EMBED_TEXTS (64
    texts of 9-135 tokens), mean and last pooling, counted (no decode loop:
    count_eager): every row's norm 1, each text alone within EMBED_COS of
    its row of the batch (cosine; alone it pads to another length and its
    projections take A's decode body, the batch's the tensor-core path),
    mean and last differ; the call's ms and peak memory logged."""
    import numpy as np

    eng.embed(EMBED_TEXTS[:2])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mb = torch.cuda.memory_allocated() / 1e6
    t0 = time.perf_counter()
    (out, launches) = count_eager(path, lambda: {p: eng.embed(EMBED_TEXTS, pooling=p)
                                                 for p in ("mean", "last")})
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 2
    peak = torch.cuda.max_memory_allocated() / 1e6 - base_mb
    for pooling, (emb, n_tok) in out.items():
        assert emb.shape == (64, eng.target.config.d_model) and np.isfinite(emb).all()
        np.testing.assert_allclose(np.linalg.norm(emb, axis=-1), 1.0, atol=1e-5)
        cos = [float(np.dot(eng.embed([EMBED_TEXTS[i]], pooling=pooling)[0][0], emb[i]))
               for i in range(0, len(EMBED_TEXTS), 9)]
        log(f"phase 23 embed {pooling}: 64 texts, {n_tok} tokens, norms 1; alone against the "
            f"batch: cosine min {min(cos):.6f} (floor {EMBED_COS})")
        assert min(cos) >= EMBED_COS, (pooling, cos)
    # Random weights give nearly one hidden row at every position: the two
    # poolings part in the low bits only, so only that they part is asserted.
    gap = float(np.abs(out["mean"][0] - out["last"][0]).max())
    assert gap > 0, "mean and last pooling gave the same vector"
    log(f"phase 23 embed: {wall * 1e3:.1f} ms a call of 64 texts (P = 160), peak memory "
        f"+{peak:.1f} MB over the engine's; max |mean - last| of text 0 {gap:.6f}")
    return launches


def phase_head_f32(dev):
    """Kernel A's f32 instantiation (the EmbedQuant4 tied head) at the 3B's
    and the 1B's head widths, K = d_model, N = 128,256, M = HEAD_F32_M:
    within the f32 summation bound of the plain version (quant_matmul_plain,
    f32 out), the bf16 instantiation's output exactly the f32 one rounded,
    every row the same bits at every M of the decode body; timed beside the
    plain version, the library call (dequantize, then torch.mm with an f32
    output) and the bound. Returns (one K=1 B=1 step's two heads, the 3B's
    head at M = 104: the ngram K=12 8-slot verify) as kernel rows."""
    from llm_inference_lab_tpu_torch.ops.quant import QuantTensor, dequantize
    from llm_inference_lab_tpu_torch.ops.quant_matmul import (
        quant_matmul,
        quant_matmul_f32,
        quant_matmul_plain,
    )

    g = torch.Generator(device=dev).manual_seed(23)
    rows, max_err = {}, 0.0
    for K in HEAD_F32_K:
        N = HEAD_V
        w = torch.randint(-128, 128, (2, K // 2, N), generator=g, dtype=torch.int8, device=dev)
        sc = torch.rand((2, N), generator=g, device=dev) * (0.02 / 7) + 1e-5
        x = torch.randn((max(HEAD_F32_M), K), generator=g, device=dev).bfloat16()
        wint = dequantize(QuantTensor(w[0], torch.ones_like(sc[0]), 4), torch.float32)
        alone = torch.cat([quant_matmul_f32(x[i:i + 1], w[0], sc[0]) for i in range(5)])
        for M in HEAD_F32_M:
            got = quant_matmul_f32(x[:M], w[0], sc[0])
            ref = quant_matmul_plain(x[:M], w[0], sc[0], out_dtype=torch.float32)
            bound = f32_sum_bound(x[:M], wint, sc[0])
            err = (got - ref).abs()
            assert got.dtype == torch.float32 and torch.all(err <= bound), (K, M)
            assert torch.equal(quant_matmul(x[:M], w[0], sc[0]), got.bfloat16()), (K, M)
            if M <= 5:
                assert torch.equal(got, alone[:M]), (K, M, "rows depend on M")
            max_err = max(max_err, err.max().item())
        del wint
        cyc = Cycle(2)
        line = []
        for M in HEAD_F32_M:
            xm = x[:M]
            ms = median_ms(lambda: quant_matmul_f32(xm, w[cyc()], sc[cyc.i]))
            pl = median_ms(lambda: quant_matmul_plain(xm, w[cyc()], sc[cyc.i],
                                                      out_dtype=torch.float32), iters=3, warmup=1)
            lib = median_ms(lambda: torch.mm(xm, dequantize(QuantTensor(w[cyc()], sc[cyc.i], 4),
                                                            torch.bfloat16),
                                             out_dtype=torch.float32), iters=10)
            b, by = bound_ms(K // 2 * N + 4 * N + 2 * M * K + 4 * M * N, 2 * M * K * N)
            rows[(K, N, M)] = dict(ms=ms, plain_ms=pl, library_ms=lib, bound_ms=b, bound_by=by)
            line.append(f"M={M} {ms:.4f} ms (bound {b:.4f} {by}, {b / ms:.3f} of it) plain "
                        f"{pl:.4f} library {lib:.4f} ({ms / lib:.2f}x)")
        log(f"quant_matmul_int4_f32 (EmbedQuant4 head) K={K} N={N}: within the f32 summation "
            f"bound of the plain version, the bf16 kernel its rounding, rows the same bits at "
            f"M = 1-5; " + "; ".join(line))
        del w, sc, x
    step = [(HEAD_F32_K[1], HEAD_V, 1, 1), (HEAD_F32_K[0], HEAD_V, 2, 1)]
    verify = [(HEAD_F32_K[0], HEAD_V, 104, 1)]
    return sum_rows(rows, step, max_err), sum_rows(rows, verify, max_err)


def phase_embed4(dev, eng, paths):
    """Phase 23 (c): the main path with the int4 embedding and tied head
    (INT4_CFG with embed_bits=4: random weights from the same seed; the
    head through kernel A's f32 instantiation). B=1 generate, three runs
    counted, in turns with phase 3's engine (tok/s and ms a step, against
    the 4.3-4.9 ms predicted); graph ids == host-loop ids; spec ids ==
    baseline ids; phase 3b's requests through the 8-slot paged batcher,
    each the start of B=1 generate's ids (near-tie rule); a save_params /
    load_params round trip of the table (__e4data__), byte-equal."""
    import os
    import tempfile

    from llm_inference_lab_tpu_torch.config import EngineConfig
    from llm_inference_lab_tpu_torch.core.batching import ContinuousBatcher
    from llm_inference_lab_tpu_torch.core.engine import Engine
    from llm_inference_lab_tpu_torch.models import checkpoint
    from llm_inference_lab_tpu_torch.ops.quant import EmbedQuant4

    launches = {}
    t0 = time.perf_counter()
    e4 = Engine(EngineConfig(**INT4_CFG, embed_bits=4), device=dev)
    torch.cuda.synchronize()
    assert isinstance(e4.target.params["embed"], EmbedQuant4)
    assert isinstance(e4.draft.params["embed"], EmbedQuant4)
    tables = sum(m.params["embed"].qt.data.numel() + m.params["embed"].rq.numel()
                 for m in (e4.target, e4.draft))
    log(f"phase 23 int4-embedding engine: built in {time.perf_counter() - t0:.1f} s; both "
        f"tables' two layouts {tables / 1e6:.1f} MB (head layout read a step: "
        f"{tables / 2e6:.1f} MB)")
    e4.generate(PROMPT)
    graph_report("generate (int4 embedding)", engine_loops("B, max_len", e4))
    runs, launches[paths[0]] = count_launches(paths[0],
                                              lambda: [e4.generate(PROMPT) for _ in range(3)])
    ids = runs[0]["generated_ids"]
    assert all(r["generated_ids"] == ids for r in runs) and runs[0]["generated_tokens"] >= 1
    assert all(math.isfinite(x) for r in runs for x in r["token_logprobs"])
    ids_digest(paths[0], [ids])
    base = Engine(replace(e4.config, draft_model=None), device=dev,
                  target_params=e4.target.params)
    assert base.generate(PROMPT)["generated_ids"] == ids, "int4-embedding spec != baseline"
    del base
    host = host_engine(e4)
    same_decode("int4 embedding", [host.generate(PROMPT)], runs[:1])
    del host
    turns = [e.generate(PROMPT) for e in (eng, e4, e4, eng)]
    log(f"phase 23 int4 embedding B=1 (in turns with phase 3's int8 embedding): "
        f"{timing(turns[1:3])}; phase 3's engine {timing(turns[::3])}; graph ids == host "
        f"loop ids, spec ids == baseline ids; predicted 4.3-4.9 ms a step")
    (key,) = [k for k in e4._decode_states if k[0] == 1]
    step = {"int4 embedding": replay_ms(e4._decode_states[key][1])}
    if key in eng._decode_states:
        step["int8 embedding (phase 3)"] = replay_ms(eng._decode_states[key][1])
        step["int4 embedding again"] = replay_ms(e4._decode_states[key][1])
    log("phase 23 K=1 B=1 step device ms (replays): "
        + ", ".join(f"{w} {ms:.4f}" for w, ms in step.items()))

    serve_kw = dict(max_seq_len=SERVE_MAX_LEN, kv_layout="paged", kv_page_size=SERVE_PAGE)
    b = ContinuousBatcher(Engine(replace(e4.config, **serve_kw), device=dev,
                                 target_params=e4.target.params, draft_params=e4.draft.params),
                          n_slots=SERVE_SLOTS)
    for p, m in zip(SERVE_PROMPTS, SERVE_BUDGETS):
        b.submit(p, max_new_tokens=m)
    (results, peak), launches[paths[1]] = count_launches(paths[1], lambda: served(b, b.run))
    ids_digest(paths[1], [r["generated_ids"] for r in results])
    stab = []

    def unstable():
        if not stab:
            stab.append([op for op, d in row_stability(e4, dev).items() if any(d.values())])
        return stab[0]

    ref = {p: e4.generate(p)["generated_ids"] for p in dict.fromkeys(SERVE_PROMPTS)}
    differ = sum(held_to(e4, dev, unstable, "generate (int4 embedding)", r["req_id"], p,
                         ref[p][: len(r["generated_ids"])], r["generated_ids"])
                 for r, p in zip(results, SERVE_PROMPTS))
    log(f"phase 23 int4-embedding serving: " + serve_stats(b, peak)
        + f"; ids == the start of B=1 generate's for {len(results) - differ} of {len(results)} "
          "(the rest near ties)")
    del b

    table = e4.target.params["embed"]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "embed4.safetensors")
        t0 = time.perf_counter()
        checkpoint.save_params({"embed": table}, path)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = checkpoint.load_params(path, device=dev)["embed"]
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        assert isinstance(back, EmbedQuant4)
        for a, c in ((table.qt.data, back.qt.data), (table.qt.scale, back.qt.scale),
                     (table.rq, back.rq)):
            assert a.dtype == c.dtype and torch.equal(a, c), "EmbedQuant4 round trip"
        log(f"phase 23 EmbedQuant4 checkpoint (__e4data__ + __e4scale__, "
            f"{os.path.getsize(path) / 1e6:.1f} MB): saved in {save_s:.2f} s, loaded in "
            f"{load_s:.2f} s, head and row layouts and scales byte-equal")
    del e4
    free_card()
    return launches


# ------------------------------------------ phase 24: the pipelined serving loop
def device_spans(b, names):
    """Wrap the batcher's methods `names` (instance attributes, which its
    own calls reach; each call goes to the class's method of the moment, so
    count_launches' taps see it): CUDA events around each outermost call of
    them. Returns the list the spans go into: (name, start event, end
    event). The wrappers hold the batcher weakly."""
    marks, depth, ref = [], [0], weakref.ref(b)
    for name in names:
        def call(*a, name=name, **kw):
            inner = getattr(type(ref()), name).__get__(ref())
            if depth[0]:
                return inner(*a, **kw)
            e0 = torch.cuda.Event(enable_timing=True)
            e0.record()
            depth[0] += 1
            try:
                return inner(*a, **kw)
            finally:
                depth[0] -= 1
                e1 = torch.cuda.Event(enable_timing=True)
                e1.record()
                marks.append((name, e0, e1))

        setattr(b, name, call)
    return marks


def span_ms(marks):
    """The device ms of device_spans' marks, summed (the card synchronized)."""
    torch.cuda.synchronize()
    return sum(e0.elapsed_time(e1) for _, e0, e1 in marks)


def sync_serve(b):
    """The synchronous order through the batcher's public calls: admit,
    then step_chunk(POLL_EVERY), a poll of the state now, admit, until the
    queue and the slots are empty."""
    from llm_inference_lab_tpu_torch.core.batching import POLL_EVERY

    b._admit_pending()
    while any(r is not None for r in b._slots) or b.scheduler.pending():
        b.step_chunk(POLL_EVERY)
        b._retire_finished()
        b._admit_pending()
    torch.cuda.synchronize()
    return [b._done[i].result for i in sorted(b._done)]


def staggered_serve(b, reqs, arrivals=STAGGER_ARRIVALS):
    """JAX's server-loop order (server/serving.py:170-201) with `arrivals`
    requests submitted after every chunk (the rest at once while nothing
    decodes): snapshot, step_chunk(), _admit_overlapped, _prefetch_retire,
    _retire_finished(flags), _admit_post_poll. Returns the results by
    req_id."""
    queue = list(reqs)
    while True:
        for _ in range(arrivals):
            if queue:
                b.submit(*queue.pop(0))
        if not any(r is not None for r in b._slots):
            if not queue and not b.scheduler.pending():
                break
            b._admit_pending()
        flags = b.poll_flags_async()
        b.step_chunk()
        b._admit_overlapped()
        fresh = b._prefetch_retire(flags)
        b._retire_finished(fresh if fresh is not None else flags)
        b._admit_post_poll()
    torch.cuda.synchronize()
    return [b._done[i].result for i in sorted(b._done)]


def cost_fit(b):
    """The chunk cost model's two constants measured on a full 8-slot batch:
    chunks of 1 to POLL_EVERY steps, each followed by a poll of the state
    now (step_chunk(n), _retire_finished()), their host wall fitted by least
    squares: (the intercept, the host ms a poll cycle adds; the slope, the
    ms of a step), with a replay's device ms beside them."""
    import numpy as np

    from llm_inference_lab_tpu_torch.core.batching import POLL_EVERY

    for p in SERVE_PROMPTS[:SERVE_SLOTS]:
        b.submit(p, max_new_tokens=400)
    b._admit_pending()
    samples = []
    for rep in range(7):
        for n in range(1, POLL_EVERY + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            b.step_chunk(n)
            b._retire_finished()
            if rep:  # the first round warms up
                samples.append((n, (time.perf_counter() - t0) * 1e3))
    ns = [n for n, _ in samples]
    slope, intercept = (float(x) for x in np.polyfit(ns, [w for _, w in samples], 1))
    return intercept, slope, replay_ms(b._loop)


def phase_pipelined_serving(dev, eng, paths):
    """Phase 24 (a), (b), (d) and (e) on phase 3's int4 3B + 1B weights (K=1),
    8 paged slots of page 64, lanes of SERVE_MAX_LEN (docstring at the top).
    Returns the launches of (a)'s first pipelined run and (b)'s first run."""
    from llm_inference_lab_tpu_torch.config import EnvFlags
    from llm_inference_lab_tpu_torch.core.batching import ContinuousBatcher
    from llm_inference_lab_tpu_torch.core.engine import Engine
    from llm_inference_lab_tpu_torch.server import InferenceServer

    def engine(flags=None, **kw):
        cfg = replace(eng.config, **{**dict(max_seq_len=SERVE_MAX_LEN, kv_layout="paged",
                                            kv_page_size=SERVE_PAGE), **kw})
        return Engine(cfg, device=dev, flags=flags, target_params=eng.target.params,
                      draft_params=draft_params_of(eng))

    stability = []

    def unstable():
        if not stability:
            stability.append([op for op, d in row_stability(eng, dev).items()
                              if any(d.values())])
        return stability[0]

    launches = {}
    serve_eng = engine()
    reference = {p: eng.generate(p)["generated_ids"] for p in dict.fromkeys(SERVE_PROMPTS)}
    intercept, slope, replay = cost_fit(ContinuousBatcher(serve_eng, SERVE_SLOTS))
    log(f"24 chunk cost fit (8 slots, K=1; step_chunk(n) and a poll of the state now, n = 1 to "
        f"4, 6 rounds): {intercept:.3f} host ms a poll cycle + {slope:.3f} ms a step (a replay of "
        f"the step: {replay:.3f} device ms)")
    gc.collect()
    # (a) phase 3b's 16 requests: run() in turns with the synchronous order.
    turns, ids, first = [], {}, None
    for turn, order in enumerate(("pipelined", "synchronous", "pipelined", "synchronous")):
        b = ContinuousBatcher(serve_eng, SERVE_SLOTS)
        for p, m in zip(SERVE_PROMPTS, SERVE_BUDGETS):
            b.submit(p, max_new_tokens=m)
        if order == "pipelined":
            b.start_trace()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if turn == 0:
            rs, launches[paths[0]] = count_launches(paths[0], b.run)
        else:
            rs = b.run() if order == "pipelined" else sync_serve(b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = b.stats.report(SERVE_SLOTS)
        turns.append((order, st["committed_tokens"] / wall, wall))
        ids.setdefault(order, [r["generated_ids"] for r in rs])
        if turn < 2:
            log(f"24(a) {order} report: {json.dumps(st)}")
        if turn == 0:
            first = [r["generated_ids"] for r in rs]
            log(f"24(a) pipelined trace rows (t s, occupied slots, committed tokens, steps): "
                + json.dumps([[row['t'], row['occupied'], row['committed'], row['steps']]
                              for row in b.trace]))
        for r, prompt in zip(rs, SERVE_PROMPTS, strict=True):
            assert r["generated_tokens"] >= 1, ("24(a) empty result", order, r["req_id"])
        del b
        gc.collect()
    log("24(a) tok/s in turns (16 requests, wall around the call): "
        + ", ".join(f"{o} {tps:.2f} ({w:.3f} s)" for o, tps, w in turns))
    ids_digest(paths[0], first)
    differ = 0
    for rid, prompt in enumerate(SERVE_PROMPTS):
        for what, got in (("the synchronous order", ids["synchronous"][rid]),
                          ("B=1 generate", reference[prompt][:len(first[rid])]),
                          ("phase 3b", SERVED_IDS[PATH_SERVE_INT4][rid])):
            differ += held_to(eng, dev, unstable, what, rid, prompt, got, first[rid])
    log(f"24(a) pipelined ids == the synchronous order's, B=1 generate's and phase 3b's for "
        f"{48 - differ} of 48 comparisons (the rest near ties)")
    # (b) staggered arrivals, the admission switches off and on, in turns.
    reqs = [(SERVE_PROMPTS[i % len(SERVE_PROMPTS)], STAGGER_BUDGETS[i])
            for i in range(STAGGER_N)]
    switches = {"off": None, "overlap_admit": EnvFlags(overlap_admit=True),
                "fused_admit": EnvFlags(fused_admit=True)}
    engines = {name: engine(flags) for name, flags in switches.items()}
    rows, stagger_ids = [], {}
    for turn, name in enumerate(("off", "overlap_admit", "fused_admit", "off")):
        b = ContinuousBatcher(engines[name], SERVE_SLOTS)
        admits = device_spans(b, ("_execute_admissions", "_finish_admission",
                                  "_advance_admission", "_admit_group"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if turn == 0:
            rs, launches[paths[1]] = count_launches(paths[1], lambda: staggered_serve(b, reqs))
        else:
            rs = staggered_serve(b, reqs)
        wall = time.perf_counter() - t0
        st = b.stats.report(SERVE_SLOTS)
        replays, admit_span = b._loop.replays, span_ms(admits)
        step_ms = replay_ms(b._loop)
        rows.append(dict(turn=name, tok_s=round(st["committed_tokens"] / wall, 2),
                         wall_s=round(wall, 3), chunks=st["chunks"], steps=st["steps"],
                         admit_waves=st["admit_waves"], admit_fused=st["admit_fused"],
                         admit_share=round(st["admit_ms_total"] / (wall * 1e3), 4),
                         poll_wait_share=round(st["poll_wait_ms"] / (wall * 1e3), 4),
                         retire_share=round(st["retire_ms_total"] / (wall * 1e3), 4),
                         admit_ms_a_wave=round(st["admit_ms_total"] / max(st["admit_waves"], 1),
                                               2),
                         admit_span_ms=round(admit_span, 2), replays=replays,
                         replay_ms=round(step_ms, 3),
                         busy_share=[round(replays * step_ms / (wall * 1e3), 4),
                                     round((replays * step_ms + admit_span) / (wall * 1e3), 4)]))
        assert len(rs) == STAGGER_N and all(r["generated_tokens"] >= 1 for r in rs), name
        stagger_ids.setdefault(name, [r["generated_ids"] for r in rs])
        del b, admits
        gc.collect()
    log("24(b) staggered arrivals (32 requests, budgets 16-128, 2 submitted a chunk), in turns "
        "(admit_span_ms: CUDA events around each admission call, host enqueue gaps included, an "
        "upper bound of its device time; busy_share: the replays' device ms (replays x a "
        "replay's ms) over the wall, and with the admission spans added): " + json.dumps(rows))
    base = stagger_ids["off"]
    ids_digest(paths[1], base)
    differ = 0
    for name, got in stagger_ids.items():
        for rid, (g, (prompt, _)) in enumerate(zip(got, reqs, strict=True)):
            differ += held_to(eng, dev, unstable, f"staggered, {name} against off", rid,
                              prompt, base[rid], g)
    log(f"24(b) ids equal across the turns for {3 * STAGGER_N - differ} of {3 * STAGGER_N} "
        f"(the rest near ties)")
    del engines
    gc.collect()
    # (d) phase 16's HTTP clients over the loop, in turns with the direct batcher.
    srv_eng = engine(**SERVER_CFG)
    server = InferenceServer(srv_eng, n_slots=SERVE_SLOTS, port=0)
    direct = ContinuousBatcher(srv_eng, SERVE_SLOTS)
    records = {}
    inner_finalize = server._finalize

    def finalize(pend):
        records.setdefault(pend.prompt, pend.result["generated_ids"])
        inner_finalize(pend)

    server._finalize = finalize
    server.start()
    try:
        greedy = dict(temperature=0.0)
        bodies = [dict(prompt=p, max_tokens=m, **greedy)
                  for p, m in zip(SERVE_PROMPTS, SERVE_BUDGETS)]
        http_post(server.port, "/v1/completions", dict(prompt=PROMPT, max_tokens=8, **greedy))
        records.clear()
        http, dir_rs = [], None
        for what in ("direct", "HTTP", "HTTP", "direct"):
            if what == "direct":
                for p, m in zip(SERVE_PROMPTS, SERVE_BUDGETS):
                    direct.submit(p, max_new_tokens=m, **greedy)
                t0 = time.perf_counter()
                rs = direct.run()[-len(SERVE_PROMPTS):]
                http.append((what, sum(r["generated_tokens"] for r in rs)
                             / (time.perf_counter() - t0)))
                dir_rs = dir_rs or rs
            else:
                outs, wall = post_all(server.port, bodies, SERVER_CLIENTS)
                http.append((what, sum(o["usage"]["completion_tokens"] for o in outs) / wall))
        stats = json.loads(urllib_get(server.port, "/stats"))
    finally:
        server.stop()
    log("24(d) HTTP (8 clients) against the direct batcher, phase 3b's requests at temperature "
        "0, in turns: " + ", ".join(f"{w} {t:.2f} tok/s" for w, t in http)
        + f"; the server's loop_ms {stats['loop_ms']}, batcher {json.dumps(stats['batcher'])}")
    differ = sum(held_to(eng, dev, unstable, "the direct batcher (HTTP)", rid, prompt,
                         dir_rs[rid]["generated_ids"], records[prompt][:len(
                             dir_rs[rid]["generated_ids"])])
                 for rid, prompt in enumerate(dict.fromkeys(SERVE_PROMPTS)))
    log(f"24(d) HTTP ids == the direct batcher's for {len(records) - differ} of {len(records)} "
        "prompts (the rest near ties)")
    del server, direct, srv_eng
    gc.collect()
    # (e) profile_phases and a profiled generate on phase 3's engine.
    prof_eng = Engine(replace(eng.config, profile=True), device=dev,
                      target_params=eng.target.params, draft_params=draft_params_of(eng))
    r = prof_eng.generate(PROMPT)
    summary = prof_eng.profiler.summary()
    ph = summary["phase_ms"]
    assert ph is not None and "error" not in ph, ph
    assert ph["draft_ms"] > 0 and ph["verify_ms"] > 0 and ph["step_ms"] > 0, ph
    assert ph["commit_sample_ms"] >= -0.05 * ph["step_ms"], ph
    assert r["generated_ids"] == reference[PROMPT] or held_to(
        eng, dev, unstable, "phase 3 (profiled)", 0, PROMPT, reference[PROMPT],
        r["generated_ids"]) == 1
    b8 = prof_eng.profile_phases(batch=SERVE_SLOTS)
    log(f"24(e) profile_phases (CUDA-graph chains, slope of 10 and 40 links), B=1: "
        f"{json.dumps(ph)}; B={SERVE_SLOTS}: {json.dumps(b8)}; the profiled generate: step_ms "
        f"{json.dumps(summary['step_ms'])}, prefill_ms {json.dumps(summary['prefill_ms'])}, "
        f"acceptance histogram {summary['acceptance_histogram']}, memory {summary['memory']}")
    del prof_eng
    gc.collect()
    return launches


def phase_adaptive_serving(dev, eng):
    """Phase 24 (c) on phase 10's int8 3B ngram K=12 engine: both adaptive
    controllers in the batcher (8 paged slots of page 64, phase 3b's first 8
    prompts at ADAPTIVE_BUDGET tokens; target acceptance 0.95 over the text's
    0.83, so K walks down): the K after every poll (the scheduler's, or each
    slot's ctrl_k), and greedy ids equal to the fixed-K batcher's under the
    near-tie rule."""
    from llm_inference_lab_tpu_torch.core.batching import ContinuousBatcher
    from llm_inference_lab_tpu_torch.core.engine import Engine

    reqs = [(p, ADAPTIVE_BUDGET) for p in SERVE_PROMPTS[:SERVE_SLOTS]]
    params = dict(min_k=1, max_k=NGRAM_K, target_acceptance=0.95, window=8)
    unstable_ops = []

    def unstable():
        if not unstable_ops:
            unstable_ops.append([op for op, d in row_stability(eng, dev).items()
                                 if any(d.values())])
        return unstable_ops[0]

    out = {}
    for ctl in ("fixed", "adaptive", "adaptive-device"):
        cfg = replace(eng.config, max_seq_len=SERVE_MAX_LEN, kv_layout="paged",
                      kv_page_size=SERVE_PAGE, controller=ctl,
                      controller_params={} if ctl == "fixed" else params)
        b = ContinuousBatcher(Engine(cfg, device=dev, target_params=eng.target.params), SERVE_SLOTS)
        ks = []
        inner = b._retire_finished

        def poll(flags=None, b=b, ks=ks, inner=inner, ctl=ctl):
            inner(flags)
            ks.append(b.scheduler.k if ctl == "adaptive" else b.state.ctrl_k.tolist())

        b._retire_finished = poll
        for p, m in reqs:
            b.submit(p, max_new_tokens=m)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rs = b.run()
        wall = time.perf_counter() - t0
        st = b.stats.report(SERVE_SLOTS)
        out[ctl] = [r["generated_ids"] for r in rs]
        acc = sum(r["accepted"] for r in rs) / max(sum(r["proposed"] for r in rs), 1)
        tps = st["committed_tokens"] / wall
        log(f"24(c) ngram K={NGRAM_K} batcher, controller {ctl}: {tps:.2f} tok/s, acceptance "
            f"{acc:.4f}, {st['steps']} steps in {st['chunks']} chunks; K after each poll: "
            f"{ks if ctl != 'adaptive-device' else [k[0] for k in ks]}"
            + (f" (slot 0's; last poll all slots {ks[-1]})" if ctl == "adaptive-device" else "")
            + (f"; K loops captured {sorted(k for k, _ in b._k_loops)}" if ctl == "adaptive"
               else ""))
        if ctl == "adaptive":
            assert len(set(ks)) > 1, ("the host controller's K never moved", ks)
        del b
        gc.collect()
    differ = sum(held_to(eng, dev, unstable, f"the fixed-K batcher ({ctl})", rid, p,
                         out["fixed"][rid], out[ctl][rid])
                 for ctl in ("adaptive", "adaptive-device")
                 for rid, (p, _) in enumerate(reqs))
    log(f"24(c) adaptive batchers' ids == the fixed-K batcher's for {2 * len(reqs) - differ} of "
        f"{2 * len(reqs)} (the rest near ties)")


def free_card():
    """Collect dead engines (a reference cycle keeps a model's weights) and
    return the cached blocks, before the next model is built."""
    gc.collect()
    torch.cuda.empty_cache()
    log(f"card memory: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
        f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved")


def phase_prefix_prefill(dev):
    """Kernel E at phase 14b's prefix-cached admissions: the suffix's S
    queries from position PREFIX_TOKENS over one sequence's pages (SERVE_PAGE
    rows, shuffled) gathered into a view of T = PREFIX_MAX_LEN keys (the
    paged path of ops/attention.py for S > 32: gather_pages, then E), the
    query span shorter than the key span and starting past key 0, POISON in
    V past the last position, at the 3B's and the 1B's geometry and S = 64
    and 384 (a suffix's fewest and most rows): E within check_attn's
    tolerance of the plain version and the bits of E over the same keys laid
    out contiguously; then, at S = 192, a layer's gather of K and V timed
    beside E and beside SDPA given the same boolean mask (logged: the
    gather is the suffix path's extra cost)."""
    from llm_inference_lab_tpu_torch.models.paged import gather_pages
    from llm_inference_lab_tpu_torch.ops.attention import paged_attend
    from llm_inference_lab_tpu_torch.ops.flash_prefill import flash_prefill

    g = torch.Generator(device=dev).manual_seed(14)
    P, T, start = SERVE_PAGE, PREFIX_MAX_LEN, PREFIX_TOKENS
    M = T // P
    for D, (H, KVH) in GEOMS.items():
        kc = torch.randn((1, KVH, T, D), generator=g, device=dev).bfloat16()
        vc = torch.randn((1, KVH, T, D), generator=g, device=dev).bfloat16()
        table = (torch.randperm(M + 3, generator=g, device=dev)[:M] + 1)[None].to(torch.int32)
        pools = [torch.zeros((M + 4, KVH, P, D), device=dev, dtype=torch.bfloat16)
                 for _ in "kv"]
        for S in (64, 384, 192):
            vs = vc.clone()
            vs[:, :, start + S:] = POISON
            for src, dst in ((kc, pools[0]), (vs, pools[1])):
                dst[table[0].long()] = src[0].reshape(KVH, M, P, D).transpose(0, 1)
            q = torch.randn((1, S, H, D), generator=g, device=dev).bfloat16()
            pos = (start + torch.arange(S, device=dev, dtype=torch.int32))[None].contiguous()
            got = paged_attend(q, pools[0], pools[1], pos, table)
            err = check_attn(got, q, kc, vs, pos, what=("prefix suffix", D, S))
            assert torch.equal(flash_prefill(q, kc, vs, pos), got), (D, S, "gathered != laid out")
            if S != 192:
                log(f"flash_prefill prefix suffix S={S} from {start} over gathered pages "
                    f"(T={T}, D={D}): max_abs_err {err:.3g}; the bits of E over the keys "
                    f"laid out contiguously")
                continue
            gather = median_ms(lambda: (gather_pages(pools[0], table),
                                        gather_pages(pools[1], table)))
            kg, vg = gather_pages(pools[0], table), gather_pages(pools[1], table)
            ms = median_ms(lambda: flash_prefill(q, kg, vg, pos))
            mask = torch.arange(T, device=dev)[None, None, None, :] <= pos[:, None, :, None]
            lib = median_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q.transpose(1, 2), kg, vg, attn_mask=mask, enable_gqa=True), iters=10)
            log(f"prefix suffix S={S} over T={T} (D={D}) a layer: gather of K and V "
                f"{gather:.4f} ms, flash_prefill {ms:.4f} ms, library {lib:.4f} ms (SDPA, "
                f"boolean mask)")


# ------------------------------------------- phase 25: bench harness and CLI
def cli_command(*args):
    """`python -m llm_inference_lab_tpu_torch.cli` with args, from the
    checkout's root."""
    return [sys.executable, "-m", "llm_inference_lab_tpu_torch.cli", *args]


PHASE3_FLAGS = ("--config", os.path.join(ROOT, "configs", "llama32_pair.yaml"), "-k", "1",
                "--quantization", "int4", "--quantize-embed", "--quantized-init", "--seed", "0")
PHASE4_FLAGS = ("--config", os.path.join(ROOT, "configs", "llama32_int8.yaml"),
                "--quantized-init", "--kv-quantization", "int8", "--seed", "0")


def harness_cli_runs(paths):
    """(a) `cli run` on phase 3's and phase 4's engines, in two
    subprocesses at once (configs/llama32_pair.yaml with phase 3's settings
    as flags; configs/llama32_int8.yaml with the quantized init and the
    int8 KV of phase 4): each prints one JSON line whose text is its
    phase's."""
    from llm_inference_lab_tpu_torch.config import EngineConfig
    from llm_inference_lab_tpu_torch.cli import build_config, build_parser

    runs = {paths[0]: PHASE3_FLAGS, paths[2]: PHASE4_FLAGS}
    for path, flags in runs.items():  # the flags give the phase's engine
        cfg = build_config(build_parser().parse_args(["run", PROMPT, *flags]))
        want = EngineConfig(**(INT4_CFG if path == paths[0] else INT8_CFG))
        assert cfg == want, (path, cfg, want)
    t0 = time.perf_counter()
    procs = {path: subprocess.Popen(cli_command("run", PROMPT, *flags), cwd=ROOT,
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for path, flags in runs.items()}
    try:
        outs = {path: proc.communicate(timeout=HARNESS_TIMEOUT_S)
                for path, proc in procs.items()}
    finally:
        for proc in procs.values():
            proc.kill()
            proc.wait()
    for path, (out, err) in outs.items():
        assert procs[path].returncode == 0, (path, "cli run failed", err[-3000:])
        result = json.loads(out.strip().splitlines()[-1])
        assert "generated_ids" not in result
        assert result["text"] == END_TO_END_TEXT[path], (path, "cli run text != its phase's")
        log(f"cli run ({' '.join(runs[path])}): text == phase's ({path}); "
            f"{result['generated_tokens']} tokens, {result['steps']} steps, "
            f"{result['tokens_per_sec']:.2f} tok/s, acceptance {result['acceptance_rate']:.4f}")
    log(f"cli run: two subprocesses in {time.perf_counter() - t0:.1f} s")


def harness_k_sweep(dev, path):
    """(b) run_k_sweep at phase 3's engine settings for K = 1-4 over
    PROMPT_SUITE (one batch of 10), one iteration: every K a success (a
    caught failure fails the phase), each K's decode loop captured once
    at the warm-up's shape and replayed by the timed iteration."""
    from llm_inference_lab_tpu_torch.bench.k_sweep import PROMPT_SUITE, run_k_sweep
    from llm_inference_lab_tpu_torch.core.specstep import DecodeLoop

    cfg = dict(INT4_CFG)
    named = {k: cfg.pop(k) for k in ("base_model", "draft_model", "max_new_tokens",
                                     "quantization", "seed")}
    cfg.pop("max_draft")
    captured, inner = [], DecodeLoop._capture

    def capture(loop, state):
        captured.append(tuple(state.tokens.shape))
        return inner(loop, state)

    DecodeLoop._capture = capture
    try:
        out, launches = count_launches(path, lambda: run_k_sweep(
            implementation="hf", max_k=4, iterations=1, device=dev, **named, **cfg))
    finally:
        DecodeLoop._capture = inner
    rows = out["summary_results"]
    for k, row in rows.items():
        assert row["success_rate"] == 1.0 and "error" not in row, (k, row.get("error"))
    B = len(PROMPT_SUITE)
    assert len(captured) == len(rows) and all(shape[0] == B for shape in captured), captured
    assert out["system_info"]["backend"] == torch.device(dev).type, out["system_info"]
    log(f"k_sweep (B={B}, {named['max_new_tokens']} new tokens, 1 iteration; captures "
        f"{captured}, one a K): " + "; ".join(
            f"{k}: {row['tokens_per_sec']['mean']:.2f} tok/s a request, aggregate "
            f"{row['aggregate_tokens_per_sec']['mean']:.2f} tok/s, step "
            f"{row['step_latency_ms']['mean']:.3f} ms, acceptance "
            f"{row['acceptance_rate']['mean']:.4f}, set-up {row['setup_s']:.2f} s"
            for k, row in rows.items()))
    log(f"k_sweep system_info: {json.dumps(out['system_info'])}")
    return launches


def harness_compare(dev, path):
    """(c) compare_to_baseline on bench.py's prompt (one warm-up, three
    runs each): random weights accept nothing."""
    from llm_inference_lab_tpu_torch.bench.run_bench import BenchmarkRunner
    from llm_inference_lab_tpu_torch.config import EngineConfig

    def run():
        runner = BenchmarkRunner(mode="specdec", config=EngineConfig(**INT4_CFG), warmup=1,
                                 iterations=3, device=dev)
        return runner.compare_to_baseline([PROMPT], max_new_tokens=INT4_CFG["max_new_tokens"])

    out, launches = count_launches(path, run)
    spec, base = out["specdec"], out["baseline"]
    assert spec["tokens_per_sec"]["mean"] > 0 and base["tokens_per_sec"]["mean"] > 0
    assert base["acceptance_rate"]["mean"] == 0.0
    log(f"compare_to_baseline (3 runs each): spec {spec['tokens_per_sec']['median']:.2f} tok/s "
        f"(latency {spec['latency_ms']['median']:.2f} ms, acceptance "
        f"{spec['acceptance_rate']['mean']:.4f}), baseline {base['tokens_per_sec']['median']:.2f}"
        f" tok/s (latency {base['latency_ms']['median']:.2f} ms); speedup {out['speedup']:.4f}")
    return launches


def harness_stress(dev, path):
    """(d) run_stress: StressConfig's 200 requests of churn through 8 paged
    slots (page 64, lanes of SERVE_MAX_LEN) on phase 3's weights."""
    from llm_inference_lab_tpu_torch.bench.stress import StressConfig, run_stress
    from llm_inference_lab_tpu_torch.config import EngineConfig
    from llm_inference_lab_tpu_torch.core.engine import Engine

    cfg = EngineConfig(**INT4_CFG).override(max_seq_len=SERVE_MAX_LEN, kv_layout="paged",
                                           kv_page_size=SERVE_PAGE)
    eng = Engine(cfg, device=dev)
    stress_cfg = StressConfig(n_slots=SERVE_SLOTS)
    report, launches = count_launches(path, lambda: run_stress(eng, stress_cfg))
    assert report["completed"] == stress_cfg.total_requests and report["all_nonempty"], report
    assert report["latency_degradation"] < 2.5, report["latency_degradation"]
    first, last = report["first_window"], report["last_window"]
    log(f"stress ({report['completed']} requests, {SERVE_SLOTS} paged slots): "
        f"{report['tokens']} tokens in {report['wall_s']:.3f} s = "
        f"{report['tokens_per_sec']:.2f} tok/s, {report['decode_steps']} steps in "
        f"{report['polls']} polls; poll p50 {first['p50_ms']:.3f} -> {last['p50_ms']:.3f} ms, "
        f"p95 {first['p95_ms']:.3f} -> {last['p95_ms']:.3f} ms (degradation "
        f"{report['latency_degradation']:.4f}); RSS growth {report['rss_growth_mb']:.1f} MB, "
        f"device memory growth {report['device_mem_growth_mb']} MB")
    return launches


def forward_ms(evaluator, tokens, length, runs=3):
    """Median ms of one perplexity forward between CUDA events, the card
    idle before each (its eager ops queue faster than the card runs them,
    so the events time the card's work)."""
    times = []
    for _ in range(runs + 1):  # the first run warms the allocator
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        evaluator._nll(tokens, length)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times[1:])


def harness_perplexity(dev, path):
    """(e) the perplexity of the 3B in bf16 and of its int8 and int4 clones
    (quantized_clone: JAX's min_size 1024) over PPL_ROWS rows of PPL_S ids
    from the seed; one forward's device ms of each."""
    import numpy as np

    from llm_inference_lab_tpu_torch.bench.quality_eval import (
        PerplexityEvaluator,
        perplexity_delta,
        quantized_clone,
    )
    from llm_inference_lab_tpu_torch.models import registry

    model = registry.create(INT4_CFG["base_model"], device=dev, dtype=torch.bfloat16, seed=0)
    assert model.weights_source == "random", model.weights_source
    rng = np.random.default_rng(25)
    rows = [rng.integers(1, model.config.vocab_size, PPL_S).tolist() for _ in range(PPL_ROWS)]
    clones = {mode: quantized_clone(model, mode) for mode in ("int8", "int4")}

    def run():
        return {mode: perplexity_delta(model, clone, rows, max_seq_len=PPL_S)
                for mode, clone in clones.items()}

    deltas, launches = count_eager(path, run)
    tokens = torch.tensor(rows[:1], dtype=torch.int32, device=dev)
    length = torch.tensor([PPL_S], dtype=torch.int32, device=dev)
    ms = {name: forward_ms(PerplexityEvaluator(m, PPL_S), tokens, length)
          for name, m in (("bf16", model), *clones.items())}
    for mode, d in deltas.items():
        assert all(math.isfinite(d[k]) and d[k] > 1 for k in ("ppl_a", "ppl_b")), (mode, d)
    log(f"perplexity of the 3B over {PPL_ROWS} x {PPL_S} ids (random weights): bf16 "
        f"{deltas['int8']['ppl_a']:.4f}; " + "; ".join(
            f"{mode} {d['ppl_b']:.4f} (delta {d['delta']:+.4f}, "
            f"{d['delta'] / d['ppl_a']:+.3e} relative)" for mode, d in deltas.items())
        + f"; a forward of S = {PPL_S}: " + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items()))
    return launches


def harness_serve():
    """(f) `cli serve` (phase 3's engine, a contiguous cache, 8 slots) in a
    subprocess on a free port; BenchmarkRunner(mode="http") against it:
    healthy, every request a success. The subprocess is killed however
    the phase ends."""
    import select

    from llm_inference_lab_tpu_torch.bench.k_sweep import PROMPT_SUITE
    from llm_inference_lab_tpu_torch.bench.run_bench import BenchmarkRunner

    proc = subprocess.Popen(cli_command("serve", *PHASE3_FLAGS, "--port", "0", "--slots",
                                        str(SERVE_SLOTS)), cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    served = False
    try:
        t0 = time.perf_counter()
        ready, _, _ = select.select([proc.stdout], [], [], HARNESS_TIMEOUT_S)
        line = proc.stdout.readline() if ready else ""
        assert line, ("cli serve printed no address", proc.poll())
        url = json.loads(line)["serving"]
        log(f"cli serve: {url} after {time.perf_counter() - t0:.1f} s")
        runner = BenchmarkRunner(mode="http", server_url=url, iterations=1)
        out = runner.run(PROMPT_SUITE, max_new_tokens=32)
        assert out["healthy"] and out["success_rate"] == 1.0, out
        log(f"http runner against cli serve ({len(PROMPT_SUITE)} requests one at a time, 32 "
            f"new tokens): latency median {out['latency_ms']['median']:.2f} ms, "
            f"{out['tokens_per_sec']['median']:.2f} tok/s a request, success rate "
            f"{out['success_rate']}")
        served = True
    finally:
        proc.kill()
        _, err = proc.communicate(timeout=60)
        if not served:
            log(f"cli serve's stderr, its end: {err[-3000:]}")


def phase_harness(dev, paths):
    """Phase 25: the bench harness and the CLI at phase 3's main path."""
    harness_cli_runs(list(PATH_KERNELS))
    launches = {}
    for path, run in zip(paths, (harness_k_sweep, harness_compare, harness_stress,
                                 harness_perplexity)):
        t0 = time.perf_counter()
        launches[path] = run(dev, path)
        free_card()
        log(f"phase 25 {path} took {time.perf_counter() - t0:.1f} s")
    harness_serve()
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

# ------------------------------------------- phase 26: data and model axes
TP_SUMS = "tensor-parallel partial sums (kernel A's f32 partials added over the model axis)"


def sharded_shapes(dev):
    """Kernels A (both instantiations), D, E and F at the shapes a rank of
    model=2 gives them (3B: 12 of 24 q heads over 4 of 8 KV heads, w_qkv
    N = 2560, gate_up N = 8192, wo K = 1536 and w_down K = 4096 through the
    f32 instantiation; the 1B: 16/4 heads, N = 1536 and 8192, K = 1024 and
    4096), each against its plain version at decode rows (1, 2, 8) and a
    prefill (160): the f32 rows within phase 17's f32 summation bound
    (f32_sum_bound: the partials the model group adds must be f32, not bf16
    rounded), the rest within phase 2's tolerance. These launches are
    checks, outside every count."""
    from llm_inference_lab_tpu_torch.ops.flash_decode import flash_decode
    from llm_inference_lab_tpu_torch.ops.flash_prefill import flash_prefill
    from llm_inference_lab_tpu_torch.ops.paged_flash import paged_flash
    from llm_inference_lab_tpu_torch.ops.quant import QuantTensor, dequantize, quantize_int4
    from llm_inference_lab_tpu_torch.ops.quant_matmul import (
        quant_matmul,
        quant_matmul_f32,
        quant_matmul_plain,
    )

    g = torch.Generator(device=dev).manual_seed(26)
    errs = {}
    shapes = {"3B": [(3072, 2560, False), (3072, 8192, False), (1536, 3072, True),
                     (4096, 3072, True)],
              "1B": [(2048, 1536, False), (2048, 8192, False), (1024, 2048, True),
                     (4096, 2048, True)]}
    for model, widths in shapes.items():
        for K, N, f32 in widths:
            qt = quantize_int4(torch.randn((K, N), generator=g, device=dev) * 0.02)
            wint = (dequantize(QuantTensor(qt.data, torch.ones_like(qt.scale), 4), torch.float32)
                    if f32 else None)
            for M in (1, 2, 8, 160):
                x = torch.randn((M, K), generator=g, device=dev).bfloat16()
                ref = quant_matmul_plain(x, qt.data, qt.scale, out_dtype=torch.float32)
                if f32:
                    got = quant_matmul_f32(x, qt.data, qt.scale)
                    err = (got - ref).abs()
                    assert got.dtype == torch.float32 and torch.isfinite(got).all() and bool(
                        (err <= f32_sum_bound(x, wint, qt.scale)).all()), (model, K, N, M)
                    errs[("A f32", model, K, N, M)] = err.max().item()
                else:
                    got = quant_matmul(x, qt.data, qt.scale)
                    assert got.dtype == torch.bfloat16
                    errs[("A", model, K, N, M)] = qmm_within(4, got, ref)
            del wint
    for D, (H, KVH) in ((128, (12, 4)), (64, (16, 4))):
        for S in (1, 2):
            q, k, v, pos = flash_inputs(g, dev, 2, S, H, KVH, T_MAIN, D, P_MAIN)
            errs[("D", D, S)] = check_attn(flash_decode(q, k[0], v[0], pos), q, k[0], v[0], pos,
                                           what=("sharded flash_decode", D, S))
            last = [P_MAIN + b for b in range(4)]
            q, kc, vc, kp, vp, table, pos = paged_inputs(g, dev, 4, S, H, KVH, D, SERVE_PAGE,
                                                         last)
            errs[("F", D, S)] = check_attn(paged_flash(q, kp[0], vp[0], pos, table), q, kc[0],
                                           vc[0], pos, what=("sharded paged_flash", D, S))
        q, k, v, pos = flash_inputs(g, dev, 1, 160, H, KVH, T_MAIN, D, 159)
        errs[("E", D, 160)] = check_attn(flash_prefill(q, k[0], v[0], pos), q, k[0], v[0], pos,
                                         what=("sharded flash_prefill", D))
    log("phase 26 kernels at the model=2 shapes (A, A's f32 instantiation within the f32 "
        "summation bound, D, E, F against their plain versions): max_abs_err " + ", ".join(
            f"{'/'.join(map(str, key))} {err:.3g}" for key, err in errs.items()))


def rank_counts(path, run):
    """count_launches inside a rank: every wrapper's count, the forward
    counts and the loops' replay tallies set to 0, run(), then the eager
    launches plus each replay's captured ones (the data axis alone
    captures; under the model axis every step is eager). Asserts that
    exactly the path's kernels launched, rms_norm once a forward and
    add_rms_norm twice a layer. Also the host seconds in the model axis's
    collectives and in the batcher's control traffic."""
    from llm_inference_lab_tpu_torch.core.specstep import DecodeLoop
    from llm_inference_lab_tpu_torch.models import transformer
    from llm_inference_lab_tpu_torch.parallel.mesh import COLLECTIVES, CONTROL

    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    transformer.forward.calls = transformer.forward.layers = 0
    DecodeLoop.replayed.clear()
    for tally in (COLLECTIVES, CONTROL):
        tally.update(calls=0, seconds=0.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    replayed = dict(DecodeLoop.replayed)
    launches = {name: w.launches + replayed.get(name, 0) for name, w in wrappers.items()}
    forwards = transformer.forward.calls + replayed.get("forwards", 0)
    layers = transformer.forward.layers + replayed.get("layers", 0)
    launched = {name for name, n in launches.items() if n}
    assert launched == PATH_KERNELS[path], (path, "launched", launched, "expected",
                                            PATH_KERNELS[path])
    assert launches["rms_norm"] == forwards and launches["add_rms_norm"] == 2 * layers, (
        path, launches, forwards, layers)
    return out, dict(launches=launches, forwards=forwards, replays=replayed.get("replays", 0),
                     wall_s=wall, coll_calls=COLLECTIVES["calls"],
                     coll_s=COLLECTIVES["seconds"], control_calls=CONTROL["calls"],
                     control_s=CONTROL["seconds"])


def rank_generate():
    """Phase 26 (a), one rank of model=2: phase 3's engine (shard_draft: the
    1B's 8 KV heads split too) over the mesh; a prefill of phase 3's
    prompt and a decode chunk of 2 rows against the whole 3B's forward on
    the same weights (this rank builds it from the same seed); then a
    warm-up generate and a counted one."""
    from llm_inference_lab_tpu_torch.config import EngineConfig
    from llm_inference_lab_tpu_torch.core.engine import Engine
    from llm_inference_lab_tpu_torch.models import registry
    from llm_inference_lab_tpu_torch.parallel.mesh import make_mesh

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    mesh = make_mesh(data=1, model=2)
    cfg = EngineConfig(**dict(INT4_CFG, shard_draft=True))
    t0 = time.perf_counter()
    eng = Engine(cfg, device=dev, mesh=mesh)
    init_s = time.perf_counter() - t0
    whole = registry.create(cfg.base_model, device=dev, dtype=torch.bfloat16, seed=cfg.seed,
                            quantized_init="int4", quantize_embed=True)
    ids = eng.encode(PROMPT, cfg.max_new_tokens, cfg.max_seq_len)
    n = len(ids)
    logits = {}
    with torch.inference_mode():
        for name, model in (("whole", whole), ("tp", eng.target)):
            cache = model.init_cache(1, T_MAIN, dev)
            pre, _ = model.forward(torch.tensor([ids], device=dev, dtype=torch.int32),
                                   torch.arange(n, device=dev, dtype=torch.int32)[None], cache,
                                   torch.zeros((1,), device=dev, dtype=torch.int32))
            nxt = pre[0, -1].argmax().item()
            dec, _ = model.forward(torch.tensor([[ids[-1], nxt]], device=dev, dtype=torch.int32),
                                   torch.tensor([[n, n + 1]], device=dev, dtype=torch.int32),
                                   cache, torch.full((1,), n, device=dev, dtype=torch.int32))
            logits[name] = (pre[0], dec[0])
    err = {what: ((logits["tp"][i] - logits["whole"][i]).abs().max().item(),
                  logits["whole"][i].abs().max().item())
           for i, what in enumerate(("prefill", "decode"))}
    assert all(torch.isfinite(x).all() for pair in logits.values() for x in pair)
    del whole, logits
    torch.cuda.empty_cache()
    eng.generate(PROMPT)  # warm-up: every kernel's first launch
    r, counts = rank_counts(TP_PATH, lambda: eng.generate(PROMPT))
    lp = torch.tensor(r["token_logprobs"])
    assert len(lp) == r["generated_tokens"] and torch.isfinite(lp).all(), "bad logprobs"
    return dict(ids=r["generated_ids"], counts=counts, err=err, steps=r["steps"],
                decode_ms=r["generation_time_ms"], tok_s=r["tokens_per_sec"], init_s=init_s,
                ranks=mesh.size, coords=mesh.coords)


def rank_serve(model):
    """Phase 26 (b) and (c), one rank: phase 3b's 16 requests through a
    MultiHostBatcher of 8 slots (8 / data a rank) on phase 3's weights,
    paged (page 64, lanes of 1024), over data = ranks / model x model."""
    from llm_inference_lab_tpu_torch.config import EngineConfig
    from llm_inference_lab_tpu_torch.core.engine import Engine
    from llm_inference_lab_tpu_torch.core.multihost_batching import MultiHostBatcher
    from llm_inference_lab_tpu_torch.parallel.multihost import make_multihost_mesh

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    mesh = make_multihost_mesh(model_per_host=model)
    path = TPDP_PATH if model > 1 else DP_PATH
    cfg = EngineConfig(**dict(INT4_CFG, shard_draft=True, max_seq_len=SERVE_MAX_LEN,
                              kv_layout="paged", kv_page_size=SERVE_PAGE))
    eng = Engine(cfg, device=dev, mesh=mesh)
    b = MultiHostBatcher(eng, n_slots=SERVE_SLOTS)
    if b.is_coordinator:
        for prompt, budget in zip(SERVE_PROMPTS, SERVE_BUDGETS):
            b.submit(prompt, max_new_tokens=budget)
    results, counts = rank_counts(path, b.run)
    for r in results:
        lp = torch.tensor(r["token_logprobs"])
        assert r["generated_tokens"] >= 1 and torch.isfinite(lp).all(), ("bad result", r["req_id"])
    st = b.stats.report(SERVE_SLOTS)
    return dict(ids=[r["generated_ids"] for r in sorted(results, key=lambda r: r["req_id"])],
                counts=counts, stats=st, rows=b._rows, ranks=mesh.size, coords=mesh.coords)


def rank_report(what, got):
    """Log each rank's step time and the shares of its wall in the model
    axis's collectives and in the batcher's control traffic."""
    for r, g in enumerate(got):
        c = g["counts"]
        steps = g["steps"] if "steps" in g else g["stats"]["steps"]
        log(f"{what} rank {r} {g['coords']}: {c['wall_s'] * 1e3 / max(steps, 1):.3f} ms a step "
            f"({steps} steps in {c['wall_s']:.3f} s), model-axis collectives {c['coll_calls']} "
            f"calls {c['coll_s']:.3f} s = {c['coll_s'] / c['wall_s']:.1%} of the wall, control "
            f"traffic {c['control_calls']} calls {c['control_s']:.3f} s = "
            f"{c['control_s'] / c['wall_s']:.1%}; {c['forwards']} forwards, {c['replays']} graph "
            f"replays; launches { {k: v for k, v in c['launches'].items() if v} }")


def summed(got):
    """The ranks' launch counts added, kernel by kernel (the kernels line)."""
    return {name: sum(g["counts"]["launches"][name] for g in got)
            for name in got[0]["counts"]["launches"]}


def phase_parallel(dev, eng):
    """Phase 26: the data and model axes on the one card. Two or four
    processes share cuda:0 over gloo (NCCL refuses two ranks on one device),
    so their collectives go by the host: this shows that the kernels run
    right at the sharded shapes, that the ranks stay in step and that the
    ids hold to the single-process path; it does not measure
    tensor-parallel speed. The parent built every kernel before it spawns.
    (a) model=2: phase 3's engine generates phase 3's prompt at B=1; both
    ranks' ids equal; held to all of phase 3's ids (held_to, the partial
    sums one of the ops that may round differently); a prefill's and a
    decode chunk's logits against the whole model's. (b) data=2 and (c)
    data=2 x model=2: phase 3b's 16 requests through an 8-slot
    MultiHostBatcher, every rank's ids equal, each request held to phase
    3b's (the partial sums excused only in (c): (b) has none)."""
    from llm_inference_lab_tpu_torch.parallel.multihost import launch

    sharded_shapes(dev)

    def ops(model):  # the ops that may round differently: the partial sums under model > 1
        return lambda: ([TP_SUMS] if model > 1 else []) + UNSTABLE[PATH_SERVE_INT4]

    out = {}
    t0 = time.perf_counter()
    got = launch(rank_generate, 2, timeout=600)
    log(f"phase 26 (a) model=2 on 2 ranks: {time.perf_counter() - t0:.1f} s with the ranks' "
        f"start; engine init {[round(g['init_s'], 1) for g in got]} s")
    ids = got[0]["ids"]
    assert all(g["ids"] == ids for g in got), "the ranks' ids differ"
    for what, (err, top) in got[0]["err"].items():
        log(f"phase 26 (a) {what} logits, model=2 against the whole 3B: max_abs_err {err:.4g} "
            f"(largest |logit| {top:.4g})")
        assert err <= TP_LOGIT_RTOL * top, (what, err, top)
    parted = held_to(eng, dev, ops(2), "phase 3's generate", 0, PROMPT,
                     END_TO_END_IDS[PATH_GENERATE_INT4], ids)
    ids_digest(TP_PATH, [ids])
    log(f"phase 26 (a): ids == phase 3's: {not parted} ({parted} partings at near ties); "
        f"{got[0]['steps']} steps, {got[0]['tok_s']:.2f} tok/s")
    rank_report("phase 26 (a)", got)
    out[TP_PATH] = summed(got)
    for model, ranks, path, what in ((1, 2, DP_PATH, "(b) data=2"),
                                     (2, 4, TPDP_PATH, "(c) data=2 x model=2")):
        t0 = time.perf_counter()
        got = launch(rank_serve, ranks, args=(model,), timeout=600)
        log(f"phase 26 {what} on {ranks} ranks: {time.perf_counter() - t0:.1f} s with the "
            f"ranks' start")
        ids = got[0]["ids"]
        assert len(ids) == len(SERVE_PROMPTS)
        assert all(g["ids"] == ids for g in got), (what, "the ranks' ids differ")
        ref = SERVED_IDS[PATH_SERVE_INT4]
        parted = sum(held_to(eng, dev, ops(model), "phase 3b's batcher", rid, prompt, ref[rid],
                             got_ids)
                     for rid, (prompt, got_ids) in enumerate(zip(SERVE_PROMPTS, ids)))
        ids_digest(path, ids)
        st = got[0]["stats"]
        log(f"phase 26 {what}: ids == phase 3b's for {len(ids) - parted} of {len(ids)} "
            f"requests (the rest near ties); {got[0]['rows']} slots a rank; coordinator "
            f"{st['committed_tokens']} tokens in {st['wall_s']:.3f} s = {st['tok_s']:.2f} tok/s, "
            f"{st['steps']} steps, {st['admit_waves']} admission waves, page grows "
            f"{st['page_grows']}, preemptions {st['preemptions']}")
        rank_report(f"phase 26 {what}", got)
        out[path] = summed(got)
    return out


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
    kernels.update(phase_family_kernels(dev))
    head_step, head_verify = phase_head_f32(dev)
    kernels.update({
        "quant_matmul_int4_f32": (
            head_step, "qmm_decode.cuh", "ops/pallas/quant_matmul.py:76",
            "one K=1 B=1 step's two EmbedQuant4 tied heads (the 1B's at M = 1, the 3B's at "
            "M = 2; N = 128256, f32 out)"),
        "quant_matmul_int4_f32_mma": (
            head_verify, "qmm_mma.cuh", "ops/pallas/quant_matmul.py:76",
            "the 3B's EmbedQuant4 tied head at M = 104 (an 8-slot ngram K=12 verify; f32 "
            "out)"),
    })
    phase_prefix_prefill(dev)
    log(f"phase 2 took {time.perf_counter() - t0:.1f} s")
    profile = "--profile" in argv
    profile_gemma = profile or "--profile=gemma" in argv
    profile_mistral = profile or "--profile=mistral" in argv
    profile_sampling = profile or "--profile=sampling" in argv
    profile_heads = profile or "--profile=heads" in argv
    profile_server = profile or "--profile=server" in argv
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
    on_path.update(phase_parallel(dev, eng))
    log(f"phase 26 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    on_path.update(phase_sampling(dev, eng, profile_sampling, [
        path for path in paths if path.startswith(("generate int4 sampled", "generate int4 greedy"))]))
    log(f"phase 11 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    on_path.update(phase_heads(dev, eng, profile_heads, HEAD_PATHS))
    log(f"phase 13 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    on_path.update(phase_admission(dev, eng, ADMISSION_PATHS))
    log(f"phase 14 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    on_path[SERVER_PATH] = phase_server(dev, eng, profile_server, SERVER_PATH)
    log(f"phase 16 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    on_path.update(phase_grammars(dev, eng, GRAMMAR_PATHS[:4]))
    log(f"phase 22 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    on_path.update(phase_lora(dev, eng, LORA_PATHS))
    on_path[EMBED_PATH] = phase_embed(dev, eng, EMBED_PATH)
    on_path.update(phase_embed4(dev, eng, EMBED4_PATHS))
    log(f"phase 23 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    on_path.update(phase_pipelined_serving(dev, eng, PIPELINE_PATHS))
    log(f"phase 24 took {time.perf_counter() - t0:.1f} s")
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
    free_card()
    t0 = time.perf_counter()
    on_path.update(phase_harness(dev, HARNESS_PATHS))
    log(f"phase 25 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    eng, on_path[NGRAM_PATHS[0]] = phase_ngram(dev, profile, NGRAM_PATHS[0])
    on_path[NGRAM_PATHS[1]] = phase_serving(dev, eng, profile, SERVE_MAX_LEN, NGRAM_PATHS[1],
                                            f"3B int8 ngram K={NGRAM_K}")
    log(f"phase 10 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    on_path[GRAMMAR_PATHS[4]] = phase_grammar_ngram(dev, eng, GRAMMAR_PATHS[4])
    log(f"phase 22 (ngram) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_adaptive_serving(dev, eng)
    log(f"phase 24 (c) took {time.perf_counter() - t0:.1f} s")
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
    ring_launches, long_ids = phase_mistral_long(dev, eng, paths[8:13])
    on_path.update(ring_launches)
    log(f"phase 8 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    on_path[RING_SERVING_PATH] = phase_ring_serving(dev, eng, long_ids, RING_SERVING_PATH)
    log(f"phase 15 took {time.perf_counter() - t0:.1f} s")
    del eng
    free_card()
    t0 = time.perf_counter()
    eng, launches = phase_qwen(dev, QWEN_PATHS)
    on_path.update(launches)
    log(f"phase 17 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_checkpoints(dev, eng)
    log(f"phase 21 took {time.perf_counter() - t0:.1f} s")
    del eng
    free_card()
    t0 = time.perf_counter()
    on_path.update(phase_phi3(dev, PHI_PATHS))
    log(f"phase 18 took {time.perf_counter() - t0:.1f} s")
    free_card()
    t0 = time.perf_counter()
    on_path[MIXTRAL_PATH] = phase_mixtral(dev, MIXTRAL_PATH)
    log(f"phase 19 took {time.perf_counter() - t0:.1f} s")
    free_card()
    t0 = time.perf_counter()
    on_path.update(phase_baselines(dev))
    log(f"phase 20 took {time.perf_counter() - t0:.1f} s")

    # A row "<kernel>/<suffix>" counts the paths of its suffix.
    suffix_paths = {"gemma-2": GEMMA_PATHS, "ring": RING_PATHS, "ngram": NGRAM_PATHS,
                    "8b": EAGLE_PATHS, "qwen2.5": QWEN_PATHS, "phi3": PHI_PATHS}

    def counted(name):
        """The paths whose launches a row counts: a suffixed row (Gemma-2,
        ring, ngram, 8b, Qwen2.5, Phi-3) its suffix's paths; the bf16 D, E
        and F rows the other Llama paths and phases 19-20's, the int8 ones
        all but Mistral's (none launch there); every other row all paths
        less those where the kernel has a suffixed row of theirs."""
        if "/" in name:
            return suffix_paths[name.split("/", 1)[1]]
        rest = [path for path in paths
                if not any(f"{name}/{suffix}" in kernels and path in ps
                           for suffix, ps in suffix_paths.items())]
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
