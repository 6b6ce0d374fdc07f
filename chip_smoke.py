#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (an H100).

    python3 chip_smoke.py

Phases, one output line each (the kernel build also prints the compiler's
register / shared-memory / spill report):

  env        the card's name and power limit (nvidia-smi), torch, CUDA, nvcc
  build      compile every kernel of the main path from csrc/ with nvcc
  attention  the t5_attention_core kernel against its plain PyTorch version
             at the main path's shapes (B=32, L=557, H=32, dh=64, bf16), and
             its time beside the plain version's, one PyTorch library call's
             and the card's bound, and the bound of its two-pass route
             (q . k^T twice and p . v, the exponentials, the bytes); the
             bias tiled as the encoder tiles it, that copy timed too
  int8_kernels
             the int8 encoder kernels (fused_t5_ln_qkv_q8,
             fused_oproj_residual_q8, fused_t5_ffn_q8) against their plain
             versions at the int8 path's shapes (M = 32 x 557 rows, D = 2048,
             F = 5120, 8 groups, weights from the port's quantizer), with
             kernel, plain and torch._int_mm (GEMMs only) times and bounds;
             each also with each CUDA kernel's device ms under the profiler
             and its GEMM stage beside _int_mm of the same products (the
             q/k/v kernel's one stacked product beside the three of wq, wk
             and wv, the FFN's one up-product beside the two of wi_0 and
             wi_1), held within Q8_GEMM_STAGE_MAX_RATIO of it
  q8_boundary
             the .5-boundary check of the int8 kernels with a norm in front
             (fused_t5_ln_qkv_q8, fused_t5_ffn_q8 on int8_kernels' inputs;
             fused_qkv_q8, fused_mlp_block_q8 on vit_q8_kernels' 16
             images): the share of their activation codes (and of the
             hidden's) and of their outputs beyond one bf16 ulp that differ
             from the plain version run on the CPU on the same inputs, for
             the kernel and for the plain version run on the card; recorded,
             not held to a bound
  reference  the encoder at full width on a small input: kernel path against
             the plain materialised-bias path
  generate   VC-T0 few-shot generation at full T0-3B width and depth (random
             weights from a seed): 32 prompts of 512 tokens with 5 sentinels,
             an mlp mapper, 20 greedy tokens, run twice; the kernel must be
             launched once per encoder layer in each run
  breakdown  the same call's layers timed one by one (mapper and splice,
             encoder, greedy decode), each ending in a synchronize
  profile    one more call under torch.profiler: the device time of the
             call's kernels, their share of the timed (unprofiled) call's
             wall time, and the kernels that take the most device time
  generate_int8
             the int8 bulk-eval configuration (int8_encoder_ffn and
             int8_encoder_attn) on the same weights and prompts: SmoothQuant
             calibration on that batch, generate twice (each of the four
             encoder kernels launched once per layer in each run), its
             encode / decode breakdown and profile, the cosine of the int8
             encoder's output against the bf16 kernel path's, and the two
             configurations' generate calls timed in turns
  decode_attention
             the cross_attention_decode kernel against its plain version at
             the decode step's shapes (24 stacked layers of B=32, L=557,
             D=2048 bf16 caches, layer 7), with kernel, plain,
             scaled_dot_product_attention and bound times
  t5_ffn     the fused_t5_ffn kernel against its plain version at the
             encoder's shapes (M = 32 x 557 rows, D = 2048, F = 5120,
             gated, and non-gated on the same inputs), with kernel, plain,
             bound times and the unfused bf16 FFN's (three cuBLAS matmuls,
             gelu and gate) as the yardstick; also with each CUDA kernel's
             device ms (its RMSNorm, the paired up-GEMM and the residual
             down-GEMM on bf16_gemm_tma.cuh) and the GEMMs beside cuBLAS
             matmuls of the same products (the up pair as one matmul over
             [wi_0 | wi_1]), their sum held within
             BF16_GEMM_STAGE_MAX_RATIO of cuBLAS's
  fp32_kernels
             the fp32 forms that tpu.compute_dtype=float32 reaches, against
             their plain versions at the main path's shapes:
             t5_attention_core (fp32 q, k, v; B=32, L=557, 32 heads of 64;
             the CUDA-core kernel of attention_f32.cuh, its held route) and
             cross_attention_decode (fp32 (24, 32, 557, 2048) caches) within
             FP32_ATOL / FP32_RTOL, each also on B=4, L=130 (a length that
             is not a multiple of the 64-key tile), t5_attention_core also
             on FP32_LONG_LEN (its two-pass route), every case with one row
             of PADDED_KEYS masked keys and one fully masked row;
             t5_attention_core's held route and the two-pass route timed
             in turns at the main shape (the two-pass kernel through its
             own launcher), beside both routes' bounds and the function's
             (each dot as six exact bf16-plane products on the tensor
             cores, as rows 9, 11, 16 and 17 fp32 count theirs; its fp32
             FMA bound beside it); fused_t5_ffn on fp32 x (bf16 weights)
             by compare_q8's rule, as t5_ffn holds the bf16 form; each with kernel, plain, library
             and bound times and its launches a call; the fp32 forms of
             the int8 trio (fused_t5_ln_qkv_q8, fused_oproj_residual_q8,
             fused_t5_ffn_q8 on fp32 x, attention output and residual, an
             fp32 norm scale) at the int8 path's shapes by compare_q8's
             rule, with the share of activation codes off the plain
             version's on the card and q8_boundary's counts, torch._int_mm
             of their products as the yardstick; fused_gpt2_block's fp32
             form at B=32, L=64 and 128 (bf16 parameters) within the bf16
             form's whole-block rule, its output on bf16-valued x rounded
             to bf16 equal to the bf16 form's, timed in turns with an
             unfused fp32-activation block (bf16 addmm, SDPA)
  generate_fused
             the configuration with every fused kernel (fused_encoder_attention,
             fused_encoder_ffn, fused_decode_attention) on the same weights
             and prompts: generate twice (t5_attention_core and fused_t5_ffn
             24 launches, cross_attention_decode 24 per decode step run),
             its breakdown and profile, its tokens' agreement with the
             default path's (recorded, not gated), and the two
             configurations' calls timed in turns (bf16, fused, fused, bf16)
  generate_int8_all
             every int8 opt-in of base_env.jsonnet (int8_encoder_ffn,
             int8_encoder_attn, int8_cross_kv at the auto layout, which is
             unmerged at B=32, int8_decoder_step) with
             fused_encoder_attention: calibration and quantization (the
             decoder step W8A16, its bf16 weights dropped), generate twice,
             launches, peak memory, the params' size, breakdown and
             profile
  kv_layouts one decode step at full width and 2 decoder layers for each
             int8 cross-KV layout: unmerged and merged logits bit-equal,
             transposed close to them, each layout's cache bytes at rest
  generate_modes
             the other generate modes on the generate phase's weights and
             prompts, each called twice with every kernel's launches
             checked against the decode steps it ran (and their rows):
             beam search (K = 3, cross_attention_decode 24 launches a step
             on 96 rows), prefill_chunks=2 and force_eos_at on the generate
             phase's model (tokens equal to that phase's, and cut at each
             row's step), no_prefix, one-at-a-time (5 segments of 128
             tokens: one encode of 160 rows, the decode over 5 x 137 keys),
             prefix-only captioning and a forced decoder prefix (4 tokens)
             with cross_attention_decode; each with wall time, prompts/s,
             peak memory and launches
  vit_kernels
             the CLIP ViT split3 kernels (fused_ln_qkv, attention_core_oproj,
             fused_mlp_block) against their plain versions at ViT-L/14@336
             widths on 16 images (L = 577, D = 1024, 16 heads, F = 4096),
             then timed at the image encoder's batch of 256 beside the plain
             version, the bound and a library yardstick (layer_norm and
             cuBLAS matmuls; scaled_dot_product_attention); fused_ln_qkv
             and fused_mlp_block also with each CUDA kernel's device ms
             (the LayerNorm, and the q | k | v GEMM or the up and down
             GEMMs, on bf16_gemm_tma.cuh) and the GEMMs beside cuBLAS addmm
             of the same products alone, their sum held within
             BF16_GEMM_STAGE_MAX_RATIO of cuBLAS's;
             attention_core_oproj also with its attention stage timed alone
             and the bound of its two-pass route (operations, exponentials
             and bytes); at most 0.5 % of that stage's outputs may differ
             from plain (the share of the whole function's is recorded)
  vit_q8_kernels
             the int8 ViT kernels (fused_qkv_q8, attention_core with and
             without fast_exp, fused_mlp_block_q8) against their plain
             versions at ViT-L/14@336 widths on 16 and on 256 images
             (weights from the port's quantize_vision_blocks, which must
             give the same codes and scales on the card as on the CPU),
             timed at 256 beside the plain version, the bound and a library
             yardstick (torch._int_mm, GEMMs only; scaled_dot_product_attention);
             attention_core also beside its route's bound, at most 0.5 % of
             its outputs differing from plain; the int8 kernels with each
             CUDA kernel's device ms and their GEMM stage beside _int_mm,
             held within Q8_GEMM_STAGE_MAX_RATIO, fused_mlp_block_q8 also
             beside its route's bound (its fp32 hidden's round trip);
             attention_core with fast_exp held within the tolerance plus
             vit_fast_exp_flip_bound (one-ulp flips of bf16(s - max))
  vit_q8_kernels_f32 (in vit_q8_kernels, inputs from a generator of
             their own) the fp32 forms of fused_qkv_q8 and fused_mlp_block_q8
             (256 images at ViT-L/14@336, vit_q8_kernels' weights) and of
             fused_vit_block_q8 (1024 at ViT-B/32): fp32 x with fp32 or bf16
             LayerNorms and biases, bf16 x with fp32 ones, against their
             plain versions on 16 images and at the main shapes (bf16
             outputs by compare_q8's rule; rows 13 and 14 with fp32 x also
             within a relative Frobenius error of 1e-4, and 1e-4 of their
             codes off the card's plain version's; row 12 with fp32 x by
             block_q8_f32_rule, on its own attention output and r1), timed
             in turns with the bf16 form, beside the plain version, the
             bound and torch._int_mm of the same GEMMs
  vit_attention_edges
             attention_core (both orders) and attention_core_oproj against
             their plain versions on 2 images at every head size (16, 32,
             64, 128; D = 256) and L of 1, 50, 64, 65, 577 and 1025: a
             single key, ragged query and key tiles, a TMA box past L and a
             length beyond the whole blocks' shared-memory limit
  clip_encode
             ClipImageEncoder at ViT-L/14@336, batch 256, random bf16 weights
             from a seed and random normalised images: the default (plain)
             path, fused_block (the three split3 kernels) and int8 (the
             quantization timed once; fused_qkv_q8, attention_core and
             fused_mlp_block_q8), each called twice with 24 launches of each
             of its kernels per call and none of the others', with images/s,
             peak memory, the device's busy share, the calls in turns and
             the fused and int8 paths' per-row cosines against the default
             path's; one split_fe encode at 2 layers (attention_core with
             fast_exp and fused_mlp_block, 2 launches each) against the
             default path at that depth; one whole and one whole_dd encode
             at 2 layers (fused_vit_block, 2 launches each) against the
             split3 path at that depth; and one ClipTextEncoder call at
             CLIPTextConfig width (B = 512, L = 77)
  t5_quantizers
             the T5 int8 weight quantizers (_quant_stacked_i8, and through
             it quantize_encoder_ffn / _attn and quantize_decoder_step) at
             T0-3B widths and 2 layers: the same codes and scales on the card
             as on the CPU, bit for bit
  vit_short_kernels
             the ViT-B/32 whole-block kernels (fused_vit_block in its three
             softmax orders, fused_vit_block_q8 on weights from
             quantize_vision_blocks, fused_attention_block) against their
             plain versions on 16 and on 1024 images (L = 50, D = 768, 12
             heads, F = 3072), timed at 1024 beside the plain version, the
             bound and a library yardstick (the unfused bf16 block;
             torch._int_mm, GEMMs only; fp32 matmuls and
             scaled_dot_product_attention); fused_attention_block in its
             three forms (block_diag; without it in compute_dtype fp32 and
             bf16), each with its CUDA kernels' device ms and its two GEMMs
             on bf16_gemm_tma.cuh beside cuBLAS addmm, the fp32 forms also
             within one bf16 ulp of plain; fused_vit_block also with
             each CUDA kernel's device ms; fused_vit_block_q8 also with
             each CUDA kernel's device ms under the profiler (four
             row_quant, four GEMMs, the attention), each GEMM beside
             _int_mm of the same product and their sum held within
             Q8_GEMM_STAGE_MAX_RATIO of the library's
  clip_encode_b32
             ClipImageEncoder at ViT-B/32 (12 layers), batch 1024, random
             bf16 weights from a seed and random normalised images: the
             default path, fused (fused_block with fast_attention and
             fused_attention, as the JAX bench builds it: fused_vit_block),
             int8 (fused_vit_block_q8) and fused_attention
             (fused_attention_block), each called twice with 12 launches of
             its kernel per call and none of the others', with images/s,
             peak memory, the device's busy share, the calls in turns and
             each path's per-row cosines against the default path's; the
             int8 path's images/s beside the fused path's
  vit_whole_kernels_f32 (after vit_kernels_f32 and clip_encode_fp32)
             the fp32 forms of fused_vit_block (fp32 x with fp32 or bf16
             parameters, bf16 x with fp32 ones) and fused_attention_block
             (fp32 x and weights, and each with the other bf16) at ViT-B/32
             widths, and of flash_attention at ViT-L/14@336, against their
             plain versions on 16 images and at the main shapes (1024 and
             256 images), timed there in turns with the bf16 form, beside
             the plain version, the bound (fused_attention_block's: its
             route's, six bf16-plane products a product of fp32 operands,
             and the fp32 FMA bound beside it) and one library call of the
             same dtypes (TF32 off); fused_vit_block's whole_dd order and
             fused_attention_block past 128 tokens (attention_f32.cuh) at
             577 tokens on 16 images, timed; from a generator of its own
  clip_encode_b32_fp32
             ClipImageEncoder at ViT-B/32 (12 layers), batch 1024, fp32
             parameters and activations: the default path, fused_block
             (fused_vit_block), fused_attention (fused_attention_block) and
             use_pallas (flash_attention), as clip_encode_b32, 12 launches
             of the path's kernel a call, per-row cosine to the default
             path >= F32_COSINE_FLOOR; then ViT-L/14@336 in fp32 at 2
             layers: whole, whole_dd and use_pallas against the default
             path; from a generator of its own
  clip_encode_int8_fp32
             ClipImageEncoder(int8=True) with fp32 parameters and bf16 or
             fp32 activations against the default path of the same dtypes:
             ViT-L/14@336 on 256 images (24 launches a call each of
             fused_qkv_q8, attention_core, fused_mlp_block_q8) and ViT-B/32
             on 1024 (12 of fused_vit_block_q8), per-row cosine >=
             CLIP_COSINE_FLOOR; from a generator of its own
  config_generate
             the shipped configs/vqa2/few_shot_vqa_hotpotqa.jsonnet through
             the port's config path (main.parse_args_sys, process_config
             with --opts seed=SEED, build_model_from_config on the card):
             the T5Config and the mapper fields generate reads equal the
             in-code config's (the fields that differ are listed), every
             param leaf bit-equal to init_vct0_params(cfg, seed=SEED), then
             generate twice: t5_attention_core 24 launches a call and the
             generate phase's tokens, wall time and prompts/s (this phase
             and the two below run last, after every earlier phase, so
             that those run as they did before them)
  config_generate_fp32
             the same file with --opts tpu.compute_dtype=float32
             tpu.fused_ffn=True
             model_config.lm_config.fused_decode_attention=True (bf16
             params, fp32 activations): cfg.lm.dtype float32, generate
             twice with t5_attention_core and fused_t5_ffn 24 launches a
             call and cross_attention_decode 24 a decode step; the encoder
             states against the same model's unfused fp32 encode (plain
             PyTorch, TF32 off) within FP32_ENCODER_REL_ERR; the token
             agreement with the bf16 default (recorded), the device's busy
             share, peak memory and the encode / decode split
  bench_generate
             tools/bench_generate.py's body once at its defaults with one
             trial (random T0-3B weights, B=32, 512 tokens, 4 shots, 20
             steps): its JSON line; bench_generate_ensembles the same with
             --ensembles 3 --members_per_call 3 (three permutations of each
             prompt decoded as one 96-row call, the pick on the host)
  config_eval
             the few-shot VQA eval as a user runs it: the port's CLI
             (main.run --mode test) on the shipped config at full width
             (T0_3B, mlp mapper, 10 x 768 prefixes, random weights from the
             config's seed, SimpleTokenizer, 4 shots) over 70 synthetic val
             questions (batches of 32, 32 and 6) written with CLIP-embedding
             and RICES pickles into a temporary folder, the mapper from a
             checkpoint written with the port's save_checkpoint: one
             prediction a question in answers.pkl, the metric present and
             equal to answers.pkl scored again, the tokens
             of direct generate calls on the same collated batches,
             t5_attention_core 24 launches an encode (counted, and in a
             torch.profiler trace); questions/s of test(), generate
             seconds per batch, the host share and peak memory
  config_eval_int8
             the same on 32 questions with int8_encoder_ffn,
             int8_encoder_attn and int8_calibrate_batches=1: the executor
             calibrates on the first batch, rows 2-4 launch 24 times, and
             the tokens equal a direct calibrate_and_quantize_int8 and
             generate on that batch
  config_eval_fp32_int8
             config_eval_int8's run with tpu.compute_dtype=float32,
             tpu.fused_ffn and fused_decode_attention too: the int8 trio's
             and t5_attention_core's fp32 forms 24 launches a batch,
             cross_attention_decode 24 a decode step run, the tokens of a
             direct calibrate_and_quantize_int8 and generate on that
             batch, its fp32 encoder states finite
  config_eval_modes
             the same CLI run on 32 questions once in each of the paper's
             other eval modes: --no_prefix 1 with the hotpotqa_no_prefix
             template, one-at-a-time, --num_permutations_of_in_context_examples
             3 with tpu.ensemble_members_per_call 1 and 3 (equal answers),
             --ensemble_one_shots 1 (4 members) and num_beams 3; each with
             one prediction a question, the metric equal to answers.pkl
             scored again, t5_attention_core 24 launches a generate call,
             questions/s, generate seconds and peak memory (no_prefix and
             beams also against direct generate on the collated batch)
  train_step the mapper's captioning train step at T0-3B width and depth
             (random weights from SEED, the mlp mapper, B=32, 32-token
             captions, 10 prefix positions as the encoder's whole input) on
             one fixed batch: the kernels' route (t5_attention_core and
             fused_t5_ffn forward, 24 launches each a step; their XLA twins
             backward, no launch) against the unfused route: losses within
             TRAIN_LOSS_REL, the mapper gradients' cosine at least
             TRAIN_GRAD_COSINE and norms within TRAIN_GRAD_NORM_REL; under
             remat 48 launches each and the same loss; the raw wrappers
             refusing a grad-requiring input; TRAIN_STEPS AdamW steps of
             each route in turns with the forward / backward / optimizer
             split, examples/s and peak memory; the loss falling over
             DESCENT_STEPS steps; the device's busy share and largest
             kernels traced in a process of its own (--trace-train-step)
  config_train
             mapper training as a user runs it: the port's CLI (main.run
             --mode train) on the shipped conceptual_captions.jsonnet at
             full width (SimpleTokenizer, tpu.fused_attention and
             tpu.fused_ffn), one epoch over 128 synthetic caption rows (4
             steps of 32) with 64 val rows, the shipped
             gradient_accumulation_steps 4: the mapper unchanged by the
             first 3 steps and changed by the 4th, model_00 and the index
             written, both validations' caption tables, the kernels' exact
             launches, each step's seconds, the logged examples/s; the rows
             through the shipped parquet loader where pyarrow imports, else
             through a subclass of it that holds them in memory (the line
             says which)
  clipcap_train_step
             ClipCap's train step at GPT-2 small width (B=32, 32 tokens +
             10 prefix positions): fused_block (12 fused_gpt2_block
             launches in the forward, none in the backward) against the
             unfused block (losses, mapper gradient cosine and norms), then
             timed steps of each in turns
  config_clipcap
             ClipCap as a user runs it: the port's CLI (main.run --mode
             train, then --mode test from model_00) on the shipped
             configs/vqa2/clip_cap.jsonnet at GPT-2 small width and depth
             (random weights, SimpleTokenizer, 512-wide CLIP embeddings),
             256 synthetic train questions (8 steps of 32, 2 updates at
             the shipped accumulation of 4) and 64 val questions; once as
             shipped (bf16, 138 positions: no kernel) and once with
             tpu.compute_dtype=float32 and buckets [32, 64] (42 positions:
             fused_gpt2_block's fp32 form 12 launches a training forward,
             none in generate): the first loss equal to a direct
             clipcap_loss on its batch, model_00 loaded back, answers.pkl
             and the metric, direct generate's tokens and answers, the
             train and eval walls, questions/s and peaks; then one train
             step each with mapping_type transformer and perceiver
  bench_train
             tools/bench_train.py's body at its defaults for --model vct0
             and clipcap, with and without --fused_attention: the JSON
             lines, the path's kernel launched once a layer a step
  rices      in-context example selection as a user runs it: knn_search on
             the card against the CPU on integer-valued vectors with
             planted ties (equal indices and similarities), and under a
             global TF32 setting within RICES_TF32_TOL of float64; image
             embeddings of 64 train and 32 val images through
             ClipImageEncoder at ViT-L/14@336 (random bf16 weights) as
             shipped (no kernel) and int8 (fused_qkv_q8, attention_core,
             fused_mlp_block_q8: 24 launches a call each), question
             embeddings of 128 + 32 questions through ClipTextEncoder
             (12 layers, 768 wide; encode_ids), the embedding pickles,
             run_full_pipeline on the card (rices.pkl, its question-only
             form and the int8 embeddings' rices.pkl) and on the CPU, and
             LoadInContextExamples reading rices.pkl back: the schema, best
             example last, the card's lists against the CPU's within
             RICES_TOL of joint similarity, pipeline seconds
  rices_at_scale
             tools/rices_at_scale.py at VQA2's sizes (443,757 train
             questions, 82,783 images, 768 wide, k = 2048, the top 32) for
             16 chunks of 1024: its JSON line, queries/s and peak memory
             beside the card's name and power limit, 8 rows of chunk 0
             against a CPU recomputation (similarities within 1e-5, rows
             equal where the scores are clear of each other)
  okvqa_eval, generate_captions, drift_studies, decode_profile, replicate
             OK-VQA through main, the caption tool, the int8 and bf16
             drift studies, the decode step's traced breakdown and the
             replication harness at T0-3B width (their functions' docs)
  train_step_study, vit_b_study, vit_l_study, eval_pipeline_bench,
  hw_smoke   each tool's main through tool_phase (every count set to 0
             just before, held to the launches its programs make after):
             the T0-3B mapper train step at B=32 and 64 with the remat,
             xla_attn and fwd variants (finite losses, step_over_fwd_ratio,
             the card's measured_ceiling_tflops and int8_over_bf16_rate);
             a chunk of each ViT study (images/s, towers' ms, shares of
             the measured ceiling); both eval orders on 32 questions
             (equal predictions, the speedup); hw_smoke's five flows
  multiprocess_eval
             main --mode test over two processes on the one card (gloo)
             at T0-3B width on EVAL_QUESTIONS questions: the gathered
             predictions cover every question once in rank order, each
             rank's answers equal a one-process run over its shard, rank
             0's accuracy is the gathered list's, rank 1 writes no
             answers.pkl, a two-process train run refuses (item 14); the
             launches are each rank's, counted in its own process

The phases from vit_kernels to clip_encode_int8_fp32 (the CLIP and GPT-2
ones) run in a process of their own (--clip-phases), from the shared
generator's state: late in a process that has traced the T5 phases,
kernel_split's traces lose records.

Then a line listing every kernel of the path with its launches (those of
t5_attention_core from config_eval, of the int8 trio from config_eval_int8,
of their fp32 forms from config_eval_fp32_int8, of fused_gpt2_block's fp32
form from config_clipcap's fp32 run, of the fp32 forms of fused_vit_block,
fused_attention_block and flash_attention from clip_encode_b32_fp32, of
those of the int8 ViT kernels from clip_encode_int8_fp32) and times, and last the line {"ok": true, "device": {...}}. Any failed
check exits non-zero before that line; without a CUDA card it exits
non-zero at once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))
# the config's "pretrained" T0 weights are looked for on local disk only
os.environ.setdefault("HF_HUB_OFFLINE", "1")
os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")

from explicit_alignment_for_vqa_tasks_tpu_torch import kernels  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch import main as eval_main  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.data import (  # noqa: E402
    DataLoaderConceptualCaptions,
    DataLoaderVQA2,
    ListDataset,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.in_context_example_selection import (  # noqa: E402
    run_full_pipeline,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.models import clip as clip_lib  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.models import clipcap as clipcap_lib  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.models import gpt2 as gpt2_lib  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.models import t5 as t5_lib  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.models.mappers import (  # noqa: E402
    MapperConfig,
    init_mapper,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.ops.attention import (  # noqa: E402
    flash_attention,
    flash_attention_plain,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.ops.decoding import (  # noqa: E402
    greedy_decode_gpt2,
    greedy_decode_t5,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.models.vct0 import (  # noqa: E402
    VCT0Config,
    VCT0Model,
    init_vct0_params,
    project_prefix,
    vct0_caption_loss,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.ops.knn import knn_search  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.parallel.mesh import (  # noqa: E402
    make_data_mesh,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.parallel.multihost import (  # noqa: E402
    backend as pbackend,
    maybe_initialize_distributed,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.ops.decode_attention import (  # noqa: E402
    cross_attention_decode,
    cross_attention_decode_plain,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.ops.fused_attention_block import (  # noqa: E402
    GPT2_BLOCK_KEYS,
    attention_core,
    attention_core_oproj,
    attention_core_oproj_plain,
    attention_core_plain,
    fused_ln_qkv,
    fused_ln_qkv_plain,
    fused_mlp_block,
    fused_mlp_block_plain,
    fused_mlp_block_q8,
    fused_mlp_block_q8_plain,
    fused_oproj_residual_q8,
    fused_oproj_residual_q8_plain,
    fused_attention_block,
    fused_attention_block_plain,
    fused_gpt2_block,
    fused_gpt2_block_plain,
    fused_qkv_q8,
    fused_qkv_q8_plain,
    fused_t5_ffn,
    fused_t5_ffn_plain,
    fused_t5_ffn_q8,
    fused_t5_ffn_q8_plain,
    fused_t5_ln_qkv_q8,
    fused_t5_ln_qkv_q8_plain,
    fused_vit_block,
    fused_vit_block_plain,
    fused_vit_block_q8,
    fused_vit_block_q8_plain,
    gpt2_block_group,
    t5_attention_core,
    t5_attention_core_plain,
    t5_bias_tiles,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.ops import (  # noqa: E402
    fused_attention_block as port_fab,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.ops.prefix_splice import (  # noqa: E402
    T5_SENTINEL_BASE,
    insert_prefix_into_input,
    splice_output_length,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.tools.clip_encoder import (  # noqa: E402
    ClipImageEncoder,
    ClipTextEncoder,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.tools.kernel_probe import (  # noqa: E402
    kernel_split,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.main import parse_args_sys  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.registry import (  # noqa: E402
    DATA_LOADERS,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.tools import bench_generate  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.tools import bench_train  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.tools import rices_at_scale  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.tools import (  # noqa: E402
    bf16_drift_study,
    decode_profile,
    e2e_fixtures,
    eval_pipeline_bench,
    generate_captions as caption_tool,
    hw_smoke,
    int8_drift_study,
    multiprocess_eval,
    replicate_baseline,
    train_step_study,
    vit_b_study,
    vit_l_study,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.trainers import clipcap_executor  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.trainers import model_factory  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.trainers.base_executor import (  # noqa: E402
    BaseExecutor,
    tree_to_device,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.trainers.checkpointing import (  # noqa: E402
    load_checkpoint,
    save_checkpoint,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.trainers.few_shot_vqa_executor import (  # noqa: E402
    FewShotVQAExecutor,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.trainers.model_factory import (  # noqa: E402
    build_model_from_config,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.trainers.optimization import (  # noqa: E402
    MultiStepAdamW,
    tree_leaves,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.trainers.vct0_executor import (  # noqa: E402
    VCT0Executor,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.utils.attr_dict import (  # noqa: E402
    AttrDict,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.utils.config_system import (  # noqa: E402
    process_config,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.utils.vqa_eval import VQAEval  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.utils.vqa_tools import VQA  # noqa: E402

SEED = 0
BATCH = 32
PROMPT_LEN = 512
NUM_SHOTS = 4                 # 4 shots + the question = 5 sentinels
PREFIX_LENGTH = 10
PREFIX_SIZE = 768             # CLIP ViT-L/14 embedding width
MAX_NEW_TOKENS = 20
# published H100 SXM peaks (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
INT8_OP_PER_S = 1979e12
FP32_FLOP_PER_S = 67e12           # outside the tensor cores
# an exact fp32 product on the tensor cores: six bf16-plane products (hi·hi,
# hi·mid, mid·hi, hi·lo, mid·mid, lo·hi of three exact planes each), the
# least the card takes for the fp32 attention's dots
F32_PLANE_PRODUCTS = 6
EXP_PER_S = 132 * 16 * 1.98e9      # 16 exponentials a clock on each SM
KERNEL_ATOL = KERNEL_RTOL = 8e-3   # one bf16 ulp of outputs below 2
REFERENCE_REL_ERR = 2e-2           # a few bf16 roundings over 2 layers
# int8 kernel against plain: two bf16 ulps, plus room for a rare activation
# code flipped by the norm's sum order
Q8_REL_FROBENIUS = 2e-3
Q8_ELEMENT_TOL = 1.6e-2            # x |want| + x rms(want)
INT8_GROUPS = 8
INT8_COSINE_FLOOR = 0.95           # a sanity floor; the value is recorded
# the GEMM stage of every int8 kernel (its s8 GEMM kernels' device time, all
# on q8_gemm_tma.cuh) against torch._int_mm of the same products
Q8_GEMM_STAGE_MAX_RATIO = 2.0
# the same for the bf16 GEMMs on bf16_gemm_tma.cuh (fused_ln_qkv,
# fused_mlp_block, fused_t5_ffn, fused_vit_block, fused_gpt2_block) against
# cuBLAS of the same products
BF16_GEMM_STAGE_MAX_RATIO = Q8_GEMM_STAGE_MAX_RATIO
DECODE_LAYER = 7                   # the cache layer the decode kernel reads
# transposed int8 cross-KV logits against unmerged: the same products
# summed in another order (rel. Frobenius over the logits)
LAYOUT_REL_ERR = 1e-3
VIT_CHECK_BATCH = 16               # images of the ragged-edge value check
# attention_core and attention_core_oproj against plain at CLIP_BATCH: only
# the order of the fp32 sums differs, so few bf16 outputs may
ATTENTION_MAX_DIFFERING = 0.005
EDGE_LENGTHS = (1, 50, 64, 65, 577, 1025)
EDGE_HEAD_DIMS = (16, 32, 64, 128)
EDGE_WIDTH = 256
EDGE_BATCH = 2
CLIP_BATCH = 256                   # the image encoder's batch
CLIP_COSINE_FLOOR = 0.99           # fused or int8 against default, per row
SPLIT_FE_LAYERS = 2                # depth of the split_fe and whole encodes
TEXT_BATCH = 512                   # ClipTextEncoder's batch
B32_BATCH = 1024                   # the JAX bench's ViT-B/32 batch
T5_QUANT_LAYERS = 2                # depth of the T5 quantizers' card = CPU check
# ClipCap: configs/vqa2/clip_cap.jsonnet's model_args (GPT-2 small, the mlp
# mapper from ViT-B/32's 512-d embeddings to 10 prefix positions)
CLIPCAP_MODEL_ARGS = {"prefix_length": 10, "clip_length": 10,
                      "prefix_size": 512, "mapping_type": "mlp",
                      "model_version": "gpt2"}
CLIPCAP_BATCH = 32                 # the config's train.batch_size
CLIPCAP_PROMPT = 32                # generate's longest prompt, in tokens
CLIPCAP_LOSS_TOKENS = 54           # + 10 prefix = 64 positions: the kernel
CLIPCAP_BUCKET_TOKENS = 128        # the shipped 128-token bucket: 138, none
CLIPCAP_LOSS_REL = 1e-2            # fused against unfused loss, relative
PALLAS_COSINE_FLOOR = 0.999        # use_pallas against default, per row
# the fp32 forms against their plain versions: the same fp32 operations
# with the sums in other orders (rows 1 and 5); an L that is not a multiple
# of the 64-key tile, and one row with this many masked keys
FP32_ATOL = FP32_RTOL = 1e-5
# the int8 kernels' fp32 forms (rows 2-4) against their plain versions: the
# same int8 products, only the loads and stores widened, so the outputs
# part only where a code on a .5 boundary flips (the out-projection, with no
# norm in front, not at all); a bf16 rounding of x or of an output alone
# would cost about 1e-3
FP32_Q8_REL_FROBENIUS = 1e-4
FP32_Q8_CODES_OFF_SHARE = 1e-4     # codes off the card's plain version's
# the int8 ViT kernels' forms other than bf16 (vit_q8_form): (x's dtype,
# the LayerNorms' and biases')
Q8_F32_FORMS = {"f32": (torch.float32, torch.float32),
                "f32_x_bf16_params": (torch.float32, torch.bfloat16),
                "bf16_x_f32_params": (torch.bfloat16, torch.float32)}
# fused_vit_block_q8 with fp32 x (block_q8_f32_rule): its output against the
# plain MLP over its own r1, as rows 13 and 14 are held on 2 or 3 images in
# tests/test_torch_vit_q8_f32.py (a .5-boundary flip of the LayerNorm's or
# the hidden's codes moves its row by about 1e-3); the plain output rounded
# to bf16 reads about 1.7e-3
BLOCK_Q8_MLP_REL_FROBENIUS = 3e-4
# fused_gpt2_block's fp32 form against its plain version: the bf16 form's
# whole-block rule (its intermediates are bf16), and, since its fp32 loads
# and stores are what it adds, at least this share of the outputs within
# FP32_ATOL (1 + |want|) (an output rounded to bf16: about 0.3 %) and a
# relative Frobenius error at most this fraction of that of the bf16 form
# with casts around it (the plain version on x rounded to bf16, its output
# rounded to bf16)
FP32_GPT2_CLOSE_FLOOR = 0.2
FP32_GPT2_REL_OF_BF16_CAST = 0.25
# the fp32 forms of the ViT split3 kernels and attention_core against their
# plain versions (vit_kernels_f32): attention_core and attention_core_oproj
# every output within FP32_ATOL (1 + |want|); with fast_exp, where two
# orders of the scores may round an exponential's argument to bf16 the
# other way, every output within that plus vit_fast_exp_flip_bound and at
# least VIT_F32_FAST_CLOSE of them within FP32_ATOL (1 + |want|);
# fused_ln_qkv and fused_mlp_block (h and hid rounded to bf16, which two
# sum orders may round the other way) a relative Frobenius error of at most
# VIT_F32_REL_FROBENIUS and at least VIT_F32_CLOSE of the outputs within
# FP32_ATOL (1 + |want|). A form rounding x, q / k / v, the attention
# output or its result to bf16 fails each
# (tests/test_torch_vit_f32_kernels.py)
VIT_F32_REL_FROBENIUS = 1e-4
VIT_F32_CLOSE = 0.2
VIT_F32_FAST_CLOSE = 0.95
VIT_F32_BOUND_IMAGES = 16          # images of fast_exp's bound at a time
F32_COSINE_FLOOR = 0.9999          # fp32 fused paths against default, per row
# fused_vit_block's fp32 forms: a relative Frobenius error at most this share
# of its bf16 form's on x rounded to bf16 (tests/test_torch_vit_whole_f32.py)
VIT_BLOCK_F32_VS_BF16 = 0.5
# config_clipcap's fp32 run: B=32 at 10 prefix + 32 tokens (ragged query
# tiles, M = 1,344); the kernel's timed shapes: 64 and 128 positions
FP32_GPT2_PATH_LEN = 42
FP32_EDGE_BATCH, FP32_EDGE_LEN = 4, 130
PADDED_KEYS = 100
# t5_attention_core's fp32 form past its held route's limit (576 at dh 64):
# the two-pass route
FP32_LONG_BATCH, FP32_LONG_LEN = 2, 700
FP32_HELD, FP32_TWO_PASS = ("t5_attention_core_f32_held_launch",
                            "t5_attention_core_f32_launch")
# the fp32 config run's encoder against its unfused fp32 encode: the fused
# FFN rounds its norm and hidden to bf16 (as the Pallas kernel does) where
# the unfused path keeps fp32, 24 layers deep
FP32_ENCODER_REL_ERR = 3e-2
CONFIG_FILE = REPO / "configs" / "vqa2" / "few_shot_vqa_hotpotqa.jsonnet"
FP32_OPTS = ("tpu.compute_dtype=float32", "tpu.fused_ffn=True",
             "model_config.lm_config.fused_decode_attention=True")
# what VCT0Model.generate reads of the config: every T5Config field but
# remat (a training knob), and these of the mapper's (the mlp mapper reads
# no depth or heads)
UNREAD_LM_FIELDS = ("remat",)
READ_MAPPER_FIELDS = ("mapping_type", "prefix_size", "d_model",
                      "prefix_length")

PORT_CSRC = "explicit_alignment_for_vqa_tasks_tpu_torch/csrc/"
JAX_OPS = "explicit_alignment_for_vqa_tasks_tpu/ops/fused_attention_block.py"
# kernel name -> (source, pallas_call it replaces)
KERNELS = {
    "t5_attention_core": (PORT_CSRC + "t5_attention_core.cu",
                          JAX_OPS + ":1168"),
    "fused_t5_ln_qkv_q8": (PORT_CSRC + "int8_encoder.cu", JAX_OPS + ":1666"),
    "fused_oproj_residual_q8": (PORT_CSRC + "int8_encoder.cu",
                                JAX_OPS + ":1715"),
    "fused_t5_ffn_q8": (PORT_CSRC + "int8_encoder.cu", JAX_OPS + ":1595"),
    "cross_attention_decode": (
        PORT_CSRC + "cross_attention_decode.cu",
        "explicit_alignment_for_vqa_tasks_tpu/ops/decode_attention.py:134"),
    "fused_t5_ffn": (PORT_CSRC + "t5_ffn.cu", JAX_OPS + ":671"),
    "fused_ln_qkv": (PORT_CSRC + "vit_block.cu", JAX_OPS + ":290"),
    "attention_core_oproj": (PORT_CSRC + "vit_block.cu", JAX_OPS + ":366"),
    "fused_mlp_block": (PORT_CSRC + "vit_block.cu", JAX_OPS + ":445"),
    "fused_qkv_q8": (PORT_CSRC + "vit_block_q8.cu", JAX_OPS + ":584"),
    "attention_core": (PORT_CSRC + "vit_block.cu", JAX_OPS + ":225"),
    "fused_mlp_block_q8": (PORT_CSRC + "vit_block_q8.cu", JAX_OPS + ":516"),
    "fused_vit_block": (PORT_CSRC + "vit_whole_block.cu", JAX_OPS + ":1398"),
    "fused_vit_block_q8": (PORT_CSRC + "vit_block_q8.cu", JAX_OPS + ":810"),
    "fused_attention_block": (PORT_CSRC + "attention_block.cu",
                              JAX_OPS + ":1452"),
    "fused_gpt2_block": (PORT_CSRC + "gpt2_block.cu", JAX_OPS + ":933"),
    "flash_attention": (
        PORT_CSRC + "flash_attention.cu",
        "explicit_alignment_for_vqa_tasks_tpu/ops/attention.py:142"),
    # the fp32 forms that tpu.compute_dtype=float32 reaches
    "t5_attention_core_f32": (PORT_CSRC + "attention_f32.cuh",
                              JAX_OPS + ":1168"),
    "cross_attention_decode_f32": (
        PORT_CSRC + "cross_attention_decode.cu",
        "explicit_alignment_for_vqa_tasks_tpu/ops/decode_attention.py:134"),
    "fused_t5_ffn_f32": (PORT_CSRC + "t5_ffn.cu", JAX_OPS + ":671"),
    # with the int8 encoder (config_eval_fp32_int8), and ClipCap's block
    # (config_clipcap's fp32 run)
    "fused_t5_ln_qkv_q8_f32": (PORT_CSRC + "int8_encoder.cu",
                               JAX_OPS + ":1666"),
    "fused_oproj_residual_q8_f32": (PORT_CSRC + "int8_encoder.cu",
                                    JAX_OPS + ":1715"),
    "fused_t5_ffn_q8_f32": (PORT_CSRC + "int8_encoder.cu", JAX_OPS + ":1595"),
    "fused_gpt2_block_f32": (PORT_CSRC + "gpt2_block.cu", JAX_OPS + ":933"),
    # ViT-L/14@336 in fp32 through ClipImageEncoder (clip_encode_fp32)
    "fused_ln_qkv_f32": (PORT_CSRC + "vit_block.cu", JAX_OPS + ":290"),
    "attention_core_oproj_f32": (PORT_CSRC + "vit_block.cu",
                                 JAX_OPS + ":366"),
    "fused_mlp_block_f32": (PORT_CSRC + "vit_block.cu", JAX_OPS + ":445"),
    "attention_core_f32": (PORT_CSRC + "attention_f32.cuh",
                           JAX_OPS + ":225"),
    # ViT-B/32 in fp32 through ClipImageEncoder (clip_encode_b32_fp32)
    "fused_vit_block_f32": (PORT_CSRC + "vit_whole_block.cu",
                            JAX_OPS + ":1398"),
    "fused_attention_block_f32": (PORT_CSRC + "attention_block.cu",
                                  JAX_OPS + ":1452"),
    "flash_attention_f32": (
        PORT_CSRC + "flash_attention.cu",
        "explicit_alignment_for_vqa_tasks_tpu/ops/attention.py:142"),
    # the int8 towers with fp32 activations through ClipImageEncoder
    # (clip_encode_int8_fp32): ViT-L/14@336's long branch, ViT-B/32's whole
    # blocks
    "fused_qkv_q8_f32": (PORT_CSRC + "vit_block_q8.cu", JAX_OPS + ":584"),
    "fused_mlp_block_q8_f32": (PORT_CSRC + "vit_block_q8.cu",
                               JAX_OPS + ":516"),
    "fused_vit_block_q8_f32": (PORT_CSRC + "vit_block_q8.cu",
                               JAX_OPS + ":810"),
}
PATH_KERNELS = (t5_attention_core, fused_t5_ln_qkv_q8,
                fused_oproj_residual_q8, fused_t5_ffn_q8,
                cross_attention_decode, fused_t5_ffn,
                fused_ln_qkv, attention_core_oproj, fused_mlp_block,
                fused_qkv_q8, attention_core, fused_mlp_block_q8,
                fused_vit_block, fused_vit_block_q8, fused_attention_block,
                fused_gpt2_block, flash_attention)
VIT_KERNELS = (fused_ln_qkv, attention_core_oproj, fused_mlp_block)
VIT_Q8_KERNELS = (fused_qkv_q8, attention_core, fused_mlp_block_q8)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() over iters launches, by CUDA events."""
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


def phase_env() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    nvcc = subprocess.run([kernels.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[-1]
    emit("env", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, nvcc=nvcc,
         python=sys.version.split()[0],
         device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    logs = kernels.build(ptxas_verbose=True)
    seconds = time.perf_counter() - t0
    for name, text in logs.items():
        for line in text.splitlines():
            print(f"[nvcc {name}] {line}", flush=True)
    emit("build", seconds=seconds, kernels=sorted(logs))


def phase_attention(gen: torch.Generator) -> dict:
    cfg = t5_lib.T5Config.t0_3b()
    batch, heads, head_dim = BATCH, cfg.num_heads, cfg.d_kv
    length = splice_output_length(PROMPT_LEN, PREFIX_LENGTH, NUM_SHOTS + 1)
    width = heads * head_dim
    dev = gen.device

    def randn(*shape, scale):
        return torch.randn(shape, generator=gen, device=dev).mul_(scale)

    q = randn(batch, length, width, scale=0.5).bfloat16()
    k = randn(batch, length, width, scale=0.5).bfloat16()
    v = (torch.rand((batch, length, width), generator=gen, device=dev)
         .mul_(2).sub_(1).bfloat16())
    bias = randn(heads, length, length, scale=0.5)
    mask = torch.ones((batch, length), dtype=torch.int32, device=dev)
    for b in range(1, batch, 4):          # padded tails of several lengths
        mask[b, length - 40 - 3 * b:] = 0
    mask[batch - 1] = 0                   # one fully masked row

    # as the encoder passes it: the bias and its tiles, built once a call
    tiles = t5_bias_tiles(bias)
    got = t5_attention_core(q, k, v, bias, mask, heads, tiles)
    torch.cuda.synchronize()
    want = t5_attention_core_plain(q, k, v, bias, mask, heads)
    err = (got.float() - want.float()).abs()
    max_abs_err = err.max().item()
    check(torch.isfinite(got.float()).all().item(), "kernel output not finite")
    check(max_abs_err <= KERNEL_ATOL,
          f"kernel differs from plain version by {max_abs_err}")
    check(bool((err <= KERNEL_ATOL + KERNEL_RTOL * want.float().abs()).all()),
          "kernel outside atol/rtol 8e-3 of the plain version")
    uniform = v[batch - 1].float().mean(dim=0)
    check(torch.allclose(got[batch - 1].float(), uniform.expand(length, -1),
                         atol=KERNEL_ATOL, rtol=KERNEL_RTOL),
          "fully masked row is not the uniform mean of v")
    del want, err

    kernel_ms = cuda_ms(
        lambda: t5_attention_core(q, k, v, bias, mask, heads, tiles),
        iters=20)
    # the tiled copy, made once an encode call (not a layer)
    tiles_ms = cuda_ms(lambda: t5_bias_tiles(bias), iters=5)
    plain_ms = cuda_ms(
        lambda: t5_attention_core_plain(q, k, v, bias, mask, heads), iters=3,
        warmup=1)
    # yardstick only: one PyTorch call computing the same function
    q4, k4, v4 = (x.view(batch, length, heads, head_dim).transpose(1, 2)
                  for x in (q, k, v))
    lib_mask = (bias[None] + torch.where(mask[:, None, None, :] > 0, 0.0, -1e9)
                ).bfloat16()
    library_ms = cuda_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=lib_mask, scale=1.0), iters=10)
    del lib_mask

    bytes_moved = 4 * q.numel() * q.element_size() + bias.numel() * 4 \
        + mask.numel() * 4
    flops = 4 * batch * heads * length * length * head_dim
    result = dict(
        shape=dict(B=batch, L=length, H=heads, dh=head_dim),
        max_abs_err=max_abs_err, ms=kernel_ms, plain_ms=plain_ms,
        library_ms=library_ms, bias_tiles_ms=tiles_ms,
        **bound(bytes_moved, flops, BF16_FLOP_PER_S),
        **attention_route_bound(batch, length, width, heads, bytes_moved),
    )
    emit("attention", kernel_ms=kernel_ms, **{
        k: v for k, v in result.items() if k != "ms"})
    return result


def bound(bytes_moved: float, ops: float, ops_per_s: float) -> dict:
    return bound_mixed(bytes_moved, [(ops, ops_per_s)])


def bound_mixed(bytes_moved: float, parts) -> dict:
    """The least time for ``bytes_moved`` and the (operations, peak rate)
    ``parts``, each part at its own type's peak, one after the other."""
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = sum(ops / ops_per_s for ops, ops_per_s in parts) * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bytes=bytes_moved, ops=sum(ops for ops, _ in parts))


def attention_route_bound(batch: int, seq: int, width: int, heads: int,
                          bytes_moved: float, extra_ops: float = 0.0) -> dict:
    """The bound of the two-pass wgmma attention's route beside the
    function's: q . k^T twice and p . v (6 B L^2 D operations, plus
    ``extra_ops`` such as an out-projection) at the bf16 peak, B H L^2
    exponentials at EXP_PER_S and the bytes; the largest of the three."""
    parts = dict(
        bytes=bytes_moved / HBM_BYTES_PER_S * 1e3,
        operations=(6 * batch * seq * seq * width + extra_ops)
        / BF16_FLOP_PER_S * 1e3,
        exponentials=batch * heads * seq * seq / EXP_PER_S * 1e3)
    by = max(parts, key=parts.get)
    return dict(route_bound_ms=parts[by], route_bound_by=by,
                route_parts_ms=parts)


def check_few_differ(name: str, res: dict) -> float:
    """The share of outputs that differ from plain, at most
    ATTENTION_MAX_DIFFERING."""
    share = res["differing"] / res["elements"]
    check(share <= ATTENTION_MAX_DIFFERING,
          f"{name}: {share} of its outputs differ from plain, more than "
          f"{ATTENTION_MAX_DIFFERING}")
    return share


def bf16_ulp(want: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp of each element of the fp32 ``want``."""
    return torch.exp2(torch.floor(torch.log2(want.abs().clamp(min=1e-30)))
                      - 7)


def compare_q8(got: torch.Tensor, want: torch.Tensor) -> dict:
    """Kernel against plain: max abs error, relative Frobenius error, the
    share of elements beyond one bf16 ulp of the plain value; fails unless
    both tolerances hold."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    rel = ((got - want).norm() / want.norm()).item()
    rms = want.square().mean().sqrt()
    ulp = bf16_ulp(want)
    check(bool(torch.isfinite(got).all()), "int8 kernel output not finite")
    check(rel <= Q8_REL_FROBENIUS,
          f"int8 kernel's relative Frobenius error {rel} > {Q8_REL_FROBENIUS}")
    check(bool((err <= Q8_ELEMENT_TOL * want.abs()
                + Q8_ELEMENT_TOL * rms).all()),
          f"int8 kernel outside {Q8_ELEMENT_TOL} x (|want| + rms(want))")
    return dict(max_abs_err=err.max().item(), rel_frobenius=rel,
                beyond_one_ulp=(err > ulp).float().mean().item())


def check_against_plain(name: str, fn, plain, args, batch: int,
                        int8: bool = False, flip_bound=None) -> dict:
    """The kernel against its plain version on the same inputs: each output
    finite and within KERNEL_ATOL + KERNEL_RTOL |want| (int8 kernels:
    compare_q8's rule), plus ``flip_bound`` (per output, where given: how
    far one-ulp flips of the exponentials' bf16 arguments may move it); the
    largest error, the elements that differ (and, with a flip bound, those
    beyond the tolerance alone)."""
    got = fn(*args)
    torch.cuda.synchronize()
    want = plain(*args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    out = dict(max_abs_err=0.0, differing=0, elements=0)
    for g, p in zip(got, want):
        if int8:
            out["rel_frobenius"] = max(out.get("rel_frobenius", 0.0),
                                       compare_q8(g, p)["rel_frobenius"])
        g, p = g.float(), p.float()
        err = (g - p).abs()
        check(bool(torch.isfinite(g).all()),
              f"{name} at B={batch}: output not finite")
        if not int8:
            limit = KERNEL_ATOL + KERNEL_RTOL * p.abs()
            if flip_bound is not None:
                out["beyond_tolerance"] = int((err > limit).sum())
                limit += flip_bound
            check(bool((err <= limit).all()),
                  f"{name} at B={batch} outside atol/rtol 8e-3 of the "
                  f"plain version (and the flip bound, where given; max "
                  f"abs err {err.max().item()})")
            del limit
        out["max_abs_err"] = max(out["max_abs_err"], err.max().item())
        out["differing"] += int((err > 0).sum())
        out["elements"] += err.numel()
        del g, p, err
    del got, want
    torch.cuda.empty_cache()
    return out


def q8_boundary(name: str, fn, plain, args) -> None:
    """The .5-boundary check of an int8 kernel with a norm in front, on
    ``args`` (CUDA tensors): its activation codes (``codes``; the MLPs'
    also ``hidden_codes``) and its outputs beside those of the plain
    version run on the CPU on copies of the same inputs (the version held
    bit-equal to JAX's interpret mode), and the same for the plain version
    run on the card: per side, how many of each stage's codes differ and
    how many outputs lie beyond one bf16 ulp of the CPU's, with their
    shares. Recorded, not held to a bound. Returns how many of the
    kernel's codes (every stage's) differ from the card's plain version's,
    of how many, and their share."""
    cpu_codes = {}
    want = plain(*(a.cpu() if isinstance(a, torch.Tensor) else a
                   for a in args), codes_out=cpu_codes)
    want = [w.float() for w in (want if isinstance(want, tuple) else (want,))]
    elements = sum(w.numel() for w in want)
    keys = [key for key in cpu_codes if key.endswith("codes")]
    result, card_codes = {}, {}
    for side, f in (("card_kernel", fn), ("card_plain", plain)):
        codes = card_codes[side] = {}
        got = f(*args, codes_out=codes)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        side_result = {}
        for key in keys:
            cpu = cpu_codes[key]
            differ = int((codes[key].cpu() != cpu).sum())
            side_result[f"{key}_differ"] = differ
            side_result[f"{key}_differ_share"] = differ / cpu.numel()
        beyond = 0
        for g, w in zip(got, want):
            beyond += int(((g.cpu().float() - w).abs() > bf16_ulp(w)).sum())
        side_result.update(outputs_beyond_one_ulp=beyond,
                           outputs_beyond_one_ulp_share=beyond / elements)
        result[side] = side_result
        del got
    off = sum(int((card_codes["card_kernel"][key]
                   != card_codes["card_plain"][key]).sum()) for key in keys)
    total = sum(cpu_codes[key].numel() for key in keys)
    del card_codes
    off_plain = dict(codes_off_plain=off, codes=total,
                     codes_off_plain_share=off / total)
    result.update(codes=cpu_codes["codes"].numel(), outputs=elements,
                  kernel_codes_off_card_plain=off)
    emit("q8_boundary", kernel=name, **result)
    return off_plain


def phase_int8_kernels(gen: torch.Generator) -> dict:
    """Each int8 kernel against its plain version at the int8 path's
    shapes, on weights from the port's quantizer."""
    cfg = t5_lib.T5Config.t0_3b()
    length = splice_output_length(PROMPT_LEN, PREFIX_LENGTH, NUM_SHOTS + 1)
    d_model, inner, d_ff = cfg.d_model, cfg.num_heads * cfg.d_kv, cfg.d_ff
    rows = BATCH * length
    dev = gen.device

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev).mul_(scale)

    def quant(k, n):
        q, s = t5_lib._quant_stacked_i8(randn(1, k, n, scale=k ** -0.5),
                                        INT8_GROUPS)
        return q[0], s[0]

    def codes(k):  # activation codes for the library yardstick
        return torch.randint(-127, 128, (rows, k), generator=gen, device=dev,
                             dtype=torch.int8)

    x = randn(BATCH, length, d_model, scale=2.0).bfloat16()
    attn = randn(BATCH, length, inner).bfloat16()
    lnw = (1 + 0.1 * randn(d_model)).bfloat16()
    qkv_w = [quant(d_model, inner) for _ in range(3)]
    o_w = quant(inner, d_model)
    ffn_w = [quant(d_model, d_ff), quant(d_model, d_ff), quant(d_ff, d_model)]
    act = rows * d_model * 2               # one bf16 (M, D) activation
    cases = {
        "fused_t5_ln_qkv_q8": dict(
            fn=fused_t5_ln_qkv_q8, plain=fused_t5_ln_qkv_q8_plain,
            args=(x, lnw, *[t for w in qkv_w for t in w]),
            # one product over the stacked wq, wk, wv computes all three
            gemms=[(d_model, w) for w, _ in qkv_w], kernel_gemms=[[0, 1, 2]],
            bytes=act + d_model * 2 + 3 * rows * inner * 2
            + sum(w.numel() + s.numel() * 4 for w, s in qkv_w),
            ops=3 * 2 * rows * d_model * inner),
        "fused_oproj_residual_q8": dict(
            fn=fused_oproj_residual_q8, plain=fused_oproj_residual_q8_plain,
            args=(x, attn, *o_w), gemms=[(inner, o_w[0])],
            kernel_gemms=[[0]],
            bytes=2 * act + rows * inner * 2 + o_w[0].numel()
            + o_w[1].numel() * 4,
            ops=2 * rows * inner * d_model),
        "fused_t5_ffn_q8": dict(
            fn=fused_t5_ffn_q8, plain=fused_t5_ffn_q8_plain,
            args=(x, lnw, *[t for w in ffn_w for t in w]),
            gemms=[(d_model, ffn_w[0][0]), (d_model, ffn_w[1][0]),
                   (d_ff, ffn_w[2][0])],
            # one up-product computes both gate products
            kernel_gemms=[[0, 1], [2]],
            bytes=2 * act + d_model * 2
            + sum(w.numel() + s.numel() * 4 for w, s in ffn_w),
            ops=2 * rows * d_model * d_ff * 2 + 2 * rows * d_ff * d_model),
    }
    results = {}
    for name, case in cases.items():
        fn, plain, args = case["fn"], case["plain"], case["args"]
        got = fn(*args)
        torch.cuda.synchronize()
        want = plain(*args)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        errs = [compare_q8(g, w) for g, w in zip(got, want)]
        del got, want
        if name in ("fused_t5_ln_qkv_q8", "fused_t5_ffn_q8"):
            q8_boundary(name, fn, plain, args)
        kernel_ms = cuda_ms(lambda: fn(*args), iters=20)
        plain_ms = cuda_ms(lambda: plain(*args), iters=3, warmup=1)
        # yardstick only: torch._int_mm of the same int8 products, GEMMs
        # alone (no norm, quantization, scales or epilogue), with the
        # weights column-major as cuBLASLt's int8 GEMM takes them (the
        # transpose is made before the timing), and as the port stores them
        lib_in = [(codes(k), w) for k, w in case["gemms"]]
        lib_col = [(a, w.t().contiguous().t()) for a, w in lib_in]
        library_ms = cuda_ms(
            lambda: [torch._int_mm(a, w) for a, w in lib_col], iters=10)
        library_row_major_ms = cuda_ms(
            lambda: [torch._int_mm(a, w) for a, w in lib_in], iters=10)
        # each CUDA GEMM kernel beside _int_mm of the products it computes
        int_mm_ms = [cuda_ms(lambda a=a, w=w: torch._int_mm(a, w), iters=10)
                     for a, w in lib_col]
        stage = gemm_stage(
            name, kernel_split(lambda: fn(*args)),
            [sum(int_mm_ms[i] for i in kernel) for kernel in
             case["kernel_gemms"]])
        del lib_in, lib_col
        results[name] = dict(
            shape=dict(M=rows, D=d_model, inner=inner, F=d_ff,
                       G=INT8_GROUPS),
            max_abs_err=max(e["max_abs_err"] for e in errs),
            rel_frobenius=max(e["rel_frobenius"] for e in errs),
            beyond_one_ulp=max(e["beyond_one_ulp"] for e in errs),
            ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
            library="torch._int_mm, GEMMs only, column-major weights",
            library_row_major_ms=library_row_major_ms, **stage,
            **bound(case["bytes"], case["ops"], INT8_OP_PER_S))
        emit("int8_kernels", kernel=name, kernel_ms=kernel_ms, **{
            k: v for k, v in results[name].items() if k != "ms"})
    return results


def make_prompts(cfg: VCT0Config, dev: torch.device):
    """32 prompts of 512 tokens, each with NUM_SHOTS + 1 sentinels
    (<extra_id_0> ... left to right); every fourth row right-padded."""
    rng = np.random.default_rng(SEED)
    tokens = rng.integers(3, 32000, (BATCH, PROMPT_LEN)).astype(np.int32)
    mask = np.ones((BATCH, PROMPT_LEN), np.int32)
    for b in range(BATCH):
        valid = PROMPT_LEN - (60 + 2 * b if b % 4 == 3 else 0)
        tokens[b, valid:] = cfg.lm.pad_token_id
        mask[b, valid:] = 0
        spots = np.sort(rng.choice(valid - 1, NUM_SHOTS + 1, replace=False))
        for g, j in enumerate(spots):
            tokens[b, j] = cfg.sentinel_base - g
    prefix = torch.from_numpy(
        rng.standard_normal((BATCH, NUM_SHOTS + 1, PREFIX_SIZE))
        .astype(np.float32))
    return (prefix.to(dev), torch.from_numpy(tokens).to(dev),
            torch.from_numpy(mask).to(dev))


def phase_reference(model: VCT0Model, prefix, tokens, mask) -> None:
    """Full width, 2 layers, 2 prompts: the encoder through the kernel
    against the plain materialised-bias path on the same inputs."""
    cfg, lm = model.cfg, model.params["lm"]
    with torch.inference_mode():
        text = t5_lib.embed_tokens(lm, cfg.lm, tokens[:2])
        proj = project_prefix(cfg, model.params["mapper"], prefix[:2])
        joint, joint_mask = insert_prefix_into_input(
            tokens[:2], text, proj.to(text.dtype), mask[:2],
            prefix_length=cfg.prefix_length, num_prefixes=NUM_SHOTS + 1,
            base_id=cfg.sentinel_base)
        outs = {}
        for fused in (True, False):
            lm_cfg = dataclasses.replace(cfg.lm, num_encoder_layers=2,
                                         fused_encoder_attention=fused)
            outs[fused] = t5_lib.t5_encode(lm, lm_cfg, inputs_embeds=joint,
                                           attention_mask=joint_mask).float()
    valid = joint_mask.bool()
    a, b = outs[True][valid], outs[False][valid]
    rel_err = ((a - b).norm() / b.norm()).item()
    check(torch.isfinite(a).all().item(), "kernel-path encoder not finite")
    check(rel_err <= REFERENCE_REL_ERR,
          f"kernel-path encoder differs from plain path: rel err {rel_err}")
    emit("reference", layers=2, batch=2, length=joint.shape[1],
         rel_err=rel_err, limit=REFERENCE_REL_ERR)


def decode_steps_run(out_tokens: torch.Tensor, eos: int) -> int:
    """The decode steps greedy_decode_from_cache ran for these tokens: it
    stops after the step at which the last row emitted EOS."""
    has_eos = (out_tokens == eos).any(dim=1)
    if not bool(has_eos.all()):
        return out_tokens.shape[1]
    first_eos = (out_tokens == eos).float().argmax(dim=1)
    return int(first_eos.max()) + 1


def launches(**counts) -> dict:
    """Expected launches of every kernel of the path (0 unless named)."""
    return {fn.__name__: counts.get(fn.__name__, 0) for fn in PATH_KERNELS}


def phase_generate(model: VCT0Model, prefix, tokens, mask, expected,
                   phase: str = "generate") -> dict:
    """generate twice; every kernel count is set to 0 just before each call
    and read just after, and must equal ``expected(steps)`` (name ->
    launches), ``steps`` being the decode steps the call ran."""
    cfg = model.cfg
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in PATH_KERNELS:
            fn.launches = 0
        t0 = time.perf_counter()
        out_tokens, logprobs = model.generate(
            prefix, tokens, mask, num_shots=NUM_SHOTS,
            max_new_tokens=MAX_NEW_TOKENS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs.append(dict(tokens=out_tokens, logprobs=logprobs, wall_s=wall,
                         launches={fn.__name__: fn.launches
                                   for fn in PATH_KERNELS},
                         peak_bytes=torch.cuda.max_memory_allocated(),
                         steps=decode_steps_run(out_tokens,
                                                cfg.lm.eos_token_id)))
    first, second = runs
    for run in runs:
        want = expected(run["steps"])
        check(run["launches"] == want,
              f"{phase}: kernels launched {run['launches']}, expected "
              f"{want}")
    out_tokens, logprobs = second["tokens"], second["logprobs"]
    check(tuple(out_tokens.shape) == (BATCH, MAX_NEW_TOKENS),
          f"tokens shape {tuple(out_tokens.shape)}")
    check(torch.equal(first["tokens"], out_tokens),
          "the two runs generated different tokens")
    check(bool(((out_tokens >= 0) & (out_tokens < cfg.lm.vocab_size)).all()),
          "token outside the vocabulary")
    check(bool(torch.isfinite(logprobs).all()), "log-prob not finite")
    check(bool((logprobs <= 0).all()), "log-prob above 0")
    scores = model.score_sequences(out_tokens, logprobs)
    check(bool(torch.isfinite(scores).all()), "sequence score not finite")
    result = dict(
        batch=BATCH, encoder_tokens=int(splice_output_length(
            PROMPT_LEN, PREFIX_LENGTH, NUM_SHOTS + 1)),
        new_tokens=MAX_NEW_TOKENS, wall_s=second["wall_s"],
        first_wall_s=first["wall_s"],
        prompts_per_s=BATCH / second["wall_s"],
        peak_mem_gb=second["peak_bytes"] / 1e9,
        launches_per_call=[r["launches"] for r in runs],
        decode_steps=[r["steps"] for r in runs],
        rows_with_eos=int((out_tokens == cfg.lm.eos_token_id).any(1).sum()),
        first_tokens=out_tokens[0, :5].tolist(),
    )
    emit(phase, **result)
    result["tokens"] = out_tokens
    return result


def phase_breakdown(model: VCT0Model, prefix, tokens, mask,
                    phase: str = "breakdown") -> dict:
    cfg, lm = model.cfg, model.params["lm"]

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def splice():
        text = t5_lib.embed_tokens(lm, cfg.lm, tokens)
        proj = project_prefix(cfg, model.params["mapper"], prefix)
        return insert_prefix_into_input(
            tokens, text, proj.to(text.dtype), mask,
            prefix_length=cfg.prefix_length, num_prefixes=NUM_SHOTS + 1,
            base_id=cfg.sentinel_base)

    with torch.inference_mode():
        (joint, joint_mask), splice_s = timed(splice)
        hidden, encode_s = timed(lambda: t5_lib.t5_encode(
            lm, cfg.lm, inputs_embeds=joint, attention_mask=joint_mask))
        _, decode_s = timed(lambda: greedy_decode_t5(
            lm, cfg.lm, hidden, joint_mask, MAX_NEW_TOKENS))
    result = dict(mapper_splice_s=splice_s, encode_s=encode_s,
                  decode_s=decode_s,
                  decode_step_ms=decode_s / MAX_NEW_TOKENS * 1e3)
    emit(phase, **result)
    return result


def device_busy(fn, timed_wall_s: float, top: int = 10) -> dict:
    """One more call of fn under torch.profiler. The profiler slows the
    host, not the kernels, so the busy share is the kernels' device time
    over the unprofiled call's wall time."""
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        profiled_wall = time.perf_counter() - t0
    kernels_us = {}
    for event in prof.events():
        if event.device_type == torch.autograd.DeviceType.CUDA:
            kernels_us[event.name] = (kernels_us.get(event.name, 0.0)
                                      + event.time_range.elapsed_us())
    busy_s = sum(kernels_us.values()) / 1e6
    largest = sorted(kernels_us.items(), key=lambda kv: -kv[1])[:top]
    return dict(profiled_wall_s=profiled_wall, device_busy_s=busy_s,
                timed_wall_s=timed_wall_s,
                busy_share=busy_s / timed_wall_s if busy_s else None,
                device_events=len(kernels_us),
                top_kernels_ms=[[name[:90], us / 1e3]
                                for name, us in largest])


def gemm_stage(name: str, split: dict, int_mm_ms: list) -> dict:
    """The GEMM kernels of ``split`` beside torch._int_mm of the same
    products, in order (an entry may be the sum of several _int_mm calls
    that one kernel computes); fails unless their sum is within
    Q8_GEMM_STAGE_MAX_RATIO of the library's."""
    gemm_ms = [split[f"gemm_{i}"] for i in range(len(int_mm_ms))]
    ratio = sum(gemm_ms) / sum(int_mm_ms)
    check(ratio <= Q8_GEMM_STAGE_MAX_RATIO,
          f"{name}: its GEMM stage takes {sum(gemm_ms)} ms, {ratio} x "
          f"torch._int_mm's {sum(int_mm_ms)}")
    return dict(kernel_split_ms=split, gemm_ms=gemm_ms, int_mm_ms=int_mm_ms,
                gemm_stage_ms=sum(gemm_ms), gemm_stage_vs_int_mm=ratio,
                gemm_vs_int_mm=[g / i for g, i in zip(gemm_ms, int_mm_ms)])


def bf16_gemm_stage(name: str, split: dict, cublas_ms: list) -> dict:
    """The bf16 GEMM kernels of ``split`` (all on bf16_gemm_tma.cuh) beside
    cuBLAS calls of the same products, in order (addmm where the kernel
    adds a bias, else matmul; no epilogue of their own); fails unless
    their sum is within BF16_GEMM_STAGE_MAX_RATIO of cuBLAS's."""
    gemm_ms = [split[f"gemm_{i}"] for i in range(len(cublas_ms))]
    ratio = sum(gemm_ms) / sum(cublas_ms)
    check(ratio <= BF16_GEMM_STAGE_MAX_RATIO,
          f"{name}: its GEMM stage takes {sum(gemm_ms)} ms, {ratio} x "
          f"cuBLAS's {sum(cublas_ms)}")
    return dict(kernel_split_ms=split, gemm_ms=gemm_ms, cublas_ms=cublas_ms,
                gemm_stage_ms=sum(gemm_ms), gemm_stage_vs_cublas=ratio,
                gemm_vs_cublas=[g / c for g, c in zip(gemm_ms, cublas_ms)])


def yardstick_operands(dev, rows: int, *widths: int) -> list:
    """Random bf16 (rows, width) operands for cuBLAS yardsticks, from a
    generator of their own: the phases' generator, and so every later
    input, stays as it was without them."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    return [torch.randn((rows, n), generator=gen, device=dev).bfloat16()
            for n in widths]


def tma_products(name: str, fn, products: int, calls: int = 3) -> list:
    """The GEMM kernels that ``calls`` calls of fn launch under
    torch.profiler (every kernel whose name says gemm, xmma or cutlass);
    fails unless all are bf16_gemm_tma.cuh's, in ``products`` distinct
    instances (one per epilogue: no mma.sync stage and no cuBLAS call)."""
    gemms = [n for n in cuda_kernel_names(fn, calls)
             if any(k in n.lower() for k in ("gemm", "xmma", "cutlass"))]
    check(len(gemms) == products
          and all("bf16_gemm_tma::gemm_kernel" in n for n in gemms),
          f"{name}: its GEMM kernels are {gemms}, not {products} "
          f"bf16_gemm_tma.cuh instances")
    return [n[:120] for n in gemms]


def cuda_kernel_names(fn, calls: int = 3, traces: int = 3) -> list:
    """The names of the CUDA kernels that ``calls`` calls of fn launch,
    under torch.profiler with the host's activity traced too, as
    device_busy traces it. Traced with CUDA activity alone,
    flash_attention's calls came back with no CUDA record at all, every
    time, late in a whole run of this script (on an H100; the same calls
    traced whole in a process of their own): a trace with no CUDA record
    says nothing, and is taken again, up to ``traces`` times in all. (A
    trace may also drop some of a call's records, so it gives no device
    times here.)"""
    fn()
    torch.cuda.synchronize()
    for _ in range(traces):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = sorted({e.name for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA})
        if names:
            return names
    return []


def phase_profile(model: VCT0Model, prefix, tokens, mask,
                  timed_wall_s: float, phase: str = "profile") -> None:
    emit(phase, **device_busy(
        lambda: model.generate(prefix, tokens, mask, num_shots=NUM_SHOTS,
                               max_new_tokens=MAX_NEW_TOKENS),
        timed_wall_s))


def generate_in_turns(models: dict, prefix, tokens, mask) -> dict:
    """Two configurations' generate calls in turns (a, b, b, a), since the
    decode's host-side time moves between calls of the same code."""
    a, b = models
    turns = {a: [], b: []}
    for name in (a, b, b, a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        models[name].generate(prefix, tokens, mask, num_shots=NUM_SHOTS,
                              max_new_tokens=MAX_NEW_TOKENS)
        torch.cuda.synchronize()
        turns[name].append(time.perf_counter() - t0)
    return turns


def phase_generate_int8(model: VCT0Model, prefix, tokens, mask,
                        bf16_encode_s: float) -> dict:
    """The int8 bulk-eval configuration on the bf16 model's weights and
    prompts: SmoothQuant calibration on that batch, generate twice, the
    breakdown, and the cosine of its encoder output against the bf16
    kernel path's on the same spliced input."""
    lm_cfg = dataclasses.replace(model.cfg.lm, int8_encoder_ffn=True,
                                 int8_encoder_attn=True)
    int8 = VCT0Model(dataclasses.replace(model.cfg, lm=lm_cfg),
                     dict(model.params))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = int8.calibrate_and_quantize_int8(
        [dict(prefix=prefix, question_tokens=tokens, question_mask=mask)],
        alpha=0.5)
    torch.cuda.synchronize()
    calibrate_s = time.perf_counter() - t0
    check(all(bool(torch.isfinite(v).all()) for v in stats.values()),
          "calibration statistics not finite")
    emit("calibrate_int8", seconds=calibrate_s, alpha=0.5,
         groups=int(int8.params["lm"]["encoder"]["ffn_q8"]["wi_0_s"].shape[1]),
         params_gb=torch.cuda.memory_allocated() / 1e9)

    layers = lm_cfg.num_encoder_layers
    result = phase_generate(
        int8, prefix, tokens, mask,
        expected=lambda steps: launches(
            t5_attention_core=layers, fused_t5_ln_qkv_q8=layers,
            fused_oproj_residual_q8=layers, fused_t5_ffn_q8=layers),
        phase="generate_int8")
    breakdown = phase_breakdown(int8, prefix, tokens, mask,
                                phase="breakdown_int8")
    phase_profile(int8, prefix, tokens, mask, result["wall_s"],
                  phase="profile_int8")

    with torch.inference_mode():
        joint, joint_mask = int8.encoder_calibration_batch(prefix, tokens,
                                                           mask)
        outs = [t5_lib.t5_encode(m.params["lm"], m.cfg.lm,
                                 inputs_embeds=joint,
                                 attention_mask=joint_mask).double()
                for m in (model, int8)]
    valid = joint_mask.bool()
    a, b = outs[0][valid].flatten(), outs[1][valid].flatten()
    cosine = (a @ b / (a.norm() * b.norm())).item()
    check(cosine >= INT8_COSINE_FLOOR,
          f"int8 encoder output's cosine to bf16 {cosine} < "
          f"{INT8_COSINE_FLOOR}")
    turns = generate_in_turns({"bf16": model, "int8": int8}, prefix, tokens,
                              mask)
    emit("int8_vs_bf16", encoder_cosine=cosine, floor=INT8_COSINE_FLOOR,
         int8_encode_s=breakdown["encode_s"], bf16_encode_s=bf16_encode_s,
         encode_speedup=bf16_encode_s / breakdown["encode_s"],
         generate_s_in_turns=turns,
         prompts_per_s_in_turns={k: [BATCH / t for t in v]
                                 for k, v in turns.items()})
    return result


def phase_decode_attention(gen: torch.Generator) -> dict:
    """The decode kernel against its plain version on one layer (not 0) of
    full-size stacked caches, as the fused decode step calls it."""
    cfg = t5_lib.T5Config.t0_3b()
    layers, heads, head_dim = cfg.num_decoder_layers, cfg.num_heads, cfg.d_kv
    length = splice_output_length(PROMPT_LEN, PREFIX_LENGTH, NUM_SHOTS + 1)
    width = heads * head_dim
    dev = gen.device

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).bfloat16()

    q = randn(BATCH, width)
    k = randn(layers, BATCH, length, width)
    v = randn(layers, BATCH, length, width)
    mask = torch.ones((BATCH, length), dtype=torch.int32, device=dev)
    for b in range(1, BATCH, 4):          # padded tails of several lengths
        mask[b, length - 40 - 3 * b:] = 0
    mask[BATCH - 1] = 0                   # one fully masked row
    args = (q, k, v, mask, DECODE_LAYER, heads)

    got = cross_attention_decode(*args)
    torch.cuda.synchronize()
    want = cross_attention_decode_plain(*args)
    err = (got.float() - want.float()).abs()
    max_abs_err = err.max().item()
    check(torch.isfinite(got.float()).all().item(),
          "decode kernel output not finite")
    check(bool((err <= KERNEL_ATOL + KERNEL_RTOL * want.float().abs()).all()),
          f"decode kernel outside atol/rtol 8e-3 of the plain version "
          f"(max abs err {max_abs_err})")
    kernel_ms = cuda_ms(lambda: cross_attention_decode(*args), iters=100)
    plain_ms = cuda_ms(lambda: cross_attention_decode_plain(*args), iters=5)
    # yardstick only: one PyTorch call computing the same function on
    # (B, H, 1, dh) and (B, H, L, dh) views of the same layer
    q4 = q.view(BATCH, heads, 1, head_dim)
    k4, v4 = (c[DECODE_LAYER].view(BATCH, length, heads, head_dim)
              .transpose(1, 2) for c in (k, v))
    bias = torch.where(mask[:, None, None, :] > 0, 0.0, -1e9).bfloat16()
    library_ms = cuda_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=bias, scale=1.0), iters=20)
    bytes_moved = (2 * BATCH * length * width * 2 + 2 * q.numel() * 2
                   + mask.numel() * 4)
    flops = 4 * BATCH * length * width
    result = dict(
        shape=dict(layers=layers, B=BATCH, L=length, H=heads, dh=head_dim,
                   layer=DECODE_LAYER),
        max_abs_err=max_abs_err, ms=kernel_ms, plain_ms=plain_ms,
        library_ms=library_ms, library="scaled_dot_product_attention",
        **bound(bytes_moved, flops, BF16_FLOP_PER_S))
    emit("decode_attention", kernel_ms=kernel_ms, **{
        key: val for key, val in result.items() if key != "ms"})
    return result


def phase_t5_ffn(gen: torch.Generator) -> dict:
    """The bf16 FFN kernel against its plain version at the encoder's
    shapes (gated, T0-3B widths), timed, split by CUDA kernel with each
    GEMM beside cuBLAS; the non-gated form against its plain version at
    the same widths."""
    cfg = t5_lib.T5Config.t0_3b()
    length = splice_output_length(PROMPT_LEN, PREFIX_LENGTH, NUM_SHOTS + 1)
    d_model, d_ff = cfg.d_model, cfg.d_ff
    rows = BATCH * length
    dev = gen.device

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev).mul_(scale)

    x = randn(BATCH, length, d_model, scale=2.0).bfloat16()
    lnw = (1 + 0.1 * randn(d_model)).bfloat16()
    wi_0, wi_1 = (randn(d_model, d_ff, scale=d_model ** -0.5).bfloat16()
                  for _ in range(2))
    wo = randn(d_ff, d_model, scale=d_ff ** -0.5).bfloat16()
    args = (x, lnw, wi_0, wi_1, wo, cfg.layer_norm_epsilon)
    got = fused_t5_ffn(*args)
    torch.cuda.synchronize()
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on: the plain version must multiply in fp32")
    want = fused_t5_ffn_plain(*args)
    errs = compare_q8(got, want)
    non_gated = (x, lnw, wi_0, None, wo, cfg.layer_norm_epsilon)
    got = fused_t5_ffn(*non_gated)
    torch.cuda.synchronize()
    non_gated_errs = compare_q8(got, fused_t5_ffn_plain(*non_gated))
    del got, want
    kernel_ms = cuda_ms(lambda: fused_t5_ffn(*args), iters=10)
    non_gated_ms = cuda_ms(lambda: fused_t5_ffn(*non_gated), iters=10)
    plain_ms = cuda_ms(lambda: fused_t5_ffn_plain(*args), iters=3, warmup=1)
    # yardstick only: the unfused bf16 FFN the encoder runs without
    # fused_encoder_ffn (three cuBLAS matmuls, gelu, gate, residual)
    ffn_p = {"wi_0": wi_0, "wi_1": wi_1, "wo": wo}
    library_ms = cuda_ms(lambda: x + t5_lib._ffn_block(
        ffn_p, t5_lib.rms_norm(x, lnw, cfg.layer_norm_epsilon), cfg),
        iters=10)
    # its RMSNorm and two GEMMs by CUDA kernel, each GEMM beside cuBLAS:
    # the up pair as one matmul over [wi_0 | wi_1], the down as one matmul
    # (a hidden of its own generator's, so that the later phases' inputs
    # stay those of earlier runs)
    h = x.view(rows, d_model)
    w_up = torch.cat([wi_0, wi_1], 1)
    hid = torch.randn((rows, d_ff), generator=torch.Generator(
        device=dev).manual_seed(SEED), device=dev).bfloat16()
    cublas_ms = [cuda_ms(lambda: torch.matmul(h, w_up), iters=10),
                 cuda_ms(lambda: torch.matmul(hid, wo), iters=10)]
    del w_up, hid
    split = kernel_split(lambda: fused_t5_ffn(*args))
    bytes_moved = 2 * rows * d_model * 2 + d_model * 2 + 3 * d_model * d_ff * 2
    flops = 3 * 2 * rows * d_model * d_ff
    result = dict(
        shape=dict(M=rows, D=d_model, F=d_ff, gated=True),
        ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
        library="unfused bf16 FFN: rms_norm, 3 torch.matmul, gelu, gate",
        **errs, non_gated=dict(ms=non_gated_ms, **non_gated_errs),
        rms_norm_ms=split["rms_norm_0"],
        **bf16_gemm_stage("fused_t5_ffn", split, cublas_ms),
        **bound(bytes_moved, flops, BF16_FLOP_PER_S))
    emit("t5_ffn", kernel_ms=kernel_ms, **{
        key: val for key, val in result.items() if key != "ms"})
    return result


def fp32_mask(batch: int, length: int, dev) -> torch.Tensor:
    """Row 0 with PADDED_KEYS masked keys, padded tails of several lengths,
    the last row fully masked."""
    mask = torch.ones((batch, length), dtype=torch.int32, device=dev)
    mask[0, length - PADDED_KEYS:] = 0
    for b in range(1, batch - 1, 4):
        mask[b, length - 40 - 3 * b:] = 0
    mask[batch - 1] = 0
    return mask


def check_fp32(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """An fp32 form against its plain version: finite, fp32, every element
    within FP32_ATOL + FP32_RTOL |want|; the largest error."""
    check(got.dtype == torch.float32, f"{name}: output is {got.dtype}")
    check(bool(torch.isfinite(got).all()), f"{name}: output not finite")
    err = (got - want).abs()
    check(bool((err <= FP32_ATOL + FP32_RTOL * want.abs()).all()),
          f"{name}: outside atol/rtol {FP32_ATOL} of the plain version "
          f"(max abs err {err.max().item()})")
    return err.max().item()


def launched(fn, call) -> int:
    """The launches that one call adds to fn's count."""
    before = fn.launches
    call()
    torch.cuda.synchronize()
    return fn.launches - before


def phase_fp32_kernels(gen: torch.Generator) -> dict:
    """The fp32 forms of t5_attention_core, cross_attention_decode and
    fused_t5_ffn against their plain versions at the main path's shapes
    (and the two attentions at an L that is not a multiple of their tile),
    timed beside their bounds and a library call."""
    cfg = t5_lib.T5Config.t0_3b()
    heads, head_dim, layers = cfg.num_heads, cfg.d_kv, cfg.num_decoder_layers
    length = splice_output_length(PROMPT_LEN, PREFIX_LENGTH, NUM_SHOTS + 1)
    width, d_model, d_ff = heads * head_dim, cfg.d_model, cfg.d_ff
    dev = gen.device
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on: the plain versions must multiply in fp32")

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev).mul_(scale)

    def attention_args(batch, seq):
        q = randn(batch, seq, width, scale=0.5)
        k = randn(batch, seq, width, scale=0.5)
        v = torch.rand((batch, seq, width), generator=gen,
                       device=dev).mul_(2).sub_(1)
        return (q, k, v, randn(heads, seq, seq, scale=0.5),
                fp32_mask(batch, seq, dev), heads)

    def check_attention(args):
        got = t5_attention_core(*args)
        torch.cuda.synchronize()
        err = check_fp32("t5_attention_core (fp32)", got,
                         t5_attention_core_plain(*args))
        q, _, v = args[:3]
        uniform = v[-1].mean(dim=0).expand(q.shape[1], -1)
        check(bool(torch.allclose(got[-1], uniform, atol=FP32_ATOL,
                                  rtol=FP32_RTOL)),
              "t5_attention_core (fp32): the fully masked row is not the "
              "mean of v")
        return err

    results = {}
    check(port_fab.t5_f32_route(length, head_dim) == FP32_HELD
          and port_fab.t5_f32_route(FP32_LONG_LEN, head_dim) == FP32_TWO_PASS,
          "t5_attention_core (fp32): the main path's L does not take the "
          "held route, or FP32_LONG_LEN does not take the two-pass route")
    edge_err = check_attention(attention_args(FP32_EDGE_BATCH, FP32_EDGE_LEN))
    long_err = check_attention(attention_args(FP32_LONG_BATCH, FP32_LONG_LEN))
    args = attention_args(BATCH, length)
    err = check_attention(args)
    q, k, v, bias, mask, _ = args
    per_call = launched(t5_attention_core, lambda: t5_attention_core(*args))
    two_pass = port_fab._launcher(FP32_TWO_PASS)
    two_pass_out = torch.empty_like(q)

    def call_two_pass():
        rc = two_pass(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      bias.data_ptr(), mask.data_ptr(),
                      two_pass_out.data_ptr(), BATCH, length, heads,
                      head_dim, torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"t5_attention_core (fp32, two-pass): cudaError {rc}")

    call_two_pass()
    torch.cuda.synchronize()
    two_pass_err = check_fp32("t5_attention_core (fp32, two-pass)",
                              two_pass_out, t5_attention_core_plain(*args))
    # the held route and the two-pass route in turns
    turns = {"held": [], "two_pass": []}
    for name in ("held", "two_pass", "two_pass", "held"):
        call = ((lambda: t5_attention_core(*args)) if name == "held"
                else call_two_pass)
        turns[name].append(cuda_ms(call, iters=5))
    kernel_ms = sum(turns["held"]) / 2
    two_pass_ms = sum(turns["two_pass"]) / 2
    del two_pass_out
    plain_ms = cuda_ms(lambda: t5_attention_core_plain(*args), iters=3,
                       warmup=1)
    q4, k4, v4 = (x.view(BATCH, length, heads, head_dim).transpose(1, 2)
                  for x in (q, k, v))
    lib_bias = bias[None] + torch.where(mask[:, None, None, :] > 0, 0.0,
                                        -1e9)
    library_ms = cuda_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=lib_bias, scale=1.0), iters=5)
    del lib_bias, q4, k4, v4
    flops = 4 * BATCH * heads * length * length * head_dim
    tiled = -(-length // 64) * 64   # the held route's whole 64-row tiles
    results["t5_attention_core_f32"] = dict(
        shape=dict(B=BATCH, L=length, H=heads, dh=head_dim),
        max_abs_err=err, edge=dict(B=FP32_EDGE_BATCH, L=FP32_EDGE_LEN,
                                   max_abs_err=edge_err),
        long=dict(B=FP32_LONG_BATCH, L=FP32_LONG_LEN, route=FP32_TWO_PASS,
                  max_abs_err=long_err),
        route=FP32_HELD, padded_keys=PADDED_KEYS,
        launches_per_call=per_call, ms=kernel_ms, turns_ms=turns,
        two_pass_ms=two_pass_ms, two_pass_max_abs_err=two_pass_err,
        plain_ms=plain_ms, library_ms=library_ms,
        library="scaled_dot_product_attention, fp32, (B, H, L, L) bias",
        route_bound_ms=4 * BATCH * heads * tiled * tiled * head_dim
        / FP32_FLOP_PER_S * 1e3,
        two_pass_route_bound_ms=1.5 * flops / FP32_FLOP_PER_S * 1e3,
        # the fp32 attentions' common yardstick (rows 9, 11, 16, 17 fp32):
        # each dot as the six exact bf16-plane products on the tensor
        # cores; the function on fp32 FMAs beside it
        fp32_fma_bound_ms=flops / FP32_FLOP_PER_S * 1e3,
        **bound(4 * q.numel() * 4 + bias.numel() * 4 + mask.numel() * 4,
                F32_PLANE_PRODUCTS * flops, BF16_FLOP_PER_S))
    del args, q, k, v, bias, mask
    torch.cuda.empty_cache()

    def decode_args(batch, seq, n_layers):
        return (randn(batch, width), randn(n_layers, batch, seq, width),
                randn(n_layers, batch, seq, width), fp32_mask(batch, seq, dev),
                min(DECODE_LAYER, n_layers - 1), heads)

    def check_decode(args):
        got = cross_attention_decode(*args)
        torch.cuda.synchronize()
        return check_fp32("cross_attention_decode (fp32)", got,
                          cross_attention_decode_plain(*args))

    edge_err = check_decode(decode_args(FP32_EDGE_BATCH, FP32_EDGE_LEN, 2))
    args = decode_args(BATCH, length, layers)
    err = check_decode(args)
    q, k, v, mask = args[:4]
    per_call = launched(cross_attention_decode,
                        lambda: cross_attention_decode(*args))
    kernel_ms = cuda_ms(lambda: cross_attention_decode(*args), iters=50)
    plain_ms = cuda_ms(lambda: cross_attention_decode_plain(*args), iters=5)
    q4 = q.view(BATCH, heads, 1, head_dim)
    k4, v4 = (c[DECODE_LAYER].view(BATCH, length, heads, head_dim)
              .transpose(1, 2) for c in (k, v))
    lib_bias = torch.where(mask[:, None, None, :] > 0, 0.0, -1e9)
    library_ms = cuda_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=lib_bias, scale=1.0), iters=20)
    results["cross_attention_decode_f32"] = dict(
        shape=dict(layers=layers, B=BATCH, L=length, H=heads, dh=head_dim,
                   layer=DECODE_LAYER),
        max_abs_err=err, edge=dict(B=FP32_EDGE_BATCH, L=FP32_EDGE_LEN,
                                   max_abs_err=edge_err),
        padded_keys=PADDED_KEYS, launches_per_call=per_call, ms=kernel_ms,
        plain_ms=plain_ms, library_ms=library_ms,
        library="scaled_dot_product_attention, fp32",
        **bound(2 * BATCH * length * width * 4 + 2 * q.numel() * 4
                + mask.numel() * 4, 4 * BATCH * length * width,
                FP32_FLOP_PER_S))
    del args, q, k, v, mask, q4, k4, v4
    torch.cuda.empty_cache()

    x = randn(BATCH, length, d_model, scale=2.0)
    lnw = (1 + 0.1 * randn(d_model)).bfloat16()
    wi_0, wi_1 = (randn(d_model, d_ff, scale=d_model ** -0.5).bfloat16()
                  for _ in range(2))
    wo = randn(d_ff, d_model, scale=d_ff ** -0.5).bfloat16()
    args = (x, lnw, wi_0, wi_1, wo, cfg.layer_norm_epsilon)
    got = fused_t5_ffn(*args)
    torch.cuda.synchronize()
    check(got.dtype == torch.float32, f"fused_t5_ffn (fp32): {got.dtype}")
    errs = compare_q8(got, fused_t5_ffn_plain(*args))
    del got
    per_call = launched(fused_t5_ffn, lambda: fused_t5_ffn(*args))
    kernel_ms = cuda_ms(lambda: fused_t5_ffn(*args), iters=10)
    plain_ms = cuda_ms(lambda: fused_t5_ffn_plain(*args), iters=3, warmup=1)
    # yardstick only: the unfused FFN the fp32 encoder runs without
    # fused_encoder_ffn (the weights upcast, three fp32 matmuls)
    fp32_cfg = dataclasses.replace(cfg, dtype=torch.float32)
    ffn_p = {"wi_0": wi_0, "wi_1": wi_1, "wo": wo}
    library_ms = cuda_ms(lambda: x + t5_lib._ffn_block(
        ffn_p, t5_lib.rms_norm(x, lnw, cfg.layer_norm_epsilon), fp32_cfg),
        iters=5)
    rows = BATCH * length
    results["fused_t5_ffn_f32"] = dict(
        shape=dict(M=rows, D=d_model, F=d_ff, gated=True, x="float32"),
        **errs, launches_per_call=per_call, ms=kernel_ms, plain_ms=plain_ms,
        library_ms=library_ms,
        library="unfused fp32 FFN: rms_norm, 3 fp32 torch.matmul, gelu, "
                "gate",
        **bound(2 * rows * d_model * 4 + d_model * 2
                + 3 * d_model * d_ff * 2, 3 * 2 * rows * d_model * d_ff,
                BF16_FLOP_PER_S))
    del args, x
    torch.cuda.empty_cache()
    results.update(fp32_int8_kernels(gen))
    results["fused_gpt2_block_f32"] = fp32_gpt2_block(gen)
    for name, res in results.items():
        emit("fp32_kernels", kernel=name, kernel_ms=res["ms"], **{
            key: val for key, val in res.items() if key != "ms"})
    return results


def fp32_int8_kernels(gen: torch.Generator) -> dict:
    """The fp32 forms of rows 2-4 (tpu.compute_dtype=float32 with the int8
    encoder): fp32 x, attention output and residual, an fp32 norm scale (a
    calibrated one may be fp32), at the int8 path's shapes (M = 32 x 557,
    D = 2048, F = 5120, INT8_GROUPS groups) on weights from the port's
    quantizer, against their plain versions by compare_q8's rule and within
    FP32_Q8_REL_FROBENIUS; fp32 outputs; the out-projection bit-equal; the
    two with a norm at most FP32_Q8_CODES_OFF_SHARE of their activation
    codes off the card plain version's (q8_boundary, which also counts
    both against the CPU's); timed beside the plain version, torch._int_mm
    of the same products (GEMMs only) and the bound."""
    cfg = t5_lib.T5Config.t0_3b()
    length = splice_output_length(PROMPT_LEN, PREFIX_LENGTH, NUM_SHOTS + 1)
    d_model, inner, d_ff = cfg.d_model, cfg.num_heads * cfg.d_kv, cfg.d_ff
    rows = BATCH * length
    dev = gen.device

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev).mul_(scale)

    def quant(k, n):
        q, s = t5_lib._quant_stacked_i8(randn(1, k, n, scale=k ** -0.5),
                                        INT8_GROUPS)
        return q[0], s[0]

    def codes(k):  # activation codes for the library yardstick
        return torch.randint(-127, 128, (rows, k), generator=gen, device=dev,
                             dtype=torch.int8)

    x = randn(BATCH, length, d_model, scale=2.0)
    attn = randn(BATCH, length, inner)
    lnw = 1 + 0.1 * randn(d_model)
    qkv_w = [quant(d_model, inner) for _ in range(3)]
    o_w = quant(inner, d_model)
    ffn_w = [quant(d_model, d_ff), quant(d_model, d_ff), quant(d_ff, d_model)]
    act = rows * d_model * 4               # one fp32 (M, D) activation
    cases = {
        "fused_t5_ln_qkv_q8_f32": dict(
            fn=fused_t5_ln_qkv_q8, plain=fused_t5_ln_qkv_q8_plain,
            args=(x, lnw, *[t for w in qkv_w for t in w]),
            gemms=[(d_model, w) for w, _ in qkv_w],
            bytes=act + d_model * 4 + 3 * rows * inner * 4
            + sum(w.numel() + s.numel() * 4 for w, s in qkv_w),
            ops=3 * 2 * rows * d_model * inner),
        "fused_oproj_residual_q8_f32": dict(
            fn=fused_oproj_residual_q8, plain=fused_oproj_residual_q8_plain,
            args=(x, attn, *o_w), gemms=[(inner, o_w[0])],
            bytes=2 * act + rows * inner * 4 + o_w[0].numel()
            + o_w[1].numel() * 4,
            ops=2 * rows * inner * d_model),
        "fused_t5_ffn_q8_f32": dict(
            fn=fused_t5_ffn_q8, plain=fused_t5_ffn_q8_plain,
            args=(x, lnw, *[t for w in ffn_w for t in w]),
            gemms=[(d_model, ffn_w[0][0]), (d_model, ffn_w[1][0]),
                   (d_ff, ffn_w[2][0])],
            bytes=2 * act + d_model * 4
            + sum(w.numel() + s.numel() * 4 for w, s in ffn_w),
            ops=2 * rows * d_model * d_ff * 2 + 2 * rows * d_ff * d_model),
    }
    results = {}
    for name, case in cases.items():
        fn, plain, args = case["fn"], case["plain"], case["args"]
        got = fn(*args)
        torch.cuda.synchronize()
        want = plain(*args)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        check(all(g.dtype == torch.float32 for g in got),
              f"{name}: outputs {[g.dtype for g in got]}, not fp32")
        errs = [compare_q8(g, w) for g, w in zip(got, want)]
        differing = sum(int((g != w).sum()) for g, w in zip(got, want))
        elements = sum(w.numel() for w in want)
        del got, want
        rel = max(e["rel_frobenius"] for e in errs)
        check(rel <= FP32_Q8_REL_FROBENIUS,
              f"{name}: relative Frobenius error {rel} to the plain version "
              f"> {FP32_Q8_REL_FROBENIUS}")
        codes_off = {}
        if name == "fused_oproj_residual_q8_f32":  # no norm: no flips
            check(differing == 0, f"{name}: {differing} outputs differ from "
                  "the plain version's")
        else:
            codes_off = q8_boundary(name, fn, plain, args)
            check(codes_off["codes_off_plain_share"]
                  <= FP32_Q8_CODES_OFF_SHARE,
                  f"{name}: {codes_off['codes_off_plain']} of "
                  f"{codes_off['codes']} codes differ from the card's plain "
                  f"version's (> {FP32_Q8_CODES_OFF_SHARE})")
        per_call = launched(fn, lambda: fn(*args))
        kernel_ms = cuda_ms(lambda: fn(*args), iters=20)
        plain_ms = cuda_ms(lambda: plain(*args), iters=3, warmup=1)
        # yardstick only: torch._int_mm of the same int8 products, GEMMs
        # alone, the weights column-major as cuBLASLt's int8 GEMM takes them
        lib_col = [(codes(k), w.t().contiguous().t())
                   for k, w in case["gemms"]]
        library_ms = cuda_ms(
            lambda: [torch._int_mm(a, w) for a, w in lib_col], iters=10)
        del lib_col
        results[name] = dict(
            shape=dict(M=rows, D=d_model, inner=inner, F=d_ff,
                       G=INT8_GROUPS, x="float32", ln="float32"),
            max_abs_err=max(e["max_abs_err"] for e in errs),
            rel_frobenius=rel,
            beyond_one_ulp=max(e["beyond_one_ulp"] for e in errs),
            outputs_off_plain_share=differing / elements, **codes_off,
            launches_per_call=per_call, ms=kernel_ms, plain_ms=plain_ms,
            library_ms=library_ms,
            library="torch._int_mm, GEMMs only, column-major weights",
            **bound(case["bytes"], case["ops"], INT8_OP_PER_S))
        torch.cuda.empty_cache()
    del x, attn, qkv_w, o_w, ffn_w
    torch.cuda.empty_cache()
    return results


def gpt2_f32_rule(name: str, got: torch.Tensor, want: torch.Tensor, x,
                  mask, params, heads) -> dict:
    """fused_gpt2_block's fp32 form against its plain version on the same
    inputs: finite fp32 outputs, each within the bf16 form's whole-block
    rule, KERNEL_ATOL + KERNEL_RTOL |want| (the intermediates are bf16, and
    the tensor cores' sums round some of them the other way); at least
    FP32_GPT2_CLOSE_FLOOR of them within FP32_ATOL (1 + |want|), and a
    relative Frobenius error at most FP32_GPT2_REL_OF_BF16_CAST of the bf16
    form's with casts around it (the plain version on x rounded to bf16,
    its output rounded to bf16), so that a form which rounded x or its
    output fails. The readings of both."""
    check(got.dtype == torch.float32 and bool(torch.isfinite(got).all()),
          f"{name}: {got.dtype} output or not finite")
    err = (got - want).abs()
    check(bool((err <= KERNEL_ATOL + KERNEL_RTOL * want.abs()).all()),
          f"{name} outside atol/rtol 8e-3 of the plain version (max abs err "
          f"{err.max().item()})")
    cast = fused_gpt2_block_plain(x.bfloat16().float(), mask, *params,
                                  heads).bfloat16().float()

    def readings(out, out_err):
        return dict(
            rel_frobenius=((out - want).norm() / want.norm()).item(),
            within_fp32_tol_share=(out_err <= FP32_ATOL * (1 + want.abs()))
            .float().mean().item())

    own, by_cast = readings(got, err), readings(cast, (cast - want).abs())
    del cast
    check(own["within_fp32_tol_share"] >= FP32_GPT2_CLOSE_FLOOR,
          f"{name}: {own['within_fp32_tol_share']} of outputs within "
          f"{FP32_ATOL} (1 + |want|) of plain (< {FP32_GPT2_CLOSE_FLOOR})")
    check(own["rel_frobenius"]
          <= FP32_GPT2_REL_OF_BF16_CAST * by_cast["rel_frobenius"],
          f"{name}: relative Frobenius error {own['rel_frobenius']} > "
          f"{FP32_GPT2_REL_OF_BF16_CAST} x the bf16 form's with casts "
          f"({by_cast['rel_frobenius']})")
    rms = want.square().mean().sqrt()
    return dict(max_abs_err=err.max().item(),
                flip_max=(err / (want.abs() + rms)).max().item(),
                outputs_off_plain_share=(err > 0).float().mean().item(),
                **own, bf16_cast=by_cast)


def fp32_gpt2_block(gen: torch.Generator) -> dict:
    """The fp32 form of fused_gpt2_block (tpu.compute_dtype=float32) at
    GPT-2 small widths, B=32 with right-padded rows, bf16 parameters (the
    config's params_dtype): at config_clipcap's fp32 run's 42 positions
    (ragged query tiles and rows), and at 64 and 128; at 64 also with fp32
    parameters (tpu.params_dtype=float32: LayerNorms and biases no bf16
    holds, the weights cast to bf16 by the wrapper on every call, timed
    with that cast). Each held to its plain version by gpt2_f32_rule; on
    bf16-valued x its output rounded to bf16 is the bf16 form's, bit for
    bit; timed beside the plain version, the bound and an unfused
    fp32-activation block (LayerNorm in fp32, bf16 addmm, SDPA)."""
    cfg = gpt2_lib.GPT2Config.gpt2_small()
    d_model, heads, d_ff = cfg.d_model, cfg.num_heads, 4 * cfg.d_model
    head_dim, eps = d_model // heads, cfg.layer_norm_epsilon
    dev = gen.device
    batch = 32
    params = gpt2_layer(gen, cfg)
    # the shapes added after the first two draw from a generator of their
    # own, so that the shared one's draws, and every later phase's inputs,
    # stay as they were
    own = torch.Generator(device=dev).manual_seed(FP32_GPT2_PATH_LEN)
    params_f32 = [p.float() + 1e-3 * torch.rand(p.shape, generator=own,
                                                device=dev)
                  if p.dim() == 1 else p.float() for p in params]
    f = torch.nn.functional
    timed = {}
    for length, source in ((64, gen), (128, gen), (FP32_GPT2_PATH_LEN, own)):
        x = torch.randn((batch, length, d_model), generator=source,
                        device=dev)
        mask = right_padded_mask(batch, length, dev, length // 2)
        forms = {"params_bf16": params}
        if length == 64:
            forms["params_f32"] = params_f32
        for form, p_form in forms.items():
            args = (x, mask, *p_form, heads)
            name = f"fused_gpt2_block (fp32, {form}) at L={length}"
            got = fused_gpt2_block(*args)
            torch.cuda.synchronize()
            want = fused_gpt2_block_plain(*args)
            errs = gpt2_f32_rule(name, got, want, x, mask, p_form, heads)
            del got, want
            row = dict(shape=dict(B=batch, L=length, D=d_model, H=heads,
                                  F=d_ff, G=gpt2_block_group(batch),
                                  x="float32", params=str(p_form[0].dtype)
                                  .removeprefix("torch.")), **errs)
            if form == "params_f32":
                row.update(
                    launches_per_call=launched(
                        fused_gpt2_block, lambda: fused_gpt2_block(*args)),
                    ms=cuda_ms(lambda: fused_gpt2_block(*args), iters=20),
                    ms_note="the wrapper's four weight casts to bf16 "
                            "included")
                timed[f"L{length}"]["params_f32"] = row
                continue
            xb = x.bfloat16()
            same = torch.equal(fused_gpt2_block(xb.float(), mask, *params,
                                                heads).bfloat16(),
                               fused_gpt2_block(xb, mask, *params, heads))
            check(same, f"{name}: on bf16 x, its output rounded to bf16 is "
                  "not the bf16 form's")
            per_call = launched(fused_gpt2_block,
                                lambda: fused_gpt2_block(*args))
            causal = torch.ones((length, length), dtype=torch.bool,
                                device=dev).tril()
            sdpa_mask = causal[None, None] & (mask[:, None, None, :] > 0)
            ln1 = (params[0].float(), params[1].float())
            ln2 = (params[6].float(), params[7].float())
            (_, _, w_qkv, b_qkv, w_out, b_out, _, _, w_fc, b_fc, w_proj,
             b_proj) = params

            def lib_block():
                # yardstick only: the unfused block on fp32 activations, its
                # products in bf16 as the kernel's (fp32 LayerNorms and
                # residuals; cuBLAS addmm; scaled_dot_product_attention with
                # the causal and key mask; tanh gelu)
                x2 = x.view(-1, d_model)
                h = f.layer_norm(x2, (d_model,), *ln1, eps).bfloat16()
                qkv = torch.addmm(b_qkv, h, w_qkv).view(
                    batch, length, 3, heads, head_dim)
                o = f.scaled_dot_product_attention(
                    *qkv.permute(2, 0, 3, 1, 4), attn_mask=sdpa_mask)
                r1 = x2 + torch.addmm(b_out, o.transpose(1, 2).reshape(
                    -1, d_model), w_out)
                z = torch.addmm(b_fc, f.layer_norm(r1, (d_model,), *ln2,
                                                   eps).bfloat16(), w_fc)
                return r1 + torch.addmm(
                    b_proj, f.gelu(z, approximate="tanh"), w_proj)

            turns = [cuda_ms(fn, iters=20) for fn in (
                lib_block, lambda: fused_gpt2_block(*args), lib_block,
                lambda: fused_gpt2_block(*args))]
            rows = batch * length
            timed[f"L{length}"] = dict(
                row, rounds_to_bf16_form=same, launches_per_call=per_call,
                ms=(turns[1] + turns[3]) / 2,
                plain_ms=cuda_ms(lambda: fused_gpt2_block_plain(*args),
                                 iters=3, warmup=1),
                library_ms=(turns[0] + turns[2]) / 2,
                turns_ms=dict(library=turns[0::2], kernel=turns[1::2]),
                library="the unfused block on fp32 activations: fp32 "
                        "layer_norm, bf16 addmm, scaled_dot_product_attention"
                        " (causal and key mask), gelu(approximate='tanh')",
                **bound(2 * rows * d_model * 4 + mask.numel() * 4
                        + sum(p.numel() * 2 for p in params),
                        gpt2_block_ops(mask, d_model, d_ff),
                        BF16_FLOP_PER_S))
        del args, x
        torch.cuda.empty_cache()
    return dict(timed["L64"], at_L128=timed["L128"],
                at_path_len=timed[f"L{FP32_GPT2_PATH_LEN}"])


def phase_generate_fused(model: VCT0Model, prefix, tokens, mask,
                         default: dict) -> dict:
    """Every fused kernel on: the default path's weights and prompts,
    generate twice, breakdown, profile, token agreement with the default
    path (recorded), and both configurations' calls in turns."""
    lm_cfg = dataclasses.replace(model.cfg.lm, fused_encoder_attention=True,
                                 fused_encoder_ffn=True,
                                 fused_decode_attention=True)
    fused = VCT0Model(dataclasses.replace(model.cfg, lm=lm_cfg),
                      dict(model.params))
    layers = lm_cfg.num_encoder_layers
    result = phase_generate(
        fused, prefix, tokens, mask,
        expected=lambda steps: launches(
            t5_attention_core=layers, fused_t5_ffn=layers,
            cross_attention_decode=lm_cfg.num_decoder_layers * steps),
        phase="generate_fused")
    breakdown = phase_breakdown(fused, prefix, tokens, mask,
                                phase="breakdown_fused")
    phase_profile(fused, prefix, tokens, mask, result["wall_s"],
                  phase="profile_fused")
    same = result["tokens"] == default["tokens"]
    turns = generate_in_turns({"bf16": model, "fused": fused}, prefix,
                              tokens, mask)
    decode = decode_in_turns(model, fused, prefix, tokens, mask)
    emit("fused_vs_bf16", token_agreement=same.float().mean().item(),
         first_token_agreement=same[:, 0].float().mean().item(),
         fused_decode_s=breakdown["decode_s"],
         generate_s_in_turns=turns,
         prompts_per_s_in_turns={k: [BATCH / t for t in v]
                                 for k, v in turns.items()},
         **decode)
    return result


def decode_in_turns(model: VCT0Model, fused: VCT0Model, prefix, tokens,
                    mask) -> dict:
    """The greedy decode alone, without and with cross_attention_decode,
    on the same encoder states: host-clock seconds in turns (bf16, fused,
    fused, bf16) and the device time of its kernels under the profiler."""
    lm = model.params["lm"]
    with torch.inference_mode():
        joint, joint_mask = model.encoder_calibration_batch(prefix, tokens,
                                                            mask)
        hidden = t5_lib.t5_encode(lm, model.cfg.lm, inputs_embeds=joint,
                                  attention_mask=joint_mask)
    cfgs = {"bf16": model.cfg.lm, "fused": dataclasses.replace(
        model.cfg.lm, fused_decode_attention=True)}

    def decode(name):
        with torch.inference_mode():
            greedy_decode_t5(lm, cfgs[name], hidden, joint_mask,
                             MAX_NEW_TOKENS)

    wall = {"bf16": [], "fused": []}
    for name in ("bf16", "fused", "fused", "bf16"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode(name)
        torch.cuda.synchronize()
        wall[name].append(time.perf_counter() - t0)
    device = {}
    for name in cfgs:
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            decode(name)
            torch.cuda.synchronize()
        device[name] = sum(
            e.time_range.elapsed_us() for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6
    return dict(decode_s_in_turns=wall, decode_device_s=device)


def tree_bytes(tree) -> int:
    """Bytes of the distinct tensors of a params tree."""
    seen = {}

    def walk(node):
        if isinstance(node, dict):
            for child in node.values():
                walk(child)
        else:
            seen[node.data_ptr()] = node.numel() * node.element_size()

    walk(tree)
    return sum(seen.values())


def phase_generate_int8_all(model: VCT0Model, prefix, tokens, mask) -> dict:
    """Every int8 opt-in of base_env.jsonnet at once (the decode's int8
    cross-KV at the auto layout and the W8A16 step), with the attention
    kernel: calibrate and quantize, then generate twice."""
    lm_cfg = dataclasses.replace(
        model.cfg.lm, fused_encoder_attention=True, int8_encoder_ffn=True,
        int8_encoder_attn=True, int8_cross_kv=True, int8_decoder_step=True)
    int8 = VCT0Model(dataclasses.replace(model.cfg, lm=lm_cfg),
                     dict(model.params))
    int8.calibrate_and_quantize_int8(
        [dict(prefix=prefix, question_tokens=tokens, question_mask=mask)],
        alpha=0.5)
    dec = int8.params["lm"]["decoder"]
    check("step_q8" in dec and not dec["ffn"] and not dec["self_attn"],
          "the decode step's weights were not quantized with drop_bf16")
    layers = lm_cfg.num_encoder_layers
    result = phase_generate(
        int8, prefix, tokens, mask,
        expected=lambda steps: launches(
            t5_attention_core=layers, fused_t5_ln_qkv_q8=layers,
            fused_oproj_residual_q8=layers, fused_t5_ffn_q8=layers),
        phase="generate_int8_all")
    emit("int8_all_params", kv_layout=t5_lib._resolve_kv_layout(lm_cfg, BATCH),
         params_gb=tree_bytes(int8.params) / 1e9,
         bf16_params_gb=tree_bytes(model.params) / 1e9)
    phase_breakdown(int8, prefix, tokens, mask, phase="breakdown_int8_all")
    phase_profile(int8, prefix, tokens, mask, result["wall_s"],
                  phase="profile_int8_all")
    return result


def phase_kv_layouts(model: VCT0Model, gen: torch.Generator) -> None:
    """One decode step at full width and 2 decoder layers for each int8
    cross-KV layout, on the same encoder states."""
    lm = model.params["lm"]
    length = splice_output_length(PROMPT_LEN, PREFIX_LENGTH, NUM_SHOTS + 1)
    dev = gen.device
    hidden = torch.randn((BATCH, length, model.cfg.lm.d_model),
                         generator=gen, device=dev).bfloat16()
    mask = torch.ones((BATCH, length), dtype=torch.int32, device=dev)
    mask[1::4, length - 60:] = 0
    token = torch.zeros((BATCH,), dtype=torch.int32, device=dev)
    logits, cache_bytes = {}, {}
    with torch.inference_mode():
        for layout in ("unmerged", "merged", "transposed"):
            cfg = dataclasses.replace(model.cfg.lm, num_decoder_layers=2,
                                      int8_cross_kv=True,
                                      int8_kv_layout=layout)
            cache = t5_lib.init_decode_cache(lm, cfg, hidden, MAX_NEW_TOKENS)
            cache_bytes[layout] = sum(
                t.numel() * t.element_size() for key, t in cache.items()
                if key.startswith("cross_"))
            logits[layout], _ = t5_lib.t5_decode_step(lm, cfg, token, cache,
                                                      mask)
            del cache
    check(bool(torch.isfinite(logits["unmerged"]).all()),
          "int8 cross-KV logits not finite")
    check(torch.equal(logits["unmerged"], logits["merged"]),
          "unmerged and merged int8 cross-KV logits differ")
    ref = logits["unmerged"]
    rel = ((logits["transposed"] - ref).norm() / ref.norm()).item()
    check(rel <= LAYOUT_REL_ERR,
          f"transposed int8 cross-KV logits differ from unmerged: rel {rel}")
    emit("kv_layouts", decoder_layers=2, batch=BATCH, length=length,
         transposed_rel_err=rel, limit=LAYOUT_REL_ERR,
         transposed_max_abs_diff=(logits["transposed"] - ref).abs().max()
         .item(),
         cross_cache_bytes_at_rest=cache_bytes)


BEAMS = 3                          # generate_modes' and config_eval_modes' K
SEGMENT_LEN = 128                  # one-at-a-time: the data side's bucket
FORCED_LEN = 4                     # the forced decoder prefix, start incl.
EOS_AT_STEPS = (2, 3, 4, 5)        # force_eos_at's steps (2-5 token answers)


class DecodeSteps:
    """Records the rows of each t5_decode_step call made while it is
    installed (ops/decoding.py calls the step through models.t5)."""

    def __enter__(self):
        self.rows, self.original = [], t5_lib.t5_decode_step

        def counted(params, cfg, token, cache, mask):
            self.rows.append(int(token.shape[0]))
            return self.original(params, cfg, token, cache, mask)

        t5_lib.t5_decode_step = counted
        return self

    def __exit__(self, *exc):
        t5_lib.t5_decode_step = self.original


def make_segments(cfg: VCT0Config, dev: torch.device):
    """One-at-a-time prompts: (B, NUM_SHOTS + 1, SEGMENT_LEN) tokens,
    segment i holding its sentinel <extra_id_i>, every fourth row's
    segments right-padded."""
    rng = np.random.default_rng(SEED + 1)
    segments = NUM_SHOTS + 1
    tokens = rng.integers(3, 32000, (BATCH, segments, SEGMENT_LEN)).astype(
        np.int32)
    mask = np.ones((BATCH, segments, SEGMENT_LEN), np.int32)
    for b in range(BATCH):
        for i in range(segments):
            valid = SEGMENT_LEN - (20 + i if b % 4 == 3 else 0)
            tokens[b, i, valid:] = cfg.lm.pad_token_id
            mask[b, i, valid:] = 0
            tokens[b, i, rng.integers(valid - 1)] = cfg.sentinel_base - i
    return (torch.from_numpy(tokens).to(dev), torch.from_numpy(mask).to(dev))


def run_mode(mode: str, model: VCT0Model, expected, **kwargs) -> dict:
    """generate(**kwargs) twice; in each call every kernel count is set to
    0 just before and read just after, and must equal ``expected(steps,
    rows)`` for the decode steps the call ran and their rows. The second
    call's tokens must equal the first's; its wall time, prompts/s and peak
    memory are kept."""
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in PATH_KERNELS:
            fn.launches = 0
        with DecodeSteps() as steps:
            t0 = time.perf_counter()
            out_tokens, logprobs = model.generate(
                max_new_tokens=MAX_NEW_TOKENS, **kwargs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = {fn.__name__: fn.launches for fn in PATH_KERNELS}
        want = expected(len(steps.rows), set(steps.rows))
        check(counts == want, f"generate_modes {mode}: kernels launched "
              f"{counts}, expected {want}")
        runs.append(dict(tokens=out_tokens, logprobs=logprobs, wall_s=wall,
                         launches=counts, steps=len(steps.rows),
                         step_rows=sorted(set(steps.rows)),
                         peak_bytes=torch.cuda.max_memory_allocated()))
    first, second = runs
    out_tokens, logprobs = second["tokens"], second["logprobs"]
    check(tuple(out_tokens.shape) == (BATCH, MAX_NEW_TOKENS),
          f"generate_modes {mode}: tokens shape {tuple(out_tokens.shape)}")
    check(torch.equal(first["tokens"], out_tokens),
          f"generate_modes {mode}: the two calls' tokens differ")
    check(bool(((out_tokens >= 0)
                & (out_tokens < model.cfg.lm.vocab_size)).all()),
          f"generate_modes {mode}: token outside the vocabulary")
    check(bool(torch.isfinite(logprobs).all()) and bool((logprobs <= 0).all()),
          f"generate_modes {mode}: log-probs not finite or above 0")
    return dict(wall_s=second["wall_s"], first_wall_s=first["wall_s"],
                prompts_per_s=BATCH / second["wall_s"],
                peak_mem_gb=second["peak_bytes"] / 1e9,
                launches=second["launches"], decode_steps=second["steps"],
                step_rows=second["step_rows"], tokens=out_tokens)


def phase_generate_modes(model: VCT0Model, prefix, tokens, mask,
                         default: dict) -> dict:
    """The other generate modes at full T0-3B width on the generate phase's
    weights and prompts (B=32), each run twice with its launches checked:
    beam search (K=3) with cross_attention_decode on 96 rows a step;
    prefill_chunks=2 and force_eos_at on the default model, against the
    generate phase's tokens; no_prefix, one-at-a-time (5 segments of 128
    tokens, one encode of 160 rows, the decoder over 5 x 137 keys),
    prefix-only captioning and a forced decoder prefix through
    cross_attention_decode."""
    lm_cfg = dataclasses.replace(model.cfg.lm, fused_decode_attention=True)
    fused = VCT0Model(dataclasses.replace(model.cfg, lm=lm_cfg),
                      dict(model.params))
    enc, dec = lm_cfg.num_encoder_layers, lm_cfg.num_decoder_layers
    rng = np.random.default_rng(SEED + 2)
    main = dict(prefix=prefix, question_tokens=tokens, question_mask=mask,
                num_shots=NUM_SHOTS)
    seg_tokens, seg_mask = make_segments(model.cfg, prefix.device)
    force_eos_at = torch.from_numpy(rng.choice(
        np.asarray(EOS_AT_STEPS, np.int32), size=BATCH)).to(prefix.device)
    forced = rng.integers(3, 32000, (BATCH, FORCED_LEN)).astype(np.int32)
    forced[:, 0] = lm_cfg.decoder_start_token_id

    def with_decode_kernel(encodes: int = 1, rows: int = BATCH):
        def expected(steps, step_rows):
            check(step_rows <= {rows}, f"decode steps on {step_rows} rows, "
                  f"not {rows}")
            return launches(t5_attention_core=enc * encodes,
                            cross_attention_decode=dec * steps)
        return expected

    def encodes_only(encodes: int = 1):
        return lambda steps, step_rows: launches(
            t5_attention_core=enc * encodes)

    modes = {
        "beam": (fused, with_decode_kernel(rows=BATCH * BEAMS),
                 dict(main, num_beams=BEAMS)),
        "prefill_chunks": (model, encodes_only(2),
                           dict(main, prefill_chunks=2)),
        "force_eos_at": (model, encodes_only(),
                         dict(main, force_eos_at=force_eos_at)),
        "no_prefix": (fused, with_decode_kernel(),
                      dict(question_tokens=tokens, question_mask=mask,
                           no_prefix=True)),
        "one_at_a_time": (fused, with_decode_kernel(),
                          dict(prefix=prefix, question_tokens=seg_tokens,
                               question_mask=seg_mask,
                               pass_examples_through_encoder_one_at_a_time=True)),
        "prefix_only": (fused, with_decode_kernel(), dict(prefix=prefix)),
        "forced": (fused, with_decode_kernel(),
                   dict(main, decoder_input_ids=torch.from_numpy(forced).to(
                       prefix.device))),
    }
    results = {}
    for mode, (which, expected, kwargs) in modes.items():
        results[mode] = run_mode(mode, which, expected, **kwargs)
    check(torch.equal(results["prefill_chunks"]["tokens"], default["tokens"]),
          "generate_modes: prefill_chunks=2 gave other tokens than the "
          "unchunked generate phase")
    steps_col = torch.arange(MAX_NEW_TOKENS, device=prefix.device)[None]
    want_cut = torch.where(steps_col < force_eos_at[:, None],
                           default["tokens"], 0)
    check(torch.equal(results["force_eos_at"]["tokens"], want_cut),
          "generate_modes: force_eos_at did not cut the generate phase's "
          "tokens at each row's step")
    seg_len = splice_output_length(SEGMENT_LEN, PREFIX_LENGTH, 1)
    spliced = splice_output_length(PROMPT_LEN, PREFIX_LENGTH, NUM_SHOTS + 1)
    encoder = {"beam": f"{spliced} ({BEAMS} beams a prompt in the decode)",
               "prefill_chunks": f"{spliced} (2 chunks of {BATCH // 2} "
                                 "rows)",
               "force_eos_at": str(spliced), "no_prefix": str(PROMPT_LEN),
               "one_at_a_time": f"{NUM_SHOTS + 1} x {seg_len} (one encode "
                                f"of {(NUM_SHOTS + 1) * BATCH} rows)",
               "prefix_only": str(PREFIX_LENGTH * (NUM_SHOTS + 1)),
               "forced": f"{spliced}, {FORCED_LEN} forced decoder tokens"}
    for mode, res in results.items():
        emit(f"generate_modes_{mode}", batch=BATCH, encoder_tokens=encoder[
            mode], **{k: v for k, v in res.items() if k != "tokens"})
    emit("generate_modes", forced_eos_steps_mean=float(
        force_eos_at.float().mean()), prefill_chunks_tokens_equal=True)
    return results


def config_model(*opts) -> tuple:
    """The shipped VQA2 config through the port's config path: the CLI
    parser, process_config with --opts seed=SEED and ``opts``, the model
    factory on the card. Returns (model, seconds to build)."""
    argv = [str(CONFIG_FILE), "--mode", "test", "--opts", f"seed={SEED}",
            *opts]
    config = process_config(parse_args_sys(argv))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, kind = build_model_from_config(config)
    torch.cuda.synchronize()
    check(kind == "vct0" and isinstance(model, VCT0Model),
          f"the config built a {kind} model, not VC-T0")
    check(model.device.type == "cuda", f"the config's model is on "
          f"{model.device}, not the card")
    return model, time.perf_counter() - t0


def fields_differing(a, b) -> list:
    return sorted(f.name for f in dataclasses.fields(a)
                  if getattr(a, f.name) != getattr(b, f.name))


def phase_config_generate(cfg: VCT0Config, prefix, tokens, mask,
                          default: dict) -> dict:
    """The config-built bf16 model against the in-code config ``cfg``: the
    fields generate reads, every param leaf against init_vct0_params(cfg,
    seed=SEED), then generate twice with the generate phase's launches and
    tokens."""
    built, build_s = config_model()
    lm_diff = fields_differing(built.cfg.lm, cfg.lm)
    mapper_diff = fields_differing(built.cfg.mapper, cfg.mapper)
    read = ([f for f in lm_diff if f not in UNREAD_LM_FIELDS]
            + [f for f in mapper_diff if f in READ_MAPPER_FIELDS])
    check(not read, f"config_generate: the config's {read} differ from the "
          f"in-code config's")
    check((built.cfg.prefix_length, built.cfg.sentinel_base)
          == (cfg.prefix_length, cfg.sentinel_base),
          "config_generate: prefix length or sentinel base differ")
    got = dict(flat_leaves(built.params))
    want = dict(flat_leaves(init_vct0_params(cfg, seed=SEED,
                                             device=built.device)))
    check(sorted(got) == sorted(want),
          "config_generate: the params trees differ in their leaves")
    unequal = [key for key in want
               if got[key].dtype != want[key].dtype
               or not torch.equal(got[key], want[key])]
    check(not unequal, f"config_generate: leaves {unequal[:5]} differ from "
          f"init_vct0_params(cfg, seed={SEED})")
    emit("config_model", config=str(CONFIG_FILE.relative_to(REPO)),
         opts=[f"seed={SEED}"], build_s=build_s,
         lm_fields_differing=lm_diff, mapper_fields_differing=mapper_diff,
         param_leaves_bit_equal=len(want))
    del got, want
    torch.cuda.empty_cache()
    layers = built.cfg.lm.num_encoder_layers
    result = phase_generate(
        built, prefix, tokens, mask,
        expected=lambda steps: launches(t5_attention_core=layers),
        phase="config_generate")
    check(torch.equal(result["tokens"], default["tokens"]),
          "config_generate: tokens differ from the generate phase's")
    return result


def phase_config_generate_fp32(prefix, tokens, mask, default: dict) -> dict:
    """The shipped config with FP32_OPTS: bf16 params, fp32 activations,
    the three T5 kernels in their fp32 forms."""
    built, build_s = config_model(*FP32_OPTS)
    lm_cfg = built.cfg.lm
    check(lm_cfg.dtype == torch.float32,
          f"config_generate_fp32: cfg.lm.dtype is {lm_cfg.dtype}")
    check(lm_cfg.fused_encoder_attention and lm_cfg.fused_encoder_ffn
          and lm_cfg.fused_decode_attention,
          "config_generate_fp32: a fused option is off")
    check(built.params["lm"]["shared"].dtype == torch.bfloat16,
          "config_generate_fp32: the params are not bf16 (tpu.params_dtype)")
    layers = lm_cfg.num_encoder_layers
    result = phase_generate(
        built, prefix, tokens, mask,
        expected=lambda steps: launches(
            t5_attention_core=layers, fused_t5_ffn=layers,
            cross_attention_decode=lm_cfg.num_decoder_layers * steps),
        phase="config_generate_fp32")
    breakdown = phase_breakdown(built, prefix, tokens, mask,
                                phase="breakdown_config_fp32")
    busy = device_busy(
        lambda: built.generate(prefix, tokens, mask, num_shots=NUM_SHOTS,
                               max_new_tokens=MAX_NEW_TOKENS),
        result["wall_s"])
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on: the unfused encode must multiply in fp32")
    lm = built.params["lm"]
    with torch.inference_mode():
        joint, joint_mask = built.encoder_calibration_batch(prefix, tokens,
                                                            mask)
        got = t5_lib.t5_encode(lm, lm_cfg, inputs_embeds=joint,
                               attention_mask=joint_mask)
        want = t5_lib.t5_encode(lm, dataclasses.replace(
            lm_cfg, fused_encoder_attention=False, fused_encoder_ffn=False),
            inputs_embeds=joint, attention_mask=joint_mask)
    valid = joint_mask.bool()
    got, want = got[valid], want[valid]
    check(got.dtype == torch.float32 and bool(torch.isfinite(got).all()),
          "config_generate_fp32: encoder states not finite fp32")
    rel = ((got - want).norm() / want.norm()).item()
    check(rel <= FP32_ENCODER_REL_ERR,
          f"config_generate_fp32: the fused fp32 encoder is {rel} off the "
          f"unfused fp32 encode (limit {FP32_ENCODER_REL_ERR})")
    same = result["tokens"] == default["tokens"]
    emit("config_generate_fp32_check", opts=list(FP32_OPTS), build_s=build_s,
         encoder_rel_err=rel, limit=FP32_ENCODER_REL_ERR,
         encoder_max_abs_diff=(got - want).abs().max().item(),
         token_agreement_with_bf16=same.float().mean().item(),
         first_token_agreement_with_bf16=same[:, 0].float().mean().item(),
         wall_s=result["wall_s"], prompts_per_s=result["prompts_per_s"],
         peak_mem_gb=result["peak_mem_gb"], encode_s=breakdown["encode_s"],
         decode_s=breakdown["decode_s"], **busy)
    return result


def phase_bench_generate(*flags, phase: str = "bench_generate") -> dict:
    """tools/bench_generate.py's body at its defaults and ``flags``, one
    trial; its JSON line printed as the bench prints it."""
    args = bench_generate.build_parser().parse_args(["--trials", "1",
                                                     *flags])
    result = bench_generate.bench(args)
    print(json.dumps(result), flush=True)
    check(result["metric"] == bench_generate.METRIC and result["value"] > 0,
          f"{phase}: {result['metric']} = {result['value']}")
    check(result["device"]["name"] == torch.cuda.get_device_name(0),
          f"{phase}: did not run on the card")
    emit(phase, prompts_per_s=result["value"],
         config=result["config"], device=result["device"])
    return result


EVAL_QUESTIONS = 70                # batches of 32 + 32 + 6 at test.batch_size
EVAL_INT8_QUESTIONS = 32           # the int8 run's one calibrated batch
EVAL_TRAIN_QUESTIONS = 16          # the in-context pool
EVAL_RICES = 8                     # retrieved examples a question keeps
EVAL_OBJECTS = ("cup", "dog", "car", "kite", "bus", "sign", "chair",
                "plate", "train", "horse")
# (question type, answer type, question, answers), as in VQA v2
EVAL_TYPES = (
    ("what color is", "other", "what color is the {} ?",
     ("red", "blue", "green", "white", "black")),
    ("how many", "number", "how many {}s are there ?",
     ("1", "2", "three", "4", "none")),
    ("is the", "yes/no", "is the {} on the left ?", ("yes", "no")),
)


def write_eval_data(folder: Path, n_val: int,
                    n_train: int = EVAL_TRAIN_QUESTIONS,
                    width: int = PREFIX_SIZE) -> dict:
    """Synthetic VQA2 artifacts in the file formats of
    tests/test_e2e.py::write_vqa_fixtures, at the shipped config's widths:
    n_val val questions on n_val images, n_train train questions,
    ``width``-wide CLIP embeddings of every image (768 for VC-T0's config,
    512 for ClipCap's) and RICES lists of EVAL_RICES train examples, best
    last. Ten answers a question, seven of them the majority's."""
    rng = np.random.default_rng(SEED)
    data = folder / "data"
    data.mkdir(parents=True, exist_ok=True)
    files, splits = {}, {}
    for name, n, qid_base in (("train2014", n_train, 1000000),
                              ("val2014", n_val, 2000000)):
        questions, annotations = [], []
        for i in range(n):
            img_id, qid = qid_base // 1000 + i, qid_base + i
            qtype, atype, text, pool = EVAL_TYPES[i % len(EVAL_TYPES)]
            obj = EVAL_OBJECTS[int(rng.integers(len(EVAL_OBJECTS)))]
            major = pool[int(rng.integers(len(pool)))]
            answers = [major] * 7 + [pool[int(k)] for k in
                                     rng.integers(0, len(pool), 3)]
            questions.append({"question_id": qid, "image_id": img_id,
                              "question": text.format(obj)})
            annotations.append({
                "question_id": qid, "image_id": img_id,
                "question_type": qtype, "answer_type": atype,
                "multiple_choice_answer": major,
                "answers": [{"answer": a, "answer_confidence": "yes",
                             "answer_id": k + 1}
                            for k, a in enumerate(answers)]})
        meta = {"info": {}, "task_type": "Open-Ended",
                "data_type": "mscoco", "data_subtype": name, "license": {}}
        for kind, rows in (("questions", questions),
                           ("annotations", annotations)):
            path = data / f"{name}_{kind}.json"
            path.write_text(json.dumps({**meta, kind: rows}))
            files[f"{name}_{kind}"] = str(path)
        splits[name] = (questions, annotations)
    train_q, train_a = splits["train2014"]
    embeddings = {
        str(q["image_id"]):
            rng.standard_normal((1, width)).astype(np.float32)
        for q in train_q + splits["val2014"][0]}
    rices = {
        str(q["question_id"]): [
            {"question_id": train_q[j]["question_id"],
             "img_key": train_q[j]["image_id"],
             "question": train_q[j]["question"],
             "gold_answer": train_a[j]["multiple_choice_answer"]}
            for j in rng.choice(len(train_q), EVAL_RICES, replace=False)]
        for q in splits["val2014"][0]}
    for name, obj in (("embeddings", embeddings), ("rices", rices)):
        path = data / f"{name}.pkl"
        path.write_bytes(pickle.dumps(obj))
        files[name] = str(path)
    return files


def eval_argv(folder: Path, files: dict, *opts, flags=()) -> list:
    """The port's CLI on the shipped config, pointed at ``files``: test
    mode, NUM_SHOTS shots, SimpleTokenizer (the card's machine has no
    transformers), random weights from the config's seed; ``flags`` are
    more of the CLI's flags (the eval modes'), ``opts`` more --opts."""
    vqa = {"question_files": {"train": files["train2014_questions"],
                              "val": files["val2014_questions"]},
           "annotation_files": {"train": files["train2014_annotations"],
                                "val": files["val2014_annotations"]}}
    modules = "data_loader.dataset_modules.module_dict."
    return [
        str(CONFIG_FILE), "--mode", "test", "--experiment_name", "eval",
        "--num_shots", str(NUM_SHOTS),
        "--in_context_examples_fpath", files["rices"],
        "--disable_wandb", "--disable_tensorboard", *flags, "--opts",
        f"EXPERIMENT_FOLDER={folder}/experiments",
        f"TENSORBOARD_FOLDER={folder}/tb",
        f"cache.default_folder={folder}/cache",
        "model_config.TokenizerClass=SimpleTokenizer",
        "model_config.pretrained=0",
        f"{modules}LoadVQA2Data.config.vqa_data_path={vqa!r}",
        f"{modules}LoadVQA2Data.config.image_data_path="
        f"{ {'train': str(folder), 'val': str(folder)}!r}",
        f"{modules}LoadClipEmbeddings.config="
        f"{ {'train': files['embeddings'], 'val': files['embeddings']}!r}",
        *opts]


class EvalTimer:
    """Times each call of the functions in ``timed`` during one main.run
    by the host clock to a synchronize, keeps each generate call's tokens,
    and sums the garbage collector's time inside test(). Installed for the
    run and taken off after."""

    def __init__(self, timed=((VCT0Model, "generate"),
                              (VCT0Model, "calibrate_and_quantize_int8"),
                              (FewShotVQAExecutor, "_collect_generative"),
                              (FewShotVQAExecutor, "evaluate_outputs"),
                              (BaseExecutor, "test"))):
        self.timed = timed
        self.seconds = {name: [] for _, name in self.timed}
        self.tokens, self.gc_s, self.in_test = [], 0.0, False

    def wrap(self, name: str, original):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            outer, self.in_test = self.in_test, self.in_test or name == "test"
            t0 = time.perf_counter()
            out = original(*args, **kwargs)
            torch.cuda.synchronize()
            self.seconds[name].append(time.perf_counter() - t0)
            self.in_test = outer
            if name == "generate":
                self.tokens.append(out[0])
            return out
        return timed

    def collecting(self, phase: str, info: dict) -> None:
        if phase == "start":
            self.gc_t0 = time.perf_counter()
        elif self.in_test:
            self.gc_s += time.perf_counter() - self.gc_t0

    def __enter__(self):
        self.originals = [(owner, name, getattr(owner, name))
                          for owner, name in self.timed]
        for owner, name, original in self.originals:
            setattr(owner, name, self.wrap(name, original))
        gc.callbacks.append(self.collecting)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self.collecting)
        for owner, name, original in self.originals:
            setattr(owner, name, original)


def eval_batch_inputs(batch, dev: torch.device) -> dict:
    return dict(prefix=torch.as_tensor(batch.clip_embeddings, device=dev),
                question_tokens=torch.as_tensor(batch.generative_input_ids,
                                                device=dev),
                question_mask=torch.as_tensor(
                    batch.generative_attention_mask, device=dev))


def run_eval(phase: str, folder: Path, files: dict, n_val: int,
             *opts, flags=(), calls_per_batch: int = 1) -> dict:
    """main.run on ``files`` with ``opts`` and ``flags``: a mapper
    checkpoint written first with the port's save_checkpoint (random,
    seeded), every kernel count set to 0 just before the run and read just
    after; then the checks every eval run must pass (``calls_per_batch``
    generate calls a batch: an ensemble's member calls)."""
    argv = eval_argv(folder, files, *opts, flags=flags)
    config = process_config(parse_args_sys(argv))
    lm_cfg = model_factory.T5_CONFIGS[config.model_config.ConfigClass]()
    mapper_cfg = VCT0Config.from_model_args(
        dict(config.model_config.model_args), lm_cfg=lm_cfg).mapper
    mapper = init_mapper(torch.Generator().manual_seed(SEED), mapper_cfg)
    save_checkpoint(config.saved_model_path, 0, {"mapper": mapper})
    del mapper
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in PATH_KERNELS:
        fn.launches = 0
    t0 = time.perf_counter()
    with EvalTimer() as timer:
        executor, metrics = eval_main.run(argv)
    run_s = time.perf_counter() - t0
    counts = {fn.__name__: fn.launches for fn in PATH_KERNELS}
    peak = torch.cuda.max_memory_allocated()
    check(executor.model.device.type == "cuda",
          f"{phase}: the executor's model is on {executor.model.device}")
    results = Path(config.results_path) / "answers.pkl"
    predictions = pickle.loads(results.read_bytes())
    qids = [p["question_id"] for p in predictions]
    want_qids = [2000000 + i for i in range(n_val)]
    check(sorted(qids) == want_qids,
          f"{phase}: answers.pkl holds {len(qids)} predictions, not one for "
          f"each of the {n_val} questions")
    key = "test_evaluation/accuracy_overall"
    check(key in metrics, f"{phase}: {key} missing: the VQA scoring failed "
          "(its error is in the log)")
    batches = len(executor.test_dataloader)
    calls = len(timer.seconds["generate"])
    check(calls == batches * calls_per_batch,
          f"{phase}: {calls} generate calls for {batches} batches")
    seconds = {name: sum(s) for name, s in timer.seconds.items()}
    test_s, generate_s = seconds["test"], seconds["generate"]
    # test() less generate: the calibration, the collects (tokens to the
    # host, detokenize), the scoring, and the rest (waits on the collate
    # thread, moves to the card)
    host = {"calibrate_s": seconds["calibrate_and_quantize_int8"],
            "collect_s": seconds["_collect_generative"],
            "score_s": seconds["evaluate_outputs"]}
    host["rest_s"] = (test_s - generate_s - host["calibrate_s"]
                      - host["collect_s"] - host["score_s"])
    return dict(executor=executor, metrics=metrics, predictions=predictions,
                tokens=timer.tokens, launches=counts, config=config,
                stats=dict(
                    questions=n_val, batches=batches, run_s=run_s,
                    test_s=test_s, questions_per_s=n_val / test_s,
                    generate_s_per_batch=timer.seconds["generate"],
                    generate_s=generate_s,
                    host_share=1 - generate_s / test_s,
                    host_split_s=host, gc_in_test_s=timer.gc_s,
                    peak_mem_gb=peak / 1e9,
                    accuracy_overall=metrics[key]))


def check_direct_generate(phase: str, run: dict, model=None,
                          **kwargs) -> None:
    """The run's batches collated again (on one thread, as with
    SimpleTokenizer the run collated them, so the ids are the run's)
    through ``model.generate(**kwargs)`` directly: the run's tokens, and
    its answers.pkl decoded from them."""
    executor = run["executor"]
    model = model or executor.model
    dev = model.device
    max_new = int(run["config"].data_loader.additional.max_target_length)
    answers = {p["question_id"]: p["answer"] for p in run["predictions"]}
    for i, batch in enumerate(executor.test_dataloader):
        tokens, _ = model.generate(**eval_batch_inputs(batch, dev),
                                   max_new_tokens=max_new, **kwargs)
        check(torch.equal(tokens, run["tokens"][i]),
              f"{phase}: batch {i}'s tokens differ from direct generate's")
        rows = tokens.cpu().numpy()
        for row, qid, valid in zip(rows, batch.question_ids,
                                   batch.sample_valid):
            if valid:
                check(answers[qid] == executor.decoder_tokenizer.decode(
                    row.tolist(), skip_special_tokens=True),
                    f"{phase}: question {qid}'s answer is not its tokens'")


def t5_kernel_launches_traced(argv: list, batch, folder: Path,
                              layers: int) -> list:
    """t5_attention_core's CUDA kernel counted in torch.profiler traces of
    one generate (one encode) on ``batch``, by the model that ``argv``'s
    config builds, in a process of its own: late in a whole run of this
    script a trace can come back with no CUDA record at all (see
    cuda_kernel_names), and a fresh process traces whole. The child
    (``--trace-t5-encode``) names the kernel from a trace of the wrapper
    alone, then takes up to 3 traces of the call; a trace can drop records
    but not add them, so one that holds fewer than ``layers`` is taken
    again, and the last must hold exactly ``layers``."""
    (folder / "argv.json").write_text(json.dumps(argv))
    np.savez(folder / "inputs.npz", prefix=batch.clip_embeddings,
             question_tokens=batch.generative_input_ids,
             question_mask=batch.generative_attention_mask)
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--trace-t5-encode",
         str(folder), str(layers)],
        capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, "the t5_attention_core trace failed:\n"
          + proc.stderr[-3000:])
    traced = json.loads(proc.stdout.strip().splitlines()[-1])
    check(len(traced["names"]) == 1,
          f"t5_attention_core traced as {traced['names']}")
    counts = traced["counts"]
    check(counts[-1] == layers,
          f"t5_attention_core: {counts} launches traced in one encode, not "
          f"{layers}")
    return counts


def trace_t5_encode(folder: Path, layers: int) -> None:
    """The child of t5_kernel_launches_traced: prints the kernel's traced
    names and the count of each trace of one encode."""
    argv = json.loads((folder / "argv.json").read_text())
    model, _ = build_model_from_config(process_config(parse_args_sys(argv)))
    dev = model.device
    cfg = model.cfg.lm
    width = cfg.num_heads * cfg.d_kv
    q = torch.randn(1, 64, width, device=dev, dtype=torch.bfloat16)
    bias = torch.zeros(cfg.num_heads, 64, 64, device=dev)
    tiles = t5_bias_tiles(bias)
    mask = torch.ones(1, 64, dtype=torch.int32, device=dev)
    names = [name for name in cuda_kernel_names(lambda: t5_attention_core(
        q, q, q, bias, mask, cfg.num_heads, bias_tiles=tiles))
        if "attention" in name]
    counts = []
    if len(names) != 1:
        print(json.dumps({"names": names, "counts": counts}), flush=True)
        return
    inputs = {key: torch.as_tensor(value, device=dev)
              for key, value in np.load(folder / "inputs.npz").items()}
    model.generate(**inputs, max_new_tokens=1)
    for _ in range(3):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA]) as prof:
            model.generate(**inputs, max_new_tokens=1)
            torch.cuda.synchronize()
        counts.append(sum(1 for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA
                          and e.name == names[0]))
        if counts[-1] >= layers:
            break
    print(json.dumps({"names": names, "counts": counts}), flush=True)


def check_scoring(phase: str, run: dict) -> dict:
    """The run's accuracy scored again from its answers.pkl, and
    predictions that are right for every other question scoring above 0."""
    helper = run["executor"].data_loader.data.vqa_data.vqa_helpers["val"]
    lookup = run["executor"].data_loader.data.vqa_data.lookup
    half_right = [{"question_id": p["question_id"],
                   "answer": lookup[str(p["question_id"])].gold_answer
                   if i % 2 else "no"}
                  for i, p in enumerate(run["predictions"])]
    accuracy = {}
    for name, predictions in (("run", run["predictions"]),
                              ("half_right", half_right)):
        ev = VQAEval(helper, helper.load_res_from_list(predictions), n=2)
        ev.evaluate()
        accuracy[name] = ev.accuracy["overall"]
    check(accuracy["run"]
          == run["metrics"]["test_evaluation/accuracy_overall"],
          f"{phase}: the run's accuracy is not its answers.pkl's")
    check(accuracy["half_right"] > 0, f"{phase}: half-right predictions "
          "scored 0")
    return accuracy


def phase_config_eval(smi: str) -> dict:
    """The port's CLI (main.run --mode test) on the shipped config at full
    width: EVAL_QUESTIONS synthetic val questions, 4 shots, a mapper
    checkpoint; one prediction a question, the metric (scored again),
    direct generate's tokens, t5_attention_core 24 launches an encode
    (counted and traced), the eval's questions/s, generate seconds, host
    share and its split (collects, scoring, the rest; the garbage
    collector's time)."""
    with tempfile.TemporaryDirectory() as tmp:
        folder = Path(tmp)
        files = write_eval_data(folder, EVAL_QUESTIONS)
        run = run_eval("config_eval", folder, files, EVAL_QUESTIONS)
        executor = run["executor"]
        layers = executor.model.cfg.lm.num_encoder_layers
        want = launches(t5_attention_core=layers * run["stats"]["batches"])
        check(run["launches"] == want, f"config_eval: kernels launched "
              f"{run['launches']}, expected {want}")
        check_direct_generate("config_eval", run)
        traced = t5_kernel_launches_traced(
            eval_argv(folder, files), next(iter(executor.test_dataloader)),
            folder, layers)
        scorers = check_scoring("config_eval", run)
        lengths = sorted({int(b.generative_input_ids.shape[1])
                          for b in executor.test_dataloader})
    emit("config_eval", nvidia_smi=smi, launches=run["launches"],
         traced_t5_attention_core_per_encode=traced,
         prompt_buckets=lengths, accuracy=scorers, **run["stats"])
    return dict(launches_per_call=[run["launches"]], **run["stats"])


def phase_config_eval_int8(smi: str) -> dict:
    """The same CLI run on EVAL_INT8_QUESTIONS questions with the int8
    encoder modes calibrated on the first eval batch through the
    executor: rows 2-4 launched 24 times, and the predictions of a direct
    calibrate_and_quantize_int8 plus generate on the same batch."""
    opts = ("tpu.int8_encoder_ffn=true", "tpu.int8_encoder_attn=true",
            "tpu.int8_calibrate_batches=1")
    with tempfile.TemporaryDirectory() as tmp:
        folder = Path(tmp)
        files = write_eval_data(folder, EVAL_INT8_QUESTIONS)
        run = run_eval("config_eval_int8", folder, files,
                       EVAL_INT8_QUESTIONS, *opts)
        executor = run["executor"]
        model = executor.model
        check(model.pending_int8_calibration is None
              and "ln" in model.params["lm"]["encoder"]["ffn_q8"]
              and "ln" in model.params["lm"]["encoder"]["self_attn_q8"],
              "config_eval_int8: the executor did not calibrate")
        layers = model.cfg.lm.num_encoder_layers
        n = layers * run["stats"]["batches"]
        want = launches(t5_attention_core=n, fused_t5_ln_qkv_q8=n,
                        fused_oproj_residual_q8=n, fused_t5_ffn_q8=n)
        check(run["launches"] == want, f"config_eval_int8: kernels launched "
              f"{run['launches']}, expected {want}")
        executor.model = None
        del model
        torch.cuda.empty_cache()
        # the same weights anew (the config's seed, the checkpoint's mapper)
        direct, _ = build_model_from_config(run["config"])
        direct.params["mapper"] = tree_to_device(load_checkpoint(
            os.path.join(run["config"].saved_model_path, "model_00"))[
                "mapper"], direct.device)
        batch = next(iter(executor.test_dataloader))
        inputs = eval_batch_inputs(batch, direct.device)
        direct.calibrate_and_quantize_int8([inputs], alpha=float(
            run["config"].tpu.get("int8_smooth_alpha", 0.5)))
        direct.pending_int8_calibration = None
        check_direct_generate("config_eval_int8", run, model=direct)
        del direct
    emit("config_eval_int8", nvidia_smi=smi, opts=list(opts),
         launches=run["launches"], **run["stats"])
    return dict(launches_per_call=[run["launches"]], **run["stats"])


def phase_config_eval_fp32_int8(smi: str) -> dict:
    """config_eval_int8's run with FP32_OPTS too: fp32 activations (bf16
    params) through the int8 encoder's fp32 forms, t5_attention_core's fp32
    form, fused_decode_attention's. Checks: t5_attention_core and rows 2-4
    24 launches a batch, cross_attention_decode 24 a decode step run, the
    predictions of a direct calibrate_and_quantize_int8 plus generate on
    the same batch, and that batch's fp32 encoder states finite."""
    opts = (*FP32_OPTS, "tpu.int8_encoder_ffn=true",
            "tpu.int8_encoder_attn=true", "tpu.int8_calibrate_batches=1")
    with tempfile.TemporaryDirectory() as tmp:
        folder = Path(tmp)
        files = write_eval_data(folder, EVAL_INT8_QUESTIONS)
        run = run_eval("config_eval_fp32_int8", folder, files,
                       EVAL_INT8_QUESTIONS, *opts)
        executor = run["executor"]
        model = executor.model
        lm_cfg = model.cfg.lm
        check(lm_cfg.dtype == torch.float32 and lm_cfg.int8_encoder_ffn
              and lm_cfg.int8_encoder_attn and lm_cfg.fused_decode_attention,
              "config_eval_fp32_int8: the config is not fp32 with the int8 "
              "encoder")
        check(model.pending_int8_calibration is None
              and "ln" in model.params["lm"]["encoder"]["ffn_q8"]
              and "ln" in model.params["lm"]["encoder"]["self_attn_q8"],
              "config_eval_fp32_int8: the executor did not calibrate")
        ln_dtypes = sorted({str(model.params["lm"]["encoder"][part]["ln"]
                                .dtype) for part in ("ffn_q8",
                                                     "self_attn_q8")})
        layers = lm_cfg.num_encoder_layers
        n = layers * run["stats"]["batches"]
        eos = executor.tokenizer.eos_token_id
        steps = sum(decode_steps_run(t, eos) for t in run["tokens"])
        want = launches(t5_attention_core=n, fused_t5_ln_qkv_q8=n,
                        fused_oproj_residual_q8=n, fused_t5_ffn_q8=n,
                        cross_attention_decode=lm_cfg.num_decoder_layers
                        * steps)
        check(run["launches"] == want, f"config_eval_fp32_int8: kernels "
              f"launched {run['launches']}, expected {want}")
        executor.model = None
        del model
        torch.cuda.empty_cache()
        direct, _ = build_model_from_config(run["config"])
        direct.params["mapper"] = tree_to_device(load_checkpoint(
            os.path.join(run["config"].saved_model_path, "model_00"))[
                "mapper"], direct.device)
        batch = next(iter(executor.test_dataloader))
        inputs = eval_batch_inputs(batch, direct.device)
        direct.calibrate_and_quantize_int8([inputs], alpha=float(
            run["config"].tpu.get("int8_smooth_alpha", 0.5)))
        direct.pending_int8_calibration = None
        check_direct_generate("config_eval_fp32_int8", run, model=direct)
        with torch.inference_mode():
            joint, joint_mask = direct.encoder_calibration_batch(
                inputs["prefix"], inputs["question_tokens"],
                inputs["question_mask"])
            states = t5_lib.t5_encode(direct.params["lm"], direct.cfg.lm,
                                      inputs_embeds=joint,
                                      attention_mask=joint_mask)
        valid = states[joint_mask.bool()]
        check(states.dtype == torch.float32
              and bool(torch.isfinite(valid).all()),
              "config_eval_fp32_int8: encoder states not finite fp32")
        rms = valid.square().mean().sqrt().item()
        del direct, states, valid
    emit("config_eval_fp32_int8", nvidia_smi=smi, opts=list(opts),
         launches=run["launches"], decode_steps=steps,
         calibrated_ln_dtypes=ln_dtypes, encoder_states_rms=rms,
         **run["stats"])
    return dict(launches_per_call=[run["launches"]], **run["stats"])


EVAL_MODES_QUESTIONS = 32          # one batch at test.batch_size
EVAL_PERMUTATIONS = 3


def no_prefix_template_opt() -> str:
    """--opts of the shipped config's input modules with the text-only
    template (--opts addresses no list element, so the whole list)."""
    config = process_config(parse_args_sys([str(CONFIG_FILE)]))
    modules = config.model_config.input_modules.to_dict()["module_list"]
    check(modules and modules[0]["option"] == "hotpotqa",
          f"the shipped config's first input module is {modules[:1]}")
    modules[0]["option"] = "hotpotqa_no_prefix"
    return f"model_config.input_modules.module_list={modules!r}"


def phase_config_eval_modes(smi: str) -> dict:
    """The CLI run of config_eval on EVAL_MODES_QUESTIONS questions in each
    of the paper's other eval modes: no_prefix (the hotpotqa_no_prefix
    template), one-at-a-time, permutations (E = 3) with members_per_call 1
    and 3 (equal predictions), ensemble_one_shots (4 members) and
    num_beams = 3. Each with one prediction a question, the metric equal
    to answers.pkl scored again, t5_attention_core 24 launches a generate
    call, questions/s; no_prefix and beams also against direct generate."""
    per = {
        "no_prefix": ((no_prefix_template_opt(),), ("--no_prefix", "1"), 1,
                      dict(no_prefix=True)),
        "one_at_a_time": ((), (
            "--pass_examples_through_encoder_one_at_a_time", "1"), 1, None),
        "permutations": (("tpu.ensemble_members_per_call=1",), (
            "--num_permutations_of_in_context_examples",
            str(EVAL_PERMUTATIONS)), EVAL_PERMUTATIONS, None),
        "permutations_batched": ((
            f"tpu.ensemble_members_per_call={EVAL_PERMUTATIONS}",), (
            "--num_permutations_of_in_context_examples",
            str(EVAL_PERMUTATIONS)), 1, None),
        "ensemble_one_shots": ((), ("--ensemble_one_shots", "1"),
                               NUM_SHOTS, None),
        "beams": ((f"data_loader.additional.num_beams={BEAMS}",), (), 1,
                  dict(num_beams=BEAMS)),
    }
    results, answers = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        folder = Path(tmp)
        files = write_eval_data(folder, EVAL_MODES_QUESTIONS)
        for mode, (opts, flags, calls, direct) in per.items():
            run = run_eval(f"config_eval_{mode}", folder, files,
                           EVAL_MODES_QUESTIONS, *opts, flags=flags,
                           calls_per_batch=calls)
            executor = run["executor"]
            layers = executor.model.cfg.lm.num_encoder_layers
            want = launches(t5_attention_core=layers * calls
                            * run["stats"]["batches"])
            check(run["launches"] == want, f"config_eval_{mode}: kernels "
                  f"launched {run['launches']}, expected {want}")
            if direct is not None:
                check_direct_generate(f"config_eval_{mode}", run, **direct)
            check_scoring(f"config_eval_{mode}", run)
            answers[mode] = sorted((p["question_id"], p["answer"])
                                   for p in run["predictions"])
            results[mode] = dict(launches_per_call=[run["launches"]],
                                 **run["stats"])
            emit(f"config_eval_{mode}", nvidia_smi=smi, opts=list(opts),
                 flags=list(flags), launches=run["launches"],
                 generate_calls_per_batch=calls, **run["stats"])
            del run, executor
            gc.collect()
            torch.cuda.empty_cache()
    check(answers["permutations_batched"] == answers["permutations"],
          "config_eval_modes: members_per_call 3 predicted other answers "
          "than the per-member loop")
    emit("config_eval_modes", modes=list(per),
         batched_permutations_equal_looped=True)
    return results


def phase_vit_kernels(gen: torch.Generator) -> dict:
    """The three split3 kernels against their plain versions at ViT-L
    widths on VIT_CHECK_BATCH images and on CLIP_BATCH images, the main
    path's shape, then timed at CLIP_BATCH images."""
    cfg = clip_lib.CLIPVisionConfig.vit_l_14_336()
    seq, width, heads = cfg.seq_len, cfg.width, cfg.num_heads
    d_ff = cfg.mlp_ratio * width
    dev = gen.device

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev).mul_(scale) \
            .bfloat16()

    x = randn(CLIP_BATCH, seq, width)
    ln_s, ln_b = 1 + randn(width, scale=0.1), randn(width, scale=0.1)
    w = [randn(width, width, scale=width ** -0.5) for _ in range(4)]
    b = [randn(width, scale=0.1) for _ in range(4)]
    w_fc, b_fc = randn(width, d_ff, scale=width ** -0.5), randn(d_ff, scale=0.1)
    w_pr, b_pr = randn(d_ff, width, scale=d_ff ** -0.5), randn(width, scale=0.1)
    q, k, v = (randn(CLIP_BATCH, seq, width, scale=s) for s in (0.5, 2.0, 1.0))
    rows = CLIP_BATCH * seq
    act = rows * width * 2                 # one bf16 (M, D) activation
    f = torch.nn.functional

    # yardsticks only: PyTorch calls computing the same functions (layer
    # norm and cuBLAS matmuls over the concatenated QKV; scaled dot-product
    # attention, the out-projection and the residual; layer norm, two
    # matmuls and quickGELU); times, not value checks
    w_qkv, b_qkv = torch.cat(w[:3], dim=1), torch.cat(b[:3])

    def lib_qkv(n):
        h = f.layer_norm(x[:n], (width,), ln_s, ln_b, cfg.layer_norm_epsilon)
        return torch.addmm(b_qkv, h.view(-1, width), w_qkv)

    def lib_oproj(n):
        q4, k4, v4 = (t[:n].view(n, seq, heads, -1).transpose(1, 2)
                      for t in (q, k, v))
        o = f.scaled_dot_product_attention(q4, k4, v4, scale=1.0)
        o = o.transpose(1, 2).reshape(-1, width)
        return x[:n].view(-1, width) + torch.addmm(b[3], o, w[3])

    def lib_mlp(n):
        h = f.layer_norm(x[:n], (width,), ln_s, ln_b, cfg.layer_norm_epsilon)
        z = torch.addmm(b_fc, h.view(-1, width), w_fc)
        return x[:n].view(-1, width) + torch.addmm(
            b_pr, z * torch.sigmoid(1.702 * z), w_pr)

    cases = {
        "fused_ln_qkv": dict(
            fn=fused_ln_qkv, plain=fused_ln_qkv_plain, library=lib_qkv,
            args=lambda n: (x[:n], ln_s, ln_b, w[0], b[0], w[1], b[1], w[2],
                            b[2], (width // heads) ** -0.5),
            bytes=4 * act + 3 * width * width * 2 + 5 * width * 2,
            ops=2 * rows * width * 3 * width),
        "attention_core_oproj": dict(
            fn=attention_core_oproj, plain=attention_core_oproj_plain,
            library=lib_oproj,
            args=lambda n: (x[:n], q[:n], k[:n], v[:n], w[3], b[3], heads),
            bytes=5 * act + width * width * 2 + width * 2,
            ops=4 * CLIP_BATCH * seq * seq * width + 2 * rows * width * width),
        "fused_mlp_block": dict(
            fn=fused_mlp_block, plain=fused_mlp_block_plain, library=lib_mlp,
            args=lambda n: (x[:n], ln_s, ln_b, w_fc, b_fc, w_pr, b_pr),
            bytes=2 * act + 2 * width * d_ff * 2 + (3 * width + d_ff) * 2,
            ops=4 * rows * width * d_ff),
    }
    results = {}
    for name, case in cases.items():
        fn, plain = case["fn"], case["plain"]
        small, full = case["args"](VIT_CHECK_BATCH), case["args"](CLIP_BATCH)
        # B=16 covers a ragged last row tile; B=256 is the main path's shape
        ragged = check_against_plain(name, fn, plain, small,
                                     VIT_CHECK_BATCH)
        main = check_against_plain(name, fn, plain, full, CLIP_BATCH)
        kernel_ms = cuda_ms(lambda: fn(*full), iters=10)
        plain_ms = cuda_ms(lambda: plain(*full), iters=2, warmup=1)
        library_ms = cuda_ms(lambda: case["library"](CLIP_BATCH), iters=10)
        extra = {}
        if name == "fused_ln_qkv":
            # its LayerNorm and its GEMM by CUDA kernel; the GEMM beside
            # cuBLAS addmm of the same (M, D) . (D, 3 D) product alone
            h = f.layer_norm(x, (width,), ln_s, ln_b,
                             cfg.layer_norm_epsilon).view(-1, width)
            addmm_ms = cuda_ms(lambda: torch.addmm(b_qkv, h, w_qkv),
                               iters=10)
            del h
            split = kernel_split(lambda: fn(*full))
            extra = dict(layer_norm_ms=split["layer_norm_0"],
                         **bf16_gemm_stage(name, split, [addmm_ms]))
        if name == "fused_mlp_block":
            # its LayerNorm and two GEMMs by CUDA kernel, beside two cuBLAS
            # addmm of the same products (up (M, D) . (D, F), down (M, F)
            # . (F, D))
            h = f.layer_norm(x, (width,), ln_s, ln_b,
                             cfg.layer_norm_epsilon).view(-1, width)
            hid = torch.addmm(b_fc, h, w_fc)
            cublas_ms = [cuda_ms(lambda: torch.addmm(b_fc, h, w_fc), iters=10),
                         cuda_ms(lambda: torch.addmm(b_pr, hid, w_pr),
                                 iters=10)]
            del h, hid
            split = kernel_split(lambda: fn(*full))
            extra = dict(layer_norm_ms=split["layer_norm_0"],
                         **bf16_gemm_stage(name, split, cublas_ms))
        if name == "attention_core_oproj":
            # the attention stage alone (the same kernel, attention_core's
            # bf16_sum order) splits the time into attention and GEMM
            attention_ms = cuda_ms(lambda: attention_core(q, k, v, heads),
                                   iters=10)
            # the share of outputs off plain: the attention stage's is held
            # to ATTENTION_MAX_DIFFERING; the whole function's also counts
            # the out-projection GEMM's sum order, and is recorded
            stage = check_against_plain(
                "attention_core_oproj's attention", attention_core,
                attention_core_plain, (q, k, v, heads), CLIP_BATCH)
            extra = dict(
                attention_ms=attention_ms, gemm_ms=kernel_ms - attention_ms,
                differing_share=main["differing"] / main["elements"],
                attention_differing_share=check_few_differ(
                    "attention_core_oproj's attention", stage),
                **attention_route_bound(CLIP_BATCH, seq, width, heads,
                                        case["bytes"],
                                        2 * rows * width * width))
        torch.cuda.empty_cache()
        results[name] = dict(
            shape=dict(B=CLIP_BATCH, L=seq, D=width, H=heads, F=d_ff),
            **main, **{f"b{VIT_CHECK_BATCH}_{key}": val
                       for key, val in ragged.items()},
            ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
            **bound(case["bytes"], case["ops"], BF16_FLOP_PER_S), **extra)
        emit("vit_kernels", kernel=name, kernel_ms=kernel_ms, **{
            key: val for key, val in results[name].items() if key != "ms"})
    return results


def int_mm_call(weights, rows: int, gen: torch.Generator):
    """Yardstick only: a call of torch._int_mm over each int8 (K, N) weight
    of ``weights`` with random (rows, K) codes, GEMMs alone, the weights
    column-major as cuBLASLt's int8 GEMM takes them (made before the
    timing)."""
    pairs = [(torch.randint(-127, 128, (rows, w.shape[0]), generator=gen,
                            device=gen.device, dtype=torch.int8),
              w.t().contiguous().t()) for w in weights]
    return lambda: [torch._int_mm(a, w) for a, w in pairs]


def phase_vit_q8_kernels(gen: torch.Generator) -> dict:
    """The int8 path's kernels against their plain versions at ViT-L widths
    on VIT_CHECK_BATCH and on CLIP_BATCH images, the main path's shape,
    with one layer's weights from the port's quantize_vision_blocks, then
    timed at CLIP_BATCH images; then the int8 kernels' fp32 forms
    (vit_q8_form), on the same weights for rows 13 and 14."""
    cfg = clip_lib.CLIPVisionConfig.vit_l_14_336()
    seq, width, heads = cfg.seq_len, cfg.width, cfg.num_heads
    d_ff = cfg.mlp_ratio * width
    dev = gen.device

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev).mul_(scale) \
            .bfloat16()

    shapes = {"q": (width, width), "k": (width, width), "v": (width, width),
              "o": (width, width), "mlp_fc": (width, d_ff),
              "mlp_proj": (d_ff, width)}
    blocks = {name: randn(1, *shape, scale=shape[0] ** -0.5)
              for name, shape in shapes.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    q8 = clip_lib.quantize_vision_blocks({"blocks": blocks})
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    on_cpu = clip_lib.quantize_vision_blocks(
        {"blocks": {name: w.cpu() for name, w in blocks.items()}})
    check(all(torch.equal(q8[key].cpu(), on_cpu[key]) for key in q8),
          "quantize_vision_blocks gives other codes or scales on the card "
          "than on the CPU")
    w_qkv, s_qkv = q8["qkv"][0], q8["qkv_scale"][0]
    w_fc, s_fc = q8["mlp_fc"][0], q8["mlp_fc_scale"][0]
    w_pr, s_pr = q8["mlp_proj"][0], q8["mlp_proj_scale"][0]
    x = randn(CLIP_BATCH, seq, width)
    ln_s, ln_b = 1 + randn(width, scale=0.1), randn(width, scale=0.1)
    b_qkv, b_fc, b_pr = (randn(n, scale=0.1) for n in (3 * width, d_ff, width))
    q, k, v = (randn(CLIP_BATCH, seq, width, scale=s) for s in (0.5, 2.0, 1.0))
    rows = CLIP_BATCH * seq
    scale = (width // heads) ** -0.5

    # the per-GEMM yardsticks draw their codes from a generator of their
    # own, so that the later phases' inputs do not depend on them
    stage_gen = torch.Generator(device=dev).manual_seed(SEED)
    # and so do the fp32 forms' inputs: fp32 x, LayerNorm parameters and
    # biases that no bf16 holds, on the same int8 weights
    f32_gen = torch.Generator(device=dev).manual_seed(SEED + 5)

    def randn32(*shape, scale=1.0):
        return torch.randn(shape, generator=f32_gen, device=dev).mul_(scale)

    x32 = randn32(CLIP_BATCH, seq, width)
    ln_s32, ln_b32 = 1 + randn32(width, scale=0.1), randn32(width, scale=0.1)
    b_qkv32, b_fc32, b_pr32 = (randn32(n, scale=0.1)
                               for n in (3 * width, d_ff, width))

    def sdpa(g=None):
        # yardstick only: on contiguous (B, H, L, dh) copies of q, k, v
        q4, k4, v4 = (t.view(CLIP_BATCH, seq, heads, -1).transpose(1, 2)
                      .contiguous() for t in (q, k, v))
        return lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, scale=1.0)

    attention = dict(
        int8=False, args=lambda n: (q[:n], k[:n], v[:n], heads),
        library=sdpa, library_name="scaled_dot_product_attention, "
                                   "contiguous (B, H, L, dh) inputs",
        bytes=lambda xs=2, ps=2: 4 * rows * width * xs,
        parts=[(4 * CLIP_BATCH * seq * seq * width, BF16_FLOP_PER_S)])
    int_mm_name = "torch._int_mm, GEMMs only, column-major weights"
    # each int8 kernel's bytes with x and its outputs of xs bytes an
    # element, its LayerNorm parameters and biases of ps
    cases = {
        "fused_qkv_q8": dict(
            fn=fused_qkv_q8, plain=fused_qkv_q8_plain, int8=True,
            args=lambda n: (x[:n], ln_s, ln_b, w_qkv, s_qkv, b_qkv, scale),
            forms=lambda d, n: (x32[:n].to(d[0]), ln_s32.to(d[1]),
                                ln_b32.to(d[1]), w_qkv, s_qkv,
                                b_qkv32.to(d[1]), scale),
            batch=CLIP_BATCH, gemms=[w_qkv],
            library=lambda g=gen: int_mm_call([w_qkv], rows, g),
            library_name=int_mm_name,
            bytes=lambda xs=2, ps=2: 4 * rows * width * xs + w_qkv.numel()
            + 3 * width * (4 + ps) + 2 * width * ps,
            parts=[(2 * rows * width * 3 * width, INT8_OP_PER_S)]),
        "attention_core": dict(
            fn=attention_core, plain=attention_core_plain, **attention),
        "attention_core_fast_exp": dict(
            fn=lambda *a: attention_core(*a, fast_exp=True),
            plain=lambda *a: attention_core_plain(*a, fast_exp=True),
            **attention),
        "fused_mlp_block_q8": dict(
            fn=fused_mlp_block_q8, plain=fused_mlp_block_q8_plain, int8=True,
            args=lambda n: (x[:n], ln_s, ln_b, w_fc, s_fc, b_fc, w_pr, s_pr,
                            b_pr),
            forms=lambda d, n: (x32[:n].to(d[0]), ln_s32.to(d[1]),
                                ln_b32.to(d[1]), w_fc, s_fc, b_fc32.to(d[1]),
                                w_pr, s_pr, b_pr32.to(d[1])),
            batch=CLIP_BATCH, gemms=[w_fc, w_pr],
            library=lambda g=gen: int_mm_call([w_fc, w_pr], rows, g),
            library_name=int_mm_name,
            bytes=lambda xs=2, ps=2: 2 * rows * width * xs + w_fc.numel()
            + w_pr.numel() + (d_ff + width) * (4 + ps) + 2 * width * ps,
            parts=[(2 * 2 * rows * width * d_ff, INT8_OP_PER_S)]),
    }

    results = {}
    for name, case in cases.items():
        # B=16 covers a ragged last row tile; B=256 is the main path's shape
        full = case["args"](CLIP_BATCH)
        ragged, main = (check_against_plain(
            name, case["fn"], case["plain"], case["args"](batch), batch,
            case["int8"], flip_bound=vit_fast_exp_flip_bound(
                q[:batch], k[:batch], v[:batch], heads, dot_units=3)
            if name.endswith("fast_exp") else None)
            for batch in (VIT_CHECK_BATCH, CLIP_BATCH))
        torch.cuda.empty_cache()
        if case["int8"]:
            q8_boundary(name, case["fn"], case["plain"],
                        case["args"](VIT_CHECK_BATCH))
        kernel_ms = cuda_ms(lambda: case["fn"](*full), iters=10)
        plain_ms = cuda_ms(lambda: case["plain"](*full), iters=2, warmup=1)
        library_ms = cuda_ms(case["library"](), iters=10)
        extra = {}
        if name.startswith("attention_core"):
            extra = dict(differing_share=check_few_differ(name, main),
                         **attention_route_bound(CLIP_BATCH, seq, width,
                                                 heads, case["bytes"]()))
        if case["int8"]:
            int_mm_ms = [cuda_ms(int_mm_call([w], rows, stage_gen), iters=10)
                         for w in case["gemms"]]
            extra = gemm_stage(name, kernel_split(lambda: case["fn"](*full)),
                               int_mm_ms)
        if name == "fused_mlp_block_q8":
            # this route: the fp32 hidden and its int8 codes each written
            # and read once more
            route = bound_mixed(case["bytes"]() + 2 * rows * d_ff * (4 + 1),
                                case["parts"])
            extra.update(route_bound_ms=route["bound_ms"],
                         route_bound_by=route["bound_by"],
                         route_ops=route["ops"])
        torch.cuda.empty_cache()
        results[name] = dict(
            shape=dict(B=CLIP_BATCH, L=seq, D=width, H=heads, F=d_ff),
            **main, **{f"b{VIT_CHECK_BATCH}_{key}": val
                       for key, val in ragged.items()},
            ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
            library=case["library_name"],
            **bound_mixed(case["bytes"](), case["parts"]), **extra)
        emit("vit_q8_kernels", kernel=name, kernel_ms=kernel_ms,
             quantize_layer_s=quantize_s, **{
                 key: val for key, val in results[name].items()
                 if key != "ms"})
    del x, q, k, v, full
    torch.cuda.empty_cache()
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on: the plain versions must multiply in fp32")
    for name, case in (("fused_qkv_q8", cases["fused_qkv_q8"]),
                       ("fused_mlp_block_q8", cases["fused_mlp_block_q8"]),
                       ("fused_vit_block_q8", vit_q8_block_case(f32_gen))):
        for form, dtypes in Q8_F32_FORMS.items():
            row = vit_q8_form(name, case, form, dtypes, f32_gen)
            if form == "f32":
                results[name + "_f32"] = row
            torch.cuda.empty_cache()
    del x32
    torch.cuda.empty_cache()
    return results


def vit_q8_block_case(gen: torch.Generator) -> dict:
    """fused_vit_block_q8's case for vit_q8_form: ViT-B/32 widths on
    B32_BATCH images, one layer of the tower's init in fp32 with LayerNorm
    parameters and biases that no bf16 holds, the weights from
    quantize_vision_blocks."""
    cfg = clip_lib.CLIPVisionConfig.vit_b_32(num_layers=1)
    seq, width, heads = cfg.seq_len, cfg.width, cfg.num_heads
    d_ff = cfg.mlp_ratio * width
    dev = gen.device
    layer = {name: leaf[0] for name, leaf in clip_lib.init_clip_vision_params(
        gen, cfg, torch.float32)["blocks"].items()}
    for name, leaf in layer.items():
        if name.endswith(("bias", "scale")):
            base = 1.0 if name.endswith("scale") else 0.0
            layer[name] = base + 0.1 * torch.randn(leaf.shape, generator=gen,
                                                   device=dev)
    q8 = {name: leaf[0] for name, leaf in clip_lib.quantize_vision_blocks(
        {"blocks": {n: layer[n][None] for n in (
            "q", "k", "v", "o", "mlp_fc", "mlp_proj")}}).items()}
    layer["qkv_bias"] = torch.cat([layer[n + "_bias"] for n in "qkv"])
    x = torch.randn((B32_BATCH, seq, width), generator=gen, device=dev)
    weights = [q8[n] for n in ("qkv", "o", "mlp_fc", "mlp_proj")]
    rows = B32_BATCH * seq

    def forms(dtypes, n):
        p = {name: layer[name].to(dtypes[1]) for name in (
            "ln1_scale", "ln1_bias", "qkv_bias", "o_bias", "ln2_scale",
            "ln2_bias", "mlp_fc_bias", "mlp_proj_bias")}
        return (x[:n].to(dtypes[0]), p["ln1_scale"], p["ln1_bias"],
                q8["qkv"], q8["qkv_scale"], p["qkv_bias"], q8["o"],
                q8["o_scale"], p["o_bias"], p["ln2_scale"], p["ln2_bias"],
                q8["mlp_fc"], q8["mlp_fc_scale"], p["mlp_fc_bias"],
                q8["mlp_proj"], q8["mlp_proj_scale"], p["mlp_proj_bias"],
                heads)

    return dict(
        fn=lambda *a: fused_vit_block_q8(*a, group=4),
        plain=fused_vit_block_q8_plain, forms=forms, batch=B32_BATCH,
        library=lambda g: int_mm_call(weights, rows, g),
        bytes=lambda xs, ps: 2 * rows * width * xs
        + sum(w.numel() for w in weights) + (4 * width + d_ff + width) * 4
        + (9 * width + d_ff) * ps,
        parts=[(2 * rows * sum(w.numel() for w in weights), INT8_OP_PER_S),
               (4 * B32_BATCH * seq * seq * width, BF16_FLOP_PER_S)])


def codes_off_plain(name: str, fn, plain, args) -> dict:
    """How many of an int8 kernel's activation codes (every stage's) differ
    from those of its plain version run on the card on the same ``args``,
    of how many; at most FP32_Q8_CODES_OFF_SHARE of them."""
    codes, plain_codes = {}, {}
    fn(*args, codes_out=codes)
    plain(*args, codes_out=plain_codes)
    keys = [key for key in plain_codes if key.endswith("codes")]
    off = sum(int((codes[key] != plain_codes[key]).sum()) for key in keys)
    total = sum(plain_codes[key].numel() for key in keys)
    check(off <= FP32_Q8_CODES_OFF_SHARE * total,
          f"{name}: {off} of {total} codes off the card's plain version's")
    return dict(codes_off_plain=off, codes=total)


def vit_q8_form(name: str, case: dict, form: str, dtypes,
                gen: torch.Generator) -> dict:
    """One form of an int8 ViT kernel (``dtypes``: x's, the LayerNorms' and
    biases') against its plain version on VIT_CHECK_BATCH images and on
    case["batch"]: bf16 outputs by compare_q8's rule; rows 13 and 14 with
    fp32 x also within FP32_Q8_REL_FROBENIUS, row 12 with fp32 x by
    block_q8_f32_rule; rows 13 and 14 with at most FP32_Q8_CODES_OFF_SHARE
    of their codes off the card's plain version's. Timed by CUDA events in
    turns with the bf16 form on the same values rounded to bf16; the fp32
    form also beside its plain version and torch._int_mm of its GEMMs."""
    what = f"{name} ({form})"
    f32, bf = torch.float32, torch.bfloat16
    fn, plain, batch = case["fn"], case["plain"], case["batch"]
    row = dict(dtypes=[str(t).removeprefix("torch.") for t in dtypes],
               batch=batch)
    for n in (VIT_CHECK_BATCH, batch):
        args = case["forms"](dtypes, n)
        if name == "fused_vit_block_q8":
            res = (block_q8_f32_rule(what, args) if dtypes[0] == f32 else
                   check_against_plain(what, fn, plain, args, n, int8=True))
        else:
            res = check_against_plain(what, fn, plain, args, n, int8=True)
            check(dtypes[0] == bf
                  or res["rel_frobenius"] <= FP32_Q8_REL_FROBENIUS,
                  f"{what} at B={n}: relative Frobenius error "
                  f"{res['rel_frobenius']} > {FP32_Q8_REL_FROBENIUS}")
            res.update(codes_off_plain(f"{what} at B={n}", fn, plain, args))
        row.update({(key if n == batch else f"b{VIT_CHECK_BATCH}_{key}"): val
                    for key, val in res.items()})
        del args
        torch.cuda.empty_cache()
    args, bf16_args = case["forms"](dtypes, batch), case["forms"]((bf, bf),
                                                                  batch)
    out = fn(*args)
    out = out if isinstance(out, tuple) else (out,)
    check(all(o.dtype == dtypes[0] for o in out),
          f"{what}: outputs {[o.dtype for o in out]}")
    del out
    per_call = launched(globals()[name], lambda: fn(*args))
    check(per_call == 1, f"{what}: {per_call} launches a call")
    turns = [cuda_ms(call, iters=10) for call in (
        lambda: fn(*bf16_args), lambda: fn(*args), lambda: fn(*args),
        lambda: fn(*bf16_args))]
    row.update(launches_per_call=per_call, ms=(turns[1] + turns[2]) / 2,
               bf16_form_ms=(turns[0] + turns[3]) / 2,
               turns_ms=dict(bf16_form=turns[0::3], form=turns[1:3]),
               **bound_mixed(case["bytes"](*(4 if t == f32 else 2
                                             for t in dtypes)),
                             case["parts"]))
    if form == "f32":
        row.update(plain_ms=cuda_ms(lambda: plain(*args), iters=2, warmup=1),
                   library_ms=cuda_ms(case["library"](gen), iters=10),
                   library="torch._int_mm, GEMMs only, column-major weights")
    emit("vit_q8_kernels_f32", kernel=name, form=form, kernel_ms=row["ms"],
         **{key: val for key, val in row.items() if key != "ms"})
    return row


def phase_vit_attention_edges(gen: torch.Generator) -> None:
    """attention_core (both orders) and attention_core_oproj against their
    plain versions on EDGE_BATCH images at every EDGE_LENGTHS x
    EDGE_HEAD_DIMS case."""
    dev = gen.device

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev).mul_(scale) \
            .bfloat16()

    cases = {}
    worst = dict(max_abs_err=0.0, differing=0, elements=0)
    for seq in EDGE_LENGTHS:
        for head_dim in EDGE_HEAD_DIMS:
            heads = EDGE_WIDTH // head_dim
            q, k, v, res = (randn(EDGE_BATCH, seq, EDGE_WIDTH, scale=s)
                            for s in (0.5, 2.0, 1.0, 1.0))
            wo = randn(EDGE_WIDTH, EDGE_WIDTH, scale=EDGE_WIDTH ** -0.5)
            bo = randn(EDGE_WIDTH, scale=0.1)
            kernels_here = {
                "attention_core": (attention_core, attention_core_plain,
                                   (q, k, v, heads)),
                "attention_core_fast_exp": (
                    lambda *a: attention_core(*a, fast_exp=True),
                    lambda *a: attention_core_plain(*a, fast_exp=True),
                    (q, k, v, heads)),
                "attention_core_oproj": (
                    attention_core_oproj, attention_core_oproj_plain,
                    (res, q, k, v, wo, bo, heads)),
            }
            for name, (fn, plain, args) in kernels_here.items():
                res_case = check_against_plain(
                    f"{name} L={seq} dh={head_dim}", fn, plain, args,
                    EDGE_BATCH)
                cases[f"{name} L={seq} dh={head_dim}"] = res_case
                worst["max_abs_err"] = max(worst["max_abs_err"],
                                           res_case["max_abs_err"])
                worst["differing"] += res_case["differing"]
                worst["elements"] += res_case["elements"]
    emit("vit_attention_edges", batch=EDGE_BATCH, width=EDGE_WIDTH,
         lengths=EDGE_LENGTHS, head_dims=EDGE_HEAD_DIMS, cases=len(cases),
         **worst, worst_case=max(cases, key=lambda c: cases[c]["max_abs_err"]))


def flat_leaves(tree, prefix: str = ""):
    """(path, tensor) for every leaf of a params tree."""
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from flat_leaves(val, f"{prefix}{key}/")
        else:
            yield prefix + key, val


def phase_t5_quantizers(gen: torch.Generator) -> None:
    """The T5 int8 weight quantizers at T0-3B widths and T5_QUANT_LAYERS
    layers: _quant_stacked_i8 on random stacked weights in 8 groups, and
    quantize_encoder_ffn / _attn and quantize_decoder_step on random
    params, each on the card and on a CPU copy of its input; every code and
    scale must be equal."""
    cfg = t5_lib.T5Config.t0_3b(num_encoder_layers=T5_QUANT_LAYERS,
                                num_decoder_layers=T5_QUANT_LAYERS)
    params = t5_lib.init_t5_params(gen, cfg, torch.bfloat16)

    def cpu_copy(tree):
        return {key: cpu_copy(val) if isinstance(val, dict) else val.cpu()
                for key, val in tree.items()}

    w = torch.randn((T5_QUANT_LAYERS, cfg.d_model, cfg.d_ff), generator=gen,
                    device=gen.device).mul_(cfg.d_model ** -0.5)
    quantized = {"_quant_stacked_i8": (
        dict(zip(("codes", "scales"), t5_lib._quant_stacked_i8(w, 8))),
        dict(zip(("codes", "scales"),
                 t5_lib._quant_stacked_i8(w.cpu(), 8))))}
    on_cpu = cpu_copy(params)
    for quantize in (t5_lib.quantize_encoder_ffn, t5_lib.quantize_encoder_attn,
                     t5_lib.quantize_decoder_step):
        quantized[quantize.__name__] = (quantize(params), quantize(on_cpu))
    leaves = {}
    for name, (card, host) in quantized.items():
        card, host = dict(flat_leaves(card)), dict(flat_leaves(host))
        check(card.keys() == host.keys(), f"{name}: other trees on the card")
        q8 = [key for key in card if "q8" in key or name.startswith("_")]
        differ = [key for key in q8 if not torch.equal(card[key].cpu(),
                                                       host[key])]
        check(not differ, f"{name} gives other codes or scales on the card "
                          f"than on the CPU: {differ}")
        leaves[name] = len(q8)
    emit("t5_quantizers", layers=T5_QUANT_LAYERS, d_model=cfg.d_model,
         d_ff=cfg.d_ff, bit_equal_leaves=leaves)


VIT_BLOCK_KEYS = ("ln1_scale", "ln1_bias", "q", "q_bias", "k", "k_bias", "v",
                  "v_bias", "o", "o_bias", "ln2_scale", "ln2_bias", "mlp_fc",
                  "mlp_fc_bias", "mlp_proj", "mlp_proj_bias")


def phase_vit_short_kernels(gen: torch.Generator) -> dict:
    """The ViT-B/32 whole-block kernels against their plain versions on
    VIT_CHECK_BATCH and on B32_BATCH images (one layer of the tower's
    seeded init weights, random LayerNorm parameters and biases; the int8
    weights from quantize_vision_blocks), then timed at B32_BATCH beside the
    plain version, the bound and a library yardstick."""
    cfg = clip_lib.CLIPVisionConfig.vit_b_32(num_layers=1)
    seq, width, heads = cfg.seq_len, cfg.width, cfg.num_heads
    head_dim, d_ff = width // heads, cfg.mlp_ratio * width
    dev = gen.device
    eps = cfg.layer_norm_epsilon
    layer = {name: leaf[0] for name, leaf in clip_lib.init_clip_vision_params(
        gen, cfg, torch.bfloat16)["blocks"].items()}
    for name, leaf in layer.items():
        if name.endswith(("bias", "scale")):
            base = 1.0 if name.endswith("scale") else 0.0
            layer[name] = (base + 0.1 * torch.randn(
                leaf.shape, generator=gen, device=dev)).bfloat16()
    q8 = {name: leaf[0] for name, leaf in clip_lib.quantize_vision_blocks(
        {"blocks": {n: layer[n][None] for n in (
            "q", "k", "v", "o", "mlp_fc", "mlp_proj")}}).items()}
    b_qkv = torch.cat([layer["q_bias"], layer["k_bias"], layer["v_bias"]])
    w_qkv = torch.cat([layer["q"], layer["k"], layer["v"]], dim=1)
    x = torch.randn((B32_BATCH, seq, width), generator=gen,
                    device=dev).bfloat16()
    block = [layer[n] for n in VIT_BLOCK_KEYS]
    q8_block = (layer["ln1_scale"], layer["ln1_bias"], q8["qkv"],
                q8["qkv_scale"], b_qkv, q8["o"], q8["o_scale"],
                layer["o_bias"], layer["ln2_scale"], layer["ln2_bias"],
                q8["mlp_fc"], q8["mlp_fc_scale"], layer["mlp_fc_bias"],
                q8["mlp_proj"], q8["mlp_proj_scale"], layer["mlp_proj_bias"])
    attn_args = [layer[n] for n in ("q", "q_bias", "k", "k_bias", "v",
                                    "v_bias", "o", "o_bias")]
    rows = B32_BATCH * seq
    act = rows * width * 2                 # one bf16 (M, D) activation
    f = torch.nn.functional

    # yardsticks only: PyTorch calls computing the same functions
    def lib_block():
        # the unfused bf16 block: layer norms, cuBLAS matmuls, SDPA,
        # quickGELU
        x2 = x.view(-1, width)
        h = f.layer_norm(x2, (width,), layer["ln1_scale"], layer["ln1_bias"],
                         eps)
        qkv = torch.addmm(b_qkv, h, w_qkv).view(B32_BATCH, seq, 3, heads,
                                                head_dim)
        o = f.scaled_dot_product_attention(*qkv.permute(2, 0, 3, 1, 4))
        r1 = x2 + torch.addmm(layer["o_bias"],
                              o.transpose(1, 2).reshape(-1, width),
                              layer["o"])
        z = torch.addmm(layer["mlp_fc_bias"], f.layer_norm(
            r1, (width,), layer["ln2_scale"], layer["ln2_bias"], eps),
            layer["mlp_fc"])
        return r1 + torch.addmm(layer["mlp_proj_bias"],
                                z * torch.sigmoid(1.702 * z),
                                layer["mlp_proj"])

    def lib_block_gemms_ms():
        # cuBLAS addmm of the block's four bf16 products (q | k | v over the
        # concatenated weight), each timed alone on random operands
        h, hid = yardstick_operands(dev, rows, width, d_ff)
        products = ((b_qkv, h, w_qkv), (layer["o_bias"], h, layer["o"]),
                    (layer["mlp_fc_bias"], h, layer["mlp_fc"]),
                    (layer["mlp_proj_bias"], hid, layer["mlp_proj"]))
        return [cuda_ms(lambda p=p: torch.addmm(*p), iters=10)
                for p in products]

    q8_weights = [q8[n] for n in ("qkv", "o", "mlp_fc", "mlp_proj")]

    def lib_attention(dtype):
        # matmuls (fp32: TF32 off) and SDPA in dtype, on copies made before
        # the timing
        x_, wqkv, wo, bqkv, bo = (t.to(dtype) for t in (
            x.view(-1, width), w_qkv, layer["o"], b_qkv, layer["o_bias"]))

        def run():
            qkv = torch.addmm(bqkv, x_, wqkv).view(
                B32_BATCH, seq, 3, heads, head_dim)
            o = f.scaled_dot_product_attention(*qkv.permute(2, 0, 3, 1, 4))
            return torch.addmm(bo, o.transpose(1, 2).reshape(-1, width), wo)
        return run

    def lib_attention_gemms_ms(planes):
        # cuBLAS addmm of fused_attention_block's two products, each timed
        # alone on random operands: q | k | v over the concatenated weight,
        # and the out-projection over the three planes and wo stacked three
        # times (fp32 forms) or over the bf16 attention output
        h, a3 = yardstick_operands(dev, rows, width, 3 * width)
        wo = torch.cat([layer["o"]] * 3) if planes else layer["o"]
        products = ((b_qkv, h, w_qkv),
                    (layer["o_bias"], a3 if planes else h, wo))
        return [cuda_ms(lambda p=p: torch.addmm(*p), iters=10)
                for p in products]

    vecs = (4 * width + 4 * width + d_ff + width) * 2   # LNs and biases
    weights = 4 * width * width + 2 * width * d_ff
    attention_flops = 4 * B32_BATCH * seq * seq * width
    block_bytes = 2 * act + weights * 2 + vecs
    block_parts = [(2 * rows * weights + attention_flops, BF16_FLOP_PER_S)]
    cases = {
        f"fused_vit_block{suffix}": dict(
            fn=lambda *a, kw=kw: fused_vit_block(*a, group=4, **kw),
            plain=lambda *a, kw=kw: fused_vit_block_plain(*a, **kw),
            args=lambda n: (x[:n], *block, heads), int8=False,
            library=lambda: lib_block,
            library_name="the unfused bf16 block: layer_norm, addmm, "
                         "scaled_dot_product_attention, quickGELU",
            bytes=block_bytes, parts=block_parts)
        for suffix, kw in (("", {}), ("_deferred_div", {"deferred_div": True}),
                           ("_fast_exp", {"fast_exp": True}))}
    cases["fused_vit_block_q8"] = dict(
        fn=lambda *a: fused_vit_block_q8(*a, group=4),
        plain=fused_vit_block_q8_plain,
        args=lambda n: (x[:n], *q8_block, heads), int8=True,
        library=lambda: int_mm_call(q8_weights, rows, gen),
        library_name="torch._int_mm, GEMMs only, column-major weights",
        bytes=2 * act + weights + (4 * width + d_ff + width) * 4 + vecs,
        parts=[(2 * rows * weights, INT8_OP_PER_S),
               (attention_flops, BF16_FLOP_PER_S)])
    # fused_attention_block in its three forms: block_diag (the tower's),
    # and without it in compute_dtype fp32 (the same function and chain)
    # and bf16
    attention_bytes = 2 * act + 4 * width * width * 2 + 4 * width * 2
    for suffix, kw in (("", {"block_diag": True}),
                       ("_unblocked", {"compute_dtype": torch.float32}),
                       ("_unblocked_bf16", {"compute_dtype": torch.bfloat16})):
        fp32 = kw.get("compute_dtype", torch.float32) == torch.float32
        cases["fused_attention_block" + suffix] = dict(
            fn=lambda *a, kw=kw: fused_attention_block(*a, group=4, **kw),
            plain=lambda *a, kw=kw: fused_attention_block_plain(*a, **kw),
            args=lambda n: (x[:n], *attn_args, heads), int8=False,
            library=lambda fp32=fp32: lib_attention(
                torch.float32 if fp32 else torch.bfloat16),
            library_name=("fp32 addmm (TF32 off) and fp32 "
                          "scaled_dot_product_attention" if fp32 else
                          "bf16 addmm and scaled_dot_product_attention"),
            bytes=attention_bytes,
            # fp32: bf16 q, k, v; fp32 attention on the CUDA cores; the
            # out-projection as three bf16 products over the split fp32
            # input. bf16: four bf16 products and the bf16 attention
            parts=([(2 * rows * 3 * width * width, BF16_FLOP_PER_S),
                    (attention_flops, FP32_FLOP_PER_S),
                    (3 * 2 * rows * width * width, BF16_FLOP_PER_S)] if fp32
                   else [(2 * rows * 4 * width * width + attention_flops,
                          BF16_FLOP_PER_S)]),
            planes=fp32)
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on: the plain versions must multiply in fp32")
    results = {}
    for name, case in cases.items():
        full = case["args"](B32_BATCH)
        ragged, main = (check_against_plain(
            name, case["fn"], case["plain"], case["args"](batch), batch,
            case["int8"]) for batch in (VIT_CHECK_BATCH, B32_BATCH))
        kernel_ms = cuda_ms(lambda: case["fn"](*full), iters=10)
        plain_ms = cuda_ms(lambda: case["plain"](*full), iters=2, warmup=1)
        library_ms = cuda_ms(case["library"](), iters=10)
        stage = {}
        if name == "fused_vit_block":
            # each CUDA kernel's device time; its four GEMMs (q | k | v,
            # out-projection, up, down, all on bf16_gemm_tma.cuh) each
            # beside cuBLAS addmm of the same product
            stage = bf16_gemm_stage(name, kernel_split(
                lambda: case["fn"](*full)), lib_block_gemms_ms())
            stage["gemm_kernels"] = tma_products(
                name, lambda: case["fn"](*full), 4)
        if name.startswith("fused_attention_block"):
            # each CUDA kernel's device time; its two GEMMs (q | k | v, the
            # out-projection, both on bf16_gemm_tma.cuh) each beside cuBLAS
            # addmm of the same product; the fp32 forms within one bf16 ulp
            # of plain (the share of outputs off recorded) and the bytes of
            # their scratch round trips (fp32 q, k, v and the planes, each
            # written and read)
            stage = bf16_gemm_stage(name, kernel_split(
                lambda: case["fn"](*full)),
                lib_attention_gemms_ms(case["planes"]))
            stage["gemm_kernels"] = tma_products(
                name, lambda: case["fn"](*full), 2)
            if case["planes"]:
                ulp = check_within_one_ulp(name, case["fn"](*full),
                                           case["plain"](*full))
                stage["one_ulp_differing_share"] = (ulp["differing"]
                                                    / ulp["elements"])
                scratch = 2 * (3 * rows * width * 4 + rows * 3 * width * 2)
                stage["route_bytes_ms"] = (attention_bytes + scratch) \
                    / HBM_BYTES_PER_S * 1e3
        if name == "fused_vit_block_q8":
            # each CUDA kernel's device time; each GEMM beside _int_mm
            int_mm_ms = [cuda_ms(int_mm_call([w], rows, gen), iters=10)
                         for w in q8_weights]
            stage = gemm_stage(name, kernel_split(lambda: case["fn"](*full)),
                               int_mm_ms)
        torch.cuda.empty_cache()
        results[name] = dict(
            shape=dict(B=B32_BATCH, L=seq, D=width, H=heads, F=d_ff, G=4),
            **main, **{f"b{VIT_CHECK_BATCH}_{key}": val
                       for key, val in ragged.items()},
            ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
            library=case["library_name"], **stage,
            **bound_mixed(case["bytes"], case["parts"]))
        emit("vit_short_kernels", kernel=name, kernel_ms=kernel_ms, **{
            key: val for key, val in results[name].items() if key != "ms"})
    return results


def encode_with_counts(encoder, images, expected: dict, what: str) -> tuple:
    """One encode_batch call with every kernel count set to 0 just before
    it and read just after; the counts must equal ``expected``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in PATH_KERNELS:
        fn.launches = 0
    t0 = time.perf_counter()
    out = encoder.encode_batch(images)
    wall = time.perf_counter() - t0
    counts = {fn.__name__: fn.launches for fn in PATH_KERNELS}
    check(counts == expected,
          f"{what}: kernels launched {counts}, expected {expected}")
    return out, dict(wall_s=wall, launches=counts,
                     peak_bytes=torch.cuda.max_memory_allocated())


def row_cosine(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a, b = a.astype(np.float64), b.astype(np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                              * np.linalg.norm(b, axis=-1))


def phase_clip_variants(gen: torch.Generator, cfg, params, images,
                        phase: str, reference: tuple, variants: dict,
                        floor: float = CLIP_COSINE_FLOOR) -> dict:
    """One encode at SPLIT_FE_LAYERS layers of each of ``variants`` (name
    -> (config, expected launches[, use_pallas])) against ``reference``
    (name, config, expected launches) at that depth, on the same weights
    and images, each per-row cosine to the reference's at least ``floor``;
    each path's run (encode_with_counts')."""
    dev = gen.device
    shallow = dict(params)
    shallow["blocks"] = {key: leaf[:SPLIT_FE_LAYERS]
                         for key, leaf in params["blocks"].items()}
    ref_name, ref_cfg, ref_launches = reference
    paths = {ref_name: (ref_cfg, ref_launches), **variants}
    outs, runs = {}, {}
    for name, (path_cfg, expected, *pallas) in paths.items():
        encoder = ClipImageEncoder(path_cfg, shallow, batch_size=CLIP_BATCH,
                                   use_pallas=bool(pallas and pallas[0]),
                                   device=dev)
        outs[name], runs[name] = encode_with_counts(
            encoder, images, expected, f"{phase} {name}")
    cosines = {}
    for name in variants:
        cosine = row_cosine(outs[name], outs[ref_name])
        check(bool(np.isfinite(outs[name]).all()),
              f"{name} embeddings not finite")
        check(bool((cosine >= floor).all()),
              f"{name} embeddings' cosine to the {ref_name} path's "
              f"{cosine.min()} < {floor}")
        cosines[name] = dict(min=float(cosine.min()),
                             mean=float(cosine.mean()))
    emit(phase, layers=SPLIT_FE_LAYERS, batch=CLIP_BATCH, reference=ref_name,
         cosine=cosines, floor=floor,
         launches={name: run["launches"] for name, run in runs.items()},
         wall_s={name: run["wall_s"] for name, run in runs.items()},
         images_per_s={name: CLIP_BATCH / run["wall_s"]
                       for name, run in runs.items()},
         peak_gb={name: run["peak_bytes"] / 1e9
                  for name, run in runs.items()})
    return runs


def encode_paths(phase: str, encoders: dict, per_call: dict, images,
                 num_layers: int, floor: float = CLIP_COSINE_FLOOR) -> dict:
    """Each encoder (name -> ClipImageEncoder; "default" first) called twice
    with the kernel counts set to 0 before each call and read after it
    (``per_call[name]``'s kernels num_layers times, the others never), then
    its busy share; the other paths' per-row cosines to the default path's;
    and the calls in turns."""
    batch = images.shape[0]
    results, outs = {}, {}
    for name, encoder in encoders.items():
        want = launches(**{fn.__name__: num_layers
                           for fn in per_call[name]})
        runs = []
        for _ in range(2):
            out, run = encode_with_counts(encoder, images, want,
                                          f"{phase} {name}")
            runs.append(run)
        check(out.shape == (batch, encoder.cfg.projection_dim),
              f"{phase} {name}: embeddings {out.shape}")
        check(bool(np.isfinite(out).all()),
              f"{phase} {name}: embeddings not finite")
        outs[name] = out
        wall = runs[-1]["wall_s"]
        results[name] = dict(
            wall_s=wall, first_wall_s=runs[0]["wall_s"],
            images_per_s=batch / wall,
            peak_mem_gb=runs[-1]["peak_bytes"] / 1e9,
            launches_per_call=[r["launches"] for r in runs],
            **device_busy(lambda: encoder.encode_batch(images), wall, top=6))
        emit(phase, path=name, batch=batch, seq=encoder.cfg.seq_len,
             **results[name])
    cosines = {}
    for name in encoders:
        if name == "default":
            continue
        cosine = row_cosine(outs[name], outs["default"])
        check(bool((cosine >= floor).all()),
              f"{phase} {name} embeddings' cosine to the default path's "
              f"{cosine.min()} < {floor}")
        cosines[name] = dict(min=float(cosine.min()),
                             mean=float(cosine.mean()))
    turns = {name: [] for name in encoders}
    order = list(encoders)
    for name in order + order[::-1]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        encoders[name].encode_batch(images)
        turns[name].append(time.perf_counter() - t0)
    emit(phase + "_vs_default", cosine=cosines, floor=floor,
         encode_s_in_turns=turns,
         images_per_s_in_turns={k: [batch / t for t in v]
                                for k, v in turns.items()})
    return results


def phase_clip_encode(gen: torch.Generator) -> dict:
    """ClipImageEncoder at ViT-L/14@336, the default path, fused_block and
    int8 on the same weights and images (encode_paths); one split_fe encode
    and one whole and one whole_dd encode at 2 layers; and one
    ClipTextEncoder call."""
    dev = gen.device
    cfg = clip_lib.CLIPVisionConfig.vit_l_14_336()
    params = clip_lib.init_clip_vision_params(gen, cfg, torch.bfloat16)
    encoders = {
        "default": ClipImageEncoder(cfg, params, batch_size=CLIP_BATCH,
                                    device=dev),
        "fused": ClipImageEncoder(dataclasses.replace(cfg, fused_block=True),
                                  params, batch_size=CLIP_BATCH, device=dev),
    }
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    encoders["int8"] = ClipImageEncoder(cfg, params, batch_size=CLIP_BATCH,
                                        int8=True, device=dev)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    check("blocks_q8" not in params and encoders["int8"].cfg.int8,
          "ClipImageEncoder(int8=True) changed the caller's params or did "
          "not set cfg.int8")
    images = torch.randn((CLIP_BATCH, cfg.image_size, cfg.image_size, 3),
                         generator=gen, device=dev).bfloat16()
    results = encode_paths(
        "clip_encode", encoders,
        {"default": (), "fused": VIT_KERNELS, "int8": VIT_Q8_KERNELS},
        images, cfg.num_layers)
    results["int8"]["quantize_s"] = quantize_s
    emit("clip_int8_quantize", seconds=quantize_s)
    del encoders
    torch.cuda.empty_cache()
    depth = dataclasses.replace(cfg, num_layers=SPLIT_FE_LAYERS)
    n = SPLIT_FE_LAYERS
    phase_clip_variants(
        gen, cfg, params, images, "clip_split_fe",
        ("default", depth, launches()),
        {"split_fe": (dataclasses.replace(depth, fused_block=True,
                                          fused_block_long="split_fe"),
                      launches(attention_core=n, fused_mlp_block=n))})
    split3 = dataclasses.replace(depth, fused_block=True)
    phase_clip_variants(
        gen, cfg, params, images, "clip_whole",
        ("split3", split3, launches(**{fn.__name__: n for fn in VIT_KERNELS})),
        {name: (dataclasses.replace(split3, fused_block_long=name),
                launches(fused_vit_block=n))
         for name in ("whole", "whole_dd")})
    del params, images
    torch.cuda.empty_cache()

    text_cfg = clip_lib.CLIPTextConfig()
    text = ClipTextEncoder(
        text_cfg, clip_lib.init_clip_text_params(gen, text_cfg,
                                                 torch.bfloat16),
        batch_size=TEXT_BATCH, device=dev)
    ids = torch.randint(1, text_cfg.vocab_size - 1,
                        (TEXT_BATCH, text_cfg.context_length), generator=gen,
                        device=dev, dtype=torch.int32)
    eot = torch.randint(2, text_cfg.context_length, (TEXT_BATCH,),
                        generator=gen, device=dev)
    ids[torch.arange(TEXT_BATCH, device=dev), eot] = text_cfg.vocab_size - 1
    text.encode_ids(ids)                  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    text_out = text.encode_ids(ids)
    text_s = time.perf_counter() - t0
    check(text_out.shape == (TEXT_BATCH, text_cfg.projection_dim)
          and bool(np.isfinite(text_out).all()),
          "text embeddings not finite or of the wrong shape")
    emit("clip_text", batch=TEXT_BATCH, length=text_cfg.context_length,
         wall_s=text_s, texts_per_s=TEXT_BATCH / text_s)
    return results


def phase_clip_encode_b32(gen: torch.Generator) -> dict:
    """ClipImageEncoder at ViT-B/32 (12 layers) on B32_BATCH images: the
    default path, fused (the JAX bench's configuration), int8 and
    fused_attention on the same weights and images (encode_paths)."""
    dev = gen.device
    cfg = clip_lib.CLIPVisionConfig.vit_b_32()
    params = clip_lib.init_clip_vision_params(gen, cfg, torch.bfloat16)
    bench = dataclasses.replace(cfg, fast_attention=True,
                                fused_attention=True, fused_block=True)
    encoders = {
        "default": ClipImageEncoder(cfg, params, batch_size=B32_BATCH,
                                    device=dev),
        "fused": ClipImageEncoder(bench, params, batch_size=B32_BATCH,
                                  device=dev),
    }
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    encoders["int8"] = ClipImageEncoder(cfg, params, batch_size=B32_BATCH,
                                        int8=True, device=dev)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    check("blocks_q8" not in params and encoders["int8"].cfg.int8,
          "ClipImageEncoder(int8=True) changed the caller's params or did "
          "not set cfg.int8")
    encoders["fused_attention"] = ClipImageEncoder(
        dataclasses.replace(cfg, fused_attention=True), params,
        batch_size=B32_BATCH, device=dev)
    images = torch.randn((B32_BATCH, cfg.image_size, cfg.image_size, 3),
                         generator=gen, device=dev).bfloat16()
    results = encode_paths(
        "clip_encode_b32", encoders,
        {"default": (), "fused": (fused_vit_block,),
         "int8": (fused_vit_block_q8,),
         "fused_attention": (fused_attention_block,)},
        images, cfg.num_layers)
    results["int8"]["quantize_s"] = quantize_s
    emit("clip_b32_int8_quantize", seconds=quantize_s)
    emit("clip_b32_int8_vs_fused",
         int8_images_per_s=results["int8"]["images_per_s"],
         fused_images_per_s=results["fused"]["images_per_s"])
    return results


def gpt2_layer(gen: torch.Generator, cfg) -> list:
    """One GPT-2 layer at ``cfg``'s widths, bf16: init-scale weights, random
    LayerNorm parameters and biases, in the kernel's argument order."""
    dev = gen.device
    layer = {name: leaf[0] for name, leaf in gpt2_lib.init_gpt2_params(
        gen, dataclasses.replace(cfg, num_layers=1))["blocks"].items()}
    for name, leaf in layer.items():
        if name.endswith(("bias", "scale")):
            base = 1.0 if name.endswith("scale") else 0.0
            layer[name] = (base + 0.1 * torch.randn(
                leaf.shape, generator=gen, device=dev)).bfloat16()
    return [layer[n] for n in GPT2_BLOCK_KEYS]


def right_padded_mask(batch: int, length: int, dev, shortest: int) -> torch.Tensor:
    """(B, L) int32: row b valid on its first L - (b % 8) (L - shortest) / 7
    positions (every eighth row full, the shortest ``shortest``)."""
    mask = torch.zeros((batch, length), dtype=torch.int32, device=dev)
    for b in range(batch):
        mask[b, :length - (b % 8) * (length - shortest) // 7] = 1
    return mask


def gpt2_block_ops(mask: torch.Tensor, d_model: int, d_ff: int) -> float:
    """The block's operations on these inputs: the four projections over
    every row, and QK^T and PV over each query's visible valid keys."""
    rows = mask.numel()
    projections = 2 * rows * (4 * d_model * d_model + 2 * d_model * d_ff)
    pairs = int(mask.long().cumsum(dim=1).sum())
    return projections + 4 * d_model * pairs


def phase_gpt2_block(gen: torch.Generator) -> dict:
    """fused_gpt2_block against its plain version at GPT-2 small widths
    (D = 768, 12 heads, F = 3072): B=32, L=64 (G = 4) and B=8, L=128 with
    right-padded rows; B=6, L=64 (G = 2) with a left-padded row that sees no
    valid key; then timed at B=32, L=64 and L=128 in turns with the unfused
    bf16 block (library, kernel, library, kernel), beside the plain version
    and the bound, and by CUDA kernel, each GEMM beside cuBLAS addmm."""
    cfg = gpt2_lib.GPT2Config.gpt2_small()
    d_model, heads, d_ff = cfg.d_model, cfg.num_heads, 4 * cfg.d_model
    head_dim, eps = d_model // heads, cfg.layer_norm_epsilon
    dev = gen.device
    params = gpt2_layer(gen, cfg)
    (ln1_s, ln1_b, w_qkv, b_qkv, w_out, b_out, ln2_s, ln2_b, w_fc, b_fc,
     w_proj, b_proj) = params
    f = torch.nn.functional

    def inputs(batch, length, left_pad=0):
        x = torch.randn((batch, length, d_model), generator=gen,
                        device=dev).bfloat16()
        mask = right_padded_mask(batch, length, dev, length // 2)
        mask[1, :left_pad] = 0
        return x, mask

    checks = {}
    for batch, length, left_pad in ((32, 64, 0), (8, 128, 0), (6, 64, 7)):
        x, mask = inputs(batch, length, left_pad)
        checks[f"B{batch}_L{length}" + ("_left_padded" if left_pad else "")] \
            = check_against_plain(
                "fused_gpt2_block", lambda *a: fused_gpt2_block(*a, heads),
                lambda *a: fused_gpt2_block_plain(*a, heads),
                (x, mask, *params), batch)
    timed = {}
    for batch, length in ((32, 64), (32, 128)):
        x, mask = inputs(batch, length)
        args = (x, mask, *params, heads)
        causal = torch.ones((length, length), dtype=torch.bool,
                            device=dev).tril()
        sdpa_mask = causal[None, None] & (mask[:, None, None, :] > 0)

        def lib_block():
            # yardstick only: the unfused bf16 block (layer_norm, cuBLAS
            # addmm, scaled_dot_product_attention with the causal and key
            # mask, tanh gelu)
            x2 = x.view(-1, d_model)
            h = f.layer_norm(x2, (d_model,), ln1_s, ln1_b, eps)
            qkv = torch.addmm(b_qkv, h, w_qkv).view(batch, length, 3, heads,
                                                    head_dim)
            o = f.scaled_dot_product_attention(*qkv.permute(2, 0, 3, 1, 4),
                                               attn_mask=sdpa_mask)
            r1 = x2 + torch.addmm(b_out, o.transpose(1, 2).reshape(
                -1, d_model), w_out)
            z = torch.addmm(b_fc, f.layer_norm(r1, (d_model,), ln2_s, ln2_b,
                                               eps), w_fc)
            return r1 + torch.addmm(b_proj, f.gelu(z, approximate="tanh"),
                                    w_proj)

        def kernel():
            return fused_gpt2_block(*args)

        rows = batch * length
        bytes_moved = (2 * rows * d_model * 2 + mask.numel() * 4
                       + sum(p.numel() * 2 for p in params))
        # the library's and the kernel's times in turns, each the mean of
        # its two
        turns = [cuda_ms(fn, iters=20)
                 for fn in (lib_block, kernel, lib_block, kernel)]
        # cuBLAS addmm of the block's four products on random operands
        h, hid = yardstick_operands(dev, rows, d_model, d_ff)
        cublas_ms = [cuda_ms(lambda p=p: torch.addmm(*p), iters=20)
                     for p in ((b_qkv, h, w_qkv), (b_out, h, w_out),
                               (b_fc, h, w_fc), (b_proj, hid, w_proj))]
        timed[f"L{length}"] = dict(
            shape=dict(B=batch, L=length, D=d_model, H=heads, F=d_ff,
                       G=gpt2_block_group(batch)),
            ms=(turns[1] + turns[3]) / 2,
            plain_ms=cuda_ms(lambda: fused_gpt2_block_plain(*args), iters=3,
                             warmup=1),
            library_ms=(turns[0] + turns[2]) / 2,
            turns_ms=dict(library=turns[0::2], kernel=turns[1::2]),
            **bf16_gemm_stage("fused_gpt2_block", kernel_split(kernel),
                              cublas_ms),
            gemm_kernels=tma_products("fused_gpt2_block", kernel, 4),
            **bound(bytes_moved, gpt2_block_ops(mask, d_model, d_ff),
                    BF16_FLOP_PER_S))
        emit("gpt2_block_timed", **timed[f"L{length}"])
    main = checks["B32_L64"]
    result = dict(**timed["L64"], max_abs_err=max(
        c["max_abs_err"] for c in checks.values()), checks=checks,
        at_L128=timed["L128"],
        library="the unfused bf16 block: layer_norm, addmm, "
                "scaled_dot_product_attention (causal and key mask), "
                "gelu(approximate='tanh')",
        differing_share=main["differing"] / main["elements"])
    emit("gpt2_block", **{k: v for k, v in result.items()
                          if k not in ("at_L128",)})
    return result


def check_within_one_ulp(name: str, got: torch.Tensor,
                         want: torch.Tensor) -> dict:
    """Every element within one bf16 ulp of the plain version's: the ulp of
    the larger of the two values (neighbours across a power of two), and
    at least that of rms(want) / 256 (outputs near zero, where fp32 sums in
    another order move by more than their own ulps)."""
    g, w = got.float(), want.float()
    floor = w.square().mean().sqrt() / 256
    top = torch.maximum(torch.maximum(g.abs(), w.abs()), floor)
    ulp = torch.exp2(torch.floor(torch.log2(top)) - 7)
    err = (g - w).abs()
    check(bool(torch.isfinite(g).all()), f"{name}: output not finite")
    check(bool((err <= ulp).all()),
          f"{name}: {int((err > ulp).sum())} elements beyond one bf16 ulp of "
          f"the plain version (max abs err {err.max().item()})")
    return dict(max_abs_err=err.max().item(), differing=int((err > 0).sum()),
                elements=err.numel())


def phase_flash_attention(gen: torch.Generator) -> dict:
    """flash_attention against its plain version on 16 images at ViT-L/14@336
    widths (L = 577, 16 heads of 64, bf16, no bias) and on a small shape
    under a (B, 1, 1, Lk) key-mask bias (one row masked entirely) and a
    per-(batch, head) bias; its CUDA kernels under the profiler (the wgmma
    attention's kF32Planes, no other: the CUDA-event time is that kernel's;
    clip_encode_pallas gives its device time in the encode); then timed at
    CLIP_BATCH beside the
    plain version, the function's bound, its route's and
    scaled_dot_product_attention on fp32 copies, and with a key-mask bias
    at CLIP_BATCH and a per-(batch, head) one on 16 images."""
    cfg = clip_lib.CLIPVisionConfig.vit_l_14_336()
    seq, heads = cfg.seq_len, cfg.num_heads
    head_dim = cfg.width // heads
    dev = gen.device

    def qkv(batch, length, n_heads):
        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev)
        return ((randn(batch, length, n_heads, head_dim) * head_dim ** -0.5)
                .bfloat16(), randn(batch, length, n_heads, head_dim).bfloat16(),
                randn(batch, length, n_heads, head_dim).bfloat16())

    def key_mask_bias(batch, length):
        # (B, 1, 1, L): row 1 keeps 120 keys, row 2 none, the others all
        bias = torch.zeros((batch, 1, 1, length), device=dev)
        bias[1, ..., 120:] = -1e9
        bias[2] = -1e9
        return bias

    checks = {}
    q, k, v = qkv(VIT_CHECK_BATCH, seq, heads)
    checks[f"B{VIT_CHECK_BATCH}"] = check_within_one_ulp(
        "flash_attention", flash_attention(q, k, v),
        flash_attention_plain(q, k, v))
    names = cuda_kernel_names(lambda: flash_attention(q, k, v), calls=10)
    check(len(names) == 1
          and "vit_attention_wgmma::attention_kernel<64, 3>" in names[0],
          f"flash_attention: its CUDA kernels are {names}, not the wgmma "
          f"attention's kF32Planes")
    per_head = torch.randn((VIT_CHECK_BATCH, heads, seq, seq), generator=gen,
                           device=dev)
    per_head_ms = cuda_ms(lambda: flash_attention(q, k, v, per_head),
                          iters=10)
    del q, k, v, per_head
    q, k, v = qkv(3, 200, 4)
    per_head = torch.randn((3, 4, 200, 200), generator=gen, device=dev)
    for name, bias in (("key_mask", key_mask_bias(3, 200)),
                       ("per_batch_head", per_head)):
        checks[name] = check_within_one_ulp(
            f"flash_attention {name}", flash_attention(q, k, v, bias),
            flash_attention_plain(q, k, v, bias))
    del q, k, v
    torch.cuda.empty_cache()

    q, k, v = qkv(CLIP_BATCH, seq, heads)
    kernel_ms = cuda_ms(lambda: flash_attention(q, k, v), iters=10)
    key_mask = key_mask_bias(CLIP_BATCH, seq)
    key_mask_ms = cuda_ms(lambda: flash_attention(q, k, v, key_mask),
                          iters=10)
    plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v), iters=2,
                       warmup=1)
    torch.cuda.empty_cache()
    # yardstick only: SDPA on the fp32-upcast inputs (B, H, L, dh)
    q32, k32, v32 = (t.float().transpose(1, 2) for t in (q, k, v))
    library_ms = cuda_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q32, k32, v32, scale=1.0), iters=10)
    del q32, k32, v32
    flops = 2 * CLIP_BATCH * heads * seq * seq * head_dim
    bytes_moved = 4 * q.numel() * 2
    main = checks[f"B{VIT_CHECK_BATCH}"]
    # this route: q k^T twice (both passes), PV as three exact bf16 products
    route = bound_mixed(bytes_moved, [(2 * flops, BF16_FLOP_PER_S),
                                      (3 * flops, BF16_FLOP_PER_S)])
    result = dict(
        shape=dict(B=CLIP_BATCH, L=seq, H=heads, dh=head_dim),
        ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
        library="scaled_dot_product_attention, fp32 inputs, scale=1.0",
        key_mask_ms=key_mask_ms,
        **{f"per_batch_head_ms_B{VIT_CHECK_BATCH}": per_head_ms},
        cuda_kernels=names,
        max_abs_err=max(c["max_abs_err"] for c in checks.values()),
        checks=checks, differing_share=main["differing"] / main["elements"],
        route_bound_ms=route["bound_ms"], route_bound_by=route["bound_by"],
        # the function: q k^T and PV once each, and its bytes
        **bound_mixed(bytes_moved, [(2 * flops, BF16_FLOP_PER_S)]))
    del q, k, v
    torch.cuda.empty_cache()
    emit("flash_attention", kernel_ms=kernel_ms,
         **{key: val for key, val in result.items() if key != "ms"})
    return result


def clipcap_batch(gen: torch.Generator, tokens: int, answer: int = 5):
    """CLIPCAP_BATCH right-padded token rows of ``tokens`` (the shortest
    half as long), their mask, and labels on each row's last ``answer``
    valid tokens (-100 elsewhere)."""
    dev = gen.device
    ids = torch.randint(0, 50256, (CLIPCAP_BATCH, tokens), generator=gen,
                        device=dev, dtype=torch.int32)
    mask = right_padded_mask(CLIPCAP_BATCH, tokens, dev, tokens // 2)
    labels = torch.full_like(ids, -100)
    for b, valid in enumerate(mask.sum(dim=1).tolist()):
        labels[b, valid - answer:valid] = ids[b, valid - answer:valid]
    return ids, mask, labels


def timed_call(fn, expected: dict, what: str) -> tuple:
    """fn() with every kernel count set to 0 just before and read just
    after (they must equal ``expected``), on the host clock to a
    synchronize, with the peak device memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kernel in PATH_KERNELS:
        kernel.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {kernel.__name__: kernel.launches for kernel in PATH_KERNELS}
    check(counts == expected,
          f"{what}: kernels launched {counts}, expected {expected}")
    return out, dict(wall_s=wall, launches=counts,
                     peak_bytes=torch.cuda.max_memory_allocated())


def phase_clipcap(gen: torch.Generator) -> dict:
    """ClipCap at GPT-2 small width and depth with the mlp mapper (512 ->
    10 x 768), random weights from SEED, prefixes from ViT-B/32
    ClipImageEncoder embeddings of CLIPCAP_BATCH random images: generate
    twice (no kernel), the loss at 64 positions with fused_block (12
    fused_gpt2_block launches) and without it (none), and at 138 positions
    with fused_block (none, as in JAX)."""
    dev = gen.device
    vit = clip_lib.CLIPVisionConfig.vit_b_32()
    encoder = ClipImageEncoder(
        vit, clip_lib.init_clip_vision_params(gen, vit, torch.bfloat16),
        batch_size=CLIPCAP_BATCH, device=dev)
    images = torch.randn((CLIPCAP_BATCH, vit.image_size, vit.image_size, 3),
                         generator=gen, device=dev).bfloat16()
    prefix, encode = timed_call(
        lambda: torch.from_numpy(encoder.encode_batch(images)).to(dev),
        launches(), "clipcap image encode")
    check(tuple(prefix.shape) == (CLIPCAP_BATCH, vit.projection_dim)
          and bool(torch.isfinite(prefix).all()), "prefix embeddings")
    del encoder, images
    torch.cuda.empty_cache()

    lm_cfg = gpt2_lib.GPT2Config.gpt2_small(fused_block=True)
    cfg = clipcap_lib.ClipCapConfig.from_model_args(CLIPCAP_MODEL_ARGS,
                                                    lm_cfg=lm_cfg)
    t0 = time.perf_counter()
    model = clipcap_lib.build_clipcap_prefix(
        cfg, clipcap_lib.init_clipcap_params(cfg, seed=SEED, device=dev))
    torch.cuda.synchronize()
    emit("clipcap_init", seconds=time.perf_counter() - t0,
         params_gb=torch.cuda.memory_allocated() / 1e9)

    # generate: CLIPCAP_BATCH prompts of up to CLIPCAP_PROMPT tokens
    prompt, prompt_mask, _ = clipcap_batch(gen, CLIPCAP_PROMPT)
    runs = []
    for _ in range(2):
        (tokens, logprobs), run = timed_call(
            lambda: model.generate(prefix, prompt, prompt_mask,
                                   max_new_tokens=MAX_NEW_TOKENS),
            launches(), "clipcap generate")
        runs.append(dict(run, tokens=tokens, logprobs=logprobs))
    check(torch.equal(runs[0]["tokens"], runs[1]["tokens"]),
          "clipcap: the two generate calls gave different tokens")
    check(tuple(tokens.shape) == (CLIPCAP_BATCH, MAX_NEW_TOKENS)
          and bool(((tokens >= 0) & (tokens < lm_cfg.vocab_size)).all()),
          "clipcap tokens")
    check(bool(torch.isfinite(logprobs).all() & (logprobs <= 0).all()),
          "clipcap log-probs")
    wall = runs[1]["wall_s"]
    generate = dict(
        batch=CLIPCAP_BATCH, prompt_tokens=CLIPCAP_PROMPT,
        positions=cfg.prefix_length + CLIPCAP_PROMPT,
        new_tokens=MAX_NEW_TOKENS, wall_s=wall,
        first_wall_s=runs[0]["wall_s"], prompts_per_s=CLIPCAP_BATCH / wall,
        peak_mem_gb=runs[1]["peak_bytes"] / 1e9,
        launches_per_call=[r["launches"] for r in runs],
        first_tokens=tokens[0, :5].tolist(),
        **device_busy(lambda: model.generate(prefix, prompt, prompt_mask,
                                             max_new_tokens=MAX_NEW_TOKENS),
                      wall, top=6))
    emit("clipcap_generate", image_encode_s=encode["wall_s"], **generate)
    generate["breakdown"] = clipcap_generate_breakdown(model, prefix, prompt,
                                                       prompt_mask)
    emit("clipcap_generate_breakdown", **generate["breakdown"])

    # the teacher-forced loss, a forward pass
    n_layers = lm_cfg.num_layers
    ids, mask, labels = clipcap_batch(gen, CLIPCAP_LOSS_TOKENS)
    unfused = clipcap_lib.build_clipcap_prefix(
        dataclasses.replace(cfg, lm=dataclasses.replace(
            lm_cfg, fused_block=False)), model.params)
    losses, loss_runs = {}, {}
    with torch.inference_mode():
        for name, path, want in (("fused", model, n_layers),
                                 ("unfused", unfused, 0)):
            calls = []
            for _ in range(2):
                value, run = timed_call(
                    lambda: path.forward_loss(prefix, ids, mask, labels),
                    launches(fused_gpt2_block=want), f"clipcap loss {name}")
                calls.append(run)
            losses[name] = float(value)
            loss_runs[name] = dict(
                wall_s=calls[1]["wall_s"], first_wall_s=calls[0]["wall_s"],
                peak_mem_gb=calls[1]["peak_bytes"] / 1e9,
                launches_per_call=[c["launches"] for c in calls],
                **device_busy(lambda: path.forward_loss(prefix, ids, mask,
                                                        labels),
                              calls[1]["wall_s"], top=6))
        rel = abs(losses["fused"] - losses["unfused"]) / abs(losses["unfused"])
        check(all(np.isfinite(v) and v > 0 for v in losses.values()),
              f"clipcap losses {losses}")
        check(rel <= CLIPCAP_LOSS_REL,
              f"clipcap fused loss {losses['fused']} against unfused "
              f"{losses['unfused']}: rel {rel} > {CLIPCAP_LOSS_REL}")
        long_ids, long_mask, long_labels = clipcap_batch(
            gen, CLIPCAP_BUCKET_TOKENS)
        long_loss, long_run = timed_call(
            lambda: model.forward_loss(prefix, long_ids, long_mask,
                                       long_labels),
            launches(), "clipcap loss at the 128-token bucket")
        check(bool(torch.isfinite(long_loss)), "clipcap loss at 138 positions")
    loss = dict(batch=CLIPCAP_BATCH, tokens=CLIPCAP_LOSS_TOKENS,
                positions=cfg.prefix_length + CLIPCAP_LOSS_TOKENS,
                losses=losses, rel_diff=rel, limit=CLIPCAP_LOSS_REL,
                **{name: run for name, run in loss_runs.items()},
                bucket=dict(tokens=CLIPCAP_BUCKET_TOKENS,
                            positions=cfg.prefix_length
                            + CLIPCAP_BUCKET_TOKENS,
                            loss=float(long_loss), wall_s=long_run["wall_s"],
                            launches=long_run["launches"]))
    emit("clipcap_loss", **loss)
    loss["breakdown"] = clipcap_loss_breakdown(model, prefix, ids, mask)
    emit("clipcap_loss_breakdown", **loss["breakdown"])
    loss["launches_per_call"] = loss_runs["fused"]["launches_per_call"]
    return dict(generate=generate, loss=loss)


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def clipcap_generate_breakdown(model, prefix, prompt, prompt_mask) -> dict:
    """The generate call's parts, each ending in a synchronize: mapper and
    embedding, prefill, the greedy decode loop (prefill included)."""
    cfg, lm = model.cfg, model.params["lm"]
    with torch.inference_mode():
        (embeds, mask), embed_s = timed(lambda: clipcap_lib.embed_with_prefix(
            cfg, lm, model.params["mapper"], prefix, prompt, prompt_mask))
        cache = gpt2_lib.init_gpt2_cache(cfg.lm, CLIPCAP_BATCH,
                                         embeds.shape[1] + MAX_NEW_TOKENS,
                                         device=embeds.device)
        _, prefill_s = timed(lambda: gpt2_lib.gpt2_prefill(
            lm, cfg.lm, embeds, mask, cache))
        _, decode_s = timed(lambda: greedy_decode_gpt2(
            lm, cfg.lm, embeds, mask, max_new_tokens=MAX_NEW_TOKENS))
    return dict(mapper_embed_s=embed_s, prefill_s=prefill_s,
                greedy_decode_s=decode_s,
                decode_steps_s=decode_s - prefill_s,
                decode_step_ms=(decode_s - prefill_s)
                / (MAX_NEW_TOKENS - 1) * 1e3)


def clipcap_loss_breakdown(model, prefix, ids, mask) -> dict:
    """The fused loss call's parts, each ending in a synchronize: mapper and
    embedding, the 12 fused blocks, and the final LayerNorm, LM head and
    log-softmax."""
    cfg, lm = model.cfg, model.params["lm"]
    with torch.inference_mode():
        (embeds, full_mask), embed_s = timed(
            lambda: clipcap_lib.embed_with_prefix(
                cfg, lm, model.params["mapper"], prefix, ids, mask))

        def blocks():
            x = embeds
            for i in range(cfg.lm.num_layers):
                x = fused_gpt2_block(
                    x, full_mask, *(lm["blocks"][n][i]
                                    for n in GPT2_BLOCK_KEYS),
                    num_heads=cfg.lm.num_heads)
            return x

        x, blocks_s = timed(blocks)

        def head():
            logits = gpt2_lib.lm_logits(lm, cfg.lm, x)
            return torch.log_softmax(logits[:, :-1].float(), dim=-1)

        _, head_s = timed(head)
    return dict(mapper_embed_s=embed_s, fused_blocks_s=blocks_s,
                head_log_softmax_s=head_s)


def phase_clip_encode_pallas(gen: torch.Generator) -> dict:
    """ClipImageEncoder(use_pallas=True) at ViT-L/14@336 on CLIP_BATCH
    images beside the default path (encode_paths): 24 flash_attention
    launches a call, per-row cosine to the default path at least
    PALLAS_COSINE_FLOOR."""
    dev = gen.device
    cfg = clip_lib.CLIPVisionConfig.vit_l_14_336()
    params = clip_lib.init_clip_vision_params(gen, cfg, torch.bfloat16)
    encoders = {
        "default": ClipImageEncoder(cfg, params, batch_size=CLIP_BATCH,
                                    device=dev),
        "use_pallas": ClipImageEncoder(cfg, params, batch_size=CLIP_BATCH,
                                       use_pallas=True, device=dev),
    }
    images = torch.randn((CLIP_BATCH, cfg.image_size, cfg.image_size, 3),
                         generator=gen, device=dev).bfloat16()
    return encode_paths("clip_encode_pallas", encoders,
                        {"default": (), "use_pallas": (flash_attention,)},
                        images, cfg.num_layers, floor=PALLAS_COSINE_FLOOR)


def vit_fast_exp_flip_bound(q, k, v, heads: int,
                            dot_units: int = 2) -> torch.Tensor:
    """Per output element, how far attention with fast_exp may move for the
    bf16 roundings of s - max that two fp32 evaluations of the scores may
    take apart (tests/test_torch_vit_f32_kernels.py): arguments within the
    error bound of two fp32 dots of dh terms (dot_units dh 2^-24 sum |q_i
    k_i|: 2 for two rounded sums, 3 where one is the tensor cores', whose
    additions may truncate) of s and of the row's max, and the
    subtraction's roundings, of a bf16 midpoint; a flip moves the argument
    by at most 2^-7 |s - max|, its exponential e by e expm1 of that. In
    fp64, over VIT_F32_BOUND_IMAGES images at a time."""
    batch, seq, width = q.shape
    dh = width // heads
    out = torch.empty_like(q)
    for b0 in range(0, batch, VIT_F32_BOUND_IMAGES):
        sl = slice(b0, b0 + VIT_F32_BOUND_IMAGES)
        n = q[sl].shape[0]

        def h(t):
            return t[sl].double().reshape(n, seq, heads, dh).transpose(1, 2)

        qh, kh, vh = h(q), h(k), h(v)
        s = (qh @ kh.transpose(-1, -2)).float()
        err = (qh.abs() @ kh.abs().transpose(-1, -2)).mul_(
            dot_units * dh * 2.0 ** -24)
        d = (s - s.amax(dim=-1, keepdim=True)).contiguous()
        del s
        ulp = torch.nextafter(d.abs(), torch.full_like(d, float("inf"))) \
            - d.abs()
        err += err.amax(dim=-1, keepdim=True) + 2 * ulp.double()
        del ulp
        bits = d.view(torch.int32) & -65536
        mid = (bits.view(torch.float32).double()
               + (bits + 65536).view(torch.float32).double()) / 2
        del bits
        dd = d.double()
        near = (dd - mid).abs() <= err
        del mid, err, d
        e = torch.exp(dd)
        de = near * e * torch.expm1(dd.abs() * 2.0 ** -7)
        del near, dd
        denom = e.sum(dim=-1, keepdim=True)
        o = (e @ vh) / denom
        bound = (de @ vh.abs() + o.abs() * de.sum(dim=-1, keepdim=True)) \
            / denom
        out[sl] = bound.transpose(1, 2).reshape(n, seq, width).float()
        del e, de, o, bound
    torch.cuda.empty_cache()
    return out


def vit_f32_rule(name: str, got: torch.Tensor, want: torch.Tensor,
                 flip_bound=None) -> dict:
    """An fp32 form of a ViT kernel against its plain version: finite fp32
    outputs held by the function's rule (VIT_F32_REL_FROBENIUS,
    FP32_ATOL); the readings."""
    check(got.dtype == torch.float32 and bool(torch.isfinite(got).all()),
          f"{name}: {got.dtype} output or not finite")
    err = (got.double() - want.double()).abs()
    limit = FP32_ATOL * (1 + want.double().abs())
    close = (err <= limit).double().mean().item()
    out = dict(max_abs_err=err.max().item(), within_fp32_tol_share=close,
               outputs_off_plain_share=(err > 0).double().mean().item())
    if name.startswith(("fused_ln_qkv", "fused_mlp_block")):
        rel = (err.norm() / want.double().norm()).item()
        out["rel_frobenius"] = rel
        check(rel <= VIT_F32_REL_FROBENIUS and close >= VIT_F32_CLOSE,
              f"{name}: relative Frobenius error {rel} (limit "
              f"{VIT_F32_REL_FROBENIUS}), {close} of outputs within "
              f"{FP32_ATOL} (1 + |want|) (floor {VIT_F32_CLOSE})")
    elif flip_bound is None:
        check(close == 1.0,
              f"{name}: outside {FP32_ATOL} (1 + |want|) of the plain "
              f"version (max abs err {out['max_abs_err']})")
    else:
        beyond = (err - limit - flip_bound.double()).max().item()
        out.update(flip_bound_max=flip_bound.max().item(),
                   beyond_bound=beyond)
        check(beyond <= 0 and close >= VIT_F32_FAST_CLOSE,
              f"{name}: {beyond} beyond {FP32_ATOL} (1 + |want|) and the "
              f"flip bound, {close} of outputs within {FP32_ATOL} (1 + "
              f"|want|) (floor {VIT_F32_FAST_CLOSE})")
    del err, limit
    return out


def vit_block_f32_rule(name: str, got: torch.Tensor, want: torch.Tensor,
                       bf16_form: torch.Tensor) -> dict:
    """fused_vit_block's fp32 form against its plain version: finite fp32
    outputs whose relative Frobenius error is at most VIT_BLOCK_F32_VS_BF16
    of the bf16 form's (``bf16_form``: the kernel on x rounded to bf16, the
    same parameters); every bf16 intermediate of the block rounds the other
    way from the plain version's now and then, in its bf16 form as in its
    fp32 ones. The readings."""
    check(got.dtype == torch.float32 and bool(torch.isfinite(got).all()),
          f"{name}: {got.dtype} output or not finite")
    want = want.double()
    rel = ((got.double() - want).norm() / want.norm()).item()
    base = ((bf16_form.double() - want).norm() / want.norm()).item()
    check(rel <= VIT_BLOCK_F32_VS_BF16 * base,
          f"{name}: relative Frobenius error {rel}, above "
          f"{VIT_BLOCK_F32_VS_BF16} of the bf16 form's {base}")
    return dict(max_abs_err=(got.double() - want).abs().max().item(),
                rel_frobenius=rel, bf16_form_rel_frobenius=base)


def block_q8_f32_rule(name: str, args) -> dict:
    """fused_vit_block_q8 with fp32 x against its plain version, by the rule
    of tests/test_torch_vit_q8_f32.py (block_q8_rule), on its own stages
    (stages_out): its r1 within FP32_ATOL (1 + |want|) of x plus the plain
    out-projection of its fp32 attention output; its output within
    BLOCK_Q8_MLP_REL_FROBENIUS of the plain MLP over its r1; and the whole
    block's relative Frobenius error at most VIT_BLOCK_F32_VS_BF16 of the
    plain version's bf16 form's (x rounded to bf16 in, the output rounded).
    Its bf16 attention and the codes after it flip against the plain
    version's, so the whole block's error alone does not part a form that
    stores its output or r1 in bf16 from a sound one; the first two do, and
    the third fails a form that reads x as bf16. The readings."""
    stages = {}
    got = fused_vit_block_q8(*args, group=4, stages_out=stages)
    torch.cuda.synchronize()
    check(got.dtype == torch.float32 and bool(torch.isfinite(got).all()),
          f"{name}: {got.dtype} output or not finite")
    x, wo, so, bo = args[0], *args[6:9]
    width = x.shape[-1]
    y = port_fab._mm_q8_grouped(
        [port_fab._row_quant_i8(stages["attn"].reshape(-1, width))], wo,
        port_fab._as_group_scales(so)) + bo.float()
    r1_want = (x.reshape(-1, width) + y).double()
    r1_err = ((stages["r1"].reshape(-1, width).double() - r1_want).abs()
              / (1 + r1_want.abs())).max().item()
    del y, r1_want
    mlp = fused_mlp_block_q8_plain(stages["r1"], *args[9:17])
    mlp_rel = rel_frobenius(got, mlp)
    del mlp, stages
    want = fused_vit_block_q8_plain(*args)
    rel = rel_frobenius(got, want)
    base = rel_frobenius(fused_vit_block_q8_plain(x.bfloat16(), *args[1:]),
                         want)
    res = dict(max_abs_err=(got.double() - want).abs().max().item(),
               rel_frobenius=rel, r1_err=r1_err, mlp_rel_frobenius=mlp_rel,
               plain_bf16_form_rel_frobenius=base,
               plain_rounded_to_bf16_rel_frobenius=rel_frobenius(
                   want.bfloat16(), want))
    check(r1_err <= FP32_ATOL, f"{name}: r1 {r1_err} off x plus the plain "
          f"out-projection of its attention output: {res}")
    check(mlp_rel <= BLOCK_Q8_MLP_REL_FROBENIUS,
          f"{name}: output off the plain MLP over its r1: {res}")
    check(rel <= VIT_BLOCK_F32_VS_BF16 * base,
          f"{name}: relative Frobenius error above {VIT_BLOCK_F32_VS_BF16} "
          f"of the plain bf16 form's: {res}")
    return res


def rel_frobenius(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.double()
    return ((got - want).norm() / want.norm()).item()


def f32_attention_by_route(q, k, v, heads: int, route: int, fast_exp: bool,
                           out: torch.Tensor) -> None:
    """attention_core's fp32 kernel by ``route`` (port_fab.F32_*) into
    ``out``, whatever route the wrapper would take."""
    batch, seq, width = q.shape
    rc = port_fab._launcher_of("vit_block", "attention_core", 4, 7, 0)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), batch, seq,
        heads, width // heads, int(fast_exp), 1, route,
        torch.cuda.current_stream().cuda_stream)
    check(rc == 0, f"attention_core (fp32) by route {route}: launch failed "
          f"({rc})")


def vit_f32_routes(qkv, heads: int, kw: dict, name: str) -> dict:
    """attention_core's fp32 kernel by the route the wrapper takes and by
    the two-pass route (any L), each by vit_f32_rule against the plain
    version, timed in turns with fp32 scaled_dot_product_attention (TF32
    off; two-pass, wrapper's, SDPA, SDPA, wrapper's, two-pass); each
    route's bound on the operations it runs: the held routes q·kᵀ once on
    whole 64-row, 64-key tiles at the fp32 rate, with P·V there too (the
    held route) or E·V as six bf16-plane products at the bf16 rate (K in
    the score rows); the two-pass route q·kᵀ twice."""
    q, k, v = qkv
    batch, seq, width = q.shape
    route = port_fab.vit_f32_route(seq, width // heads)
    two_pass_out = torch.empty_like(q)

    def two_pass():
        f32_attention_by_route(q, k, v, heads, port_fab.F32_TWO_PASS,
                               bool(kw), two_pass_out)

    two_pass()
    torch.cuda.synchronize()
    want = attention_core_plain(q, k, v, heads, **kw)
    flip = vit_fast_exp_flip_bound(q, k, v, heads) if kw else None
    two_pass_err = vit_f32_rule(f"{name} (two-pass route)", two_pass_out,
                                want, flip)
    del want, flip
    torch.cuda.empty_cache()
    q4, k4, v4 = (t.view(batch, seq, heads, -1).transpose(1, 2)
                  for t in qkv)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, scale=1.0)

    def wrapper():
        return attention_core(q, k, v, heads, **kw)

    turns = [cuda_ms(call, iters=5) for call in (
        two_pass, wrapper, sdpa, sdpa, wrapper, two_pass)]
    padded = -(-seq // 64) * 64
    whole = batch * padded * padded * width
    route_ops = {
        port_fab.F32_HELD: [(4 * whole, FP32_FLOP_PER_S)],
        port_fab.F32_HELD_KS: [(2 * whole, FP32_FLOP_PER_S),
                               (12 * whole, BF16_FLOP_PER_S)],
        port_fab.F32_TWO_PASS: [(6 * batch * seq * seq * width,
                                 FP32_FLOP_PER_S)]}
    return dict(
        route={port_fab.F32_HELD: "held", port_fab.F32_HELD_KS:
               "held, K in the score rows, E·V as bf16-plane wgmma",
               port_fab.F32_TWO_PASS: "two-pass"}[route],
        route_bound_ms=bound_mixed(0, route_ops[route])["bound_ms"],
        route_in_turns_ms=(turns[1] + turns[4]) / 2,
        sdpa_in_turns_ms=(turns[2] + turns[3]) / 2,
        two_pass_ms=(turns[0] + turns[5]) / 2,
        route_turns_ms=dict(two_pass=turns[0::5], route=turns[1::3],
                            sdpa=turns[2:4]),
        two_pass_route_bound_ms=bound_mixed(
            0, route_ops[port_fab.F32_TWO_PASS])["bound_ms"],
        two_pass_max_abs_err=two_pass_err["max_abs_err"])


def phase_vit_kernels_f32(gen: torch.Generator) -> dict:
    """The fp32 forms of the split3 kernels and attention_core at ViT-L
    widths on CLIP_BATCH images, the main path's shape: fp32 activations
    with bf16 parameters (the kernels line's ``_f32`` rows) and with fp32
    parameters (the weights cast to bf16 by the wrapper each call, the
    casts timed apart), bf16 activations with fp32 parameters, and
    attention_core with fast_exp. Each against its plain version by
    vit_f32_rule (the bf16-activation forms by check_against_plain's bf16
    rule), timed by CUDA events in turns with the bf16 form, beside its
    plain version, its bound and, for the fp32 rows, one library function
    of the same dtypes (TF32 off)."""
    cfg = clip_lib.CLIPVisionConfig.vit_l_14_336()
    seq, width, heads = cfg.seq_len, cfg.width, cfg.num_heads
    d_ff, eps = cfg.mlp_ratio * width, cfg.layer_norm_epsilon
    dev = gen.device
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on: the plain versions must multiply in fp32")

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev).mul_(scale)

    batch, rows = CLIP_BATCH, CLIP_BATCH * seq
    x = randn(batch, seq, width)
    vecs = dict(ln_s=1 + randn(width, scale=0.1), ln_b=randn(width, scale=0.1),
                b=[randn(width, scale=0.1) for _ in range(4)],
                b_fc=randn(d_ff, scale=0.1), b_pr=randn(width, scale=0.1))
    mats = dict(w=[randn(width, width, scale=width ** -0.5) for _ in range(4)],
                w_fc=randn(width, d_ff, scale=width ** -0.5),
                w_pr=randn(d_ff, width, scale=d_ff ** -0.5))
    qkv = [randn(batch, seq, width, scale=s) for s in (0.5, 2.0, 1.0)]

    def cast(tree, dtype):
        if isinstance(tree, dict):
            return {key: cast(val, dtype) for key, val in tree.items()}
        if isinstance(tree, list):
            return [cast(val, dtype) for val in tree]
        return tree.to(dtype)

    def operands(act, vec, mat):
        return dict(x=x.to(act), qkv=[t.to(act) for t in qkv],
                    **cast(vecs, vec), **cast(mats, mat))

    def args_of(name, o):
        if name == "fused_ln_qkv":
            return (o["x"], o["ln_s"], o["ln_b"], o["w"][0], o["b"][0],
                    o["w"][1], o["b"][1], o["w"][2], o["b"][2],
                    (width // heads) ** -0.5)
        if name == "attention_core_oproj":
            return (o["x"], *o["qkv"], o["w"][3], o["b"][3], heads)
        if name == "fused_mlp_block":
            return (o["x"], o["ln_s"], o["ln_b"], o["w_fc"], o["b_fc"],
                    o["w_pr"], o["b_pr"])
        return (*o["qkv"], heads)

    f32, bf = torch.float32, torch.bfloat16
    # name -> (activations, vectors, weights)
    forms = {"f32": (f32, bf, bf), "f32_params_f32": (f32, f32, f32),
             "bf16_params_f32": (bf, f32, f32)}
    bf16_form = operands(bf, bf, bf)
    f = torch.nn.functional
    lib_w = [w.bfloat16().float() for w in mats["w"]]   # exact in fp32

    # yardsticks only, on the "f32" form's operands (fp32 activations, the
    # products' weights bf16-valued): fp32 layer_norm, bf16 addmm widened
    # to fp32; fp32 scaled_dot_product_attention (TF32 off) and an fp32
    # out-projection on the widened weight; times, not value checks
    def library(name, o):
        x2 = o["x"].view(-1, width)
        if name == "fused_ln_qkv":
            h = f.layer_norm(x2, (width,), o["ln_s"].float(),
                             o["ln_b"].float(), eps).bfloat16()
            w_qkv = torch.cat(o["w"][:3], dim=1)
            return lambda: torch.addmm(torch.cat(o["b"][:3]), h,
                                       w_qkv).float()
        if name == "fused_mlp_block":
            def mlp():
                h = f.layer_norm(x2, (width,), o["ln_s"].float(),
                                 o["ln_b"].float(), eps).bfloat16()
                z = torch.addmm(o["b_fc"], h, o["w_fc"])
                return x2 + torch.addmm(o["b_pr"], z * torch.sigmoid(
                    1.702 * z), o["w_pr"]).float()
            return mlp

        def attention():
            q4, k4, v4 = (t.view(batch, seq, heads, -1).transpose(1, 2)
                          for t in o["qkv"])
            return f.scaled_dot_product_attention(q4, k4, v4, scale=1.0)
        if name == "attention_core":
            return attention

        def oproj():
            a = attention().transpose(1, 2).reshape(-1, width)
            return x2 + torch.addmm(o["b"][3].float(), a, lib_w[3])
        return oproj

    act32, act16 = rows * width * 4, rows * width * 2
    attn_ops = 4 * batch * seq * seq * width
    proj_ops = 2 * rows * width * width

    def bound_of(name, act, vec):
        a = act32 if act == f32 else act16
        vb = 4 if vec == f32 else 2
        # fp32: the attention's dots as exact bf16-plane products
        attn = (attn_ops * (F32_PLANE_PRODUCTS if act == f32 else 1),
                BF16_FLOP_PER_S)
        if name == "fused_ln_qkv":
            return bound(4 * a + 3 * width * width * 2 + 5 * width * vb,
                         3 * proj_ops, BF16_FLOP_PER_S)
        if name == "attention_core_oproj":
            # fp32: the out-projection as the three exact bf16-plane
            # products over the attention output's planes
            planes = 3 if act == f32 else 1
            return bound_mixed(5 * a + width * width * 2 + width * vb,
                               [attn, (planes * proj_ops, BF16_FLOP_PER_S)])
        if name == "fused_mlp_block":
            return bound(2 * a + 2 * width * d_ff * 2
                         + (3 * width + d_ff) * vb,
                         4 * rows * width * d_ff, BF16_FLOP_PER_S)
        return bound_mixed(4 * a, [attn])

    results, line = {}, {}
    for name in ("fused_ln_qkv", "attention_core_oproj", "fused_mlp_block",
                 "attention_core", "attention_core_fast_exp"):
        base = name.removesuffix("_fast_exp")
        kw = {"fast_exp": True} if name != base else {}
        fn, plain = globals()[base], globals()[base + "_plain"]
        bf16_args = args_of(base, bf16_form)
        for form, dtypes in forms.items():
            if base == "attention_core" and form != "f32":
                continue                 # no parameters: the f32 form only
            o = operands(*dtypes)
            args = args_of(base, o)
            what = f"{name} ({form})"
            if dtypes[0] == bf:
                errs = check_against_plain(what, lambda *a: fn(*a, **kw),
                                           lambda *a: plain(*a, **kw), args,
                                           batch)
            else:
                got = fn(*args, **kw)
                torch.cuda.synchronize()
                want = plain(*args, **kw)
                flip = (vit_fast_exp_flip_bound(*o["qkv"], heads) if kw
                        else None)
                errs = {}
                for g, w in zip(*(t if isinstance(t, tuple) else (t,)
                                  for t in (got, want))):
                    # of q, k and v: the largest errors, the smallest share
                    for key, val in vit_f32_rule(what, g, w, flip).items():
                        pick = min if key == "within_fp32_tol_share" else max
                        errs[key] = pick(errs.get(key, val), val)
                del got, want, flip
                torch.cuda.empty_cache()
            per_call = launched(fn, lambda: fn(*args, **kw))
            check(per_call == 1, f"{what}: {per_call} launches a call")
            iters = 5 if base.startswith("attention") else 10
            turns = [cuda_ms(call, iters=iters) for call in (
                lambda: fn(*bf16_args, **kw), lambda: fn(*args, **kw),
                lambda: fn(*args, **kw), lambda: fn(*bf16_args, **kw))]
            row = dict(
                shape=dict(B=batch, L=seq, D=width, H=heads, F=d_ff),
                dtypes=[str(t).removeprefix("torch.") for t in dtypes],
                **errs, launches_per_call=per_call,
                ms=(turns[1] + turns[2]) / 2,
                bf16_form_ms=(turns[0] + turns[3]) / 2,
                turns_ms=dict(bf16_form=turns[0::3], form=turns[1:3]),
                **bound_of(base, *dtypes[:2]))
            if dtypes[2] == f32 and base != "attention_core":
                weights = [t for t in args
                           if torch.is_tensor(t) and t.dim() == 2]
                row["weight_casts_ms"] = cuda_ms(
                    lambda: [port_fab._bf16_weight(w) for w in weights],
                    iters=10)
                row["ms_note"] = "the wrapper's weight casts included"
            if form == "f32":
                row["plain_ms"] = cuda_ms(lambda: plain(*args, **kw),
                                          iters=2, warmup=1)
                row["library_ms"] = cuda_ms(library(base, o), iters=iters)
                if base == "attention_core":
                    row.update(vit_f32_routes(o["qkv"], heads, kw, name))
                line[name.replace("_fast_exp", "_f32_fast_exp")
                     if kw else base + "_f32"] = row
            results[f"{name} ({form})"] = row
            emit("vit_kernels_f32", kernel=name, form=form,
                 kernel_ms=row["ms"],
                 **{key: val for key, val in row.items() if key != "ms"})
            del o, args
            torch.cuda.empty_cache()
    return line


def phase_clip_encode_fp32(gen: torch.Generator) -> dict:
    """ClipImageEncoder at ViT-L/14@336 on CLIP_BATCH images with fp32
    parameters (param_dtype=float32): bf16 activations (the cfg's dtype)
    and fp32 ones (dtype=float32), each under fused_block against the
    default path of the same dtypes (encode_paths: 24 launches a call of
    each split3 kernel, per-row cosines); and with fp32 activations at
    SPLIT_FE_LAYERS layers, split, split_fe and fused_attention (the
    attention_core kernel) against the default path at that depth."""
    dev = gen.device
    cfg = clip_lib.CLIPVisionConfig.vit_l_14_336()
    params = clip_lib.init_clip_vision_params(gen, cfg, torch.float32)
    images = torch.randn((CLIP_BATCH, cfg.image_size, cfg.image_size, 3),
                         generator=gen, device=dev)
    results = {}
    for case, path_cfg in (
            ("params_f32", cfg),
            ("f32", dataclasses.replace(cfg, dtype=torch.float32))):
        encoders = {
            name: ClipImageEncoder(
                dataclasses.replace(path_cfg, fused_block=fused), params,
                batch_size=CLIP_BATCH, param_dtype=torch.float32,
                device=dev)
            for name, fused in (("default", False), ("fused", True))}
        results[case] = encode_paths(
            f"clip_encode_fp32_{case}", encoders,
            {"default": (), "fused": VIT_KERNELS}, images, cfg.num_layers)
        del encoders
        torch.cuda.empty_cache()
    n = SPLIT_FE_LAYERS
    depth = dataclasses.replace(cfg, dtype=torch.float32, num_layers=n)
    runs = phase_clip_variants(
        gen, depth, params, images, "clip_fp32_variants",
        ("default", depth, launches()),
        {"split": (dataclasses.replace(depth, fused_block=True,
                                       fused_block_long="split"),
                   launches(attention_core=n, fused_mlp_block=n)),
         "split_fe": (dataclasses.replace(depth, fused_block=True,
                                          fused_block_long="split_fe"),
                      launches(attention_core=n, fused_mlp_block=n)),
         "fused_attention": (dataclasses.replace(depth, fused_attention=True),
                             launches(attention_core=n))})
    results["fused_attention"] = dict(
        launches_per_call=[runs["fused_attention"]["launches"]])
    del params, images
    torch.cuda.empty_cache()
    return results


def phase_vit_whole_kernels_f32(gen: torch.Generator) -> dict:
    """The fp32 forms of the whole-block kernels and of flash_attention
    against their plain versions on VIT_CHECK_BATCH images and at the main
    shapes, timed there by CUDA events in turns with the bf16 form, beside
    the plain version, the bound and one library call of the same dtypes
    (TF32 off): fused_vit_block and fused_attention_block at ViT-B/32
    widths on B32_BATCH images (one layer of the tower's init, random
    LayerNorm parameters and biases; the forms of fp32 x with fp32 or bf16
    parameters and of bf16 x with fp32 ones), flash_attention at ViT-L/14@336
    on CLIP_BATCH images; also, on VIT_CHECK_BATCH images at ViT-L/14@336's
    577 tokens, fused_vit_block's whole_dd order and fused_attention_block
    past 128 tokens (its attention on attention_f32.cuh). fused_vit_block
    by vit_f32_rule's relative Frobenius rule, the other two within
    FP32_ATOL (1 + |want|); bf16 outputs by check_against_plain's rule."""
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on: the plain versions must multiply in fp32")
    dev = gen.device
    f32, bf = torch.float32, torch.bfloat16
    f = torch.nn.functional

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev).mul_(scale)

    def layer_of(cfg):
        layer = {name: leaf[0] for name, leaf in
                 clip_lib.init_clip_vision_params(gen, cfg, f32)[
                     "blocks"].items()}
        for name, leaf in layer.items():
            if name.endswith(("bias", "scale")):
                base = 1.0 if name.endswith("scale") else 0.0
                layer[name] = base + randn(*leaf.shape, scale=0.1)
        return layer

    def cast(layer, vec, mat):
        return {name: t.to(vec if name.endswith(("bias", "scale")) else mat)
                for name, t in layer.items()}

    b32 = clip_lib.CLIPVisionConfig.vit_b_32(num_layers=1)
    seq, width, heads = b32.seq_len, b32.width, b32.num_heads
    head_dim, d_ff, eps = width // heads, b32.mlp_ratio * width, \
        b32.layer_norm_epsilon
    layer = layer_of(b32)
    x = randn(B32_BATCH, seq, width)
    rows = B32_BATCH * seq
    long_cfg = clip_lib.CLIPVisionConfig.vit_l_14_336(num_layers=1)
    long_layer = layer_of(long_cfg)
    long_x = randn(VIT_CHECK_BATCH, long_cfg.seq_len, long_cfg.width)

    def block_args(x_, layer_, heads_):
        return (x_, *(layer_[n] for n in VIT_BLOCK_KEYS), heads_)

    def attn_args(x_, layer_, heads_):
        return (x_, *(layer_[n] for n in ("q", "q_bias", "k", "k_bias", "v",
                                          "v_bias", "o", "o_bias")), heads_)

    # yardsticks only: PyTorch calls of the same dtypes, operands made
    # before the timing
    def lib_block(o):
        # fp32 layer_norm, bf16 addmm widened, bf16 SDPA, quickGELU
        x2 = o[0].reshape(-1, width).float()
        vec = {n: o[1 + i].float() for i, n in enumerate(VIT_BLOCK_KEYS)
               if n.endswith(("bias", "scale"))}
        wb = {n: o[1 + i].bfloat16() for i, n in enumerate(VIT_BLOCK_KEYS)
              if not n.endswith(("bias", "scale"))}
        w_qkv = torch.cat([wb["q"], wb["k"], wb["v"]], dim=1)
        b_qkv = torch.cat([vec["q_bias"], vec["k_bias"], vec["v_bias"]])

        def run():
            h = f.layer_norm(x2, (width,), vec["ln1_scale"], vec["ln1_bias"],
                             eps).bfloat16()
            qkv = (torch.mm(h, w_qkv).float() + b_qkv).bfloat16().view(
                B32_BATCH, seq, 3, heads, head_dim)
            a = f.scaled_dot_product_attention(*qkv.permute(2, 0, 3, 1, 4))
            r1 = x2 + torch.mm(a.transpose(1, 2).reshape(-1, width),
                               wb["o"]).float() + vec["o_bias"]
            z = torch.mm(f.layer_norm(r1, (width,), vec["ln2_scale"],
                                      vec["ln2_bias"], eps).bfloat16(),
                         wb["mlp_fc"]).float() + vec["mlp_fc_bias"]
            hid = (z * torch.sigmoid(1.702 * z)).bfloat16()
            return r1 + torch.mm(hid, wb["mlp_proj"]).float() \
                + vec["mlp_proj_bias"]
        return run

    def lib_attention(o):
        # fp32 addmm (TF32 off) and fp32 SDPA on fp32 copies
        x2 = o[0].reshape(-1, width).float()
        w = [o[i].float() for i in (1, 3, 5, 7)]
        b = [o[i].float() for i in (2, 4, 6, 8)]
        w_qkv, b_qkv = torch.cat(w[:3], dim=1), torch.cat(b[:3])

        def run():
            qkv = torch.addmm(b_qkv, x2, w_qkv).view(B32_BATCH, seq, 3,
                                                     heads, head_dim)
            a = f.scaled_dot_product_attention(*qkv.permute(2, 0, 3, 1, 4))
            return torch.addmm(b[3], a.transpose(1, 2).reshape(-1, width),
                               w[3])
        return run

    vec_n = 4 * width + 4 * width + d_ff + width
    weights = 4 * width * width + 2 * width * d_ff
    attention_flops = 4 * B32_BATCH * seq * seq * width

    def block_bound(act, vec):
        a = 4 if act == f32 else 2
        return bound_mixed(2 * rows * width * a + weights * 2
                           + vec_n * (4 if vec == f32 else 2),
                           [(2 * rows * weights + attention_flops,
                             BF16_FLOP_PER_S)])

    def attention_bound(act, mat, batch=B32_BATCH, length=seq, dim=width):
        # the projections as the plane products on the tensor cores (six a
        # product of fp32 operands, three of fp32 and bf16, one of bf16),
        # the fp32 attention's dots as six bf16-plane products each; the
        # function's fp32 products on fp32 FMAs beside it
        products = (6 if act == f32 and mat == f32 else
                    3 if f32 in (act, mat) else 1)
        planes_out = 6 if mat == f32 else 3
        a, m = (4 if act == f32 else 2), (4 if mat == f32 else 2)
        n = batch * length
        proj = 2 * n * 4 * dim * dim
        attn = 4 * batch * length * length * dim
        res = bound_mixed(2 * n * dim * a + 4 * dim * dim * m + 4 * dim * m,
                          [(products * 3 * proj / 4, BF16_FLOP_PER_S),
                           (F32_PLANE_PRODUCTS * attn, BF16_FLOP_PER_S),
                           (planes_out * proj / 4, BF16_FLOP_PER_S)])
        res["fp32_fma_bound_ms"] = (proj + attn) / FP32_FLOP_PER_S * 1e3
        return res

    cases = {}
    # name -> (wrapper, plain, args of (form, batch), forms, bound, library)
    block_forms = {"f32_params_f32": (f32, f32, f32), "f32": (f32, bf, bf),
                   "bf16_params_f32": (bf, f32, f32)}
    cases["fused_vit_block"] = dict(
        fn=lambda *a: fused_vit_block(*a, group=4),
        plain=fused_vit_block_plain,
        args=lambda dtypes, n: block_args(
            x[:n].to(dtypes[0]), cast(layer, *dtypes[1:]), heads),
        forms=block_forms, bound=lambda d: block_bound(d[0], d[1]),
        library=lambda o: lib_block(o),
        library_name="the unfused block of the same dtypes: fp32 "
                     "layer_norm, bf16 mm widened, bf16 SDPA, quickGELU")
    attn_forms = {"f32": (f32, f32, f32), "f32_x_bf16_weights": (f32, bf, bf),
                  "bf16_x_f32_weights": (bf, f32, f32)}
    cases["fused_attention_block"] = dict(
        fn=lambda *a: fused_attention_block(*a, group=4, block_diag=True),
        plain=lambda *a: fused_attention_block_plain(*a, block_diag=True),
        args=lambda dtypes, n: attn_args(
            x[:n].to(dtypes[0]), cast(layer, *dtypes[1:]), heads),
        forms=attn_forms, bound=lambda d: attention_bound(d[0], d[2]),
        library=lambda o: lib_attention(o),
        library_name="fp32 addmm (TF32 off) and fp32 "
                     "scaled_dot_product_attention")
    vit_l = clip_lib.CLIPVisionConfig.vit_l_14_336()
    l_heads, l_dh = vit_l.num_heads, vit_l.width // vit_l.num_heads
    qkv = [randn(CLIP_BATCH, vit_l.seq_len, l_heads, l_dh, scale=s)
           for s in (l_dh ** -0.5, 1.0, 1.0)]
    l_ops = 4 * CLIP_BATCH * vit_l.seq_len ** 2 * vit_l.width

    def lib_flash(o):
        q4, k4, v4 = (t.float().transpose(1, 2).contiguous() for t in o)
        return lambda: f.scaled_dot_product_attention(q4, k4, v4, scale=1.0)

    cases["flash_attention"] = dict(
        fn=flash_attention, plain=flash_attention_plain,
        args=lambda dtypes, n: tuple(t[:n].to(dtypes[0]) for t in qkv),
        forms={"f32": (f32,)},
        bound=lambda d: dict(
            bound(4 * qkv[0].numel() * 4, F32_PLANE_PRODUCTS * l_ops,
                  BF16_FLOP_PER_S),
            # this route: q·kᵀ on whole tiles at the fp32 rate, E·V as six
            # bf16-plane products (csrc/attention_f32.cuh's KS form)
            route_bound_ms=bound_mixed(0, [
                (l_ops / 2 * (640 / 577) ** 2, FP32_FLOP_PER_S),
                (3 * l_ops * (640 / 577) ** 2, BF16_FLOP_PER_S)])["bound_ms"]),
        library=lambda o: lib_flash(o),
        library_name="fp32 scaled_dot_product_attention (TF32 off), scale 1, "
                     "on (B, H, L, dh) copies")

    line, results = {}, {}
    for name, case in cases.items():
        main_batch = CLIP_BATCH if name == "flash_attention" else B32_BATCH
        bf16_args = case["args"]((bf, bf, bf)[:len(
            next(iter(case["forms"].values())))], main_batch)
        for form, dtypes in case["forms"].items():
            what = f"{name} ({form})"
            errs = {}
            for n in (VIT_CHECK_BATCH, main_batch):
                args = case["args"](dtypes, n)
                if dtypes[0] == bf:
                    got = check_against_plain(what, case["fn"], case["plain"],
                                              args, n)
                elif name == "fused_vit_block":
                    out = case["fn"](*args)
                    base = case["fn"](args[0].bfloat16(), *args[1:])
                    torch.cuda.synchronize()
                    got = vit_block_f32_rule(what, out, case["plain"](*args),
                                             base)
                    del out, base
                else:
                    out = case["fn"](*args)
                    torch.cuda.synchronize()
                    got = vit_f32_rule(what, out, case["plain"](*args))
                    del out
                errs.update({(key if n == main_batch else
                              f"b{VIT_CHECK_BATCH}_{key}"): val
                             for key, val in got.items()})
                torch.cuda.empty_cache()
            per_call = launched(globals()[name], lambda: case["fn"](*args))
            check(per_call == 1, f"{what}: {per_call} launches a call")
            iters = 5 if name == "flash_attention" else 10
            first = form == next(iter(case["forms"]))
            # flash_attention: fp32 SDPA in the turns too (row 16 fp32's
            # yardstick at ViT-L/14@336's 577 keys)
            lib = [case["library"](args)] * 2 \
                if first and name == "flash_attention" else []
            turns = [cuda_ms(call, iters=iters) for call in (
                lambda: case["fn"](*bf16_args), lambda: case["fn"](*args),
                *lib, lambda: case["fn"](*args),
                lambda: case["fn"](*bf16_args))]
            row = dict(
                dtypes=[str(t).removeprefix("torch.") for t in dtypes],
                **errs, launches_per_call=per_call,
                ms=(turns[1] + turns[-2]) / 2,
                bf16_form_ms=(turns[0] + turns[-1]) / 2,
                turns_ms=dict(bf16_form=turns[0::len(turns) - 1],
                              form=[turns[1], turns[-2]],
                              **({"library": turns[2:4]} if lib else {})),
                **case["bound"](dtypes))
            if first:
                row["plain_ms"] = cuda_ms(lambda: case["plain"](*args),
                                          iters=2, warmup=1)
                row["library_ms"] = ((turns[2] + turns[3]) / 2 if lib else
                                     cuda_ms(case["library"](args),
                                             iters=iters))
                row["library"] = case["library_name"]
                line[name + "_f32"] = row
            results[what] = row
            emit("vit_whole_kernels_f32", kernel=name, form=form,
                 batch=main_batch, kernel_ms=row["ms"],
                 **{key: val for key, val in row.items() if key != "ms"})
            del args
            torch.cuda.empty_cache()
        del bf16_args
    del qkv
    torch.cuda.empty_cache()

    # past 128 tokens: ViT-L/14@336's 577 on VIT_CHECK_BATCH images, fp32
    # x and parameters
    long_f32 = cast(long_layer, f32, f32)
    for name, fn, plain, args, extra in (
            ("fused_vit_block whole_dd", lambda *a: fused_vit_block(
                *a, group=1, deferred_div=True),
             lambda *a: fused_vit_block_plain(*a, deferred_div=True),
             block_args(long_x, long_f32, l_heads), {}),
            (f"fused_attention_block {vit_l.seq_len} tokens", lambda *a:
             fused_attention_block(*a, group=1, block_diag=True),
             lambda *a: fused_attention_block_plain(*a, block_diag=True),
             attn_args(long_x, long_f32, l_heads),
             attention_bound(f32, f32, VIT_CHECK_BATCH, vit_l.seq_len,
                             vit_l.width))):
        out = fn(*args)
        torch.cuda.synchronize()
        want = plain(*args)
        emit("vit_whole_kernels_f32_long", kernel=name,
             batch=VIT_CHECK_BATCH, seq=vit_l.seq_len,
             kernel_ms=cuda_ms(lambda: fn(*args), iters=5), **extra,
             **(vit_block_f32_rule(name, out, want, fn(
                 args[0].bfloat16(), *args[1:]))
                if name.startswith("fused_vit_block")
                else vit_f32_rule(name, out, want)))
        del out, want
    torch.cuda.empty_cache()
    return line


def phase_clip_encode_b32_fp32(gen: torch.Generator) -> dict:
    """ClipImageEncoder at ViT-B/32 (12 layers) on B32_BATCH images with
    fp32 parameters and activations: the default path, fused_block
    (fused_vit_block), fused_attention (fused_attention_block) and
    use_pallas (flash_attention) on the same weights and images
    (encode_paths, per-row cosine to the default path >= F32_COSINE_FLOOR);
    then ViT-L/14@336 in fp32 at SPLIT_FE_LAYERS layers, whole, whole_dd
    and use_pallas against the default path at that depth."""
    dev = gen.device
    f32 = torch.float32
    cfg = clip_lib.CLIPVisionConfig.vit_b_32(dtype=f32)
    params = clip_lib.init_clip_vision_params(gen, cfg, f32)
    encoders = {
        name: ClipImageEncoder(path_cfg, params, batch_size=B32_BATCH,
                               param_dtype=f32, use_pallas=pallas,
                               device=dev)
        for name, path_cfg, pallas in (
            ("default", cfg, False),
            ("fused", dataclasses.replace(cfg, fused_block=True), False),
            ("fused_attention", dataclasses.replace(cfg, fused_attention=True),
             False),
            ("use_pallas", cfg, True))}
    images = torch.randn((B32_BATCH, cfg.image_size, cfg.image_size, 3),
                         generator=gen, device=dev)
    results = encode_paths(
        "clip_encode_b32_fp32", encoders,
        {"default": (), "fused": (fused_vit_block,),
         "fused_attention": (fused_attention_block,),
         "use_pallas": (flash_attention,)},
        images, cfg.num_layers, floor=F32_COSINE_FLOOR)
    del encoders, params, images
    torch.cuda.empty_cache()

    n = SPLIT_FE_LAYERS
    depth = clip_lib.CLIPVisionConfig.vit_l_14_336(dtype=f32, num_layers=n)
    params = clip_lib.init_clip_vision_params(gen, depth, f32)
    images = torch.randn((CLIP_BATCH, depth.image_size, depth.image_size, 3),
                         generator=gen, device=dev)
    runs = phase_clip_variants(
        gen, depth, params, images, "clip_fp32_whole",
        ("default", depth, launches()),
        {name: (dataclasses.replace(depth, fused_block=True,
                                    fused_block_long=name),
                launches(fused_vit_block=n))
         for name in ("whole", "whole_dd")}
        | {"use_pallas": (depth, launches(flash_attention=n), True)},
        floor=F32_COSINE_FLOOR)
    results["vit_l_fp32"] = {name: run["launches"]
                             for name, run in runs.items()}
    del params, images
    torch.cuda.empty_cache()
    return results


def phase_clip_encode_int8_fp32(gen: torch.Generator) -> dict:
    """ClipImageEncoder(int8=True) with fp32 parameters (param_dtype=
    float32), with bf16 activations (the cfg's dtype) and with fp32 ones
    (dtype=float32): at ViT-L/14@336 on CLIP_BATCH images (24 launches a
    call of each of fused_qkv_q8, attention_core and fused_mlp_block_q8,
    their fp32 forms with fp32 x) and at ViT-B/32 on B32_BATCH images (12
    of fused_vit_block_q8), each against the unquantized default path of
    the same dtypes on the same weights and images (encode_paths: per-row
    cosines at least CLIP_COSINE_FLOOR)."""
    dev = gen.device
    f32 = torch.float32
    results = {}
    for tower, cfg, batch, path_kernels in (
            ("vit_l", clip_lib.CLIPVisionConfig.vit_l_14_336(), CLIP_BATCH,
             VIT_Q8_KERNELS),
            ("b32", clip_lib.CLIPVisionConfig.vit_b_32(), B32_BATCH,
             (fused_vit_block_q8,))):
        params = clip_lib.init_clip_vision_params(gen, cfg, f32)
        images = torch.randn((batch, cfg.image_size, cfg.image_size, 3),
                             generator=gen, device=dev)
        for case, path_cfg in (("params_f32", cfg),
                               ("f32", dataclasses.replace(cfg, dtype=f32))):
            encoders = {
                name: ClipImageEncoder(path_cfg, params, batch_size=batch,
                                       param_dtype=f32, int8=int8,
                                       device=dev)
                for name, int8 in (("default", False), ("int8", True))}
            results[f"{tower}_{case}"] = encode_paths(
                f"clip_encode_int8_fp32_{tower}_{case}", encoders,
                {"default": (), "int8": path_kernels}, images,
                cfg.num_layers)
            del encoders
            torch.cuda.empty_cache()
        del params, images
        torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# Mapper training: VC-T0 on Conceptual Captions, and ClipCap's step
# ---------------------------------------------------------------------------

CC_CONFIG_FILE = (REPO / "configs" / "conceptual_captions"
                  / "conceptual_captions.jsonnet")
TRAIN_BATCH = 32                   # conceptual_captions.jsonnet's batch_size
CAPTION_LEN = 32                   # its max_target_length
TRAIN_STEPS = 3                    # timed steps of each route, in turns
DESCENT_STEPS = 5                  # AdamW steps on one batch: the loss falls
TRAIN_LR = 1e-4                    # the shipped train.lr
# the kernels' route (their forwards, the twins' backwards) against the
# unfused route: the loss relative, the mapper gradient's cosine and norm
TRAIN_LOSS_REL = 2e-2
TRAIN_GRAD_COSINE = 0.999
TRAIN_GRAD_NORM_REL = 2e-2
CC_TRAIN_ROWS, CC_VAL_ROWS = 128, 64   # 4 train steps, 2 val batches
CC_WORDS = ("a", "the", "dog", "cat", "man", "woman", "car", "tree", "red",
            "small", "sits", "runs", "on", "in", "grass", "street", "beach",
            "house", "with", "ball", "photo", "of", "at", "night")


def caption_batch(gen: torch.Generator, batch: int, vocab: int):
    """(CLIP embeddings (B, PREFIX_SIZE), labels (B, CAPTION_LEN)): caption
    ids in [2, vocab), each row's tail past a random length of at least
    half the row on -100, as the loader pads."""
    dev = gen.device
    clip = torch.randn((batch, PREFIX_SIZE), generator=gen, device=dev)
    labels = torch.randint(2, vocab, (batch, CAPTION_LEN), generator=gen,
                           device=dev)
    lengths = torch.randint(CAPTION_LEN // 2, CAPTION_LEN + 1, (batch,),
                            generator=gen, device=dev)
    pad = torch.arange(CAPTION_LEN, device=dev)[None] >= lengths[:, None]
    return clip, labels.masked_fill(pad, -100)


def trainable_copy(mapper: dict) -> dict:
    return {name: {key: value.detach().clone().requires_grad_()
                   for key, value in layer.items()}
            for name, layer in mapper.items()}


def flat_grad(mapper: dict) -> torch.Tensor:
    return torch.cat([t.grad.float().flatten() for t in tree_leaves(mapper)])


def kernel_counts() -> dict:
    return {fn.__name__: fn.launches for fn in PATH_KERNELS}


def launched_only(counts: dict) -> dict:
    """The kernels of ``counts`` that launched (for the output lines)."""
    return {name: n for name, n in counts.items() if n}


def zero_counts() -> None:
    for fn in PATH_KERNELS:
        fn.launches = 0


def grad_step(loss_fn, mapper: dict, expected: dict, what: str) -> tuple:
    """loss_fn(mapper) and its backward with every count set to 0 just
    before: the forward launches ``expected``, the backward none. Returns
    (loss, the mapper's flat gradient)."""
    torch.cuda.synchronize()
    zero_counts()
    loss = loss_fn(mapper)
    torch.cuda.synchronize()
    forward = kernel_counts()
    check(forward == expected,
          f"{what}: the forward launched {forward}, expected {expected}")
    loss.backward()
    torch.cuda.synchronize()
    check(kernel_counts() == forward,
          f"{what}: the backward launched {kernel_counts()} - {forward}")
    check(bool(torch.isfinite(loss)), f"{what}: loss {loss.item()}")
    return loss.item(), flat_grad(mapper)


def compare_grads(what: str, losses: dict, grads: dict, rel_limit: float,
                  a: str = "fused", b: str = "unfused") -> dict:
    rel = abs(losses[a] - losses[b]) / abs(losses[b])
    # in float64: an fp32 cosine of the 218 M mapper gradients strays past 1
    ga, gb = grads[a].double(), grads[b].double()
    cos = float(torch.nn.functional.cosine_similarity(ga, gb, dim=0))
    norm_ratio = float(ga.norm() / gb.norm())
    check(rel <= rel_limit, f"{what}: loss {losses[a]} against {losses[b]}, "
          f"rel {rel} > {rel_limit}")
    check(cos >= TRAIN_GRAD_COSINE, f"{what}: mapper gradient cosine {cos} "
          f"< {TRAIN_GRAD_COSINE}")
    check(abs(norm_ratio - 1) <= TRAIN_GRAD_NORM_REL,
          f"{what}: mapper gradient norm ratio {norm_ratio}")
    return dict(losses=losses, loss_rel_diff=rel, grad_cosine=cos,
                grad_norm_ratio=norm_ratio)


def timed_train_steps(routes: dict, steps: int) -> dict:
    """``steps`` steps of each route in turns (a, b, b, a, ...): each route
    ``name -> (loss_fn, mapper, optimizer, expected launches)``. A step is
    split at synchronizes into forward, backward and optimizer; its
    launches are checked; the first step of each is the warm one."""
    names = list(routes)
    out = {name: dict(step_s=[], forward_s=[], backward_s=[],
                      optimizer_s=[], losses=[], peak_bytes=0)
           for name in names}
    for step in range(steps):
        for name in (names if step % 2 == 0 else names[::-1]):
            loss_fn, mapper, optimizer, expected = routes[name]
            rec = out[name]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_counts()
            t0 = time.perf_counter()
            loss = loss_fn(mapper)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            loss.backward()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            optimizer.step()
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            check(kernel_counts() == expected,
                  f"train step {name}: launched {kernel_counts()}, "
                  f"expected {expected}")
            rec["forward_s"].append(t1 - t0)
            rec["backward_s"].append(t2 - t1)
            rec["optimizer_s"].append(t3 - t2)
            rec["step_s"].append(t3 - t0)
            rec["losses"].append(loss.item())
            rec["peak_bytes"] = max(rec["peak_bytes"],
                                    torch.cuda.max_memory_allocated())
    for name, rec in out.items():
        warm = rec["step_s"][1:] or rec["step_s"]
        rec["mean_step_s"] = sum(warm) / len(warm)
        rec["examples_per_s"] = TRAIN_BATCH / rec["mean_step_s"]
        rec["peak_mem_gb"] = rec.pop("peak_bytes") / 1e9
    return out


def vct0_train_setup(dev: torch.device) -> tuple:
    """T0-3B with the mlp mapper (768 -> 10 x 2048), random weights from
    SEED; its configs for the kernels' route (the encoder's attention and
    FFN kernels), the unfused route and the kernels' route under remat."""
    lm_cfg = t5_lib.T5Config.t0_3b()
    mapper = MapperConfig(mapping_type="mlp", prefix_size=PREFIX_SIZE,
                          d_model=lm_cfg.d_model, prefix_length=PREFIX_LENGTH,
                          clip_length=PREFIX_LENGTH)
    fused = dataclasses.replace(lm_cfg, fused_encoder_attention=True,
                                fused_encoder_ffn=True)
    cfgs = {"fused": VCT0Config(lm=fused, mapper=mapper),
            "unfused": VCT0Config(lm=lm_cfg, mapper=mapper),
            "fused_remat": VCT0Config(
                lm=dataclasses.replace(fused, remat=True), mapper=mapper)}
    params = init_vct0_params(cfgs["fused"], seed=SEED, device=dev)
    return cfgs, params


def adamw(mapper: dict) -> MultiStepAdamW:
    return MultiStepAdamW(tree_leaves(mapper), lambda step: TRAIN_LR,
                          eps=1e-8)


def phase_train_step(dev: torch.device, smi: str) -> dict:
    """The captioning train step at T0-3B width and depth, B = TRAIN_BATCH,
    CAPTION_LEN-token captions, PREFIX_LENGTH prefix positions, on one
    fixed batch: the kernels' route against the unfused one (losses,
    mapper gradients), launches per step (24 each of t5_attention_core and
    fused_t5_ffn in the forward, none in the backward; 48 under remat, the
    same loss and gradient), the raw wrappers refusing a grad-requiring
    input; TRAIN_STEPS timed steps of each route in turns with the
    forward / backward / optimizer split and peak memory; the loss falling
    over DESCENT_STEPS AdamW steps; the device's busy share and largest
    kernels traced in a process of its own."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    cfgs, params = vct0_train_setup(dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    lm = params["lm"]
    layers = cfgs["fused"].lm.num_encoder_layers
    clip, labels = caption_batch(gen, TRAIN_BATCH,
                                 min(30000, cfgs["fused"].lm.vocab_size))

    def loss_of(cfg):
        return lambda mapper: vct0_caption_loss(mapper, lm, cfg, clip, labels)

    expected = {
        "fused": launches(t5_attention_core=layers, fused_t5_ffn=layers),
        "unfused": launches(),
        "fused_remat": launches(t5_attention_core=layers,
                                fused_t5_ffn=layers)}
    losses, grads = {}, {}
    for name in ("fused", "unfused"):
        mapper = trainable_copy(params["mapper"])
        losses[name], grads[name] = grad_step(loss_of(cfgs[name]), mapper,
                                              expected[name],
                                              f"train_step {name}")
        del mapper
    routes = compare_grads("train_step", losses, grads, TRAIN_LOSS_REL)

    # remat: the layers' forwards again in the backward, kernels included
    mapper = trainable_copy(params["mapper"])
    torch.cuda.synchronize()
    zero_counts()
    loss = loss_of(cfgs["fused_remat"])(mapper)
    loss.backward()
    torch.cuda.synchronize()
    remat_counts = kernel_counts()
    want = launches(t5_attention_core=2 * layers, fused_t5_ffn=2 * layers)
    check(remat_counts == want,
          f"train_step remat: launched {remat_counts}, expected {want}")
    remat_cos = float(torch.nn.functional.cosine_similarity(
        flat_grad(mapper), grads["fused"], dim=0))
    check(loss.item() == losses["fused"] and remat_cos >= TRAIN_GRAD_COSINE,
          f"train_step remat: loss {loss.item()} against {losses['fused']}, "
          f"gradient cosine {remat_cos}")
    del mapper, loss, grads

    # the raw wrappers: a grad-requiring input on the card raises
    width = cfgs["fused"].lm.num_heads * cfgs["fused"].lm.d_kv
    q = torch.randn((2, 10, width), device=dev).bfloat16().requires_grad_()
    bias = torch.zeros((cfgs["fused"].lm.num_heads, 10, 10), device=dev)
    key_mask = torch.ones((2, 10), dtype=torch.int32, device=dev)
    x = torch.randn((2, 10, cfgs["fused"].lm.d_model),
                    device=dev).bfloat16().requires_grad_()
    ffn = {k: v[0] for k, v in lm["encoder"]["ffn"].items()}
    refused = []
    for name, call in (
            ("t5_attention_core", lambda: t5_attention_core(
                q, q, q, bias, key_mask, cfgs["fused"].lm.num_heads)),
            ("fused_t5_ffn", lambda: fused_t5_ffn(
                x, lm["encoder"]["ln1"][0], ffn["wi_0"], ffn["wi_1"],
                ffn["wo"]))):
        zero_counts()
        try:
            call()
        except NotImplementedError:
            refused.append(name)
        check(kernel_counts() == launches(),
              f"train_step: {name} launched on a grad-requiring input")
    check(refused == ["t5_attention_core", "fused_t5_ffn"],
          f"train_step: only {refused} refused a grad-requiring input")

    # the routes' steps in turns, each on its own mapper and optimizer
    turns = {}
    for name in ("fused", "unfused"):
        mapper = trainable_copy(params["mapper"])
        turns[name] = (loss_of(cfgs[name]), mapper, adamw(mapper),
                       expected[name])
    stepped = timed_train_steps(turns, TRAIN_STEPS)
    del turns
    torch.cuda.empty_cache()

    # DESCENT_STEPS AdamW steps on the kernels' route
    mapper = trainable_copy(params["mapper"])
    optimizer = adamw(mapper)
    descent = []
    for _ in range(DESCENT_STEPS):
        loss = loss_of(cfgs["fused"])(mapper)
        loss.backward()
        optimizer.step()
        descent.append(loss.item())
    check(descent[-1] < descent[0],
          f"train_step: the loss did not fall over {DESCENT_STEPS} AdamW "
          f"steps: {descent}")
    del mapper, optimizer, params, lm
    gc.collect()
    torch.cuda.empty_cache()
    busy = traced_in_child("--trace-train-step",
                           stepped["fused"]["mean_step_s"])
    result = dict(
        batch=TRAIN_BATCH, caption_len=CAPTION_LEN,
        encoder_positions=PREFIX_LENGTH, init_s=init_s, nvidia_smi=smi,
        launches_per_step={name: launched_only(expected[name])
                           for name in ("fused", "unfused")},
        remat_launches_per_step=launched_only(remat_counts),
        remat_grad_cosine=remat_cos,
        refused_grad=refused, descent_losses=descent, **routes,
        **stepped, fused_busy=busy)
    emit("train_step", **result)
    result["launches_per_call"] = [expected["fused"]]
    return result


def traced_in_child(flag: str, timed_wall_s: float) -> dict:
    """``chip_smoke.py flag`` in a process of its own (late in a whole run
    a trace can come back with records missing, see cuda_kernel_names):
    the device's busy share over one warm step and its largest kernels."""
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), flag],
        capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"{flag} failed:\n" + proc.stderr[-3000:])
    traced = json.loads(proc.stdout.strip().splitlines()[-1])
    traced["parent_mean_step_s"] = timed_wall_s
    return traced


def trace_train_step() -> None:
    """The child of traced_in_child for train_step: two warm steps of the
    kernels' route, then device_busy over one more."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cfgs, params = vct0_train_setup(dev)
    clip, labels = caption_batch(gen, TRAIN_BATCH,
                                 min(30000, cfgs["fused"].lm.vocab_size))
    mapper = trainable_copy(params["mapper"])
    optimizer = adamw(mapper)

    def step():
        vct0_caption_loss(mapper, params["lm"], cfgs["fused"], clip,
                          labels).backward()
        optimizer.step()

    for _ in range(2):
        _, wall = timed(step)
    print(json.dumps(device_busy(step, wall, top=8)), flush=True)


def cc_rows(n: int, rng: np.random.Generator) -> list:
    """Conceptual Captions rows in the parquet artifacts' schema: 6-12 word
    captions and 768-wide CLIP embeddings, each in a one-element list as
    the reference stores caption and image_url."""
    return [{"image_url": [f"http://img/{i}"],
             "caption": [" ".join(rng.choice(CC_WORDS,
                                             int(rng.integers(6, 13))))],
             "clip_embeddings": rng.standard_normal(PREFIX_SIZE)
             .astype(np.float32).tolist()} for i in range(n)]


class TrainRecorder:
    """For one main.run of ``executor_cls``: each training step's loss,
    host seconds to a synchronize and the mapper's sum before and after
    it; the first step's batch and a copy of the mapper before it; each
    validation's table rows; every logged metric. Installed for the run
    and taken off after."""

    def __init__(self, executor_cls=VCT0Executor):
        self.executor_cls = executor_cls
        self.steps, self.tables, self.metrics = [], [], {}
        self.first = None

    def __enter__(self):
        cls = self.executor_cls
        self.originals = {name: getattr(owner, name) for owner, name in (
            (cls, "training_step"), (cls, "evaluate_outputs"),
            (BaseExecutor, "log_metrics"))}
        step, evaluate, log = (self.originals[n] for n in (
            "training_step", "evaluate_outputs", "log_metrics"))

        def mapper_sum(executor):
            return float(sum(t.detach().double().sum() for t in
                             tree_leaves(executor.model.params["mapper"])))

        def training_step(executor, batch, batch_idx):
            if self.first is None:
                self.first = dict(batch=batch, mapper=tree_clone(
                    executor.model.params["mapper"]))
            before = mapper_sum(executor)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(executor, batch, batch_idx)
            torch.cuda.synchronize()
            self.steps.append(dict(seconds=time.perf_counter() - t0,
                                   loss=float(out["loss"]), before=before,
                                   after=mapper_sum(executor)))
            return out

        def evaluate_outputs(executor, outputs, mode="test"):
            log_dict = evaluate(executor, outputs, mode)
            self.tables.append(log_dict.artifacts["test_table"]["rows"])
            return log_dict

        def log_metrics(executor, metrics, step=None):
            self.metrics.update(metrics)
            return log(executor, metrics, step)

        cls.training_step = training_step
        cls.evaluate_outputs = evaluate_outputs
        BaseExecutor.log_metrics = log_metrics
        return self

    def __exit__(self, *exc):
        self.executor_cls.training_step = self.originals["training_step"]
        self.executor_cls.evaluate_outputs = self.originals[
            "evaluate_outputs"]
        BaseExecutor.log_metrics = self.originals["log_metrics"]


def tree_clone(tree: dict) -> dict:
    """A detached copy of a nested dict of tensors."""
    return {k: tree_clone(v) if isinstance(v, dict) else v.detach().clone()
            for k, v in tree.items()}


def phase_config_train(smi: str) -> dict:
    """Mapper training as a user runs it: the port's CLI (main.run --mode
    train) on the shipped conceptual_captions.jsonnet at full width (T0_3B,
    mlp mapper, random weights from the config's seed, SimpleTokenizer)
    with tpu.fused_attention and tpu.fused_ffn, one epoch over CC_TRAIN_ROWS
    synthetic rows (4 steps of TRAIN_BATCH) and CC_VAL_ROWS val rows, the
    shipped gradient_accumulation_steps 4 (one applied update). The rows
    go through the shipped parquet loader where pyarrow imports, else
    through the same loader holding them in memory. Checks: the mapper
    unchanged by the first 3 steps and changed by the 4th, model_00 and
    the index written, the validations' captions, exact launches."""
    rng = np.random.default_rng(SEED)
    rows = {"train": cc_rows(CC_TRAIN_ROWS, rng),
            "val": cc_rows(CC_VAL_ROWS, rng)}
    modules = "data_loader.dataset_modules.module_dict.LoadConceptualCaptions"
    with tempfile.TemporaryDirectory() as tmp:
        folder = Path(tmp)
        if importlib.util.find_spec("pyarrow") is not None:
            import pyarrow as pa
            import pyarrow.parquet as pq

            source = "parquet"
            opts = []
            for split, split_rows in rows.items():
                path = folder / f"cc_{split}.parquet"
                pq.write_table(pa.table({key: [r[key] for r in split_rows]
                                         for key in split_rows[0]}), path)
                opts.append(f"{modules}.config.{split}={path}")
        else:
            source = "in_memory"

            class InMemoryConceptualCaptions(DataLoaderConceptualCaptions):
                """The shipped loader, its parquet rows held in memory."""

                def LoadConceptualCaptions(self, module_config):
                    self.data.conceptual_captions = AttrDict(
                        train=ListDataset(rows["train"]),
                        val=ListDataset(rows["val"]))

            if InMemoryConceptualCaptions.__name__ not in DATA_LOADERS:
                DATA_LOADERS.register()(InMemoryConceptualCaptions)
            opts = [f"data_loader.type={InMemoryConceptualCaptions.__name__}"]
        argv = [str(CC_CONFIG_FILE), "--mode", "train", "--experiment_name",
                "train", "--disable_wandb", "--disable_tensorboard",
                "--opts", f"EXPERIMENT_FOLDER={folder}/experiments",
                f"TENSORBOARD_FOLDER={folder}/tb",
                f"cache.default_folder={folder}/cache",
                "model_config.TokenizerClass=SimpleTokenizer",
                "model_config.pretrained=0", "tpu.fused_attention=true",
                "tpu.fused_ffn=true", "train.epochs=1", *opts]
        config = process_config(parse_args_sys(argv))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        with TrainRecorder() as rec:
            executor, metrics = eval_main.run(argv)
        run_s = time.perf_counter() - t0
        counts = kernel_counts()
        peak = torch.cuda.max_memory_allocated()
        check(executor.model.device.type == "cuda",
              f"config_train: the model is on {executor.model.device}")
        saved = Path(config.saved_model_path)
        index = json.loads((saved / "checkpoint_index.json").read_text())
        check(index["epochs"] == ["model_00"] and index["last"] == "model_00"
              and (saved / "model_00" / "trainable_state.pt").is_file(),
              f"config_train: checkpoint index {index}")
        checkpoint = load_checkpoint(str(saved / "model_00"))
        check(checkpoint["opt_state"]["applied"] == 1
              and int(checkpoint["epoch"]) == 0,
              "config_train: model_00 holds another optimizer state")
        checkpoint_gb = sum(t.numel() * t.element_size()
                            for t in tree_leaves(checkpoint["mapper"])
                            + list(checkpoint["opt_state"]["mu"])
                            + list(checkpoint["opt_state"]["nu"])
                            + list(checkpoint["opt_state"]["acc"])) / 1e9
        del checkpoint
    steps = rec.steps
    accumulate = int(config.train.additional.gradient_accumulation_steps)
    check(len(steps) == CC_TRAIN_ROWS // TRAIN_BATCH == accumulate,
          f"config_train: {len(steps)} steps")
    check(all(s["after"] == s["before"] for s in steps[:-1])
          and steps[-1]["after"] != steps[-1]["before"]
          and executor.optimizer.applied == 1,
          "config_train: the mapper changed before the k-th step or not at "
          "it: " + str([(s["before"], s["after"]) for s in steps]))
    check(all(np.isfinite(s["loss"]) for s in steps), "config_train losses")
    val_batches = CC_VAL_ROWS // TRAIN_BATCH
    check(len(rec.tables) == 2 and all(
        len(t) == CC_VAL_ROWS and all(len(r) == 3 for r in t)
        for t in rec.tables), "config_train: the validations' caption "
          "tables")
    layers = executor.model.cfg.lm.num_encoder_layers
    # each step one encode; each val batch two (the loss, then generate)
    encodes = len(steps) + 2 * 2 * val_batches
    want = launches(t5_attention_core=layers * encodes,
                    fused_t5_ffn=layers * encodes)
    check(counts == want,
          f"config_train: kernels launched {counts}, expected {want}")
    result = dict(
        nvidia_smi=smi, data=source, rows=dict(train=CC_TRAIN_ROWS,
                                               val=CC_VAL_ROWS),
        run_s=run_s, step_s=[s["seconds"] for s in steps],
        losses=[s["loss"] for s in steps], launches=launched_only(counts),
        applied_updates=executor.optimizer.applied,
        logged={k: v for k, v in rec.metrics.items()
                if k.startswith(("train/", "valid/"))},
        first_caption=rec.tables[-1][0], checkpoint_gb=checkpoint_gb,
        peak_mem_gb=peak / 1e9)
    emit("config_train", **result)
    del executor
    gc.collect()
    torch.cuda.empty_cache()
    return dict(result, launches_per_call=[counts])


def phase_clipcap_train_step(dev: torch.device) -> dict:
    """ClipCap's train step at GPT-2 small width and depth with the mlp
    mapper (512 -> 10 x 768), B = TRAIN_BATCH, CAPTION_LEN tokens + 10
    prefix positions: fused_block (12 fused_gpt2_block launches in the
    forward, none in the backward) against the unfused block (losses,
    mapper gradients), then TRAIN_STEPS timed steps of each in turns."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    lm_cfg = gpt2_lib.GPT2Config.gpt2_small(fused_block=True)
    cfgs = {"fused": clipcap_lib.ClipCapConfig.from_model_args(
        CLIPCAP_MODEL_ARGS, lm_cfg=lm_cfg)}
    cfgs["unfused"] = dataclasses.replace(cfgs["fused"], lm=dataclasses.replace(
        lm_cfg, fused_block=False))
    params = clipcap_lib.init_clipcap_params(cfgs["fused"], seed=SEED,
                                             device=dev)
    prefix = torch.randn((TRAIN_BATCH, CLIPCAP_MODEL_ARGS["prefix_size"]),
                         generator=gen, device=dev)
    ids, mask, _ = clipcap_batch(gen, CAPTION_LEN)
    labels = ids.masked_fill(mask == 0, -100)

    def loss_of(cfg):
        return lambda mapper: clipcap_lib.clipcap_loss(
            mapper, params["lm"], cfg, prefix, ids, mask, labels)

    expected = {"fused": launches(fused_gpt2_block=lm_cfg.num_layers),
                "unfused": launches()}
    losses, grads = {}, {}
    for name, cfg in cfgs.items():
        mapper = trainable_copy(params["mapper"])
        losses[name], grads[name] = grad_step(
            loss_of(cfg), mapper, expected[name], f"clipcap_train_step {name}")
    routes = compare_grads("clipcap_train_step", losses, grads,
                           CLIPCAP_LOSS_REL)
    turns = {}
    for name, cfg in cfgs.items():
        mapper = trainable_copy(params["mapper"])
        turns[name] = (loss_of(cfg), mapper, adamw(mapper), expected[name])
    timed_steps = timed_train_steps(turns, TRAIN_STEPS)
    result = dict(batch=TRAIN_BATCH, positions=PREFIX_LENGTH + CAPTION_LEN,
                  launches_per_step={name: launched_only(counts)
                                     for name, counts in expected.items()},
                  **routes, **timed_steps)
    emit("clipcap_train_step", **result)
    del turns, params
    torch.cuda.empty_cache()
    return dict(result, launches_per_call=[expected["fused"]])


CLIPCAP_CONFIG_FILE = REPO / "configs" / "vqa2" / "clip_cap.jsonnet"
CLIPCAP_PREFIX_SIZE = 512          # the config's prefix_size (ViT-B/32)
CLIPCAP_TRAIN_QUESTIONS = 256      # 8 steps of 32: 2 updates at the shipped 4
CLIPCAP_VAL_QUESTIONS = 64         # 2 batches
# the fp32 run's buckets: the padded length plus the 10 prefix positions
# stays at 128 or fewer, so gpt2_forward takes fused_gpt2_block
CLIPCAP_FP32_OPTS = ("tpu.compute_dtype=float32", "tpu.length_buckets=[32,64]")
# the run's first loss against clipcap_loss called again on its batch and
# the mapper before it: the same calls on the same inputs
CLIPCAP_DIRECT_LOSS_REL = 1e-5


def clipcap_argv(folder: Path, files: dict, mode: str, *opts) -> list:
    """The port's CLI on the shipped clip_cap.jsonnet pointed at ``files``:
    GPT-2 small with random weights from the config's seed, SimpleTokenizer
    (the card's machine has no transformers), one epoch."""
    vqa = {"question_files": {"train": files["train2014_questions"],
                              "val": files["val2014_questions"]},
           "annotation_files": {"train": files["train2014_annotations"],
                                "val": files["val2014_annotations"]}}
    modules = "data_loader.dataset_modules.module_dict."
    return [
        str(CLIPCAP_CONFIG_FILE), "--mode", mode, "--experiment_name",
        "clipcap", "--disable_wandb", "--disable_tensorboard", "--opts",
        f"EXPERIMENT_FOLDER={folder}/experiments",
        f"TENSORBOARD_FOLDER={folder}/tb",
        f"cache.default_folder={folder}/cache",
        "model_config.TokenizerClass=SimpleTokenizer",
        "model_config.pretrained=0", "train.epochs=1",
        f"{modules}LoadVQA2Data.config.vqa_data_path={vqa!r}",
        f"{modules}LoadVQA2Data.config.image_data_path="
        f"{ {'train': str(folder), 'val': str(folder)}!r}",
        f"{modules}LoadClipEmbeddings.config="
        f"{ {'train': files['embeddings'], 'val': files['embeddings']}!r}",
        *opts]


def clipcap_inputs(executor, batch) -> tuple:
    """The loss's inputs of one training batch, on the model's device."""
    ids = np.asarray(batch.input_ids)
    return tuple(torch.as_tensor(a, device=executor.model.device) for a in (
        clipcap_executor.last_clip_row(batch.clip_embeddings), ids,
        np.asarray(batch.attention_mask), executor._answer_labels(ids)))


def config_clipcap_run(name: str, folder: Path, files: dict, opts) -> dict:
    """main.run --mode train, then --mode test from its model_00, on
    clip_cap.jsonnet with ``opts``; every kernel count set to 0 just before
    each run and read just after. Checks: the training steps and updates,
    the kernels' exact launches (fused_gpt2_block once a layer a training
    forward where the positions allow, none in generate), the first loss
    against a direct clipcap_loss, model_00 loaded back, answers.pkl with
    one prediction a question and the metric, direct generate's tokens and
    answers."""
    phase = f"config_clipcap_{name}"
    folder.mkdir(parents=True, exist_ok=True)
    train_argv = clipcap_argv(folder, files, "train", *opts)
    config = process_config(parse_args_sys(train_argv))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    # a train run has no results folder: its validations write answers.pkl
    # into the working directory, here the run's own
    with TrainRecorder(clipcap_executor.ClipCapExecutor) as rec, \
            contextlib.chdir(folder):
        executor, _ = eval_main.run(train_argv)
    train_s = time.perf_counter() - t0
    train_counts = kernel_counts()
    train_peak = torch.cuda.max_memory_allocated()
    model = executor.model
    check(model.device.type == "cuda", f"{phase}: the model is on "
          f"{model.device}")
    batch_size = int(config.train.batch_size)
    steps = rec.steps
    n_steps = CLIPCAP_TRAIN_QUESTIONS // batch_size
    accumulate = int(config.train.additional.gradient_accumulation_steps)
    check(len(steps) == n_steps and executor.optimizer.applied
          == n_steps // accumulate,
          f"{phase}: {len(steps)} steps, {executor.optimizer.applied} "
          "updates")
    check(all(np.isfinite(s["loss"]) for s in steps), f"{phase} losses")
    first = clipcap_inputs(executor, rec.first["batch"])
    positions = first[1].shape[1] + model.cfg.prefix_length
    fused = model.cfg.lm.fused_block and positions <= 128
    layers = model.cfg.lm.num_layers
    want = launches(fused_gpt2_block=layers * n_steps if fused else 0)
    check(train_counts == want, f"{phase}: the train run launched "
          f"{train_counts}, expected {want}")
    with torch.no_grad():
        direct = float(clipcap_lib.clipcap_loss(
            rec.first["mapper"], model.params["lm"], model.cfg, *first))
    check(abs(direct - steps[0]["loss"]) <= CLIPCAP_DIRECT_LOSS_REL
          * abs(direct), f"{phase}: the first step's loss {steps[0]['loss']}"
          f" is not a direct clipcap_loss's {direct}")
    trained = [t.detach().clone() for t in
               tree_leaves(model.params["mapper"])]
    saved = load_checkpoint(os.path.join(config.saved_model_path,
                                         "model_00"))
    check(all(torch.equal(a.to(b.device), b) for a, b in
              zip(tree_leaves(saved["mapper"]), trained)),
          f"{phase}: model_00's mapper is not the trained one")
    del executor, model, saved
    gc.collect()
    torch.cuda.empty_cache()

    test_argv = clipcap_argv(folder, files, "test", *opts)
    tconfig = process_config(parse_args_sys(test_argv))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    with EvalTimer(timed=((clipcap_lib.ClipCaptionModel, "generate"),
                          (BaseExecutor, "test"))) as timer:
        executor, metrics = eval_main.run(test_argv)
    run_s = time.perf_counter() - t0
    test_counts = kernel_counts()
    peak = torch.cuda.max_memory_allocated()
    check(test_counts == launches(), f"{phase}: the test run launched "
          f"{test_counts}")
    check(all(torch.equal(a, b) for a, b in zip(
        tree_leaves(executor.model.params["mapper"]), trained)),
        f"{phase}: the test run's mapper is not model_00's")
    predictions = pickle.loads((Path(tconfig.results_path)
                                / "answers.pkl").read_bytes())
    check(sorted(p["question_id"] for p in predictions)
          == [2000000 + i for i in range(CLIPCAP_VAL_QUESTIONS)],
          f"{phase}: answers.pkl holds {len(predictions)} predictions")
    key = "test_evaluation/accuracy_overall"
    check(key in metrics, f"{phase}: {key} missing")
    answers = {p["question_id"]: p["answer"] for p in predictions}
    max_new = int(tconfig.data_loader.additional.max_target_length)
    eos = executor.tokenizer.eos_token_id
    batches = 0
    for i, batch in enumerate(executor.test_dataloader):
        dev = executor.model.device
        tokens, _ = executor.model.generate(
            torch.as_tensor(clipcap_executor.last_clip_row(
                batch.clip_embeddings), device=dev),
            torch.as_tensor(batch.generative_input_ids, device=dev),
            torch.as_tensor(batch.generative_attention_mask, device=dev),
            max_new_tokens=max_new, eos_token_id=eos)
        check(torch.equal(tokens, timer.tokens[i]),
              f"{phase}: batch {i}'s tokens differ from direct generate's")
        for row, qid, valid in zip(tokens.cpu().numpy(), batch.question_ids,
                                   batch.sample_valid):
            if valid:
                check(answers[qid] == executor.decode_prediction(
                    row.tolist()), f"{phase}: question {qid}'s answer is "
                    "not its tokens'")
        batches += 1
    check(len(timer.tokens) == batches,
          f"{phase}: {len(timer.tokens)} generate calls for {batches} "
          "batches")
    test_s = sum(timer.seconds["test"])
    generate_s = sum(timer.seconds["generate"])
    result = dict(
        opts=list(opts), dtype=str(executor.model.cfg.lm.dtype),
        positions=positions, fused_block=fused, train_s=train_s,
        step_s=[s["seconds"] for s in steps],
        losses=[s["loss"] for s in steps], direct_first_loss=direct,
        applied_updates=n_steps // accumulate,
        train_launches=launched_only(train_counts),
        logged_examples_per_s=rec.metrics.get("train/examples_per_s"),
        train_peak_mem_gb=train_peak / 1e9, test_run_s=run_s, test_s=test_s,
        questions_per_s=CLIPCAP_VAL_QUESTIONS / test_s,
        generate_s_per_batch=timer.seconds["generate"],
        host_share=1 - generate_s / test_s, peak_mem_gb=peak / 1e9,
        accuracy_overall=metrics[key])
    del executor
    gc.collect()
    torch.cuda.empty_cache()
    return dict(result, train_counts=train_counts)


def clipcap_mapper_step(folder: Path, files: dict, mapping_type: str) -> dict:
    """One train step of ClipCapExecutor with ``mapping_type`` (the
    config override) in the fp32 run's configuration, applied at once
    (gradient_accumulation_steps=1) at the config's learning rate (no
    warmup, whose first rate is 0): a finite loss, fused_gpt2_block once a
    layer, every mapper tensor moved."""
    argv = clipcap_argv(
        folder, files, "train", *CLIPCAP_FP32_OPTS,
        f"model_config.model_args.mapping_type={mapping_type}",
        "train.additional.gradient_accumulation_steps=1",
        "train.additional.warmup_steps=0")
    config = process_config(parse_args_sys(argv))
    loader = DATA_LOADERS.get(config.data_loader.type)(config)
    loader.build_dataset()
    loader.set_dataloader()
    executor = clipcap_executor.ClipCapExecutor(config, loader)
    model = executor.model
    check(model.cfg.mapper.mapping_type == mapping_type,
          f"config_clipcap: the mapper is {model.cfg.mapper.mapping_type}")
    before = [t.detach().clone() for t in tree_leaves(model.params["mapper"])]
    batch = next(iter(executor.train_dataloader))
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = executor.training_step(batch, 0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = kernel_counts()
    want = launches(fused_gpt2_block=model.cfg.lm.num_layers)
    check(counts == want, f"config_clipcap {mapping_type}: launched "
          f"{counts}, expected {want}")
    loss = float(out["loss"])
    after = tree_leaves(model.params["mapper"])
    check(np.isfinite(loss) and executor.optimizer.applied == 1
          and all(not torch.equal(a.detach(), b)
                  for a, b in zip(after, before)),
          f"config_clipcap {mapping_type}: loss {loss}, or a mapper tensor "
          "the step did not move")
    result = dict(loss=loss, step_s=seconds,
                  mapper_params=sum(t.numel() for t in before),
                  launches=launched_only(counts))
    del executor, model, before, after
    gc.collect()
    torch.cuda.empty_cache()
    return result


def phase_config_clipcap(smi: str) -> dict:
    """ClipCap as a user runs it: the port's CLI on the shipped
    clip_cap.jsonnet at GPT-2 small width and depth (random weights,
    SimpleTokenizer), CLIPCAP_TRAIN_QUESTIONS synthetic train questions (8
    steps of 32, the shipped accumulation of 4) and CLIPCAP_VAL_QUESTIONS
    val questions: --mode train then --mode test twice, as shipped (bf16,
    the 128-token bucket: 138 positions, no kernel) and with
    CLIPCAP_FP32_OPTS (fp32 activations at 42 positions: fused_gpt2_block's
    fp32 form 12 launches a training forward), each with
    config_clipcap_run's checks; then one train step each with the
    transformer and the perceiver mapper."""
    with tempfile.TemporaryDirectory() as tmp:
        folder = Path(tmp)
        files = write_eval_data(folder, CLIPCAP_VAL_QUESTIONS,
                                n_train=CLIPCAP_TRAIN_QUESTIONS,
                                width=CLIPCAP_PREFIX_SIZE)
        runs = {}
        for name, opts in (("bf16", ()), ("fp32", CLIPCAP_FP32_OPTS)):
            runs[name] = config_clipcap_run(name, folder / name, files, opts)
        check(not runs["bf16"]["fused_block"] and runs["fp32"]["fused_block"],
              "config_clipcap: the bf16 run took the kernel or the fp32 run "
              "did not")
        mappers = {t: clipcap_mapper_step(folder / t, files, t)
                   for t in ("transformer", "perceiver")}
    for name, run in runs.items():
        emit("config_clipcap", run=name, nvidia_smi=smi, **{
            k: v for k, v in run.items() if k != "train_counts"})
    emit("config_clipcap_mappers", **mappers)
    return dict(launches_per_call=[runs["fp32"]["train_counts"]],
                runs={name: {k: v for k, v in run.items()
                             if k != "train_counts"}
                      for name, run in runs.items()}, mappers=mappers)


def phase_bench_train() -> dict:
    """tools/bench_train.py's body at its defaults (B = 32, 32 tokens, 10
    steps after a first) for both models, without and with
    --fused_attention: each JSON line printed as the bench prints it, the
    path's kernel launched once a layer in each of its 11 steps."""
    results = {}
    for model, kernel, layers in (
            ("vct0", "t5_attention_core",
             t5_lib.T5Config.t0_3b().num_encoder_layers),
            ("clipcap", "fused_gpt2_block",
             gpt2_lib.GPT2Config.gpt2_small().num_layers)):
        for fused in ("0", "1"):
            args = bench_train.build_parser().parse_args(
                ["--model", model, "--fused_attention", fused])
            zero_counts()
            result = bench_train.bench(args)
            print(json.dumps(result), flush=True)
            counts = kernel_counts()
            want = launches(**({kernel: layers * (args.steps + 1)}
                               if fused == "1" else {}))
            check(counts == want, f"bench_train {model} {fused}: launched "
                  f"{counts}, expected {want}")
            check(result["metric"] == bench_train.METRICS[model]
                  and result["value"] > 0
                  and np.isfinite(result["config"]["final_loss"])
                  and result["device"]["name"]
                  == torch.cuda.get_device_name(0),
                  f"bench_train {model} {fused}: {result}")
            results[f"{model}_{'fused' if fused == '1' else 'unfused'}"] = (
                dict(examples_per_s=result["value"],
                     step_s=result["step_s"], launches=launched_only(counts)))
            gc.collect()
            torch.cuda.empty_cache()
    emit("bench_train", **results)
    return results


# ---------------------------------------------------------------------------
# RICES: in-context example selection on the card
# ---------------------------------------------------------------------------

RICES_TRAIN_IMAGES = 64
RICES_QUESTIONS_PER_IMAGE = 2      # 128 train questions
RICES_VAL = 32                     # val questions, an image each
RICES_IMAGE_BATCH = 32             # ClipImageEncoder's batch here
RICES_EXAMPLES = 32                # rices.TOP_K_EXAMPLES: each list's length
# the card's pipeline against the CPU's: the joint similarities (recomputed
# in float64) of the two lists, position by position; fp32 products in
# another order move a similarity by about 1e-7
RICES_TOL = 1e-5
# knn_search's exactness check: integer-valued vectors (exact products in
# any order), the last quarter of the database a copy of its first
RICES_KNN_ROWS, RICES_KNN_QUERIES, RICES_KNN_DIM, RICES_KNN_K = (
    8192, 256, 768, 64)
RICES_TF32_TOL = 1e-5              # a TF32 product is off by about 1e-3
# rices_at_scale: the tool at VQA2's full sizes for 16 chunks of 1024
RICES_SCALE_ARGS = ("--max_chunks", "16")
RICES_SCALE_CHECK_ROWS = 8         # rows of chunk 0 recomputed on the CPU
RICES_SCALE_TOL = 1e-5


def rices_items() -> tuple:
    """(train items, val items) in the VQA2 cache's schema."""
    train = [{"question_id": 1_000_000 + i,
              "img_key": 100 + i // RICES_QUESTIONS_PER_IMAGE,
              "question": f"question {i}", "gold_answer": f"answer {i}"}
             for i in range(RICES_TRAIN_IMAGES * RICES_QUESTIONS_PER_IMAGE)]
    val = [{"question_id": 2_000_000 + i, "img_key": 900 + i,
            "question": f"val question {i}", "gold_answer": f"val {i}"}
           for i in range(RICES_VAL)]
    return train, val


def joint_similarities(examples: list, val_qid: int, embeddings: dict,
                       images: bool = True) -> np.ndarray:
    """Each example's text plus image cosine (the text cosine alone
    without ``images``) to its val question, in float64 from the embedding
    pickles' dicts: the score its list is ranked by."""
    def cos(a, b):
        a, b = a.reshape(-1).astype(np.float64), b.reshape(-1).astype(
            np.float64)
        return a @ b / (np.linalg.norm(a) * np.linalg.norm(b))

    val_img = 900 + val_qid - 2_000_000
    return np.asarray([
        cos(embeddings["val_text"][str(val_qid)],
            embeddings["train_text"][str(e["question_id"])])
        + (cos(embeddings["val_img"][str(val_img)],
               embeddings["train_img"][str(e["img_key"])]) if images else 0.0)
        for e in examples])


def rices_knn_checks(dev: torch.device, gen: torch.Generator) -> dict:
    """knn_search on the card against its CPU version on integer-valued
    vectors with planted ties (normalize=False): equal indices and
    similarities; then on normal vectors with TF32 switched on globally,
    its similarities within RICES_TF32_TOL of float64 products."""
    n, m, d, k = (RICES_KNN_ROWS, RICES_KNN_QUERIES, RICES_KNN_DIM,
                  RICES_KNN_K)
    db = torch.randint(-3, 4, (n, d), generator=gen, device=dev).float()
    db[3 * n // 4:] = db[:n // 4]
    q = torch.randint(-3, 4, (m, d), generator=gen, device=dev).float()
    q[:16] = db[:16]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = knn_search(q, db, k, normalize=False, device=dev)
    card_s = time.perf_counter() - t0
    want = knn_search(q.cpu(), db.cpu(), k, normalize=False, device="cpu")
    ties = int((np.diff(want[0], axis=1) == 0).sum())
    check(np.array_equal(got[1], want[1]) and np.array_equal(got[0], want[0]),
          "knn_search on the card differs from the CPU on exact products")
    check(ties > 0, "the exactness check planted no tie")
    qn, dbn = torch.randn((m, d), generator=gen, device=dev), torch.randn(
        (n, d), generator=gen, device=dev)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        sims, idx = knn_search(qn, dbn, k, device=dev)
        check(torch.backends.cuda.matmul.allow_tf32,
              "knn_search did not restore the caller's TF32 setting")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    q64, db64 = (x.cpu().double() for x in (qn, dbn))
    exact = ((q64 / q64.norm(dim=1, keepdim=True))
             @ (db64 / db64.norm(dim=1, keepdim=True)).T).numpy()
    tf32_err = float(np.abs(
        sims - np.take_along_axis(exact, idx.astype(np.int64), 1)).max())
    check(tf32_err <= RICES_TF32_TOL,
          f"knn_search under a global TF32 setting: similarities off "
          f"float64 by {tf32_err} > {RICES_TF32_TOL}")
    return dict(rows=n, queries=m, dim=d, k=k, tied_neighbours=ties,
                card_s=card_s, tf32_on_max_err=tf32_err)


def phase_rices(dev: torch.device, smi: str) -> dict:
    """The port's RICES as a user runs it, on the card: image embeddings of
    RICES_TRAIN_IMAGES train and RICES_VAL val images through
    ClipImageEncoder at ViT-L/14@336 (random bf16 weights), as shipped (no
    kernel) and with int8=True (fused_qkv_q8, attention_core,
    fused_mlp_block_q8: 24 launches a call each), counts set to 0 before
    each call and read after; question embeddings through the 12-layer,
    768-wide ClipTextEncoder (encode_ids: the card has no tokenizer; no
    kernel); the four embedding pickles; run_full_pipeline on the card
    writing rices.pkl (k of 2048, clamped to the 128 train questions), its
    question-only form, and the int8 embeddings' rices.pkl; the CPU's
    pipeline on the same pickles; DataLoaderVQA2.LoadInContextExamples
    reading rices.pkl back. Held: the schema (every val question, 32
    examples of the train split, best last: the float64 joint
    similarities ascending within RICES_TOL), the card's lists against the
    CPU's within RICES_TOL position by position, and knn_search's checks
    (rices_knn_checks)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    results = {"knn": rices_knn_checks(dev, gen)}
    torch.cuda.empty_cache()

    cfg = clip_lib.CLIPVisionConfig.vit_l_14_336()
    params = clip_lib.init_clip_vision_params(gen, cfg, torch.bfloat16)
    n_images = RICES_TRAIN_IMAGES + RICES_VAL
    images = torch.randn((n_images, cfg.image_size, cfg.image_size, 3),
                         generator=gen, device=dev)
    layers = cfg.num_layers
    image_emb, runs = {}, {}
    for name, int8, expected in (
            ("default", False, launches()),
            ("int8", True, launches(fused_qkv_q8=layers,
                                    attention_core=layers,
                                    fused_mlp_block_q8=layers))):
        encoder = ClipImageEncoder(cfg, params, batch_size=RICES_IMAGE_BATCH,
                                   int8=int8, device=dev)
        outs, walls = [], []
        for start in range(0, n_images, RICES_IMAGE_BATCH):
            out, run = encode_with_counts(
                encoder, images[start:start + RICES_IMAGE_BATCH], expected,
                f"rices {name} image embeddings")
            outs.append(out)
            walls.append(run["wall_s"])
        image_emb[name] = np.concatenate(outs)
        check(image_emb[name].shape == (n_images, cfg.projection_dim)
              and bool(np.isfinite(image_emb[name]).all()),
              f"rices {name} image embeddings not finite or misshapen")
        runs[name] = dict(calls=len(walls), wall_s=walls,
                          launches_per_call=launched_only(run["launches"]))
        del encoder
    int8_cosine = row_cosine(image_emb["int8"], image_emb["default"])
    check(bool((int8_cosine >= CLIP_COSINE_FLOOR).all()),
          f"rices int8 image embeddings' cosine {int8_cosine.min()} < "
          f"{CLIP_COSINE_FLOOR}")
    del params, images
    torch.cuda.empty_cache()

    train, val = rices_items()
    text_cfg = clip_lib.CLIPTextConfig()
    n_texts = len(train) + len(val)
    text = ClipTextEncoder(
        text_cfg, clip_lib.init_clip_text_params(gen, text_cfg,
                                                 torch.bfloat16),
        batch_size=n_texts, device=dev)
    ids = torch.randint(1, text_cfg.vocab_size - 1,
                        (n_texts, text_cfg.context_length), generator=gen,
                        device=dev, dtype=torch.int32)
    eot = torch.randint(2, text_cfg.context_length, (n_texts,),
                        generator=gen, device=dev)
    ids[torch.arange(n_texts, device=dev), eot] = text_cfg.vocab_size - 1
    zero_counts()
    text_emb = text.encode_ids(ids)
    check(kernel_counts() == launches(), "rices: the text tower launched "
          f"{launched_only(kernel_counts())}")
    check(text_emb.shape == (n_texts, text_cfg.projection_dim)
          and bool(np.isfinite(text_emb).all()),
          "rices text embeddings not finite or misshapen")
    del text
    torch.cuda.empty_cache()

    train_imgs = RICES_TRAIN_IMAGES
    pickles = {name: dict(
        train_text={str(it["question_id"]): text_emb[i][None]
                    for i, it in enumerate(train)},
        val_text={str(it["question_id"]): text_emb[len(train) + i][None]
                  for i, it in enumerate(val)},
        train_img={str(100 + j): image_emb[name][j][None]
                   for j in range(train_imgs)},
        val_img={str(it["img_key"]): image_emb[name][train_imgs + i][None]
                 for i, it in enumerate(val)}) for name in image_emb}
    train_qids = {it["question_id"]: it for it in train}
    with tempfile.TemporaryDirectory() as tmp:
        folder = Path(tmp)
        files = {}
        for name, dicts in pickles.items():
            files[name] = []
            for part in ("train_text", "val_text", "train_img", "val_img"):
                path = folder / f"{name}_{part}.pkl"
                path.write_bytes(pickle.dumps(dicts[part]))
                files[name].append(str(path))
        walls, outs = {}, {}
        for case, name, question_only, where in (
                ("rices", "default", False, dev),
                ("rices_questions_only", "default", True, dev),
                ("rices_int8", "int8", False, dev),
                ("rices_cpu", "default", False, "cpu"),
                ("rices_questions_only_cpu", "default", True, "cpu")):
            zero_counts()
            t0 = time.perf_counter()
            outs[case] = run_full_pipeline(
                *files[name], train, val, str(folder / f"{case}.pkl"),
                question_only=question_only, device=where)
            walls[case] = time.perf_counter() - t0
            check(kernel_counts() == launches(),
                  f"{case}: the kNN launched a path kernel")
        loader = DataLoaderVQA2.__new__(DataLoaderVQA2)
        loader.data = AttrDict()
        loader.LoadInContextExamples(
            AttrDict(config=AttrDict(file_path=str(folder / "rices.pkl"))))
        read_back = loader.data.in_context_examples
    check(read_back == outs["rices"],
          "LoadInContextExamples read another rices.pkl than was written")
    fields = {"question_id", "img_key", "question", "gold_answer"}
    exact, worst = {}, {}
    for case in ("rices", "rices_questions_only", "rices_int8"):
        got, emb = outs[case], pickles["int8" if "int8" in case
                                       else "default"]
        check(list(got) == [str(it["question_id"]) for it in val],
              f"{case}: the val questions differ")
        for qid, examples in got.items():
            check(len(examples) == RICES_EXAMPLES
                  and all(set(e) == fields for e in examples)
                  and all(e["img_key"] == train_qids[int(e["question_id"])][
                      "img_key"] for e in examples),
                  f"{case}: the examples of {qid} break the schema")
            sims = joint_similarities(examples, int(qid), emb,
                                      images=case != "rices_questions_only")
            check(bool((np.diff(sims) >= -RICES_TOL).all()),
                  f"{case}: the examples of {qid} are not best last")
        cpu = outs.get(case + "_cpu")
        if cpu is None:
            continue
        exact[case] = sum(got[q] == cpu[q] for q in got) / len(got)
        err = 0.0
        for qid in got:
            a, b = (joint_similarities(
                lists[qid], int(qid), emb,
                images=case != "rices_questions_only") for lists in (got, cpu))
            err = max(err, float(np.abs(a - b).max()))
        worst[case] = err
        check(err <= RICES_TOL, f"{case}: the card's lists off the CPU's "
              f"by {err} > {RICES_TOL} in joint similarity")
    overlap = np.mean([
        len({e["question_id"] for e in outs["rices_int8"][q]}
            & {e["question_id"] for e in outs["rices"][q]}) / RICES_EXAMPLES
        for q in outs["rices"]])
    results.update(
        images=dict(train=RICES_TRAIN_IMAGES, val=RICES_VAL,
                    batch=RICES_IMAGE_BATCH, **runs),
        int8_cosine_min=float(int8_cosine.min()),
        texts=n_texts, pipeline_s=walls, equal_to_cpu_share=exact,
        max_joint_err_to_cpu=worst, int8_example_overlap=float(overlap))
    emit("rices", nvidia_smi=smi, **results)
    return results


def phase_rices_at_scale(dev: torch.device, smi: str) -> dict:
    """tools/rices_at_scale.py at VQA2's sizes (443,757 train questions,
    82,783 images, 768 wide, k = 2048, the top 32, chunks of 1024) for the
    chunks RICES_SCALE_ARGS asks: its JSON line (queries/s, the card's name
    and power limit), then queries/s, peak memory and the CPU check on a
    line of this phase: RICES_SCALE_CHECK_ROWS rows of chunk 0 recomputed
    on the CPU from the same embeddings, the similarities within
    RICES_SCALE_TOL and the train rows equal wherever the CPU's adjacent
    scores (the 33rd's beside the 32nd's) are more than RICES_SCALE_TOL
    apart."""
    args = rices_at_scale.parse_args(list(RICES_SCALE_ARGS))
    database = rices_at_scale.make_database(args, dev)
    zero_counts()
    result = rices_at_scale.bench(args, database, dev)
    check(kernel_counts() == launches(),
          "rices_at_scale launched a path kernel")
    line = rices_at_scale.report(result, dev)
    print(json.dumps(line), flush=True)
    check(line["value"] > 0
          and line["device"]["name"] == torch.cuda.get_device_name(0)
          and np.isfinite(line["config"]["checksum"]),
          f"rices_at_scale: {line}")
    rows = RICES_SCALE_CHECK_ROWS
    q_text, q_img = rices_at_scale.make_queries(args, 0, dev)
    host = tuple(t.cpu() for t in database)
    t0 = time.perf_counter()
    want_sims, want_rows = rices_at_scale.rices_chunk(
        *host, q_text[:rows].cpu(), q_img[:rows].cpu(), args.k,
        args.top_examples + 1)
    cpu_s = time.perf_counter() - t0
    del host
    got_sims, got_rows = (t[:rows].numpy() for t in result["first"])
    want_sims, want_rows = want_sims.numpy(), want_rows.numpy()
    top = args.top_examples
    sim_err = float(np.abs(got_sims - want_sims[:, :top]).max())
    gaps = -np.diff(want_sims, axis=1)                 # (rows, top)
    clear = gaps[:, :top] > RICES_SCALE_TOL
    clear[:, 1:] &= gaps[:, :top - 1] > RICES_SCALE_TOL
    check(sim_err <= RICES_SCALE_TOL,
          f"rices_at_scale: similarities off the CPU's by {sim_err}")
    check(np.array_equal(got_rows[clear], want_rows[:, :top][clear]),
          "rices_at_scale: train rows differ from the CPU's where the "
          "scores are clear of each other")
    config = line["config"]
    emit("rices_at_scale", nvidia_smi=smi, queries_per_s=line["value"],
         peak_gb=config["peak_gb"], seconds=config["seconds"],
         chunks=config["chunks"], query_chunk=config["query_chunk"],
         chunk_stage_ms=config["chunk_stage_ms"],
         projected_full_val_minutes=config["projected_full_val_minutes"],
         cpu_check=dict(rows=rows, max_sim_err=sim_err,
                        clear_positions=int(clear.sum()), of=int(clear.size),
                        rows_equal=int((got_rows == want_rows[:, :top]).all(
                            axis=1).sum()), cpu_s=cpu_s))
    del database, result
    gc.collect()
    torch.cuda.empty_cache()
    return line


OKVQA_QUESTIONS = 64               # 2 batches at test.batch_size 32
CAPTION_IMAGES = 32
REPLICATE_QUESTIONS = 32           # one batch at the harness's --batch-size
# bigscience/T0_3B's config.json fields the harness reads
T0_3B_HF_CONFIG = {"vocab_size": 32128, "d_model": 2048, "d_kv": 64,
                   "num_heads": 32, "d_ff": 5120, "num_layers": 24,
                   "num_decoder_layers": 24,
                   "relative_attention_num_buckets": 32,
                   "relative_attention_max_distance": 128}
INT8_OPTS = ("tpu.int8_encoder_ffn=True", "tpu.int8_encoder_attn=True")


def phase_line(phase: str, smi: str, t0: float, counts: dict, want: dict,
               **fields) -> None:
    """The five later phases' line: the card, the wall since ``t0``, the
    peak memory, and the launches checked against what the run
    dispatches."""
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(counts == want, f"{phase}: kernels launched {counts}, expected "
          f"{want}")
    emit(phase, nvidia_smi=smi, wall_s=wall,
         peak_gb=torch.cuda.max_memory_allocated() / 1e9,
         launches=launched_only(counts), **fields)


def start_phase() -> float:
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    return time.perf_counter()


def write_feature_data(folder: Path, image_keys: list) -> dict:
    """VinVL detections (TSV), Google-OCR annotations (a JSON an image, a
    polygon inside the first box) and Oscar captions (JSON) for
    ``image_keys``, in the reference's file formats."""
    rng = np.random.default_rng(SEED)
    ocr = folder / "ocr"
    ocr.mkdir(parents=True, exist_ok=True)
    captions = {}
    with open(folder / "vinvl.tsv", "w") as fh:
        for key in image_keys:
            w, h = (int(v) for v in rng.integers(80, 200, 2))
            objects = [{"rect": [60 * i, 0, 60 * i + w, h], "class": obj,
                        "conf": 0.9, "attributes": ["red"],
                        "attribute_scores": [0.7]}
                       for i, obj in enumerate(EVAL_OBJECTS[:3])]
            fh.write(f"{key}\t{json.dumps({'objects': objects})}\n")
            (ocr / f"{key}_ocr.json").write_text(json.dumps({
                "filtered_text_annotations": [{
                    "description": "STOP\nHERE", "vertices":
                    [[5, 5], [40, 5], [40, 20], [5, 20]]}]}))
            captions[key] = f"a {EVAL_OBJECTS[int(key) % 10]} on a table"
    (folder / "captions.json").write_text(json.dumps(captions))
    return {"vinvl": str(folder / "vinvl.tsv"), "ocr": str(ocr),
            "captions": str(folder / "captions.json")}


def phase_okvqa_eval(smi: str) -> dict:
    """main --mode test on the shipped config turned into an OK-VQA run at
    full T0-3B width and depth: LoadOKVQAData (on OKVQA_QUESTIONS
    synthetic questions in the official VQA format) in place of
    LoadVQA2Data, the VinVL, OCR (merged into the VinVL boxes) and Oscar
    modules, compute_okvqa_scores in place of compute_vqa_scores. Checks:
    answers.pkl, the OKVQA accuracy keys, the OCR merged, t5_attention_core
    24 launches a batch; questions/s."""
    t0 = start_phase()
    with tempfile.TemporaryDirectory() as tmp:
        folder = Path(tmp)
        files = write_eval_data(folder, OKVQA_QUESTIONS)
        keys = [str(1000 + i) for i in range(EVAL_TRAIN_QUESTIONS)] + [
            str(2000 + i) for i in range(OKVQA_QUESTIONS)]
        features = write_feature_data(folder / "features", keys)
        vqa = {"question_files": {"train": files["train2014_questions"],
                                  "val": files["val2014_questions"]},
               "annotation_files": {"train": files["train2014_annotations"],
                                    "val": files["val2014_annotations"]}}
        modules = "data_loader.dataset_modules."
        module_list = ["LoadClipEmbeddings", "LoadInContextExamples",
                       "LoadVinVLFeatures", "LoadGoogleOCRFeatures",
                       "LoadOscarCaptionFeatures", "LoadOKVQAData"]
        module_dict = {
            "LoadOKVQAData": {"type": "LoadOKVQAData", "option": "default",
                              "config": {"vqa_data_path": vqa,
                                         "image_data_path": {
                                             "train": str(folder),
                                             "val": str(folder)}}},
            "LoadVinVLFeatures": {"type": "LoadVinVLFeatures",
                                  "option": "default",
                                  "config": {"train": features["vinvl"],
                                             "test": features["vinvl"]}},
            "LoadGoogleOCRFeatures": {
                "type": "LoadGoogleOCRFeatures", "option": "default",
                "config": {"train": features["ocr"],
                           "test": features["ocr"],
                           "combine_with_vinvl": True}},
            "LoadOscarCaptionFeatures": {
                "type": "LoadOscarCaptionFeatures", "option": "default",
                "config": {"train": features["captions"]}},
        }
        opts = [f"{modules}module_list={module_list!r}",
                *(f"{modules}module_dict.{name}={value!r}"
                  for name, value in module_dict.items()),
                "metrics=[{'name': 'compute_okvqa_scores'}, "
                "{'name': 'write_predictions_to_file'}]"]
        run = run_eval("okvqa_eval", folder, files, OKVQA_QUESTIONS, *opts)
        executor = run["executor"]
        data = executor.data_loader.data
        check(data.get("okvqa_data") is not None
              and data.okvqa_data is data.vqa_data
              and "vqa2_data" not in data,
              "okvqa_eval: the split is not LoadOKVQAData's")
        merged = sum(p["ocr"] for p in data.vinvl_features.values())
        check(merged == len(keys), f"okvqa_eval: {merged} OCR texts merged "
              f"into the VinVL boxes of {len(keys)} images")
        check(len(data.caption_features) == len(keys),
              "okvqa_eval: the Oscar captions did not load")
        answer_keys = sorted(k for k in run["metrics"]
                             if k.startswith("test_evaluation/accuracy_"))
        check(any("AnswerType" in k for k in answer_keys),
              f"okvqa_eval: OK-VQA accuracy keys {answer_keys}")
        scorers = check_scoring("okvqa_eval", run)
        layers = executor.model.cfg.lm.num_encoder_layers
        want = launches(t5_attention_core=layers * run["stats"]["batches"])
        stats, counts = run["stats"], run["launches"]
        del executor, data, run
    phase_line("okvqa_eval", smi, t0, counts, want, accuracy=scorers,
               accuracy_keys=len(answer_keys), questions=stats["questions"],
               batches=stats["batches"],
               questions_per_s=stats["questions_per_s"],
               test_s=stats["test_s"], host_share=stats["host_share"],
               run_s=stats["run_s"])
    return stats


def phase_generate_captions(smi: str) -> dict:
    """tools/generate_captions.py (its CLI, the shipped config) on
    CAPTION_IMAGES pickled 768-wide embeddings at T0-3B width, the mapper
    checkpoint written by the port's save_checkpoint: one caption an
    embedding, each beginning with the forced "A picture of";
    t5_attention_core 24 launches a batch of 32. captions/s is over
    generate_captions alone; tool_s is the CLI's whole run (config, a
    random T0-3B, the checkpoint, the tokenizer)."""
    t0 = start_phase()
    with tempfile.TemporaryDirectory() as tmp:
        folder = Path(tmp)
        rng = np.random.default_rng(SEED)
        embeddings = folder / "embeddings.pkl"
        embeddings.write_bytes(pickle.dumps({
            str(i): rng.standard_normal((1, PREFIX_SIZE)).astype(np.float32)
            for i in range(CAPTION_IMAGES)}))
        opts = ["model_config.TokenizerClass=SimpleTokenizer",
                "model_config.pretrained=0"]
        config = process_config(parse_args_sys(
            [str(CONFIG_FILE), "--opts", *opts]))
        lm_cfg = model_factory.T5_CONFIGS[config.model_config.ConfigClass]()
        mapper_cfg = VCT0Config.from_model_args(
            dict(config.model_config.model_args), lm_cfg=lm_cfg).mapper
        save_checkpoint(str(folder / "saved_model"), 0, {"mapper": init_mapper(
            torch.Generator().manual_seed(SEED), mapper_cfg)})
        zero_counts()
        t1 = time.perf_counter()
        out = caption_tool.main([
            str(CONFIG_FILE), "--checkpoint",
            str(folder / "saved_model" / "model_00"),
            "--embeddings", str(embeddings), "--out",
            str(folder / "captions.txt"), "--limit", str(CAPTION_IMAGES),
            "--opts", *opts])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t1
        captions, generate_s = out["captions"], out["generate_s"]
        written = (folder / "captions.txt").read_text().split("\n")
    check(len(captions) == CAPTION_IMAGES and written == captions,
          f"generate_captions: {len(captions)} captions, {len(written)} "
          "written")
    check(all(c.startswith("A picture of") for c in captions),
          f"generate_captions: {captions[:2]}")
    layers = lm_cfg.num_encoder_layers
    phase_line("generate_captions", smi, t0, kernel_counts(),
               launches(t5_attention_core=layers * -(-CAPTION_IMAGES // 32)),
               captions=len(captions), tool_s=seconds,
               generate_s=generate_s,
               captions_per_s=len(captions) / generate_s,
               first=captions[0])
    return {"captions_per_s": len(captions) / generate_s}


def phase_drift_studies(smi: str) -> dict:
    """tools/int8_drift_study.py --mode both and tools/bf16_drift_study.py
    at their defaults (t5-large: 24 + 24 layers, d 1024; B=16, L=64, 20
    new tokens; the bf16 study's forward on 4 rows) on the card. The int8
    study encodes with rows 1-4: t5_attention_core 24 a call in the bf16
    baseline and each of the four variants, rows 2-4 24 in each variant, in
    each mode; the bf16 study runs the plain encoder, as in JAX, and
    launches nothing. Both JSON lines are printed; this line carries each
    study's full-sequence match rates and per-layer errors."""
    t0 = start_phase()
    int8 = int8_drift_study.main(["--mode", "both"])
    int8_s = time.perf_counter() - t0
    modes = ("normal", "outlier")
    calls = len(modes) * len(int8_drift_study.VARIANTS)
    layers = int8["shapes"]["layers"]
    int8_counts = kernel_counts()
    want_int8 = launches(
        t5_attention_core=layers * (calls + len(modes)),
        fused_t5_ln_qkv_q8=layers * calls,
        fused_oproj_residual_q8=layers * calls,
        fused_t5_ffn_q8=layers * calls)
    check(int8_counts == want_int8, f"drift_studies: the int8 study launched "
          f"{int8_counts}, expected {want_int8}")
    for mode in modes:
        for name, metrics in int8[mode].items():
            check(0.0 <= metrics["full_sequence_match_rate"] <= 1.0
                  and len(metrics["per_layer_rel_error"]) == layers
                  and all(np.isfinite(metrics["per_layer_rel_error"])),
                  f"drift_studies: int8 {mode} {name}: {metrics}")
    zero_counts()
    t1 = time.perf_counter()
    bf16 = bf16_drift_study.main([])
    bf16_s = time.perf_counter() - t1
    dec = bf16["greedy_decode"]
    check(len(bf16["per_layer_rel_error"]) == bf16["shapes"]["layers"]
          and all(np.isfinite(bf16["per_layer_rel_error"]))
          and 0.0 <= dec["full_sequence_match_rate"] <= 1.0,
          f"drift_studies: bf16 study {bf16}")
    phase_line(
        "drift_studies", smi, t0, kernel_counts(), launches(),
        int8_s=int8_s, bf16_s=bf16_s,
        int8_launches=launched_only(int8_counts),
        int8_full_sequence_match_rate={
            mode: {name: m["full_sequence_match_rate"]
                   for name, m in int8[mode].items()} for mode in modes},
        int8_per_layer_rel_error={
            mode: {name: m["per_layer_rel_error"]
                   for name, m in int8[mode].items()} for mode in modes},
        bf16_full_sequence_match_rate=dec["full_sequence_match_rate"],
        bf16_logit_top1_match=bf16["logit_top1_match"],
        bf16_per_layer_rel_error=bf16["per_layer_rel_error"])
    return {"int8": int8, "bf16": bf16}


def phase_decode_profile(smi: str) -> dict:
    """tools/decode_profile.py at its defaults (T0-3B, B=16, 557 encoder
    tokens, 20 greedy steps): its trace runs in a child process; this
    process parses it. Checks: the buckets sum to the operations' time,
    busy within the span, the card's name; records ms a step, the buckets
    a step, the idle share of the traced span and the busy share of the
    untraced wall."""
    t0 = start_phase()
    line = decode_profile.main([])
    trace = line["trace"]
    check(trace["n_events"] > 0 and trace["busy_us"] <= trace["span_us"]
          and abs(sum(trace["buckets_us"].values()) - trace["summed_us"])
          <= 1e-6 * trace["summed_us"]
          and 0.0 <= line["idle_share"] < 1.0
          and line["device"]["name"] == torch.cuda.get_device_name(0),
          f"decode_profile: {line}")
    phase_line("decode_profile", smi, t0, kernel_counts(), launches(),
               wall_ms_per_step=line["wall_ms_per_step"],
               steps_run=line["config"]["steps_run"],
               per_step_us=line["per_step_us"], idle_share=line["idle_share"],
               busy_share_of_untraced_wall=line[
                   "busy_share_of_untraced_wall"],
               busy_us=trace["busy_us"], span_us=trace["span_us"],
               kernels=trace["n_events"], top_ops_us=trace["top_ops_us"][:6])
    return line


def write_reference_mapper(path: Path, prefix_size: int, d_model: int,
                           prefix_length: int) -> None:
    """A reference-style (PyTorch Lightning) checkpoint of the MLP mapper
    (reference: src/models/vct0.py:58-69, torch Linear layouts), random
    from SEED with fan-in scaled weights."""
    gen = torch.Generator().manual_seed(SEED)
    hidden = d_model * prefix_length // 2
    out = d_model * prefix_length

    def linear(rows: int, cols: int) -> torch.Tensor:
        return torch.randn(rows, cols, generator=gen) * cols ** -0.5

    torch.save({"state_dict": {
        "model.clip_project.model.0.weight": linear(hidden, prefix_size),
        "model.clip_project.model.0.bias": torch.zeros(hidden),
        "model.clip_project.model.2.weight": linear(out, hidden),
        "model.clip_project.model.2.bias": torch.zeros(out)}}, path)


def phase_replicate(smi: str) -> dict:
    """tools/replicate_baseline.py's sweep (_build_config and _run_point
    through run_sweep) at T0-3B width on REPLICATE_QUESTIONS synthetic
    questions: main with hotpotqa at 0 and 2 shots, then its int8 twin
    (INT8_OPTS, --compare-bf16, --skip-int8-drift: the study has its own
    phase) at 2 shots. The card's machine has no T0 weights or tokenizer
    files: the phase writes T0-3B's config.json, picks SimpleTokenizer
    through --opts, and the model factory draws random weights where it
    finds none. A reference .ckpt goes through
    tools/convert_reference_checkpoint.py. Checks: report rows with
    accuracies; t5_attention_core 24 a point, rows 2-4 24 in the int8
    point."""
    t0 = start_phase()
    with tempfile.TemporaryDirectory() as tmp:
        folder = Path(tmp)
        files = write_eval_data(folder, REPLICATE_QUESTIONS)
        weights = folder / "T0_3B"
        weights.mkdir()
        (weights / "config.json").write_text(json.dumps(T0_3B_HF_CONFIG))
        ckpt = folder / "model_04.ckpt"
        write_reference_mapper(ckpt, PREFIX_SIZE, T0_3B_HF_CONFIG["d_model"],
                               PREFIX_LENGTH)
        base = ["--t0-weights", str(weights), "--mapper-ckpt", str(ckpt),
                "--questions-train", files["train2014_questions"],
                "--annotations-train", files["train2014_annotations"],
                "--questions-val", files["val2014_questions"],
                "--annotations-val", files["val2014_annotations"],
                "--clip-embeddings-train", files["embeddings"],
                "--clip-embeddings-val", files["embeddings"],
                "--rices", files["rices"], "--templates", "hotpotqa",
                "--batch-size", str(REPLICATE_QUESTIONS),
                "--workdir", str(folder / "work")]
        simple = "model_config.TokenizerClass=SimpleTokenizer"
        zero_counts()
        main_report = replicate_baseline.run_sweep(
            replicate_baseline.parse_args(
                base + ["--shots", "0", "2", "--opts", simple]))
        main_counts = kernel_counts()
        zero_counts()
        int8_report = replicate_baseline.run_sweep(
            replicate_baseline.parse_args(
                base + ["--shots", "2", "--compare-bf16", "--skip-int8-drift",
                        "--opts", simple, *INT8_OPTS]))
    layers = T0_3B_HF_CONFIG["num_layers"]
    check(main_counts == launches(t5_attention_core=2 * layers),
          f"replicate: the main points launched {main_counts}")
    rows = main_report["rows"] + int8_report["rows"]
    check([(r["mode"], r["num_shots"]) for r in rows]
          == [("main", 0), ("main", 2), ("main", 2)]
          and all(r["accuracy"] is not None and 0 <= r["accuracy"] <= 100
                  and r["questions"] == REPLICATE_QUESTIONS for r in rows)
          and int8_report["rows"][0].get("accuracy_bf16") is not None
          and not main_report["random_mapper"],
          f"replicate: report rows {rows}")
    check(int8_report.get("int8_drift_study")
          == "skipped (--skip-int8-drift)", "replicate: the drift study ran")
    replicate_baseline.print_report(main_report)
    replicate_baseline.print_report(int8_report)
    phase_line(
        "replicate", smi, t0, kernel_counts(),
        launches(t5_attention_core=2 * layers, fused_t5_ln_qkv_q8=layers,
                 fused_oproj_residual_q8=layers, fused_t5_ffn_q8=layers),
        main_launches=launched_only(main_counts),
        rows=[{key: r.get(key) for key in (
            "mode", "num_shots", "accuracy", "reference", "accuracy_bf16",
            "int8_vs_bf16_delta", "questions_per_s",
            "bf16_questions_per_s")} for r in rows])
    return {"rows": rows}


# the kernel studies, the eval-order bench, hw_smoke and the eval over
# processes: each tool's main through tool_phase; the studies at a chunk
# (the full, unfiltered runs are the README's commands)
TRAIN_STUDY_ARGS = ("--batches", "32,64", "--steps", "2", "--trials", "1")
VIT_B_CHUNK = ("--variants", "xla,whole_g4_shipped,whole_g8,split3_g4",
               "--towers", "whole_block_g4,attention_core_g4,mlp_fused_g4,"
               "patch_embed_only", "--trials", "1")
VIT_L_CHUNK = ("--variants", "xla,split3,whole", "--towers",
               "attention_core_only,mlp_fused_only,qkv_projections_xla",
               "--trials", "1")
# the kernels each timed entry of the chunks runs, once a layer a pass
VIT_ENTRY_KERNELS = {
    "xla": (), "qkv_projections_xla": (), "patch_embed_only": (),
    "whole_g4_shipped": ("fused_vit_block",), "whole": ("fused_vit_block",),
    "whole_block_g4": ("fused_vit_block",),
    "split3_g4": ("fused_ln_qkv", "attention_core_oproj", "fused_mlp_block"),
    "split3": ("fused_ln_qkv", "attention_core_oproj", "fused_mlp_block"),
    "attention_core_g4": ("attention_core",),
    "attention_core_only": ("attention_core",),
    "mlp_fused_g4": ("fused_mlp_block",), "mlp_fused_only": ("fused_mlp_block",),
}
# hw_smoke's launches at e2e_fixtures.KERNEL_LM_CONFIG (2 encoder layers,
# 4 val questions in 2 batches), by flow: eval, one-at-a-time and beam 4
# each; the ensembles 12 looped and 8 batched; training none (the CC
# config fuses nothing); the int8 eval 4 of each int8 kernel and of
# t5_attention_core (the calibration encodes on the plain path)
HW_SMOKE_LAUNCHES = dict(t5_attention_core=4 + 4 + 4 + 12 + 8 + 4,
                         fused_t5_ln_qkv_q8=4, fused_oproj_residual_q8=4,
                         fused_t5_ffn_q8=4)
PROCESSES = 2                      # multiprocess_eval's ranks, on one card


def tool_phase(phase: str, smi: str, tool, argv, want, fields,
               counts=None) -> dict:
    """``tool.main(argv)`` with every kernel count set to 0 just before; then
    ``fields(result)``, which checks the result (raising on a miss) and may
    run more on the card; then the counts (``counts(result)`` where the tool
    ran in other processes, else this process's), held to ``want(result)``,
    and the phase line with the card, wall, peak and the fields."""
    t0 = start_phase()
    out = tool.main(list(argv))
    got = counts(out) if counts else kernel_counts()
    line = fields(out)
    phase_line(phase, smi, t0, got, want(out), **line)
    return out


def timed_entry_launches(out: dict, tables: tuple, layers: int) -> dict:
    """A study's launches: each timed entry's kernels once a layer in each
    of its (trials + 1) calls of k passes."""
    calls = (out["trials"] + 1) * out["k_batches"] * layers
    counts: dict = {}
    for table in tables:
        for name, res in out[table].items():
            if "same_program_as" in res:
                continue
            for kernel in VIT_ENTRY_KERNELS[name]:
                counts[kernel] = counts.get(kernel, 0) + calls
    return launches(**counts)


def train_study_fields(out: dict) -> dict:
    points = {**{f"B={b}": p for b, p in out["batch_sweep"].items()},
              **out["variants"]}
    for name, p in points.items():
        check("error" not in p and np.isfinite(p["first_loss"])
              and np.isfinite(p["final_loss"]) and p["ms_per_step"] > 0,
              f"train_step_study: {name}: {p}")
    cfg = out["config"]
    check(cfg["measured_ceiling_tflops"] > 0 and cfg["int8_over_bf16_rate"] > 0
          and out["variants"]["fwd"]["step_over_fwd_ratio"] > 0
          and out["int8_forward_bound"]["max_step_speedup"] > 0
          and out["device"]["name"] == torch.cuda.get_device_name(0),
          f"train_step_study: {cfg}, {out['int8_forward_bound']}")
    return dict(
        measured_ceiling_tflops=cfg["measured_ceiling_tflops"],
        int8_over_bf16_rate=cfg["int8_over_bf16_rate"],
        ms_per_step={n: p["ms_per_step"] for n, p in points.items()},
        pct_of_measured_ceiling={n: p["pct_of_measured_ceiling"]
                                 for n, p in points.items()},
        step_over_fwd_ratio=out["variants"]["fwd"]["step_over_fwd_ratio"],
        int8_forward_bound=out["int8_forward_bound"])


def train_study_want(out: dict) -> dict:
    """The encoder's two kernels once a layer a step's forward: base at
    each batch, fwd, xla_attn (the FFN alone) once; remat twice (its
    backward recomputes the forward)."""
    cfg = out["config"]
    units = (cfg["steps_per_fetch"] * (cfg["trials"] + 1)
             * t5_lib.T5Config.t0_3b().num_encoder_layers)
    base = len(out["batch_sweep"]) + 2 + 1        # + remat twice + fwd
    return launches(t5_attention_core=units * base,
                    fused_t5_ffn=units * (base + 1))  # + xla_attn


def vit_study_fields(phase: str, towers_key: str):
    def fields(out: dict) -> dict:
        entries = {**out["variants"], **out[towers_key]}
        for name, res in entries.items():
            check("error" not in res, f"{phase}: {name}: {res}")
        check(out["measured_ceiling_tflops"] > 0
              and out["device"]["name"] == torch.cuda.get_device_name(0),
              f"{phase}: {out['measured_ceiling_tflops']}, {out['device']}")
        return dict(
            measured_ceiling_tflops=out["measured_ceiling_tflops"],
            images_per_s={n: r.get("images_per_s", r.get("same_program_as"))
                          for n, r in out["variants"].items()},
            towers=out[towers_key],
            variants_pct_of_measured_ceiling={
                n: r.get("pct_of_measured_ceiling")
                for n, r in out["variants"].items()})
    return fields


def eval_pipeline_fields(out: dict) -> dict:
    check(out["predictions"] == 32 and out["serial_ms"] > 0
          and out["pipelined_ms"] > 0, f"eval_pipeline_bench: {out}")
    return {k: out[k] for k in ("serial_ms", "pipelined_ms", "value",
                                "batches", "predictions")}


def phase_multiprocess_eval(smi: str) -> dict:
    """main --mode test over PROCESSES processes on the one card
    (tools/multiprocess_eval.py: the launcher's environment, a gloo group)
    on the shipped config at T0-3B width with EVAL_QUESTIONS synthetic
    questions and a saved mapper. Checks: rank 0's answers.pkl (the
    gathered list) covers every question once, in rank order, and rank 1
    wrote none; each rank's answers equal a one-process run (in this
    process) over its [r::PROCESSES] shard; rank 0's accuracy is the
    gathered list's, scored here; a two-process --mode train on the
    pipelined mesh (tpu.mesh.pipe 2) refuses, naming ROADMAP Queue 1 item
    14, the pipeline. The launches are the ranks' own, each
    counted in its process: t5_attention_core once an encoder layer a batch
    of that rank. The one-process shard runs' launches are checked apart
    from them."""
    with tempfile.TemporaryDirectory() as tmp:
        folder = Path(tmp)
        files = write_eval_data(folder, EVAL_QUESTIONS)
        config = process_config(parse_args_sys(eval_argv(folder, files)))
        lm_cfg = model_factory.T5_CONFIGS[config.model_config.ConfigClass]()
        mapper_cfg = VCT0Config.from_model_args(
            dict(config.model_config.model_args), lm_cfg=lm_cfg).mapper
        ckpt = save_checkpoint(str(folder / "ckpt"), 0, {"mapper": init_mapper(
            torch.Generator().manual_seed(SEED), mapper_cfg)})
        load = f"test.load_model_path={ckpt}"
        layers = lm_cfg.num_encoder_layers

        def rank_want(rec: dict) -> dict:
            return launches(t5_attention_core=layers * rec["batches"])

        def fields(records: list) -> dict:
            want_ids = [2000000 + i for i in range(EVAL_QUESTIONS)]
            gathered = records[0]["predictions"]
            check(gathered is not None
                  and all(r["predictions"] is None for r in records[1:])
                  and any(f.endswith("answers.pkl")
                          for f in records[0]["files"])
                  and not any(f.endswith("answers.pkl")
                              for r in records[1:] for f in r["files"]),
                  "multiprocess_eval: a rank other than 0 wrote predictions, "
                  "or rank 0 none")
            check([p["question_id"] for p in gathered]
                  == [q for r in records for q in r["shard"]]
                  and sorted(p["question_id"] for p in gathered) == want_ids,
                  "multiprocess_eval: the gathered predictions do not cover "
                  "every question once in rank order")
            offset = 0
            for r in records:
                shard = want_ids[r["rank"]::PROCESSES]
                check(r["shard"] == shard,
                      f"multiprocess_eval: rank {r['rank']}'s shard")
                check(r["launches"] == rank_want(r),
                      f"multiprocess_eval: rank {r['rank']} launched "
                      f"{launched_only(r['launches'])} in {r['batches']} "
                      "batches")
                local = gathered[offset:offset + len(shard)]
                offset += len(shard)
                sub = folder / f"shard{r['rank']}"
                shard_files = dict(files)
                for kind in ("questions", "annotations"):
                    rows = json.loads(Path(files[f"val2014_{kind}"])
                                      .read_text())
                    rows[kind] = [q for q in rows[kind]
                                  if q["question_id"] in set(shard)]
                    path = sub / f"val2014_{kind}.json"
                    path.parent.mkdir(parents=True, exist_ok=True)
                    path.write_text(json.dumps(rows))
                    shard_files[f"val2014_{kind}"] = str(path)
                zero_counts()
                executor, _ = eval_main.run(eval_argv(sub, shard_files, load))
                batches = len(executor.test_dataloader)
                check(batches == r["batches"] and kernel_counts()
                      == launches(t5_attention_core=layers * batches),
                      f"multiprocess_eval: the one-process run over rank "
                      f"{r['rank']}'s shard: {batches} batches, launched "
                      f"{launched_only(kernel_counts())}")
                one = pickle.loads((Path(executor.config.results_path)
                                    / "answers.pkl").read_bytes())
                check({p["question_id"]: p["answer"] for p in one}
                      == {p["question_id"]: p["answer"] for p in local},
                      f"multiprocess_eval: rank {r['rank']}'s answers differ "
                      "from a one-process run over its shard")
                del executor
            helper = VQA(files["val2014_annotations"],
                         files["val2014_questions"])
            ev = VQAEval(helper, helper.load_res_from_list(gathered), n=2)
            ev.evaluate()
            key = "test_evaluation/accuracy_overall"
            check(records[0]["metrics"][key] == ev.accuracy["overall"],
                  "multiprocess_eval: rank 0's accuracy is not the gathered "
                  "list's")
            train_argv = eval_argv(folder / "train", files, load,
                                   "tpu.mesh.pipe=2")
            train_argv[train_argv.index("--mode") + 1] = "train"
            refused = multiprocess_eval.launch(train_argv, PROCESSES,
                                               folder / "train_ranks")
            check(all("Queue 1 item 14, the pipeline" in (r["error"] or "")
                      and not any(r["launches"].values()) for r in refused),
                  f"multiprocess_eval: a two-process pipelined train run: "
                  f"{[(r['error'], r['launches']) for r in refused]}")
            return dict(ranks=PROCESSES, questions=len(gathered),
                        shards=[len(r["shard"]) for r in records],
                        rank_launches=[launched_only(r["launches"])
                                       for r in records],
                        accuracy=records[0]["metrics"][key],
                        train_refusal=refused[0]["error"])

        def summed(records: list) -> dict:
            return {name: sum(r["launches"][name] for r in records)
                    for name in launches()}

        return tool_phase(
            "multiprocess_eval", smi, multiprocess_eval,
            ["--nproc", str(PROCESSES), "--out", str(folder / "ranks"), "--",
             *eval_argv(folder, files, load)],
            lambda records: launches(t5_attention_core=layers * sum(
                r["batches"] for r in records)), fields, counts=summed)


def phase_tools(smi: str) -> None:
    """The studies (a chunk each), eval_pipeline_bench, hw_smoke and the
    eval over processes, each through tool_phase."""
    tool_phase("train_step_study", smi, train_step_study, TRAIN_STUDY_ARGS,
               train_study_want, train_study_fields)
    torch.cuda.empty_cache()
    tool_phase("vit_b_study", smi, vit_b_study, VIT_B_CHUNK,
               lambda out: timed_entry_launches(
                   out, ("variants", "component_towers_12layer"), 12),
               vit_study_fields("vit_b_study", "component_towers_12layer"))
    torch.cuda.empty_cache()
    tool_phase("vit_l_study", smi, vit_l_study, VIT_L_CHUNK,
               lambda out: timed_entry_launches(
                   out, ("variants", "component_towers_24layer"), 24),
               vit_study_fields("vit_l_study", "component_towers_24layer"))
    torch.cuda.empty_cache()
    tool_phase("eval_pipeline_bench", smi, eval_pipeline_bench, [],
               lambda out: launches(t5_attention_core=(
                   1 + 2 * eval_pipeline_bench.TRIALS) * out["batches"]
                   * e2e_fixtures.KERNEL_LM_CONFIG["num_encoder_layers"]),
               eval_pipeline_fields)
    tool_phase("hw_smoke", smi, hw_smoke, [],
               lambda out: launches(**HW_SMOKE_LAUNCHES),
               lambda out: {"flows": out})
    torch.cuda.empty_cache()
    phase_multiprocess_eval(smi)


# ---------------------------------------------------------------------------
# The (data, model) mesh over processes: two ranks on the one card
# ---------------------------------------------------------------------------

MESH_RANKS = 2                     # the mesh phases' ranks, on the one card
MESH_TRAIN_BATCH = 4               # a rank's rows a training step
MESH_DP_STEPS, MESH_TP_STEPS = 3, 2
MESH_VAL_ROWS, MESH_VAL_BATCH = 4, 2
# a rank's step loss against the one-process run's (the same rows; the
# products summed in another order, bf16 at T0-3B width)
MESH_LOSS_REL = 1e-2
MESH_EVAL_QUESTIONS = 8
MESH_IMAGES = 32                   # the extraction batch, 16 a rank
MESH_KNN_QUERIES = 2048            # two of rices_at_scale's 1024-query chunks
MESH_KNN_K = 2048                  # the question kNN's k
# sharded against one card: each rank's product of its database block and
# one card's of the whole may round a score apart; two scores closer than
# this may trade places
MESH_KNN_SIM_TOL = 1e-5
MESH_HEADS = 16                    # a model rank's heads of T0-3B's 32
# row 6's partial form against plain: its fp32 partial differs by the
# kernel's sum order (1.59e-4 on an H100); the same partial rounded to bf16
# before it is stored, the fault the fp32 form exists to avoid, reads about
# 1.5e-3. The check also shows that plain's partial rounded to bf16 lies
# beyond the limit
PARTIAL_FFN_REL = 5e-4
# the bf16 split eval: the mesh's first encoder output and first decode
# step's logits may be at most this many times as far (relative Frobenius)
# from the fp32 one-process run's as the bf16 one-process run's are
MESH_BF16_GROWTH = 1.5


def mesh_cc_opts(folder: Path, n_train: int) -> list:
    """CC parquet files of ``n_train`` training rows and MESH_VAL_ROWS val
    rows, as --opts. SimpleTokenizer numbers words in the order a process
    meets them: the first val row of every data shard (rows 0 and 1) holds
    every caption word in one order, so that each rank and the one-process
    run number them alike in their first (sanity) validation."""
    check(importlib.util.find_spec("pyarrow") is not None,
          "mesh phases: the ranks read the CC parquet files, and pyarrow "
          "does not import")
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(SEED)
    rows = {"train": cc_rows(n_train, rng), "val": cc_rows(MESH_VAL_ROWS,
                                                           rng)}
    for row in rows["val"][:MESH_RANKS]:
        row["caption"] = [" ".join(CC_WORDS)]
    modules = "data_loader.dataset_modules.module_dict.LoadConceptualCaptions"
    opts = []
    for split, split_rows in rows.items():
        path = folder / f"cc_{split}.parquet"
        pq.write_table(pa.table({key: [r[key] for r in split_rows]
                                 for key in split_rows[0]}), path)
        opts.append(f"{modules}.config.{split}={path}")
    return opts


def mesh_train_argv(folder: Path, *opts) -> list:
    return [str(CC_CONFIG_FILE), "--mode", "train", "--experiment_name",
            "train", "--disable_wandb", "--disable_tensorboard", "--opts",
            f"EXPERIMENT_FOLDER={folder}/experiments",
            f"TENSORBOARD_FOLDER={folder}/tb",
            f"cache.default_folder={folder}/cache",
            "model_config.TokenizerClass=SimpleTokenizer",
            "model_config.pretrained=0", "tpu.fused_attention=true",
            "tpu.fused_ffn=true", "train.epochs=1",
            "train.additional.gradient_accumulation_steps=1",
            f"valid.batch_size={MESH_VAL_BATCH}", *opts]


def mesh_checks(phase: str, records: list, shape: dict) -> str:
    """Every rank ran (no refusal) on ``shape`` with one backend: gloo,
    since the ranks share the one card. Returns the backend."""
    for rec in records:
        check(rec["error"] is None, f"{phase}: rank {rec['rank']} refused: "
              f"{rec['error']}")
        check(rec["mesh"] == shape, f"{phase}: rank {rec['rank']} on "
              f"{rec['mesh']}, expected {shape}")
    backends = {rec["backend"] for rec in records}
    check(backends == {"gloo"}, f"{phase}: backends {backends}: ranks "
          "sharing one card take gloo")
    return backends.pop()


def mesh_encodes(steps: int, val_batches: int) -> int:
    """A training run's encodes: one a step, two a val batch (the loss,
    then generate) in the sanity validation (at most 2 batches) and in the
    epoch's."""
    return steps + 2 * (min(val_batches, 2) + val_batches)


def phase_mesh_train(smi: str, phase: str, sizes: dict, steps: int) -> dict:
    """main --mode train on conceptual_captions.jsonnet at T0-3B width over
    MESH_RANKS ranks on the mesh ``sizes`` (tools/multiprocess_eval.py:
    the launcher's environment), MESH_TRAIN_BATCH rows a rank a step, then
    the one-process run on the union batch (the data ways' rows together:
    with one data way, the same rows). Checks: each step's loss, equal on
    the ranks and within MESH_LOSS_REL of the one-process run's; the first
    step's mapper gradient equal on the ranks and against the one process's
    (cosine, norm); the mapper and the optimizer's moments bit-identical on
    the ranks after the run; each rank's launches."""
    data_ways = MESH_RANKS // sizes["model"]
    t0 = start_phase()
    with tempfile.TemporaryDirectory() as tmp:
        folder = Path(tmp)
        cc = mesh_cc_opts(folder, steps * MESH_TRAIN_BATCH * data_ways)
        mesh_opts = [f"tpu.mesh.{ax}={n}" for ax, n in sizes.items()]
        ranks_t0 = time.perf_counter()
        records = multiprocess_eval.launch(
            mesh_train_argv(folder, f"train.batch_size={MESH_TRAIN_BATCH}",
                            *mesh_opts, *cc), MESH_RANKS, folder / "ranks")
        ranks_s = time.perf_counter() - ranks_t0
        backend = mesh_checks(phase, records, sizes)
        grad_mesh = torch.load(folder / "ranks" / "first_grad.pt")
        zero_counts()
        one_t0 = time.perf_counter()
        with multiprocess_eval.TrainTrace() as one:
            executor, _ = eval_main.run(mesh_train_argv(
                folder / "one",
                f"train.batch_size={MESH_TRAIN_BATCH * data_ways}", *cc))
        one_s = time.perf_counter() - one_t0
        one_counts = kernel_counts()
        check(executor.model.device.type == "cuda",
              f"{phase}: the one-process model is on {executor.model.device}")
        del executor
    gc.collect()
    torch.cuda.empty_cache()
    for key in ("train_losses", "first_grad_sha256", "mapper_sha256",
                "moments_sha256"):
        check(all(r[key] == records[0][key] for r in records),
              f"{phase}: the ranks' {key} differ: "
              f"{[r[key] for r in records]}")
    check(all(r["steps"] == steps for r in records)
          and len(one.losses) == steps,
          f"{phase}: steps {[r['steps'] for r in records]}, one process "
          f"{len(one.losses)}")
    rels = [abs(a - b) / abs(b)
            for a, b in zip(records[0]["train_losses"], one.losses)]
    check(max(rels) <= MESH_LOSS_REL,
          f"{phase}: the ranks' losses {records[0]['train_losses']} against "
          f"one process's {one.losses}")
    grads = compare_grads(phase, {"mesh": records[0]["train_losses"][0],
                                  "one": one.losses[0]},
                          {"mesh": grad_mesh, "one": one.first_grad},
                          MESH_LOSS_REL, a="mesh", b="one")
    layers = t5_lib.T5Config.t0_3b().num_encoder_layers
    encodes = mesh_encodes(steps, -(-MESH_VAL_ROWS // (
        MESH_VAL_BATCH * data_ways)))
    want = launches(t5_attention_core=layers * encodes,
                    fused_t5_ffn=layers * encodes)
    for rec in records:
        check(rec["launches"] == want, f"{phase}: rank {rec['rank']} "
              f"launched {launched_only(rec['launches'])}, expected "
              f"{launched_only(want)}")
    result = dict(mesh=sizes, backend=backend, ranks=MESH_RANKS,
                  steps=steps, rank_batch=MESH_TRAIN_BATCH,
                  losses=records[0]["train_losses"],
                  one_process_losses=one.losses, loss_rel=rels,
                  grad_cosine=grads["grad_cosine"],
                  grad_norm_ratio=grads["grad_norm_ratio"],
                  mapper_sha256=records[0]["mapper_sha256"],
                  ranks_s=ranks_s, one_process_s=one_s,
                  one_process_launches=launched_only(one_counts),
                  rank_launches=[launched_only(r["launches"])
                                 for r in records])
    phase_line(phase, smi, t0, records[0]["launches"], want, **result)
    return result


def mesh_kernel_checks(gen: torch.Generator) -> dict:
    """Rows 1 and 5 at a model rank's MESH_HEADS heads and row 6's partial
    form at T0-3B's model-2 FFN shard, at the main path's shapes, against
    their plain versions; timed beside their plain versions, bounds, and
    for row 6 the unfused shard's cuBLAS products."""
    cfg = t5_lib.T5Config.t0_3b()
    length = splice_output_length(PROMPT_LEN, PREFIX_LENGTH, NUM_SHOTS + 1)
    dev = gen.device
    width = MESH_HEADS * cfg.d_kv
    d_model, d_ff = cfg.d_model, cfg.d_ff // (cfg.num_heads // MESH_HEADS)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev).mul_(scale)

    out = {}
    q, k, v = (randn(BATCH, length, width).bfloat16() for _ in range(3))
    bias = randn(MESH_HEADS, length, length)
    mask = torch.ones((BATCH, length), dtype=torch.int32, device=dev)
    mask[1, length - 40:] = 0
    tiles = t5_bias_tiles(bias)
    args = (q, k, v, bias, mask, MESH_HEADS, tiles)
    got = t5_attention_core(*args)
    want = t5_attention_core_plain(*args[:6])
    err = (got.float() - want.float()).abs()
    check(bool((err <= KERNEL_ATOL + KERNEL_RTOL * want.float().abs()).all()),
          "tp_eval: t5_attention_core at 16 heads against plain")
    flops = 4 * BATCH * MESH_HEADS * length * length * cfg.d_kv
    out["t5_attention_core"] = dict(
        shape=dict(B=BATCH, L=length, H=MESH_HEADS),
        max_abs_err=float(err.max()),
        ms=cuda_ms(lambda: t5_attention_core(*args), iters=10),
        plain_ms=cuda_ms(lambda: t5_attention_core_plain(*args[:6]), iters=3,
                         warmup=1),
        **bound(4 * BATCH * length * width * 2 + bias.numel() * 4, flops,
                BF16_FLOP_PER_S))
    del q, k, v, bias, tiles, got, want
    layers = cfg.num_decoder_layers
    cq = randn(BATCH, width).bfloat16()
    ck, cv = (randn(layers, BATCH, length, width).bfloat16()
              for _ in range(2))
    dargs = (cq, ck, cv, mask, DECODE_LAYER, MESH_HEADS)
    got = cross_attention_decode(*dargs)
    want = cross_attention_decode_plain(*dargs)
    err = (got.float() - want.float()).abs()
    check(bool((err <= KERNEL_ATOL + KERNEL_RTOL * want.float().abs()).all()),
          "tp_eval: cross_attention_decode at 16 heads against plain")
    out["cross_attention_decode"] = dict(
        shape=dict(B=BATCH, L=length, H=MESH_HEADS),
        max_abs_err=float(err.max()),
        ms=cuda_ms(lambda: cross_attention_decode(*dargs), iters=20),
        plain_ms=cuda_ms(lambda: cross_attention_decode_plain(*dargs),
                         iters=5, warmup=1),
        **bound(2 * BATCH * length * width * 2, 4 * BATCH * length * width,
                BF16_FLOP_PER_S))
    del cq, ck, cv, got, want
    x = randn(BATCH, length, d_model, scale=2.0).bfloat16()
    lnw = (1 + 0.1 * randn(d_model)).bfloat16()
    wi_0, wi_1 = (randn(d_model, d_ff, scale=d_model ** -0.5).bfloat16()
                  for _ in range(2))
    wo = randn(d_ff, d_model, scale=d_ff ** -0.5).bfloat16()
    fargs = (x, lnw, wi_0, wi_1, wo, cfg.layer_norm_epsilon)
    got = fused_t5_ffn(*fargs, residual=False)
    want = fused_t5_ffn_plain(*fargs, residual=False)
    check(got.dtype == want.dtype == torch.float32,
          "tp_eval: the partial FFN's output is not fp32")
    errs = compare_q8(got, want)
    planted = ((want.bfloat16().float() - want).norm() / want.norm()).item()
    check(errs["rel_frobenius"] <= PARTIAL_FFN_REL < planted,
          f"tp_eval: the partial FFN's relative Frobenius error "
          f"{errs['rel_frobenius']} against plain, plain's partial rounded "
          f"to bf16 {planted}: the limit {PARTIAL_FFN_REL} must lie between")
    rows = BATCH * length

    def unfused_shard():
        h = t5_lib.rms_norm(x, lnw, cfg.layer_norm_epsilon)
        return torch.matmul(t5_lib.gelu_new(torch.matmul(h, wi_0))
                            * torch.matmul(h, wi_1), wo)

    out["fused_t5_ffn_partial"] = dict(
        shape=dict(M=rows, D=d_model, F=d_ff, gated=True), **errs,
        bf16_partial_rel_frobenius=planted,
        ms=cuda_ms(lambda: fused_t5_ffn(*fargs, residual=False), iters=10),
        plain_ms=cuda_ms(lambda: fused_t5_ffn_plain(*fargs, residual=False),
                         iters=3, warmup=1),
        # yardstick: the unfused bf16 shard (the norm, 3 cuBLAS matmuls,
        # gelu, gate; bf16 out)
        library_ms=cuda_ms(unfused_shard, iters=10),
        **bound(rows * d_model * 2 + rows * d_model * 4
                + 3 * d_model * d_ff * 2, 3 * 2 * rows * d_model * d_ff,
                BF16_FLOP_PER_S))
    del x, got, want
    # models/t5.py::_out_proj under a model split: a rank's partial of the
    # attention's o product as an fp32 GEMM of upcast bf16 operands, beside
    # the whole-width form's bf16 GEMM and a bf16 GEMM with an fp32 output
    y = randn(rows, width).bfloat16()
    wo_shard = randn(width, d_model, scale=width ** -0.5).bfloat16()
    upcast = torch.matmul(y.float(), wo_shard.float())
    to_fp32 = torch.mm(y, wo_shard, out_dtype=torch.float32)
    out["out_proj_partial"] = dict(
        shape=dict(M=rows, K=width, N=d_model),
        fp32_upcast_ms=cuda_ms(
            lambda: torch.matmul(y.float(), wo_shard.float()), iters=10),
        bf16_ms=cuda_ms(lambda: torch.matmul(y, wo_shard), iters=10),
        bf16_fp32_out_ms=cuda_ms(
            lambda: torch.mm(y, wo_shard, out_dtype=torch.float32),
            iters=10),
        bf16_fp32_out_max_abs_diff=(to_fp32 - upcast).abs().max().item(),
        tf32=torch.backends.cuda.matmul.allow_tf32)
    return out


def tp_eval_run(folder: Path, files: dict, load: str, opts: tuple) -> dict:
    """main --mode test over MESH_RANKS ranks on (data 1, model 2), then in
    this process, on the same questions and checkpoint with ``opts``: the
    ranks' records and the one-process run's answers, metrics, launches,
    first outputs (``multiprocess_eval.FirstOutputs``) and walls."""
    ranks_t0 = time.perf_counter()
    records = multiprocess_eval.launch(
        eval_argv(folder / "ranks_run", files, load, *opts,
                  "tpu.mesh.model=2"), MESH_RANKS, folder / "ranks")
    ranks_s = time.perf_counter() - ranks_t0
    zero_counts()
    one_t0 = time.perf_counter()
    with multiprocess_eval.FirstOutputs() as first:
        executor, metrics = eval_main.run(eval_argv(folder / "one", files,
                                                    load, *opts))
    one_s = time.perf_counter() - one_t0
    one = pickle.loads((Path(executor.config.results_path)
                        / "answers.pkl").read_bytes())
    del executor
    gc.collect()
    torch.cuda.empty_cache()
    return dict(records=records, answers=one, metrics=metrics,
                counts=kernel_counts(), first=first.outputs, ranks_s=ranks_s,
                one_s=one_s)


def tp_eval_answers(phase: str, run: dict) -> tuple:
    """Rank 0's gathered answers and the one-process run's, by question;
    fails unless rank 0 alone wrote every question's prediction."""
    records = run["records"]
    gathered = records[0]["predictions"]
    check(gathered is not None and records[1]["predictions"] is None
          and len(gathered) == MESH_EVAL_QUESTIONS,
          f"{phase}: rank 0 alone writes the {MESH_EVAL_QUESTIONS} "
          "predictions")
    return ({p["question_id"]: p["answer"] for p in gathered},
            {p["question_id"]: p["answer"] for p in run["answers"]})


def phase_tp_eval(smi: str) -> dict:
    """main --mode test on the shipped few_shot_vqa_hotpotqa.jsonnet at
    T0-3B width on (data 1, model 2) over MESH_RANKS ranks (the T5 split,
    16 heads and half the FFN a rank), each held against the one-process
    run of the same questions, twice:

    * fp32 activations with the fused encoder and decode attention (rows 1
      and 5's fp32 forms): rank 0's answers equal one process's token for
      token, and each rank launched what it did;
    * the configs' bf16 with the fused FFN too (row 6's partial form on the
      eval path): in bf16 a split block's sum in another order moves a bf16
      rounding now and then, and over 48 layers of random weights that
      flipped a near-tie (on an H100, one of 8 answers ended 2 tokens
      early), so tokens are not the measure. The first encoder output and
      the first decode step's logits are held within a relative Frobenius
      error of MESH_BF16_REL (tests/test_torch_tp_t5.py's bf16 rule), the
      encoder's launches equal one process's, and the answers that agree
      are counted.

    Then rows 1, 5 and 6 (its partial form) at the mesh's widths against
    their plain versions (mesh_kernel_checks)."""
    t0 = start_phase()
    fp32_opts = ("tpu.compute_dtype=float32",
                 "model_config.lm_config.fused_decode_attention=true")
    bf16_opts = ("tpu.fused_ffn=true",
                 "model_config.lm_config.fused_decode_attention=true")
    with tempfile.TemporaryDirectory() as tmp:
        folder = Path(tmp)
        files = write_eval_data(folder, MESH_EVAL_QUESTIONS)
        config = process_config(parse_args_sys(eval_argv(folder, files)))
        lm_cfg = model_factory.T5_CONFIGS[config.model_config.ConfigClass]()
        mapper_cfg = VCT0Config.from_model_args(
            dict(config.model_config.model_args), lm_cfg=lm_cfg).mapper
        ckpt = save_checkpoint(str(folder / "ckpt"), 0, {"mapper": init_mapper(
            torch.Generator().manual_seed(SEED), mapper_cfg)})
        load = f"test.load_model_path={ckpt}"
        fp32 = tp_eval_run(folder / "fp32", files, load, fp32_opts)
        bf16 = tp_eval_run(folder / "bf16", files, load, bf16_opts)
    shape = {"data": 1, "model": 2}
    backend = mesh_checks("tp_eval", fp32["records"], shape)
    check(mesh_checks("tp_eval bf16", bf16["records"], shape) == backend,
          "tp_eval: the bf16 run took another backend")
    got_answers, want_answers = tp_eval_answers("tp_eval", fp32)
    check(got_answers == want_answers,
          f"tp_eval: the mesh's answers {got_answers} differ from one "
          f"process's {want_answers}")
    for rec in fp32["records"]:
        check(rec["launches"] == fp32["counts"] and rec["launches"][
            "t5_attention_core"] > 0 and rec["launches"][
            "cross_attention_decode"] > 0,
              f"tp_eval: rank {rec['rank']} launched "
              f"{launched_only(rec['launches'])}, one process "
              f"{launched_only(fp32['counts'])}")
    bf16_got, bf16_want = tp_eval_answers("tp_eval bf16", bf16)
    encoder = ("t5_attention_core", "fused_t5_ffn")
    for rec in bf16["records"]:
        check(all(rec["launches"][name] == bf16["counts"][name] > 0
                  for name in encoder)
              and rec["launches"]["cross_attention_decode"] > 0,
              f"tp_eval bf16: rank {rec['rank']} launched "
              f"{launched_only(rec['launches'])}, one process "
              f"{launched_only(bf16['counts'])}")
    def rel(got, want):
        return float(np.linalg.norm(got - want) / np.linalg.norm(want))

    bf16_rel = {}
    for name, exact in fp32["first"].items():
        want = bf16["first"][name]
        got = bf16["records"][0]["first_outputs"][name]
        check(got.shape == want.shape == exact.shape
              and bool(np.isfinite(got).all()),
              f"tp_eval bf16: rank 0's first {name} output {got.shape}, "
              f"one process's {want.shape}, in fp32 {exact.shape}")
        bf16_rel[name] = dict(mesh_to_one=rel(got, want),
                              one_to_fp32=rel(want, exact),
                              mesh_to_fp32=rel(got, exact))
        print(f"tp_eval bf16: first {name}: {bf16_rel[name]}", flush=True)
    check(sorted(bf16_rel) == sorted(multiprocess_eval.FirstOutputs.NAMES),
          f"tp_eval bf16: first outputs of {sorted(bf16_rel)} only")
    for name, errs in bf16_rel.items():
        check(errs["mesh_to_fp32"] <= MESH_BF16_GROWTH * errs["one_to_fp32"],
              f"tp_eval bf16: rank 0's first {name} output is "
              f"{errs['mesh_to_fp32']} from the fp32 run's, more than "
              f"{MESH_BF16_GROWTH} x one bf16 process's {errs['one_to_fp32']}")
    kernels_t0 = time.perf_counter()
    checked = mesh_kernel_checks(torch.Generator(device="cuda").manual_seed(
        SEED + 7))
    records = fp32["records"]
    result = dict(mesh=shape, backend=backend, ranks=MESH_RANKS,
                  questions=MESH_EVAL_QUESTIONS, answers_equal=True,
                  accuracy=records[0]["metrics"][
                      "test_evaluation/accuracy_overall"],
                  one_process_accuracy=fp32["metrics"][
                      "test_evaluation/accuracy_overall"],
                  ranks_s=fp32["ranks_s"], one_process_s=fp32["one_s"],
                  bf16=dict(
                      answers_equal=sum(bf16_got[q] == a
                                        for q, a in bf16_want.items()),
                      first_rel_frobenius=bf16_rel,
                      ranks_s=bf16["ranks_s"], one_process_s=bf16["one_s"],
                      rank_launches=[launched_only(r["launches"])
                                     for r in bf16["records"]],
                      one_process_launches=launched_only(bf16["counts"])),
                  kernels_s=time.perf_counter() - kernels_t0,
                  rank_launches=[launched_only(r["launches"])
                                 for r in records], kernels=checked)
    phase_line("tp_eval", smi, t0, records[0]["launches"], fp32["counts"],
               **result)
    return result


def mesh_tool_inputs(dev: torch.device) -> tuple:
    """The extraction's MESH_IMAGES preprocessed-size images (numpy) and
    ViT-L/14@336 weights, and the kNN's VQA2-size question database (on the
    host, as the tools load it: a rank moves only its block to the card)
    and MESH_KNN_QUERIES queries (on the card), each from its own seed."""
    cfg = clip_lib.CLIPVisionConfig.vit_l_14_336(fused_block=True)
    params = clip_lib.init_clip_vision_params(
        torch.Generator(device=dev).manual_seed(SEED), cfg, torch.bfloat16)
    images = np.random.default_rng(SEED).standard_normal(
        (MESH_IMAGES, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    args = rices_at_scale.parse_args([])
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    database = torch.randn((args.n_train, args.dim), generator=gen,
                           device=dev).cpu().numpy()
    queries = torch.randn((MESH_KNN_QUERIES, args.dim), generator=gen,
                          device=dev)
    return cfg, params, images, database, queries


def run_mesh_tools_rank(folder: Path) -> None:
    """One rank of mesh_tools (``chip_smoke.py --mesh-tools-rank DIR``,
    started with a launcher's environment): the extraction encoder and the
    question kNN on ``make_data_mesh(-1)``, its results, backend and
    launches in DIR/rank{r}.pkl."""
    maybe_initialize_distributed()
    mesh = make_data_mesh(-1)
    dev = torch.device("cuda")
    cfg, params, images, database, queries = mesh_tool_inputs(dev)
    zero_counts()
    encoder = ClipImageEncoder(cfg, params, batch_size=MESH_IMAGES,
                               mesh=mesh)
    embeddings = encoder.encode_batch(images)
    encode_counts = kernel_counts()
    del encoder
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    sims, idx = knn_search(queries, database, MESH_KNN_K, mesh=mesh)
    record = dict(rank=mesh.data_index, backend=pbackend(),
                  mesh=dict(mesh.shape), embeddings=embeddings,
                  sims=sims, idx=idx, launches=encode_counts,
                  knn_peak_gb=(torch.cuda.max_memory_allocated() - held) / 1e9)
    (folder / f"rank{mesh.data_index}.pkl").write_bytes(pickle.dumps(record))


def phase_mesh_tools(smi: str) -> dict:
    """The extraction mesh and the sharded kNN over MESH_RANKS ranks on the
    one card (``--mesh_data -1``: ClipImageEncoder at ViT-L/14@336 with the
    split3 kernels, MESH_IMAGES images, a slice of the batch a rank;
    knn_search over the VQA2-size question database, each rank a block of
    its rows), against one card's in this process: the embeddings equal,
    the kNN's scores within MESH_KNN_SIM_TOL and its indices equal but
    where two scores are closer than that (counted)."""
    t0 = start_phase()
    with tempfile.TemporaryDirectory() as tmp:
        folder = Path(tmp)
        ranks_t0 = time.perf_counter()
        multiprocess_eval.launch_command(
            [sys.executable, str(Path(__file__).resolve()),
             "--mesh-tools-rank", str(folder)], MESH_RANKS, cwd=REPO)
        ranks_s = time.perf_counter() - ranks_t0
        records = [pickle.loads((folder / f"rank{r}.pkl").read_bytes())
                   for r in range(MESH_RANKS)]
    dev = torch.device("cuda")
    cfg, params, images, database, queries = mesh_tool_inputs(dev)
    zero_counts()
    one_t0 = time.perf_counter()
    embeddings = ClipImageEncoder(cfg, params, batch_size=MESH_IMAGES
                                  ).encode_batch(images)
    encode_counts = kernel_counts()
    sims, idx = knn_search(queries, database, MESH_KNN_K)
    one_s = time.perf_counter() - one_t0
    del params, database, queries
    gc.collect()
    torch.cuda.empty_cache()
    backends = {r["backend"] for r in records}
    check(backends == {"gloo"} and all(
        r["mesh"] == {"data": MESH_RANKS, "model": 1} for r in records),
          f"mesh_tools: backends {backends}, meshes "
          f"{[r['mesh'] for r in records]}")
    near_ties, sim_diff = 0, 0.0
    for rec in records:
        check(np.array_equal(rec["embeddings"], embeddings),
              f"mesh_tools: rank {rec['rank']}'s embeddings differ from one "
              f"card's by {np.abs(rec['embeddings'] - embeddings).max()}")
        check(np.abs(rec["sims"] - sims).max() <= MESH_KNN_SIM_TOL,
              f"mesh_tools: rank {rec['rank']}'s kNN scores differ by "
              f"{np.abs(rec['sims'] - sims).max()}")
        differ = rec["idx"] != idx
        gap = np.minimum(np.abs(np.diff(sims, axis=1, prepend=np.inf)),
                         np.abs(np.diff(sims, axis=1, append=-np.inf)))
        check(not (differ & (gap > MESH_KNN_SIM_TOL)).any(),
              f"mesh_tools: rank {rec['rank']}'s kNN indices differ from one "
              "card's where no two scores are close")
        near_ties = max(near_ties, int(differ.sum()))
        sim_diff = max(sim_diff, float(np.abs(rec["sims"] - sims).max()))
        check(rec["launches"] == encode_counts,
              f"mesh_tools: rank {rec['rank']} launched "
              f"{launched_only(rec['launches'])}, one card "
              f"{launched_only(encode_counts)}")
    result = dict(backend=backends.pop(), ranks=MESH_RANKS,
                  images=MESH_IMAGES, knn=dict(
                      queries=MESH_KNN_QUERIES, k=MESH_KNN_K,
                      database=list(database_shape())),
                  knn_indices_swapped_in_near_ties=near_ties,
                  # above what the rank held before its search: its block
                  # of the database, the queries' scores and candidates
                  knn_rank_peak_gb=[r["knn_peak_gb"] for r in records],
                  knn_max_sim_diff=sim_diff,
                  ranks_s=ranks_s, one_card_s=one_s,
                  rank_launches=[launched_only(r["launches"])
                                 for r in records])
    phase_line("mesh_tools", smi, t0, records[0]["launches"], encode_counts,
               **result)
    return result


def database_shape() -> tuple:
    args = rices_at_scale.parse_args([])
    return args.n_train, args.dim


def phase_mesh(smi: str) -> None:
    """The four mesh phases, each over MESH_RANKS ranks on the one card."""
    phase_mesh_train(smi, "dp_train", {"data": 2, "model": 1},
                     MESH_DP_STEPS)
    phase_mesh_train(smi, "tp_train", {"data": 1, "model": 2},
                     MESH_TP_STEPS)
    phase_tp_eval(smi)
    phase_mesh_tools(smi)


LINE_FIELDS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms")


def clip_phases(gen: torch.Generator) -> dict:
    """The CLIP and GPT-2 phases in order, each drawing from ``gen``, and
    of each what the kernels line reads: a kernel's LINE_FIELDS and a
    run's launches_per_call."""
    def fields(res: dict) -> dict:
        return {key: res[key] for key in LINE_FIELDS}

    def kernels_of(res: dict, *names) -> dict:
        return {name: fields(res[name]) for name in names}

    def runs(res: dict, *names) -> dict:
        return {name: {"launches_per_call": res[name]["launches_per_call"]}
                for name in names}

    out = {}
    out["vit_kernels"] = kernels_of(
        phase_vit_kernels(gen), "fused_ln_qkv", "attention_core_oproj",
        "fused_mlp_block")
    torch.cuda.empty_cache()
    out["vit_q8_kernels"] = kernels_of(
        phase_vit_q8_kernels(gen), "fused_qkv_q8", "attention_core",
        "fused_mlp_block_q8", "fused_qkv_q8_f32", "fused_mlp_block_q8_f32",
        "fused_vit_block_q8_f32")
    torch.cuda.empty_cache()
    phase_vit_attention_edges(gen)
    torch.cuda.empty_cache()
    out["clip_encode"] = runs(phase_clip_encode(gen), "fused", "int8")
    torch.cuda.empty_cache()
    phase_t5_quantizers(gen)
    torch.cuda.empty_cache()
    out["vit_short"] = kernels_of(
        phase_vit_short_kernels(gen), "fused_vit_block",
        "fused_vit_block_q8", "fused_attention_block")
    torch.cuda.empty_cache()
    out["clip_b32"] = runs(phase_clip_encode_b32(gen), "fused", "int8",
                           "fused_attention")
    torch.cuda.empty_cache()
    out["gpt2_block"] = fields(phase_gpt2_block(gen))
    torch.cuda.empty_cache()
    out["flash"] = fields(phase_flash_attention(gen))
    torch.cuda.empty_cache()
    out["clipcap"] = runs(phase_clipcap(gen), "loss")
    torch.cuda.empty_cache()
    out["clip_pallas"] = runs(phase_clip_encode_pallas(gen), "use_pallas")
    torch.cuda.empty_cache()
    # the fp32 phases draw from generators of their own, so that the phases
    # above keep their inputs
    out["vit_f32"] = {name: fields(res) for name, res in phase_vit_kernels_f32(
        torch.Generator(device=gen.device).manual_seed(SEED + 1)).items()
        if not name.endswith("fast_exp")}
    torch.cuda.empty_cache()
    clip_fp32 = phase_clip_encode_fp32(
        torch.Generator(device=gen.device).manual_seed(SEED + 2))
    out["clip_fp32"] = dict(
        runs(clip_fp32["f32"], "fused"),
        fused_attention=clip_fp32["fused_attention"])
    torch.cuda.empty_cache()
    out["vit_whole_f32"] = {
        name: fields(res) for name, res in phase_vit_whole_kernels_f32(
            torch.Generator(device=gen.device).manual_seed(SEED + 3)).items()}
    torch.cuda.empty_cache()
    out["clip_b32_fp32"] = runs(phase_clip_encode_b32_fp32(
        torch.Generator(device=gen.device).manual_seed(SEED + 4)), "fused",
        "fused_attention", "use_pallas")
    torch.cuda.empty_cache()
    clip_int8_fp32 = phase_clip_encode_int8_fp32(
        torch.Generator(device=gen.device).manual_seed(SEED + 6))
    out["clip_int8_fp32"] = {case: runs(res, "int8")["int8"]
                             for case, res in clip_int8_fp32.items()}
    torch.cuda.empty_cache()
    return out


def clip_phases_in_child(gen: torch.Generator) -> dict:
    """clip_phases in a process of its own (--clip-phases), from ``gen``'s
    state, so that their inputs are those of a run in this process. In a
    process that has run the T5 phases' traces, kernel_split's traces of
    the CLIP kernels came back with records missing (1 of 6 calls whole,
    on an H100); a fresh process traces whole. Its lines go to this
    process's output; its results come back through a file."""
    with tempfile.TemporaryDirectory() as tmp:
        folder = Path(tmp)
        torch.save(gen.get_state(), folder / "generator.pt")
        sys.stdout.flush()
        sys.stderr.flush()
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--clip-phases",
             str(folder)], timeout=900)
        check(proc.returncode == 0,
              f"the CLIP and GPT-2 phases failed (exit {proc.returncode})")
        return json.loads((folder / "clip_phases.json").read_text())


def run_clip_phases(folder: Path) -> None:
    """The child of clip_phases_in_child."""
    gen = torch.Generator(device=torch.device("cuda"))
    gen.set_state(torch.load(folder / "generator.pt"))
    (folder / "clip_phases.json").write_text(json.dumps(clip_phases(gen)))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    if kernels.CSRC_DIR.parent.parent != REPO:
        print(f"chip_smoke: the port was imported from {kernels.CSRC_DIR.parent}, "
              f"not from this checkout ({REPO})", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = phase_env()
    phase_build()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    attention = phase_attention(gen)
    int8_kernels = phase_int8_kernels(gen)
    torch.cuda.empty_cache()
    decode_attention = phase_decode_attention(gen)
    torch.cuda.empty_cache()
    t5_ffn = phase_t5_ffn(gen)
    torch.cuda.empty_cache()
    # a generator of its own: the later phases' inputs stay those of the
    # runs before this phase existed (PERF.md compares them across runs)
    fp32_kernels = phase_fp32_kernels(
        torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.empty_cache()

    lm_cfg = t5_lib.T5Config.t0_3b(fused_encoder_attention=True)
    cfg = VCT0Config(
        lm=lm_cfg,
        mapper=MapperConfig(mapping_type="mlp", prefix_size=PREFIX_SIZE,
                            d_model=lm_cfg.d_model,
                            prefix_length=PREFIX_LENGTH,
                            clip_length=PREFIX_LENGTH),
        sentinel_base=T5_SENTINEL_BASE,
    )
    t0 = time.perf_counter()
    model = VCT0Model(cfg, init_vct0_params(cfg, seed=SEED, device=dev))
    torch.cuda.synchronize()
    emit("init", seconds=time.perf_counter() - t0,
         params_gb=torch.cuda.memory_allocated() / 1e9)
    prefix, tokens, mask = make_prompts(cfg, dev)
    phase_reference(model, prefix, tokens, mask)
    layers = cfg.lm.num_encoder_layers
    generate = phase_generate(
        model, prefix, tokens, mask,
        expected=lambda steps: launches(t5_attention_core=layers))
    breakdown = phase_breakdown(model, prefix, tokens, mask)
    phase_profile(model, prefix, tokens, mask, generate["wall_s"])
    phase_generate_int8(model, prefix, tokens, mask, breakdown["encode_s"])
    torch.cuda.empty_cache()
    generate_fused = phase_generate_fused(model, prefix, tokens, mask,
                                          generate)
    torch.cuda.empty_cache()
    phase_generate_int8_all(model, prefix, tokens, mask)
    torch.cuda.empty_cache()
    phase_kv_layouts(model, gen)
    torch.cuda.empty_cache()
    phase_generate_modes(model, prefix, tokens, mask, generate)
    del model
    torch.cuda.empty_cache()
    clip_side = clip_phases_in_child(gen)
    vit_kernels = clip_side["vit_kernels"]
    vit_q8_kernels = clip_side["vit_q8_kernels"]
    clip_encode = clip_side["clip_encode"]
    vit_short = clip_side["vit_short"]
    clip_b32 = clip_side["clip_b32"]
    gpt2_block = clip_side["gpt2_block"]
    flash = clip_side["flash"]
    clipcap = clip_side["clipcap"]
    clip_pallas = clip_side["clip_pallas"]
    vit_f32, clip_fp32 = clip_side["vit_f32"], clip_side["clip_fp32"]
    vit_whole_f32 = clip_side["vit_whole_f32"]
    clip_b32_fp32 = clip_side["clip_b32_fp32"]
    clip_int8_fp32 = clip_side["clip_int8_fp32"]
    phase_config_generate(cfg, prefix, tokens, mask, generate)
    torch.cuda.empty_cache()
    config_fp32 = phase_config_generate_fp32(prefix, tokens, mask, generate)
    torch.cuda.empty_cache()
    phase_bench_generate()
    torch.cuda.empty_cache()
    phase_bench_generate("--ensembles", "3", "--members_per_call", "3",
                         phase="bench_generate_ensembles")
    torch.cuda.empty_cache()
    config_eval = phase_config_eval(smi)
    torch.cuda.empty_cache()
    config_eval_int8 = phase_config_eval_int8(smi)
    torch.cuda.empty_cache()
    config_eval_fp32_int8 = phase_config_eval_fp32_int8(smi)
    torch.cuda.empty_cache()
    phase_config_eval_modes(smi)
    torch.cuda.empty_cache()
    phase_train_step(dev, smi)
    torch.cuda.empty_cache()
    phase_config_train(smi)
    phase_clipcap_train_step(dev)
    torch.cuda.empty_cache()
    config_clipcap = phase_config_clipcap(smi)
    torch.cuda.empty_cache()
    phase_bench_train()
    gc.collect()
    torch.cuda.empty_cache()
    phase_rices(dev, smi)
    torch.cuda.empty_cache()
    phase_rices_at_scale(dev, smi)
    for later in (phase_okvqa_eval, phase_generate_captions,
                  phase_drift_studies, phase_decode_profile, phase_replicate):
        later(smi)
    phase_tools(smi)
    phase_mesh(smi)

    measured = {
        "t5_attention_core": (attention, config_eval),
        **{name: (res, config_eval_int8)
           for name, res in int8_kernels.items()},
        "cross_attention_decode": (decode_attention, generate_fused),
        "fused_t5_ffn": (t5_ffn, generate_fused),
        **{name: (res, clip_encode["fused"])
           for name, res in vit_kernels.items()},
        **{name: (vit_q8_kernels[name], clip_encode["int8"])
           for name in ("fused_qkv_q8", "attention_core",
                        "fused_mlp_block_q8")},
        **{name: (vit_q8_kernels[name], clip_int8_fp32[
            "b32_f32" if name == "fused_vit_block_q8_f32" else "vit_l_f32"])
           for name in ("fused_qkv_q8_f32", "fused_mlp_block_q8_f32",
                        "fused_vit_block_q8_f32")},
        "fused_vit_block": (vit_short["fused_vit_block"], clip_b32["fused"]),
        "fused_vit_block_q8": (vit_short["fused_vit_block_q8"],
                               clip_b32["int8"]),
        "fused_attention_block": (vit_short["fused_attention_block"],
                                  clip_b32["fused_attention"]),
        "fused_gpt2_block": (gpt2_block, clipcap["loss"]),
        "flash_attention": (flash, clip_pallas["use_pallas"]),
        **{name: (res, clip_fp32["fused_attention"
                                 if name == "attention_core_f32" else "fused"])
           for name, res in vit_f32.items()},
        **{name: (res, clip_b32_fp32[{
            "fused_vit_block_f32": "fused",
            "fused_attention_block_f32": "fused_attention",
            "flash_attention_f32": "use_pallas"}[name]])
           for name, res in vit_whole_f32.items()},
        **{name: (res, {"fused_t5_ln_qkv_q8_f32": config_eval_fp32_int8,
                        "fused_oproj_residual_q8_f32": config_eval_fp32_int8,
                        "fused_t5_ffn_q8_f32": config_eval_fp32_int8,
                        "fused_gpt2_block_f32": config_clipcap}.get(
                            name, config_fp32))
           for name, res in fp32_kernels.items()},
    }
    lines = []
    for name, (res, run) in measured.items():
        source, replaces = KERNELS[name]
        lines.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            # an fp32 form counts under its function's name
            "launches": run["launches_per_call"][-1][
                name.removesuffix("_f32")],
            "max_abs_err": res["max_abs_err"], "ms": res["ms"],
            "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"], "library_ms": res["library_ms"],
        })
    print(json.dumps({"kernels": lines}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--trace-t5-encode"]:
        trace_t5_encode(Path(sys.argv[2]), int(sys.argv[3]))
        sys.exit(0)
    if sys.argv[1:2] == ["--clip-phases"]:
        run_clip_phases(Path(sys.argv[2]))
        sys.exit(0)
    if sys.argv[1:2] == ["--trace-train-step"]:
        trace_train_step()
        sys.exit(0)
    if sys.argv[1:2] == ["--mesh-tools-rank"]:
        run_mesh_tools_rank(Path(sys.argv[2]))
        sys.exit(0)
    sys.exit(main())
