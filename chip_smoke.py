#!/usr/bin/env python3
"""Drive the PyTorch port (exploremultimodal_torch) on one CUDA GPU.

    python3 chip_smoke.py        # from the repository root; needs one GPU and nvcc
    python3 chip_smoke.py --train-loop-samples 64 640
                                 # the build and phase 20 alone at each size,
                                 # then the loop's fixed and per-step cost
    python3 chip_smoke.py --downstream
                                 # the build, rows 2-4 at IRTR's shape and its
                                 # dropout mask, phases 21 and 22 alone
    python3 chip_smoke.py --momentum
                                 # the build, rows 1, 3 and 4 at the shapes
                                 # phase 23 alone gives them and the dropout
                                 # mask at its microbatches' rows, phase 6's
                                 # timed step and phase 23 alone

Phases, in order; any failure raises and the script exits non-zero:
  1. the card's name and power limit, torch and CUDA versions;
  2. build every CUDA kernel from the checkout's sources (nvcc, sm_90a, one
     process per source, all at once) into exploremultimodal_torch/ops/build/;
  3. the shared memory the sm90 kernels of rows 1, 2/4 (up to 512 keys),
     1/3/5's streamed kernel, 8, 9 and 10 report against their wrappers'
     layout; at each shape the VQA serving path gives each
     serving kernel, hold the kernel against its plain PyTorch version on
     the card, then time the kernel, the plain version and a library call
     computing the same function (row 1 also at batch 8 at N = 100, 150
     and 256, the short sm90 kernel's other key widths, and past 256 keys
     on the streamed kernel at N = 333, 512 and 577 (384^2 images), at the
     momentum encoder's text and image streams at batch 32 (phase 23) and at
     batch 32 at N = 512, with route, grid and tiles; the MLP also at the
     1024^2 request's M, at M = 64 and at two ragged M, with its cluster
     size and hidden splits);
  4. serve batch-64 VQA requests through `Predictor.vqa_logits` at vlmo_base
     full width and depth (bf16, attn_impl=pallas, mlp_impl=fused, seeded
     random weights), check that every request went through both kernels,
     compare two requests with the CPU's plain path, and time the requests;
  5. at each shape the pretrain_mum step gives the training kernels (the
     flash backward, the dropout forward and the dropout backward: rows 2,
     3 and 4, all three on the sm90 kernels there), at finetune_retrieval's
     IRTR rows (BH = 1,536, N = 237), at the microbatches of
     accumulation_steps=2 (phase 23: the streams at BH = 192 and ITM's pair
     rows at BH = 576), and off the path at
     batch 8 at N = 256, 333 (ragged) and 512 and at batch 32 at N = 333
     and 512 (pretrain_txt's length; the backward's sm90 kernels up to 512
     keys, in work units of a head's tile groups where heads are fewer than
     SMs; the dropout forward's streamed kernel past 256), hold each against
     its plain version, with its route, key width and grid, check the
     in-kernel dropout mask bit for bit (through the short sm90 forward and
     the backward at ITM's, at IRTR's and at the microbatches' shapes
     (BH = 192 and 576, N = 237), and through the streamed
     forward and the backward at N = 512), and time kernel, plain version
     and SDPA (the backward rows against SDPA's backward alone, and its
     forward and backward);
  6. train pretrain_mum at vlmo_base, batch 32, on the synthetic data with a
     random dVAE (attn_impl=auto: the dropout kernels): one warm-up step and
     TRAIN_STEPS timed steps, with every launch counted;
  7. two steps with attn_impl=pallas and attention dropout 0, which run the
     flash forward and backward kernels;
  8. one step at batch 2 on the card and on the CPU's plain path from the
     same weights, batch, ITM negatives and MIM labels (hidden dropout and
     DropPath off, attention dropout on through the hash), compared
     (itc_temp's gradient at the card's own ITC features, and those
     features);
  9. the fused MLP's dropout forward (row 7) against its plain version at
     the finetune_vqa step's three FFN shapes and two thresholds, and at
     M = 64 and two ragged M, timed beside its plain version and the
     library chain (with its cluster size and hidden splits); the fused
     MLP's autograd backward against the fp32 plain VJP at the largest
     shape;
 10. train finetune_vqa at vlmo_base, batch 32, with mlp_impl=fused (row 7
     on every FFN call, rows 3 and 4 on every attention call): one warm-up
     step and TRAIN_STEPS timed steps, with every launch counted;
 11. two steps with R-Drop and ISDA on (twice the row-7 launches, a grown
     ISDA count), and two at attention and hidden dropout 0 through rows 1,
     2 and 6;
 12. one finetune_vqa step at batch 2 on the card and on the CPU's plain
     path (hidden dropout and DropPath off), compared;
 13. int8 (W8A8): row 8 bit for bit against its plain version for proj and
     qkv at M = 64, two ragged M, the finetune_vqa M and the serving M (with
     its grid), row 9 at M = 64 and two ragged M, the finetune_vqa M and
     the serving M (with its grid and hidden split), row 10 at M = 64 and
     two ragged M, the finetune_vqa M and two thresholds (with its grid and
     split), each timed beside its plain version,
     the `torch._int_mm` chain and the bf16 chain; `quant_dot` (w8a8) against
     the exact product of its codes;
 14. serve batch-64 requests with model.quantize=w8a8_pallas_mlp (row 9 on
     every FFN call), compare two with the CPU's plain path, print the argmax
     agreement with phase 4's bf16 logits; then as many at w8a8_pallas (row 8
     on qkv and proj as well), one compared with the CPU, all timed;
 15. train finetune_vqa under w8a8_pallas_mlp (row 10 on every FFN call): a
     warm-up step and TRAIN_STEPS timed ones; two steps at w8a8_pallas, two
     at dropout 0 (row 9 trains); a batch-2 step against the CPU;
 16. high-resolution serving (model.img_size=1024, 4097 image and 4137 fused
     tokens): the long flash forward (row 5) against its plain version at
     both stream shapes, at batch 1 and with a batch row whose first
     128-key block is all masked, timed beside its plain version and SDPA;
     then 1 + 5 batch-8 requests with row 5 on the image and fused streams,
     row 1 on the text stream and row 6 on every FFN call, one row compared
     with the CPU;
 17. the dVAE tokenizer: the fused encoder block (row 11) against its plain
     version at the five blocks it fuses at 256^2 (batch 32), timed beside
     its plain version and the cuDNN chain; then 1 + 5 tokenizer calls of
     32 images each with fused=True (5 row-11 launches per call),
     fused=False, quantize=w8a8 and w8a8_shifted (equal ids required), each
     path's token agreement with the unfused one, the fused and w8a8 paths
     against the CPU at batch 2;
 18. two pretrain_mum steps with MIM labels from the int8 dVAE
     (train.discrete_vae_quantize=w8a8);
 19. train pretrain_txt at vlmo_base, batch 32, 512 tokens (text-only MLM,
     attn_impl=auto: rows 3 and 4 at BH = 384, N = 512 on the streamed
     forward and the sm90 backward, 12 launches each a step): one warm-up
     step and TRAIN_STEPS timed steps with every launch counted, the text
     side moved and the fixed attention and frozen vision side not; two
     steps at attn_impl=pallas and attention dropout 0 (rows 1 and 2 at N =
     512); one batch-2 step on the card and on the CPU's plain path,
     compared as in phase 8;
 20. the run around the step, through `main.setup` and `phases.dispatch`
     (the dirs in a temporary directory, deleted at the end): finetune_vqa
     at vlmo_base, batch 32, mlp_impl=fused, 64 synthetic samples, two
     epochs each evaluated (rows 7, 3 and 4 on the 4 steps, row 6 and no
     row 1 on the 4 eval batches), finite `log_stats.json` lines with
     `val_vqa_mean_score`, checkpoint-0 and checkpoint-1 on disk; the
     checkpoint restored into a new trainer bit for bit (parameters, AdamW
     moments, step, both generators); a relaunch with train.epochs=3 that
     resumes from checkpoint-1 for one epoch (step 6); serving from the
     newest checkpoint through `Predictor.from_checkpoint` (rows 1 and 6 on
     every request) against a CPU `Predictor.from_checkpoint` of the same
     directory; throughput_mode (5 warm-up and 40 timed steps); each run's
     wall, epoch, eval, save and load seconds, the checkpoint's bytes, the
     throughput, and a step in the loop against throughput mode's step;
 21. the downstream phases at vlmo_base, batch 32: pretrain_vis (MIM, with
     mlp_impl=fused: rows 3, 4 and 7, 12 each a step), finetune_nlvr2 (rows
     3 and 4, 36 each) and finetune_retrieval (rows 3 and 4, 42 each), each a
     warm-up step and TRAIN_STEPS timed ones with every launch counted, the
     trained parameters moved (pretrain_vis's frozen ones not), and a
     batch-2 step against the CPU's plain path (retrieval's with the CPU's
     gradient at the ITC features fed to the card, ITC_GRAD_NOTE); two MAE
     steps; finetune_retrieval through `main.setup` and `phases.dispatch` on
     16 samples (steps, evaluation, a save, recall@{1,5,10}), its
     similarity matrix on the card against the CPU's;
 22. the endpoints at batch 64 (attn_impl=pallas, mlp_impl=fused, seeded
     weights): encode_image, encode_text, similarity and itm_score on
     pretrain_mum's heads, nlvr2 on finetune_nlvr2's; rows 1 and 6 on every
     attention and FFN call (12, 12, 18 and 36 a request), 4 rows of each
     against the CPU's plain path, the requests timed;
 23. pretrain_mum's full recipe at vlmo_base, batch 32 (vlmo_ema,
     train.neg_queue with 65,536 columns of itc_dim 256, model_ema;
     attn_impl=auto, attention dropout 0.1): one warm-up step (one leaf of
     each EMA tree set to 0 before it must then hold p (1 - decay) at its
     own decay; the queues' written columns unit-norm) and TRAIN_STEPS
     timed steps with every launch counted (rows 3 and 4 54 times a step,
     row 1 never: the momentum encoder's deterministic forward takes the
     plain chain under auto), the pointer 32 on each step, i2i, t2t, i2i_l
     and t2t_l finite, the median step beside phase 6's; ALTERNATED_PAIRS
     steps of the recipe and of plain pretrain_mum taken in turn in one
     process, the added time of each pair; `evaluate` on 2
     val batches equal to an evaluation of a task holding the eval EMA's
     tree; two steps at attn_impl=pallas (row 1 24 times a step on the
     momentum encoder); two at accumulation_steps=2 (rows 3 and 4 108
     times a step, at BH = 192); one batch-4 step at accumulation_steps=2
     against the CPU's plain path (compared as in phase 8, itc_temp at each
     device's own features through the momentum losses; the queues' new
     columns each device's own momentum features, within
     MOMENTUM_FEATURE_TOL across the two, as the momentum features of trees
     drawn from four more seeds, with the control (the tree's weights
     rounded to float8 e4m3) above it; one leaf of each tree, set to 0 before
     the step, within MOMENTUM_LEAF_TOL across the two, with the control
     (the other tree's decay) above it);
 24. print the kernel table as one JSON line, the card line, and last
     {"ok": true, "device": {...}}.
It imports nothing of JAX. The bounds use the H100 SXM data-sheet peaks.
Kernel times are device times: `time_ms` queues the timed calls behind a
device-side sleep, so the host's launch overhead does not enter them.
"""

from __future__ import annotations

import ctypes
import json
import math
import statistics
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from exploremultimodal_torch.config import VlmoConfig, load_config
from exploremultimodal_torch.infer import Predictor
from exploremultimodal_torch.models import build_model
from exploremultimodal_torch.ops import _build
from exploremultimodal_torch.ops.attention import key_padding_bias
from exploremultimodal_torch.models.dvae import DalleEncoder, DalleVAE, map_pixels
from exploremultimodal_torch.ops.dvae_conv import (
    block_widths,
    kernel_grid,
    fused_encoder_block,
    fused_encoder_block_plain,
)
from exploremultimodal_torch.ops.flash_attention import (
    FULL_ROW_FWD_MAX,
    LONG_TILE,
    SM90_BWD_MAX_N,
    SM90_BWD_ROLES,
    bwd_route,
    bwd_sm90_layout,
    bwd_sm90_units,
    dropout_keep_mask_plain,
    flash_attention_bwd,
    flash_attention_bwd_drop,
    flash_attention_bwd_drop_plain,
    flash_attention_bwd_plain,
    flash_attention_fwd,
    flash_attention_fwd_drop,
    flash_attention_fwd_drop_plain,
    flash_attention_fwd_long,
    flash_attention_fwd_long_plain,
    flash_attention_fwd_plain,
    fwd_route,
    fwd_sm90_grid,
    fwd_sm90_smem,
    fwd_sm90_tile,
    long_ctas,
    long_grid,
    padded_len,
    stream_smem,
)
from exploremultimodal_torch.ops.mlp_fused import CLUSTER as MLP_CLUSTER
from exploremultimodal_torch.ops.mlp_fused import (
    fused_mlp,
    fused_mlp_fwd,
    fused_mlp_fwd_drop,
    fused_mlp_fwd_drop_plain,
    fused_mlp_fwd_plain,
    gelu_tanh,
    hidden_splits,
)
from exploremultimodal_torch.ops.quant import _quantize_int8, quant_dot
from exploremultimodal_torch.ops.quant_fused import (
    int8_product,
    matmul_grid,
    matmul_smem,
    mlp_grid,
    mlp_smem,
    mlp_splits,
    quantize_weights,
    row_quant,
    w8a8_matmul,
    w8a8_matmul_plain,
    w8a8_mlp_fwd,
    w8a8_mlp_fwd_drop,
    w8a8_mlp_fwd_drop_plain,
    w8a8_mlp_fwd_plain,
)
from exploremultimodal_torch.ops.stochastic import keep16, keep_scale16
from exploremultimodal_torch.main import setup
from exploremultimodal_torch.data.datasets import build_dataset
from exploremultimodal_torch.data.pipeline import Loader
from exploremultimodal_torch.objectives.losses import itc_losses
from exploremultimodal_torch.train import checkpoints as ckpt_lib
from exploremultimodal_torch.train.phases import dispatch
from exploremultimodal_torch.train.retrieval import encode_split, recall_at_k
from exploremultimodal_torch.train.trainer import Trainer

# every kernel wrapper of the port, each with its launch count
KERNELS = (flash_attention_fwd, flash_attention_bwd, flash_attention_fwd_drop,
           flash_attention_bwd_drop, fused_mlp_fwd, fused_mlp_fwd_drop,
           w8a8_matmul, w8a8_mlp_fwd, w8a8_mlp_fwd_drop, flash_attention_fwd_long,
           fused_encoder_block)
PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16 tensor cores
PEAK_INT8_OPS = 1979e12  # H100 SXM, dense int8 tensor cores
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# device-side sleep ahead of a timed run: ~20 ms at the H100's clocks, more
# than the host takes to launch 20 calls of any timed function here
QUEUE_CYCLES = 40_000_000

SERVE_OVERRIDES = [
    "model=vlmo_base", "train=finetune_vqa", "compute_dtype=bfloat16",
    "attn_impl=pallas", "model.mlp_impl=fused",
]
BATCH = 64
N_REQUESTS = 6  # the first is the warm-up; latency is taken over the rest
CPU_CHECK_REQUESTS, CPU_CHECK_ROWS = 2, 4

# kernel vs plain version on the card, both bf16 out. The attention kernel
# keeps 16 mantissa bits of p for its second product and sums in another
# order in fp32; both round the output to bf16, so they may differ by one
# bf16 ulp (at most 2**-7 of |out|) plus the fp32 differences (1e-4 covers
# them at |out| near 0). lse is fp32 on both sides (|lse| < 20). The MLP sums
# in another order in fp32, which can flip the bf16 rounding of a hidden
# value, and both round y (|y| < 4) to bf16: one ulp is at most 2**-6.
ATTN_ATOL, ATTN_RTOL, ATTN_LSE_ATOL = 1e-4, 2 ** -7, 1e-4
# row 1 off the serving path, (batch, N), at batch 8 (BH = 96): the short
# sm90 kernel's key widths 128, 192 and 256 (the serving streams take 64
# and 256), then past SM90_FWD_MAX_N on the streamed kernel a ragged N, the
# fused backward's longest and 384^2 images (577 tokens); pretrain_txt's
# 512 tokens at batch 32 (BH = 384) are on that phase's path at dropout 0
OFF_PATH_BATCH = 8
ATTN_OFF_PATH = ((8, 100), (8, 150), (8, 256), (8, 333), (8, 512), (8, 577))
MLP_ATOL, MLP_RTOL = 2 ** -6, 2 ** -7
# GPU kernels vs the CPU plain path, end to end in bf16 over 12 blocks and
# the 3129-way head: bf16 rounding (2**-8 relative) at every layer, in other
# places on the two devices.
E2E_ATOL = 0.05

TRAIN_OVERRIDES = [
    "model=vlmo_base", "train=pretrain_mum", "compute_dtype=bfloat16",
    "train.datasets=[synthetic]", "train.discrete_vae_type=random",
    "data.batch_size=32",  # the JAX package's pretrain bench batch
]
TRAIN_BATCH = 32
TRAIN_STEPS = 5  # timed, after one warm-up step, in each training phase
EXTRA_STEPS = 2  # untimed, in each variant of a training phase
CPU_TRAIN_BATCH = 2
DROP_SEED = 1234
# rows 2, 3 and 4 off the path, (batch, N): at batch 8 (BH = 96, fewer
# heads than SMs) the widest key width the short sm90 forward takes, a
# ragged N past it (padded width 336: one head slot in the backward) and the
# fused backward's longest, and at batch 32 (BH = 384) the ragged one;
# pretrain_txt's 512 tokens at batch 32 are on that phase's path. Row 3
# takes the streamed forward past 256 keys
TRAIN_OFF_PATH = ((8, 256), (8, 333), (8, 512), (32, 333))
# backward kernels vs plain versions, bf16 out. Both sum fp32 products of
# bf16 inputs, in other orders; the kernel keeps 16 mantissa bits of p and ds
# for its products with k, q and do (2**-17 relative per term). Both round
# dq, dk and dv to bf16, which may differ by one ulp (2**-7 of |x|) where the
# fp32 values straddle a rounding boundary; 1e-3 covers the fp32 differences
# near zero of sums of up to 512 terms whose magnitudes sum to below 4 (p
# sums to 1 over the keys; |do| < 4): 512 * 2**-24 plus 4 * 2**-17 of it.
BWD_ATOL, BWD_RTOL = 1e-3, 2 ** -7
# one step on the card against the CPU's plain path, both in bf16 with sums
# in other orders through 12 blocks: losses within 2% (the bf16 rounding of
# every layer's output, 2**-8 relative, accumulated), named gradients within
# 10% in relative L2 norm. The first AdamW step moves each weight by about
# lr * sign(grad); the two devices must agree on that direction for 90% of
# the elements (gradients near zero may flip under the bf16 noise).
# itc_temp's gradient is sum(dL/dsim * sim) over the in-batch similarities,
# a difference of near-equal cosines at random weights (-1.5e-4 against a
# total gradient norm of 46.6): the bf16 rounding of the features it is
# taken from moves it by 3% to 84% between equally exact builds (on an H100,
# the fp32 plain attention among them). So its 10% holds it against the
# CPU's gradient rescaled by the two devices' closed forms from their own
# ITC features (itc_temp_closed_form), and those features are held within
# 10% in relative L2 norm: a wrong itc_temp gradient fails the first, wrong
# features the second.
LOSS_RTOL, GRAD_REL_TOL, UPDATE_AGREEMENT = 2e-2, 0.1, 0.9
# ITC_GRAD_NOTE: finetune_retrieval trains ITC without MIM, MLM or ITM. At
# random weights every image's ITC feature is nearly the same (the loss sits
# at ln 2 for 2 rows), so the loss's gradient at an image feature is a
# difference of near-equal text features (and the reverse), which the bf16
# rounding of the features (0.8% relative L2 between an H100 and the CPU)
# moves by 5-10%, and the image side's gradients with it (14-22% there;
# pretrain_mum's MIM dominates its image side). So that check feeds the
# CPU's gradient at the ITC features into the card's backward: the backward
# below the fusion layer (which IRTR's rows reach too), the text side and
# the fused experts are then held to GRAD_REL_TOL, the features too, and
# itc_temp at the card's own features as above. The image side that only
# ITC reaches (route v above the fusion layer, the image projection) sums
# each row's gradient times its near-identical features, rows whose
# gradients cancel: a difference again, 10% apart even with the fed
# gradient; those are reported, not held (ITC_ONLY_IMAGE_PARAMS).
CHECKED_PARAMS = (
    "transformer.patch_embed.weight",
    "transformer.txt_embeddings.word_embeddings.weight",
    "transformer.blocks.0.attn.qkv.weight",
    "transformer.blocks.11.mlp_vl.fc2.weight",
    "mim_head.fc.weight",
    "itc_temp",
)

# pretrain_txt: text-only MLM at BERT length (the JAX package's bert_mlm
# bench, `model.max_text_len=512` as its preset says), attn_impl=auto with
# attention dropout 0.1: rows 3 and 4 at BH = 384, N = 512 on every block
TXT_OVERRIDES = [
    "model=vlmo_base", "train=pretrain_txt", "model.max_text_len=512",
    "compute_dtype=bfloat16", "train.datasets=[synthetic]", "data.batch_size=32",
]
TXT_BATCH, TXT_LEN = 32, 512
# the trained text side must move; the fixed shared attention (0x lr) and the
# frozen vision side must not
CHECKED_TXT_PARAMS = (
    "transformer.txt_embeddings.word_embeddings.weight",
    "transformer.blocks.0.mlp_l.fc1.weight",
    "transformer.blocks.11.mlp_l.fc2.weight",
    "mlm_head.transform_dense.weight",
)
FIXED_TXT_PARAMS = ("transformer.blocks.0.attn.qkv.weight", "transformer.norm.weight",
                    "transformer.blocks.5.mlp_v.fc1.weight")
# compared with the CPU: the trained ones and a fixed attention weight's
# gradient (computed, never applied)
COMPARED_TXT_PARAMS = CHECKED_TXT_PARAMS + ("transformer.blocks.0.attn.qkv.weight",
                                            "transformer.blocks.11.attn.proj.weight")

VQA_OVERRIDES = [
    "model=vlmo_base", "train=finetune_vqa", "compute_dtype=bfloat16",
    "model.mlp_impl=fused", "train.datasets=[synthetic]",
    "data.batch_size=32",  # the JAX package's VQA bench batch
]
VQA_BATCH = 32
# the run around the step (phase 20): two steps and two eval batches an epoch
LOOP_SAMPLES = 64
# throughput mode's warm-up and timed steps (JAX's defaults are 20 and 200)
LOOP_THROUGHPUT = ["throughput_warmup=5", "throughput_iters=40"]
LOOP_REQUESTS = 3
# row 7 at the finetune_vqa step's thresholds: drop_rate 0.1 (6554) and a
# half-dropping one (32768), which reads bits with the top bit set; at the
# path's threshold also M = 64 (one row tile) and two ragged M (partial
# row tiles, one of them with the hidden split)
MLP_DROP_THRESHOLDS = (32768, 6554)
MLP_DROP_OFF_PATH_ROWS = (64, 1000, 4999)
# the fused MLP's backward on the card (bf16: the hidden recomputed and
# rounded to bf16, the gelu VJP and every product with bf16 operands and
# outputs) against the fp32 VJP of the plain function on the same bf16
# inputs: each of h1, act, dh_post and dh carries a bf16 rounding (2**-9
# relative), so each gradient within 2% in relative L2 norm, and every
# element within 5% of that gradient's largest magnitude (sums over 7,584
# rows of rounded terms may cancel to near zero)
MLP_BWD_REL_L2, MLP_BWD_ATOL_SHARE = 2e-2, 5e-2
W8A8_SERVE_OVERRIDES = SERVE_OVERRIDES + ["model.quantize=w8a8_pallas_mlp"]
W8A8_VQA_OVERRIDES = VQA_OVERRIDES + ["model.quantize=w8a8_pallas_mlp"]
# int8 kernels vs plain versions on the card, bf16 out. Both take the same
# int8 codes (the same roundings of the scales) and exact int32 sums, then
# the same fp32 products, so row 8 is expected bit for bit. Rows 9/10 pass h
# through tanh; CUDA's tanhf and PyTorch's may differ in the last bit, which
# can move a hidden code by one and an output by sh * |w2| (~3e-3 here),
# below the bf16 rounding of |y| < 4 that MLP_ATOL/MLP_RTOL allow for.
W8A8_ATOL, W8A8_RTOL = MLP_ATOL, MLP_RTOL
# the int8 serving path on the card against the CPU's: besides the bf16
# differences of E2E_ATOL, an upstream bf16 difference may move a code by one
# int8 step (1/127 of a row's absmax, about twice a bf16 ulp there)
W8A8_E2E_ATOL = 2 * E2E_ATOL
HIRES_OVERRIDES = SERVE_OVERRIDES + ["model.img_size=1024"]
HIRES_BATCH = 8  # 64^2 + 1 = 4097 image and 4137 fused tokens per row
HIRES_CPU_ROWS = 1
# the tokenizer: `DalleVAE` at 256^2 on the JAX tokenizer bench's batch
DVAE_SIZE, DVAE_BATCH, DVAE_CALLS = 256, 32, 6  # the first call is the warm-up
DVAE_CPU_BATCH = 2
# the blocks the selector fuses at 256^2, n_hid 256, and their pooling
DVAE_FUSED_BLOCKS = (("group_1_block_1", False), ("group_1_block_2", True),
                     ("group_2_block_1", False), ("group_2_block_2", True),
                     ("group_3_block_1", False))
# row 11 against its plain version, bf16 out. Both round h1, h2 and h3 to
# bf16 at the same points after fp32 sums in other orders, so a hidden value
# on a rounding boundary may differ by one bf16 ulp (2**-8 relative) and
# carry into the later convs, and both round out (|out| ~ 1 here) to bf16.
# Checked at the path's post_gain (1/64) and at 1, where the residual path
# counts in full.
DVAE_ATOL, DVAE_RTOL = 2 ** -6, 2 ** -7
CHECKED_VQA_PARAMS = (
    "transformer.patch_embed.weight",
    "transformer.txt_embeddings.word_embeddings.weight",
    "transformer.blocks.0.attn.qkv.weight",
    "transformer.blocks.0.mlp_v.fc1.weight",
    "transformer.blocks.11.mlp_vl.fc1.weight",
    "transformer.pooler.dense.weight",
    "vqa_classifier.fc2.weight",
)

# the downstream phases at vlmo_base, batch 32, synthetic data, random dVAE:
# pretrain_vis (MIM; MAE under train.loss_names=[mae]) with the fused MLP, as
# the JAX package's beit_mim bench runs it (rows 7, 3 and 4 on its 12 image
# blocks), finetune_nlvr2 and finetune_retrieval at their defaults (rows 3
# and 4: NLVR2's two fused forwards, retrieval's ITC streams and its IRTR
# rows, each image with its caption and draw_false_text = 3 false ones)
DOWNSTREAM = ["model=vlmo_base", "compute_dtype=bfloat16", "train.datasets=[synthetic]",
              "train.discrete_vae_type=random", f"data.batch_size={TRAIN_BATCH}"]
VIS_OVERRIDES = DOWNSTREAM + ["train=pretrain_vis", "model.mlp_impl=fused"]
NLVR2_OVERRIDES = DOWNSTREAM + ["train=finetune_nlvr2"]
RETRIEVAL_OVERRIDES = DOWNSTREAM + ["train=finetune_retrieval"]
IRTR_ROWS = 4  # a caption and its 3 false ones
# trained (must move) and frozen (must stay) by pretrain_vis: the text side,
# the fused experts and the pooler take no gradient
CHECKED_VIS_PARAMS = (
    "transformer.patch_embed.weight",
    "transformer.img_mask_token",
    "transformer.blocks.0.attn.qkv.weight",
    "transformer.blocks.11.mlp_v.fc2.weight",
    "mim_head.fc.weight",
)
FROZEN_VIS_PARAMS = ("transformer.txt_embeddings.word_embeddings.weight",
                     "transformer.blocks.0.mlp_l.fc1.weight",
                     "transformer.blocks.11.mlp_vl.fc1.weight",
                     "transformer.pooler.dense.weight")
CHECKED_NLVR2_PARAMS = (
    "transformer.patch_embed.weight",
    "transformer.txt_embeddings.word_embeddings.weight",
    "transformer.token_type_embeddings.weight",
    "transformer.blocks.0.attn.qkv.weight",
    "transformer.blocks.11.mlp_vl.fc1.weight",
    "transformer.pooler.dense.weight",
    "nlvr2_classifier.fc2.weight",
)
ITC_ONLY_IMAGE_PARAMS = ("transformer.blocks.11.mlp_v.fc2.weight", "itc_head.dense_v.weight")
CHECKED_RETRIEVAL_PARAMS = (
    "transformer.patch_embed.weight",
    "transformer.txt_embeddings.word_embeddings.weight",
    "transformer.blocks.0.attn.qkv.weight",
    "transformer.blocks.11.mlp_v.fc2.weight",
    "transformer.blocks.11.mlp_vl.fc1.weight",
    "itc_head.dense_v.weight",
    "rank_output.fc.weight",
    "itc_temp",
)
# retrieval recall on a small val split, on the card and on the CPU: the
# similarity matrix of the unit-norm ITC features (cosines) held within
# E2E_ATOL
RECALL_SAMPLES, RECALL_BATCH = 16, 8
# the endpoints at batch 64 under attn_impl=pallas, mlp_impl=fused: rows 1 and
# 6 on every attention and FFN call; encode_*, similarity and itm_score on
# pretrain_mum's heads, nlvr2 on finetune_nlvr2's
# pretrain_mum's full recipe (phase 23): the momentum encoder with the
# negative queues (the default 65,536 columns of itc_dim 256) and the local
# g2l ITC, and the eval EMA, at phase 6's settings
MOMENTUM_OVERRIDES = TRAIN_OVERRIDES + ["vlmo_ema=true", "train.neg_queue=true",
                                        "model_ema=true"]
MOMENTUM_LOSSES = ("i2i_Loss", "t2t_Loss", "i2i_l_Loss", "t2t_l_Loss")
MOMENTUM_LEAF = "transformer.blocks.0.attn.qkv.weight"
MOMENTUM_EVAL_BATCHES = 2
ALTERNATED_PAIRS = 12  # recipe and plain pretrain_mum steps in turn
MOMENTUM_CPU_BATCH = 4  # two microbatches of 2 at accumulation_steps=2
# the streams whose shapes phase 23 alone gives rows 1 (the momentum
# encoder under attn_impl=pallas) and 3 and 4 (accumulation_steps=2)
MOMENTUM_STREAMS = ("momentum_text", "momentum_image")
ACCUM_STREAMS = ("accum_text", "accum_image", "accum_fused", "accum_itm")
# after the step compared with the CPU, in relative L2 norm: the queues' new
# columns, each device's own momentum features bit for bit, held against
# each other within MOMENTUM_FEATURE_TOL, as are the momentum features of
# the trees drawn from MOMENTUM_GAP_SEEDS on new batches; the card's
# features from the tree's weights rounded to float8 e4m3 (the control)
# must read above it. On an H100 the gaps read 1.10-1.16% (image) and
# 0.29-0.40% (text) on all five, the e4m3 control 6.3-7.4% and 3.6-3.7%:
# the limit sits between. MOMENTUM_CPU_LEAF, set to 0 in both trees before
# the step, then holds p (1 - decay), held across the devices within
# MOMENTUM_LEAF_TOL (read 0; AdamW's first step, lr * sign(g), can leave
# at most 2 lr an element between them, under 5e-5 of this leaf), and the
# other tree's decay (0.98 and 49 apart) must read above it
MOMENTUM_GAP_SEEDS = (1, 2, 3, 4)
MOMENTUM_CPU_LEAF = "itm_head.fc.weight"  # not read by the momentum forward
MOMENTUM_FEATURE_TOL, MOMENTUM_LEAF_TOL = 2e-2, 1e-4
ENDPOINT_OVERRIDES = ["model=vlmo_base", "compute_dtype=bfloat16", "attn_impl=pallas",
                      "model.mlp_impl=fused"]


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, from CUDA events around `iters` calls.
    The calls are queued behind a device-side sleep of QUEUE_CYCLES, which
    outlasts their launch on the host, so that they run back to back and the
    host's launch overhead does not enter the time of a short kernel."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(QUEUE_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, peak: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def text_mask(rng: np.random.Generator, batch: int, length: int) -> np.ndarray:
    """Questions of 6..20 tokens padded to `length`, as VQAv2's are."""
    lens = rng.integers(6, 21, batch)
    return (np.arange(length)[None, :] < lens[:, None]).astype(np.int32)


def check_layouts() -> dict:
    """The shared memory each sm90 kernel with a layout mirrored on the
    host reports for itself against that mirror (rows 1, 2/4 at every key
    width up to SM90_BWD_MAX_N, the streamed kernel of rows 1, 3 and 5, 8,
    9 and 10), all within the 232,448 bytes a block may use."""
    fwd_smem = _build.load("flash_attention_fwd_sm90", [ctypes.c_int],
                           "flash_attention_fwd_sm90_smem")
    stream_smem_fn = _build.load("flash_attention_long_sm90", [],
                                 "flash_attention_long_sm90_smem")
    bwd_smem = _build.load("flash_attention_bwd_sm90", [ctypes.c_int] * 2,
                           "flash_attention_bwd_sm90_smem")
    mlp_smem_fn = _build.load("w8a8_mlp_sm90", [ctypes.c_int], "w8a8_mlp_sm90_smem")
    matmul_smem_fn = _build.load("w8a8_matmul_sm90", [], "w8a8_matmul_sm90_smem")
    got = {f"flash_attention_fwd_sm90 nt={nt}": (fwd_smem(nt), fwd_sm90_smem(nt))
           for nt in range(16, 257, 16)}
    for r, role in enumerate(SM90_BWD_ROLES):
        got.update({f"flash_attention_bwd_sm90 {role} nt={nt}":
                    (bwd_smem(nt, r), bwd_sm90_layout(nt, role)["smem"])
                    for nt in range(16, SM90_BWD_MAX_N + 1, 16)})
    got["flash_attention_long_sm90"] = (stream_smem_fn(), stream_smem())
    got["w8a8_matmul_sm90"] = (matmul_smem_fn(), matmul_smem())
    got["w8a8_mlp_sm90"] = (mlp_smem_fn(0), mlp_smem())
    got["w8a8_mlp_sm90 drop"] = (mlp_smem_fn(1), mlp_smem(drop=True))
    for name, (kernel, host) in got.items():
        require(kernel == host <= 232448,
                f"{name}: the kernel takes {kernel} bytes of shared memory, its host "
                f"code assumes {host}")
    return {name: kernel for name, (kernel, _) in got.items()}


def fwd_layout(bh: int, n: int, sms: int) -> dict:
    """The forward's route at (BH, N) and how it tiles the work: the short
    kernel's key width and persistent grid, or the streamed kernel's
    persistent grid over its work items (128-row query tiles x BH) and
    their 128-key blocks."""
    route = fwd_route(n)
    if route == "sm90":
        return {"route": route, "key_width": fwd_sm90_tile(n),
                "grid": fwd_sm90_grid(bh, sms)}
    tiles, _ = long_grid(bh, n)
    return {"route": route, "grid": long_ctas(bh, n, sms), "items": tiles * bh,
            "query_tile": LONG_TILE, "key_blocks": -(-n // LONG_TILE)}


def padded_mask(rng: np.random.Generator, batch: int, length: int) -> np.ndarray:
    """Rows of length // 2 .. length real keys, padded to `length`."""
    lens = rng.integers(length // 2, length + 1, batch)
    return (np.arange(length)[None, :] < lens[:, None]).astype(np.int32)


def check_attention(cfg: VlmoConfig, rng: np.random.Generator, dev,
                    only: tuple[str, ...] | None = None) -> list[dict]:
    """Row 1 against its plain version: off the path at the (batch, N) of
    ATTN_OFF_PATH (N = 100, 150 and 256 take the short sm90 kernel's other
    key widths; N = 333, 512 and 577, 384^2 images, the streamed kernel past
    SM90_FWD_MAX_N), then at the serving streams of batch 64, at the
    momentum encoder's text and image streams of pretrain_mum's batch 32
    (phase 23 under attn_impl=pallas) and at pretrain_txt's 512 tokens at
    batch 32 (its path at attention dropout 0, the streamed kernel), each
    timed beside its plain version and SDPA; with `only`, those streams
    alone."""
    heads, d = cfg.num_heads, cfg.embed_dim // cfg.num_heads
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_img = (cfg.img_size // cfg.patch_size) ** 2 + 1
    txt = text_mask(rng, BATCH, cfg.max_text_len)
    masks = {f"off_path_b{b}_n{n}": padded_mask(rng, b, n) for b, n in ATTN_OFF_PATH}
    txt512 = synthetic_text_mask(rng, TXT_BATCH, TXT_LEN)
    masks.update({
        "text": txt,
        "image": np.ones((BATCH, n_img), np.int32),
        "fused": np.concatenate([txt, np.ones((BATCH, n_img), np.int32)], 1),
        "momentum_text": synthetic_text_mask(rng, TRAIN_BATCH, cfg.max_text_len),
        "momentum_image": np.ones((TRAIN_BATCH, n_img), np.int32),
        "txt": txt512,
    })
    if only is not None:
        masks = {k: v for k, v in masks.items() if k in only}
    rows = []
    for stream, mask in masks.items():
        (batch, n), bh = mask.shape, mask.shape[0] * heads
        g = torch.Generator(device=dev).manual_seed(n)
        q, k, v = (torch.randn((bh, n, d), generator=g, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        kb = key_padding_bias(torch.from_numpy(mask).to(dev)).reshape(batch, n)
        kb = kb.contiguous()
        scale = d ** -0.5
        out, lse = flash_attention_fwd(q, k, v, kb, scale)
        ref, ref_lse = flash_attention_fwd_plain(q, k, v, kb, scale)
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        require(bool(torch.isfinite(out.float()).all()), f"attention {stream}: non-finite")
        require(bool((diff <= ATTN_ATOL + ATTN_RTOL * ref.float().abs()).all())
                and lse_err <= ATTN_LSE_ATOL,
                f"attention {stream} N={n}: max|out err| {err} beyond atol "
                f"{ATTN_ATOL} + rtol {ATTN_RTOL}, or max|lse err| {lse_err} "
                f"beyond {ATTN_LSE_ATOL}")
        q4, k4, v4 = (t.view(batch, heads, n, d) for t in (q, k, v))
        mask4 = kb.to(torch.bfloat16).view(batch, 1, 1, n)
        nbytes = 4 * bh * n * d * 2 + batch * n * 4 + bh * n * 4
        bound_ms, bound_by = bound(nbytes, 4 * bh * n * n * d)
        rows.append({
            "stream": stream, "shape": f"BH={bh} N={n} D={d}", **fwd_layout(bh, n, sms),
            "max_abs_err": err, "lse_max_abs_err": lse_err,
            "ms": time_ms(lambda: flash_attention_fwd(q, k, v, kb, scale)),
            "plain_ms": time_ms(lambda: flash_attention_fwd_plain(q, k, v, kb, scale)),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=mask4, scale=scale)),
            "bound_ms": bound_ms, "bound_by": bound_by,
        })
    return rows


def check_mlp(cfg: VlmoConfig, dev) -> list[dict]:
    """Row 6 against its plain version at every M the serving paths give it
    (batch 64 at 224^2, batch 8 at 1024^2), the M = 64 probe and two ragged
    M (not multiples of the 64-row tile, one of them split over the hidden),
    each timed beside its plain version and the bf16 chain. The last row is
    the batch-64 fused stream."""
    n_img = (cfg.img_size // cfg.patch_size) ** 2 + 1
    n_hires = (1024 // cfg.patch_size) ** 2 + 1
    g, w1, b1, w2, b2 = mlp_weights(cfg, dev, 1)
    k, h, n_out = w1.shape[1], w1.shape[0], w2.shape[0]
    b1h, b2h = b1.to(torch.bfloat16), b2.to(torch.bfloat16)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    # "probe" is no path shape: M = 64 is one row tile, its hidden split
    # over CTAs; the "ragged" rows check the masking of a partial tile
    shapes = (("probe", 64), ("ragged_split", 1000), ("ragged", 4999),
              ("hires_text", HIRES_BATCH * cfg.max_text_len),
              ("text", BATCH * cfg.max_text_len), ("image", BATCH * n_img),
              ("hires_image", HIRES_BATCH * n_hires),
              ("hires_fused", HIRES_BATCH * (cfg.max_text_len + n_hires)),
              ("fused", BATCH * (cfg.max_text_len + n_img)))
    for stream, m in shapes:
        x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
        y = fused_mlp_fwd(x, w1, b1, w2, b2)
        ref = fused_mlp_fwd_plain(x, w1, b1, w2, b2)
        torch.cuda.synchronize()
        ok, err = within(y, ref, MLP_ATOL, MLP_RTOL)
        require(ok, f"mlp {stream} M={m}: max|err| {err} beyond atol {MLP_ATOL} "
                f"+ rtol {MLP_RTOL}")
        nbytes = 2 * (m * k + h * k + n_out * h + m * n_out) + 4 * (h + n_out)
        bound_ms, bound_by = bound(nbytes, 2 * m * (k * h + h * n_out))
        rows.append({
            "stream": stream, "shape": f"M={m} K={k} H={h} N={n_out}",
            "cluster": MLP_CLUSTER, "hidden_splits": hidden_splits(m, h, sms),
            "max_abs_err": err,
            "ms": time_ms(lambda: fused_mlp_fwd(x, w1, b1, w2, b2)),
            "plain_ms": time_ms(lambda: fused_mlp_fwd_plain(x, w1, b1, w2, b2)),
            "library_ms": time_ms(lambda: F.linear(
                F.gelu(F.linear(x, w1, b1h), approximate="tanh"), w2, b2h)),
            "bound_ms": bound_ms, "bound_by": bound_by,
        })
        del x, y, ref
    return rows


def mlp_weights(cfg: VlmoConfig, dev, seed: int):
    """Seeded bf16 (w1, w2) and fp32 (b1, b2) at the model's FFN widths."""
    k = n_out = cfg.embed_dim
    h = int(cfg.embed_dim * cfg.mlp_ratio)
    g = torch.Generator(device=dev).manual_seed(seed)
    w1 = (torch.randn((h, k), generator=g, device=dev) * 0.02).to(torch.bfloat16)
    w2 = (torch.randn((n_out, h), generator=g, device=dev) * 0.02).to(torch.bfloat16)
    b1 = torch.randn(h, generator=g, device=dev) * 0.02
    b2 = torch.randn(n_out, generator=g, device=dev) * 0.02
    return g, w1, b1, w2, b2


def vqa_mlp_rows(cfg: VlmoConfig) -> tuple[int, ...]:
    """M of the finetune_vqa step's FFN calls at batch 32: text (mlp_l),
    image (mlp_v) and fused (mlp_vl) rows."""
    n_img = (cfg.img_size // cfg.patch_size) ** 2 + 1
    return tuple(VQA_BATCH * n for n in (cfg.max_text_len, n_img,
                                         cfg.max_text_len + n_img))


def check_mlp_drop(cfg: VlmoConfig, dev) -> list[dict]:
    """Row 7 against `fused_mlp_fwd_drop_plain` at each FFN shape of the
    finetune_vqa step and each threshold, and at the path's threshold at
    M = 64 (one row tile, its hidden split over CTAs) and two ragged M (one
    of them split), on seeded int16 bits; then the kernel, the plain
    version and the library chain (bf16 linear, tanh gelu, where, linear)
    timed. The last row is the path's threshold at the largest shape."""
    g, w1, b1, w2, b2 = mlp_weights(cfg, dev, 2)
    k, h, n_out = w1.shape[1], w1.shape[0], w2.shape[0]
    b1h, b2h = b1.to(torch.bfloat16), b2.to(torch.bfloat16)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for t in MLP_DROP_THRESHOLDS:
        scale = torch.tensor(keep_scale16(t), dtype=torch.bfloat16, device=dev)
        extra = MLP_DROP_OFF_PATH_ROWS if t == MLP_DROP_THRESHOLDS[-1] else ()
        for m in extra + vqa_mlp_rows(cfg):
            x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
            bits = torch.randint(-32768, 32768, (m, h), dtype=torch.int16,
                                 generator=g, device=dev)
            y = fused_mlp_fwd_drop(x, w1, b1, w2, b2, bits, t)
            ref = fused_mlp_fwd_drop_plain(x, w1, b1, w2, b2, bits, t)
            torch.cuda.synchronize()
            ok, err = within(y, ref, MLP_ATOL, MLP_RTOL)
            require(ok, f"mlp_drop t={t} M={m}: max|err| {err} beyond atol "
                    f"{MLP_ATOL} + rtol {MLP_RTOL}")

            def library():
                hh = F.gelu(F.linear(x, w1, b1h), approximate="tanh")
                hh = torch.where(keep16(bits, t), hh * scale, torch.zeros_like(hh))
                return F.linear(hh, w2, b2h)

            nbytes = (2 * (m * k + h * k + n_out * h + m * n_out) + 4 * (h + n_out)
                      + 2 * m * h)
            bound_ms, bound_by = bound(nbytes, 2 * m * (k * h + h * n_out))
            rows.append({
                "threshold": t, "shape": f"M={m} K={k} H={h} N={n_out}",
                "on_path": m not in extra,
                "cluster": MLP_CLUSTER, "hidden_splits": hidden_splits(m, h, sms),
                "max_abs_err": err,
                "kept_share": keep16(bits, t).float().mean().item(),
                "ms": time_ms(lambda: fused_mlp_fwd_drop(x, w1, b1, w2, b2, bits, t)),
                "plain_ms": time_ms(lambda: fused_mlp_fwd_drop_plain(
                    x, w1, b1, w2, b2, bits, t), iters=5),
                "library_ms": time_ms(library),
                "bound_ms": bound_ms, "bound_by": bound_by,
            })
    return rows


def check_mlp_backward(cfg: VlmoConfig, dev) -> dict:
    """The fused MLP's autograd backward (`fused_mlp` on bf16 x, fp32 master
    weights, bits at drop_rate 0.1), as the finetune_vqa step runs it, at
    the largest FFN shape: every gradient against the fp32 VJP of the plain
    function on the same inputs; then the backward timed (the forward's
    graph kept) beside the fp32 plain backward and the bf16 library chain's
    backward."""
    g, w1, b1, w2, b2 = mlp_weights(cfg, dev, 3)
    m, t = vqa_mlp_rows(cfg)[-1], MLP_DROP_THRESHOLDS[-1]
    k, h = w1.shape[1], w1.shape[0]
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    bits = torch.randint(-32768, 32768, (m, h), dtype=torch.int16, generator=g,
                         device=dev)
    gy = torch.randn((m, w2.shape[0]), generator=g, device=dev).to(torch.bfloat16)
    keep = keep16(bits, t)

    def leaves(dtype):
        return [a.detach().to(dtype).requires_grad_()
                for a in (x, w1.float(), b1, w2.float(), b2)]

    kl = [x.detach().requires_grad_()] + leaves(torch.float32)[1:]
    y = fused_mlp(*kl, bits, t)
    grads = torch.autograd.grad(y, kl, gy, retain_graph=True)

    def plain(a, u1, c1, u2, c2):
        hh = gelu_tanh(F.linear(a, u1, c1))
        hh = torch.where(keep, hh * keep_scale16(t), torch.zeros_like(hh))
        return F.linear(hh, u2, c2)

    pl = leaves(torch.float32)
    yp = plain(*pl)
    want = torch.autograd.grad(yp, pl, gy.float(), retain_graph=True)
    torch.cuda.synchronize()
    errs = {}
    for name, got, ref in zip(("dx", "dw1", "db1", "dw2", "db2"), grads, want):
        got, ref = got.float(), ref.float()
        rel = ((got - ref).norm() / ref.norm().clamp_min(1e-30)).item()
        worst = ((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30)).item()
        errs[name] = {"rel_l2": rel, "max_abs_err_share": worst}
        require(bool(torch.isfinite(got).all()) and rel <= MLP_BWD_REL_L2
                and worst <= MLP_BWD_ATOL_SHARE,
                f"fused MLP backward {name}: rel L2 {rel}, max err share {worst} "
                f"beyond {MLP_BWD_REL_L2}, {MLP_BWD_ATOL_SHARE}")
    lb = leaves(torch.bfloat16)
    yl = F.linear(torch.where(keep, F.gelu(F.linear(lb[0], lb[1], lb[2]),
                                           approximate="tanh") * keep_scale16(t), 0.0),
                  lb[3], lb[4])
    # read x, gy, the bits, the fp32 weights and b1; write dx, the fp32
    # weight gradients, db1 and db2. Products: h1 is recomputed (K.H), then
    # dh_post, dx, dw1 and dw2
    n_out = w2.shape[0]
    nbytes = 2 * (2 * m * k + m * n_out + m * h) + 8 * (h * k + n_out * h) + 4 * (2 * h + n_out)
    bound_ms, bound_by = bound(nbytes, 2 * m * (3 * k * h + 2 * h * n_out))
    return {
        "shape": f"M={m} K={k} H={h}", "threshold": t, "errors": errs,
        "bwd_ms": time_ms(lambda: torch.autograd.grad(y, kl, gy, retain_graph=True)),
        "plain_bwd_ms": time_ms(lambda: torch.autograd.grad(yp, pl, gy.float(),
                                                            retain_graph=True), iters=5),
        "library_bwd_ms": time_ms(lambda: torch.autograd.grad(yl, lb, gy,
                                                              retain_graph=True)),
        "bwd_bound_ms": bound_ms, "bwd_bound_by": bound_by,
    }


def serve_rows(cfg: VlmoConfig) -> tuple[int, ...]:
    """M of a VQA request's linear and FFN calls at batch 64: text, image and
    fused rows."""
    n_img = (cfg.img_size // cfg.patch_size) ** 2 + 1
    return tuple(BATCH * n for n in (cfg.max_text_len, n_img, cfg.max_text_len + n_img))


def int_mm_rows(x, qw, sw):
    """Row 8's function through the library int8 GEMM: the rows quantized
    by PyTorch ops, `torch._int_mm`, the dequantization."""
    qx, sx = row_quant(x.float())
    return (torch._int_mm(qx, qw.T).float() * sx * sw).to(x.dtype)


def int_mm_mlp(x, qw1, sw1, b1, qw2, sw2, b2, bits=None, t=0):
    """Rows 9/10's function through `torch._int_mm` and PyTorch ops."""
    qx, sx = row_quant(x.float())
    h = F.gelu(torch._int_mm(qx, qw1.T).float() * sx * sw1 + b1, approximate="tanh")
    if bits is not None:
        h = torch.where(keep16(bits, t), h * keep_scale16(t), 0.0)
    qh, sh = row_quant(h)
    return (torch._int_mm(qh, qw2.T).float() * sh * sw2 + b2).to(x.dtype)


def check_w8a8_matmul(cfg: VlmoConfig, dev) -> list[dict]:
    """Row 8 bit for bit against `w8a8_matmul_plain` for proj (N = 768)
    and qkv (N = 2304) at M = 64, two ragged M, the finetune_vqa step's M
    and the serving path's M, with the grid of each; each timed beside its
    plain version, the `torch._int_mm` chain (`library_ms`) and the bf16
    `F.linear`. The last row is qkv at the largest M."""
    g = torch.Generator(device=dev).manual_seed(4)
    k = cfg.embed_dim
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for n_out in (k, 3 * k):
        w = (torch.randn((n_out, k), generator=g, device=dev) * 0.02).to(torch.bfloat16)
        qw, sw = quantize_weights(w)
        for m in MLP_DROP_OFF_PATH_ROWS + vqa_mlp_rows(cfg) + serve_rows(cfg):
            x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
            y = w8a8_matmul(x, qw, sw)
            ref = w8a8_matmul_plain(x, qw, sw)
            torch.cuda.synchronize()
            err = (y.float() - ref.float()).abs().max().item()
            require(torch.equal(y, ref), f"w8a8_matmul M={m} N={n_out}: max|err| {err}, "
                    "not bit for bit with its plain version")
            nbytes = 2 * m * k + n_out * k + 4 * n_out + 2 * m * n_out
            bound_ms, bound_by = bound(nbytes, 2 * m * k * n_out, PEAK_INT8_OPS)
            rows.append({
                "shape": f"M={m} K={k} N={n_out}",
                "on_path": m not in MLP_DROP_OFF_PATH_ROWS,
                "grid": list(matmul_grid(m, n_out, sms)), "max_abs_err": err,
                "exact_share": (y == ref).float().mean().item(),
                "ms": time_ms(lambda: w8a8_matmul(x, qw, sw)),
                "plain_ms": time_ms(lambda: w8a8_matmul_plain(x, qw, sw), iters=5),
                "library_ms": time_ms(lambda: int_mm_rows(x, qw, sw)),
                "bf16_ms": time_ms(lambda: F.linear(x, w)),
                "bound_ms": bound_ms, "bound_by": bound_by,
            })
    return rows


def w8a8_mlp_weights(cfg: VlmoConfig, dev, seed: int):
    """`mlp_weights` with fp32 weights, and their codes and scales."""
    g, w1, b1, w2, b2 = mlp_weights(cfg, dev, seed)
    return g, (w1, w2), (*quantize_weights(w1.float()), b1, *quantize_weights(w2.float()), b2)


def check_w8a8_mlp(cfg: VlmoConfig, dev, drop: bool) -> list[dict]:
    """Rows 9 (drop False: M = 64 and two ragged M, the finetune_vqa step's
    M at dropout 0, then the serving M) and 10 (drop True: the step's M at
    each threshold, and at the path's threshold first M = 64 and two ragged
    M) against their plain versions on seeded inputs and bits, with the
    grid and hidden split of each; each timed beside its plain version, the
    `torch._int_mm` chain (`library_ms`) and the bf16 chain. The last row is
    the path's largest shape (and threshold)."""
    g, (w1, w2), args = w8a8_mlp_weights(cfg, dev, 5 + drop)
    k, h, n_out = w1.shape[1], w1.shape[0], w2.shape[0]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def splits(m):
        return mlp_splits(m, h, sms)
    b1h, b2h = args[2].to(torch.bfloat16), args[5].to(torch.bfloat16)
    path_t = MLP_DROP_THRESHOLDS[-1]
    cases = ([(t, m) for t in MLP_DROP_THRESHOLDS
              for m in (MLP_DROP_OFF_PATH_ROWS if t == path_t else ()) + vqa_mlp_rows(cfg)]
             if drop else [(0, m) for m in MLP_DROP_OFF_PATH_ROWS + vqa_mlp_rows(cfg)
                           + serve_rows(cfg)])
    rows = []
    for t, m in cases:
        x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
        bits = (torch.randint(-32768, 32768, (m, h), dtype=torch.int16, generator=g,
                              device=dev) if drop else None)
        extra = (bits, t) if drop else ()
        kern, plain = ((w8a8_mlp_fwd_drop, w8a8_mlp_fwd_drop_plain) if drop
                       else (w8a8_mlp_fwd, w8a8_mlp_fwd_plain))
        y, ref = kern(x, *args, *extra), plain(x, *args, *extra)
        torch.cuda.synchronize()
        ok, err = within(y, ref, W8A8_ATOL, W8A8_RTOL)
        require(ok, f"{kern.__name__} t={t} M={m}: max|err| {err} beyond atol "
                f"{W8A8_ATOL} + rtol {W8A8_RTOL}")

        def bf16_chain():
            hh = F.gelu(F.linear(x, w1, b1h), approximate="tanh")
            if drop:
                hh = torch.where(keep16(bits, t), hh * keep_scale16(t), 0.0)
            return F.linear(hh, w2, b2h)

        nbytes = (2 * m * k + h * k + n_out * h + 8 * (h + n_out) + 2 * m * n_out
                  + (2 * m * h if drop else 0))
        bound_ms, bound_by = bound(nbytes, 2 * m * (k * h + h * n_out), PEAK_INT8_OPS)
        rows.append({
            "threshold": t, "shape": f"M={m} K={k} H={h} N={n_out}",
            "on_path": m not in MLP_DROP_OFF_PATH_ROWS,
            "grid": [mlp_grid(m, splits(m)), splits(m)],
            "max_abs_err": err,
            "exact_share": (y == ref).float().mean().item(),
            "ms": time_ms(lambda: kern(x, *args, *extra)),
            "plain_ms": time_ms(lambda: plain(x, *args, *extra), iters=5),
            "library_ms": time_ms(lambda: int_mm_mlp(x, *args, *extra)),
            "bf16_ms": time_ms(bf16_chain),
            "bound_ms": bound_ms, "bound_by": bound_by,
        })
    return rows


def check_quant_dot(cfg: VlmoConfig, dev) -> dict:
    """`quant_dot` (model.quantize=w8a8: one scale for all of x, the product
    through `torch._int_mm`) against the exact float64 product of the same
    codes, at the qkv shape of a text stream: both sums are exact integers,
    so the outputs are equal."""
    g = torch.Generator(device=dev).manual_seed(7)
    k, m = cfg.embed_dim, serve_rows(cfg)[0]
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn((3 * k, k), generator=g, device=dev) * 0.02).to(torch.bfloat16)
    y = quant_dot(x, w)
    (qx, sx), (qw, sw) = _quantize_int8(x), _quantize_int8(w, 1)
    ref = (int8_product(qx, qw) * (sx.reshape(()) * sw.reshape(-1))).to(x.dtype)
    torch.cuda.synchronize()
    require(torch.equal(y, ref), "quant_dot differs from the exact product of its codes")
    return {"shape": f"M={m} K={k} N={3 * k}", "equal": True,
            "ms": time_ms(lambda: quant_dot(x, w))}


def check_attention_long(cfg: VlmoConfig, rng: np.random.Generator, dev) -> list[dict]:
    """Row 5 against `flash_attention_fwd_long_plain` at the high-resolution
    serving shapes (batch HIRES_BATCH): the image stream (N = 4097) and the
    fused one (N = 4137), each timed beside its plain version and SDPA;
    before them two off-path cases: the image stream at batch 1, and the
    fused stream with every key of the first 128-key block of one batch row
    masked (the online rescale from a block with no real key). The last row
    is the fused stream."""
    heads, d = cfg.num_heads, cfg.embed_dim // cfg.num_heads
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_img = (cfg.img_size // cfg.patch_size) ** 2 + 1
    txt = text_mask(rng, HIRES_BATCH, cfg.max_text_len)
    fused = np.concatenate([txt, np.ones((HIRES_BATCH, n_img), np.int32)], 1)
    first_block_masked = fused.copy()
    first_block_masked[HIRES_BATCH // 2, :LONG_TILE] = 0
    masks = {"image_b1": np.ones((1, n_img), np.int32),
             "fused_first_block_masked": first_block_masked,
             "image": np.ones((HIRES_BATCH, n_img), np.int32),
             "fused": fused}
    rows = []
    for stream, mask in masks.items():
        (batch, n), bh = mask.shape, mask.shape[0] * heads
        require(padded_len(n) > FULL_ROW_FWD_MAX, f"N={n} does not take row 5")
        g = torch.Generator(device=dev).manual_seed(n)
        q, k, v = (torch.randn((bh, n, d), generator=g, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        kb = key_padding_bias(torch.from_numpy(mask).to(dev)).reshape(batch, n)
        kb = kb.contiguous()
        scale = d ** -0.5
        out = flash_attention_fwd_long(q, k, v, kb, scale)
        ref = flash_attention_fwd_long_plain(q, k, v, kb, scale)
        torch.cuda.synchronize()
        ok, err = within(out, ref, ATTN_ATOL, ATTN_RTOL)
        require(ok, f"attention_long {stream} N={n}: max|err| {err} beyond atol "
                f"{ATTN_ATOL} + rtol {ATTN_RTOL}")
        q4, k4, v4 = (t.view(batch, heads, n, d) for t in (q, k, v))
        mask4 = kb.to(torch.bfloat16).view(batch, 1, 1, n)
        nbytes = 4 * bh * n * d * 2 + batch * n * 4
        bound_ms, bound_by = bound(nbytes, 4 * bh * n * n * d)
        del ref
        rows.append({
            "stream": stream, "shape": f"BH={bh} N={n} D={d}",
            "grid": long_ctas(bh, n, sms), "items": math.prod(long_grid(bh, n)),
            "max_abs_err": err,
            "ms": time_ms(lambda: flash_attention_fwd_long(q, k, v, kb, scale)),
            "plain_ms": time_ms(lambda: flash_attention_fwd_long_plain(q, k, v, kb, scale),
                                iters=3, warmup=1),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=mask4, scale=scale)),
            "bound_ms": bound_ms, "bound_by": bound_by,
        })
        del q, k, v, q4, k4, v4, out
        torch.cuda.empty_cache()
    return rows


def dvae_encoder(dtype: torch.dtype, dev, quantize: str = "none") -> DalleEncoder:
    """The tokenizer's encoder at n_hid 256: seeded lecun-normal kernels
    (`init_random`) and seeded non-zero biases, the same for every dtype and
    mode."""
    enc = DalleEncoder(dtype=dtype, quantize=quantize)
    g = torch.Generator().manual_seed(11)
    enc.init_random(g)
    with torch.no_grad():
        for name, p in enc.named_parameters():
            if name.endswith("bias"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.05)
    return enc.to(dev).requires_grad_(False).eval()


def dvae_block_shapes():
    """(name, pool, h) of each fused block and its input's height (= width)
    at DVAE_SIZE^2."""
    out, h = [], DVAE_SIZE
    for name, pool in DVAE_FUSED_BLOCKS:
        out.append((name, pool, h))
        if pool:
            h //= 2
    return out


def check_dvae_block(dev) -> list[dict]:
    """Row 11 against `fused_encoder_block_plain` at the five blocks the
    tokenizer fuses (batch DVAE_BATCH, 256^2, bf16), at the path's post_gain
    and at 1, on seeded inputs; each timed beside its plain version and the
    bf16 cuDNN chain of the same block (the `EncoderBlock` on channels-last
    memory, and the max-pool where the block pools). The kernel's time
    leaves out the weights' layout, which the first call builds and keeps
    on the block. The last row is g3b1."""
    enc = dvae_encoder(torch.bfloat16, dev)
    g = torch.Generator(device=dev).manual_seed(12)
    # off the path, checked only: images that cut the kernel's tiles (56 is
    # 3.5 tiles of 16 columns at nh 128; 40 is 2.5 tiles of 16 at nh 64,
    # pooled), batch 2
    for name, pool, h in (("group_2_block_1", False, 56), ("group_1_block_2", True, 40)):
        blk = getattr(enc, name)
        x = torch.randn((2, h, h, block_widths(blk)[0]), generator=g,
                        device=dev).to(torch.bfloat16)
        ok, err = within(fused_encoder_block(x, blk, 1.0, pool),
                         fused_encoder_block_plain(x, blk, 1.0, pool), DVAE_ATOL, DVAE_RTOL)
        require(ok, f"dvae_block {name} at {h}x{h}: max|err| {err} beyond atol "
                f"{DVAE_ATOL} + rtol {DVAE_RTOL}")
        print(f"dvae_block: {name} at {h}x{h} (tiles cut by the edge), pool={pool}: "
              f"max|err| {err}", flush=True)
    rows = []
    for name, pool, h in dvae_block_shapes():
        blk = getattr(enc, name)
        cin, nh, cout = block_widths(blk)
        x = torch.randn((DVAE_BATCH, h, h, cin), generator=g, device=dev).to(torch.bfloat16)
        errs = []
        for pg in (enc.post_gain, 1.0):
            out = fused_encoder_block(x, blk, pg, pool)
            ref = fused_encoder_block_plain(x, blk, pg, pool)
            torch.cuda.synchronize()
            ok, err = within(out, ref, DVAE_ATOL, DVAE_RTOL)
            require(ok, f"dvae_block {name} post_gain={pg}: max|err| {err} beyond atol "
                    f"{DVAE_ATOL} + rtol {DVAE_RTOL}")
            errs.append(err)
            del out, ref

        def library():
            y = blk(x.permute(0, 3, 1, 2))
            return F.max_pool2d(y, 2) if pool else y

        pixels = DVAE_BATCH * h * h
        flops = 2 * pixels * (9 * (cin * nh + 2 * nh * nh) + nh * cout
                              + (cin * cout if blk.id_conv is not None else 0))
        weights = 2 * (9 * (cin * nh + 2 * nh * nh) + nh * cout
                       + (cin * cout if blk.id_conv is not None else 0))
        nbytes = 2 * pixels * cin + 2 * pixels * cout // (4 if pool else 1) + weights
        bound_ms, bound_by = bound(nbytes, flops)
        grid, tile, cluster = kernel_grid(nh, h, h, DVAE_BATCH)
        rows.append({
            "block": name, "shape": f"B={DVAE_BATCH} H=W={h} cin={cin} nh={nh} "
            f"cout={cout} pool={pool}", "tile": tile, "ctas": grid, "cluster": cluster,
            "max_abs_err": max(errs),
            "max_abs_err_by_post_gain": errs,
            "ms": time_ms(lambda: fused_encoder_block(x, blk, enc.post_gain, pool), iters=10),
            "plain_ms": time_ms(lambda: fused_encoder_block_plain(x, blk, enc.post_gain, pool),
                                iters=3, warmup=1),
            "library_ms": time_ms(library, iters=10),
            "bound_ms": bound_ms, "bound_by": bound_by, "gflop": flops / 1e9,
        })
        del x
        torch.cuda.empty_cache()
    return rows


# the tokenizer's four ways: DalleVAE keyword arguments
DVAE_MODES = {"fused": {"fused": True}, "unfused": {}, "w8a8": {"quantize": "w8a8"},
              "w8a8_shifted": {"quantize": "w8a8_shifted"}}
# the card against the CPU on the same DVAE_CPU_BATCH images (int8
# activation scales are per tensor, so both sides tokenize the same batch),
# token agreement. Int8: the trunk's codes, integer sums and elementwise
# bf16 steps are the same operations on both devices, so only the fp32
# output conv sums in another order (a flip needs a top-2 gap near 1e-6).
# bf16: both round every layer to bf16 after sums in other orders; through
# 16 blocks that moves the logits by about a percent, which flips the near
# ties of random weights.
DVAE_CPU_AGREEMENT = {"fused": 0.9, "w8a8": 0.99}


def tokenize_phase(card: str, dev) -> tuple[dict, dict]:
    """DVAE_CALLS calls of `DalleVAE.get_codebook_indices(map_pixels(x))`
    on DVAE_BATCH seeded images at 256^2 (bf16, the same seeded weights)
    for each of DVAE_MODES, timed one by one with a synchronise around each
    (images already on the card), every kernel's launches counted; the
    int8 emitters' ids must be equal; each mode's token agreement with the
    unfused bf16 path; then the fused and w8a8 paths against the CPU on the
    first DVAE_CPU_BATCH images (tokenized as one batch on both devices).
    Returns the results and the fused path's launches."""
    state = dvae_encoder(torch.bfloat16, "cpu").state_dict()
    rng = np.random.default_rng(21)
    images = [torch.from_numpy(rng.random((DVAE_BATCH, DVAE_SIZE, DVAE_SIZE, 3),
                                          dtype=np.float32)).to(dev)
              for _ in range(DVAE_CALLS)]
    results, ids, small, fused_launches = {}, {}, {}, None
    for mode, kw in DVAE_MODES.items():
        vae = DalleVAE(DVAE_SIZE, dtype=torch.bfloat16, device=dev, **kw)
        vae.encoder.load_state_dict(state)
        vae.eval()
        for fn in KERNELS:
            fn.launches = 0
        out, times = [], []
        for img in images:
            torch.cuda.synchronize()
            t = time.perf_counter()
            out.append(vae.get_codebook_indices(map_pixels(img)))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        launches = {fn.__name__: fn.launches for fn in KERNELS}
        if mode in DVAE_CPU_AGREEMENT:
            small[mode] = vae.get_codebook_indices(
                map_pixels(images[0][:DVAE_CPU_BATCH])).cpu()
        expected = len(DVAE_FUSED_BLOCKS) if mode == "fused" else 0
        require_launches(f"tokenize_{mode}", launches, {"fused_encoder_block": expected},
                         DVAE_CALLS)
        if mode == "fused":
            fused_launches = launches
        ids[mode] = torch.stack(out)
        grid = (DVAE_SIZE // 8) ** 2
        require(ids[mode].shape == (DVAE_CALLS, DVAE_BATCH, grid)
                and int(ids[mode].min()) >= 0 and int(ids[mode].max()) < 8192,
                f"tokenize_{mode}: bad ids {tuple(ids[mode].shape)}")
        med = statistics.median(times[1:])
        results[mode] = {
            "first_call_ms": times[0] * 1e3, "ms": [x * 1e3 for x in times[1:]],
            "median_ms": med * 1e3, "images_per_s": DVAE_BATCH / med,
            "launches": launches,
        }
        del vae
        torch.cuda.empty_cache()
    require(torch.equal(ids["w8a8"], ids["w8a8_shifted"]),
            "tokenize: the int8 emitters' token ids differ")
    for mode in DVAE_MODES:
        results[mode]["agreement_with_unfused"] = (
            (ids[mode] == ids["unfused"]).float().mean().item())

    for mode, floor in DVAE_CPU_AGREEMENT.items():
        vae = DalleVAE(DVAE_SIZE, dtype=torch.bfloat16, device="cpu", **DVAE_MODES[mode])
        vae.encoder.load_state_dict(state)
        t = time.perf_counter()
        cpu = vae.eval().get_codebook_indices(map_pixels(images[0][:DVAE_CPU_BATCH].cpu()))
        cpu_s = time.perf_counter() - t
        agree = (cpu == small[mode]).float().mean().item()
        results[mode]["cpu_check"] = {"batch": DVAE_CPU_BATCH, "agreement": agree,
                                      "cpu_s": cpu_s}
        print(f"tokenize_{mode}: GPU vs CPU token agreement {agree} at batch "
              f"{DVAE_CPU_BATCH} ({cpu_s:.1f} s on the CPU)", flush=True)
        require(agree >= floor, f"tokenize_{mode}: GPU vs CPU token agreement {agree} "
                f"below {floor}")
    print("tokenize: " + json.dumps({"card": card, "batch": DVAE_BATCH,
                                     "size": DVAE_SIZE, "calls": DVAE_CALLS,
                                     **results}), flush=True)
    return results, fused_launches


def make_requests(cfg: VlmoConfig, rng: np.random.Generator, count: int = N_REQUESTS,
                  batch: int = BATCH):
    """`count` batches of (uint8 NHWC images, token ids, attention mask)."""
    reqs = []
    for _ in range(count):
        img = rng.integers(0, 256, (batch, cfg.img_size, cfg.img_size, 3),
                           dtype=np.uint8)
        mask = text_mask(rng, batch, cfg.max_text_len)
        ids = rng.integers(1000, cfg.vocab_size, mask.shape).astype(np.int32)
        ids[:, 0] = 101  # [CLS]
        ids[np.arange(batch), mask.sum(1) - 1] = 102  # [SEP]
        ids[mask == 0] = 0  # [PAD]
        reqs.append((img, ids, mask))
    return reqs


def img_txt_calls(cfg: VlmoConfig) -> int:
    """Attention calls and FFN calls of one img-txt forward (a VQA request,
    or one forward of the finetune_vqa step): the image and text streams
    below the fusion layer, the fused rows above it."""
    return 2 * cfg.fusion_layer + (cfg.depth - cfg.fusion_layer)


def serve(tag: str, cfg_dict: dict, cfg: VlmoConfig, card: str, expected: dict,
          requests: int = N_REQUESTS, e2e_atol: float | None = E2E_ATOL,
          batch: int = BATCH, cpu_check: tuple[int, int] = (CPU_CHECK_REQUESTS,
                                                            CPU_CHECK_ROWS)):
    """`requests` VQA requests of `batch` rows through `Predictor.vqa_logits`
    on the card, seeded weights (seed 0) and requests; every kernel's
    launches counted against `expected` (per request). With `e2e_atol`, the
    first `cpu_check` = (requests, rows) are compared with the CPU plain
    path. Returns the launches and the logits."""
    t0 = time.perf_counter()
    state = build_model(cfg_dict, device="cpu", seed=0).state_dict()
    gpu = Predictor(cfg_dict, state, max_batch=batch, device="cuda")
    print(f"{tag}: vlmo_base weights (seed 0) ready in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    reqs = make_requests(cfg, np.random.default_rng(0), requests, batch)

    for fn in KERNELS:
        fn.launches = 0
    latencies, outputs = [], []
    for img, ids, mask in reqs:
        t = time.perf_counter()
        logits = gpu.vqa_logits(img, ids, mask)
        latencies.append(time.perf_counter() - t)
        outputs.append(logits)
    launches = {fn.__name__: fn.launches for fn in KERNELS}
    require_launches(tag, launches, expected, requests)
    for logits in outputs:
        require(logits.shape == (batch, cfg.vqa_label_size)
                and bool(np.isfinite(logits).all()),
                f"bad logits: shape {logits.shape}, finite {np.isfinite(logits).all()}")
    answers = gpu.answers(outputs[0])
    require(len(answers) == batch and all(isinstance(a, str) for a in answers),
            "answer mapping failed")

    errs, agree = [], []
    check_requests, check_rows = cpu_check
    if e2e_atol is not None:
        cpu = Predictor(cfg_dict, state, max_batch=batch, device="cpu")
        for r in range(check_requests):
            img, ids, mask = (a[:check_rows] for a in reqs[r])
            ref = cpu.vqa_logits(img, ids, mask)
            got = outputs[r][:check_rows]
            errs.append(float(np.abs(got - ref).max()))
            agree.append(float((got.argmax(-1) == ref.argmax(-1)).mean()))
        max_logit = float(max(np.abs(o).max() for o in outputs))
        print(f"{tag}: GPU vs CPU plain path on {check_rows} rows of "
              f"{check_requests} requests: max|logit err| {errs} "
              f"(tol {e2e_atol}, max|logit| {max_logit:.3f}), argmax agreement {agree}",
              flush=True)
        require(max(errs) <= e2e_atol, f"{tag}: GPU logits differ from the CPU path: {errs}")

    steady = latencies[1:]
    med = statistics.median(steady)
    result = {
        "card": card, "batch": batch, "requests": requests,
        "first_request_ms": latencies[0] * 1e3,
        "latency_ms": [x * 1e3 for x in steady],
        "median_latency_ms": med * 1e3,
        "images_per_s": batch / med,
        "launches": launches, "expected_launches_per_request": expected,
        "cpu_check_max_abs_err": errs, "cpu_check_argmax_agreement": agree,
        "sample_answers": answers[:4],
    }
    print(f"{tag}: " + json.dumps(result), flush=True)
    return launches, outputs


def attention_calls_per_step(cfg: VlmoConfig) -> int:
    """Attention calls of one pretrain_mum step: ITC's image and text streams
    (every block), MLM's masked text below the fusion layer and its fused
    rows above it, MIM's image stream, and ITM's fused pair rows."""
    d, f = cfg.depth, cfg.fusion_layer
    return 2 * d + (f + (d - f)) + d + (d - f)


def synthetic_text_mask(rng: np.random.Generator, batch: int, length: int) -> np.ndarray:
    """length/2..length valid tokens, as the synthetic pretrain texts have."""
    lens = rng.integers(length // 2, length + 1, batch)
    return (np.arange(length)[None, :] < lens[:, None]).astype(np.int32)


def within(got: torch.Tensor, want: torch.Tensor, atol: float, rtol: float) -> tuple[bool, float]:
    diff = (got.float() - want.float()).abs()
    ok = bool(torch.isfinite(got.float()).all()) and bool(
        (diff <= atol + rtol * want.float().abs()).all())
    return ok, diff.max().item()


def check_attention_train(cfg: VlmoConfig, rng: np.random.Generator, dev,
                          only: tuple[str, ...] | None = None) -> dict:
    """Rows 2, 3 and 4 off the path at the (batch, N) of TRAIN_OFF_PATH
    (the backward on its sm90 kernels throughout, with its work units),
    then at each shape of the pretrain_mum step: the text, image and fused
    (MLM) streams at B = 32 and ITM's fused pair rows at 3B, all on the
    short sm90 forward, then finetune_retrieval's IRTR rows (each image
    fused with its caption and 3 false ones: 4B = 128 rows, BH = 1,536, N =
    237), the microbatches of pretrain_mum at accumulation_steps=2 (phase
    23: the three streams at B/2, BH = 192, and ITM's pair rows at 3B/2, BH
    = 576), and last pretrain_txt's 512 tokens at B = 32 (row 3 on the
    streamed forward); with `only`, those streams alone. Each
    kernel against its plain version on the same inputs, then
    the kernel, the plain version and SDPA timed: the forward rows against
    SDPA's forward, the backward rows against SDPA's backward alone (its
    forward run once, outside the timing) and, as `library_fwd_bwd_ms`,
    its forward and backward together."""
    heads, d = cfg.num_heads, cfg.embed_dim // cfg.num_heads
    n_img = (cfg.img_size // cfg.patch_size) ** 2 + 1
    rate, scale = cfg.attn_drop_rate, d ** -0.5
    txt = synthetic_text_mask(rng, TRAIN_BATCH, cfg.max_text_len)
    txt3 = np.concatenate([txt, txt, txt[rng.permutation(TRAIN_BATCH)]])
    masks = {f"off_path_b{b}_n{n}": padded_mask(rng, b, n) for b, n in TRAIN_OFF_PATH}
    half = TRAIN_BATCH // 2  # a microbatch at accumulation_steps=2
    mtxt = txt[:half]
    mtxt3 = np.concatenate([mtxt, mtxt, np.roll(mtxt, 1, 0)])
    masks.update({
        "text": txt,
        "image": np.ones((TRAIN_BATCH, n_img), np.int32),
        "fused": np.concatenate([txt, np.ones((TRAIN_BATCH, n_img), np.int32)], 1),
        "itm": np.concatenate([txt3, np.ones((3 * TRAIN_BATCH, n_img), np.int32)], 1),
        "irtr": np.concatenate([irtr_text_mask(txt), np.ones(
            (IRTR_ROWS * TRAIN_BATCH, n_img), np.int32)], 1),
        "accum_text": mtxt,
        "accum_image": np.ones((half, n_img), np.int32),
        "accum_fused": np.concatenate([mtxt, np.ones((half, n_img), np.int32)], 1),
        "accum_itm": np.concatenate([mtxt3, np.ones((3 * half, n_img), np.int32)], 1),
        "txt": synthetic_text_mask(rng, TXT_BATCH, TXT_LEN),
    })
    if only is not None:
        masks = {k: v for k, v in masks.items() if k in only}
    rows = {"flash_attention_bwd": [], "flash_attention_fwd_drop": [],
            "flash_attention_bwd_drop": []}
    seed = torch.tensor([DROP_SEED], dtype=torch.int32, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for stream, mask in masks.items():
        b, n = mask.shape
        bh = b * heads
        g = torch.Generator(device=dev).manual_seed(b * 1000 + n)
        q, k, v, do = (torch.randn((bh, n, d), generator=g, device=dev)
                       .to(torch.bfloat16) for _ in range(4))
        kb = key_padding_bias(torch.from_numpy(mask).to(dev)).reshape(b, n).contiguous()
        o, lse = flash_attention_fwd_plain(q, k, v, kb, scale)
        od, lsed = flash_attention_fwd_drop_plain(q, k, v, kb, seed, scale, rate)
        calls = {
            "flash_attention_bwd": (
                lambda: flash_attention_bwd(q, k, v, kb, o, do, lse, scale),
                lambda: flash_attention_bwd_plain(q, k, v, kb, o, do, lse, scale)),
            "flash_attention_fwd_drop": (
                lambda: flash_attention_fwd_drop(q, k, v, kb, seed, scale, rate),
                lambda: flash_attention_fwd_drop_plain(q, k, v, kb, seed, scale, rate)),
            "flash_attention_bwd_drop": (
                lambda: flash_attention_bwd_drop(q, k, v, kb, seed, od, do, lsed, scale, rate),
                lambda: flash_attention_bwd_drop_plain(q, k, v, kb, seed, od, do, lsed,
                                                       scale, rate)),
        }
        leaves = [t.view(b, heads, n, d).detach().requires_grad_() for t in (q, k, v)]
        do4, mask4 = do.view(b, heads, n, d), kb.to(torch.bfloat16).view(b, 1, 1, n)

        def sdpa(p: float, grad: bool):
            def run():
                out = F.scaled_dot_product_attention(*leaves, attn_mask=mask4,
                                                     dropout_p=p, scale=scale)
                if grad:
                    torch.autograd.grad(out, leaves, do4)
            return run

        def sdpa_bwd(p: float):
            out = F.scaled_dot_product_attention(*leaves, attn_mask=mask4, dropout_p=p,
                                                 scale=scale)
            return lambda: torch.autograd.grad(out, leaves, do4, retain_graph=True)

        library = {"flash_attention_bwd": sdpa_bwd(0.0),
                   "flash_attention_fwd_drop": sdpa(rate, False),
                   "flash_attention_bwd_drop": sdpa_bwd(rate)}
        library_fwd_bwd = {"flash_attention_bwd": sdpa(0.0, True),
                           "flash_attention_bwd_drop": sdpa(rate, True)}
        for name, (kern, plain) in calls.items():
            got, want = kern(), plain()
            torch.cuda.synchronize()
            is_bwd = name != "flash_attention_fwd_drop"
            if is_bwd:
                checks = [within(x, y, BWD_ATOL, BWD_RTOL) for x, y in zip(got, want)]
            else:
                checks = [within(got[0], want[0], ATTN_ATOL, ATTN_RTOL),
                          within(got[1], want[1], ATTN_LSE_ATOL, 0.0)]
            err = max(e for _, e in checks)
            require(all(ok for ok, _ in checks),
                    f"{name} {stream} BH={bh} N={n}: max|err| {[e for _, e in checks]} "
                    "beyond its tolerance")
            nbytes = ((8 if is_bwd else 4) * bh * n * d * 2 + b * n * 4 + bh * n * 4)
            bound_ms, bound_by = bound(nbytes, (10 if is_bwd else 4) * bh * n * n * d)
            on_path = not stream.startswith("off_path")
            if is_bwd:
                tpg, grid = bwd_sm90_units(bh, n, sms)
                route = {"route": bwd_route(n), "key_width": fwd_sm90_tile(n),
                         "grid": grid, "tiles_per_unit": tpg}
            else:
                route = fwd_layout(bh, n, sms)
            require(route["route"] == ("sm90_stream" if stream == "txt" and not is_bwd
                                       else "sm90") or not on_path,
                    f"{name} {stream} N={n}: a step's shape took {route['route']}")
            rows[name].append({
                "stream": stream, "shape": f"BH={bh} N={n} D={d}",
                "on_path": on_path, **route, "max_abs_err": err,
                "ms": time_ms(kern), "plain_ms": time_ms(plain, iters=5),
                "library_ms": time_ms(library[name]),
                **({"library_fwd_bwd_ms": time_ms(library_fwd_bwd[name])} if is_bwd else {}),
                "bound_ms": bound_ms, "bound_by": bound_by,
            })
    return rows


def irtr_text_mask(txt: np.ndarray) -> np.ndarray:
    """IRTR's text rows: each caption's mask, then its false captions' (all
    ones, as the synthetic ones are)."""
    b, length = txt.shape
    rows = np.ones((b, IRTR_ROWS, length), np.int32)
    rows[:, 0] = txt
    return rows.reshape(b * IRTR_ROWS, length)


def check_dropout_mask(cfg: VlmoConfig, dev, batch: int, n: int | None = None) -> dict:
    """The in-kernel dropout mask, bit for bit, at `batch` rows of N tokens
    (by default the fused length: at ITM's batch the largest batch*head, row
    and column indices of the step). The inputs make every
    checked output element carry exactly one mask bit: q and k are zero on
    each other's dims, so p = 1/N everywhere, and one-hot windows of W rows
    pick the bits out:
      forward    out[i, 1 + w]   = keep[i, c + w] / N          (v window)
      backward   dv[j, 32 + w]   = keep[c + w, j] / N          (do window)
                 dq[i, w]        = scale * ds[i, c + w]        (k window)
                 dk[j, 32 + w]   = scale * ds[c + w, j]        (q window)
    with ds = (keep - delta) / N. In the forward and dv a kept bit is
    nonzero and a dropped one zero; in dq and dk a flipped bit moves the
    value by scale / (N (1 - rate)), and the check allows a quarter of
    that."""
    heads, d = cfg.num_heads, cfg.embed_dim // cfg.num_heads
    n = n or cfg.max_text_len + (cfg.img_size // cfg.patch_size) ** 2 + 1
    b, rate, scale, width = batch, cfg.attn_drop_rate, d ** -0.5, 31
    bh = b * heads
    seed = torch.tensor([DROP_SEED + 1], dtype=torch.int32, device=dev)
    keep = dropout_keep_mask_plain(seed, bh, n, rate) != 0
    kb = torch.zeros((b, n), dtype=torch.float32, device=dev)
    ds_tol = 0.25 * scale / (n * (1.0 - rate))
    bits = 0
    for c in range(0, n, width):
        w = min(width, n - c)
        i = torch.arange(w, device=dev)
        q, k, v, do = (torch.zeros((bh, n, d), device=dev) for _ in range(4))
        q[:, c + i, 32 + i] = 1
        k[:, c + i, i] = 1
        v[:, :, 0] = 1
        v[:, c + i, 1 + i] = 1
        do[:, :, 0] = 1
        do[:, c + i, 32 + i] = 1
        q, k, v, do = (t.to(torch.bfloat16) for t in (q, k, v, do))
        out, _ = flash_attention_fwd_drop(q, k, v, kb, seed, scale, rate)
        o, lse = flash_attention_fwd_drop_plain(q, k, v, kb, seed, scale, rate)
        dq, dk, dv = flash_attention_bwd_drop(q, k, v, kb, seed, o, do, lse, scale, rate)
        pq, pk, _ = flash_attention_bwd_drop_plain(q, k, v, kb, seed, o, do, lse, scale, rate)
        torch.cuda.synchronize()
        require(torch.equal(out[:, :, 1:1 + w] != 0, keep[:, :, c:c + w]),
                f"dropout forward: mask bits differ in key window {c}..{c + w}")
        require(torch.equal(dv[:, :, 32:32 + w] != 0, keep[:, c:c + w, :].transpose(1, 2)),
                f"dropout backward dv: mask bits differ in query window {c}..{c + w}")
        dq_err = (dq[:, :, :w].float() - pq[:, :, :w].float()).abs().max().item()
        dk_err = (dk[:, :, 32:32 + w].float() - pk[:, :, 32:32 + w].float()).abs().max().item()
        require(dq_err <= ds_tol and dk_err <= ds_tol,
                f"dropout backward dq/dk: max|err| {dq_err}, {dk_err} beyond {ds_tol} "
                f"in window {c}..{c + w}: a mask bit differs")
        bits += 4 * bh * n * w
    return {"shape": f"BH={bh} N={n}", "mask_bits_checked": bits, "kept_share":
            keep.float().mean().item()}


def cpu_check_phase() -> dict:
    """One step at batch CPU_TRAIN_BATCH on the card and on the CPU's plain
    path: same seeded weights, batch, attention-dropout seeds, ITM negatives
    and MIM labels (the CPU dVAE's), hidden dropout and DropPath off."""
    cfg_dict = load_config(TRAIN_OVERRIDES + [
        f"data.batch_size={CPU_TRAIN_BATCH}", "model.drop_rate=0.0",
        "model.drop_path_rate=0.0"])
    gpu, cpu = Trainer(cfg_dict, device="cuda"), Trainer(cfg_dict, device="cpu")
    batch = cpu.next_batch()
    labels = cpu.model_batch(batch)["mim_labels"]
    gpu_labels = gpu.model_batch(batch)["mim_labels"].cpu()
    b = CPU_TRAIN_BATCH
    negatives = (torch.arange(1, b + 1) % b, torch.arange(b - 1, 2 * b - 1) % b)
    agreement = (gpu_labels == labels).float().mean().item()
    print(f"train_cpu_check: dvae_token_agreement {agreement}", flush=True)
    result = compare_step("train_cpu_check", gpu, cpu, batch, CHECKED_PARAMS,
                          negatives=negatives, mim_labels=labels)
    del gpu, cpu
    torch.cuda.empty_cache()
    return result


def run_counted(trainer: Trainer, steps: int, timed: bool = False):
    """`steps` steps with every kernel's count set to 0 just before and
    read just after; with `timed`, a synchronise around each step."""
    for fn in KERNELS:
        fn.launches = 0
    metrics, times = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = trainer.step()
        if timed:
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        metrics.append({k: float(v) for k, v in m.items()})
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in KERNELS}
    for m in metrics:
        require(all(np.isfinite(v) for v in m.values()), f"non-finite metrics: {m}")
    return metrics, times, launches


def require_launches(tag: str, launches: dict, expected: dict, runs: int) -> None:
    """Each kernel of `expected` launched exactly its count per run (step or
    request) in `runs` runs."""
    for name, per_run in expected.items():
        require(launches[name] == per_run * runs,
                f"{tag}: {name} {launches[name]} launches in {runs} runs, "
                f"expected {per_run} per run")


# timed_phase's results by tag, for a later phase to print its own beside
TIMED: dict[str, dict] = {}


def timed_phase(tag: str, cfg_dict: dict, checked, expected: dict, unmoved=()) -> dict:
    """A training step at vlmo_base, batch 32: one warm-up step, then
    TRAIN_STEPS steps timed one by one, each with a synchronise around it,
    every kernel's launches counted against `expected` (per step), the
    `checked` parameters required to move and the `unmoved` ones (fixed or
    frozen by the phase) required to stay."""
    t0 = time.perf_counter()
    trainer = Trainer(cfg_dict, device="cuda")
    print(f"{tag}: Trainer ready in {time.perf_counter() - t0:.1f} s", flush=True)
    params = dict(trainer.task.named_parameters())
    before = {k: params[k].detach().clone() for k in (*checked, *unmoved)}
    trainer.step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    metrics, times, launches = run_counted(trainer, TRAIN_STEPS, timed=True)
    require_launches(tag, launches, expected, TRAIN_STEPS)
    moved = {k: (params[k].detach() - before[k]).abs().max().item() for k in checked}
    require(all(x > 0 for x in moved.values()), f"{tag}: parameters did not change: {moved}")
    stayed = {k: (params[k].detach() - before[k]).abs().max().item() for k in unmoved}
    require(all(x == 0 for x in stayed.values()),
            f"{tag}: fixed or frozen parameters changed: {stayed}")
    batch, med = cfg_dict["data"]["batch_size"], statistics.median(times)
    result = {
        "batch": batch, "steps": TRAIN_STEPS, "ms_per_step": [x * 1e3 for x in times],
        "median_ms_per_step": med * 1e3, "images_per_s": batch / med,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches": launches, "expected_launches_per_step": expected,
        "losses": [{k: v for k, v in m.items() if k.endswith("_task_loss") or k in
                    ("vqa_mean_score", "total_loss", "grad_norm", "lr")} for m in metrics],
        "max_param_change": moved, **({"fixed_param_change": stayed} if unmoved else {}),
    }
    print(f"{tag}: " + json.dumps(result), flush=True)
    TIMED[tag] = result
    del trainer
    torch.cuda.empty_cache()
    return launches


def short_phase(tag: str, cfg_dict: dict, expected: dict, check=None):
    """EXTRA_STEPS untimed steps, every kernel's launches counted against
    `expected` (per step); `check(trainer)`, where given, runs first.
    Returns the launches, the steps' metrics and the ISDA count after them
    (None without ISDA)."""
    trainer = Trainer(cfg_dict, device="cuda")
    if check is not None:
        check(trainer)
    steps, _, launches = run_counted(trainer, EXTRA_STEPS)
    require_launches(tag, launches, expected, EXTRA_STEPS)
    isda = trainer.state.isda
    count = None if isda is None else float(isda.count.sum())
    print(f"{tag}: " + json.dumps({
        "launches": launches, "isda_count": count,
        "losses": [{k: v for k, v in m.items() if k.endswith("_task_loss")
                    or k == "total_loss"} for m in steps]}), flush=True)
    del trainer
    torch.cuda.empty_cache()
    return launches, steps, count


def itc_temp_closed_form(feats: dict, log_temp: float) -> float:
    """d(ITC loss)/d itc_temp from one step's normalised ITC features
    ({"v": images, "l": texts}), in fp64: sum(dL/dsim * sim), the loss
    seeing itc_temp only through sim = i t^T exp(itc_temp)."""
    sim = feats["v"] @ feats["l"].T * math.exp(log_temp)
    eye = torch.eye(len(sim), dtype=sim.dtype)
    d_sim = (sim.softmax(-1) - eye + (sim.T.softmax(-1) - eye).T) / (2 * len(sim))
    return float((d_sim * sim).sum())


def compare_step(tag: str, gpu: Trainer, cpu: Trainer, batch: dict, names,
                 itc_grad_from_cpu: bool = False, unheld=(), itc_temp_grad=None,
                 **step_kw) -> dict:
    """One step on each trainer from the same host batch; the losses, the
    named gradients (relative L2; itc_temp's against the CPU's rescaled to
    the card's ITC features, and those features) and the signs of the first
    AdamW update compared against LOSS_RTOL, GRAD_REL_TOL and
    UPDATE_AGREEMENT. With `itc_grad_from_cpu`, the card's backward takes
    the CPU's gradient at the ITC features (ITC_GRAD_NOTE); the card's own
    is reported beside it. The `unheld` names are reported, not held.
    `itc_temp_grad(device, feats, log_temp)` gives itc_temp's gradient from
    a device's own ITC features (`feats`: each route's features, one
    tensor per forward; default: `itc_temp_closed_form` of the in-batch
    ITC)."""
    before = {k: p.detach().clone() for k, p in cpu.task.named_parameters()
              if k in names}
    feats = {"gpu": {}, "cpu": {}}
    hooks = [t.task.itc_head.register_forward_hook(
        lambda mod, args, out, f=feats[d]: f.setdefault(args[1], []).append(
            out.detach().double().cpu()))
        for d, t in (("gpu", gpu), ("cpu", cpu)) if "itc_temp" in names]
    if itc_temp_grad is None:
        def itc_temp_grad(device, f, log_temp):
            return itc_temp_closed_form({r: torch.cat(v) for r, v in f.items()}, log_temp)
    feat_grads: dict = {"gpu": {}, "cpu": {}}
    if itc_grad_from_cpu:
        def keep(mod, args, out):
            out.register_hook(lambda g, r=args[1]: feat_grads["cpu"].__setitem__(
                r, g.detach().double()))

        def feed(mod, args, out):
            def swap(g, r=args[1]):
                feat_grads["gpu"][r] = g.detach().double().cpu()
                return feat_grads["cpu"][r].to(g.device, g.dtype)
            out.register_hook(swap)

        hooks += [cpu.task.itc_head.register_forward_hook(keep),
                  gpu.task.itc_head.register_forward_hook(feed)]
    t0 = time.perf_counter()
    m_cpu = cpu.step(batch, **step_kw)
    cpu_s = time.perf_counter() - t0
    m_gpu = gpu.step(batch, **step_kw)
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    lr = float(m_cpu["lr"])
    p_cpu, p_gpu = dict(cpu.task.named_parameters()), dict(gpu.task.named_parameters())
    losses = {k: (float(m_gpu[k]), float(m_cpu[k])) for k in m_cpu
              if k.endswith("_task_loss") or k.endswith("_Loss") or k == "total_loss"}
    grads, agree = {}, {}
    for k in names:
        g_cpu, g_gpu = p_cpu[k].grad.float(), p_gpu[k].grad.float().cpu()
        grads[k] = ((g_gpu - g_cpu).norm() / g_cpu.norm().clamp_min(1e-30)).item()
        step_cpu = (p_cpu[k].detach() - before[k]) / lr
        step_gpu = (p_gpu[k].detach().cpu() - before[k]) / lr
        agree[k] = (torch.sign(step_cpu) == torch.sign(step_gpu)).float().mean().item()
    held, itc = {k: v for k, v in grads.items() if k not in unheld}, {}
    if "itc_temp" in names:
        closed = {d: itc_temp_grad(d, f, float(before["itc_temp"]))
                  for d, f in feats.items()}
        g_gpu, g_cpu = float(p_gpu["itc_temp"].grad), float(p_cpu["itc_temp"].grad)
        want = g_cpu * closed["gpu"] / closed["cpu"]
        f_gpu, f_cpu = (torch.cat([*f["v"], *f["l"]]) for f in (feats["gpu"], feats["cpu"]))
        itc = {"grad_gpu_cpu": (g_gpu, g_cpu), "closed_form_gpu_cpu": (closed["gpu"],
               closed["cpu"]), "feature_rel_err": ((f_gpu - f_cpu).norm() / f_cpu.norm()).item()}
        held["itc_temp"] = itc["grad_rel_err_at_gpu_features"] = abs(g_gpu - want) / abs(want)
        held["itc_features"] = itc["feature_rel_err"]
    own = {r: ((feat_grads["gpu"][r] - g).norm() / g.norm()).item()
           for r, g in feat_grads["cpu"].items()}
    result = {
        "batch": len(batch["text_ids"]), "cpu_step_s": cpu_s,
        "losses_gpu_cpu": losses, "grad_norm_gpu_cpu": (float(m_gpu["grad_norm"]),
                                                        float(m_cpu["grad_norm"])),
        "grad_rel_err": grads, "update_sign_agreement": agree, "lr": lr,
        **({"itc_temp": itc} if itc else {}),
        **({"own_feature_grad_rel_err": own} if own else {}),
        **({"unheld": list(unheld)} if unheld else {}),
    }
    print(f"{tag}: " + json.dumps(result), flush=True)
    for k, (g, c) in losses.items():
        require(abs(g - c) <= LOSS_RTOL * abs(c) + 1e-3,
                f"{tag} {k}: GPU {g} vs CPU {c} beyond rtol {LOSS_RTOL}")
    require(max(held.values()) <= GRAD_REL_TOL,
            f"{tag}: gradients differ from the CPU path: {held}")
    require(min(v for k, v in agree.items() if k not in unheld) >= UPDATE_AGREEMENT,
            f"{tag}: post-step parameters differ from the CPU path: {agree}")
    return result


def vqa_cpu_check_phase(tag: str, overrides: list[str]) -> dict:
    """One finetune_vqa step at batch CPU_TRAIN_BATCH on the card and on the
    CPU's plain path: same seeded weights, batch and attention-dropout
    seeds, hidden dropout and DropPath off (the fused MLP without dropout:
    row 6, or row 9 under int8)."""
    cfg_dict = load_config(overrides + [
        f"data.batch_size={CPU_TRAIN_BATCH}", "model.drop_rate=0.0",
        "model.drop_path_rate=0.0"])
    gpu, cpu = Trainer(cfg_dict, device="cuda"), Trainer(cfg_dict, device="cpu")
    result = compare_step(tag, gpu, cpu, cpu.next_batch(), CHECKED_VQA_PARAMS)
    del gpu, cpu
    torch.cuda.empty_cache()
    return result


def txt_phase() -> dict:
    """pretrain_txt at vlmo_base, batch 32, 512 tokens: a warm-up step and
    TRAIN_STEPS timed ones through rows 3 and 4 (12 launches each a step), the
    trained text side moved and the fixed and frozen parameters not; two
    steps at attention dropout 0 through rows 1 and 2; a batch-2 step
    against the CPU's plain path (hidden dropout and DropPath off,
    attention dropout on through the hash). Returns each run's launches."""
    txt_dict = load_config(TXT_OVERRIDES)
    txt_cfg = VlmoConfig.from_config(txt_dict)
    require(txt_cfg.attn_impl == "auto" and txt_cfg.attn_drop_rate > 0
            and txt_cfg.max_text_len == TXT_LEN and txt_cfg.loss_names == ("mlm",)
            and txt_dict["data"]["batch_size"] == TXT_BATCH
            and padded_len(TXT_LEN) <= SM90_BWD_MAX_N and fwd_route(TXT_LEN) == "sm90_stream",
            "the pretrain_txt phase must run text-only MLM at 512 tokens through the "
            "dropout kernels, the forward on the streamed kernel")
    depth = txt_cfg.depth
    launches = {"txt_train": timed_phase(
        "txt_train", txt_dict, CHECKED_TXT_PARAMS, {
            "flash_attention_fwd_drop": depth, "flash_attention_bwd_drop": depth,
            "flash_attention_fwd": 0, "flash_attention_bwd": 0},
        unmoved=FIXED_TXT_PARAMS)}
    launches["txt_attn_drop0"], _, _ = short_phase(
        "txt_attn_drop0",
        load_config(TXT_OVERRIDES + ["attn_impl=pallas", "model.attn_drop_rate=0.0"]),
        {"flash_attention_fwd": depth, "flash_attention_bwd": depth,
         "flash_attention_fwd_drop": 0, "flash_attention_bwd_drop": 0})
    cfg_dict = load_config(TXT_OVERRIDES + [
        f"data.batch_size={CPU_TRAIN_BATCH}", "model.drop_rate=0.0",
        "model.drop_path_rate=0.0"])
    gpu, cpu = Trainer(cfg_dict, device="cuda"), Trainer(cfg_dict, device="cpu")
    compare_step("txt_cpu_check", gpu, cpu, cpu.next_batch(), COMPARED_TXT_PARAMS)
    del gpu, cpu
    torch.cuda.empty_cache()
    return launches


def _loop_counts(launches: dict, calls: int, steps: int, eval_batches: int, tag: str):
    """Rows 7, 3 and 4 on every FFN and attention call of the steps, row 6
    on every FFN call of the evaluation, rows 1 and 2 never (attention at
    eval takes the plain chain under attn_impl=auto)."""
    want = {"fused_mlp_fwd_drop": calls * steps, "flash_attention_fwd_drop": calls * steps,
            "flash_attention_bwd_drop": calls * steps, "fused_mlp_fwd": calls * eval_batches,
            "flash_attention_fwd": 0, "flash_attention_bwd": 0}
    got = {k: launches[k] for k in want}
    require(got == want, f"{tag}: launches {got}, expected {want}")


def _run_phase(overrides: list[str]):
    """`main.setup` and `phases.dispatch` on the card with every count set to
    0 just before; returns (result, cfg, launches, wall seconds)."""
    cfg, logger = setup(overrides)
    for fn in KERNELS:
        fn.launches = 0
    t0 = time.perf_counter()
    result = dispatch(cfg, logger, device="cuda")
    torch.cuda.synchronize()
    return result, cfg, {fn.__name__: fn.launches for fn in KERNELS}, time.perf_counter() - t0


def _same_state(a, b) -> dict:
    """Which parts of two train states are equal bit for bit."""
    sa, sb = ckpt_lib.state_dict(a), ckpt_lib.state_dict(b)
    oa, ob = sa["optimizer"]["state"], sb["optimizer"]["state"]
    return {
        "step": sa["step"] == sb["step"],
        "parameters": sa["model"].keys() == sb["model"].keys() and all(
            torch.equal(v, sb["model"][k]) for k, v in sa["model"].items()),
        "adamw_moments": bool(oa) and oa.keys() == ob.keys() and all(
            torch.equal(oa[i][k], ob[i][k]) for i in oa
            for k in ("exp_avg", "exp_avg_sq", "step")),
        "generators": all(torch.equal(sa[k], sb[k])
                          for k in ("generator", "seed_generator")),
    }


def train_loop_phase(card: str, calls: int, samples: int = LOOP_SAMPLES) -> dict:
    """Phase 20: two evaluated epochs of finetune_vqa at vlmo_base on
    `samples` synthetic samples, a restore and a relaunch that resumes,
    serving from the newest checkpoint and throughput mode, through the
    port's `setup` and `dispatch`."""
    batches = samples // VQA_BATCH  # per epoch, for training and for eval
    out = {"card": card, "samples": samples}
    with tempfile.TemporaryDirectory() as root:
        exp = os.path.join(root, "finetune_vqa", "vlmo_base", "default")
        base = VQA_OVERRIDES + [f"data.synthetic_size={samples}", "train.epochs=2",
                                f"exp_dir={exp}"]
        result1, cfg1, launches1, wall1 = _run_phase(base + [f"run_dir={exp}/run1"])
        _loop_counts(launches1, calls, 2 * batches, 2 * batches, "train_loop run 1")
        lines = [json.loads(x) for x in open(os.path.join(cfg1["run_dir"], "log_stats.json"))]
        require(len(lines) == len(result1["history"]) == 2
                and all("val_vqa_mean_score" in x and "val_total_loss" in x for x in lines)
                and all(np.isfinite(v) for x in lines for v in x.values()),
                f"train_loop run 1: log_stats.json {lines}")
        kept = [os.path.basename(p) for _, p in ckpt_lib._scan(exp)]
        require(kept == ["checkpoint-0", "checkpoint-1"],
                f"train_loop run 1: checkpoints on disk {kept}")
        state1 = result1["state"]
        n_params = sum(p.numel() for p in state1.task.parameters())
        t1 = result1["times"]
        out["run1"] = {"wall_s": wall1, "epoch_s": t1["epoch_s"], "eval_s": t1["eval_s"],
                       "save_s": t1["save_s"], "checkpoint_bytes": t1["checkpoint_bytes"],
                       "params": n_params, "ms_per_step_epoch1": 1e3 * t1["epoch_s"][1] / batches,
                       "launches": launches1, "log_stats": lines}
        print(f"train_loop: run 1 (2 epochs, each evaluated): wall {wall1:.2f} s, "
              f"epochs {t1['epoch_s']} s, evals {t1['eval_s']} s, saves {t1['save_s']} s, "
              f"checkpoint {t1['checkpoint_bytes']} bytes for {n_params} parameters "
              f"({card})", flush=True)

        # the checkpoint read back into a new trainer, against run 1's state
        probe_cfg = load_config(base + ["train.epochs=3", f"run_dir={exp}/probe"])
        probe = Trainer(probe_cfg, device="cuda")
        t0 = time.perf_counter()
        _, next_epoch = ckpt_lib.auto_load(exp, probe.state, probe_cfg)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        same = _same_state(probe.state, state1)
        require(next_epoch == 2 and all(same.values()),
                f"train_loop: restored state {same}, next epoch {next_epoch}")
        out["restore"] = {"load_s": load_s, "bit_for_bit": same}
        print(f"train_loop: checkpoint-1 restored bit for bit {same} in {load_s:.2f} s "
              f"({card})", flush=True)
        del probe, result1, state1
        torch.cuda.empty_cache()

        # a relaunch under the same exp_dir: one more epoch, from checkpoint-1
        result2, _, launches2, wall2 = _run_phase(
            base + ["train.epochs=3", f"run_dir={exp}/run2"])
        _loop_counts(launches2, calls, batches, batches, "train_loop run 2")
        require([h["epoch"] for h in result2["history"]] == [2]
                and result2["state"].step == 3 * batches,
                f"train_loop run 2: history {result2['history']}, "
                f"step {result2['state'].step}")
        t2 = result2["times"]
        out["run2"] = {"wall_s": wall2, "load_s": t2["load_s"], "epoch_s": t2["epoch_s"],
                       "eval_s": t2["eval_s"], "save_s": t2["save_s"], "launches": launches2,
                       "history": result2["history"]}
        print(f"train_loop: run 2 (resumed at epoch 2, step {result2['state'].step}): wall "
              f"{wall2:.2f} s, load {t2['load_s']:.2f} s, epoch {t2['epoch_s']} s, eval "
              f"{t2['eval_s']} s, save {t2['save_s']} s ({card})", flush=True)
        del result2
        torch.cuda.empty_cache()
        latest = ckpt_lib._scan(exp)[-1][1]
        out["checkpoints_on_disk"] = [os.path.relpath(p, exp) for _, p in ckpt_lib._scan(exp)]

        # serving from the newest checkpoint: rows 1 and 6 on every request
        serve_cfg = VlmoConfig.from_config(load_config(SERVE_OVERRIDES))
        gpu = Predictor.from_checkpoint(latest, SERVE_OVERRIDES, max_batch=BATCH,
                                        device="cuda")
        reqs = make_requests(serve_cfg, np.random.default_rng(3), LOOP_REQUESTS, BATCH)
        for fn in KERNELS:
            fn.launches = 0
        latencies, outputs = [], []
        for img, ids, mask in reqs:
            t = time.perf_counter()
            outputs.append(gpu.vqa_logits(img, ids, mask))
            latencies.append(time.perf_counter() - t)
        served = {fn.__name__: fn.launches for fn in KERNELS}
        require_launches("train_loop serve", served,
                         {"flash_attention_fwd": calls, "fused_mlp_fwd": calls}, LOOP_REQUESTS)
        cpu = Predictor.from_checkpoint(latest, SERVE_OVERRIDES, max_batch=BATCH,
                                        device="cpu")
        img, ids, mask = (a[:CPU_CHECK_ROWS] for a in reqs[0])
        err = float(np.abs(outputs[0][:CPU_CHECK_ROWS] - cpu.vqa_logits(img, ids, mask)).max())
        require(all(o.shape == (BATCH, serve_cfg.vqa_label_size) and np.isfinite(o).all()
                    for o in outputs) and err <= E2E_ATOL,
                f"train_loop serve: logits vs the CPU {err} (tol {E2E_ATOL})")
        out["serve"] = {"checkpoint": os.path.relpath(latest, exp), "launches": served,
                        "latency_ms": [x * 1e3 for x in latencies],
                        "cpu_check_max_abs_err": err}
        print(f"train_loop: served {LOOP_REQUESTS} batch-{BATCH} requests from "
              f"{os.path.relpath(latest, exp)}: latency ms "
              f"{[round(x * 1e3, 2) for x in latencies]}, CPU check max|err| {err} "
              f"(tol {E2E_ATOL}) ({card})", flush=True)
        del gpu, cpu
        torch.cuda.empty_cache()

        # throughput mode at the same overrides: a short warm-up, then the
        # timed steps in 4 chunks
        result3, _, _, wall3 = _run_phase(
            base + LOOP_THROUGHPUT + ["throughput_mode=true", f"exp_dir={root}/throughput",
                                      f"run_dir={root}/throughput/run"])
        timed_ms = 1e3 * VQA_BATCH / result3["throughput"]
        out["throughput"] = {"samples_per_s": result3["throughput"], "wall_s": wall3,
                             "ms_per_step": timed_ms}
        print(f"train_loop: throughput {result3['throughput']:.2f} samples/s "
              f"({timed_ms:.2f} ms/step, batch {VQA_BATCH}) ({card})", flush=True)
        loop_ms = out["run1"]["ms_per_step_epoch1"]
        print(f"train_loop: a step in the loop (epoch 1, {batches} steps) {loop_ms:.2f} ms, "
              f"{loop_ms / timed_ms:.3f}x throughput mode's ({card})", flush=True)
    print("train_loop: " + json.dumps(out), flush=True)
    torch.cuda.empty_cache()
    return out


def loop_fit(card: str, calls: int, sizes: list[int]) -> int:
    """Phase 20 alone at each of `sizes` synthetic samples, then the
    second epoch's seconds fitted as fixed + per-step * steps over the
    sizes: what the loop adds per epoch and per step, against throughput
    mode's step at the largest size."""
    outs = [train_loop_phase(card, calls, n) for n in sizes]
    steps = np.array([o["samples"] // VQA_BATCH for o in outs], dtype=float)
    epoch_s = np.array([o["run1"]["epoch_s"][1] for o in outs])
    fit = {"steps": steps.tolist(), "epoch1_s": epoch_s.tolist(),
           "throughput_ms": [o["throughput"]["ms_per_step"] for o in outs]}
    if len(set(steps)) > 1:
        per_step, fixed = np.polyfit(steps, epoch_s, 1)
        fit.update(per_step_ms=1e3 * per_step, fixed_ms=1e3 * fixed,
                   per_step_over_throughput=1e3 * per_step / fit["throughput_ms"][-1])
    print("train_loop_fit: " + json.dumps(fit) + f" ({card})", flush=True)
    return 0


def downstream_cpu_check(tag: str, overrides: list[str], names,
                         itc_grad_from_cpu: bool = False, unheld=()) -> dict:
    """One step at batch CPU_TRAIN_BATCH on the card and on the CPU's plain
    path: same seeded weights, batch and attention-dropout seeds, hidden
    dropout and DropPath off; MIM labels, where the phase trains MIM, from
    the CPU's dVAE on both."""
    cfg_dict = load_config(overrides + [
        f"data.batch_size={CPU_TRAIN_BATCH}", "model.drop_rate=0.0",
        "model.drop_path_rate=0.0"])
    gpu, cpu = Trainer(cfg_dict, device="cuda"), Trainer(cfg_dict, device="cpu")
    batch = cpu.next_batch()
    kw = {}
    if cpu.dvae is not None:
        kw["mim_labels"] = cpu.model_batch(batch)["mim_labels"]
    result = compare_step(tag, gpu, cpu, batch, names, itc_grad_from_cpu, unheld, **kw)
    del gpu, cpu
    torch.cuda.empty_cache()
    return result


def recall_phase(card: str, per_step: int) -> dict:
    """finetune_retrieval through `main.setup` and `phases.dispatch` on
    RECALL_SAMPLES synthetic samples at batch RECALL_BATCH (one epoch:
    steps, evaluation, a save, then recall@{1,5,10} on the val split); the
    trained weights' similarity matrix over the val split on the card
    against the CPU's from the same weights."""
    with tempfile.TemporaryDirectory() as root:
        result, cfg, launches, wall = _run_phase(RETRIEVAL_OVERRIDES + [
            f"data.synthetic_size={RECALL_SAMPLES}", f"data.batch_size={RECALL_BATCH}",
            "train.epochs=1", f"exp_dir={root}/exp", f"run_dir={root}/exp/run"])
    recalls, state = result["recalls"], result["state"]
    steps = RECALL_SAMPLES // RECALL_BATCH
    require(launches["flash_attention_fwd_drop"] == launches["flash_attention_bwd_drop"]
            == per_step * steps and launches["flash_attention_fwd"] == 0,
            f"retrieval recall run: launches {launches}, expected {per_step} of rows 3 and 4 "
            f"in each of {steps} steps and none at evaluation")
    keys = [f"{d}_recall@{k}" for d in ("i2t", "t2i") for k in (1, 5, 10)] + ["recall_mean"]
    require(set(recalls) == set(keys) and all(0.0 <= recalls[k] <= 1.0 for k in keys),
            f"retrieval recall: {recalls}")
    cpu = Trainer(cfg, device="cpu")
    cpu.task.load_state_dict({k: v.cpu() for k, v in state.task.state_dict().items()})
    loader = cpu.val_loader
    t0 = time.perf_counter()
    feats_gpu = encode_split(state.task, loader, torch.device("cuda"))
    gpu_s = time.perf_counter() - t0
    feats_cpu = encode_split(cpu.task, loader, cpu.device)
    sim_gpu, sim_cpu = (i @ t.T for i, t in (feats_gpu, feats_cpu))
    err = float(np.abs(sim_gpu - sim_cpu).max())
    require(sim_gpu.shape == (RECALL_SAMPLES, RECALL_SAMPLES) and bool(np.isfinite(sim_gpu).all())
            and err <= E2E_ATOL,
            f"retrieval: the card's similarity matrix differs from the CPU's by {err} "
            f"(tol {E2E_ATOL})")
    out = {"card": card, "samples": RECALL_SAMPLES, "wall_s": wall, "recalls": recalls,
           "cpu_recalls": recall_at_k(*feats_cpu), "encode_s": gpu_s,
           "similarity_max_abs_err": err, "launches": launches}
    print("retrieval_recall: " + json.dumps(out), flush=True)
    del cpu, state, result
    torch.cuda.empty_cache()
    return out


def downstream_train_phase(card: str) -> dict:
    """pretrain_vis (MIM, with the fused MLP), finetune_nlvr2 and
    finetune_retrieval at vlmo_base, batch 32: each a warm-up step and
    TRAIN_STEPS timed ones with every launch counted against its
    prediction, the trained parameters moved (and pretrain_vis's frozen text
    side, fused experts and pooler not), then a batch-2 step against the
    CPU's plain path; two MAE steps; retrieval's recall. Returns each timed
    phase's launches."""
    vis_dict = load_config(VIS_OVERRIDES)
    vis = VlmoConfig.from_config(vis_dict)
    require(vis.loss_names == ("mim",) and vis.mlp_impl == "fused" and vis.attn_impl == "auto"
            and vis.attn_drop_rate > 0 and vis.drop_rate > 0,
            "pretrain_vis must train MIM through the dropout kernels and the fused MLP")
    depth, calls = vis.depth, img_txt_calls(vis)
    none = {"flash_attention_fwd": 0, "flash_attention_bwd": 0, "fused_mlp_fwd": 0}
    # the masked image stream: rows 3, 4 and 7 once a block
    vis_expected = {"flash_attention_fwd_drop": depth, "flash_attention_bwd_drop": depth,
                    "fused_mlp_fwd_drop": depth, **none}
    launches = {"vis_train": timed_phase("vis_train", vis_dict, CHECKED_VIS_PARAMS,
                                         vis_expected, unmoved=FROZEN_VIS_PARAMS)}
    _, steps, _ = short_phase("vis_mae", load_config(VIS_OVERRIDES + ["train.loss_names=[mae]"]),
                              vis_expected)
    require(all(np.isfinite(m.get("mae_task_loss", np.nan)) for m in steps),
            f"vis_mae: no finite MAE loss in {steps}")
    downstream_cpu_check("vis_cpu_check", VIS_OVERRIDES, CHECKED_VIS_PARAMS)

    nlvr2 = VlmoConfig.from_config(load_config(NLVR2_OVERRIDES))
    require(nlvr2.loss_names == ("nlvr2",) and nlvr2.mlp_impl == "xla"
            and nlvr2.attn_drop_rate > 0, "finetune_nlvr2 must run at its defaults")
    # two img-txt forwards (token types 1 and 2)
    launches["nlvr2_train"] = timed_phase(
        "nlvr2_train", load_config(NLVR2_OVERRIDES), CHECKED_NLVR2_PARAMS, {
            "flash_attention_fwd_drop": 2 * calls, "flash_attention_bwd_drop": 2 * calls,
            "fused_mlp_fwd_drop": 0, **none})
    downstream_cpu_check("nlvr2_cpu_check", NLVR2_OVERRIDES, CHECKED_NLVR2_PARAMS)

    ret = VlmoConfig.from_config(load_config(RETRIEVAL_OVERRIDES))
    require(ret.loss_names == ("itc", "irtr") and ret.mlp_impl == "xla"
            and load_config(RETRIEVAL_OVERRIDES)["train"]["draw_false_text"] == IRTR_ROWS - 1,
            "finetune_retrieval must run at its defaults")
    # ITC's image and text streams through every block, then IRTR's
    # img-txt forward of 4B rows
    per_step = 2 * depth + calls
    launches["retrieval_train"] = timed_phase(
        "retrieval_train", load_config(RETRIEVAL_OVERRIDES), CHECKED_RETRIEVAL_PARAMS, {
            "flash_attention_fwd_drop": per_step, "flash_attention_bwd_drop": per_step,
            "fused_mlp_fwd_drop": 0, **none})
    downstream_cpu_check("retrieval_cpu_check", RETRIEVAL_OVERRIDES, CHECKED_RETRIEVAL_PARAMS,
                         itc_grad_from_cpu=True, unheld=ITC_ONLY_IMAGE_PARAMS)
    recall_phase(card, per_step)
    return launches


def endpoint_requests(cfg: VlmoConfig, seed: int):
    """N_REQUESTS batches of (images, token ids, mask, second images)."""
    rng = np.random.default_rng(seed)
    return [(img, ids, mask, rng.integers(0, 256, img.shape, dtype=np.uint8))
            for img, ids, mask in make_requests(cfg, rng, N_REQUESTS, BATCH)]


def downstream_serve_phase(card: str) -> dict:
    """The endpoints at batch 64 on the card: encode_image, encode_text
    (`encode_text_ids`), similarity and itm_score (`itm_score_ids`) on
    pretrain_mum's heads, nlvr2 (`nlvr2_ids`) on finetune_nlvr2's, seeded
    weights (seed 0): N_REQUESTS requests each (the first a warm-up), every
    launch counted against the prediction (rows 1 and 6 on every attention
    and FFN call), the first request's first CPU_CHECK_ROWS rows held to the
    CPU's plain path within E2E_ATOL (embeddings, scaled similarities and
    probabilities), the latencies timed."""
    mum_dict = load_config(ENDPOINT_OVERRIDES + ["train=pretrain_mum"])
    nlvr2_dict = load_config(ENDPOINT_OVERRIDES + ["train=finetune_nlvr2"])
    cfg = VlmoConfig.from_config(mum_dict)
    depth, calls = cfg.depth, img_txt_calls(cfg)
    preds = {}
    for tag, cfg_dict in (("mum", mum_dict), ("nlvr2", nlvr2_dict)):
        state = build_model(cfg_dict, device="cpu", seed=0).state_dict()
        preds[tag] = (Predictor(cfg_dict, state, max_batch=BATCH, device="cuda"),
                      Predictor(cfg_dict, state, max_batch=BATCH, device="cpu"))
    reqs = endpoint_requests(cfg, 5)
    itc_dim = cfg.itc_dim
    endpoints = {
        "encode_image": ("mum", lambda p, r: p.encode_image(r[0]), depth, (BATCH, itc_dim)),
        "encode_text": ("mum", lambda p, r: p.encode_text_ids(r[1], r[2]), depth,
                        (BATCH, itc_dim)),
        "itm_score": ("mum", lambda p, r: p.itm_score_ids(r[0], r[1], r[2]), calls, (BATCH,)),
        "nlvr2": ("nlvr2", lambda p, r: p.nlvr2_ids(r[0], r[3], r[1], r[2]), 2 * calls,
                  (BATCH,)),
    }
    out, first = {"card": card, "batch": BATCH, "requests": N_REQUESTS}, {}
    for name, (tag, call, per_request, shape) in endpoints.items():
        gpu, cpu = preds[tag]
        for fn in KERNELS:
            fn.launches = 0
        latencies, results = [], []
        for r in reqs:
            t = time.perf_counter()
            results.append(call(gpu, r))
            latencies.append(time.perf_counter() - t)
        launches = {fn.__name__: fn.launches for fn in KERNELS}
        require_launches(f"serve_{name}", launches, {
            "flash_attention_fwd": per_request, "fused_mlp_fwd": per_request,
            "flash_attention_fwd_drop": 0, "fused_mlp_fwd_drop": 0}, N_REQUESTS)
        require(all(x.shape == shape and x.dtype == np.float32 and np.isfinite(x).all()
                    for x in results), f"serve_{name}: bad outputs")
        ref = call(cpu, tuple(a[:CPU_CHECK_ROWS] for a in reqs[0]))
        err = float(np.abs(results[0][:CPU_CHECK_ROWS] - ref).max())
        require(err <= E2E_ATOL, f"serve_{name}: GPU vs CPU max|err| {err} (tol {E2E_ATOL})")
        first[name] = (results[0], ref)
        med = statistics.median(latencies[1:])
        out[name] = {"first_request_ms": latencies[0] * 1e3,
                     "latency_ms": [x * 1e3 for x in latencies[1:]],
                     "median_latency_ms": med * 1e3, "rows_per_s": BATCH / med,
                     "launches": launches, "expected_launches_per_request": per_request,
                     "cpu_check_max_abs_err": err}
    norms = np.linalg.norm(first["encode_image"][0], axis=-1)
    require(bool(np.abs(norms - 1).max() < 1e-2), f"encode_image: norms {norms.min()}..{norms.max()}")
    require(all(((first[k][0] >= 0) & (first[k][0] <= 1)).all() for k in ("itm_score", "nlvr2")),
            "itm_score / nlvr2: probabilities outside [0, 1]")
    gpu, cpu = preds["mum"]
    (img_g, img_c), (txt_g, txt_c) = first["encode_image"], first["encode_text"]
    t = time.perf_counter()
    sim = gpu.similarity(img_g, txt_g)
    sim_s = time.perf_counter() - t
    err = float(np.abs(sim[:CPU_CHECK_ROWS, :CPU_CHECK_ROWS] - cpu.similarity(img_c, txt_c)).max())
    require(sim.shape == (BATCH, BATCH) and err <= E2E_ATOL,
            f"similarity: GPU vs CPU max|err| {err} (tol {E2E_ATOL})")
    out["similarity"] = {"host_ms": sim_s * 1e3, "cpu_check_max_abs_err": err,
                         "temperature": float(np.exp(float(gpu.task.itc_temp)))}
    print("downstream_serve: " + json.dumps(out), flush=True)
    del preds
    torch.cuda.empty_cache()
    return out


def momentum_itc_temp_grad(feats: dict, branch: dict, log_temp: float) -> float:
    """d(loss)/d itc_temp of a momentum step in fp64 from a device's own
    features: each microbatch's globals (`feats['v'][i]`, `feats['l'][i]`)
    against the full batch's momentum features and the queue the step
    contrasted them with (`branch`, `record_momentum_branch`), through
    `itc_losses`, averaged over the microbatches as the step averages their
    losses. ITC is the only loss that reads itc_temp (ITM's hard negatives
    take its sims detached)."""
    t = torch.tensor(log_temp, dtype=torch.float64, requires_grad=True)
    mf = {k: v.double() if v.is_floating_point() else v for k, v in branch["feats"].items()}
    queue = {k: v.double() for k, v in branch["queue"].items()}
    size = len(feats["v"][0])
    loss = sum(itc_losses(i, tx, t.exp(), None, mf, queue, k * size)["itc_task_loss"]
               for k, (i, tx) in enumerate(zip(feats["v"], feats["l"]))) / len(feats["v"])
    loss.backward()
    return float(t.grad)


def record_momentum_branch(trainer: Trainer, store: dict, key: str) -> None:
    """Keep in `store[key]` a host copy of the momentum features and the
    queues that each step of `trainer` contrasts against (before the step
    writes the queues)."""
    branch = trainer.momentum_branch

    def recorded(mb):
        feats, queue = branch(mb)
        store[key] = {"feats": {k: v.detach().cpu().clone() for k, v in feats.items()},
                      "queue": {k: v.detach().cpu().clone() for k, v in queue.items()}}
        return feats, queue

    trainer.momentum_branch = recorded


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return ((got - want).norm() / want.norm().clamp_min(1e-30)).item()


def momentum_cpu_check() -> dict:
    """One batch-MOMENTUM_CPU_BATCH step of the recipe at
    accumulation_steps=2 on the card and on the CPU's plain path, from the
    same weights, trees (copies of the same seeded init), queues (the
    CPU's, copied to the card), batch, ITM negatives and MIM labels; hidden
    dropout and DropPath off, attention dropout on through the hash.
    Compared as phase 8 compares, itc_temp's gradient at each device's own
    features through `momentum_itc_temp_grad`; then the queues' new
    columns, equal on each device to its own momentum features, and
    MOMENTUM_CPU_LEAF of both trees, across the devices, each beside the
    control that must fail (`momentum_feature_gaps`)."""
    cfg_dict = load_config(MOMENTUM_OVERRIDES + [
        f"data.batch_size={MOMENTUM_CPU_BATCH}", "train.accumulation_steps=2",
        "model.drop_rate=0.0", "model.drop_path_rate=0.0"])
    gpu, cpu = Trainer(cfg_dict, device="cuda"), Trainer(cfg_dict, device="cpu")
    trainers = {"gpu": gpu, "cpu": cpu}
    with torch.no_grad():
        gpu.state.img_queue.copy_(cpu.state.img_queue)
        gpu.state.txt_queue.copy_(cpu.state.txt_queue)
        for tr in trainers.values():
            for tree in (tr.state.ema_task, tr.state.model_ema_task):
                tree.get_parameter(MOMENTUM_CPU_LEAF).zero_()
    batch = cpu.next_batch()
    labels = cpu.model_batch(batch)["mim_labels"]
    mb = MOMENTUM_CPU_BATCH // 2
    negatives = (torch.arange(1, mb + 1) % mb, torch.arange(mb - 1, 2 * mb - 1) % mb)
    branches: dict = {}
    for d, tr in trainers.items():
        record_momentum_branch(tr, branches, d)
    result = compare_step(
        "momentum_cpu_check", gpu, cpu, batch, CHECKED_PARAMS, negatives=negatives,
        mim_labels=labels,
        itc_temp_grad=lambda d, f, lt: momentum_itc_temp_grad(f, branches[d], lt))
    require(gpu.state.queue_ptr == cpu.state.queue_ptr == MOMENTUM_CPU_BATCH,
            f"momentum_cpu_check: queue pointers {gpu.state.queue_ptr}, "
            f"{cpu.state.queue_ptr}, expected {MOMENTUM_CPU_BATCH}")
    cols = slice(0, MOMENTUM_CPU_BATCH)
    written = {d: {k: getattr(tr.state, f"{k}_queue")[:, cols].cpu() for k in ("img", "txt")}
               for d, tr in trainers.items()}
    own = all(torch.equal(written[d][k], branches[d]["feats"][f"{k[0]}_feat_m"].float().T)
              for d in written for k in ("img", "txt"))
    step_gap = {f"{k}_queue": rel_l2(written["gpu"][k], written["cpu"][k])
                for k in ("img", "txt")}
    # each tree's leaf after the step: p (1 - its decay); the control is
    # the other tree's decay on the CPU's parameters
    p1 = cpu.task.get_parameter(MOMENTUM_CPU_LEAF).detach()
    trees = {"vlmo_ema": ("ema_task", "model_ema_decay"),
             "model_ema": ("model_ema_task", "ema_decay")}
    leaf, leaf_control = {}, {}
    for name, (attr, other) in trees.items():
        got = getattr(gpu.state, attr).get_parameter(MOMENTUM_CPU_LEAF)
        leaf[name] = rel_l2(got, getattr(cpu.state, attr).get_parameter(MOMENTUM_CPU_LEAF))
        leaf_control[name] = rel_l2(got, p1 * (1.0 - getattr(cpu.state, other)))
    gaps = momentum_feature_gaps(gpu, cpu, labels)
    gaps["step"] = {"gap": step_gap}
    worst = max(max(g["gap"].values()) for g in gaps.values())
    least_control = {c: min(min(g[c].values()) for k, g in gaps.items() if k != "step")
                     for c in ("dropout", "e4m3_weights")}
    print("momentum_cpu_check: " + json.dumps({
        "feature_gaps": gaps, "max_feature_gap": worst,
        "min_control": least_control, "feature_tol": MOMENTUM_FEATURE_TOL,
        "ema_leaf_rel_err": leaf, "ema_leaf_control": leaf_control,
        "leaf_tol": MOMENTUM_LEAF_TOL, "queue_holds_own_features": own}), flush=True)
    require(own and worst <= MOMENTUM_FEATURE_TOL < least_control["e4m3_weights"],
            f"momentum_cpu_check: queue columns (own features: {own}) or momentum "
            f"features differ by {worst}, or the e4m3 control reads "
            f"{least_control['e4m3_weights']}, within {MOMENTUM_FEATURE_TOL}")
    require(max(leaf.values()) <= MOMENTUM_LEAF_TOL < min(leaf_control.values()),
            f"momentum_cpu_check: the EMA leaves differ by {leaf}, or the other "
            f"decay's control reads {leaf_control}, within {MOMENTUM_LEAF_TOL}")
    del gpu, cpu
    torch.cuda.empty_cache()
    return result


def momentum_feature_gaps(gpu: Trainer, cpu: Trainer, labels: torch.Tensor) -> dict:
    """For each seed of MOMENTUM_GAP_SEEDS, the momentum tree drawn anew
    from it on the CPU and copied to the card, and the CPU trainer's next
    batch: the relative L2 gap of the queue's features (`i_feat_m`,
    `t_feat_m`) between the two devices, and that of the card's features
    under two faults (the controls): the momentum forward's attention
    dropout on (`dropout`), and the tree's weights rounded to float8 e4m3
    with a scale for each tensor (`e4m3_weights`)."""
    out = {}
    tree = gpu.state.ema_task
    for seed in MOMENTUM_GAP_SEEDS:
        cpu.state.ema_task.init_weights(torch.Generator().manual_seed(seed))
        tree.load_state_dict(cpu.state.ema_task.state_dict())
        batch = cpu.next_batch()
        mbs = {"gpu": gpu.model_batch(batch, labels), "cpu": cpu.model_batch(batch, labels)}
        feats = {}
        with torch.no_grad():
            for d, tr in (("gpu", gpu), ("cpu", cpu)):
                feats[d] = tr.state.ema_task.itc_momentum_feats(mbs[d])
            rng, infer = gpu.state.step_rng(), tree.infer
            tree.infer = lambda b, mode, **kw: infer(b, mode, rng=rng, **kw)
            feats["dropout"] = tree.itc_momentum_feats(mbs["gpu"])
            del tree.infer
            for p in tree.parameters():
                scale = p.abs().max().clamp_min(1e-30) / 448.0
                p.copy_((p / scale).to(torch.float8_e4m3fn).float() * scale)
            feats["e4m3_weights"] = tree.itc_momentum_feats(mbs["gpu"])

        def gap(d):
            return {f"{k}_queue": rel_l2(feats[d][f"{k[0]}_feat_m"],
                                         feats["cpu"][f"{k[0]}_feat_m"]) for k in ("img", "txt")}

        out[f"seed_{seed}"] = {"gap": gap("gpu"), "dropout": gap("dropout"),
                               "e4m3_weights": gap("e4m3_weights")}
    return out


def alternated_steps(recipe: Trainer, plain: Trainer) -> dict:
    """The recipe's step and plain pretrain_mum's taken in turn in one
    process, ALTERNATED_PAIRS pairs after a warm-up step of each (the
    first of each pair alternating), each step timed with a synchronise
    around it: the host's drift and the card's clocks fall on both alike."""
    plain.step()
    recipe.step()
    times: dict[str, list[float]] = {"recipe": [], "plain": []}
    for i in range(ALTERNATED_PAIRS):
        for name in (("plain", "recipe") if i % 2 == 0 else ("recipe", "plain")):
            torch.cuda.synchronize()
            t = time.perf_counter()
            (recipe if name == "recipe" else plain).step()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t) * 1e3)
    diffs = sorted(r - p for r, p in zip(times["recipe"], times["plain"]))
    return {"pairs": ALTERNATED_PAIRS, "ms_per_step": times,
            "median_ms_per_step": {k: statistics.median(v) for k, v in times.items()},
            "added_ms_per_step_median": statistics.median(diffs),
            "added_ms_per_step_quartiles": [diffs[len(diffs) // 4],
                                            diffs[(3 * len(diffs)) // 4]]}


def momentum_phase(card: str) -> dict:
    """Phase 23: pretrain_mum's full recipe at vlmo_base, batch 32."""
    cfg_dict = load_config(MOMENTUM_OVERRIDES)
    cfg = VlmoConfig.from_config(cfg_dict)
    t = cfg_dict["train"]
    require(cfg.attn_impl == "auto" and cfg.attn_drop_rate > 0 and cfg_dict["vlmo_ema"]
            and cfg_dict["model_ema"] and t["neg_queue"] and t["queue_size"] == 65536
            and cfg.itc_dim == 256 and t["accumulation_steps"] == 1
            and cfg_dict["data"]["batch_size"] == TRAIN_BATCH,
            "the momentum phase must run the recipe's defaults at batch 32")
    per_step = attention_calls_per_step(cfg)
    momentum_calls = 2 * cfg.depth  # the momentum encoder's image and text streams
    expected = {"flash_attention_fwd_drop": per_step, "flash_attention_bwd_drop": per_step,
                "flash_attention_fwd": 0, "flash_attention_bwd": 0}
    if "train" not in TIMED:  # alone (--momentum): phase 6's step in this run
        timed_phase("train", load_config(TRAIN_OVERRIDES), CHECKED_PARAMS, {
            "flash_attention_fwd_drop": per_step, "flash_attention_bwd_drop": per_step})

    t0 = time.perf_counter()
    trainer = Trainer(cfg_dict, device="cuda")
    print(f"momentum_train: Trainer ready in {time.perf_counter() - t0:.1f} s", flush=True)
    st = trainer.state
    q_size = st.img_queue.shape[1]
    require((st.ema_decay, st.model_ema_decay) == (0.995, 0.9999)
            and st.img_queue.shape == (256, 65536),
            f"momentum_train: decays {st.ema_decay}, {st.model_ema_decay}, queue "
            f"{tuple(st.img_queue.shape)}")
    # the warm-up step, with one leaf of each tree set to 0 before it: after
    # it the leaf holds p * (1 - decay), each tree at its own decay
    with torch.no_grad():
        for tree in (st.ema_task, st.model_ema_task):
            tree.get_parameter(MOMENTUM_LEAF).zero_()
    ptr0 = st.queue_ptr
    trainer.step()
    torch.cuda.synchronize()
    p1 = trainer.task.get_parameter(MOMENTUM_LEAF).detach()
    decay_err = {name: rel_l2(tree.get_parameter(MOMENTUM_LEAF), p1 * (1.0 - d))
                 for name, tree, d in (("vlmo_ema", st.ema_task, st.ema_decay),
                                       ("model_ema", st.model_ema_task, st.model_ema_decay))}
    norms = torch.cat([torch.linalg.vector_norm(q[:, ptr0:ptr0 + TRAIN_BATCH], dim=0)
                       for q in (st.img_queue, st.txt_queue)])
    norm_err = (norms - 1.0).abs().max().item()
    require(max(decay_err.values()) <= 1e-5 and norm_err <= 1e-2,
            f"momentum_train: EMA leaves off their decays {decay_err} or written queue "
            f"columns off unit norm by {norm_err}")
    torch.cuda.reset_peak_memory_stats()
    metrics, times, launches = run_counted(trainer, TRAIN_STEPS, timed=True)
    require_launches("momentum_train", launches, expected, TRAIN_STEPS)
    ptr = (ptr0 + TRAIN_BATCH * (1 + TRAIN_STEPS)) % q_size
    require(st.queue_ptr == ptr and all(k in m for m in metrics for k in MOMENTUM_LOSSES),
            f"momentum_train: queue pointer {st.queue_ptr} (expected {ptr}) or the "
            f"momentum losses missing: {sorted(metrics[-1])}")
    med = statistics.median(times)
    plain = TIMED["train"]["median_ms_per_step"]
    result = {
        "batch": TRAIN_BATCH, "steps": TRAIN_STEPS, "ms_per_step": [x * 1e3 for x in times],
        "median_ms_per_step": med * 1e3, "plain_pretrain_mum_median_ms_per_step": plain,
        "added_ms_per_step": med * 1e3 - plain, "images_per_s": TRAIN_BATCH / med,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches": launches, "expected_launches_per_step": expected,
        "ema_decay_rel_err": decay_err, "queue_norm_err": norm_err, "queue_ptr": st.queue_ptr,
        "losses": [{k: v for k, v in m.items() if k.endswith(("_task_loss", "_Loss"))
                    or k in ("total_loss", "grad_norm", "lr")} for m in metrics],
    }
    print("momentum_train: " + json.dumps(result), flush=True)
    plain_trainer = Trainer(load_config(TRAIN_OVERRIDES), device="cuda")
    print("momentum_alternated: " + json.dumps(alternated_steps(trainer, plain_trainer)),
          flush=True)
    del plain_trainer
    torch.cuda.empty_cache()

    # evaluation runs the eval EMA: equal to an evaluation of a task that
    # holds its tree
    val = build_dataset({**cfg_dict, "data": {**cfg_dict["data"], "synthetic_size":
                                              MOMENTUM_EVAL_BATCHES * TRAIN_BATCH}}, "val")
    loader = Loader(val, TRAIN_BATCH, seed=int(cfg_dict["seed"]), train=False)
    require(len(loader) == MOMENTUM_EVAL_BATCHES, f"{len(loader)} eval batches")
    got = trainer.evaluate(loader)
    ref = build_model(cfg_dict, device="cuda")
    ref.load_state_dict(st.model_ema_task.state_dict())
    trainer.eval_task = lambda: ref
    want = trainer.evaluate(loader)
    trainer.eval_task = lambda: trainer.task
    live = trainer.evaluate(loader)
    del trainer.eval_task
    eval_err = max(abs(got[k] - want[k]) / max(abs(want[k]), 1e-30) for k in want)
    print("momentum_eval: " + json.dumps({
        "eval_ema": got, "task_with_eval_ema_tree": want, "live_parameters": live,
        "max_rel_diff": eval_err}), flush=True)
    require(set(got) == set(want) and eval_err <= 1e-6 and all(
        np.isfinite(v) for v in got.values()),
        f"momentum_eval: evaluate is not the eval EMA's tree: {got} vs {want}")
    del trainer, ref
    torch.cuda.empty_cache()

    # attn_impl=pallas: row 1 on the momentum encoder's 24 attention calls
    pallas, _, _ = short_phase("momentum_pallas",
                               load_config(MOMENTUM_OVERRIDES + ["attn_impl=pallas"]),
                               {**expected, "flash_attention_fwd": momentum_calls})
    # two microbatches of 16: rows 3 and 4 twice a step, at BH = 16 x 12
    accum, _, _ = short_phase(
        "momentum_accum2", load_config(MOMENTUM_OVERRIDES + ["train.accumulation_steps=2"]),
        {**expected, "flash_attention_fwd_drop": 2 * per_step,
         "flash_attention_bwd_drop": 2 * per_step})
    momentum_cpu_check()
    return {"train": launches, "pallas": pallas, "accum": accum}


def accum_dropout_masks(cfg: VlmoConfig, dev) -> None:
    """The dropout mask bit for bit at the microbatches' rows of
    accumulation_steps=2: the streams' B/2 and ITM's 3B/2 (BH = 192 and
    576, N = 237)."""
    for rows in (TRAIN_BATCH // 2, 3 * TRAIN_BATCH // 2):
        print("dropout_mask: " + json.dumps(check_dropout_mask(cfg, dev, rows)), flush=True)


def momentum_only(card: str, dev) -> int:
    """The build, rows 1, 3 and 4 at the shapes phase 23 alone gives them
    and the dropout mask at its microbatches' rows, then phase 23 alone
    (`--momentum`), with phase 6's timed step for its baseline."""
    train_cfg = VlmoConfig.from_config(load_config(TRAIN_OVERRIDES))
    rows = check_attention(VlmoConfig.from_config(load_config(SERVE_OVERRIDES)),
                           np.random.default_rng(0), dev, only=MOMENTUM_STREAMS)
    for row in rows:
        print("kernel: " + json.dumps({"name": "flash_attention_fwd", **row}), flush=True)
    train_rows = check_attention_train(train_cfg, np.random.default_rng(1), dev,
                                       only=ACCUM_STREAMS)
    for name, entries in train_rows.items():
        for row in entries:
            print("kernel: " + json.dumps({"name": name, **row}), flush=True)
    accum_dropout_masks(train_cfg, dev)
    momentum_phase(card)
    return 0


def downstream_only(card: str, dev) -> int:
    """The build, rows 2-4 at IRTR's shape and its dropout mask, then the
    downstream phases alone (`--downstream`)."""
    train_cfg = VlmoConfig.from_config(load_config(TRAIN_OVERRIDES))
    rows = check_attention_train(train_cfg, np.random.default_rng(1), dev, only=("irtr",))
    for name, entries in rows.items():
        for row in entries:
            print("kernel: " + json.dumps({"name": name, **row}), flush=True)
    print("dropout_mask: " + json.dumps(check_dropout_mask(train_cfg, dev,
                                                           IRTR_ROWS * TRAIN_BATCH)), flush=True)
    downstream_train_phase(card)
    downstream_serve_phase(card)
    return 0


def main(argv: list[str] | None = None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)

    t0 = time.perf_counter()
    logs = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s wall", flush=True)
    for name, (secs, log) in logs.items():
        print(f"build: {name} {secs:.1f} s", flush=True)
        for line in log.splitlines():
            if any(k in line for k in ("registers", "spill", "bytes smem", "Performance Loss")):
                print(f"  {line.strip()}", flush=True)
    if args[:1] == ["--train-loop-samples"]:
        return loop_fit(card, img_txt_calls(VlmoConfig.from_config(load_config(
            SERVE_OVERRIDES))), [int(n) for n in args[1:]])
    if args[:1] == ["--downstream"]:
        return downstream_only(card, dev)
    if args[:1] == ["--momentum"]:
        return momentum_only(card, dev)

    print("smem: " + json.dumps(check_layouts()), flush=True)

    cfg_dict = load_config(SERVE_OVERRIDES)
    cfg = VlmoConfig.from_config(cfg_dict)
    attn_rows = check_attention(cfg, np.random.default_rng(0), dev)
    mlp_rows = check_mlp(cfg, dev)
    for row in attn_rows + mlp_rows:
        print("kernel: " + json.dumps(row), flush=True)

    calls = img_txt_calls(cfg)
    serve_launches, bf16_outputs = serve("serve", cfg_dict, cfg, card, {
        "flash_attention_fwd": calls, "fused_mlp_fwd": calls})

    train_dict = load_config(TRAIN_OVERRIDES)
    train_cfg = VlmoConfig.from_config(train_dict)
    require(train_cfg.attn_impl == "auto" and train_cfg.attn_drop_rate > 0
            and train_dict["data"]["batch_size"] == TRAIN_BATCH,
            "the training phase must run the default attention path at batch 32")
    train_rows = check_attention_train(train_cfg, np.random.default_rng(1), dev)
    for name, rows in train_rows.items():
        for row in rows:
            print("kernel: " + json.dumps({"name": name, **row}), flush=True)
    print("dropout_mask: " + json.dumps(check_dropout_mask(train_cfg, dev, 3 * TRAIN_BATCH)),
          flush=True)
    # the streamed forward and the backward's sm90 kernels past 256 keys
    # (one head slot, work units)
    print("dropout_mask: " + json.dumps(check_dropout_mask(train_cfg, dev, OFF_PATH_BATCH,
                                                           SM90_BWD_MAX_N)), flush=True)
    # IRTR's rows: BH = 1,536, N = 237
    print("dropout_mask: " + json.dumps(check_dropout_mask(train_cfg, dev,
                                                           IRTR_ROWS * TRAIN_BATCH)), flush=True)
    accum_dropout_masks(train_cfg, dev)
    per_step = attention_calls_per_step(train_cfg)
    train_launches = timed_phase("train", train_dict, CHECKED_PARAMS, {
        "flash_attention_fwd_drop": per_step, "flash_attention_bwd_drop": per_step})
    # attn_impl=pallas at attention dropout 0: rows 1 and 2 on the step
    drop0_launches, _, _ = short_phase(
        "train_attn_drop0",
        load_config(TRAIN_OVERRIDES + ["attn_impl=pallas", "model.attn_drop_rate=0.0"]),
        {"flash_attention_fwd": per_step, "flash_attention_bwd": per_step})
    cpu_check_phase()

    vqa_dict = load_config(VQA_OVERRIDES)
    vqa_cfg = VlmoConfig.from_config(vqa_dict)
    require(vqa_cfg.attn_impl == "auto" and vqa_cfg.attn_drop_rate > 0
            and vqa_cfg.drop_rate > 0 and vqa_cfg.mlp_impl == "fused"
            and vqa_cfg.kl_alpha == 0 and vqa_cfg.isda_lambda == 0
            and vqa_dict["data"]["batch_size"] == VQA_BATCH,
            "the finetune_vqa phase must run the default dropout path at batch 32")
    mlp_drop_rows = check_mlp_drop(vqa_cfg, dev)
    for row in mlp_drop_rows:
        print("kernel: " + json.dumps({"name": "fused_mlp_fwd_drop", **row}), flush=True)
    print("mlp_backward: " + json.dumps(check_mlp_backward(vqa_cfg, dev)), flush=True)
    # rows 7, 3 and 4 on every FFN and attention call, row 6 on none
    vqa_launches = timed_phase("vqa_train", vqa_dict, CHECKED_VQA_PARAMS, {
        "fused_mlp_fwd_drop": calls, "flash_attention_fwd_drop": calls,
        "flash_attention_bwd_drop": calls, "fused_mlp_fwd": 0})
    # R-Drop's second forward doubles every launch; ISDA counts the batch
    _, steps, count = short_phase(
        "vqa_rdrop_isda",
        load_config(VQA_OVERRIDES + ["train.kl_alpha=1.0", "train.isda_lambda=0.5"]),
        {"fused_mlp_fwd_drop": 2 * calls, "flash_attention_fwd_drop": 2 * calls,
         "flash_attention_bwd_drop": 2 * calls})
    require(count == EXTRA_STEPS * VQA_BATCH and all("vqa_kl_task_loss" in m for m in steps),
            f"R-Drop/ISDA: ISDA count {count} after {EXTRA_STEPS} steps of {VQA_BATCH}, "
            "or no KL loss")
    # attention and hidden dropout 0 at attn_impl=pallas: rows 1, 2 and 6 train
    short_phase(
        "vqa_drop0",
        load_config(VQA_OVERRIDES + ["attn_impl=pallas", "model.attn_drop_rate=0.0",
                                     "model.drop_rate=0.0"]),
        {"flash_attention_fwd": calls, "flash_attention_bwd": calls,
         "fused_mlp_fwd": calls, "fused_mlp_fwd_drop": 0})
    vqa_cpu_check_phase("vqa_cpu_check", VQA_OVERRIDES)

    # ---- int8 (W8A8): rows 8, 9 and 10 at the path shapes, then the paths
    w8_dict = load_config(W8A8_SERVE_OVERRIDES)
    w8_cfg = VlmoConfig.from_config(w8_dict)
    w8_rows = {"w8a8_matmul": check_w8a8_matmul(w8_cfg, dev),
               "w8a8_mlp_fwd": check_w8a8_mlp(w8_cfg, dev, drop=False),
               "w8a8_mlp_fwd_drop": check_w8a8_mlp(vqa_cfg, dev, drop=True)}
    for name, rows in w8_rows.items():
        for row in rows:
            print("kernel: " + json.dumps({"name": name, **row}), flush=True)
    print("quant_dot: " + json.dumps(check_quant_dot(w8_cfg, dev)), flush=True)
    # row 9 on every FFN call (the int8 branch takes precedence over
    # mlp_impl=fused), row 1 on every attention call
    w8_serve_launches, w8_outputs = serve(
        "serve_w8a8", w8_dict, w8_cfg, card,
        {"w8a8_mlp_fwd": calls, "flash_attention_fwd": calls, "fused_mlp_fwd": 0,
         "w8a8_matmul": 0}, e2e_atol=W8A8_E2E_ATOL)
    agree = [float((a.argmax(-1) == b.argmax(-1)).mean())
             for a, b in zip(w8_outputs, bf16_outputs)]
    print(f"serve_w8a8: argmax agreement with the bf16 path, per request: {agree}",
          flush=True)
    # w8a8_pallas: row 8 on qkv and proj as well
    w8p_launches, _ = serve(
        "serve_w8a8_pallas", load_config(SERVE_OVERRIDES + ["model.quantize=w8a8_pallas"]),
        w8_cfg, card, {"w8a8_matmul": 2 * calls, "w8a8_mlp_fwd": calls,
                       "flash_attention_fwd": calls},
        e2e_atol=W8A8_E2E_ATOL, cpu_check=(1, CPU_CHECK_ROWS))
    # row 10 on every FFN call, rows 3 and 4 on every attention call
    w8_vqa_launches = timed_phase("vqa_w8a8_train", load_config(W8A8_VQA_OVERRIDES),
                                  CHECKED_VQA_PARAMS, {
        "w8a8_mlp_fwd_drop": calls, "flash_attention_fwd_drop": calls,
        "flash_attention_bwd_drop": calls, "w8a8_mlp_fwd": 0, "fused_mlp_fwd_drop": 0,
        "w8a8_matmul": 0})
    short_phase("vqa_w8a8_pallas", load_config(VQA_OVERRIDES + ["model.quantize=w8a8_pallas"]),
                {"w8a8_matmul": 2 * calls, "w8a8_mlp_fwd_drop": calls})
    # attention and hidden dropout 0 at attn_impl=pallas: row 9 trains
    short_phase(
        "vqa_w8a8_drop0",
        load_config(W8A8_VQA_OVERRIDES + ["attn_impl=pallas", "model.attn_drop_rate=0.0",
                                          "model.drop_rate=0.0"]),
        {"w8a8_mlp_fwd": calls, "flash_attention_fwd": calls, "flash_attention_bwd": calls,
         "w8a8_mlp_fwd_drop": 0})
    vqa_cpu_check_phase("vqa_w8a8_cpu_check", W8A8_VQA_OVERRIDES)

    # ---- high-resolution serving: row 5 at the path shapes, then the path
    hires_dict = load_config(HIRES_OVERRIDES)
    hires_cfg = VlmoConfig.from_config(hires_dict)
    long_rows = check_attention_long(hires_cfg, np.random.default_rng(2), dev)
    for row in long_rows:
        print("kernel: " + json.dumps({"name": "flash_attention_fwd_long", **row}), flush=True)
    # row 5 on the image and fused streams (padded N 4224 > FULL_ROW_FWD_MAX),
    # row 1 on the text stream, row 6 on every FFN call
    hires_launches, _ = serve(
        "serve_hires", hires_dict, hires_cfg, card,
        {"flash_attention_fwd_long": calls - hires_cfg.fusion_layer,
         "flash_attention_fwd": hires_cfg.fusion_layer, "fused_mlp_fwd": calls},
        batch=HIRES_BATCH, cpu_check=(1, HIRES_CPU_ROWS))

    # ---- the tokenizer: row 11 at the five fused blocks, then four ways
    dvae_rows = check_dvae_block(dev)
    for row in dvae_rows:
        print("kernel: " + json.dumps({"name": "fused_encoder_block", **row}), flush=True)
    _, tok_launches = tokenize_phase(card, dev)
    # pretrain_mum with MIM labels from the int8 dVAE
    short_phase(
        "train_dvae_w8a8", load_config(TRAIN_OVERRIDES + ["train.discrete_vae_quantize=w8a8"]),
        {"flash_attention_fwd_drop": per_step, "flash_attention_bwd_drop": per_step},
        check=lambda tr: require(tr.dvae.encoder.quantize == "w8a8",
                                 "the trainer's dVAE is not int8"))

    # pretrain_txt at 512 tokens: rows 3 and 4 (and 1 and 2 at dropout 0)
    txt_launches = txt_phase()

    # the run around the step: epochs with evaluation, checkpoints, resume,
    # serving from a checkpoint, throughput mode
    train_loop_phase(card, calls)

    # pretrain_vis, finetune_nlvr2 and finetune_retrieval, then the
    # retrieval and NLVR2 endpoints
    downstream_train_phase(card)
    downstream_serve_phase(card)

    # pretrain_mum's full recipe: the momentum encoder, the queues, the eval
    # EMA and accumulation
    momentum_phase(card)

    def entry(name, route, source, replaces, rows, launches):
        big = rows[-1]  # the largest shape on the path
        return {
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": big["ms"], "plain_ms": big["plain_ms"],
            "bound_ms": big["bound_ms"], "bound_by": big["bound_by"],
            "library_ms": big["library_ms"],
        }

    stream_src = "exploremultimodal_torch/ops/csrc/flash_attention_long_sm90.cu"
    fwd_sm90_src = "exploremultimodal_torch/ops/csrc/flash_attention_fwd_sm90.cu"
    bwd_sm90_src = "exploremultimodal_torch/ops/csrc/flash_attention_bwd_sm90.cu"
    tpu_fa = "exploremultimodal_tpu/ops/flash_attention.py"
    mlp_src = "exploremultimodal_torch/ops/csrc/fused_mlp_sm90.cu"
    tpu_mlp = "exploremultimodal_tpu/ops/mlp_pallas.py"
    q_src = "exploremultimodal_torch/ops/csrc/w8a8_matmul_sm90.cu"
    qmlp_src = "exploremultimodal_torch/ops/csrc/w8a8_mlp_sm90.cu"
    tpu_q = "exploremultimodal_tpu/ops/quant_pallas.py"
    # rows 1-4 at their largest path shape, pretrain_txt's BH = 384, N = 512
    # (rows 1 and 3 on the streamed kernel there, the short one on the other
    # paths), with that phase's launches
    kernels = [
        entry("flash_attention_fwd", "cuda", stream_src, f"{tpu_fa}:152", attn_rows,
              txt_launches["txt_attn_drop0"]),
        entry("flash_attention_bwd", "cuda", bwd_sm90_src, f"{tpu_fa}:170",
              train_rows["flash_attention_bwd"], txt_launches["txt_attn_drop0"]),
        entry("flash_attention_fwd_drop", "cuda", stream_src, f"{tpu_fa}:209",
              train_rows["flash_attention_fwd_drop"], txt_launches["txt_train"]),
        entry("flash_attention_bwd_drop", "cuda", bwd_sm90_src, f"{tpu_fa}:237",
              train_rows["flash_attention_bwd_drop"], txt_launches["txt_train"]),
        entry("fused_mlp_fwd", "cuda", mlp_src, f"{tpu_mlp}:56", mlp_rows,
              serve_launches),
        entry("fused_mlp_fwd_drop", "cuda", mlp_src, f"{tpu_mlp}:69", mlp_drop_rows,
              vqa_launches),
        entry("w8a8_matmul", "cuda", q_src, f"{tpu_q}:48", w8_rows["w8a8_matmul"],
              w8p_launches),
        entry("w8a8_mlp_fwd", "cuda", qmlp_src, f"{tpu_q}:233", w8_rows["w8a8_mlp_fwd"],
              w8_serve_launches),
        entry("w8a8_mlp_fwd_drop", "cuda", qmlp_src, f"{tpu_q}:366",
              w8_rows["w8a8_mlp_fwd_drop"], w8_vqa_launches),
        entry("flash_attention_fwd_long", "cuda", stream_src, f"{tpu_fa}:113", long_rows,
              hires_launches),
        entry("fused_encoder_block", "cuda", "exploremultimodal_torch/ops/csrc/dvae_block.cu",
              "exploremultimodal_tpu/ops/dvae_conv.py:127", dvae_rows, tok_launches),
    ]
    for k in kernels[:4:2]:  # rows 1 and 3: the short kernel up to 256 keys
        k["sources"] = [fwd_sm90_src, stream_src]
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
