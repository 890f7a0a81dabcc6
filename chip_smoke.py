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
    python3 chip_smoke.py --finetune-rest
                                 # the build and phase 24 alone
    python3 chip_smoke.py --data # the build and phase 25 alone
    python3 chip_smoke.py --parallel
                                 # the build and phase 26 alone
    python3 chip_smoke.py --tp   # the build and phase 27 alone
    python3 chip_smoke.py --optim
                                 # the build and phase 28 alone
    python3 chip_smoke.py --tp-int8
                                 # the build and phase 29 alone
    python3 chip_smoke.py --widths
                                 # the build, the layouts (phase 3's first
                                 # check) and phase 30 alone

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
     row 1 on the 4 eval batches and the 2 batches of the test-split
     submission, written after training), finite `log_stats.json` lines with
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
 24. the last four phases at vlmo_base, batch 32, on the synthetic data at
     their defaults (rows 3 and 4 18 times a step, img_txt_calls):
     finetune_caption (MLM over image-text pairs; C9: the image side, the
     fused experts and the pooler held fixed), finetune_vis (imgcls, the
     fused path on captioned samples), finetune_ref (the box head) and
     finetune_inpainting (MIM on the fused stream, region masks, random
     dVAE labels through cuDNN): each a warm-up step and TRAIN_STEPS timed
     ones, the trained parameters moved and the frozen ones not, then a
     batch-2 step against the CPU (as phase 8); two steps of the MPP
     objective (`train=pretrain_mum train.loss_names=[mpp]`); two
     finetune_vqa steps and the test-split submission written and read
     back; serving at batch 64 under SERVE_OVERRIDES: `caption_ids` (16
     tokens, 8 iterations: rows 1 and 6 f + 8 d = 102 times a request),
     held to the CPU by teacher forcing on 4 rows (at each iteration the
     CPU's MLM logits from the card's ids within E2E_ATOL, and the card's
     next ids equal to the CPU's keep/re-mask rule applied to the card's
     logits), and `inpaint_ids` with one region mask a row (f + d = 18),
     held to the CPU on 4 rows (MIM logits within E2E_ATOL, merged codes
     at the masked patches in at least INPAINT_AGREEMENT agreement, the
     pixels outside the mask within 1e-5 of the CPU's resized input, the
     codes outside the mask the card's dVAE encoder's own); the latencies
     timed; one forward and backward of `DiscreteVAE` at its defaults on
     the card and the CPU (no Gumbel noise): the reconstruction loss within
     1e-3 relative, every gradient within GRAD_REL_TOL;
 25. real data (DATA_IMAGES seeded 640x480 JPEGs at quality 90 with five
     captions each, coco's train and val tables, vg, vqav2_train with
     answers and question ids, a save_to_disk text corpus, in a temporary
     directory): which of pyarrow, PIL and `datasets` import and whether
     `jpeglib.h`, libjpeg and the native loader's build are found (a part
     whose package is missing is left out, named on a line of its own; the
     native route without the library); the tokenizer's and the collator's
     host microseconds per caption and per 512-token packed sample; the
     train loader's images per second at 1, 8 and 16 threads; two loaders
     of one seed and epoch giving the same batches at 8 threads;
     pretrain_mum at vlmo_base, batch 32, from coco and vg (rows 3 and 4 54
     times a step), steps fed by the loader against steps on batches
     collated before, in DATA_ROUNDS rounds, with the loader's wait and
     `step/batch` host ms, and the same on the synthetic samples; finetune_vqa from vqav2_train (mlp_impl=fused:
     rows 7, 3 and 4 18 times a step) and pretrain_txt from the corpus at
     512 tokens (rows 3 and 4 12 times), each timed as phase 6; one batch-2
     pretrain_mum step from the shards against the CPU (as phase 8);
     `Predictor.vqa` on 64 PIL images and question strings against
     `vqa_logits` on the same rows (rows 1 and 6 18 times a request, the
     answers equal);
 26. more than one process: rows 3 and 4 with a row index (rank 1 of 2's
     global rows; ITM's pair rows in their three runs) against their plain
     versions at the step's shapes, the mask bit for bit at ITM's, each
     timed with the index and without; the two-rank probe (the card count,
     NCCL's answer to two ranks on one device, gloo's to CUDA tensors for
     all_reduce, all_gather_into_tensor and reduce_scatter_tensor, from two
     processes of this script); dp, zero1, fsdp (remat on), fsdp_offload
     and dp with parallel.remat=dots on an NCCL group of one rank at
     vlmo_base, batch 32: the first step's losses equal across them, the
     median of PARALLEL_STEPS timed steps, peak memory, rows 3 and 4 a step
     (row 3 twice under remat); where two ranks can run, dp and fsdp at 2 x
     16 against one rank at 32 (losses within LOSS_RTOL, gradients within
     GRAD_REL_TOL), else the reason; `Predictor(devices=["cuda:0"])` against
     the plain `Predictor` (equal logits, rows 1 and 6 18 times a request);
 27. tensor parallelism (parallel=tp, TP = 2): rows 3 and 4 holding heads
     6..11 of 12 at the tp step's BH = 192 (N = 40, 197, 237) and ITM's
     576 (N = 237) against their plain versions with the heads' offset,
     the mask bit for bit at ITM's shape and equal to the whole call's at
     those heads, each timed with the offset and without; rows 6 and 7 in
     the partial mode (fp32, no b2) at hidden 1,536 and 768 and the
     finetune_vqa step's M against their plain versions, the shares summed
     plus b2 against the whole plain MLP, each timed beside the whole
     kernel; pretrain_mum (rows 3 and 4 54 times a step) and finetune_vqa
     with mlp_impl=fused (rows 7, 3 and 4 18 times a step, row 6 18 times
     an evaluation batch) at vlmo_base, batch 32, every dropout on, on two
     gloo ranks of this script on the one card against one process on the
     same weights and batch (losses within LOSS_RTOL, gradients gathered
     whole within GRAD_REL_TOL), with each rank's step time, peak memory
     and all-reduces; the ranks' checkpoint read in one process (logits
     within E2E_ATOL);
 28. the optimizer menu: one pretrain_mum step's gradients at vlmo_base,
     batch 32 (rows 3 and 4 54 times), then every rule of JAX's table and
     lookahead_adamw (OPTIM_LOOKAHEAD_UPDATES updates) applied to them on
     the card over every parameter, each update's host time, and in fp32
     on the CPU over OPTIM_CPU_PARAMS, the largest difference against
     OPTIM_STEP_RTOL of the step (lion: the sign agreement of the step);
     OPTIM_TIMED_STEPS timed training steps under lamb and adafactor with
     rows 3 and 4 counted; lamb and adafactor at fsdp on two gloo ranks of
     this script against one process (losses within LOSS_RTOL, gradients
     within GRAD_REL_TOL, each rule's update on the step's gradients within
     OPTIM_TWO_RANK_REL_L2 and OPTIM_TWO_RANK_SIZE, and its control, each
     shard's own leaf statistics, outside them);
 29. int8 under tensor parallelism: row 8's partial mode on proj's row
     shares (K 384) and its whole mode on qkv's column share (N 1,152), and
     rows 9 and 10's split mode (two launches around the all-reduce-max) on
     the hidden's shares (1,536 of 3,072), at the finetune_vqa step's M,
     against their plain versions, the shares summed against the whole
     plain call, each timed beside the whole kernel, its plain version and
     the `torch._int_mm` chain on the share; then finetune_vqa at
     model.quantize=w8a8_pallas, TP = 2, batch 32, every dropout on, on two
     gloo ranks against one process (rows 8 whole and partial and 10 split
     18 times a step, row 9 split on an evaluation batch), and the ranks'
     checkpoint read in one process;
 30. the presets' widths (ROADMAP A9): rows 6 and 7 at vlmo_tiny's and
     vlmo_small's widths (K = N = 192 and 384) at the serving and
     finetune_vqa M within MLP_ATOL; row 8 bit for bit at vlmo_large's qkv
     and proj (K 1,024) at the serving M, at vlmo_tiny's and vlmo_small's,
     and at every tensor share of vlmo_base and vlmo_large at T = 2 and 4
     (qkv's columns whole, N down to 576; proj's rows partial, K down to
     192) with the shares summed against the whole call; rows 9 and 10 bit
     for bit at vlmo_large's widths (K = N = 1,024, hidden 4,096; the
     second product in two parts) at the serving and step M and split at
     hidden 2,048; each timed beside its plain version and library chain;
     then vlmo_large pretrain_mum at batch 16 (rows 3 and 4 108 times a
     step at 16 heads, the MLP on the erf chain: no row 6 or 7; a warm-up
     and TRAIN_STEPS timed steps, peak memory) with a batch-2 step against
     the CPU at CHECK_DEPTH; vlmo_large serving at w8a8_pallas (rows 8, 9
     and 1 72, 36 and 36 times a request; one request's rows against the
     CPU within W8A8_E2E_ATOL) and its int8 finetune_vqa step (rows 8, 10,
     3 and 4 72, 36, 36 and 36 times a step); vlmo_tiny and vlmo_small
     serving (rows 1 and 6 18 times a request, against the CPU) and
     finetune_vqa with mlp_impl=fused (rows 7, 3 and 4 18 times a step, a
     batch-2 step against the CPU);
 31. print the kernel table as one JSON line (rows 3, 4, 6 and 7 with
     their tp launches; rows 8-10's split modes as entries of their own;
     rows 6-10 with their phase-30 widths, each width's largest shape with
     its launches there), the card line, and last {"ok": true, "device":
     {...}}.
It imports nothing of JAX. The bounds use the H100 SXM data-sheet peaks.
Kernel times are device times: `time_ms` queues the timed calls behind a
device-side sleep, so the host's launch overhead does not enter them.
"""

from __future__ import annotations

import contextlib
import ctypes
import ctypes.util
import importlib
import io
import json
import math
import shutil
import statistics
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from exploremultimodal_torch.config import VlmoConfig, load_config
from exploremultimodal_torch.data.masking import RegionMaskingGenerator
from exploremultimodal_torch.infer import Predictor, mask_predict_step
from exploremultimodal_torch.models import build_model
from exploremultimodal_torch.ops import _build
from exploremultimodal_torch.data.vqa_vocab import load_vqa_vocab
from exploremultimodal_torch.ops.attention import key_padding_bias
from exploremultimodal_torch.models.dvae import (
    DalleEncoder,
    DalleVAE,
    DiscreteVAE,
    map_pixels,
)
from exploremultimodal_torch.ops.dvae_conv import (
    block_widths,
    kernel_grid,
    fused_encoder_block,
    fused_encoder_block_plain,
)
from exploremultimodal_torch.ops.flash_attention import (
    FULL_ROW_FWD_MAX,
    HEAD_DIMS,
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
from exploremultimodal_torch.ops.mlp_fused import sm90_smem as fused_sm90_smem
from exploremultimodal_torch.ops.mlp_fused import (
    fits_vmem,
    fused_mlp,
    fused_mlp_fwd,
    fused_mlp_fwd_drop,
    fused_mlp_fwd_drop_plain,
    fused_mlp_fwd_plain,
    gelu_tanh,
    hidden_splits,
)
from exploremultimodal_torch.ops.preprocess import normalize_image
from exploremultimodal_torch.ops.quant import _quantize_int8, quant_dot
from exploremultimodal_torch.ops.quant_fused import (
    MATMUL_K_MAX,
    MATMUL_K_MIN,
    MLP_WIDTHS,
    int8_product,
    matmul_grid,
    matmul_smem,
    mlp_grid,
    mlp_layout,
    mlp_smem,
    mlp_splits,
    quantize_weights,
    row_quant,
    w8a8_matmul,
    w8a8_matmul_partial,
    w8a8_matmul_partial_plain,
    w8a8_matmul_plain,
    w8a8_mlp_amax_plain,
    w8a8_mlp_fwd,
    w8a8_mlp_fwd_drop,
    w8a8_mlp_fwd_drop_plain,
    w8a8_mlp_fwd_drop_split,
    w8a8_mlp_fwd_plain,
    w8a8_mlp_fwd_split,
    w8a8_mlp_partial_plain,
)
from exploremultimodal_torch.ops.stochastic import keep16, keep_scale16
from exploremultimodal_torch.main import setup
from exploremultimodal_torch.data import native
from exploremultimodal_torch.data.datamodule import MultiTaskData
from exploremultimodal_torch.data.datasets import TextCorpusDataset, build_dataset
from exploremultimodal_torch.data.pipeline import Loader
from exploremultimodal_torch.data.tokenization import MlmCollator, encode_texts, get_tokenizer
from exploremultimodal_torch.objectives.losses import itc_losses
from exploremultimodal_torch.train import checkpoints as ckpt_lib
from exploremultimodal_torch.train.phases import dispatch, write_vqa_submission
from exploremultimodal_torch.train.retrieval import encode_split, recall_at_k
from exploremultimodal_torch.train.optim import RULES as OPTIM_RULE_TABLE
from exploremultimodal_torch.train.optim import create_optimizer
from exploremultimodal_torch.train.trainer import Trainer

# every kernel wrapper of the port, each with its launch count
KERNELS = (flash_attention_fwd, flash_attention_bwd, flash_attention_fwd_drop,
           flash_attention_bwd_drop, fused_mlp_fwd, fused_mlp_fwd_drop,
           w8a8_matmul, w8a8_mlp_fwd, w8a8_mlp_fwd_drop, flash_attention_fwd_long,
           fused_encoder_block, w8a8_matmul_partial, w8a8_mlp_fwd_split,
           w8a8_mlp_fwd_drop_split)
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
# The comparisons with the CPU (phases 8, 12, 15, 19, 21, 23, 24, 25) run
# at half depth, fusion layer 3 of 6: every attention and FFN call has the
# shapes of the full-depth step, and the CPU's step and both trainers'
# builds take half the time (it keeps the whole script near 600 s). The
# named parameters of the last block (11) are the shallower model's (5).
CHECK_DEPTH = ["model.depth=6", "model.fusion_layer=3"]


def at_check_depth(names) -> tuple:
    return tuple(n.replace("transformer.blocks.11.", "transformer.blocks.5.") for n in names)


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
ALTERNATED_PAIRS = 6  # recipe and plain pretrain_mum steps in turn
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
# the last four phases (phase 24) at their defaults, as DOWNSTREAM, by
# objective (finetune_vis is `imgcls`, apart from phase 21's pretrain_vis);
# finetune_inpainting with its recipe's region masks. Each: trained
# parameters (must move; the CPU comparison holds their gradients) and
# frozen ones (must stay)
REST_OVERRIDES = {
    "caption": DOWNSTREAM + ["train=finetune_caption"],
    "imgcls": DOWNSTREAM + ["train=finetune_vis"],
    "ref": DOWNSTREAM + ["train=finetune_ref"],
    "inpainting": DOWNSTREAM + ["train=finetune_inpainting", "data.mask_style=region"],
}
REST_CHECKED = {
    "caption": ("transformer.txt_embeddings.word_embeddings.weight",
                "transformer.blocks.0.attn.qkv.weight", "transformer.blocks.0.mlp_l.fc1.weight",
                "transformer.blocks.11.attn.qkv.weight", "mlm_head.transform_dense.weight"),
    "imgcls": ("transformer.patch_embed.weight", "transformer.blocks.0.attn.qkv.weight",
            "transformer.blocks.11.mlp_vl.fc1.weight", "transformer.pooler.dense.weight",
            "img_classifier.fc.weight"),
    "ref": ("transformer.patch_embed.weight", "transformer.blocks.0.attn.qkv.weight",
            "transformer.blocks.11.mlp_vl.fc1.weight", "transformer.pooler.dense.weight",
            "ref_head.fc1.weight", "ref_head.fc2.weight"),
    "inpainting": ("transformer.patch_embed.weight", "transformer.img_mask_token",
                   "transformer.blocks.0.attn.qkv.weight",
                   "transformer.blocks.11.mlp_vl.fc1.weight", "mim_head.fc.weight"),
}
# C9: finetune_caption's [mlm] freezes the image side, the mask token, the
# fused experts and the pooler (as JAX's phase_frozen_predicate), though its
# MLM runs the fused stream on image-text pairs
REST_FROZEN = {
    "caption": ("transformer.patch_embed.weight", "transformer.pos_embed",
                "transformer.img_cls_token", "transformer.img_mask_token",
                "transformer.blocks.0.mlp_v.fc1.weight", "transformer.blocks.11.mlp_vl.fc1.weight",
                "transformer.pooler.dense.weight"),
    "imgcls": ("transformer.img_mask_token",),
    "ref": ("transformer.img_mask_token",),
    "inpainting": ("transformer.pooler.dense.weight",),
}
MPP_OVERRIDES = DOWNSTREAM + ["train=pretrain_mum", "train.loss_names=[mpp]"]
SUBMIT_SAMPLES = 64

# phase 25: real data. Seeded shards in a temporary directory: DATA_IMAGES
# JPEGs at COCO's size and quality (a smooth random field plus noise, so
# decoding costs what a photograph's does), five captions each from
# DATA_SENTENCES; coco's train and val tables, vg, vqav2_train with answers
# and question ids, and a save_to_disk text corpus of DATA_TEXTS texts
DATA_IMAGES, DATA_W, DATA_H, DATA_QUALITY = 320, 640, 480, 90
DATA_CAPTIONS = 5
DATA_TEXTS = 4000
DATA_SENTENCES = (
    "a man riding a wave on top of a surfboard in the ocean",
    "two dogs are playing with a red frisbee in a grassy park near some tall trees",
    "a red double decker bus parked beside the road in front of an old building",
    "a plate of food with broccoli rice and grilled chicken on a wooden table",
    "people walking down a busy city street while it is raining",
    "a cat sleeping on the keyboard of an open laptop computer",
    "a passenger train passing through a small station in the countryside at sunset",
    "a young woman holding an umbrella while waiting for the bus",
    "several zebras grazing in a dry field with mountains in the background",
    "a kitchen with white cabinets a stainless steel refrigerator and a small window",
    "a little boy swinging a baseball bat at a ball during a game",
    "an airplane flying high above the clouds on a clear blue day",
    "a bowl of fresh fruit including bananas apples and oranges sits on the counter",
    "a skier going down a snowy slope next to a line of pine trees",
    "a group of people sitting around a table sharing a large pizza",
    "a giraffe standing next to a tree and eating leaves from its branches",
    "a bathroom with a white sink a mirror and a shower curtain",
    "an elephant walking along a dirt road with a person riding on its back",
    "a street sign at the corner of two roads under a cloudy sky",
    "a brown teddy bear sitting on a bed covered with a striped blanket",
)
DATA_QUESTIONS = ("what color is the bus", "how many people are in the picture",
                  "is it raining", "what is the man holding", "what animal is this",
                  "is there a dog in the image", "what room is this", "what sport is played")
DATA_WORKERS = (1, 8, 16)
LOADER_BATCHES = 4  # batches timed per loader setting, after the first
DATA_ROUNDS = 2  # rounds of TRAIN_STEPS loader-fed then TRAIN_STEPS pre-collated steps
# caption serving: [CLS] [MASK] x 16 [SEP] [PAD]... at 8 refinements
CAPTION_TOKENS, CAPTION_ITERS, MASK_ID = 16, 8, 103
# inpainting: one region of up to INPAINT_REGION patches a row; at the
# masked patches the card's and the CPU's merged codes (MIM argmaxes) must
# agree at least this often (bf16 near-ties may flip), elsewhere they are the
# dVAE's own codes
INPAINT_REGION, INPAINT_AGREEMENT, INPAINT_PIXEL_ATOL = 75, 0.9, 1e-5
DISCRETE_VAE_BATCH, DISCRETE_VAE_LOSS_RTOL = 4, 1e-3


START = time.perf_counter()


def elapsed(label: str) -> None:
    """The script's wall seconds so far, after `label`."""
    print(f"elapsed: {label} {time.perf_counter() - START:.1f} s", flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def demangle(symbol: str) -> str:
    """A kernel's C++ name from its mangled symbol, through c++filt where the
    machine has it."""
    try:
        return subprocess.run(["c++filt", symbol], check=True, capture_output=True,
                              text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return symbol


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
    width up to SM90_BWD_MAX_N, the streamed kernel of rows 1, 3 and 5, each
    at both head dims; 6 and 7, 8 at every K it takes, 9 and 10 at every
    preset's width), all within the 232,448 bytes a block may use."""
    fwd_smem = _build.load("flash_attention_fwd_sm90", [ctypes.c_int] * 2,
                           "flash_attention_fwd_sm90_smem")
    stream_smem_fn = _build.load("flash_attention_long_sm90", [ctypes.c_int],
                                 "flash_attention_long_sm90_smem")
    bwd_smem = _build.load("flash_attention_bwd_sm90", [ctypes.c_int] * 3,
                           "flash_attention_bwd_sm90_smem")
    mlp_smem_fn = _build.load("w8a8_mlp_sm90", [ctypes.c_int] * 2, "w8a8_mlp_sm90_smem")
    matmul_smem_fn = _build.load("w8a8_matmul_sm90", [ctypes.c_int], "w8a8_matmul_sm90_smem")
    fused_smem_fn = _build.load("fused_mlp_sm90", [ctypes.c_int], "fused_mlp_sm90_smem")
    got = {}
    for d in HEAD_DIMS:
        got.update({f"flash_attention_fwd_sm90 nt={nt} d={d}":
                    (fwd_smem(nt, d), fwd_sm90_smem(nt, d)) for nt in range(16, 257, 16)})
        for r, role in enumerate(SM90_BWD_ROLES):
            got.update({f"flash_attention_bwd_sm90 {role} nt={nt} d={d}":
                        (bwd_smem(nt, r, d), bwd_sm90_layout(nt, role, d)["smem"])
                        for nt in range(16, SM90_BWD_MAX_N + 1, 16)})
        got[f"flash_attention_long_sm90 d={d}"] = (stream_smem_fn(d), stream_smem(d))
    got.update({f"w8a8_matmul_sm90 k={k}": (matmul_smem_fn(k), matmul_smem(k))
                for k in range(MATMUL_K_MIN, MATMUL_K_MAX + 1, 64)})
    for k in MLP_WIDTHS:
        got[f"w8a8_mlp_sm90 k={k}"] = (mlp_smem_fn(k, 0), mlp_smem(False, k))
        got[f"w8a8_mlp_sm90 drop k={k}"] = (mlp_smem_fn(k, 1), mlp_smem(True, k))
    got["fused_mlp_sm90"] = (fused_smem_fn(0), fused_sm90_smem(False))
    got["fused_mlp_sm90 drop"] = (fused_smem_fn(1), fused_sm90_smem(True))
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
                                                            CPU_CHECK_ROWS),
          state: dict | None = None):
    """`requests` VQA requests of `batch` rows through `Predictor.vqa_logits`
    on the card, seeded weights (seed 0, or the given `state`) and
    requests; every kernel's launches counted against `expected` (per
    request). With `e2e_atol`, the first `cpu_check` = (requests, rows) are
    compared with the CPU plain path. Returns the launches and the
    logits."""
    t0 = time.perf_counter()
    if state is None:
        state = build_model(cfg_dict, device="cpu", seed=0).state_dict()
    gpu = Predictor(cfg_dict, state, max_batch=batch, device="cuda")
    print(f"{tag}: {cfg_dict['model']['name']} weights (seed 0) ready in "
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


def check_dropout_mask(cfg: VlmoConfig, dev, batch: int, n: int | None = None,
                       row_index: torch.Tensor | None = None, heads: int | None = None,
                       heads_total: int | None = None, head0: int = 0) -> dict:
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
    that. With a `row_index` ((batch,) int32, each row's index in a global
    batch) the kernels and the plain mask key each head by it; the mask is
    then required to differ from the one each row's own index gives. With
    `heads` of each row's `heads_total` from `head0` on (a tensor rank's),
    the plain mask is required equal to the whole call's at those heads.
    The windows take half the head dim each: 31 wide at D = 64 (q's from
    dim 32), 15 at vlmo_debug's 32 (q's from dim 16)."""
    d = cfg.embed_dim // cfg.num_heads
    half = d // 2
    heads = heads or cfg.num_heads
    offset = {} if heads_total is None else {"heads_total": heads_total, "head0": head0}
    n = n or cfg.max_text_len + (cfg.img_size // cfg.patch_size) ** 2 + 1
    b, rate, scale, width = batch, cfg.attn_drop_rate, d ** -0.5, half - 1
    bh = b * heads
    seed = torch.tensor([DROP_SEED + 1], dtype=torch.int32, device=dev)
    keep = dropout_keep_mask_plain(seed, bh, n, rate, row_index, batch=b, **offset) != 0
    if offset:
        whole = dropout_keep_mask_plain(seed, b * heads_total, n, rate, row_index) != 0
        require(torch.equal(keep, whole.view(b, heads_total, n, n)[
            :, head0:head0 + heads].reshape(bh, n, n)),
            "dropout mask: a tensor rank's heads are not the whole call's")
    if row_index is not None:
        require(not torch.equal(keep, dropout_keep_mask_plain(seed, bh, n, rate) != 0),
                "dropout mask: the row index left every head's mask as it was")
    kb = torch.zeros((b, n), dtype=torch.float32, device=dev)
    ds_tol = 0.25 * scale / (n * (1.0 - rate))
    bits = 0
    for c in range(0, n, width):
        w = min(width, n - c)
        i = torch.arange(w, device=dev)
        q, k, v, do = (torch.zeros((bh, n, d), device=dev) for _ in range(4))
        q[:, c + i, half + i] = 1
        k[:, c + i, i] = 1
        v[:, :, 0] = 1
        v[:, c + i, 1 + i] = 1
        do[:, :, 0] = 1
        do[:, c + i, half + i] = 1
        q, k, v, do = (t.to(torch.bfloat16) for t in (q, k, v, do))
        out, _ = flash_attention_fwd_drop(q, k, v, kb, seed, scale, rate, row_index,
                                          **offset)
        o, lse = flash_attention_fwd_drop_plain(q, k, v, kb, seed, scale, rate, row_index,
                                                **offset)
        dq, dk, dv = flash_attention_bwd_drop(q, k, v, kb, seed, o, do, lse, scale, rate,
                                              row_index, **offset)
        pq, pk, _ = flash_attention_bwd_drop_plain(q, k, v, kb, seed, o, do, lse, scale, rate,
                                                   row_index, **offset)
        torch.cuda.synchronize()
        require(torch.equal(out[:, :, 1:1 + w] != 0, keep[:, :, c:c + w]),
                f"dropout forward: mask bits differ in key window {c}..{c + w}")
        require(torch.equal(dv[:, :, half:half + w] != 0, keep[:, c:c + w, :].transpose(1, 2)),
                f"dropout backward dv: mask bits differ in query window {c}..{c + w}")
        dq_err = (dq[:, :, :w].float() - pq[:, :, :w].float()).abs().max().item()
        dk_err = (dk[:, :, half:half + w].float() - pk[:, :, half:half + w].float()).abs().max().item()
        require(dq_err <= ds_tol and dk_err <= ds_tol,
                f"dropout backward dq/dk: max|err| {dq_err}, {dk_err} beyond {ds_tol} "
                f"in window {c}..{c + w}: a mask bit differs")
        bits += 4 * bh * n * w
    return {"shape": f"BH={bh} N={n}", "mask_bits_checked": bits, "kept_share":
            keep.float().mean().item(), "row_index": row_index is not None,
            **({"heads": f"{head0}..{head0 + heads - 1} of {heads_total}"} if offset else {})}


def cpu_check_phase(overrides: list[str] = TRAIN_OVERRIDES,
                    tag: str = "train_cpu_check", depth: list[str] = CHECK_DEPTH,
                    names=at_check_depth(CHECKED_PARAMS)) -> dict:
    """One pretrain_mum step at batch CPU_TRAIN_BATCH on the card and on the
    CPU's plain path: same seeded weights, batch (the CPU trainer's first),
    attention-dropout seeds, ITM negatives and MIM labels (the CPU dVAE's),
    hidden dropout and DropPath off; at `depth` (CHECK_DEPTH, or [] for the
    preset's own), the `names` gradients held."""
    cfg_dict = load_config(overrides + depth + [
        f"data.batch_size={CPU_TRAIN_BATCH}", "model.drop_rate=0.0",
        "model.drop_path_rate=0.0"])
    gpu, cpu = Trainer(cfg_dict, device="cuda"), Trainer(cfg_dict, device="cpu")
    batch = cpu.next_batch()
    labels = cpu.model_batch(batch)["mim_labels"]
    gpu_labels = gpu.model_batch(batch)["mim_labels"].cpu()
    b = CPU_TRAIN_BATCH
    negatives = (torch.arange(1, b + 1) % b, torch.arange(b - 1, 2 * b - 1) % b)
    agreement = (gpu_labels == labels).float().mean().item()
    print(f"{tag}: dvae_token_agreement {agreement}", flush=True)
    result = compare_step(tag, gpu, cpu, batch, names, negatives=negatives, mim_labels=labels)
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


def timed_phase(tag: str, cfg_dict: dict, checked, expected: dict, unmoved=(),
                trainer: Trainer | None = None) -> dict:
    """A training step at vlmo_base, batch 32 (or the config's model and
    batch): one warm-up step, then TRAIN_STEPS steps timed one by one, each
    with a synchronise around it, every kernel's launches counted against
    `expected` (per step), the `checked` parameters required to move and
    the `unmoved` ones (fixed or frozen by the phase) required to stay; on
    a new trainer of `cfg_dict`, or the given one."""
    t0 = time.perf_counter()
    if trainer is None:
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
    cfg_dict = load_config(overrides + CHECK_DEPTH + [
        f"data.batch_size={CPU_TRAIN_BATCH}", "model.drop_rate=0.0",
        "model.drop_path_rate=0.0"])
    gpu, cpu = Trainer(cfg_dict, device="cuda"), Trainer(cfg_dict, device="cpu")
    result = compare_step(tag, gpu, cpu, cpu.next_batch(), at_check_depth(CHECKED_VQA_PARAMS))
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
    cfg_dict = load_config(TXT_OVERRIDES + CHECK_DEPTH + [
        f"data.batch_size={CPU_TRAIN_BATCH}", "model.drop_rate=0.0",
        "model.drop_path_rate=0.0"])
    gpu, cpu = Trainer(cfg_dict, device="cuda"), Trainer(cfg_dict, device="cpu")
    compare_step("txt_cpu_check", gpu, cpu, cpu.next_batch(),
                 at_check_depth(COMPARED_TXT_PARAMS))
    del gpu, cpu
    torch.cuda.empty_cache()
    return launches


def _loop_counts(launches: dict, calls: int, steps: int, eval_batches: int, tag: str):
    """Rows 7, 3 and 4 on every FFN and attention call of the steps, row 6
    on every FFN call of the `eval_batches` deterministic batches (the
    evaluations and the test-split submission), rows 1 and 2 never
    (attention there takes the plain chain under attn_impl=auto)."""
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
        # two evaluations of the val split, then the submission of the test
        # split, each `batches` batches
        _loop_counts(launches1, calls, 2 * batches, 3 * batches, "train_loop run 1")
        require(os.path.isfile(result1["submission"] or ""),
                f"train_loop run 1: no submission ({result1['submission']})")
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
        _loop_counts(launches2, calls, batches, 2 * batches, "train_loop run 2")
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
    cfg_dict = load_config(overrides + CHECK_DEPTH + [
        f"data.batch_size={CPU_TRAIN_BATCH}", "model.drop_rate=0.0",
        "model.drop_path_rate=0.0"])
    gpu, cpu = Trainer(cfg_dict, device="cuda"), Trainer(cfg_dict, device="cpu")
    batch = cpu.next_batch()
    kw = {}
    if cpu.dvae is not None:
        kw["mim_labels"] = cpu.model_batch(batch)["mim_labels"]
    result = compare_step(tag, gpu, cpu, batch, at_check_depth(names), itc_grad_from_cpu,
                          at_check_depth(unheld), **kw)
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
    cfg_dict = load_config(MOMENTUM_OVERRIDES + CHECK_DEPTH + [
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
        "momentum_cpu_check", gpu, cpu, batch, at_check_depth(CHECKED_PARAMS),
        negatives=negatives,
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


def caption_launches(cfg: VlmoConfig, n_iter: int) -> int:
    """Attention calls and FFN calls of one `caption_ids` request: the image
    stream below the fusion layer once, then at each iteration the text
    stream below it and the fused rows above it."""
    return cfg.fusion_layer + n_iter * cfg.depth


def inpaint_launches(cfg: VlmoConfig) -> int:
    """Attention calls and FFN calls of one `inpaint_ids` request: one
    img-txt forward (the masked image and the caption below the fusion
    layer, the fused rows above it)."""
    return cfg.fusion_layer + cfg.depth


def caption_rows(batch: int, length: int, tokens: int = CAPTION_TOKENS):
    """`caption`'s rows: [CLS] [MASK] x tokens [SEP] [PAD]..., and their mask."""
    row = [101] + [MASK_ID] * tokens + [102] + [0] * (length - 2 - tokens)
    mask = np.zeros((batch, length), np.int32)
    mask[:, : tokens + 2] = 1
    return np.tile(np.asarray(row, np.int32), (batch, 1)), mask


def caption_teacher_forced(gpu: Predictor, cpu: Predictor, img: np.ndarray,
                           ids: np.ndarray, mask: np.ndarray, n_iter: int,
                           rows: int) -> dict:
    """`caption_ids`'s loop replayed on `gpu` (the card) with each
    iteration checked on `cpu` at the first `rows` rows: the CPU's MLM
    logits from the card's current ids (teacher forcing) against the
    card's, and the card's next ids against `mask_predict_step` on the CPU
    applied to the card's own logits (bit for bit). Returns the logit
    errors, whether each iteration's ids agreed, and the card's final ids."""
    errs, same = [], []
    with torch.inference_mode():
        dev = gpu.device
        t_img, t_ids, t_mask = (torch.from_numpy(a).to(dev) for a in (img, ids, mask))
        h_img = gpu.task.stream_below_fusion(img=normalize_image(t_img, gpu.task.config.dtype))
        c_img = normalize_image(torch.from_numpy(img[:rows]), cpu.task.config.dtype)
        h_img_cpu = cpu.task.stream_below_fusion(img=c_img)
        c_mask = torch.from_numpy(mask[:rows])
        gen = t_ids == MASK_ID
        n_gen = gen.sum(dim=1, dtype=torch.int32)
        cur = t_ids
        for it in range(n_iter):
            logits = gpu._caption_logits(h_img, cur, t_mask)
            nxt = mask_predict_step(logits, t_ids, gen, n_gen, it, n_iter, MASK_ID)
            head = logits[:rows].cpu()
            ref = cpu._caption_logits(h_img_cpu, cur[:rows].cpu(), c_mask)
            errs.append(float((head - ref).abs().max()))
            rule = mask_predict_step(head, t_ids[:rows].cpu(), gen[:rows].cpu(),
                                     n_gen[:rows].cpu(), it, n_iter, MASK_ID)
            same.append(bool(torch.equal(nxt[:rows].cpu(), rule)))
            cur = nxt
    return {"logit_err": errs, "rule_equal": same, "ids": cur.cpu().numpy()}


def caption_serve(card: str, cfg_dict: dict) -> dict:
    """`caption_ids` at batch 64 on the card, seeded weights (seed 0):
    N_REQUESTS requests (the first a warm-up) of CAPTION_TOKENS generated
    tokens at CAPTION_ITERS iterations, launches counted against
    `caption_launches`, the first request replayed by
    `caption_teacher_forced` against the CPU on CPU_CHECK_ROWS rows."""
    cfg = VlmoConfig.from_config(cfg_dict)
    state = build_model(cfg_dict, device="cpu", seed=0).state_dict()
    gpu = Predictor(cfg_dict, state, max_batch=BATCH, device="cuda")
    cpu = Predictor(cfg_dict, state, max_batch=BATCH, device="cpu")
    rng = np.random.default_rng(11)
    ids, mask = caption_rows(BATCH, cfg.max_text_len)
    imgs = [rng.integers(0, 256, (BATCH, cfg.img_size, cfg.img_size, 3), dtype=np.uint8)
            for _ in range(N_REQUESTS)]
    per_request = caption_launches(cfg, CAPTION_ITERS)
    for fn in KERNELS:
        fn.launches = 0
    latencies, outs = [], []
    for img in imgs:
        t = time.perf_counter()
        outs.append(gpu.caption_ids(img, ids, mask, CAPTION_ITERS, MASK_ID))
        latencies.append(time.perf_counter() - t)
    launches = {fn.__name__: fn.launches for fn in KERNELS}
    require_launches("serve_caption", launches, {
        "flash_attention_fwd": per_request, "fused_mlp_fwd": per_request,
        "flash_attention_fwd_drop": 0, "fused_mlp_fwd_drop": 0}, N_REQUESTS)
    gen = ids == MASK_ID
    require(all(o.shape == ids.shape and o.dtype == np.int32 and not (o == MASK_ID).any()
                and (o[~gen] == ids[~gen]).all() for o in outs),
            "serve_caption: bad ids (shape, dtype, an unfilled [MASK] or a moved token)")
    forced = caption_teacher_forced(gpu, cpu, imgs[0], ids, mask, CAPTION_ITERS,
                                    CPU_CHECK_ROWS)
    require(max(forced["logit_err"]) <= E2E_ATOL,
            f"serve_caption: MLM logits on the card vs the CPU (teacher-forced): "
            f"{forced['logit_err']} (tol {E2E_ATOL})")
    require(all(forced["rule_equal"]),
            f"serve_caption: the card's next ids differ from the keep/re-mask rule on "
            f"its own logits: {forced['rule_equal']}")
    med = statistics.median(latencies[1:])
    out = {"card": card, "batch": BATCH, "tokens": CAPTION_TOKENS,
           "iterations": CAPTION_ITERS, "first_request_ms": latencies[0] * 1e3,
           "latency_ms": [x * 1e3 for x in latencies[1:]], "median_latency_ms": med * 1e3,
           "rows_per_s": BATCH / med, "launches": launches,
           "expected_launches_per_request": per_request,
           "teacher_forced_logit_err": forced["logit_err"],
           "rule_equal": forced["rule_equal"],
           "replay_equals_request": bool(np.array_equal(forced["ids"], outs[0]))}
    print("serve_caption: " + json.dumps(out), flush=True)
    del gpu, cpu
    torch.cuda.empty_cache()
    return out


def inpaint_serve(card: str, cfg_dict: dict) -> dict:
    """`inpaint_ids` at batch 64 on the card with one region mask a row
    (the random dVAE with its decoder, seed 0, the task's weights seed 0):
    N_REQUESTS requests (the first a warm-up), launches counted against
    `inpaint_launches`, the first request's first CPU_CHECK_ROWS rows held
    to the CPU: the MIM logits within E2E_ATOL, the merged codes at the
    masked patches in INPAINT_AGREEMENT agreement, the pixels outside the
    mask within INPAINT_PIXEL_ATOL of the CPU's resized input and the codes
    outside it the card's dVAE encoder's own."""
    cfg = VlmoConfig.from_config(cfg_dict)
    grid = cfg.img_size // cfg.patch_size
    state = build_model(cfg_dict, device="cpu", seed=0).state_dict()
    gpu = Predictor(cfg_dict, state, max_batch=BATCH, device="cuda")
    cpu = Predictor(cfg_dict, state, max_batch=BATCH, device="cpu")
    region = RegionMaskingGenerator(grid, INPAINT_REGION)
    rng = np.random.default_rng(12)
    reqs = [(img, np.stack([region(rng).reshape(-1) for _ in range(BATCH)]), ids, mask)
            for img, ids, mask in make_requests(cfg, rng, N_REQUESTS, BATCH)]
    _ = gpu.dvae, cpu.dvae  # both tokenizers built outside the timing
    per_request = inpaint_launches(cfg)
    for fn in KERNELS:
        fn.launches = 0
    latencies, outs = [], []
    for img, pm, ids, mask in reqs:
        t = time.perf_counter()
        outs.append(gpu.inpaint_ids(img, pm, ids, mask))
        latencies.append(time.perf_counter() - t)
    launches = {fn.__name__: fn.launches for fn in KERNELS}
    require_launches("serve_inpaint", launches, {
        "flash_attention_fwd": per_request, "fused_mlp_fwd": per_request,
        "flash_attention_fwd_drop": 0, "fused_mlp_fwd_drop": 0}, N_REQUESTS)
    size = cfg.img_size // 2
    require(all(o.shape == (BATCH, size, size, 3) and np.isfinite(o).all()
                and o.min() >= 0 and o.max() <= 1 and c.shape == (BATCH, grid * grid)
                for o, c in outs), "serve_inpaint: bad images or codes")
    rows = CPU_CHECK_ROWS
    img, pm, ids, mask = (a[:rows] for a in reqs[0])
    got_img, got_codes = outs[0][0][:rows], outs[0][1][:rows]
    want_img, want_codes = cpu.inpaint_ids(img, pm, ids, mask)
    with torch.inference_mode():
        args = [torch.from_numpy(a) for a in (img, pm, ids, mask)]
        logits_cpu = cpu._inpaint_logits(*args)
        logits_gpu = gpu._inpaint_logits(*(a.cuda() for a in args)).cpu()
        small = F.interpolate((args[0].float() / 255.0).permute(0, 3, 1, 2),
                              size=(size, size), mode="bilinear", align_corners=False,
                              antialias=True).permute(0, 2, 3, 1)
        # the encoder on the request's whole batch, as the request ran it
        full = torch.from_numpy(reqs[0][0]).cuda()
        own_resized = gpu.dvae.get_codebook_indices(map_pixels(F.interpolate(
            (full.float() / 255.0).permute(0, 3, 1, 2), size=(size, size),
            mode="bilinear", align_corners=False, antialias=True).permute(0, 2, 3, 1)))[:rows]
        own = gpu.dvae.get_codebook_indices(map_pixels(
            torch.from_numpy(outs[0][0]).cuda()))[:rows].cpu().numpy()
    logit_err = float((logits_gpu - logits_cpu).abs().max())
    masked = pm > 0
    agree = float((got_codes[masked] == want_codes[masked]).mean())
    cell = size // grid
    pix = np.repeat(np.repeat(pm.reshape(rows, grid, grid), cell, 1), cell, 2) == 0
    pixel_err = float(np.abs(got_img[pix] - small.numpy()[pix]).max())
    own_equal = bool((got_codes[~masked] == own_resized.cpu().numpy()[~masked]).all())
    require(logit_err <= E2E_ATOL, f"serve_inpaint: MIM logits differ from the CPU by "
            f"{logit_err} (tol {E2E_ATOL})")
    require(agree >= INPAINT_AGREEMENT, f"serve_inpaint: merged codes at the masked patches "
            f"agree {agree} with the CPU's (limit {INPAINT_AGREEMENT})")
    require(pixel_err <= INPAINT_PIXEL_ATOL, f"serve_inpaint: pixels outside the mask "
            f"{pixel_err} from the CPU's resized input (tol {INPAINT_PIXEL_ATOL})")
    require(own_equal, "serve_inpaint: codes outside the mask are not the dVAE encoder's own")
    med = statistics.median(latencies[1:])
    out = {"card": card, "batch": BATCH, "first_request_ms": latencies[0] * 1e3,
           "latency_ms": [x * 1e3 for x in latencies[1:]], "median_latency_ms": med * 1e3,
           "rows_per_s": BATCH / med, "launches": launches,
           "expected_launches_per_request": per_request,
           "masked_patches_per_row": float(pm.sum(1).mean()),
           "cpu_check_mim_logit_err": logit_err, "masked_code_agreement": agree,
           "unmasked_pixel_err": pixel_err, "unmasked_codes_own": own_equal,
           "image_err_vs_cpu": float(np.abs(got_img - want_img).max()),
           "repainted_codes_reencoded_agreement": float((own == got_codes).mean())}
    print("serve_inpaint: " + json.dumps(out), flush=True)
    del gpu, cpu
    torch.cuda.empty_cache()
    return out


def discrete_vae_check(card: str) -> dict:
    """One forward and backward of `DiscreteVAE` at its defaults (image
    256, 3 layers, hidden 64, 8192 tokens) on DISCRETE_VAE_BATCH seeded
    images, on the card and on the CPU from the same seeded weights,
    without Gumbel noise: the reconstruction loss within
    DISCRETE_VAE_LOSS_RTOL, every gradient within GRAD_REL_TOL (relative
    L2); the card's forward and backward timed."""
    torch.manual_seed(0)
    cpu = DiscreteVAE()
    gpu = DiscreteVAE().cuda()
    gpu.load_state_dict(cpu.state_dict())
    img = torch.from_numpy(np.random.default_rng(13).random(
        (DISCRETE_VAE_BATCH, 256, 256, 3), np.float32))
    _, loss_cpu = cpu(img)
    loss_cpu.backward()
    img_gpu = img.cuda()
    _, loss_gpu = gpu(img_gpu)
    loss_gpu.backward()
    errs = {k: rel_l2(p.grad.cpu(), cpu.get_parameter(k).grad)
            for k, p in gpu.named_parameters()}

    def fwd_bwd():
        gpu.zero_grad()
        gpu(img_gpu)[1].backward()

    ms = time_ms(fwd_bwd, iters=5, warmup=1)
    lc, lg = float(loss_cpu), float(loss_gpu)
    out = {"card": card, "batch": DISCRETE_VAE_BATCH, "loss_gpu_cpu": (lg, lc),
           "loss_rel_err": abs(lg - lc) / abs(lc), "max_grad_rel_err": max(errs.values()),
           "grad_rel_err": errs, "fwd_bwd_ms": ms,
           "ids_equal": float((gpu.get_codebook_indices(img_gpu).cpu()
                               == cpu.get_codebook_indices(img)).float().mean())}
    print("discrete_vae: " + json.dumps(out), flush=True)
    require(out["loss_rel_err"] <= DISCRETE_VAE_LOSS_RTOL,
            f"discrete_vae: loss {lg} vs CPU {lc} beyond {DISCRETE_VAE_LOSS_RTOL}")
    require(out["max_grad_rel_err"] <= GRAD_REL_TOL,
            f"discrete_vae: gradients differ from the CPU's: {errs}")
    del gpu, cpu
    torch.cuda.empty_cache()
    return out


def submission_phase(card: str) -> dict:
    """Two finetune_vqa steps (VQA_OVERRIDES, SUBMIT_SAMPLES samples) and
    the test-split submission: `write_vqa_submission` writes
    `submit/vqa_submit_0.json` and the merged `vqa_submit.json`, read back
    as one answer (a string of the vocabulary) per test row, the
    question ids the samples'."""
    with tempfile.TemporaryDirectory() as root:
        cfg_dict = load_config(VQA_OVERRIDES + [f"data.synthetic_size={SUBMIT_SAMPLES}",
                                                f"output_dir={root}"])
        trainer = Trainer(cfg_dict, device="cuda")
        calls = img_txt_calls(trainer.config)
        run_counted(trainer, EXTRA_STEPS)
        for fn in KERNELS:
            fn.launches = 0
        t = time.perf_counter()
        path = write_vqa_submission(trainer)
        secs = time.perf_counter() - t
        launches = {fn.__name__: fn.launches for fn in KERNELS}
        rows = json.load(open(path))
        part = json.load(open(os.path.join(root, "submit", "vqa_submit_0.json")))
    answers = set(load_vqa_vocab()["id2answer"].values())
    batches = -(-SUBMIT_SAMPLES // VQA_BATCH)
    require(path.endswith("vqa_submit.json") and rows == part
            and len(rows) == batches * VQA_BATCH
            and all(set(r) == {"question_id", "answer"} and r["answer"] in answers
                    and isinstance(r["question_id"], int) for r in rows)
            and sorted({r["question_id"] for r in rows}) == list(range(SUBMIT_SAMPLES)),
            f"vqa_submission: malformed submission of {len(rows)} rows")
    # the eval forward is deterministic: the plain attention chain under
    # attn_impl=auto, row 6 on every FFN call
    require_launches("vqa_submission", launches, {
        "fused_mlp_fwd": calls, "flash_attention_fwd_drop": 0, "flash_attention_fwd": 0},
        batches)
    out = {"card": card, "rows": len(rows), "seconds": secs, "launches": launches,
           "sample": rows[:2]}
    del trainer
    torch.cuda.empty_cache()
    print("vqa_submission: " + json.dumps(out), flush=True)
    return out


def finetune_rest_phase(card: str) -> dict:
    """Phase 24: finetune_caption, finetune_vis, finetune_ref and
    finetune_inpainting at vlmo_base, batch 32 (each timed with its
    launches, moved and frozen parameters, then against the CPU), the MPP
    objective and the VQA submission (short), then caption and inpaint
    serving and the DiscreteVAE check."""
    out = {}
    for name, overrides in REST_OVERRIDES.items():
        cfg_dict = load_config(overrides)
        cfg = VlmoConfig.from_config(cfg_dict)
        require(cfg.attn_impl == "auto" and cfg.attn_drop_rate > 0 and cfg.mlp_impl == "xla"
                and cfg_dict["data"]["batch_size"] == TRAIN_BATCH,
                f"{name}: the phase must run its defaults at batch 32")
        calls = img_txt_calls(cfg)  # one img-txt forward: f + d = 18
        out[name] = timed_phase(f"{name}_train", cfg_dict, REST_CHECKED[name], {
            "flash_attention_fwd_drop": calls, "flash_attention_bwd_drop": calls,
            "flash_attention_fwd": 0, "flash_attention_bwd": 0, "fused_mlp_fwd": 0,
            "fused_mlp_fwd_drop": 0}, unmoved=REST_FROZEN[name])
        downstream_cpu_check(f"{name}_cpu_check", overrides, REST_CHECKED[name])
    mpp = VlmoConfig.from_config(load_config(MPP_OVERRIDES))
    _, steps, _ = short_phase("mpp_train", load_config(MPP_OVERRIDES), {
        "flash_attention_fwd_drop": img_txt_calls(mpp),
        "flash_attention_bwd_drop": img_txt_calls(mpp)})
    require(all(np.isfinite(m.get("mpp_task_loss", np.nan)) and m["mpp_task_loss"] > 0
                for m in steps), f"mpp_train: no finite positive MPP loss in {steps}")
    out["submission"] = submission_phase(card)
    out["caption"] = caption_serve(card, load_config(ENDPOINT_OVERRIDES
                                                     + ["train=finetune_caption"]))
    out["inpaint"] = inpaint_serve(card, load_config(ENDPOINT_OVERRIDES
                                                     + ["train=finetune_inpainting"]))
    out["discrete_vae"] = discrete_vae_check(card)
    return out


def finetune_rest_only(card: str) -> int:
    """The build, then phase 24 alone (`--finetune-rest`)."""
    finetune_rest_phase(card)
    return 0


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

# ---------------------------------------------------------------- phase 25


def data_packages() -> dict:
    """What the data layer needs on this machine: pyarrow, PIL (and HF
    `datasets`, which the port does not use), `jpeglib.h` and libjpeg, and
    whether the native loader builds from `native/emmloader.cc`."""
    out: dict = {}
    for mod in ("pyarrow", "PIL", "datasets"):
        try:
            out[mod] = getattr(importlib.import_module(mod), "__version__", "?")
        except ImportError as e:
            out[mod] = f"missing ({e})"
    dirs = ["/usr/include", "/usr/local/include",
            *os.environ.get("CPATH", "").split(os.pathsep)]
    out["jpeglib.h"] = next((os.path.join(d, "jpeglib.h") for d in dirs
                             if d and os.path.exists(os.path.join(d, "jpeglib.h"))), None)
    out["libjpeg"] = ctypes.util.find_library("jpeg")
    try:
        native.require()
        out["native_loader"] = "built"
    except RuntimeError as e:
        lines = str(e).splitlines()
        out["native_loader"] = next((x.strip() for x in lines if "error" in x), lines[0])
    return out


def write_shards(root: str, rng: np.random.Generator) -> dict:
    """The phase's tables under `root` (see DATA_IMAGES); returns their
    sizes."""
    import pyarrow as pa
    from PIL import Image

    def write(name: str, table, stream: bool = False):
        path = os.path.join(root, name)
        with pa.OSFile(path, "wb") as sink:
            with (pa.ipc.new_stream if stream else pa.ipc.new_file)(sink, table.schema) as w:
                w.write_table(table)

    def jpeg(seed: int) -> bytes:
        r = np.random.default_rng(seed)
        coarse = r.integers(0, 256, (DATA_H // 32 + 1, DATA_W // 32 + 1, 3), dtype=np.uint8)
        field = np.asarray(Image.fromarray(coarse).resize((DATA_W, DATA_H), Image.BICUBIC),
                           np.float32)
        noise = r.standard_normal(field.shape, dtype=np.float32) * 8
        buf = io.BytesIO()
        Image.fromarray(np.clip(field + noise, 0, 255).astype(np.uint8)).save(
            buf, format="JPEG", quality=DATA_QUALITY)
        return buf.getvalue()

    with ThreadPoolExecutor(8) as pool:
        images = list(pool.map(jpeg, rng.integers(0, 2 ** 63, DATA_IMAGES)))
    caps = [[DATA_SENTENCES[j] for j in rng.integers(0, len(DATA_SENTENCES), DATA_CAPTIONS)]
            for _ in range(DATA_IMAGES)]
    train, vg, val = slice(0, 192), slice(192, 256), slice(256, 288)
    for name, sl in (("coco_caption_karpathy_train", train), ("vg", vg),
                     ("coco_caption_karpathy_val", val)):
        write(f"{name}.arrow", pa.table({"image": images[sl], "caption": caps[sl]}))
    n_q = rng.integers(1, 3, DATA_IMAGES)
    write("vqav2_train.arrow", pa.table({
        "image": images,
        "questions": [[DATA_QUESTIONS[j] for j in rng.integers(0, len(DATA_QUESTIONS), n)]
                      for n in n_q],
        "answers": [[["yes"]] * n for n in n_q],
        "answer_labels": [[list(map(int, rng.integers(0, 3129, 3))) for _ in range(n)]
                          for n in n_q],
        "answer_scores": [[[1.0, 0.6, 0.3]] * n for n in n_q],
        "question_id": [[1000 * i + k for k in range(n)] for i, n in enumerate(n_q)],
    }))
    corpus = os.path.join(root, "bookcorpus")
    os.makedirs(os.path.join(corpus, "train"))
    texts = [" ".join(DATA_SENTENCES[j] for j in rng.integers(0, len(DATA_SENTENCES), k)) + "."
             for k in rng.integers(1, 4, DATA_TEXTS)]
    write("bookcorpus/train/data-00000-of-00001.arrow", pa.table({"text": texts}), stream=True)
    with open(os.path.join(corpus, "train", "state.json"), "w") as f:
        json.dump({"_data_files": [{"filename": "data-00000-of-00001.arrow"}]}, f)
    with open(os.path.join(corpus, "dataset_dict.json"), "w") as f:
        json.dump({"splits": ["train"]}, f)
    return {"images": DATA_IMAGES, "jpeg_mean_kb": sum(map(len, images)) / len(images) / 1e3,
            "coco_train_rows": 192, "vg_rows": 64, "coco_val_rows": 32,
            "vqa_questions": int(n_q.sum()), "corpus_texts": DATA_TEXTS}


def data_overrides(root: str, phase: str, *extra: str) -> list[str]:
    return ["model=vlmo_base", f"train={phase}", "compute_dtype=bfloat16",
            f"data.data_root={root}", f"data.batch_size={TRAIN_BATCH}", *extra]


def loader_rate(cfg_dict: dict, workers: int) -> dict:
    """Images per second of the train loader alone at `workers` threads:
    LOADER_BATCHES batches after the first (which starts the producer)."""
    cfg = {**cfg_dict, "data": {**cfg_dict["data"], "num_workers": workers}}
    batches = MultiTaskData(cfg).train_loader().epoch(0)
    next(batches)
    t0 = time.perf_counter()
    n = sum(len(next(batches)["text_ids"]) for _ in range(LOADER_BATCHES))
    secs = time.perf_counter() - t0
    batches.close()
    return {"workers": workers, "images": n, "seconds": secs, "images_per_s": n / secs}


def same_batches(cfg_dict: dict) -> None:
    """Two loaders of one config at 8 threads, same seed and epoch: the same
    first two batches, array for array."""
    cfg = {**cfg_dict, "data": {**cfg_dict["data"], "num_workers": 8}}
    a, b = (MultiTaskData(cfg).train_loader().epoch(1) for _ in range(2))
    for _ in range(2):
        x, y = next(a), next(b)
        require(x.keys() == y.keys() and all(
            np.array_equal(x[k], y[k]) if isinstance(x[k], np.ndarray) else x[k] == y[k]
            for k in x), "two loaders with one seed and epoch gave different batches")
    a.close()
    b.close()


def tokenizer_costs(root: str) -> dict:
    """Host microseconds (one thread, warm word cache) of the tokenizer and
    the whole-word collator per 40-token caption and per 512-token packed
    sample, and of a whole packed sample of the corpus."""
    tok, col = get_tokenizer(), MlmCollator(get_tokenizer())
    caps = [DATA_SENTENCES[i % len(DATA_SENTENCES)] for i in range(2000)]

    def per_call_us(fn, items):
        fn(items[0])
        t0 = time.perf_counter()
        for x in items:
            fn(x)
        return (time.perf_counter() - t0) / len(items) * 1e6

    ids40 = [encode_texts(tok, [c], 40)[0] for c in caps[:500]]
    corpus = TextCorpusDataset(os.path.join(root, "bookcorpus"), tokenizer=tok,
                               max_text_len=TXT_LEN, mlm_collator=col)
    packed = [" ".join(caps[i: i + 45]) for i in range(0, 1800, 45)]
    ids512 = [encode_texts(tok, [p], TXT_LEN)[0] for p in packed]
    out = {
        "caption_encode_us": per_call_us(lambda c: encode_texts(tok, [c], 40), caps),
        "caption_collate_us": per_call_us(lambda x: col(x, seed=7), ids40),
        "packed_encode_us": per_call_us(lambda p: encode_texts(tok, [p], TXT_LEN), packed),
        "packed_collate_us": per_call_us(lambda x: col(x, seed=7), ids512),
        "packed_sample_us": per_call_us(corpus.__getitem__, list(range(64))),
        "packed_tokens": int(ids512[0].astype(bool).sum()),
    }
    print("data_tokenizer: " + json.dumps(out), flush=True)
    return out


def timed_host(fn, store: list):
    def wrapped(*args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        store.append((time.perf_counter() - t0) * 1e3)
        return out
    return wrapped


def loader_step_phase(card: str, cfg_dict: dict, tag: str = "data_train") -> dict:
    """pretrain_mum at vlmo_base, batch 32, from the shards: a warm-up step,
    then DATA_ROUNDS rounds of TRAIN_STEPS steps fed by the loader (its 8
    threads working beside the step) and TRAIN_STEPS on batches collated
    before with the loader stopped, each step synchronised; rows 3 and 4 counted on the fed steps;
    the host ms of the loader's wait and of `model_batch` (`step/batch`:
    the H2D copy, preprocessing, the dVAE's labels)."""
    t0 = time.perf_counter()
    trainer = Trainer(cfg_dict, device="cuda")
    print(f"{tag}: Trainer ready in {time.perf_counter() - t0:.1f} s", flush=True)
    waits, prep = [], []
    trainer.next_batch = timed_host(trainer.next_batch, waits)
    trainer.model_batch = timed_host(trainer.model_batch, prep)
    params = dict(trainer.task.named_parameters())
    before = {k: params[k].detach().clone() for k in CHECKED_PARAMS}
    trainer.step()
    per_step = attention_calls_per_step(trainer.config)
    fed, pre, fed_wait, fed_prep, pre_prep, launches = [], [], [], [], [], {}
    for _ in range(DATA_ROUNDS):
        waits.clear()
        prep.clear()
        metrics, times, counted = run_counted(trainer, TRAIN_STEPS, timed=True)
        require_launches(tag, counted, {"flash_attention_fwd_drop": per_step,
                                                 "flash_attention_bwd_drop": per_step},
                         TRAIN_STEPS)
        launches = {k: launches.get(k, 0) + v for k, v in counted.items()}
        fed += times
        fed_wait += waits
        fed_prep += prep
        batches = [trainer.next_batch() for _ in range(TRAIN_STEPS)]
        trainer._batches.close()  # no loader thread runs beside these steps
        trainer._batches = None
        prep.clear()
        for b in batches:
            torch.cuda.synchronize()
            t = time.perf_counter()
            trainer.step(b)
            torch.cuda.synchronize()
            pre.append(time.perf_counter() - t)
        pre_prep += prep
    moved = {k: (params[k].detach() - before[k]).abs().max().item() for k in CHECKED_PARAMS}
    require(all(x > 0 for x in moved.values()), f"{tag}: parameters did not change: {moved}")
    result = {
        "card": card, "batch": TRAIN_BATCH, "rounds": DATA_ROUNDS, "steps": TRAIN_STEPS,
        "fed_ms": [x * 1e3 for x in fed], "precollated_ms": [x * 1e3 for x in pre],
        "fed_median_ms": statistics.median(fed) * 1e3,
        "precollated_median_ms": statistics.median(pre) * 1e3,
        "fed_loader_wait_ms": fed_wait, "fed_step_batch_ms": fed_prep,
        "precollated_step_batch_ms": pre_prep,
        "fed_losses": [{k: v for k, v in m.items() if k.endswith("_task_loss")}
                       for m in metrics],
        "launches": launches, "expected_launches_per_step": per_step,
    }
    print(f"{tag}: " + json.dumps(result), flush=True)
    del trainer
    torch.cuda.empty_cache()
    return result


def data_serve(card: str, root: str) -> dict:
    """`Predictor.vqa` on 64 PIL images (the shards' 640x480 JPEGs) and their
    questions as strings, against `vqa_logits` on the same rows
    (`preprocess_images` and `tokenize` done before): N_REQUESTS requests
    each, the first a warm-up; rows 1 and 6 on every attention and FFN
    call; the answers equal."""
    import pyarrow as pa
    from PIL import Image

    cfg_dict = load_config(SERVE_OVERRIDES)
    cfg = VlmoConfig.from_config(cfg_dict)
    state = build_model(cfg_dict, device="cpu", seed=0).state_dict()
    pred = Predictor(cfg_dict, state, max_batch=BATCH, device="cuda")
    with pa.memory_map(os.path.join(root, "vqav2_train.arrow")) as src:
        table = pa.ipc.open_file(src).read_all()
    raw = table["image"].to_pylist()[:BATCH]
    questions = [q[0] for q in table["questions"].to_pylist()[:BATCH]]
    images = [Image.open(io.BytesIO(b)) for b in raw]
    calls = img_txt_calls(cfg)
    expected = {"flash_attention_fwd": calls, "fused_mlp_fwd": calls}

    def run(fn):
        for f in KERNELS:
            f.launches = 0
        times, outs = [], []
        for _ in range(N_REQUESTS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            outs.append(fn())
            times.append(time.perf_counter() - t)
        launches = {f.__name__: f.launches for f in KERNELS}
        require_launches("data_serve", launches, expected, N_REQUESTS)
        return times[1:], outs[-1], launches

    t0 = time.perf_counter()
    u8 = pred.preprocess_images(images)
    prep_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ids, mask = pred.tokenize(questions)
    tok_ms = (time.perf_counter() - t0) * 1e3
    str_times, answers, launches = run(lambda: pred.vqa(images, questions))
    id_times, logits, _ = run(lambda: pred.vqa_logits(u8, ids, mask))
    require(answers == pred.answers(logits),
            "data_serve: vqa on PIL images and strings answers otherwise than vqa_logits")
    result = {
        "card": card, "batch": BATCH, "requests": N_REQUESTS - 1,
        "vqa_strings_pil_ms": [x * 1e3 for x in str_times],
        "vqa_strings_pil_median_ms": statistics.median(str_times) * 1e3,
        "vqa_logits_ms": [x * 1e3 for x in id_times],
        "vqa_logits_median_ms": statistics.median(id_times) * 1e3,
        "preprocess_images_ms": prep_ms, "tokenize_ms": tok_ms,
        "launches": launches, "sample_answers": answers[:4],
    }
    print("data_serve: " + json.dumps(result), flush=True)
    return result


def data_phase(card: str) -> dict:
    """Phase 25: the data layer on this machine. The parts whose packages
    are missing are left out, each named with its reason on a line of its
    own; every part that runs raises on its own failure."""
    pkgs = data_packages()
    print("data_packages: " + json.dumps(pkgs), flush=True)
    have = {m: not str(pkgs[m]).startswith("missing") for m in ("pyarrow", "PIL")}
    out: dict = {"packages": pkgs}
    if not all(have.values()):
        missing = [m for m, ok in have.items() if not ok]
        print(f"data: left out: the shards, the arrow loaders, the training paths and "
              f"serving on PIL images (missing {missing})", flush=True)
        return data_phase_synthetic(card, out)
    root = tempfile.mkdtemp(prefix="chip_smoke_shards_")
    try:
        t0 = time.perf_counter()
        out["shards"] = write_shards(root, np.random.default_rng(25))
        print(f"data_shards: {json.dumps(out['shards'])} written in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        out["tokenizer"] = tokenizer_costs(root)
        mum = load_config(data_overrides(root, "pretrain_mum", "train.discrete_vae_type=random"))
        rates = [loader_rate(mum, w) for w in DATA_WORKERS]
        if pkgs["native_loader"] == "built":
            native_cfg = {**mum, "data": {**mum["data"], "native_loader": True}}
            rates += [{"route": "native", **loader_rate(native_cfg, w)} for w in DATA_WORKERS]
        else:
            print(f"data: left out: the native route (jpeglib.h {pkgs['jpeglib.h']}, libjpeg "
                  f"{pkgs['libjpeg']}: {pkgs['native_loader']})", flush=True)
        out["loader"] = rates
        print("data_loader: " + json.dumps({"card": card, "pil": rates}), flush=True)
        same_batches(mum)
        out["train"] = loader_step_phase(card, mum)
        # the same comparison on the synthetic samples (numpy draws on the
        # loader's threads)
        out["train_synthetic"] = loader_step_phase(card, load_config(TRAIN_OVERRIDES),
                                                   "data_train_synthetic")
        vqa = load_config(data_overrides(root, "finetune_vqa", "model.mlp_impl=fused"))
        calls = img_txt_calls(VlmoConfig.from_config(vqa))
        out["vqa_launches"] = timed_phase("vqa_arrow_train", vqa, CHECKED_VQA_PARAMS, {
            "fused_mlp_fwd_drop": calls, "flash_attention_fwd_drop": calls,
            "flash_attention_bwd_drop": calls})
        txt = load_config(data_overrides(root, "pretrain_txt", f"model.max_text_len={TXT_LEN}"))
        depth = VlmoConfig.from_config(txt).depth
        out["txt_launches"] = timed_phase("txt_arrow_train", txt, CHECKED_TXT_PARAMS, {
            "flash_attention_fwd_drop": depth, "flash_attention_bwd_drop": depth},
            unmoved=FIXED_TXT_PARAMS)
        cpu_check_phase(data_overrides(root, "pretrain_mum", "train.discrete_vae_type=random"),
                        tag="data_cpu_check")
        out["serve"] = data_serve(card, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def data_phase_synthetic(card: str, out: dict) -> dict:
    """The parts that need neither pyarrow nor PIL: the tokenizer and the
    collator on the fixed sentences, the block masks and `ShardedLoader`
    over the synthetic samples (two loaders, one seed: equal batches)."""
    tok, col = get_tokenizer(), MlmCollator(get_tokenizer())
    ids, _ = encode_texts(tok, list(DATA_SENTENCES), 40)
    col(ids, seed=1)
    cfg = load_config(TRAIN_OVERRIDES)
    same_batches(cfg)
    out["loader"] = [loader_rate(cfg, w) for w in DATA_WORKERS]
    print("data_loader: " + json.dumps({"card": card, "synthetic": out["loader"]}), flush=True)
    return out


def data_only(card: str) -> int:
    """The build, then phase 25 alone (`--data`)."""
    data_phase(card)
    return 0


# ---- phase 26: training and serving on more than one process

# the presets of phase 26 at one rank of a real process group: (tag, overrides)
PARALLEL_RUNS = (("dp", ["parallel=dp"]), ("zero1", ["parallel=zero1"]),
                 ("fsdp", ["parallel=fsdp"]), ("fsdp_offload", ["parallel=fsdp_offload"]),
                 ("dp_dots", ["parallel=dp", "parallel.remat=dots"]))
PARALLEL_STEPS = 3  # timed, after the first (whose losses every preset must share)
TWO_RANKS = 2  # the two-rank run: 2 x TRAIN_BATCH // 2 rows against 1 x TRAIN_BATCH
PROBE_TIMEOUT_S = 90
# the two-rank comparison's gradients (the phase 8 set, at full depth)
TWO_RANK_PARAMS = tuple(k for k in CHECKED_PARAMS if k != "itc_temp") + ("itm_head.fc.weight",)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def row_index_of(rank: int, world: int, rows: int, runs: int, dev) -> torch.Tensor:
    """Rank `rank`'s global rows of an attention call of `rows` rows in
    `runs` runs (`StepRng.row_index`)."""
    from exploremultimodal_torch.ops.stochastic import StepRng

    rng = StepRng(torch.Generator(), torch.Generator(), torch.device("cpu"), rank=rank,
                  world=world)
    with rng.runs(runs):
        return rng.row_index(rows, dev)


def check_row_index(cfg: VlmoConfig, dev) -> list[dict]:
    """Rows 3 and 4 with a non-identity row index (rank 1 of 2: its rows
    of the global batch) at the pretrain_mum step's shapes: the streams'
    32 rows (one run: rows 32..63) at N = 40, 197, 237, and ITM's 96 pair
    rows in its three runs (64 k + 32 + j), against their plain versions on
    the same inputs and index, within the existing bf16 limits; the mask bit
    for bit at ITM's shape (`check_dropout_mask`); and the kernels timed
    at each shape with the index and without it, in turns."""
    heads, d = cfg.num_heads, cfg.embed_dim // cfg.num_heads
    rate, scale = cfg.attn_drop_rate, d ** -0.5
    n_img = (cfg.img_size // cfg.patch_size) ** 2 + 1
    seed = torch.tensor([DROP_SEED + 2], dtype=torch.int32, device=dev)
    shapes = (("text", TRAIN_BATCH, cfg.max_text_len, 1), ("image", TRAIN_BATCH, n_img, 1),
              ("fused", TRAIN_BATCH, cfg.max_text_len + n_img, 1),
              ("itm", 3 * TRAIN_BATCH, cfg.max_text_len + n_img, 3))
    rows = []
    for stream, b, n, runs in shapes:
        idx = row_index_of(1, TWO_RANKS, b, runs, dev)
        bh = b * heads
        g = torch.Generator(device=dev).manual_seed(7 * b + n)
        q, k, v, do = (torch.randn((bh, n, d), generator=g, device=dev).to(torch.bfloat16)
                       for _ in range(4))
        kb = torch.zeros((b, n), dtype=torch.float32, device=dev)
        od, lsed = flash_attention_fwd_drop_plain(q, k, v, kb, seed, scale, rate, idx)
        got, want = (flash_attention_fwd_drop(q, k, v, kb, seed, scale, rate, idx),
                     (od, lsed))
        bgot = flash_attention_bwd_drop(q, k, v, kb, seed, od, do, lsed, scale, rate, idx)
        bwant = flash_attention_bwd_drop_plain(q, k, v, kb, seed, od, do, lsed, scale, rate,
                                               idx)
        torch.cuda.synchronize()
        checks = [within(got[0], want[0], ATTN_ATOL, ATTN_RTOL),
                  within(got[1], want[1], ATTN_LSE_ATOL, 0.0)]
        checks += [within(x, y, BWD_ATOL, BWD_RTOL) for x, y in zip(bgot, bwant)]
        require(all(ok for ok, _ in checks),
                f"rows 3/4 with a row index, {stream} BH={bh} N={n}: max|err| "
                f"{[e for _, e in checks]} beyond the tolerances")
        timed = {}
        for name, with_idx in (("plain_index", None), ("index", idx), ("index", idx),
                               ("plain_index", None)):
            timed.setdefault(f"fwd_{name}_ms", []).append(time_ms(
                lambda: flash_attention_fwd_drop(q, k, v, kb, seed, scale, rate, with_idx)))
            timed.setdefault(f"bwd_{name}_ms", []).append(time_ms(
                lambda: flash_attention_bwd_drop(q, k, v, kb, seed, od, do, lsed, scale,
                                                 rate, with_idx)))
        rows.append({"stream": stream, "shape": f"BH={bh} N={n}", "runs": runs,
                     "first_rows": idx[:4].tolist(), "max_abs_err": max(e for _, e in checks),
                     **timed})
    mask = check_dropout_mask(cfg, dev, 3 * TRAIN_BATCH,
                              row_index=row_index_of(1, TWO_RANKS, 3 * TRAIN_BATCH, 3, dev))
    print("dropout_mask: " + json.dumps(mask), flush=True)
    return rows


def losses_of(m: dict) -> dict:
    return {k: float(v) for k, v in m.items() if k.endswith("_task_loss") or k == "total_loss"}


def group_overrides(port: int, world: int = 1, rank: int = 0) -> list[str]:
    return [f"runtime.coordinator_address=localhost:{port}", f"runtime.num_processes={world}",
            f"runtime.process_id={rank}"]


def preset_phase(card: str, port: int) -> dict:
    """Every preset on a real process group of one rank (NCCL, started by
    `runtime.coordinator_address`) at vlmo_base, pretrain_mum's defaults,
    batch 32: the first step (its losses required equal across the
    presets within fp32 sum order: one rank computes the same step under
    each), then PARALLEL_STEPS timed, with rows 3 and 4 counted (row 3
    twice a block under remat, which runs the forward again in the
    backward) and the peak memory."""
    cfg = VlmoConfig.from_config(load_config(TRAIN_OVERRIDES))
    per_step = attention_calls_per_step(cfg)
    out = {}
    for tag, extra in PARALLEL_RUNS:
        cfg_dict = load_config(TRAIN_OVERRIDES + group_overrides(port) + extra)
        t0 = time.perf_counter()
        trainer = Trainer(cfg_dict, device="cuda")
        ready_s = time.perf_counter() - t0
        require(trainer.runtime.distributed and trainer.runtime.world == 1,
                f"{tag}: no process group")
        first = losses_of(trainer.step())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        metrics, times, launches = run_counted(trainer, PARALLEL_STEPS, timed=True)
        remat = trainer.config.remat
        expected = {"flash_attention_fwd_drop": per_step * (2 if remat else 1),
                    "flash_attention_bwd_drop": per_step}
        require_launches(f"parallel_{tag}", launches, expected, PARALLEL_STEPS)
        out[tag] = {
            "preset": trainer.preset, "remat": remat, "trainer_s": ready_s,
            "median_ms_per_step": statistics.median(times) * 1e3,
            "ms_per_step": [x * 1e3 for x in times],
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
            "launches_per_step": {k: launches[k] / PARALLEL_STEPS for k in expected},
            "first_step_losses": first, "card": card,
        }
        print(f"parallel_{tag}: " + json.dumps(out[tag]), flush=True)
        del trainer
        torch.cuda.empty_cache()
    ref = out["dp"]["first_step_losses"]
    for tag, r in out.items():
        for k, want in ref.items():
            got = r["first_step_losses"][k]
            require(abs(got - want) <= 1e-5 * abs(want) + 1e-6,
                    f"parallel_{tag}: first-step {k} {got} against dp's {want}")
    return out


def probe_child(rank: int, port: int, backend: str, path: str) -> int:
    """One of two ranks on the one card: which collectives `backend` runs
    on CUDA tensors (each attempted, its error recorded)."""
    import torch.distributed as dist

    result = {"backend": backend, "rank": rank}
    try:
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", world_size=2,
                                rank=rank)
        x = torch.full((4,), float(rank + 1), device="cuda")
        ops = {"all_reduce": lambda: dist.all_reduce(x.clone()),
               "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
                   torch.empty(8, device="cuda"), x),
               "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
                   torch.empty(2, device="cuda"), x)}
        for name, op in ops.items():
            try:
                op()
                torch.cuda.synchronize()
                result[name] = "ok"
            except Exception as e:  # the probe's answer, not a failure
                result[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:300]}"
        dist.destroy_process_group()
    except Exception as e:
        result["init"] = f"{type(e).__name__}: {str(e).splitlines()[0][:300]}"
    with open(path, "w") as f:
        json.dump(result, f)
    return 0


def require_ranks(done: list, tags: list) -> None:
    """Each rank process of `spawn_ranks` exited 0 (tags[i] names the i-th)."""
    for (rc, log), tag in zip(done, tags):
        require(rc == 0, f"{tag} exited {rc}:\n{log[-3000:]}")


def spawn_ranks(args: list[list[str]], timeout: float) -> list[tuple[int, str]]:
    """Start a process of this script per argument list, wait for each (the
    rest are killed once one outlives `timeout`); (exit code, output)."""
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), *a],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for a in args]
    outs = []
    try:
        for p in procs:
            try:
                outs.append((p.communicate(timeout=timeout)[0], p))
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                outs.append((f"timed out after {timeout} s", p))
                timeout = 5
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, log) for log, p in outs]


def probe_two_ranks(tmp: str) -> dict:
    """What the card's machine allows two ranks: the devices, NCCL's answer
    to two ranks on one device, gloo's to CUDA tensors."""
    out = {"device_count": torch.cuda.device_count()}
    backends = ("nccl", "gloo")
    ports = {b: free_port() for b in backends}
    paths = {(b, r): os.path.join(tmp, f"probe_{b}_{r}.json") for b in backends
             for r in range(TWO_RANKS)}
    # both backends' two ranks at once
    runs = spawn_ranks([["--probe-rank", str(r), str(ports[b]), b, paths[(b, r)]]
                        for b, r in paths], PROBE_TIMEOUT_S)
    for b in backends:
        found = [json.load(open(paths[(b, r)])) if os.path.exists(paths[(b, r)]) else
                 {"exit": rc, "log": log[-600:]}
                 for r, (rc, log) in zip(range(TWO_RANKS),
                                         runs[backends.index(b) * TWO_RANKS:])]
        out[b] = found[0] if all(f == {**found[0], "rank": f.get("rank")}
                                 for f in found) else found
    print("two_rank_probe: " + json.dumps(out), flush=True)
    return out


def two_rank_child(rank: int, port: int, tag: str, workdir: str) -> int:
    """Rank `rank` of the two-rank step over gloo on the one card: its half
    of the parent's batch, the parent's ITM negatives and MIM labels; its
    losses and the named gradients (whole) to `workdir`; where the parent
    asks for "rules" (phase 28), `rule_updates` on the step's gradients."""
    import torch.distributed as dist

    inputs = torch.load(os.path.join(workdir, "in.pt"), weights_only=False)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=TWO_RANKS, rank=rank)
    cfg_dict = load_config(inputs["overrides"] + group_overrides(port, TWO_RANKS, rank)
                           + [f"data.batch_size={TRAIN_BATCH // TWO_RANKS}", f"parallel={tag}"])
    trainer = Trainer(cfg_dict, device="cuda")
    ckpt_lib.load_model_state_dict(trainer.task, inputs["weights"])
    per = TRAIN_BATCH // TWO_RANKS
    lo, hi = rank * per, (rank + 1) * per
    batch = {k: v[lo:hi] for k, v in inputs["batch"].items()}
    named = {k: p for k, p in trainer.task.named_parameters() if p.requires_grad}
    before = ({k: p.detach().to_local().clone() if hasattr(p, "to_local") else
               p.detach().clone() for k, p in named.items()} if inputs.get("rules") else None)
    m = trainer.step(batch, negatives=tuple(n[lo:hi] for n in inputs["negatives"]),
                     mim_labels=inputs["mim_labels"][lo:hi])

    def whole(t):
        if hasattr(t, "to_local"):
            # fsdp's dim-0 shards gathered by hand: a DTensor's own gather
            # (functional collectives) crashes on gloo with CUDA tensors;
            # these parameters split evenly
            local = t.to_local().contiguous()
            t = local.new_empty((TWO_RANKS * local.shape[0], *local.shape[1:]))
            dist.all_gather_into_tensor(t, local)
        return t.float().cpu()

    grads = {}
    for k, p in trainer.task.named_parameters():
        if k in TWO_RANK_PARAMS:
            grads[k] = whole(p.grad)
    out = {"losses": losses_of(m), "grads": grads}
    if before is not None:
        out["updates"] = rule_updates(named, before, {k: p.grad for k, p in named.items()},
                                      inputs["overrides"], trainer.steps_per_epoch,
                                      ("whole", "local"), whole)
    torch.save(out, os.path.join(workdir, f"out_{tag}_{rank}.pt"))
    dist.destroy_process_group()
    return 0


def two_rank_phase(card: str, probe: dict, tmp: str) -> dict:
    """dp and fsdp at 2 x 16 rows against one rank at 32 on the same global
    batch (the same weights, ITM negatives and MIM labels; hidden dropout
    and DropPath off, attention dropout on through the hash keyed by the
    global rows), where a route gives two ranks: two cards over NCCL, or
    the one card over gloo. Losses within LOSS_RTOL, the named gradients
    within GRAD_REL_TOL relative L2. Where no route does, says why."""
    gloo = probe["gloo"] if isinstance(probe["gloo"], dict) else {}
    # what each preset's step calls: DDP's all-reduce and the losses'
    # gathers; FSDP2's all-gather and reduce-scatter as well
    needs = {"dp": ("all_reduce", "all_gather_into_tensor"),
             "fsdp": ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor")}
    tags = [t for t, ops in needs.items() if all(gloo.get(o) == "ok" for o in ops)]
    out = {"ran": tags, "card": card}
    if len(tags) < len(needs):
        out["why"] = (f"{probe['device_count']} device(s); NCCL: {probe['nccl']}; gloo on "
                      f"CUDA tensors: { {o: gloo.get(o) for o in needs['fsdp']} }")
        print(f"two_rank: {sorted(set(needs) - set(tags))} left to the CPU tests "
              f"(tests/test_torch_port_parallel.py): {out['why']}", flush=True)
    if not tags:
        return out
    require(probe["device_count"] < TWO_RANKS,
            "two_rank: more than one card: run the two ranks over NCCL, one per card")
    overrides = TRAIN_OVERRIDES + ["model.drop_rate=0.0", "model.drop_path_rate=0.0"]
    one = Trainer(load_config(overrides), device="cuda")
    batch = one.next_batch()
    labels = one.model_batch(batch)["mim_labels"].cpu()
    b = TRAIN_BATCH
    negatives = (torch.arange(1, b + 1) % b, torch.arange(b - 1, 2 * b - 1) % b)
    weights = {k: v.cpu() for k, v in one.task.state_dict().items()}
    m = one.step(batch, negatives=negatives, mim_labels=labels)
    want = {"losses": losses_of(m), "grads": {
        k: p.grad.float().cpu() for k, p in one.task.named_parameters()
        if k in TWO_RANK_PARAMS}}
    del one
    torch.cuda.empty_cache()
    torch.save({"overrides": overrides, "weights": weights, "batch": batch,
                "negatives": negatives, "mim_labels": labels}, os.path.join(tmp, "in.pt"))
    # every preset's two ranks at once (their own ports)
    t0 = time.perf_counter()
    ports = {tag: free_port() for tag in tags}
    runs = spawn_ranks([["--two-rank", str(r), str(ports[tag]), tag, tmp]
                        for tag in tags for r in range(TWO_RANKS)], 600)
    for i, (rc, log) in enumerate(runs):
        require(rc == 0, f"two_rank {tags[i // TWO_RANKS]} rank {i % TWO_RANKS} exited "
                f"{rc}:\n{log[-3000:]}")
    out["s"] = time.perf_counter() - t0
    for tag in tags:
        got = [torch.load(os.path.join(tmp, f"out_{tag}_{r}.pt")) for r in range(TWO_RANKS)]
        res = {"losses_two_one": {
            k: (got[0]["losses"][k], w) for k, w in want["losses"].items()},
            "grad_rel_err": {k: ((got[0]["grads"][k] - w).norm() / w.norm()).item()
                             for k, w in want["grads"].items()}}
        print(f"two_rank_{tag}: " + json.dumps(res), flush=True)
        for k, (g, w) in res["losses_two_one"].items():
            require(abs(g - w) <= LOSS_RTOL * abs(w) + 1e-3,
                    f"two_rank {tag} {k}: two ranks {g} against one {w}")
            require(got[1]["losses"][k] == g, f"two_rank {tag} {k}: the ranks disagree")
        require(max(res["grad_rel_err"].values()) <= GRAD_REL_TOL,
                f"two_rank {tag}: gradients {res['grad_rel_err']}")
        out[tag] = res
    return out


def mesh_serve_phase(card: str) -> dict:
    """`Predictor(devices=[cuda:0])` (mesh serving: a replica per device,
    here one) against the plain `Predictor` on the same batch-64 requests:
    equal logits, and rows 1 and 6 on every attention and FFN call."""
    cfg_dict = load_config(SERVE_OVERRIDES)
    cfg = VlmoConfig.from_config(cfg_dict)
    sd = build_model(cfg_dict, device="cpu", seed=0).state_dict()
    plain = Predictor(cfg_dict, sd, device="cuda")
    mesh = Predictor(cfg_dict, sd, device="cuda", devices=["cuda:0"])
    img, ids, mask = make_requests(cfg, np.random.default_rng(26), count=1)[0]
    want = plain.vqa_logits(img, ids, mask)
    for fn in KERNELS:
        fn.launches = 0
    got = mesh.vqa_logits(img, ids, mask)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in KERNELS}
    calls = img_txt_calls(cfg)
    require_launches("mesh_serve", launches, {"flash_attention_fwd": calls,
                                              "fused_mlp_fwd": calls}, 1)
    require(np.array_equal(got, want), "mesh_serve: the replica's logits differ")
    out = {"replicas": len(mesh.replicas), "launches": launches, "equal": True, "card": card}
    print("mesh_serve: " + json.dumps(out), flush=True)
    del plain, mesh
    torch.cuda.empty_cache()
    return out


def parallel_phase(card: str, dev) -> dict:
    """Phase 26: the row index of rows 3 and 4, every preset on a process
    group of one rank, the two-rank probe and (where a route allows) the
    two-rank step, mesh serving."""
    import torch.distributed as dist

    cfg = VlmoConfig.from_config(load_config(TRAIN_OVERRIDES))
    out = {"row_index": check_row_index(cfg, dev)}
    for row in out["row_index"]:
        print("kernel_row_index: " + json.dumps(row), flush=True)
    elapsed("phase 26 row index")
    tmp = tempfile.mkdtemp(prefix="emm_parallel_")
    try:
        out["probe"] = probe_two_ranks(tmp)
        elapsed("phase 26 probe")
        out["presets"] = preset_phase(card, free_port())
        elapsed("phase 26 presets")
        out["two_rank"] = two_rank_phase(card, out["probe"], tmp)
        elapsed("phase 26 two ranks")
        out["mesh_serve"] = mesh_serve_phase(card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        if dist.is_initialized():
            dist.destroy_process_group()
    return out


def parallel_only(card: str, dev) -> int:
    """The build, then phase 26 alone (`--parallel`)."""
    parallel_phase(card, dev)
    return 0


# ---- phase 27: tensor parallelism (parallel=tp) on two gloo ranks
TP = 2  # the tensor axis: two processes of this script on the one card
TP_STEPS = 3  # timed on each rank, after the compared step
TP_TIMEOUT_S = 420
TP_MLP_THRESHOLD = 6554  # finetune_vqa's hidden dropout 0.1
TP_MLP_SIZES = (2, 4)  # hidden 1,536 and 768 of 3,072


def check_tp_attention(cfg: VlmoConfig, dev) -> list[dict]:
    """Rows 3 and 4 holding heads 6..11 of 12 (tensor rank 1 of TP) at the
    tp step's shapes: the streams' BH = 192 at N = 40, 197 and 237, and
    ITM's BH = 576 at N = 237, against their plain versions with the same
    heads' offset, within the existing bf16 limits; the mask bit for bit at
    ITM's shape (`check_dropout_mask` at the offset, whose plain mask is
    required equal to the whole call's at those heads); each timed with
    the offset and without it (the same heads keyed as a whole call's), in
    turns."""
    heads_total, d = cfg.num_heads, cfg.embed_dim // cfg.num_heads
    heads = heads_total // TP
    offset = {"heads_total": heads_total, "head0": heads}
    rate, scale = cfg.attn_drop_rate, d ** -0.5
    n_img = (cfg.img_size // cfg.patch_size) ** 2 + 1
    n_fused = cfg.max_text_len + n_img
    seed = torch.tensor([DROP_SEED + 3], dtype=torch.int32, device=dev)
    rows = []
    for stream, b, n in (("text", TRAIN_BATCH, cfg.max_text_len), ("image", TRAIN_BATCH, n_img),
                         ("fused", TRAIN_BATCH, n_fused), ("itm", 3 * TRAIN_BATCH, n_fused)):
        bh = b * heads
        g = torch.Generator(device=dev).manual_seed(11 * b + n)
        q, k, v, do = (torch.randn((bh, n, d), generator=g, device=dev).to(torch.bfloat16)
                       for _ in range(4))
        kb = torch.zeros((b, n), dtype=torch.float32, device=dev)
        od, lsed = flash_attention_fwd_drop_plain(q, k, v, kb, seed, scale, rate, **offset)
        got = flash_attention_fwd_drop(q, k, v, kb, seed, scale, rate, **offset)
        bgot = flash_attention_bwd_drop(q, k, v, kb, seed, od, do, lsed, scale, rate, **offset)
        bwant = flash_attention_bwd_drop_plain(q, k, v, kb, seed, od, do, lsed, scale, rate,
                                               **offset)
        torch.cuda.synchronize()
        checks = [within(got[0], od, ATTN_ATOL, ATTN_RTOL),
                  within(got[1], lsed, ATTN_LSE_ATOL, 0.0)]
        checks += [within(x, y, BWD_ATOL, BWD_RTOL) for x, y in zip(bgot, bwant)]
        require(all(ok for ok, _ in checks),
                f"rows 3/4 at heads {heads}..{heads_total - 1}, {stream} BH={bh} N={n}: "
                f"max|err| {[e for _, e in checks]} beyond the tolerances")
        timed = {}
        for name, kw in (("no_offset", {}), ("offset", offset), ("offset", offset),
                         ("no_offset", {})):
            timed.setdefault(f"fwd_{name}_ms", []).append(time_ms(
                lambda: flash_attention_fwd_drop(q, k, v, kb, seed, scale, rate, **kw)))
            timed.setdefault(f"bwd_{name}_ms", []).append(time_ms(
                lambda: flash_attention_bwd_drop(q, k, v, kb, seed, od, do, lsed, scale, rate,
                                                 **kw)))
        fwd_bound = bound(4 * bh * n * d * 2 + b * n * 4 + bh * n * 4, 4 * bh * n * n * d)
        bwd_bound = bound(8 * bh * n * d * 2 + b * n * 4 + bh * n * 4, 10 * bh * n * n * d)
        rows.append({"stream": stream, "shape": f"BH={bh} N={n}", "heads": f"{heads}.."
                     f"{heads_total - 1} of {heads_total}",
                     "max_abs_err": max(e for _, e in checks),
                     "fwd_bound_ms": fwd_bound[0], "bwd_bound_ms": bwd_bound[0], **timed})
    mask = check_dropout_mask(cfg, dev, 3 * TRAIN_BATCH, heads=heads, **offset)
    print("dropout_mask: " + json.dumps(mask), flush=True)
    return rows


def check_tp_mlp(cfg: VlmoConfig, dev) -> list[dict]:
    """Rows 6 and 7 in the partial mode (fp32 out, no b2) on each tensor
    rank's share of the hidden at T = 2 and 4 (1,536 and 768 of 3,072), at
    the finetune_vqa step's M (text, image, fused rows; its evaluation at
    batch 32 gives row 6 the same): each rank's share against its plain
    version, and the T shares summed in fp32, b2 added and rounded once
    against the whole plain MLP within the whole kernel's limits
    (MLP_ATOL, MLP_RTOL); rank 0's share timed beside the whole kernel at
    hidden 3,072 on the same rows, its plain version and the library chain
    on the share."""
    g, w1, b1, w2, b2 = mlp_weights(cfg, dev, 4)
    k, h, n_out = w1.shape[1], w1.shape[0], w2.shape[0]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for drop in (False, True):
        t = TP_MLP_THRESHOLD if drop else 0
        kernel = fused_mlp_fwd_drop if drop else fused_mlp_fwd
        plain = fused_mlp_fwd_drop_plain if drop else fused_mlp_fwd_plain
        for m in vqa_mlp_rows(cfg):
            x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
            bits = (torch.randint(-32768, 32768, (m, h), dtype=torch.int16, generator=g,
                                  device=dev) if drop else None)
            whole_args = (x, w1, b1, w2, b2) + ((bits, t) if drop else ())
            whole = plain(*whole_args)
            for size in TP_MLP_SIZES:
                hs = h // size
                shares = []
                for r in range(size):
                    cols = slice(r * hs, (r + 1) * hs)
                    shares.append((x, w1[cols].contiguous(), b1[cols].contiguous(),
                                   w2[:, cols].contiguous(), None)
                                  + ((bits[:, cols].contiguous(), t) if drop else ()))
                parts = [kernel(*a) for a in shares]
                refs = [plain(*a) for a in shares]
                torch.cuda.synchronize()
                errs = [within(p_, r_, MLP_ATOL, MLP_RTOL) for p_, r_ in zip(parts, refs)]
                summed = (torch.stack(parts).sum(0) + b2).to(torch.bfloat16)
                sum_ok, sum_err = within(summed, whole, MLP_ATOL, MLP_RTOL)
                require(all(ok for ok, _ in errs) and sum_ok and all(
                    p_.dtype == torch.float32 for p_ in parts),
                    f"mlp partial drop={drop} M={m} hidden {hs}: max|err| "
                    f"{[e for _, e in errs]}, summed {sum_err}")
                a0 = shares[0]
                w1h, w2h = a0[1], a0[3]
                b1h = a0[2].to(torch.bfloat16)

                def library():
                    hh = F.gelu(F.linear(x, w1h, b1h), approximate="tanh")
                    if drop:
                        hh = torch.where(keep16(a0[5], t),
                                         hh * torch.tensor(keep_scale16(t), dtype=hh.dtype,
                                                           device=dev),
                                         torch.zeros_like(hh))
                    return F.linear(hh, w2h).float()

                nbytes = (2 * (m * k + hs * k + n_out * hs) + 4 * hs + 4 * m * n_out
                          + (2 * m * hs if drop else 0))
                bound_ms, bound_by = bound(nbytes, 2 * m * (k * hs + hs * n_out))
                rows.append({
                    "name": "fused_mlp_fwd_drop" if drop else "fused_mlp_fwd",
                    "shape": f"M={m} K={k} H={hs} of {h} N={n_out}", "tensor": size,
                    "hidden_splits": hidden_splits(m, hs, sms),
                    "max_abs_err": max(e for _, e in errs), "summed_err": sum_err,
                    "ms": time_ms(lambda: kernel(*a0)),
                    "whole_ms": time_ms(lambda: kernel(*whole_args)),
                    "plain_ms": time_ms(lambda: plain(*a0), iters=5),
                    "library_ms": time_ms(library),
                    "bound_ms": bound_ms, "bound_by": bound_by,
                })
                del parts, refs, summed
    return rows


def tp_rank_child(rank: int, port: int, tag: str, workdir: str) -> int:
    """Rank `rank` of phase 27's tp = 2 step over gloo on the one card (the
    group started before the `Trainer`, which joins it): the parent's
    weights and batch (and ITM negatives and MIM labels), every dropout on;
    the compared step's losses, launches and all-reduces (counted by
    wrapping `dist.all_reduce`), the named gradients gathered whole over
    the tensor axis, then TP_STEPS timed steps and the peak memory. For
    finetune_vqa also one evaluation batch (row 6's launches, the logits)
    and a checkpoint, which rank 0 writes whole."""
    import torch.distributed as dist

    from exploremultimodal_torch.parallel.partitioning import gather_tensor, tensor_split

    inputs = torch.load(os.path.join(workdir, f"in_{tag}.pt"), weights_only=False)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=TP,
                            rank=rank)
    reduced = []
    all_reduce = dist.all_reduce

    def counted(t, *a, **kw):
        reduced.append(t.numel() * t.element_size())
        return all_reduce(t, *a, **kw)

    dist.all_reduce = counted
    cfg_dict = load_config(inputs["overrides"] + group_overrides(port, TP, rank)
                           + ["parallel=tp"])
    trainer = Trainer(cfg_dict, device="cuda")
    require(trainer.mesh.tensor_size == TP and trainer.axis is None, "tp: not a tensor axis")
    ckpt_lib.load_model_state_dict(trainer.task, inputs["weights"])
    batch, kw = inputs["batch"], inputs["step_kwargs"]
    for fn in KERNELS:
        fn.launches = 0
    reduced.clear()
    m = trainer.step(batch, **kw)
    torch.cuda.synchronize()
    out = {"losses": losses_of(m), "launches": {fn.__name__: fn.launches for fn in KERNELS},
           "all_reduces": len(reduced), "all_reduce_bytes": sum(reduced), "grads": {}}
    for k, p in trainer.task.named_parameters():
        if k in inputs["params"]:
            g, how = p.grad.contiguous(), tensor_split(k)
            if how is not None:
                parts = [torch.empty_like(g) for _ in range(TP)]
                dist.all_gather(parts, g, group=trainer.mesh.tensor_group)
                g = gather_tensor(parts, how)
            out["grads"][k] = g.float().cpu()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(TP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.step(batch, **kw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    out.update(ms_per_step=[x * 1e3 for x in times],
               median_ms_per_step=statistics.median(times) * 1e3,
               peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30)
    if tag != "mum":
        out["saved"] = ckpt_lib.save(os.path.join(workdir, f"ckpt_{tag}"), trainer.state,
                                     cfg_dict, 0)
        for fn in KERNELS:
            fn.launches = 0
        _, _, extra = trainer.eval_step(batch, torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        out["eval_launches"] = {fn.__name__: fn.launches for fn in KERNELS}
        out["eval_logits"] = extra["vqa_logits"].float().cpu()
    torch.save(out, os.path.join(workdir, f"out_{tag}_{rank}.pt"))
    dist.destroy_process_group()
    return 0


def tp_overrides(tag: str) -> list[str]:
    if tag == "mum":
        return TRAIN_OVERRIDES
    return VQA_OVERRIDES + (["model.quantize=w8a8_pallas"] if tag == "vqa_w8" else [])


def tp_step_phase(card: str, tag: str, tmp: str) -> dict:
    """pretrain_mum ("mum", rows 3 and 4 54 times a step), finetune_vqa
    with mlp_impl=fused ("vqa": rows 7, 3 and 4 18 times, row 6 18 times an
    evaluation batch, each MLP in the partial mode) or at
    model.quantize=w8a8_pallas ("vqa_w8": rows 8 whole (qkv) and partial
    (proj), 10 split, 3 and 4 18 times a step; rows 8 and 9 split 18 times
    an evaluation batch) at vlmo_base, batch 32, every dropout on: one
    process on the card, then two tensor ranks (`tp_rank_child`) on the
    same weights and batch. Losses within LOSS_RTOL and equal on both
    ranks, the named gradients within GRAD_REL_TOL (relative L2), the
    launches counted per step; for finetune_vqa the ranks' checkpoint read
    in one process gives their logits within E2E_ATOL (W8A8_E2E_ATOL for
    int8)."""
    mum, int8 = tag == "mum", tag == "vqa_w8"
    overrides = tp_overrides(tag)
    names = TWO_RANK_PARAMS if mum else CHECKED_VQA_PARAMS
    one = Trainer(load_config(overrides), device="cuda")
    batch = one.next_batch()
    kw = {}
    if mum:
        b = TRAIN_BATCH
        kw = {"negatives": (torch.arange(1, b + 1) % b, torch.arange(b - 1, 2 * b - 1) % b),
              "mim_labels": one.model_batch(batch)["mim_labels"].cpu()}
    weights = {k: v.cpu() for k, v in one.task.state_dict().items()}
    m = one.step(batch, **kw)
    want = {"losses": losses_of(m), "grads": {k: p.grad.float().cpu() for k, p in
                                              one.task.named_parameters() if k in names}}
    if mum:  # finetune_vqa's trainer reads the ranks' checkpoint back below
        del one
        torch.cuda.empty_cache()
    torch.save({"overrides": overrides, "weights": weights, "batch": batch, "step_kwargs": kw,
                "params": names}, os.path.join(tmp, f"in_{tag}.pt"))
    t0 = time.perf_counter()
    port = free_port()
    require_ranks(spawn_ranks([["--tp-rank", str(r), str(port), tag, tmp] for r in range(TP)],
                              TP_TIMEOUT_S), [f"tp {tag} rank {r}" for r in range(TP)])
    cfg = VlmoConfig.from_config(load_config(overrides))
    got = [torch.load(os.path.join(tmp, f"out_{tag}_{r}.pt")) for r in range(TP)]
    calls = img_txt_calls(cfg)
    if mum:
        expected = {"flash_attention_fwd_drop": attention_calls_per_step(cfg),
                    "flash_attention_bwd_drop": attention_calls_per_step(cfg)}
    elif int8:
        expected = {"w8a8_matmul": calls, "w8a8_matmul_partial": calls,
                    "w8a8_mlp_fwd_drop_split": calls, "flash_attention_fwd_drop": calls,
                    "flash_attention_bwd_drop": calls, "w8a8_mlp_fwd_drop": 0,
                    "fused_mlp_fwd_drop": 0}
        eval_expected = {"w8a8_matmul": calls, "w8a8_matmul_partial": calls,
                         "w8a8_mlp_fwd_split": calls, "w8a8_mlp_fwd": 0}
    else:
        expected = {"fused_mlp_fwd_drop": calls, "flash_attention_fwd_drop": calls,
                    "flash_attention_bwd_drop": calls, "fused_mlp_fwd": 0}
        eval_expected = {"fused_mlp_fwd": calls, "fused_mlp_fwd_drop": 0}
    res = {"s": time.perf_counter() - t0, "card": card, "ranks": []}
    for r, g in enumerate(got):
        require_launches(f"tp_{tag} rank {r}", g["launches"], expected, 1)
        if not mum:
            require_launches(f"tp_{tag} eval rank {r}", g["eval_launches"], eval_expected, 1)
        for k, w in want["losses"].items():
            require(abs(g["losses"][k] - w) <= LOSS_RTOL * abs(w) + 1e-3,
                    f"tp {tag} rank {r} {k}: {g['losses'][k]} against one process's {w}")
            require(g["losses"][k] == got[0]["losses"][k], f"tp {tag} {k}: the ranks disagree")
        grad_err = {k: ((g["grads"][k] - w).norm() / w.norm()).item()
                    for k, w in want["grads"].items()}
        require(max(grad_err.values()) <= GRAD_REL_TOL, f"tp {tag} rank {r}: gradients "
                f"{grad_err}")
        res["ranks"].append({
            "median_ms_per_step": g["median_ms_per_step"], "ms_per_step": g["ms_per_step"],
            "peak_memory_gib": g["peak_memory_gib"], "all_reduces_per_step": g["all_reduces"],
            "all_reduce_gb_per_step": g["all_reduce_bytes"] / 1e9,
            "launches_per_step": {k: g["launches"][k] for k in expected},
            **({} if mum else {"eval_launches": {k: g["eval_launches"][k]
                                                 for k in eval_expected}}),
            "grad_rel_err": grad_err})
    res["losses_tp_one"] = {k: (got[0]["losses"][k], w) for k, w in want["losses"].items()}
    if not mum:
        # the checkpoint the two ranks wrote (rank 0, the whole torch
        # layout), read by the one process's trainer: its logits are the
        # ranks'. Its floating tensors are set to NaN first, so a tensor the
        # load missed cannot keep this trainer's stepped values unseen
        reader = one
        floats = [v for v in reader.task.state_dict().values() if v.is_floating_point()]
        with torch.no_grad():
            for v in floats:
                v.fill_(float("nan"))
        restored = ckpt_lib.auto_load(os.path.join(tmp, f"ckpt_{tag}"), reader.state,
                                      reader.cfg)
        require(restored is not None and reader.state.step == 1 + TP_STEPS,
                f"tp checkpoint: restored {restored}, step {reader.state.step}")
        missed = sum(not bool(torch.isfinite(v).all()) for v in floats)
        require(missed == 0, f"tp checkpoint: {missed} of {len(floats)} tensors not loaded")
        _, _, extra = reader.eval_step(batch, torch.Generator(device="cuda").manual_seed(0))
        diff = (extra["vqa_logits"].float().cpu() - got[0]["eval_logits"]).abs().max().item()
        atol = W8A8_E2E_ATOL if int8 else E2E_ATOL
        require(diff <= atol, f"tp checkpoint: logits {diff} apart, beyond {atol}")
        res["checkpoint_logits_max_abs_diff"] = diff
        del reader, one
        torch.cuda.empty_cache()
    print(f"tp_{tag}: " + json.dumps(res), flush=True)
    return res


def tp_phase(card: str, dev) -> dict:
    """Phase 27: rows 3 and 4 with the heads' offset, rows 6 and 7 in the
    partial mode, then the tp = 2 pretrain_mum and finetune_vqa steps over
    gloo against one process, and the checkpoint across layouts."""
    train_cfg = VlmoConfig.from_config(load_config(TRAIN_OVERRIDES))
    vqa_cfg = VlmoConfig.from_config(load_config(VQA_OVERRIDES))
    out = {"attention": check_tp_attention(train_cfg, dev), "mlp": check_tp_mlp(vqa_cfg, dev)}
    for row in out["attention"] + out["mlp"]:
        print("kernel_tp: " + json.dumps(row), flush=True)
    elapsed("phase 27 kernels")
    tmp = tempfile.mkdtemp(prefix="emm_tp_")
    try:
        out["pretrain_mum"] = tp_step_phase(card, "mum", tmp)
        elapsed("phase 27 pretrain_mum")
        out["vqa"] = tp_step_phase(card, "vqa", tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def tp_only(card: str, dev) -> int:
    """The build, then phase 27 alone (`--tp`)."""
    tp_phase(card, dev)
    return 0


# ---- phase 28: the optimizer menu
# one pretrain_mum trainer for the whole phase, at hidden dropout and
# DropPath 0 (attention dropout on) as its two-rank check needs: the rules'
# gradients and the timed steps come from it too
OPTIM_OVERRIDES = TRAIN_OVERRIDES + ["model.drop_rate=0.0", "model.drop_path_rate=0.0"]
OPTIM_RULES = tuple(sorted(OPTIM_RULE_TABLE)) + ("lookahead_adamw",)
OPTIM_LOOKAHEAD_UPDATES = 7  # lookahead syncs at the 6th
OPTIM_TIMED = ("lamb", "adafactor")
OPTIM_TIMED_STEPS = 3
# the leaves the CPU updates beside the card (the rules work leaf by leaf
# and pretrain_mum clips nothing, so a subset's update is the whole one's
# there): Dense kernels adafactor factors, the 3-D pos_embed (factored, not
# a kernel), the conv kernel, biases, a head, the 0-d itc_temp
OPTIM_CPU_PARAMS = ("transformer.blocks.0.attn.qkv.weight",
                    "transformer.blocks.11.mlp_vl.fc1.weight",
                    "transformer.blocks.5.mlp_v.fc2.bias", "transformer.blocks.3.attn.q_bias",
                    "transformer.patch_embed.weight", "transformer.pos_embed",
                    "itm_head.fc.weight", "itc_temp")
OPTIM_UPDATES = 2  # a rule's first update also makes its state
# the card's fp32 update against the CPU's: every element within this share
# of the leaf's largest step plus 4 fp32 spacings of the parameter (the
# devices round the moments' square roots and sums differently); lion's
# step is a sign, compared by the share of equal signs
OPTIM_STEP_RTOL, OPTIM_SIGN_AGREEMENT = 1e-3, 0.999
# the two-rank update (fsdp, gloo) against one process's on the same
# gradients (theirs 0.2% apart in relative L2): the difference's relative
# L2 (a first step of lamb, or of adafactor on a leaf it does not factor,
# is near a sign of the gradient, whose flips where the two gradients
# straddle 0 set this reading: up to 2.7% / 1.7% on the H100), and each
# fsdp shard's part's size (|ratio - 1|), which such flips leave alone and
# a leaf statistic of one shard alone moves. Read on the H100: lamb
# 1.4e-5 (its control 7.6e-3), adafactor 2.9e-4 (its control 0.82)
OPTIM_TWO_RANK_REL_L2 = 0.1
OPTIM_TWO_RANK_SIZE = {"lamb": 1e-4, "adafactor": 2e-3}


def optim_warmup_end(overrides: list[str], steps_per_epoch: int) -> int:
    """The schedule's last warm-up step (its base rate): the rules are
    compared there, not at the warm-up's first rates (5e-7 and up), whose
    steps lamb's trust ratio takes down to a few fp32 spacings of the
    weights."""
    t = load_config(overrides)["train"]
    return min(int(t["warmup_steps"]), max(int(t["epochs"] * steps_per_epoch) - 1, 1))


def optim_rules_phase(card: str, trainer: Trainer) -> dict:
    """One pretrain_mum step of `trainer` (vlmo_base, batch 32; rows 3 and
    4 counted) for its gradients; then each rule of OPTIM_RULES applied to
    them from
    the step's weights, OPTIM_UPDATES times (lookahead's
    OPTIM_LOOKAHEAD_UPDATES) at the schedule's last warm-up steps: on the
    card over every trainable parameter
    (each update's host time, synchronised: the `step/optimizer` range's
    optimizer part; the first also makes the state), and in fp32 on the
    CPU over OPTIM_CPU_PARAMS, their changes compared."""
    per_step = attention_calls_per_step(trainer.config)
    for fn in KERNELS:
        fn.launches = 0
    trainer.step()
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in KERNELS}
    require_launches("optim_grads", launches, {"flash_attention_fwd_drop": per_step,
                                               "flash_attention_bwd_drop": per_step}, 1)
    named = {n: p for n, p in trainer.task.named_parameters() if p.requires_grad}
    grads = {n: p.grad.detach().clone() for n, p in named.items()}
    base = {n: p.detach().clone() for n, p in named.items()}
    spe = trainer.steps_per_epoch
    del named
    cpu_grads = {n: grads[n].cpu() for n in OPTIM_CPU_PARAMS}
    out = {"card": card, "launches": {k: launches[k] for k in (
        "flash_attention_fwd_drop", "flash_attention_bwd_drop")}, "rules": {}}
    for name in OPTIM_RULES:
        updates = (OPTIM_LOOKAHEAD_UPDATES if name.startswith("lookahead_")
                   else OPTIM_UPDATES)
        rule_cfg = load_config(TRAIN_OVERRIDES + [f"train.opt.name={name}"])
        gpu = {n: p.clone().requires_grad_() for n, p in base.items()}
        cpu = {n: base[n].cpu().clone().requires_grad_() for n in OPTIM_CPU_PARAMS}
        gopt, _ = create_optimizer(rule_cfg, gpu, spe)
        copt, _ = create_optimizer(rule_cfg, cpu, spe)
        times = []
        last = optim_warmup_end(TRAIN_OVERRIDES + [f"train.opt.name={name}"], spe)
        for t in range(last - updates + 1, last + 1):
            for n, p in gpu.items():
                p.grad = grads[n]
            for n, p in cpu.items():
                p.grad = cpu_grads[n]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gopt.step(t)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            copt.step(t)
        diffs, worst = {}, 0.0
        for n in OPTIM_CPU_PARAMS:
            b = base[n].cpu().double()
            got, want = gpu[n].detach().cpu().double() - b, cpu[n].detach().double() - b
            require(torch.isfinite(got).all(), f"optim {name} {n}: non-finite update")
            if name == "lion":
                agree = (torch.sign(got) == torch.sign(want)).double().mean().item()
                require(agree >= OPTIM_SIGN_AGREEMENT,
                        f"optim lion {n}: signs agree on {agree}")
                diffs[n] = agree
                continue
            bf = b.abs().float()
            spacing = (torch.nextafter(bf, torch.full_like(bf, math.inf)) - bf).double()
            limit = OPTIM_STEP_RTOL * want.abs().max() + 4 * spacing
            over = ((got - want).abs() - limit).max().item()
            diffs[n] = (got - want).abs().max().item()
            worst = max(worst, diffs[n] / max(want.abs().max().item(), 1e-30))
            require(over <= 0, f"optim {name} {n}: card and CPU steps {diffs[n]} apart")
        out["rules"][name] = {
            "updates": updates, "opt_ms": [x * 1e3 for x in times],
            "median_opt_ms": statistics.median(times[1:]) * 1e3,
            "max_abs_diff": diffs, "max_diff_of_largest_step": worst,
            "state_mib": sum(v.numel() * v.element_size() for st in gopt.torch.state.values()
                             for v in st.values() if isinstance(v, torch.Tensor)
                             and v.is_cuda) / 2**20}
        print(f"optim_{name}: " + json.dumps(out["rules"][name]), flush=True)
        del gopt, copt, gpu, cpu
        torch.cuda.empty_cache()
    return out


def optim_timed_phase(card: str, trainer: Trainer) -> dict:
    """OPTIM_TIMED_STEPS timed pretrain_mum steps of `trainer` (vlmo_base,
    batch 32) after a warm-up step, under each rule of OPTIM_TIMED in turn
    (the trainer's optimizer replaced by `create_optimizer` of the next
    rule), rows 3 and 4 counted at 54 a step."""
    per_step = attention_calls_per_step(trainer.config)
    named = {n: p for n, p in trainer.task.named_parameters() if p.requires_grad}
    out = {}
    for name in OPTIM_TIMED:
        trainer.state.optimizer, trainer.schedule = create_optimizer(
            load_config(TRAIN_OVERRIDES + [f"train.opt.name={name}"]), named,
            trainer.steps_per_epoch)
        trainer.step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        metrics, times, launches = run_counted(trainer, OPTIM_TIMED_STEPS, timed=True)
        expected = {"flash_attention_fwd_drop": per_step, "flash_attention_bwd_drop": per_step}
        require_launches(f"optim_train_{name}", launches, expected, OPTIM_TIMED_STEPS)
        out[name] = {"card": card, "median_ms_per_step": statistics.median(times) * 1e3,
                     "ms_per_step": [x * 1e3 for x in times],
                     "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
                     "launches_per_step": {k: launches[k] / OPTIM_TIMED_STEPS
                                           for k in expected},
                     "losses": [losses_of(m) for m in metrics]}
        print(f"optim_train_{name}: " + json.dumps(out[name]), flush=True)
    return out


def rule_updates(named: dict, before: dict, grads: dict, overrides: list[str], spe: int,
                 variants: tuple, gather) -> dict:
    """Each rule of OPTIM_TIMED applied once, at `optim_warmup_end`, to the
    gradients `grads` from the weights `before` (each trainable parameter's
    local piece), for each of `variants`: "whole", optax's leaf statistics
    (lamb's trust ratio, adafactor's row and column sums) added over the
    shards as the port adds them, or "local", each process's own shard's
    alone (`optim._leaf_sums` left unreduced: the fault a missing
    all-reduce would be, the control of the two-rank check).
    {rule: {variant: {name: the TWO_RANK_PARAMS parameter after, whole}}}."""
    from unittest import mock

    from exploremultimodal_torch.parallel.partitioning import local
    from exploremultimodal_torch.train import optim as optim_mod

    out: dict = {}
    for rule in OPTIM_TIMED:
        rule_overrides = overrides + [f"train.opt.name={rule}"]
        t = optim_warmup_end(rule_overrides, spe)
        for variant in variants:
            with torch.no_grad():
                for k, p in named.items():
                    local(p).copy_(before[k])
                    p.grad = grads[k]
            opt, _ = create_optimizer(load_config(rule_overrides), named, spe)
            with mock.patch.object(optim_mod, "_leaf_sums", lambda ps, parts: list(parts)) \
                    if variant == "local" else contextlib.nullcontext():
                opt.step(t)
            out.setdefault(rule, {})[variant] = {k: gather(named[k].detach()).clone()
                                                 for k in TWO_RANK_PARAMS}
            del opt
    return out


def update_gaps(got: dict, want: dict, before: dict) -> dict:
    """The two-rank update against one process's, per named parameter: the
    relative L2 of the difference, and the size of each fsdp shard's part
    (dim-0 halves) against one process's, |ratio - 1| at the worse half."""
    rel, size = {}, {}
    for k, w in want.items():
        b = before[k].double()
        dg, dw = got[k].double() - b, w.double() - b
        rel[k] = ((dg - dw).norm() / dw.norm()).item()
        size[k] = max(abs((g.norm() / x.norm()).item() - 1.0) for g, x in zip(
            dg.chunk(TWO_RANKS), dw.chunk(TWO_RANKS)) if x.norm() > 0)
    return {"rel_l2": rel, "size": size}


def optim_two_rank_reference(trainer: Trainer) -> dict:
    """The one-process side of phase 28's two-rank check, from `trainer`
    (OPTIM_OVERRIDES) before any other step: its weights, one batch with
    fixed ITM negatives and MIM labels, the step's losses and the named
    gradients, and each rule of OPTIM_TIMED applied whole to the step's
    gradients (`rule_updates`); then the trainer's parameters are put back
    and their gradients dropped, for the rest of the phase."""
    from exploremultimodal_torch.parallel.partitioning import local

    b = TRAIN_BATCH
    negatives = (torch.arange(1, b + 1) % b, torch.arange(b - 1, 2 * b - 1) % b)
    batch = trainer.next_batch()
    labels = trainer.model_batch(batch)["mim_labels"].cpu()
    weights = {k: v.cpu() for k, v in trainer.task.state_dict().items()}
    named = {k: p for k, p in trainer.task.named_parameters() if p.requires_grad}
    before = {k: p.detach().clone() for k, p in named.items()}
    m = trainer.step(batch, negatives=negatives, mim_labels=labels)
    grads = {k: p.grad.detach().clone() for k, p in named.items()}
    want = {"losses": losses_of(m),
            "grads": {k: grads[k].float().cpu() for k in TWO_RANK_PARAMS},
            "params": rule_updates(named, before, grads, OPTIM_OVERRIDES,
                                   trainer.steps_per_epoch, ("whole",),
                                   lambda t: t.float().cpu())}
    with torch.no_grad():
        for k, p in named.items():
            local(p).copy_(before[k])
            p.grad = None
    return {"want": want, "weights": weights, "batch": batch, "negatives": negatives,
            "labels": labels}


def optim_two_rank_phase(card: str, probe: dict, tmp: str, ref: dict) -> dict:
    """lamb and adafactor at fsdp on two gloo ranks of this script on the
    one card (2 x 16 rows; `two_rank_child`, one pair of ranks for both
    rules) against one process at 32 on the same weights, batch, ITM
    negatives and MIM labels (hidden dropout and DropPath off): losses
    within LOSS_RTOL, the named gradients within GRAD_REL_TOL; each rule
    applied to the step's gradients (`rule_updates`), the update held to
    one process's within OPTIM_TWO_RANK_REL_L2 (relative L2) and the
    rule's OPTIM_TWO_RANK_SIZE (each shard's part's size), and the control
    (the leaf statistics of each shard alone) required outside them; the
    one process's side is `ref` (`optim_two_rank_reference`). Where gloo
    cannot run fsdp's collectives on CUDA tensors, says why."""
    gloo = probe["gloo"] if isinstance(probe["gloo"], dict) else {}
    ops = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor")
    if not all(gloo.get(o) == "ok" for o in ops):
        why = f"gloo on CUDA tensors: { {o: gloo.get(o) for o in ops} }"
        print(f"optim_two_rank: left to the CPU tests (tests/test_torch_port_optim_ranks.py): "
              f"{why}", flush=True)
        return {"ran": [], "why": why, "card": card}
    want, weights = ref["want"], ref["weights"]
    torch.save({"overrides": OPTIM_OVERRIDES, "weights": weights, "batch": ref["batch"],
                "negatives": ref["negatives"], "mim_labels": ref["labels"], "rules": True},
               os.path.join(tmp, "in.pt"))
    t0 = time.perf_counter()
    port = free_port()
    require_ranks(spawn_ranks([["--two-rank", str(r), str(port), "fsdp", tmp]
                               for r in range(TWO_RANKS)], 600),
                  [f"optim_two_rank rank {r}" for r in range(TWO_RANKS)])
    out = {"ran": list(OPTIM_TIMED), "card": card, "s": time.perf_counter() - t0}
    got = [torch.load(os.path.join(tmp, f"out_fsdp_{r}.pt")) for r in range(TWO_RANKS)]
    res = {"losses_two_one": {k: (got[0]["losses"][k], w) for k, w in want["losses"].items()},
           "grad_rel_err": {k: ((got[0]["grads"][k] - w).norm() / w.norm()).item()
                            for k, w in want["grads"].items()}}
    for k, (g, w) in res["losses_two_one"].items():
        require(abs(g - w) <= LOSS_RTOL * abs(w) + 1e-3,
                f"optim_two_rank {k}: two ranks {g} against one {w}")
        require(got[1]["losses"][k] == g, f"optim_two_rank {k}: the ranks disagree")
    require(max(res["grad_rel_err"].values()) <= GRAD_REL_TOL,
            f"optim_two_rank: gradients {res['grad_rel_err']}")
    start = {k: weights[k].float() for k in TWO_RANK_PARAMS}
    for rule in OPTIM_TIMED:
        whole = want["params"][rule]["whole"]
        gaps = {v: update_gaps(got[0]["updates"][rule][v], whole, start)
                for v in ("whole", "local")}
        res[rule] = gaps
        print(f"optim_two_rank_{rule}: " + json.dumps(
            {**gaps, "grad_rel_err": res["grad_rel_err"],
             "losses_two_one": res["losses_two_one"]}), flush=True)
    for rule in OPTIM_TIMED:
        gaps = res[rule]
        size = OPTIM_TWO_RANK_SIZE[rule]
        require(max(gaps["whole"]["rel_l2"].values()) <= OPTIM_TWO_RANK_REL_L2
                and max(gaps["whole"]["size"].values()) <= size,
                f"optim_two_rank {rule}: the update {gaps['whole']} against one process's")
        require(max(gaps["local"]["rel_l2"].values()) > OPTIM_TWO_RANK_REL_L2
                or max(gaps["local"]["size"].values()) > size,
                f"optim_two_rank {rule}: the control (each shard's own leaf statistics) "
                f"passes: {gaps['local']}")
    out.update(res)
    return out


def optim_phase(card: str, dev, probe: dict | None = None) -> dict:
    """Phase 28 on one trainer (OPTIM_OVERRIDES): the two-rank check's
    one-process step, every rule on a step's gradients, card against CPU;
    lamb's and adafactor's timed steps; both at fsdp on two gloo ranks."""
    t0 = time.perf_counter()
    trainer = Trainer(load_config(OPTIM_OVERRIDES), device="cuda")
    ref = optim_two_rank_reference(trainer)
    out = {"rules": optim_rules_phase(card, trainer)}
    elapsed("phase 28 rules")
    out["timed"] = optim_timed_phase(card, trainer)
    del trainer
    torch.cuda.empty_cache()
    elapsed("phase 28 timed steps")
    tmp = tempfile.mkdtemp(prefix="emm_optim_")
    try:
        out["two_rank"] = optim_two_rank_phase(card, probe or probe_two_ranks(tmp), tmp, ref)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 28: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def optim_only(card: str, dev) -> int:
    """The build, then phase 28 alone (`--optim`)."""
    optim_phase(card, dev)
    return 0


# ---- phase 29: int8 under tensor parallelism
TP_INT8_HIDDEN = 2  # hidden shares: 1,536 of 3,072 columns


def int_mm_rows_at(x, qw, sw, amax):
    """Row 8's partial mode through `torch._int_mm` and PyTorch ops."""
    qx, sx = row_quant(x.float(), amax)
    return torch._int_mm(qx, qw.T).float() * sx * sw


def int_mm_mlp_split(x, qw1, sw1, b1, qw2, sw2, amax, bits=None, t=0):
    """Rows 9/10's split mode through `torch._int_mm` and PyTorch ops: both
    passes' work, the hidden once."""
    qx, sx = row_quant(x.float())
    h = F.gelu(torch._int_mm(qx, qw1.T).float() * sx * sw1 + b1, approximate="tanh")
    if bits is not None:
        h = torch.where(keep16(bits, t), h * keep_scale16(t), 0.0)
    qh, sh = row_quant(h, torch.maximum(h.abs().amax(1), amax))
    return torch._int_mm(qh, qw2.T).float() * sh * sw2


def check_tp_int8_matmul(cfg: VlmoConfig, dev) -> list[dict]:
    """Row 8 at the tensor shares of the finetune_vqa step's M: proj's row
    share (K 384) in the partial mode (x's rows at their absmax over the
    whole K, the weight's channels at theirs) bit for bit with its plain
    version, the two shares summed against the whole plain call within a
    bf16 ulp (W8A8_ATOL, W8A8_RTOL); qkv's column share (N 1,152: heads 6
    of 12 of each of q, k, v) in the whole mode bit for bit, and equal to
    the whole call's columns. Each timed beside the whole kernel, its plain
    version and the `torch._int_mm` chain on the share."""
    g = torch.Generator(device=dev).manual_seed(29)
    k = cfg.embed_dim
    half = k // TP
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    w = (torch.randn((k, k), generator=g, device=dev) * 0.02).to(torch.bfloat16)
    wq = (torch.randn((3 * k, k), generator=g, device=dev) * 0.02).to(torch.bfloat16)
    qw, sw = quantize_weights(w)
    qkv_rows = torch.cat([torch.arange(j * k, j * k + half, device=dev) for j in range(3)])
    qwq, swq = quantize_weights(wq)
    qwq_t, swq_t = quantize_weights(wq[qkv_rows].contiguous())
    require(torch.equal(qwq_t, qwq[qkv_rows]) and torch.equal(swq_t, swq[qkv_rows]),
            "qkv's column share: codes differ from the whole call's rows")
    wmax = w.float().abs().amax(1)
    rows = []
    for m in vqa_mlp_rows(cfg):
        x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
        amax = x.float().abs().amax(1)
        shares = []
        for r in range(TP):
            cols = slice(r * half, (r + 1) * half)
            qw_t, sw_t = quantize_weights(w[:, cols].contiguous(), wmax)
            require(torch.equal(qw_t, qw[:, cols]) and torch.equal(sw_t, sw),
                    "proj's row share: codes differ from the whole call's columns")
            shares.append((x[:, cols].contiguous(), qw_t.contiguous(), sw_t, amax))
        parts = [w8a8_matmul_partial(*a) for a in shares]
        refs = [w8a8_matmul_partial_plain(*a) for a in shares]
        whole = w8a8_matmul_plain(x, qw, sw)
        torch.cuda.synchronize()
        exact = all(torch.equal(p_, r_) for p_, r_ in zip(parts, refs))
        err = max((p_ - r_).abs().max().item() for p_, r_ in zip(parts, refs))
        summed = (parts[0] + parts[1]).to(torch.bfloat16)
        sum_ok, sum_err = within(summed, whole, W8A8_ATOL, W8A8_RTOL)
        require(exact and sum_ok and parts[0].dtype == torch.float32,
                f"w8a8_matmul_partial M={m}: max|err| {err}, summed {sum_err}")
        a0 = shares[0]
        nbytes = 2 * m * half + k * half + 4 * k + 4 * m + 4 * m * k
        bound_ms, bound_by = bound(nbytes, 2 * m * half * k, PEAK_INT8_OPS)
        rows.append({
            "name": "w8a8_matmul_partial", "shape": f"M={m} K={half} of {k} N={k}",
            "tensor": TP, "grid": list(matmul_grid(m, k, sms)), "max_abs_err": err,
            "summed_err": sum_err, "ms": time_ms(lambda: w8a8_matmul_partial(*a0)),
            "whole_ms": time_ms(lambda: w8a8_matmul(x, qw, sw)),
            "plain_ms": time_ms(lambda: w8a8_matmul_partial_plain(*a0), iters=5),
            "library_ms": time_ms(lambda: int_mm_rows_at(*a0)),
            "bound_ms": bound_ms, "bound_by": bound_by})
        yq = w8a8_matmul(x, qwq_t, swq_t)
        refq = w8a8_matmul_plain(x, qwq_t, swq_t)
        torch.cuda.synchronize()
        require(torch.equal(yq, refq) and torch.equal(yq, w8a8_matmul_plain(x, qwq, swq)[
            :, qkv_rows]), f"w8a8_matmul qkv share M={m}: not the whole call's columns")
        nbytes = 2 * m * k + 3 * half * k + 4 * 3 * half + 2 * m * 3 * half
        bound_ms, bound_by = bound(nbytes, 2 * m * k * 3 * half, PEAK_INT8_OPS)
        rows.append({
            "name": "w8a8_matmul", "shape": f"M={m} K={k} N={3 * half} of {3 * k}",
            "tensor": TP, "grid": list(matmul_grid(m, 3 * half, sms)), "max_abs_err": 0.0,
            "ms": time_ms(lambda: w8a8_matmul(x, qwq_t, swq_t)),
            "whole_ms": time_ms(lambda: w8a8_matmul(x, qwq, swq)),
            "plain_ms": time_ms(lambda: w8a8_matmul_plain(x, qwq_t, swq_t), iters=5),
            "library_ms": time_ms(lambda: int_mm_rows(x, qwq_t, swq_t)),
            "bound_ms": bound_ms, "bound_by": bound_by})
    return rows


def check_tp_int8_mlp(cfg: VlmoConfig, dev) -> list[dict]:
    """Rows 9 and 10's split mode on the hidden's TP_INT8_HIDDEN shares at
    the finetune_vqa step's M (row 10 at its threshold): each share's first
    launch's row absmax within W8A8_RTOL of its plain version's, the shares'
    maxima (the all-reduce-max, done here in one process) giving each
    share's second launch, whose fp32 partial output is held against its
    plain version at the global absmax, and the shares summed plus b2
    against the whole plain MLP (W8A8_ATOL, W8A8_RTOL). Share 0 timed
    beside the whole kernel at hidden 3,072, its plain versions and the
    `torch._int_mm` chain on the share."""
    g, (w1, w2), (qw1, sw1, b1, qw2, sw2, b2) = w8a8_mlp_weights(cfg, dev, 29)
    k, h, n_out = w1.shape[1], w1.shape[0], w2.shape[0]
    hs = h // TP_INT8_HIDDEN
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    w2max = w2.float().abs().amax(1)
    rows = []
    for drop in (False, True):
        t = TP_MLP_THRESHOLD if drop else 0
        split = w8a8_mlp_fwd_drop_split if drop else w8a8_mlp_fwd_split
        whole_kernel = w8a8_mlp_fwd_drop if drop else w8a8_mlp_fwd
        whole_plain = w8a8_mlp_fwd_drop_plain if drop else w8a8_mlp_fwd_plain
        for m in vqa_mlp_rows(cfg):
            x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
            bits = (torch.randint(-32768, 32768, (m, h), dtype=torch.int16, generator=g,
                                  device=dev) if drop else None)
            extra = (bits, t) if drop else ()
            whole_args = (x, qw1, sw1, b1, qw2, sw2, b2) + extra
            whole = whole_plain(*whole_args)
            shares = []
            for r in range(TP_INT8_HIDDEN):
                cols = slice(r * hs, (r + 1) * hs)
                qw2_t, sw2_t = quantize_weights(w2[:, cols].float().contiguous(), w2max)
                require(torch.equal(qw2_t, qw2[:, cols]) and torch.equal(sw2_t, sw2),
                        "the hidden's share: qW2's codes differ from the whole call's")
                shares.append(((x, qw1[cols].contiguous(), sw1[cols].contiguous(),
                                b1[cols].contiguous(), qw2_t.contiguous(), sw2_t),
                               None if bits is None else bits[:, cols].contiguous()))
            plain_amax = [w8a8_mlp_amax_plain(*a[:4], b, t) for a, b in shares]
            amax = torch.stack(plain_amax).amax(0)
            seen = []

            def reduce_max(a):  # the all-reduce-max, the other shares' from plain
                seen.append(a.clone())
                return torch.maximum(a, amax, out=a)

            parts = [split(*a, *((b, t) if drop else ()), reduce_max) for a, b in shares]
            refs = [w8a8_mlp_partial_plain(*a, amax, b, t) for a, b in shares]
            torch.cuda.synchronize()
            amax_ok = all(within(s_, p_, 0.0, W8A8_RTOL)[0] for s_, p_ in zip(seen, plain_amax))
            errs = [within(p_, r_, W8A8_ATOL, W8A8_RTOL) for p_, r_ in zip(parts, refs)]
            summed = (torch.stack(parts).sum(0) + b2).to(torch.bfloat16)
            sum_ok, sum_err = within(summed, whole, W8A8_ATOL, W8A8_RTOL)
            require(amax_ok and all(ok for ok, _ in errs) and sum_ok,
                    f"{split.__name__} M={m}: absmax {amax_ok}, max|err| "
                    f"{[e for _, e in errs]}, summed {sum_err}")
            a0, bits0 = shares[0]
            ex0 = (bits0, t) if drop else ()

            def no_reduce(a):
                return torch.maximum(a, amax, out=a)

            nbytes = (2 * m * k + hs * k + n_out * hs + 8 * hs + 4 * n_out + 4 * m * n_out
                      + 8 * m + (2 * m * hs if drop else 0))
            bound_ms, bound_by = bound(nbytes, 2 * m * (k * hs + hs * n_out), PEAK_INT8_OPS)
            rows.append({
                "name": split.__name__, "threshold": t,
                "shape": f"M={m} K={k} H={hs} of {h} N={n_out}", "tensor": TP_INT8_HIDDEN,
                "grid": [mlp_grid(m, mlp_splits(m, hs, sms)), mlp_splits(m, hs, sms)],
                "max_abs_err": max(e for _, e in errs), "summed_err": sum_err,
                "ms": time_ms(lambda: split(*a0, *ex0, no_reduce)),
                "whole_ms": time_ms(lambda: whole_kernel(*whole_args)),
                "plain_ms": time_ms(lambda: (w8a8_mlp_amax_plain(*a0[:4], *ex0),
                                             w8a8_mlp_partial_plain(*a0, amax, *ex0)), iters=5),
                "library_ms": time_ms(lambda: int_mm_mlp_split(*a0, amax, *ex0)),
                "bound_ms": bound_ms, "bound_by": bound_by})
    return rows


def tp_int8_phase(card: str, dev) -> dict:
    """Phase 29: rows 8-10's split modes at the tensor shares, then the
    int8 finetune_vqa step on two tensor ranks against one process, and
    their checkpoint read in one process."""
    t0 = time.perf_counter()
    vqa_cfg = VlmoConfig.from_config(load_config(VQA_OVERRIDES))
    out = {"matmul": check_tp_int8_matmul(vqa_cfg, dev), "mlp": check_tp_int8_mlp(vqa_cfg, dev)}
    for row in out["matmul"] + out["mlp"]:
        print("kernel_tp_int8: " + json.dumps(row), flush=True)
    elapsed("phase 29 kernels")
    tmp = tempfile.mkdtemp(prefix="emm_tp_int8_")
    try:
        out["vqa_w8"] = tp_step_phase(card, "vqa_w8", tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 29: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def tp_int8_only(card: str, dev) -> int:
    """The build, then phase 29 alone (`--tp-int8`)."""
    tp_int8_phase(card, dev)
    return 0


# ---- phase 30: the presets' widths on the card's kernels
# vlmo_large (K = 1,024, 16 heads, 24 layers) on its documented pretraining
# scale (the JAX package's `vlmo_large_pretrain` bench, batch 16) with its
# bf16 MLP on the erf chain (`fits_vmem` rejects 1,024 / 4,096 there, as in
# JAX), int8 (`w8a8_pallas`) serving and finetune_vqa on rows 8, 9 and 10 at
# its widths; vlmo_tiny and vlmo_small (K = 192 and 384) serving and
# finetune_vqa on rows 6 and 7 (`mlp_impl=fused`)
LARGE_TRAIN_BATCH = 16
LARGE_TRAIN_OVERRIDES = [
    "model=vlmo_large", "train=pretrain_mum", "compute_dtype=bfloat16",
    "train.datasets=[synthetic]", "train.discrete_vae_type=random",
    f"data.batch_size={LARGE_TRAIN_BATCH}", "model.mlp_impl=xla",
]
# the batch-2 step against the CPU at vlmo_base's LayerScale: at the
# preset's 1e-5 every block's output is scaled to nothing, the batch's ITC
# features agree to 3e-6 relative, the ITC loss sits at ln 2 and
# itc_temp's gradient is fp32 noise (2e-8 on the card, -7e-9 on the CPU,
# against a closed form of 4.5e-10, on an H100), and the check
# would hold the blocks' kernels to nothing
LARGE_CHECK = ["model.init_values=0.1"]
NARROW_PRESETS = ("vlmo_tiny", "vlmo_small")
# row 8's tensor shares: qkv's columns (N = 3 K / T, the whole mode) and
# proj's rows (K / T, the partial mode) of vlmo_base and vlmo_large at T =
# 2 and 4
SHARE_WIDTHS, SHARE_AXES = (768, 1024), (2, 4)
# rows 9 and 10 split over two shares of the hidden (2,048 of 4,096 at
# vlmo_large)
HIDDEN_SHARES = 2


def preset_overrides(overrides: list[str], model: str, *extra: str) -> list[str]:
    """`overrides` with their model group replaced by `model`."""
    return [f"model={model}" if o.startswith("model=") else o for o in overrides] + list(extra)


def at_last_block(names, depth: int) -> tuple:
    """vlmo_base's parameter names of its last block (11) at a preset of
    `depth` blocks."""
    return tuple(n.replace("transformer.blocks.11.", f"transformer.blocks.{depth - 1}.")
                 for n in names)


def width_weights(g, dev, k: int, h: int, dtype=torch.bfloat16):
    """Seeded (w1 (h, k), b1, w2 (k, h), b2): weights in `dtype`, fp32
    biases, at the MLP widths of a preset."""
    w1 = (torch.randn((h, k), generator=g, device=dev) * 0.02).to(dtype)
    w2 = (torch.randn((k, h), generator=g, device=dev) * 0.02).to(dtype)
    b1 = torch.randn(h, generator=g, device=dev) * 0.02
    b2 = torch.randn(k, generator=g, device=dev) * 0.02
    return w1, b1, w2, b2


def check_widths_bf16_mlp(dev, models=NARROW_PRESETS, seed: int = 30) -> list[dict]:
    """Rows 6 and 7 at the widths of `models` (by default vlmo_tiny's and
    vlmo_small's, K = N = 192 and 384, hidden 4x): row 6 at the serving M
    of a batch-64 request, row 7 at the finetune_vqa step's M (threshold of
    drop_rate 0.1), each against its plain version within MLP_ATOL /
    MLP_RTOL and timed beside it and the library chain (bf16 linear, tanh
    gelu[, where], linear)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    t = MLP_DROP_THRESHOLDS[-1]
    rows = []
    for model in models:
        cfg = VlmoConfig.from_config(load_config([f"model={model}"]))
        k, h = cfg.embed_dim, int(cfg.embed_dim * cfg.mlp_ratio)
        w1, b1, w2, b2 = width_weights(g, dev, k, h)
        b1h, b2h = b1.to(torch.bfloat16), b2.to(torch.bfloat16)
        for name, ms in (("fused_mlp_fwd", serve_rows(cfg)), ("fused_mlp_fwd_drop",
                                                            vqa_mlp_rows(cfg))):
            drop = name == "fused_mlp_fwd_drop"
            kern = fused_mlp_fwd_drop if drop else fused_mlp_fwd
            plain = fused_mlp_fwd_drop_plain if drop else fused_mlp_fwd_plain
            for m in ms:
                x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
                bits = torch.randint(-32768, 32768, (m, h), dtype=torch.int16, generator=g,
                                     device=dev)
                extra = (bits, t) if drop else ()
                y, ref = kern(x, w1, b1, w2, b2, *extra), plain(x, w1, b1, w2, b2, *extra)
                torch.cuda.synchronize()
                ok, err = within(y, ref, MLP_ATOL, MLP_RTOL)
                require(ok, f"{name} {model} M={m}: max|err| {err} beyond atol {MLP_ATOL} "
                        f"+ rtol {MLP_RTOL}")

                def library():
                    hh = F.gelu(F.linear(x, w1, b1h), approximate="tanh")
                    if drop:
                        hh = torch.where(keep16(bits, t), hh * keep_scale16(t), 0.0)
                    return F.linear(hh, w2, b2h)

                nbytes = (2 * (m * k + h * k + k * h + m * k) + 4 * (h + k)
                          + (2 * m * h if drop else 0))
                bound_ms, bound_by = bound(nbytes, 2 * m * 2 * k * h)
                rows.append({
                    "name": name, "model": model, "shape": f"M={m} K={k} H={h} N={k}",
                    "threshold": t if drop else 0,
                    "hidden_splits": hidden_splits(m, h, sms), "max_abs_err": err,
                    "ms": time_ms(lambda: kern(x, w1, b1, w2, b2, *extra)),
                    "plain_ms": time_ms(lambda: plain(x, w1, b1, w2, b2, *extra), iters=5),
                    "library_ms": time_ms(library),
                    "bound_ms": bound_ms, "bound_by": bound_by})
                del x, bits, y, ref
    return rows


def check_widths_matmul(dev) -> list[dict]:
    """Row 8 bit for bit against its plain version: vlmo_large's qkv (1,024
    -> 3,072) and proj (1,024 -> 1,024) at the serving M of a batch-64
    request, vlmo_tiny's and vlmo_small's at the largest one; then the
    tensor shares of vlmo_base and vlmo_large at T = 2 and 4 at the
    finetune_vqa step's largest M: qkv's columns in the whole mode (N 3 K /
    T: 576 at vlmo_base and T = 4, a 64-column tail) equal to the whole
    call's columns, proj's rows (K / T, down to 192) in the partial mode at
    the rows' absmax over the whole K, the shares summed against the whole
    plain call within a bf16 ulp. Each timed beside its plain version, the
    `torch._int_mm` chain (`library_ms`) and the bf16 linear."""
    g = torch.Generator(device=dev).manual_seed(31)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []

    def timed(name, model, shape, x, qw, sw, w, on_path, amax=None):
        m, k = x.shape
        n = qw.shape[0]
        partial = amax is not None
        kern, plain = ((lambda: w8a8_matmul_partial(x, qw, sw, amax)),
                       (lambda: w8a8_matmul_partial_plain(x, qw, sw, amax))) if partial else (
            (lambda: w8a8_matmul(x, qw, sw)), (lambda: w8a8_matmul_plain(x, qw, sw)))
        y, ref = kern(), plain()
        torch.cuda.synchronize()
        err = (y.float() - ref.float()).abs().max().item()
        require(torch.equal(y, ref), f"{name} {shape}: max|err| {err}, not bit for bit "
                "with its plain version")
        nbytes = 2 * m * k + n * k + 4 * n + (4 * m + 4 * m * n if partial else 2 * m * n)
        bound_ms, bound_by = bound(nbytes, 2 * m * k * n, PEAK_INT8_OPS)
        rows.append({
            "name": name, "model": model, "shape": shape, "on_path": on_path,
            "grid": list(matmul_grid(m, n, sms)), "max_abs_err": err,
            "ms": time_ms(kern), "plain_ms": time_ms(plain, iters=5),
            "library_ms": time_ms((lambda: int_mm_rows_at(x, qw, sw, amax)) if partial
                                  else (lambda: int_mm_rows(x, qw, sw))),
            "bf16_ms": time_ms(lambda: F.linear(x, w)),
            "bound_ms": bound_ms, "bound_by": bound_by})
        return y

    for model in ("vlmo_large",) + NARROW_PRESETS:
        cfg = VlmoConfig.from_config(load_config([f"model={model}"]))
        k = cfg.embed_dim
        ms = serve_rows(cfg) if model == "vlmo_large" else serve_rows(cfg)[-1:]
        for n in (k, 3 * k):
            w = (torch.randn((n, k), generator=g, device=dev) * 0.02).to(torch.bfloat16)
            qw, sw = quantize_weights(w)
            for m in ms:
                x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
                timed("w8a8_matmul", model, f"M={m} K={k} N={n}", x, qw, sw, w,
                      model == "vlmo_large")
    m = vqa_mlp_rows(VlmoConfig.from_config(load_config(VQA_OVERRIDES)))[-1]
    for k in SHARE_WIDTHS:
        model = "vlmo_base" if k == 768 else "vlmo_large"
        x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
        amax = x.float().abs().amax(1)
        wq = (torch.randn((3 * k, k), generator=g, device=dev) * 0.02).to(torch.bfloat16)
        w = (torch.randn((k, k), generator=g, device=dev) * 0.02).to(torch.bfloat16)
        whole_q = w8a8_matmul_plain(x, *quantize_weights(wq))
        qw, sw = quantize_weights(w)
        whole = w8a8_matmul_plain(x, qw, sw)
        wmax = w.float().abs().amax(1)
        for t in SHARE_AXES:
            part = k // t
            cols = torch.cat([torch.arange(j * k, j * k + part, device=dev) for j in range(3)])
            wq_t = wq[cols].contiguous()
            yq = timed("w8a8_matmul", model, f"qkv share M={m} K={k} N={3 * part} of {3 * k} "
                       f"T={t}", x, *quantize_weights(wq_t), wq_t, False)
            require(torch.equal(yq, whole_q[:, cols]),
                    f"qkv share K={k} T={t}: not the whole call's columns")
            parts = []
            for r in range(t):
                sl = slice(r * part, (r + 1) * part)
                w_t = w[:, sl].contiguous()
                qw_t, sw_t = quantize_weights(w_t, wmax)
                x_t = x[:, sl].contiguous()
                if r == 0:  # timed; the other shares checked alone
                    parts.append(timed("w8a8_matmul_partial", model,
                                       f"proj share M={m} K={part} of {k} N={k} T={t}",
                                       x_t, qw_t, sw_t, w_t, False, amax))
                    continue
                parts.append(w8a8_matmul_partial(x_t, qw_t, sw_t, amax))
                require(torch.equal(parts[-1], w8a8_matmul_partial_plain(x_t, qw_t, sw_t, amax)),
                        f"proj share {r} K={k} T={t}: not bit for bit with its plain version")
            ok, err = within(torch.stack(parts).sum(0).to(torch.bfloat16), whole,
                             W8A8_ATOL, W8A8_RTOL)
            require(ok, f"proj shares K={k} T={t}: summed {err} from the whole call")
            rows[-1]["summed_err"] = err
        del x, whole, whole_q
    return rows


def check_widths_w8a8_mlp(dev) -> list[dict]:
    """Rows 9 and 10 at every width of MLP_WIDTHS but vlmo_base's 768 (K =
    N = 1,024 at vlmo_large, 192 and 384 at vlmo_tiny and vlmo_small,
    hidden 4x), bit for bit with their plain versions: row 9 at the serving
    M of a batch-64 request, row 10 at the finetune_vqa step's M (threshold
    of drop_rate 0.1), every M at vlmo_large and the smallest and largest
    (a cluster pair splitting the hidden, and none) at the narrow widths;
    then their split modes on HIDDEN_SHARES shares (hidden 2,048 at
    vlmo_large) at the step's largest M: each share's row absmax equal to
    its plain version's, their maximum giving each share's fp32 partial
    output, equal to its plain version's, the shares summed plus b2
    against the whole plain call (W8A8_ATOL, W8A8_RTOL). Each timed beside
    its plain version, the `torch._int_mm` chain and the bf16 chain."""
    g = torch.Generator(device=dev).manual_seed(32)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    t = MLP_DROP_THRESHOLDS[-1]
    rows = []
    for model in ("vlmo_large",) + NARROW_PRESETS:
        cfg = VlmoConfig.from_config(load_config([f"model={model}"]))
        k, h = cfg.embed_dim, int(cfg.embed_dim * cfg.mlp_ratio)
        require(k in MLP_WIDTHS and k != 768, f"{model}: width {k}")
        large = model == "vlmo_large"
        rows += w8a8_mlp_width_rows(g, dev, sms, t, model, k, h, large,
                                    serve_rows(cfg) if large else serve_rows(cfg)[::2],
                                    vqa_mlp_rows(cfg) if large else vqa_mlp_rows(cfg)[::2],
                                    vqa_mlp_rows(cfg)[-1])
    return rows


def w8a8_mlp_width_rows(g, dev, sms: int, t: int, model: str, k: int, h: int,
                        on_path: bool, serve_ms, step_ms, split_m: int) -> list[dict]:
    """check_widths_w8a8_mlp at one preset's widths (K = N = k, hidden h):
    rows 9 at `serve_ms`, 10 at `step_ms`, and both split at `split_m`."""
    w1, b1, w2, b2 = width_weights(g, dev, k, h, torch.float32)
    args = (*quantize_weights(w1), b1, *quantize_weights(w2), b2)
    w1h, w2h, b1h, b2h = w1.to(torch.bfloat16), w2.to(torch.bfloat16), b1.bfloat16(), b2.bfloat16()
    rows = []
    for name, ms in (("w8a8_mlp_fwd", serve_ms), ("w8a8_mlp_fwd_drop", step_ms)):
        drop = name == "w8a8_mlp_fwd_drop"
        kern = w8a8_mlp_fwd_drop if drop else w8a8_mlp_fwd
        plain = w8a8_mlp_fwd_drop_plain if drop else w8a8_mlp_fwd_plain
        for m in ms:
            x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
            bits = torch.randint(-32768, 32768, (m, h), dtype=torch.int16, generator=g,
                                 device=dev)
            extra = (bits, t) if drop else ()
            y, ref = kern(x, *args, *extra), plain(x, *args, *extra)
            torch.cuda.synchronize()
            err = (y.float() - ref.float()).abs().max().item()
            require(torch.equal(y, ref), f"{name} {model} M={m}: max|err| {err}, not bit "
                    "for bit with its plain version")

            def bf16_chain():
                hh = F.gelu(F.linear(x, w1h, b1h), approximate="tanh")
                if drop:
                    hh = torch.where(keep16(bits, t), hh * keep_scale16(t), 0.0)
                return F.linear(hh, w2h, b2h)

            nbytes = 2 * m * k + 2 * h * k + 8 * (h + k) + 2 * m * k + (2 * m * h if drop else 0)
            bound_ms, bound_by = bound(nbytes, 2 * m * 2 * k * h, PEAK_INT8_OPS)
            splits = mlp_splits(m, h, sms)
            rows.append({
                "name": name, "model": model, "shape": f"M={m} K={k} H={h} N={k}",
                "on_path": on_path, "threshold": t if drop else 0,
                "parts": mlp_layout(k)["parts"], "grid": [mlp_grid(m, splits), splits],
                "max_abs_err": err,
                "ms": time_ms(lambda: kern(x, *args, *extra)),
                "plain_ms": time_ms(lambda: plain(x, *args, *extra), iters=5),
                "library_ms": time_ms(lambda: int_mm_mlp(x, *args, *extra)),
                "bf16_ms": time_ms(bf16_chain), "bound_ms": bound_ms, "bound_by": bound_by})
            del x, bits, y, ref
    m, hs = split_m, h // HIDDEN_SHARES
    qw1, sw1 = args[:2]
    w2max = w2.abs().amax(1)
    for drop in (False, True):
        x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
        bits = torch.randint(-32768, 32768, (m, h), dtype=torch.int16, generator=g, device=dev)
        split = w8a8_mlp_fwd_drop_split if drop else w8a8_mlp_fwd_split
        shares = []
        for r in range(HIDDEN_SHARES):
            cols = slice(r * hs, (r + 1) * hs)
            qw2_t, sw2_t = quantize_weights(w2[:, cols].contiguous(), w2max)
            ex = (bits[:, cols].contiguous(), t) if drop else ()
            shares.append(((x, qw1[cols].contiguous(), sw1[cols].contiguous(),
                            b1[cols].contiguous(), qw2_t, sw2_t), ex))
        plain_amax = [w8a8_mlp_amax_plain(*a[:4], *ex) for a, ex in shares]
        amax = torch.stack(plain_amax).amax(0)
        seen = []

        def reduce_max(a):
            seen.append(a.clone())
            return torch.maximum(a, amax, out=a)

        parts = [split(*a, *ex, reduce_max) for a, ex in shares]
        refs = [w8a8_mlp_partial_plain(*a, amax, *ex) for a, ex in shares]
        torch.cuda.synchronize()
        exact = (all(torch.equal(s_, p_) for s_, p_ in zip(seen, plain_amax))
                 and all(torch.equal(p_, r_) for p_, r_ in zip(parts, refs)))
        err = max((p_ - r_).abs().max().item() for p_, r_ in zip(parts, refs))
        whole = (w8a8_mlp_fwd_drop_plain(x, *args, bits, t) if drop
                 else w8a8_mlp_fwd_plain(x, *args))
        sum_ok, sum_err = within((torch.stack(parts).sum(0) + b2).to(torch.bfloat16), whole,
                                 W8A8_ATOL, W8A8_RTOL)
        require(exact and sum_ok, f"{split.__name__} {model} M={m}: exact {exact}, "
                f"max|err| {err}, summed {sum_err}")
        a0, ex0 = shares[0]

        def no_reduce(a):
            return torch.maximum(a, amax, out=a)

        nbytes = (2 * m * k + 2 * hs * k + 8 * hs + 4 * k + 4 * m * k + 8 * m
                  + (2 * m * hs if drop else 0))
        bound_ms, bound_by = bound(nbytes, 2 * m * 2 * k * hs, PEAK_INT8_OPS)
        splits = mlp_splits(m, hs, sms)
        rows.append({
            "name": split.__name__, "model": model,
            "shape": f"M={m} K={k} H={hs} of {h} N={k}",
            "threshold": t if drop else 0, "tensor": HIDDEN_SHARES,
            "grid": [mlp_grid(m, splits), splits], "max_abs_err": err, "summed_err": sum_err,
            "ms": time_ms(lambda: split(*a0, *ex0, no_reduce)),
            "plain_ms": time_ms(lambda: (w8a8_mlp_amax_plain(*a0[:4], *ex0),
                                         w8a8_mlp_partial_plain(*a0, amax, *ex0)), iters=5),
            "library_ms": time_ms(lambda: int_mm_mlp_split(*a0, amax, *ex0)),
            "bound_ms": bound_ms, "bound_by": bound_by})
        del x, bits, parts, refs, whole
    return rows


def widths_phase(card: str, dev) -> dict:
    """Phase 30: rows 6-10 at the presets' widths against their plain
    versions; vlmo_large pretrain_mum at batch 16 (rows 3 and 4, the MLP on
    the erf chain) with a batch-2 step against the CPU; vlmo_large int8
    serving and finetune_vqa (rows 8, 9 and 10); vlmo_tiny and vlmo_small
    serving and finetune_vqa through rows 6 and 7, each held against the
    CPU as phases 4 and 9-12 hold vlmo_base. Returns the kernel rows and
    each path's launches."""
    t0 = time.perf_counter()
    out = {"bf16_mlp": check_widths_bf16_mlp(dev), "matmul": check_widths_matmul(dev),
           "w8a8_mlp": check_widths_w8a8_mlp(dev)}
    for row in out["bf16_mlp"] + out["matmul"] + out["w8a8_mlp"]:
        print("kernel_widths: " + json.dumps(row), flush=True)
    elapsed("phase 30 kernels")

    large = load_config(LARGE_TRAIN_OVERRIDES)
    large_cfg = VlmoConfig.from_config(large)
    k, h = large_cfg.embed_dim, int(large_cfg.embed_dim * large_cfg.mlp_ratio)
    require(large_cfg.num_heads == 16 and large_cfg.attn_impl == "auto"
            and large_cfg.attn_drop_rate > 0 and large_cfg.mlp_impl == "xla"
            and not fits_vmem(k, h, k) and not large["parallel"]["remat"],
            "vlmo_large pretrain_mum: 16 heads, attention dropout on, the erf MLP, no remat")
    per_step = attention_calls_per_step(large_cfg)
    out["large_train"] = timed_phase(
        "large_train", large, at_last_block(CHECKED_PARAMS, large_cfg.depth),
        {"flash_attention_fwd_drop": per_step, "flash_attention_bwd_drop": per_step,
         "fused_mlp_fwd": 0, "fused_mlp_fwd_drop": 0})
    cpu_check_phase(LARGE_TRAIN_OVERRIDES + LARGE_CHECK, "large_train_cpu_check")
    elapsed("phase 30 vlmo_large pretrain_mum")

    # int8 serving from the int8 finetune_vqa trainer's seeded weights (one
    # vlmo_large built on the host instead of two), then its steps
    large_serve = load_config(preset_overrides(SERVE_OVERRIDES, "vlmo_large",
                                               "model.quantize=w8a8_pallas"))
    calls = img_txt_calls(VlmoConfig.from_config(large_serve))
    large_vqa = load_config(preset_overrides(VQA_OVERRIDES, "vlmo_large",
                                             "model.quantize=w8a8_pallas"))
    t1 = time.perf_counter()
    trainer = Trainer(large_vqa, device="cuda")
    print(f"vqa_large_w8a8_train: Trainer ready in {time.perf_counter() - t1:.1f} s",
          flush=True)
    out["large_serve"], _ = serve(
        "serve_large_w8a8", large_serve, VlmoConfig.from_config(large_serve), card,
        {"w8a8_matmul": 2 * calls, "w8a8_mlp_fwd": calls, "flash_attention_fwd": calls,
         "fused_mlp_fwd": 0}, e2e_atol=W8A8_E2E_ATOL, cpu_check=(1, CPU_CHECK_ROWS),
        state={k: v.detach().cpu() for k, v in trainer.task.state_dict().items()})
    out["large_vqa"] = timed_phase(
        "vqa_large_w8a8_train", large_vqa, at_last_block(CHECKED_VQA_PARAMS, large_cfg.depth),
        {"w8a8_matmul": 2 * calls, "w8a8_mlp_fwd_drop": calls,
         "flash_attention_fwd_drop": calls, "flash_attention_bwd_drop": calls,
         "w8a8_mlp_fwd": 0, "fused_mlp_fwd_drop": 0}, trainer=trainer)
    del trainer
    elapsed("phase 30 vlmo_large int8")

    for model in NARROW_PRESETS:  # serving from the finetune_vqa trainer's weights, as above
        serve_dict = load_config(preset_overrides(SERVE_OVERRIDES, model))
        cfg = VlmoConfig.from_config(serve_dict)
        calls = img_txt_calls(cfg)
        vqa = preset_overrides(VQA_OVERRIDES, model)
        trainer = Trainer(load_config(vqa), device="cuda")
        out[f"{model}_serve"], _ = serve(f"serve_{model}", serve_dict, cfg, card, {
            "flash_attention_fwd": calls, "fused_mlp_fwd": calls},
            state={k: v.detach().cpu() for k, v in trainer.task.state_dict().items()})
        out[f"{model}_vqa"] = timed_phase(f"vqa_{model}_train", load_config(vqa),
                                          CHECKED_VQA_PARAMS, {
            "fused_mlp_fwd_drop": calls, "flash_attention_fwd_drop": calls,
            "flash_attention_bwd_drop": calls, "fused_mlp_fwd": 0}, trainer=trainer)
        del trainer
        vqa_cpu_check_phase(f"vqa_{model}_cpu_check", vqa)
        elapsed(f"phase 30 {model}")
    print(f"phase 30: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


# the kernels of phase 30's widths, and where their launches on its paths
# are counted: (the path's key in `widths_phase`'s result by model)
WIDTH_KERNELS = {
    "fused_mlp_fwd": "{model}_serve", "fused_mlp_fwd_drop": "{model}_vqa",
    "w8a8_matmul": "large_serve", "w8a8_matmul_partial": None,
    "w8a8_mlp_fwd": "large_serve", "w8a8_mlp_fwd_drop": "large_vqa",
    "w8a8_mlp_fwd_split": None, "w8a8_mlp_fwd_drop_split": None,
}


def width_entries(widths: dict, name: str) -> list[dict]:
    """Kernel `name`'s rows of phase 30, the largest M of each width and
    mode, with the kernel's launches on the phase's path at that width (0
    where no path of the phase runs it: the tensor shares, and row 8 at
    vlmo_tiny's and vlmo_small's widths)."""
    keep: dict = {}
    for row in widths["bf16_mlp"] + widths["matmul"] + widths["w8a8_mlp"]:
        if row["name"] != name:
            continue
        group = (row["model"], row.get("threshold"), row["shape"].split("M=")[0],
                 row["shape"].split(" K=", 1)[-1])
        m = int(row["shape"].split("M=")[1].split()[0])
        if group not in keep or m > keep[group][0]:
            keep[group] = (m, row)
    out = []
    for m, row in keep.values():
        path = WIDTH_KERNELS[name]
        on = path is not None and row.get("on_path", True) and "T=" not in row["shape"]
        launches = widths[path.format(model=row["model"])][name] if on else 0
        out.append({"model": row["model"], "shape": row["shape"], "launches": launches,
                    **{key: row[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                 "bound_by", "library_ms")}})
    return out


def widths_only(card: str, dev) -> int:
    """The build, the layouts, then phase 30 alone (`--widths`)."""
    print("smem: " + json.dumps(check_layouts()), flush=True)
    widths_phase(card, dev)
    return 0


# ---- phase 31: the default preset, vlmo_debug (96 wide, 3 heads: head dim
# 32; depth 2, fusion layer 1), which `main` trains when no `model=` is
# given: rows 1-5 at head dim 32, rows 6 and 7 at width 96 (ROADMAP §A9)
DEBUG_MODEL = "vlmo_debug"
DEBUG_MAIN = ["train.datasets=[synthetic]", f"data.batch_size={TRAIN_BATCH}"]
DEBUG_MAIN_STEPS = 3  # main's `steps=N` at the default preset
DEBUG_TRAIN_STREAMS = ("text", "image", "fused", "itm", "txt")
DEBUG_SERVE_STREAMS = ("text", "image", "fused", "txt")
DEBUG_HIRES_REQUESTS = 2


def check_mlp_tail(dev) -> dict:
    """Rows 6 and 7 at K = N = 96 with NaN in the memory just past x, W1 and
    W2 (their last row), where a box that ran past the matrix would read:
    x's and W1's second 64-column box covers K columns 64-127, W2's second
    64-row box output rows 64-127, and the 32 past the matrix come from the
    tensor map's zero fill. The K tail's products are not issued and the N
    tail is not stored, so both kernels equal their plain versions and stay
    finite."""
    g = torch.Generator(device=dev).manual_seed(33)
    k, h, m, t = 96, 384, 1000, MLP_DROP_THRESHOLDS[-1]

    def with_nan_after(rows, cols, std):
        buf = torch.full((rows + 1, cols), float("nan"), device=dev)
        buf[:rows] = torch.randn((rows, cols), generator=g, device=dev) * std
        return buf.to(torch.bfloat16)[:rows]

    x, w1, w2 = with_nan_after(m, k, 1.0), with_nan_after(h, k, 0.02), with_nan_after(k, h, 0.02)
    b1, b2 = (torch.randn(n, generator=g, device=dev) * 0.02 for n in (h, k))
    bits = torch.randint(-32768, 32768, (m, h), dtype=torch.int16, generator=g, device=dev)
    out = {}
    for name, got, want in (
            ("fused_mlp_fwd", fused_mlp_fwd(x, w1, b1, w2, b2),
             fused_mlp_fwd_plain(x, w1, b1, w2, b2)),
            ("fused_mlp_fwd_drop", fused_mlp_fwd_drop(x, w1, b1, w2, b2, bits, t),
             fused_mlp_fwd_drop_plain(x, w1, b1, w2, b2, bits, t))):
        torch.cuda.synchronize()
        ok, err = within(got, want, MLP_ATOL, MLP_RTOL)
        require(ok, f"{name} K=96 with NaN past the matrices: max|err| {err}, finite "
                f"{bool(torch.isfinite(got.float()).all())}")
        out[name] = err
    return {"shape": f"M={m} K={k} H={h} N={k}", "max_abs_err": out}


def debug_kernels(dev) -> dict:
    """Rows 1-7 at vlmo_debug's shapes against their plain versions, each
    timed beside it and its library call: row 1 at the serving streams of
    batch 64 (BH = 192, N = 40 / 197 / 237) and pretrain_txt's 512 tokens
    at batch 32 (BH = 96, the streamed kernel); rows 2-4 at the
    pretrain_mum step's streams (BH = 96; ITM's 288) and at 512 tokens; the
    dropout mask bit for bit at ITM's rows and at N = 512; row 5 at
    1024^2, batch 8 (BH = 24, N = 4,097 / 4,137); rows 6 and 7 at K = N =
    96, hidden 384, at the serving and step M, and with NaN past the
    matrices."""
    dicts = [load_config(preset_overrides(SERVE_OVERRIDES, DEBUG_MODEL)),
             load_config(DEBUG_MAIN), load_config(preset_overrides(HIRES_OVERRIDES, DEBUG_MODEL))]
    serve_cfg, train_cfg, hires_cfg = (VlmoConfig.from_config(d) for d in dicts)
    for d, cfg in zip(dicts, (serve_cfg, train_cfg, hires_cfg)):
        require(d["model"]["name"] == DEBUG_MODEL and cfg.embed_dim == 96
                and cfg.embed_dim // cfg.num_heads == 32, "not vlmo_debug's widths")
    out = {"flash_attention_fwd": check_attention(serve_cfg, np.random.default_rng(10), dev,
                                                  only=DEBUG_SERVE_STREAMS)}
    out.update(check_attention_train(train_cfg, np.random.default_rng(11), dev,
                                     only=DEBUG_TRAIN_STREAMS))
    out["dropout_mask"] = [check_dropout_mask(train_cfg, dev, 3 * TRAIN_BATCH),
                           check_dropout_mask(train_cfg, dev, OFF_PATH_BATCH, SM90_BWD_MAX_N)]
    out["flash_attention_fwd_long"] = check_attention_long(hires_cfg,
                                                           np.random.default_rng(12), dev)
    mlp = check_widths_bf16_mlp(dev, (DEBUG_MODEL,), seed=34)
    out["fused_mlp_fwd"] = [r for r in mlp if r["name"] == "fused_mlp_fwd"]
    out["fused_mlp_fwd_drop"] = [r for r in mlp if r["name"] == "fused_mlp_fwd_drop"]
    out["mlp_tail"] = check_mlp_tail(dev)
    return out


def debug_main_phase(cfg: VlmoConfig) -> dict:
    """`python -m exploremultimodal_torch.main` as a user runs it, with no
    `model=`: DEBUG_MAIN_STEPS pretrain_mum steps of vlmo_debug on
    synthetic data at batch 32 (`main(argv)` in this process, so its
    launches are counted), rows 3 and 4 at the count derived from depth 2
    and fusion layer 1, every step's metrics finite."""
    import contextlib
    import io

    from exploremultimodal_torch import main as port_main

    per_step = attention_calls_per_step(cfg)
    expected = {"flash_attention_fwd_drop": per_step, "flash_attention_bwd_drop": per_step,
                "flash_attention_fwd": 0, "flash_attention_bwd": 0,
                "fused_mlp_fwd": 0, "fused_mlp_fwd_drop": 0}
    print(f"debug_main: expected launches per step (depth {cfg.depth}, fusion layer "
          f"{cfg.fusion_layer}): {json.dumps(expected)}", flush=True)
    for fn in KERNELS:
        fn.launches = 0
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        rc = port_main.main(DEBUG_MAIN + [f"steps={DEBUG_MAIN_STEPS}"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in KERNELS}
    steps = [json.loads(line) for line in printed.getvalue().splitlines()
             if line.startswith("{")]
    require(rc == 0 and len(steps) == DEBUG_MAIN_STEPS,
            f"debug_main: rc {rc}, {len(steps)} step lines")
    require(all(np.isfinite(v) for m in steps for v in m.values()),
            f"debug_main: non-finite metrics {steps}")
    require_launches("debug_main", launches, expected, DEBUG_MAIN_STEPS)
    result = {"steps": DEBUG_MAIN_STEPS, "wall_s": wall, "launches": launches,
              "step_ms": [m["step_s"] * 1e3 for m in steps],
              "losses": [{k: v for k, v in m.items() if k.endswith("_task_loss")}
                         for m in steps]}
    print("debug_main: " + json.dumps(result), flush=True)
    return launches


def debug_phase(card: str, dev) -> dict:
    """Phase 31: vlmo_debug on the card. Its kernels (`debug_kernels`); the
    default entry point (`debug_main_phase`); the step at attention dropout
    0 under attn_impl=pallas (rows 1 and 2); pretrain_txt at 512 tokens
    (row 3 on the streamed kernel, row 4 at N = 512); finetune_vqa under
    mlp_impl=fused (rows 7, 3, 4); six batch-64 VQA requests under
    attn_impl=pallas mlp_impl=fused (rows 1, 6) and two batch-8 1024^2 ones
    (rows 5, 1, 6), each against the CPU plain path; one batch-2
    pretrain_mum step against it at the preset's own depth. Returns the
    kernel rows and each path's launches."""
    t0 = time.perf_counter()
    out = {"kernels": debug_kernels(dev)}
    for name, rows in out["kernels"].items():
        for row in rows if isinstance(rows, list) else [rows]:
            print("kernel_debug: " + json.dumps({"name": name, **row}), flush=True)
    elapsed("phase 31 kernels")

    main_dict = load_config(DEBUG_MAIN)
    cfg = VlmoConfig.from_config(main_dict)
    require(main_dict["model"]["name"] == DEBUG_MODEL and cfg.attn_impl == "auto"
            and cfg.attn_drop_rate > 0
            and (cfg.depth, cfg.fusion_layer) == (2, 1) and cfg.mlp_impl == "xla",
            "the default preset: vlmo_debug, depth 2, fusion layer 1, attention dropout on")
    per_step = attention_calls_per_step(cfg)
    out["main"] = debug_main_phase(cfg)
    out["attn_drop0"], _, _ = short_phase(
        "debug_attn_drop0", load_config(DEBUG_MAIN + ["attn_impl=pallas",
                                                      "model.attn_drop_rate=0.0"]),
        {"flash_attention_fwd": per_step, "flash_attention_bwd": per_step,
         "flash_attention_fwd_drop": 0, "flash_attention_bwd_drop": 0})
    txt_dict = load_config(preset_overrides(TXT_OVERRIDES, DEBUG_MODEL))
    require(fwd_route(TXT_LEN) == "sm90_stream"
            and VlmoConfig.from_config(txt_dict).max_text_len == TXT_LEN,
            "debug pretrain_txt: 512 tokens on the streamed forward")
    out["txt"], _, _ = short_phase(
        "debug_txt", txt_dict, {"flash_attention_fwd_drop": cfg.depth,
                                "flash_attention_bwd_drop": cfg.depth,
                                "flash_attention_fwd": 0, "flash_attention_bwd": 0})
    calls = img_txt_calls(cfg)
    out["vqa"], _, _ = short_phase(
        "debug_vqa", load_config(preset_overrides(VQA_OVERRIDES, DEBUG_MODEL)),
        {"fused_mlp_fwd_drop": calls, "flash_attention_fwd_drop": calls,
         "flash_attention_bwd_drop": calls, "fused_mlp_fwd": 0})
    serve_dict = load_config(preset_overrides(SERVE_OVERRIDES, DEBUG_MODEL))
    out["serve"], _ = serve("debug_serve", serve_dict, VlmoConfig.from_config(serve_dict), card,
                            {"flash_attention_fwd": calls, "fused_mlp_fwd": calls})
    hires_dict = load_config(preset_overrides(HIRES_OVERRIDES, DEBUG_MODEL))
    out["hires"], _ = serve(
        "debug_hires", hires_dict, VlmoConfig.from_config(hires_dict), card,
        {"flash_attention_fwd_long": calls - cfg.fusion_layer,
         "flash_attention_fwd": cfg.fusion_layer, "fused_mlp_fwd": calls},
        requests=DEBUG_HIRES_REQUESTS, batch=HIRES_BATCH, cpu_check=(1, HIRES_CPU_ROWS))
    cpu_check_phase(DEBUG_MAIN, "debug_cpu_check", depth=[],
                    names=at_last_block(CHECKED_PARAMS, cfg.depth))
    print(f"phase 31: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


# the kernels of phase 31, and the path whose launches each shows:
# (the path's key in `debug_phase`'s result, its launches per run)
DEBUG_PATHS = {
    "flash_attention_fwd": "serve", "flash_attention_bwd": "attn_drop0",
    "flash_attention_fwd_drop": "main", "flash_attention_bwd_drop": "main",
    "flash_attention_fwd_long": "hires", "fused_mlp_fwd": "serve",
    "fused_mlp_fwd_drop": "vqa",
}


def debug_entries(debug: dict, name: str) -> list[dict]:
    """Kernel `name`'s rows of phase 31 at every vlmo_debug shape it was
    held at, each with the kernel's launches on the phase's path of
    DEBUG_PATHS (all its runs: steps or requests)."""
    launches = debug[DEBUG_PATHS[name]][name]
    return [{"model": DEBUG_MODEL, "shape": r["shape"], "launches": launches,
             **{key: r[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")}}
            for r in debug["kernels"][name]]


def debug_only(card: str, dev) -> int:
    """The build, the layouts, then phase 31 alone (`--debug`)."""
    print("smem: " + json.dumps(check_layouts()), flush=True)
    debug = debug_phase(card, dev)
    print(json.dumps({"debug_kernels": {name: debug_entries(debug, name)
                                        for name in DEBUG_PATHS}}), flush=True)
    return 0


def main(argv: list[str] | None = None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # phase 26's and 27's rank processes (this script, started by itself)
    if args[:1] in (["--probe-rank"], ["--two-rank"], ["--tp-rank"]):
        import faulthandler

        faulthandler.enable()
    if args[:1] == ["--probe-rank"]:
        return probe_child(int(args[1]), int(args[2]), args[3], args[4])
    if args[:1] == ["--two-rank"]:
        return two_rank_child(int(args[1]), int(args[2]), args[3], args[4])
    if args[:1] == ["--tp-rank"]:
        return tp_rank_child(int(args[1]), int(args[2]), args[3], args[4])
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
        func = ""
        for line in log.splitlines():
            if "Function properties for" in line:
                func = line.split("Function properties for", 1)[1].strip()
            if any(k in line for k in ("registers", "spill", "bytes smem", "Performance Loss")):
                print(f"  {line.strip()}", flush=True)
            if "spill" in line and " 0 bytes spill stores" not in line:
                print(f"    in {demangle(func)}", flush=True)
    elapsed("build")
    if args[:1] == ["--train-loop-samples"]:
        return loop_fit(card, img_txt_calls(VlmoConfig.from_config(load_config(
            SERVE_OVERRIDES))), [int(n) for n in args[1:]])
    if args[:1] == ["--downstream"]:
        return downstream_only(card, dev)
    if args[:1] == ["--momentum"]:
        return momentum_only(card, dev)
    if args[:1] == ["--finetune-rest"]:
        return finetune_rest_only(card)
    if args[:1] == ["--data"]:
        return data_only(card)
    if args[:1] == ["--parallel"]:
        return parallel_only(card, dev)
    if args[:1] == ["--tp"]:
        return tp_only(card, dev)
    if args[:1] == ["--optim"]:
        return optim_only(card, dev)
    if args[:1] == ["--tp-int8"]:
        return tp_int8_only(card, dev)
    if args[:1] == ["--widths"]:
        return widths_only(card, dev)
    if args[:1] == ["--debug"]:
        return debug_only(card, dev)

    print("smem: " + json.dumps(check_layouts()), flush=True)

    cfg_dict = load_config(SERVE_OVERRIDES)
    cfg = VlmoConfig.from_config(cfg_dict)
    attn_rows = check_attention(cfg, np.random.default_rng(0), dev)
    mlp_rows = check_mlp(cfg, dev)
    for row in attn_rows + mlp_rows:
        print("kernel: " + json.dumps(row), flush=True)

    elapsed("phase 3")
    calls = img_txt_calls(cfg)
    serve_launches, bf16_outputs = serve("serve", cfg_dict, cfg, card, {
        "flash_attention_fwd": calls, "fused_mlp_fwd": calls})
    elapsed("phase 4")

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
    elapsed("phases 5-8")

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
    elapsed("phases 9-12")

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
    elapsed("phases 13-15")

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

    elapsed("phase 16")
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

    elapsed("phases 17-18")
    # pretrain_txt at 512 tokens: rows 3 and 4 (and 1 and 2 at dropout 0)
    txt_launches = txt_phase()
    elapsed("phase 19")

    # the run around the step: epochs with evaluation, checkpoints, resume,
    # serving from a checkpoint, throughput mode
    train_loop_phase(card, calls)
    elapsed("phase 20")

    # pretrain_vis, finetune_nlvr2 and finetune_retrieval, then the
    # retrieval and NLVR2 endpoints
    downstream_train_phase(card)
    downstream_serve_phase(card)
    elapsed("phases 21-22")

    # pretrain_mum's full recipe: the momentum encoder, the queues, the eval
    # EMA and accumulation
    momentum_phase(card)
    elapsed("phase 23")

    # the last four phases, MPP, the VQA submission, caption and inpaint
    # serving, the DiscreteVAE
    finetune_rest_phase(card)
    elapsed("phase 24")

    # real data: the shards, the tokenizer, the loader, the three training
    # paths and serving on PIL images and strings
    data_phase(card)
    elapsed("phase 25")

    # more than one process: rows 3 and 4 keyed by the global row, every
    # preset on a process group, two ranks where the card allows, mesh
    # serving
    par = parallel_phase(card, dev)
    elapsed("phase 26")

    # tensor parallelism: rows 3 and 4 at the global heads, rows 6 and 7's
    # partial mode, the tp = 2 steps over gloo, the checkpoint across
    # layouts
    tp = tp_phase(card, dev)
    elapsed("phase 27")

    # the optimizer menu: every rule on one step's gradients, card against
    # CPU; lamb and adafactor trained, and at fsdp on two gloo ranks
    optim_phase(card, dev, par["probe"])
    elapsed("phase 28")

    # int8 under tensor parallelism: rows 8-10's split modes, the int8
    # finetune_vqa step on two tensor ranks
    tp_int8 = tp_int8_phase(card, dev)
    elapsed("phase 29")

    # the presets' widths: rows 6-10 at vlmo_tiny's, vlmo_small's and
    # vlmo_large's widths, vlmo_large's training and int8 paths, vlmo_tiny's
    # and vlmo_small's through rows 6 and 7
    widths = widths_phase(card, dev)
    elapsed("phase 30")

    # the default preset, vlmo_debug: rows 1-5 at head dim 32, rows 6 and 7
    # at width 96, `main` with no model given, and its other paths
    debug = debug_phase(card, dev)
    elapsed("phase 31")

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
    # phase 27's launches a step (rows 6: an evaluation batch) on each
    # tensor rank of the tp = 2 steps
    mum_tp, vqa_tp = tp["pretrain_mum"]["ranks"][0], tp["vqa"]["ranks"][0]
    tp_launches = {"flash_attention_fwd_drop": mum_tp["launches_per_step"],
                   "flash_attention_bwd_drop": mum_tp["launches_per_step"],
                   "fused_mlp_fwd_drop": vqa_tp["launches_per_step"],
                   "fused_mlp_fwd": vqa_tp["eval_launches"]}
    for k in kernels:
        if k["name"] in tp_launches:
            k["tp_launches"] = tp_launches[k["name"]][k["name"]]
    # rows 8-10's split modes, each with its launches on phase 29's int8 tp
    # step (rows 8 and 10) or evaluation batch (row 9), on rank 0
    w8_tp = tp_int8["vqa_w8"]["ranks"][0]
    split_launches = {**w8_tp["launches_per_step"], **{
        "w8a8_mlp_fwd_split": w8_tp["eval_launches"]["w8a8_mlp_fwd_split"]}}
    partial_rows = [r for r in tp_int8["matmul"] if r["name"] == "w8a8_matmul_partial"]
    kernels += [
        entry("w8a8_matmul_partial", "cuda", q_src, f"{tpu_q}:48", partial_rows,
              split_launches),
        entry("w8a8_mlp_fwd_split", "cuda", qmlp_src, f"{tpu_q}:233",
              [r for r in tp_int8["mlp"] if r["name"] == "w8a8_mlp_fwd_split"], split_launches),
        entry("w8a8_mlp_fwd_drop_split", "cuda", qmlp_src, f"{tpu_q}:366",
              [r for r in tp_int8["mlp"] if r["name"] == "w8a8_mlp_fwd_drop_split"],
              split_launches),
    ]
    for k in kernels[-3:]:
        k["tensor"] = TP
    kernels[6]["tp_launches"] = w8_tp["launches_per_step"]["w8a8_matmul"]
    # rows 6-10 at the presets' widths (phase 30), each width's largest
    # shape with its launches on phase 30's paths (0 off them)
    for k in kernels:
        if k["name"] in WIDTH_KERNELS:
            k["widths"] = width_entries(widths, k["name"])
    # rows 1-7 at vlmo_debug's shapes (phase 31), with their launches on
    # its paths
    for k in kernels:
        if k["name"] in DEBUG_PATHS:
            k["debug"] = debug_entries(debug, k["name"])
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
