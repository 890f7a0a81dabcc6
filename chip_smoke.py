#!/usr/bin/env python3
"""Drive the PyTorch port (exploremultimodal_torch) on one CUDA GPU.

    python3 chip_smoke.py        # from the repository root; needs one GPU and nvcc
    python3 chip_smoke.py --train-loop-samples 64 640
                                 # the build and phase 20 alone at each size,
                                 # then the loop's fixed and per-step cost

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
     on the streamed kernel at N = 333, 512 and 577 (384^2 images) and at
     batch 32 at N = 512, with route, grid and tiles; the MLP also at the
     1024^2 request's M, at M = 64 and at two ragged M, with its cluster
     size and hidden splits);
  4. serve batch-64 VQA requests through `Predictor.vqa_logits` at vlmo_base
     full width and depth (bf16, attn_impl=pallas, mlp_impl=fused, seeded
     random weights), check that every request went through both kernels,
     compare two requests with the CPU's plain path, and time the requests;
  5. at each shape the pretrain_mum step gives the training kernels (the
     flash backward, the dropout forward and the dropout backward: rows 2,
     3 and 4, all three on the sm90 kernels there), and off the path at
     batch 8 at N = 256, 333 (ragged) and 512 and at batch 32 at N = 333
     and 512 (pretrain_txt's length; the backward's sm90 kernels up to 512
     keys, in work units of a head's tile groups where heads are fewer than
     SMs; the dropout forward's streamed kernel past 256), hold each against
     its plain version, with its route, key width and grid, check the
     in-kernel dropout mask bit for bit (through the short sm90 forward and
     the backward at ITM's shape, and through the streamed forward and the
     backward at N = 512), and time kernel, plain version and SDPA (the
     backward rows against SDPA's backward alone, and its forward and
     backward);
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
 21. print the kernel table as one JSON line, the card line, and last
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
from exploremultimodal_torch.train import checkpoints as ckpt_lib
from exploremultimodal_torch.train.phases import dispatch
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


def check_attention(cfg: VlmoConfig, rng: np.random.Generator, dev) -> list[dict]:
    """Row 1 against its plain version: off the path at the (batch, N) of
    ATTN_OFF_PATH (N = 100, 150 and 256 take the short sm90 kernel's other
    key widths; N = 333, 512 and 577, 384^2 images, the streamed kernel past
    SM90_FWD_MAX_N), then at the serving streams of batch 64 and at
    pretrain_txt's 512 tokens at batch 32 (its path at attention dropout 0,
    the streamed kernel), each timed beside its plain version and SDPA."""
    heads, d = cfg.num_heads, cfg.embed_dim // cfg.num_heads
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_img = (cfg.img_size // cfg.patch_size) ** 2 + 1
    txt = text_mask(rng, BATCH, cfg.max_text_len)
    masks = {f"off_path_b{b}_n{n}": padded_mask(rng, b, n) for b, n in ATTN_OFF_PATH}
    masks.update({
        "text": txt,
        "image": np.ones((BATCH, n_img), np.int32),
        "fused": np.concatenate([txt, np.ones((BATCH, n_img), np.int32)], 1),
        "txt": synthetic_text_mask(rng, TXT_BATCH, TXT_LEN),
    })
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


def check_attention_train(cfg: VlmoConfig, rng: np.random.Generator, dev) -> dict:
    """Rows 2, 3 and 4 off the path at the (batch, N) of TRAIN_OFF_PATH
    (the backward on its sm90 kernels throughout, with its work units),
    then at each shape of the pretrain_mum step: the text, image and fused
    (MLM) streams at B = 32 and ITM's fused pair rows at 3B, all on the
    short sm90 forward, and last pretrain_txt's 512 tokens at B = 32 (row 3
    on the streamed forward). Each
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
    masks.update({
        "text": txt,
        "image": np.ones((TRAIN_BATCH, n_img), np.int32),
        "fused": np.concatenate([txt, np.ones((TRAIN_BATCH, n_img), np.int32)], 1),
        "itm": np.concatenate([txt3, np.ones((3 * TRAIN_BATCH, n_img), np.int32)], 1),
        "txt": synthetic_text_mask(rng, TXT_BATCH, TXT_LEN),
    })
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
                 **step_kw) -> dict:
    """One step on each trainer from the same host batch; the losses, the
    named gradients (relative L2; itc_temp's against the CPU's rescaled to
    the card's ITC features, and those features) and the signs of the first
    AdamW update compared against LOSS_RTOL, GRAD_REL_TOL and
    UPDATE_AGREEMENT."""
    before = {k: p.detach().clone() for k, p in cpu.task.named_parameters()
              if k in names}
    feats = {"gpu": {}, "cpu": {}}
    hooks = [t.task.itc_head.register_forward_hook(
        lambda mod, args, out, f=feats[d]: f.__setitem__(args[1], out.detach().double().cpu()))
        for d, t in (("gpu", gpu), ("cpu", cpu)) if "itc_temp" in names]
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
    held, itc = dict(grads), {}
    if "itc_temp" in names:
        closed = {d: itc_temp_closed_form(f, float(before["itc_temp"]))
                  for d, f in feats.items()}
        g_gpu, g_cpu = float(p_gpu["itc_temp"].grad), float(p_cpu["itc_temp"].grad)
        want = g_cpu * closed["gpu"] / closed["cpu"]
        f_gpu, f_cpu = (torch.cat([f["v"], f["l"]]) for f in (feats["gpu"], feats["cpu"]))
        itc = {"grad_gpu_cpu": (g_gpu, g_cpu), "closed_form_gpu_cpu": (closed["gpu"],
               closed["cpu"]), "feature_rel_err": ((f_gpu - f_cpu).norm() / f_cpu.norm()).item()}
        held["itc_temp"] = itc["grad_rel_err_at_gpu_features"] = abs(g_gpu - want) / abs(want)
        held["itc_features"] = itc["feature_rel_err"]
    result = {
        "batch": CPU_TRAIN_BATCH, "cpu_step_s": cpu_s,
        "losses_gpu_cpu": losses, "grad_norm_gpu_cpu": (float(m_gpu["grad_norm"]),
                                                        float(m_cpu["grad_norm"])),
        "grad_rel_err": grads, "update_sign_agreement": agree, "lr": lr,
        **({"itc_temp": itc} if itc else {}),
    }
    print(f"{tag}: " + json.dumps(result), flush=True)
    for k, (g, c) in losses.items():
        require(abs(g - c) <= LOSS_RTOL * abs(c) + 1e-3,
                f"{tag} {k}: GPU {g} vs CPU {c} beyond rtol {LOSS_RTOL}")
    require(max(held.values()) <= GRAD_REL_TOL,
            f"{tag}: gradients differ from the CPU path: {held}")
    require(min(agree.values()) >= UPDATE_AGREEMENT,
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
