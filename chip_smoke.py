#!/usr/bin/env python3
"""Smoke test of the PyTorch port (dfc_sa_unet_torch) on one NVIDIA H100.

    python3 chip_smoke.py [--seed N]

Run from the root of the repository.  Phases, each printing its lines;
any failure exits non-zero:

1. require CUDA; print the card's name, power limit and maximum SM clock;
   turn TF32 off for the f32 checks;
2. build the CUDA kernels from dfc_sa_unet_torch/csrc; ptxas must neither
   serialize the products (C7515) nor spill in the wgmma kernels of
   conv3x3_bn_relu (its halo instantiations too), conv3x3_bias_stats,
   probe_matmul, conv3x3_s8 (its halo instantiation too) and the bf16 pooled
   attention;
3. hold every kernel against its plain PyTorch version on the card, at
   the shapes the main paths give it and at awkward ones, in f32 and bf16
   (pooled attention, after a launch on NaN inputs: in bf16 the wgmma kernel
   at every N from 1 to 4096, at every main-path shape and at ragged N, C'
   and C, and every instantiation at three or more tiles a block,
   ATTN_WGMMA_SHAPES; in f32 the 16-row and the two-pass SIMT
   kernels; conv3x3_bn_relu
   at every flagship level and at the bf16 kernels' tilings, Cin 3 to 520,
   Cout 8 to 1024, ragged pixel counts and one pixel, after a launch on NaN
   inputs; conv3x3_bias_stats (y, mean and mean2) at its probe's levels and
   at Cin 3 to 520, Cout 8 to 520, ragged pixel counts and one pixel, after a
   launch on NaN inputs; the three matrix-unit probes in bf16, their only
   type, the matmul on the TMA-fed wgmma GEMM up to the probe's full M, the
   two conv probes on the wgmma mainloop; the pooled attention's epilogue,
   lsa_epilogue, within one ulp of its plain version, in practice bit for
   bit, at every flagship level, an odd size, a map larger than its level,
   C that no 16-byte vector divides and a band's rows), and the backward of
   the three attention wrappers against autograd through their plain
   versions;
4. serve the flagship DFC-SA-Res-Block at full width (224x224, features
   64/128/256/512, pool 8, seeded weights, BatchNorm statistics fitted to
   a slice of the batch so that the logits spread O(1)):
   one B=128 uint8 batch through the Predictor on the module path
   (attention kernel) and through the folded DFCEngine (tail kernel on the
   7 "auto" levels, 3x3 conv kernel on the other two, attention kernel and
   its epilogue kernel on all 9); the probabilities must agree, and the
   launch counts show that the kernels ran;
5. three synthetic 512x512 requests through predict_sliding_stream(tta);
6. serve the transformer zoo at full width and depth (224x224, ViT-B:
   E=768, 12 heads, 12 layers, MLP 3072; TransUNet: R50 units (3,4,9), the
   same ViT-B, DecoderCup), seeded weights with fitted BatchNorm
   statistics: one B=128 uint8 batch through the Predictor in f32 and
   bf16.  ViT-seg must launch the fused_mha kernel 12 times per forward
   and TransUNet the fused_mha_sep kernel 12 times; f32 on the card must
   agree with the same weights on the CPU, and bf16 with f32;
7. time each kernel, its plain version, a library yardstick and every
   serving path in bf16 at B=128; a kernel's bound is the largest of its
   bytes over the memory rate, its operations over the tensor-core peak
   and, for the attention kernels, its exponentials over the rate of the
   special-function units (132 SMs x 16 a clock x the maximum SM clock;
   ``bound_by`` says "bytes" or "operations", ``bound_term`` which of the
   three); the tail, the conv and conv3x3_bias_stats are held to their
   plain versions at each level's B=128 inputs (after a launch on NaN
   inputs) before they are timed, and so is the attention's epilogue (to
   one ulp) beside F.interpolate and the torch island it replaces; the
   kernels line keeps the four level by level (``levels``); the flagship's
   nine attention launches
   again at B=1024 beside SDPA and their bound (``flagship_large_batch``:
   at B=128 the launches read the host); the attention at SegFormer-B5's
   four launch shapes of a 1024x1024 tile at B=16 (every pixel's query
   against 1024 keys, heads of 64, k and v the halves of one projection),
   each held to its plain version on two images first, beside SDPA on the
   same heads and with its bound, and the 52 launches of a request summed
   (``segformer``); the bias pass of a SegFormer-B5 request (ops/bias_add.py,
   scripts/bench_torch_bias_add.py: 370 launches at 16 1024x1024 tiles),
   each biased output's shape held to torch's add_ bit for bit, then timed
   in place beside it (``bias_add``, shape by shape in ``levels``), and
   held bit for bit at TransUNet's and the flagship module's shapes in bf16
   at B=128 and in f32 (TransUNet at B=128, the flagship at phase 8's B=2);
   every path through the layers of nn/layers.py launches it, and each
   phase holds its count (``BIAS_LAUNCHES`` a forward, at least one a
   training step; 0 on the engines' paths);
8. train at full width through the port's Trainer (train_epoch and
   validate_epoch) on synthetic ellipses made in memory, bce_dice 0.5/0.5
   and SGD as configs/config_dfc-sa-res-block.yaml: the flagship for 16
   steps in f32 at B=2 (the first 3 against the same steps on the CPU; a
   checkpoint after epoch 1 restored into a fresh trainer must repeat
   epoch 2's losses; the best_model it writes is served through the
   Predictor, and so are the best_model and checkpoint_epoch_1 read back by
   the factory's facade, ModelFactory.get_model_and_variables with
   model.pretrained_path: 9 pooled-attention launches a forward, the
   probabilities within 1e-5 of the served best_model's) and for 20 steps in bf16 at the largest of B=128/64/32 that
   fits without rematerialisation (the loss must fall), every step finite
   and applied, 9 pooled-attention launches per step; the same step with
   ``remat='l12'`` for its time and memory (13 launches: four blocks run
   their forward twice); then 3 bf16 steps each of
   ViT-seg (attention dropout 0, so the kernel runs: 12 fused_mha launches
   per step; one more step at the YAML's 0.1 must launch none) and
   TransUNet (12 fused_mha_sep launches per step);
9. run the BatchNorm-statistics probe (the conv3x3_bias_stats kernel's own
   path, scripts/bench_torch_bn_stats.py) at its four levels, B=128, bf16,
   each level twice: y, mean and mean2 must be the same bits both times
   (no atomics), and the statistics must normalise y;
10. serve the DFC zoo at full width: the vanilla UNet (64..1024) and the
   eight ablations (features 64/128/256/512, pool 8) at 224x224,
   UNet_FullResAttention at 64x64 (its attention takes N = H*W <= 4096),
   seeded weights with fitted BatchNorm statistics: one B=128 uint8 batch
   through the Predictor in bf16, and 8 images in f32 against the same
   weights on the CPU.  Pooled-attention launches per forward: 9 for the
   attention-only, addition, concat and full-resolution models, 5 for
   encoder-only, 4 for decoder-only, none for UNet, baseline and
   both-standard (in bf16 all on the wgmma attention kernel; in f32
   six of the full-resolution model's on the two-pass SIMT kernel);
11. train three bf16 steps each of UNet_AttentionOnly (9 launches a step),
   UNet_FullResAttention at 64x64 (9 a step; the backward goes through the
   plain version, which holds B*N*N f32 energies, hence B=8) and UNet
   (none) through the Trainer, every step finite and applied;
12. run the matrix-unit probes (scripts/bench_torch_mxu.py: cuBLAS, the
   matmul kernel, cuDNN, the two conv kernels) at B=128, 56x56, 128 -> 256,
   bf16: one launch of each kernel held against its plain version, then
   the five timed rows;
13. int8 serving: the s8 3x3 conv kernel (conv3x3_s8) against its plain
   version bit for bit (max abs err 0), after a launch on inputs of all +127
   and -128, in bf16 and f32 out, at the int8 engine's four "auto" levels at
   B=128 and at Cin 3 (padded to 16), 16, 48 and 272, Cout 8, 40 and 520, odd
   H and W, ragged pixel counts and one pixel; then the int8 flagship (phase
   4's weights, bf16, auto int8 levels, the fp levels on the tail and conv
   kernels) calibrated at percentile 99.9 on 8 synthetic images with 8 more
   held out (its self-check printed, not gated: the weights are seeded), one
   B=128 uint8 batch through the Predictor (9 attention, 4 tail, 1 conv3x3
   and 4 conv3x3_s8 launches a forward), and the f32 int8 engine on the card
   against the CPU with the same scales: each int8 level's quantized input and
   s8 products from the same input the same bits, the logits of 2 images
   within |dlogit| / std max 0.2 and mean 0.025 (the quantize steps make the
   output discontinuous in its input; DLOGIT_TOL_INT8_CPU says why);
   then int8 ViT-seg and TransUNet at full width and depth, bf16, B=128 (12
   fused_mha launches a forward each), calibrated at max |t|, held against
   their bf16 modules to phase 6's bf16-against-f32 limits, and at percentile
   99.9, printed beside (INT8_ZOO_PERCENTILES says why); then the kernel's times at the four
   levels beside its plain version, the bf16 yardstick (cuDNN's bf16 conv +
   bias + ReLU) and its bound (dense s8: 1979 TOP/s), and the three int8
   forwards and served img/s beside their bf16 paths;
14. multi-device: (a) the flagship's data-parallel training step (the
   Trainer with a mesh, as the training CLI builds it) over NCCL in a group
   of one process, bf16 B=64, 3 steps, beside the single-device Trainer on the
   same weights and batches (both ms/step printed; 9 attention launches a
   step), then both in f32 at B=16, losses and state within 1e-4; (b) two
   processes on this card over Gloo (this script with --dp_worker; NCCL
   refuses two ranks on one GPU), f32, global batch 8, 2 steps, held to one
   process at tests/test_parallel_fast.py's limits, under a hard time limit;
   (c) 8 synthetic images served through the inference CLI (engine, bf16) by
   two processes under torch.distributed.run (this script with
   --serve_worker, which calls the CLI's main and saves its launch counts):
   the merged CSV must be the single-process run's, row for row, metrics
   within 1e-6, and each process must launch 9 attention, 7 tail and 2
   conv3x3 kernels a batch;
15. gradient accumulation, the kernels' build directory and the batch
   policy: (a) the flagship's configured batch of 128, which does not fit
   in one piece, as grad_accum 2 x 64 in bf16, 3 steps each of the exact
   path (one loss over both microbatches, each microbatch's forward run
   again in the backward: 36 attention launches a step) and the default
   path (18), every step finite, with ms/step, img/s and peak memory
   beside phase 8's step; (b) the exact path in f32 at B=4 as 2 x 2, 3
   steps on the card against the CPU (phase 8's limit); (c) the
   data-parallel Trainer at world size 1 (NCCL), f32, B=16 as 2 x 8,
   default and exact, against the single-device Trainer (phase 14(a)'s
   limit), then two Gloo ranks on this card at grad_accum 2, exact, against
   one process (phase 14(b)'s limits); (d) ``exe_cache``: a child process
   (this script with --cache_child DIR) builds every library in a fresh
   directory and serves a first request, a second one loads them and must
   write or touch no file there, both times to the first launch printed;
   (e) 150 images through the bf16 engine's ``predict_probs`` under the
   Predictor's batch policy against the same images served natively as
   128 + 22 (phase 5's bf16 limits);
16. row sharding: (a) the tail and conv3x3 kernels' halo instantiations
   band by band, at every level shape the engine launches them at (B=4,
   224x224), bf16 and f32, in 2 and 4 bands and a band of one row beside one
   of odd height, each band reading its neighbours' rows: stitched, equal
   bit for bit to the whole image's kernel, and each band within phase 3's
   limits of the plain version given the same rows, after a launch on NaN
   rows; (b) one image of the largest side one process serves (2048 down to
   512) through the bf16 engine by two processes sharing the card over Gloo
   (this script with --rows_worker; each the Predictor over a 2-band
   serving_mesh, a band of half the rows each, the probabilities gathered):
   against one process at phase 5's bf16 limits and in f32 within 1e-5 of
   max |logit|, 9 attention, 9 epilogue, 7 tail and 2 conv3x3 launches a forward on each
   rank, each rank's peak memory and wall time beside one process's; (c) the
   flagship's f32 training at 224x224, B=4, 2 steps, on a Gloo pair of
   bands against one process (phase 14(b)'s limits), then with grad_accum 2
   exact;
17. the rest of row sharding: (a) conv3x3_s8's halo instantiation band by
   band at the int8 engine's four levels (B=4), bf16 and f32 out, 2 and 4
   bands and a band of one row, after a launch on rows of +127: stitched,
   equal bit for bit to the whole image's kernel and to the plain version;
   the pooled attention with a band's queries against every key (nq < nk)
   at the full-resolution model's key counts and on an 8x16 map, bf16 and
   f32, after a launch on NaN queries: within phase 3's limits of the plain
   version and equal bit for bit to the band's rows of the whole map's
   launch; (b) ViT-B/16 and
   R50-ViT-B/16 at 224x224 (tokens gathered, the transformer whole on each
   rank), UNet_FullResAttention at 64x64 (the band's queries against the
   gathered keys), the bilinear UNet at 224x224, and the three int8 engines
   (the flagship's on one 2048x2048 image) served in bf16 by a Gloo pair of
   bands sharing the card (this script with --rows17_worker) against one
   process, with the f32 logits beside, each rank's launches a forward, peak
   memory and wall time beside one process's; (c) one f32 training step of
   each of the four models on the pair against one process (a Gloo group of
   one, so that its dropout seed is the pair's; phase 14(b)'s limits).

The launch counts are set to 0 before phase 4 and read after phase 5 (the
flagship's serving paths), and again around phase 6 (the transformers'),
around each training run of phase 8, around each of phases 9 to 12
(phase 12's before its timed rows), around each int8 engine's path in
phase 13 (before its timed rows) and around each multi-device run of phase
14 (the data-parallel Trainer's two runs in this process; each process of
(b) and (c) counts its own; the single-process references are not
counted), of phase 15 (its runs on the card, the data-parallel ones,
each Gloo rank's and each cache child's; not the single-device, CPU and
native references) and of phase 16 (each band's runs in (b) and (c); not
(a)'s comparisons, nor the single-process references; the tail's and
conv3x3's are their halo instantiations' and stand in the kernels line as
``halo_launches`` too) and of phase 17 (each band's runs in (b) and (c), not
(a)'s nor one process's; the int8 flagship's conv3x3_s8, tail and conv3x3
launches there are their halo instantiations', added to ``halo_launches``;
the full-resolution model's attention launches there are its launches with
fewer queries than keys, ``fewer_query_launches``; the MHA launches there
run on the gathered token maps, ``gathered_token_launches``).  The line before
the last is a JSON object of the kernels; the last line is
{"ok": true, "device": {...}}.
"""

import argparse
import contextlib
import io
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

START = time.perf_counter()  # the cache children of phase 15(d) time their first launch from here

BATCH = 128
IMG = 224
# configs/config_dfc-sa-res-block.yaml, model section (no YAML reader needed)
CONFIG = {"model": {"name": "DFC-SA-Res-Block", "in_channels": 3, "out_channels": 1,
                    "features": [64, 128, 256, 512], "pool_size": 8, "use_pallas": True}}
# (block, H, Cin, C) of the flagship at 224x224
# configs/config_vit_seg.yaml and configs/config_transunet.yaml: the model section, and the
# dataset's image size, which sizes TransUNet
ZOO = {
    "ViT-seg": ({"model": {"name": "VisionTransformerSegmentation", "in_channels": 3, "out_channels": 1,
                           "img_dim": 224, "patch_dim": 16, "embed_dim": 768, "num_layers": 12,
                           "num_heads": 12, "mlp_dim": 3072, "dropout": 0.1}}, "fused_mha"),
    "TransUNet": ({"model": {"name": "TransformerUNet", "in_channels": 3, "out_channels": 1},
                   "dataset": {"img_size": [224, 224]}}, "fused_mha_sep"),
}
TOKENS, EMBED, HEADS, LAYERS = 196, 768, 12, 12  # ViT-B/16 at 224x224: what both models give the kernel
# phase 3's MHA checks (B, N, E, heads): ViT-B, then N in {196, 197, 256, 257, 1024} (either side of
# the one-pass kernel's 256) at head dimensions 32, 64 and 128, a tiny N, one token, a single image
MHA_SHAPES = ([(BATCH, TOKENS, EMBED, HEADS)]
              + [(2, n, 4 * hd, 4) for n in (196, 197, 256, 257, 1024) for hd in (32, 64, 128)]
              + [(2, 16, 32, 2), (3, 1, EMBED, HEADS), (1, TOKENS, EMBED, HEADS)])
ATTN_BIG_BATCH = 1024          # phase 7: the flagship's nine attention launches timed again at this batch
# phase 3's extra bf16 attention checks (B, H, W, Cq, C), each after a launch on NaN inputs: the
# full-resolution model's five shapes at 64x64 (N = 4096 to 16, C' = C / 8), the pool-4 bottleneck at
# B=128, an odd B on the two-images-a-block path, and the ragged: N = 100 (no 64-row tile divides),
# 289 (no chunk divides), C' 16, 25 (zero-padded to 32 by the wrapper), 48, 128 and 256 at several N,
# C 96, 200 and 100 (padded to 104).  Then every instantiation of the persistent kernel at a batch that
# gives each of the 132 blocks three tiles or more, so that q slots and ring stages are reused across
# tiles: the full-resolution model's two large levels at the main path's B, the flagship's five N = 64
# levels at ATTN_BIG_BATCH, C' 32, 64, 128 and 256 over more than 64 keys, and the two warpgroups at
# 64 channels of v (C <= 64, 16 < C' <= 64: SegFormer's heads) at C' 32 and, ragged, 64 with C 48
ATTN_WGMMA_SHAPES = ([(8, 64, 64, 8, 64), (8, 32, 32, 16, 128), (8, 16, 16, 32, 256), (8, 8, 8, 64, 512),
                      (8, 4, 4, 128, 1024), (BATCH, 4, 4, 128, 1024), (3, 8, 8, 16, 128), (3, 10, 10, 8, 64),
                      (4, 17, 17, 8, 64), (2, 32, 32, 128, 1024), (2, 16, 16, 256, 64), (2, 16, 16, 256, 256),
                      (2, 8, 8, 256, 512), (5, 12, 12, 48, 96), (4, 17, 17, 25, 200), (2, 40, 40, 16, 100),
                      (1, 64, 64, 8, 64)]
                     + [(BATCH, 64, 64, 8, 64), (BATCH, 32, 32, 16, 128)]
                     + [(ATTN_BIG_BATCH, 8, 8, c // 8, c) for c in (64, 128, 256, 512, 1024)]
                     + [(BATCH, 16, 16, 32, 256), (BATCH, 32, 32, 64, 512), (16, 32, 32, 128, 1024),
                        (BATCH, 16, 16, 256, 256), (BATCH, 24, 24, 32, 64), (4, 33, 31, 64, 48)])
# phase 3's extra tail checks (B, H, W, Cin, C): odd H and W and ragged pixel counts at C = 512 and
# C <= 256, the channel counts below the flagship's (C = 32 is padded to 64 columns), and down1's
# Cin = 3 (zero-padded to 8 by the wrapper)
TAIL_ODD_SHAPES = [(3, 13, 17, 512, 512), (1, 9, 7, 1024, 512), (3, 13, 17, 128, 256), (2, 9, 7, 64, 128),
                   (2, 15, 15, 128, 64), (2, 8, 8, 32, 32), (1, 7, 9, 64, 32), (2, 9, 7, 3, 64)]
# phase 3's extra conv3x3_bn_relu checks (B, H, W, Cin, Cout): the bf16 kernels' flat K walk at Cin 3
# and 8 (the persistent kernel at Cout <= 64; Cin 3 on the ring, zero-padded to 8, at Cout 1024), 16
# (taps packed into a step), 24 (a step across taps) and 520 (a step across a tap's end), Cout 8, 40,
# 64 and 1024 (B tiles of 64 and 256 columns, ragged at 8 and 40), pixel counts that no 128-pixel
# block divides, and a 1x1 image
CONV_ODD_SHAPES = [(3, 13, 17, 3, 64), (3, 13, 17, 8, 40), (2, 9, 7, 16, 8), (3, 13, 17, 24, 1024),
                   (2, 9, 7, 520, 40), (3, 5, 3, 16, 64), (2, 9, 7, 3, 1024), (1, 1, 1, 3, 64),
                   (1, 1, 1, 520, 1024)]
# phase 3's extra conv3x3_bias_stats checks (B, H, W, Cin, Cout): in bf16 the persistent kernel at Cin 3
# and 8 (Cout 64 and 40), the ring at Cin 16 (taps packed into a step), 24 (a step across taps), 64 and
# 520 (a step across a tap's end), Cin 3 on the ring (zero-padded to 8) at Cout 128, B tiles of 64, 128
# and 256 columns, ragged at Cout 8, 40 and 520, two column tiles at 512; pixel counts below one tile,
# just past one and ragged (phantom rows must not count), and one pixel
STATS_ODD_SHAPES = [(3, 13, 17, 3, 64), (3, 13, 17, 8, 40), (2, 9, 7, 16, 8), (3, 13, 17, 24, 128),
                    (2, 9, 7, 520, 40), (3, 5, 3, 16, 512), (2, 9, 7, 3, 128), (1, 11, 12, 8, 64),
                    (1, 11, 12, 64, 520), (1, 1, 1, 3, 64), (1, 1, 1, 520, 512)]
# phase 3's probe_matmul checks (M, K, N): the probe's shape cut in B, rows that no 128-row tile
# divides, a tiny K and N, and the probe's full M plus a ragged tile (more tiles than blocks)
PROBE_MATMUL_SHAPES = [(4 * 56 * 56, 384, 256), (1000, 384, 256), (129, 8, 8), (BATCH * 56 * 56 + 77, 384, 256)]
BLOCK_SHAPES = [("down1", 224, 3, 64), ("down2", 112, 64, 128), ("down3", 56, 128, 256),
                ("down4", 28, 256, 512), ("bottleneck", 14, 512, 1024),
                ("up_conv4", 28, 1024, 512), ("up_conv3", 56, 512, 256),
                ("up_conv2", 112, 256, 128), ("up_conv1", 224, 128, 64)]
# phase 3's lsa_epilogue checks (B, H, W, C, p, band): the flagship's five level shapes at B=4 (the decoder's
# repeat them), a level already p x p, an odd size and C 24, a map larger than its level, C 3 and 12 (no 16-byte
# vector of bf16 divides them: the one-element instantiation), and a band of rows (height, row0)
LSA_SHAPES = [(4, 224, 224, 64, 8, None), (4, 112, 112, 128, 8, None), (4, 56, 56, 256, 8, None),
              (4, 28, 28, 512, 8, None), (4, 14, 14, 1024, 8, None), (3, 8, 8, 64, 8, None), (3, 13, 17, 24, 8, None),
              (2, 5, 6, 16, 8, None), (2, 21, 33, 3, 8, None), (2, 9, 7, 12, 4, None), (4, 14, 56, 256, 8, (56, 28)),
              (4, 7, 28, 512, 8, (28, 21))]
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
PEAK_OPS = {"bf16": 989e12, "f32": 67e12, "s8": 1979e12}  # dense tensor cores (bf16, s8); f32 without them
SMS, EXP_PER_CLOCK = 132, 16   # H100 SXM: SMs, and exponentials an SM's special-function units give a clock
TOL = {"float32": 1e-5, "bfloat16": 2e-2}  # max |kernel - plain| <= TOL * max(1, max|plain|) (SegFormer's shapes: TOL * max|plain|)
# module path vs engine path in f32: |dprob| <= 1e-3 and |dlogit| <= 1e-2 * std(logit); the
# engine folds BatchNorm into the weights, which reorders the f32 sums of every conv
PROB_TOL_F32 = 1e-3
# bf16 engine vs bf16 module on a request, in units of std(logit): the two round at different
# places (folded weights vs f32 BatchNorm), a few bf16 ulps through 9 blocks
DLOGIT_TOL_BF16 = {"mean": 0.05, "max": 0.5}
# training (phase 8): configs/config_dfc-sa-res-block.yaml's training section
TRAINING = {"num_epochs": 1, "learning_rate": 0.01, "momentum": 0.9, "weight_decay": 1e-4, "num_workers": 2,
            "loss": {"type": "bce_dice", "params": {"bce_weight": 0.5, "dice_weight": 0.5}}}
TRAIN_BATCHES = (128, 64, 32)  # bf16, without rematerialisation: the largest that fits is used
F32_TRAIN_BATCH = 2
ZOO_TRAIN_BATCH = 32
# f32 training on the card vs the CPU, relative loss difference of the first 3 steps: the same f32
# arithmetic in another order (cuDNN and cuBLAS without TF32), amplified by two updates
TRAIN_LOSS_TOL_CPU = 1e-3
# a resumed trainer against the one that went on, relative loss difference over the next epoch:
# the same state and batches; cuDNN's backward sums in an order that changes from run to run
TRAIN_LOSS_TOL_RESUME = 1e-4
# attention backward on the card vs autograd through the plain version, of max|reference|
GRAD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# phase 10: the DFC zoo.  configs/config_unet.yaml and configs/config_ablation*.yaml, model sections:
# name -> (image size, pooled-attention launches per forward)
DFC_WIDTHS = {"in_channels": 3, "out_channels": 1, "features": [64, 128, 256, 512], "pool_size": 8}
DFC_ZOO = {"UNet": (IMG, 0), "UNet_Baseline": (IMG, 0), "UNet_AttentionOnly": (IMG, 9),
           "UNet_AdditionFusion": (IMG, 9), "UNet_ConcatFusion": (IMG, 9), "UNet_FullResAttention": (64, 9),
           "UNet_EncoderOnlyDFC": (IMG, 5), "UNet_DecoderOnlyDFC": (IMG, 4), "UNet_BothStandardConv": (IMG, 0)}
# the bias pass's launches (ops/bias_add.py) of one forward of each model's module, by factory name: every
# biased Dense and conv of nn/layers.py, one call each (a forward on the CPU counts the same calls); the
# engines add their biases themselves, but the int8 TransUNet keeps its module's patch embedding and
# segmentation head
BIAS_LAUNCHES = {"DFC-SA-Res-Block": 64, "VisionTransformerSegmentation": 54, "TransformerUNet": 74, "UNet": 19,
                 "UNet_Baseline": 10, "UNet_AttentionOnly": 37, "UNet_AdditionFusion": 46, "UNet_ConcatFusion": 55,
                 "UNet_FullResAttention": 64, "UNet_EncoderOnlyDFC": 40, "UNet_DecoderOnlyDFC": 34,
                 "UNet_BothStandardConv": 10}
INT8_BIAS_LAUNCHES = {"VisionTransformerSegmentation": 0, "TransformerUNet": 2}
DFC_ZOO_F32_BATCH = 8
DFC_ZOO_CPU_IMAGES = 2
# phase 11: (model, image size, batch); the full-resolution model's backward recomputes through
# the plain version, B*N*N f32 energies a tensor at N = 4096
DFC_ZOO_TRAINING = [("UNet_AttentionOnly", IMG, 64), ("UNet_FullResAttention", 64, 8), ("UNet", IMG, 64)]
# the full-resolution model at 64x64: (block, H, C) with N = H*H tokens a launch
# SegFormer-B5 (models/segformer.py) at a 1024x1024 tile: (width, heads, reduction ratio, blocks) a stage
SEGFORMER_STAGES = [(64, 1, 8, 3), (128, 2, 4, 6), (320, 5, 2, 40), (512, 8, 1, 3)]
SEGFORMER_BATCH = 16  # the tiles of a request of the cell segformer_serve_b16_1024
FULLRES_SHAPES = [("down1", 64, 64), ("down2", 32, 128), ("down3", 16, 256), ("down4", 8, 512),
                  ("bottleneck", 4, 1024), ("up_conv4", 8, 512), ("up_conv3", 16, 256), ("up_conv2", 32, 128),
                  ("up_conv1", 64, 64)]
MIN_LOGIT_STD = 0.1  # below this the agreement checks could not tell a constant output apart
# transformer f32 on the card vs the same weights on the CPU (plain attention), max |dlogit| / std:
# the same f32 arithmetic in another order through 12 layers
DLOGIT_TOL_CPU = 1e-3
# transformer bf16 vs f32 on the card, |dlogit| / std.  ViT-seg keeps the limits above (it read
# mean 8.4e-3, max 7.3e-2).  TransUNet needs wider ones: with seeded weights the bf16 roundings of
# the 48 weight-standardised convs of its R50 add up without contracting (mean 0.26 of the
# activation std after block3 at a reduced size on the CPU, and the JAX package's own bf16 mode reads
# the same there); the full model read mean 1.250e-01 and max 1.255 on an H100.  A constant output
# reads about 0.8 on the mean.
DLOGIT_TOL_BF16_ZOO = {"ViT-seg": DLOGIT_TOL_BF16, "TransUNet": {"mean": 0.25, "max": 2.5}}
# the DFC zoo's bf16 against its f32 on the same images, |dlogit| / std: a sanity gate at
# TransUNet's limits (printed for every model; a constant output reads about 0.8 on the mean)
DLOGIT_TOL_BF16_DFC_ZOO = DLOGIT_TOL_BF16_ZOO["TransUNet"]
# phase 13's extra conv3x3_s8 checks (B, H, W, Cin, Cout): Cin 3 (zero-padded to 16), 16 (taps packed into a
# step), 48 (a step across taps) and 272 (a step across a tap's end), Cout 8, 40 and 520 (B tiles of 64 and
# 256 columns, ragged), odd H and W, pixel counts that no 128-pixel block divides, one pixel
S8_ODD_SHAPES = [(3, 13, 17, 3, 64), (2, 9, 7, 16, 8), (3, 13, 17, 48, 40), (2, 9, 7, 272, 520),
                 (1, 11, 12, 16, 40), (1, 1, 1, 16, 8), (1, 1, 1, 272, 520)]
INT8_CALIB_IMAGES = 8
INT8_PERCENTILE = 99.9
# the int8 transformers are calibrated both ways and the max |t| one is held to phase 6's bf16 limits: on
# seeded ViT-B weights the 99.9th percentile clips LayerNorm outputs (the inputs of qkv and fc1), which
# costs several times the max |t| error; its agreement is printed beside
INT8_ZOO_PERCENTILES = (None, INT8_PERCENTILE)
# the f32 int8 flagship on the card against the CPU, the same scales, on 2 images.  Given the same block input
# an int8 level's quantized input and s8 products are the same bits on both (checked level by level).  End to
# end the output is discontinuous in its input: an f32 sum taken in another order moves a value across a
# rounding boundary of the next quantize, one step, and the steps compound through four int8 levels.  Phase 13
# prints what the CPU engine reads against itself with its input scaled by 1 + 1e-6, and what int8 reads
# against fp; the card is held to about twice the former.
INT8_CPU_IMAGES = 2
DLOGIT_TOL_INT8_CPU = {"max": 0.2, "mean": 0.025}
# phase 14: the data-parallel path at world size 1 against the single-device Trainer, f32, B=16 (both fit at
# once), 3 steps: losses and every tensor of the state dict within 1e-4 of the largest magnitude (the only
# difference is the cross-replica BatchNorm arithmetic, E[x^2] - E[x]^2 over one process)
DP_F32_BATCH, DP_TOL = 16, 1e-4
# phase 14(b): two processes on the one card over Gloo (NCCL refuses two ranks on one GPU), f32, global
# batch 8, 2 steps, against one process: tests/test_parallel_fast.py:89-93's limits
DP_BATCH, DP_STEPS = 8, 2
DP_LOSS_TOL = {"atol": 1e-5, "rtol": 1e-5}
DP_STATE_TOL = {"atol": 1e-5, "rtol": 1e-4}
DP_CHILD_TIMEOUT_S = 300  # a hang fails the phase
# phase 14(c): 8 synthetic images served by two processes through the CLI, merged, against one process; both
# runs take batches of 4 tiles, so each image meets the same shapes and the same library algorithms
SERVE_IMAGES, SERVE_BATCH = 8, 4
# phase 15: the configured batch of 128, which does not fit on the card in one piece (phase 8), as
# grad_accum 2 x 64, bf16, 3 steps of each path.  Pooled-attention launches a step: 9 a forward of each
# microbatch, and the exact path runs each microbatch's forward again in the backward (the backward
# itself recomputes attention through the plain version)
ACCUM, ACCUM_BATCH, ACCUM_STEPS = 2, 128, 3
ACCUM_ATTENTION = {"exact": 9 * ACCUM * 2, "default": 9 * ACCUM}
EXACT = {"grad_accum": ACCUM, "grad_accum_exact": True}
# (b) f32 on the card against the CPU at B=4 as 2 x 2, phase 8's TRAIN_LOSS_TOL_CPU; (c) the data-parallel
# step at world size 1 against the Trainer at B=16 as 2 x 8, 2 steps, phase 14(a)'s DP_TOL, then 2 Gloo
# ranks at phase 14(b)'s global batch, limits and steps; (e) a request of 150 images through the engine
ACCUM_F32_BATCH, ACCUM_DP_BATCH, ACCUM_DP_STEPS = 4, 16, 2
POLICY_IMAGES = 150
POLICY_FORWARDS = 1  # infer/predictor.py::Predictor.predict_probs runs a batch as it is (measured, PERF.md §4)
# phase 16: row sharding.  (b) one image served by a Gloo pair sharing the card, each rank a band of
# half its rows, against one process: the largest side that one process serves, a multiple of 32
# (16 x 2 bands); (c) training on the pair at 224x224 (two bands of 112 rows) at a global batch of 4
ROWS_SIDES = (2048, 1536, 1024, 512)
ROWS_TRAIN_BATCH = 4
# 16(b) in f32: the pair's logits against one process's, of max |logit|: the pool's window sums and
# the upsample's band rows are summed in another order, and cuDNN picks its algorithm per shape
ROWS_F32_TOL = 1e-5
# phase 17: the rest of row sharding.  (b) the families banded after the DFC family, each served by a Gloo
# pair sharing the card, each rank a band of half the rows, against one process: label -> (config, image side,
# launches of one forward); the transformers' configs are phase 6's, the full-resolution model's phase 10's
ROWS17_MODELS = {
    "ViT-B/16": (ZOO["ViT-seg"][0], IMG, {"fused_mha": 12, "bias_add": BIAS_LAUNCHES["VisionTransformerSegmentation"]}),
    "R50-ViT-B/16": (ZOO["TransUNet"][0], IMG, {"fused_mha_sep": 12, "bias_add": BIAS_LAUNCHES["TransformerUNet"]}),
    "UNet_FullResAttention": ({"model": {"name": "UNet_FullResAttention", **DFC_WIDTHS}}, 64,
                              {"pooled_attention": 9, "bias_add": BIAS_LAUNCHES["UNet_FullResAttention"]}),
    "UNet bilinear": ({"model": {"name": "UNet", "bilinear": True}}, IMG, {"bias_add": BIAS_LAUNCHES["UNet"]}),
}
# the int8 engines: label -> (the weights' model, image side, launches of one forward); the flagship on phase
# 16(b)'s one large image, its fp levels on the tail and conv kernels
ROWS17_INT8 = {
    "int8 flagship": ("flagship", 2048, {"pooled_attention": 9, "lsa_epilogue": 9, "dfc_tail": 4, "conv3x3_bn_relu": 1,
                                         "conv3x3_s8": 4}),
    "int8 ViT-B/16": ("ViT-B/16", IMG, {"fused_mha": 12}),
    "int8 R50-ViT-B/16": ("R50-ViT-B/16", IMG, {"fused_mha": 12, "bias_add": INT8_BIAS_LAUNCHES["TransformerUNet"]}),
}
# the bf16 requests' limits against one process, |dlogit| / std: phase 5's, and TransUNet's wider ones of phase 6
# (its int8 engine keeps the module's bf16 R50 stem), which phase 13 holds the int8 transformers to; the f32
# int8 flagship's are phase 13's against the CPU (DLOGIT_TOL_INT8_CPU: a sum in another order moves a value
# across a quantize step)
ROWS17_TOL = {"R50-ViT-B/16": DLOGIT_TOL_BF16_ZOO["TransUNet"], "int8 R50-ViT-B/16": DLOGIT_TOL_BF16_ZOO["TransUNet"]}
# the f32 logits against one process, of max |logit|: ROWS_F32_TOL (phase 16(b)'s), but R50-ViT-B/16's, set
# above its readings on the card, 1.59e-5 (phase 17) and 1.59-1.63e-5 (four cards over NCCL,
# scripts/bench_torch_rows.py): its R50 body amplifies the reordered sums of the band's convs and GroupNorm,
# 1e-6 of the activations after block1 to 2e-5 after block3, with either GroupNorm formula in the one process
# (a trace at 64x64 on the CPU).  The control: the pair's bf16 logits on the same images must fall outside it
ROWS17_F32_TOL = {"R50-ViT-B/16": 4e-5}
ROWS17_LOGIT_CLIP = 15.0  # the control reads logits from probabilities: |logit| above this saturates logit_of
ROWS17_IMAGES = 8       # a bf16 request of each model at 224 or 64 (the int8 flagship: one image)
ROWS17_F32_IMAGES = 2   # the f32 logits
ROWS17_TRAIN_BATCH = 2  # (c): one f32 step of each model on the pair
# (a) the pooled attention's band of queries against every key, at the full-resolution model's key counts
# and on an 8x16 map
ROWS17_ATTN_BATCH = 4


def seeded_trainer(cfg, batch, data, bf16, device, log_dir, seed, remat=False, weight_seed=None, mesh=None,
                   training=None):
    """A Trainer of ``cfg`` (phase 8's training section, with ``training``'s settings over it) with
    weights seeded by ``weight_seed`` (default ``seed``) over the synthetic samples ``data``; with
    ``mesh`` each process loads its share of every batch (``BatchLoader(shard=..., microbatches=...)``)
    as the training CLI does.  ``step_log`` records each step's metrics and its time: train_step ends
    on a read of the loss."""
    import torch

    from dfc_sa_unet_torch.data.dataset import ArrayDataset
    from dfc_sa_unet_torch.data.loader import BatchLoader
    from dfc_sa_unet_torch.models.factory import create_model
    from dfc_sa_unet_torch.train.trainer import Trainer
    from dfc_sa_unet_torch.utils.weights import init_random_

    dtype = torch.bfloat16 if bf16 else None
    config = {**cfg, "training": {**TRAINING, "batch_size": batch, **(training or {})},
              "logging": {"log_dir": log_dir, "images_dir": os.path.join(log_dir, "images")}}
    net = init_random_(create_model(config, dtype=dtype, device="cpu", remat=remat),
                       torch.Generator().manual_seed(seed if weight_seed is None else weight_seed))
    shard = None if mesh is None else (mesh.data_index, mesh.data_size)  # a spatial group loads one chunk
    train = BatchLoader(ArrayDataset(data), batch, shuffle=True, num_workers=2, seed=seed, shard=shard,
                        partial="replicate", microbatches=config["training"].get("grad_accum", 1))
    val = BatchLoader(ArrayDataset(data[:2 * batch]), batch, shuffle=False, num_workers=2, seed=seed, shard=shard)
    trainer = Trainer(net, train, val, config, mesh=mesh, seed=seed, compute_dtype=dtype, device=device,
                      progress=False)
    trainer.step_log = []
    step = trainer.train_step

    def logged_step(*batch_tensors, **kw):
        t0 = time.perf_counter()
        metrics = step(*batch_tensors, **kw)
        trainer.step_log.append({**metrics, "ms": (time.perf_counter() - t0) * 1e3})
        return metrics

    trainer.train_step = logged_step
    return trainer


def dp_worker(args):
    """One process of phase 14(b) (and of 15(c) with ``--dp_exact``: grad_accum 2, exact; of 16(c)
    with ``--dp_spatial 2``: each rank on a band of the rows): the flagship at full width, f32, one
    rank of a Gloo group of ``--dp_world`` processes on cuda:0, DP_STEPS steps at a global batch of
    ``--dp_batch`` (its share of each); saves its step log, launch counts and state dict into
    ``--dp_out``."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dfc_sa_unet_torch.data.synthetic import samples
    from dfc_sa_unet_torch.ops import launches, reset_launches
    from dfc_sa_unet_torch.parallel.mesh import serving_mesh

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = serving_mesh(args.dp_spatial, device="cuda:0", backend="gloo", coordinator=args.dp_coordinator,
                        num_processes=args.dp_world, process_id=args.dp_worker, timeout_s=DP_CHILD_TIMEOUT_S)
    try:
        data = list(samples(n=DP_STEPS * args.dp_batch, size=IMG, seed=args.seed))
        trainer = seeded_trainer(CONFIG, args.dp_batch, data, False, mesh.device,
                                 os.path.join(args.dp_out, f"rank{args.dp_worker}"), args.seed, mesh=mesh,
                                 training=EXACT if args.dp_exact else None)
        reset_launches()
        trainer.train_epoch(0)
        torch.save({"step_log": trainer.step_log, "launches": launches(),
                    "state": {k: v.detach().cpu() for k, v in trainer.model.state_dict().items()}},
                   os.path.join(args.dp_out, f"rank{args.dp_worker}.pt"))
    finally:
        mesh.close()


def serve_worker(args, cli_argv):
    """One process of phase 14(c) under torch.distributed.run: the inference CLI's main on
    ``cli_argv`` with the launch counts from 0, then its counts into ``--serve_worker``."""
    from dfc_sa_unet_torch import inference as serve_cli
    from dfc_sa_unet_torch.ops import launches, reset_launches

    reset_launches()
    serve_cli.main(serve_cli.parse_args(cli_argv))
    with open(os.path.join(args.serve_worker, f"launches.rank{os.environ['RANK']}.json"), "w") as f:
        json.dump(launches(), f)


def cache_child(args):
    """One process of phase 15(d): the flagship's module path served through a Predictor whose
    kernels build in, or load from, ``--cache_child``; prints one JSON line: the seconds from this
    script's start to the end of the first request (its kernel launches), the launch counts and the
    build directory."""
    import torch

    from dfc_sa_unet_torch.infer.predictor import Predictor
    from dfc_sa_unet_torch.models.factory import ModelFactory, create_model
    from dfc_sa_unet_torch.ops import _build, launches, reset_launches

    model = create_model(CONFIG, dtype=torch.bfloat16, device="cuda")
    pred = Predictor(model, compute_dtype=torch.bfloat16, device="cuda", exe_cache_dir=args.cache_child)
    reset_launches()
    probs = pred.predict_probs(np.random.default_rng(args.seed).integers(0, 256, (2, IMG, IMG, 3), dtype=np.uint8))
    print(json.dumps({"first_launch_s": time.perf_counter() - START, "launches": launches(),
                      "build_dir": str(_build.BUILD_DIR), "finite": bool(np.isfinite(probs).all())}))


def gloo_pair_against_one(seed, card, dev, tmp, label, training, run_epochs, spatial=1, batch=DP_BATCH):
    """Two processes of this script (``--dp_worker``) on this card over Gloo, the flagship in f32 at a
    global batch of ``batch`` for DP_STEPS steps (with ``training``'s settings: ``EXACT`` adds
    ``--dp_exact``; ``spatial`` 2: one data index, each rank on a band of the rows), against one
    process on the same batches (its launches not counted): losses and state within phase 14(b)'s
    limits, and each rank's pooled-attention launches those of its steps.  Fails ``label``
    otherwise, or when a process fails or outlives DP_CHILD_TIMEOUT_S.  Returns each rank's launch
    counts."""
    import torch

    from dfc_sa_unet_torch.data.synthetic import samples
    from dfc_sa_unet_torch.parallel.mesh import local_coordinator

    per_step = ACCUM_ATTENTION["exact"] if training == EXACT else 9
    dp_out = os.path.join(tmp, ("bands" if spatial > 1 else "two") + ("_exact" if training == EXACT else ""))
    os.makedirs(dp_out)
    coordinator = local_coordinator()
    children = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--seed", str(seed), "--dp_worker",
                                  str(r), "--dp_world", "2", "--dp_coordinator", coordinator, "--dp_out", dp_out,
                                  "--dp_spatial", str(spatial), "--dp_batch", str(batch),
                                  *(["--dp_exact"] if training == EXACT else [])],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        logs = [c.communicate(timeout=DP_CHILD_TIMEOUT_S)[0] for c in children]
    except subprocess.TimeoutExpired:
        logs = None
    finally:
        for c in children:
            if c.poll() is None:
                c.kill()
                c.communicate()
    if logs is None or any(c.returncode for c in children):
        for i, log in enumerate(logs or []):
            print(f"    rank {i}: {log[-3000:]}")
        fail(f"{label}: a process of the Gloo group failed or hung (limit {DP_CHILD_TIMEOUT_S} s); its output is above")
    ranks = [torch.load(os.path.join(dp_out, f"rank{r}.pt"), weights_only=False) for r in range(2)]
    one = seeded_trainer(CONFIG, batch, list(samples(n=DP_STEPS * batch, size=IMG, seed=seed)), False, dev,
                         os.path.join(dp_out, "one"), seed, training=training)
    run_epochs(one, [0], "pooled_attention", per_step, f"{label}, one process")
    want_loss = [r["loss"] for r in one.step_log]
    want_state = {k: v.detach().cpu() for k, v in one.model.state_dict().items()}
    bad = []
    for r, got in enumerate(ranks):
        loss = [s["loss"] for s in got["step_log"]]
        launched = without_bias(got["launches"], DP_STEPS, f"{label}, rank {r}")
        if launched != {**{k: 0 for k in launched}, "pooled_attention": per_step * DP_STEPS}:
            bad.append(f"rank {r} launched {got['launches']}")
        if not np.allclose(loss, want_loss, **DP_LOSS_TOL) or len(loss) != DP_STEPS:
            bad.append(f"rank {r} losses {loss} against {want_loss}")
        for k, v in want_state.items():
            if not torch.allclose(got["state"][k].double(), v.double(), **DP_STATE_TOL):
                bad.append(f"rank {r} {k}: max difference {(got['state'][k].double() - v.double()).abs().max():.3e}")
    two_ms = float(np.median([s["ms"] for s in ranks[0]["step_log"][1:]]))
    one_ms = float(np.median([s["ms"] for s in one.step_log[1:]]))
    setting = f", grad_accum {ACCUM} exact" if training == EXACT else ""
    share = f"a band of {IMG // 2} rows of every image a process" if spatial > 1 else f"{batch // 2} a process"
    print(f"    two processes on one card over Gloo, f32, global batch {batch} ({share}{setting}), "
          f"{DP_STEPS} steps: losses {[round(s['loss'], 6) for s in ranks[0]['step_log']]} against one process's "
          f"{[round(v, 6) for v in want_loss]}; {two_ms:.1f} ms/step (rank 0, step 2) against one process's "
          f"{one_ms:.1f} ({card})", flush=True)
    if bad:
        fail(f"{label}: two processes disagree with one: " + "; ".join(bad[:8]))
    return [got["launches"] for got in ranks]


def multi_device(seed, card, dev, fits, batch, items, run_epochs):
    """Phase 14: the data-parallel training step and multi-process serving.  ``fits`` is phase
    8's bf16 batch, ``items`` its synthetic samples and ``run_epochs`` its epoch check, ``batch``
    phase 4's uint8 images; the two processes of (b) and (c) share cuda:0.  Returns the launch
    counts of the multi-device runs: the data-parallel Trainer's in this process and every
    process's of (b) and (c); the single-process references' are not counted."""
    import csv

    import torch
    import yaml

    from dfc_sa_unet_torch import inference as serve_cli
    from dfc_sa_unet_torch.data.normalize import normalize
    from dfc_sa_unet_torch.data.synthetic import generate
    from dfc_sa_unet_torch.models.factory import create_model
    from dfc_sa_unet_torch.ops import launches, reset_launches
    from dfc_sa_unet_torch.parallel.mesh import data_parallel_mesh, local_coordinator
    from dfc_sa_unet_torch.utils.weights import calibrate_batch_stats_, init_random_

    print(f"[14] multi-device training and serving, seed {seed} ({card})", flush=True)

    tmp = tempfile.TemporaryDirectory()
    path = {k: 0 for k in launches()}  # the multi-device runs' launches
    run_counts = {}  # each run's, printed

    def count(label, got):
        run_counts[label] = {k: v for k, v in got.items() if v}
        for k, v in got.items():
            path[k] += v

    def epoch(tr, label, counted):
        """Phase 8's epoch check (9 attention launches a step and nothing else); a data-parallel
        run's launches go into the path's."""
        reset_launches()
        run_epochs(tr, [0], "pooled_attention", 9, label)
        if counted:
            count(label, launches())

    # (a) the data-parallel training step over NCCL at world size 1, in this process, beside the
    # single-device Trainer on the same weights and batches
    mesh = data_parallel_mesh(dev, coordinator=local_coordinator(), num_processes=1, process_id=0,
                              timeout_s=DP_CHILD_TIMEOUT_S)
    if mesh.group is None or mesh.backend != "nccl" or mesh.world_size != 1:
        fail(f"expected an NCCL group of one process, got {mesh}")
    dp_ms = {}
    for label, m in (("data-parallel, NCCL, 1 process", mesh), ("single-device Trainer", None)):
        tr = seeded_trainer(CONFIG, fits, items[:3 * fits], True, dev, os.path.join(tmp.name, "bf16"), seed, mesh=m)
        epoch(tr, f"(a) flagship bf16 B={fits}, {label}", m is not None)
        dp_ms[label] = float(np.median([r["ms"] for r in tr.step_log[1:]]))
        print(f"    flagship bf16 B={fits}, {label}: losses {[round(r['loss'], 4) for r in tr.step_log]}; "
              f"{dp_ms[label]:.1f} ms/step (median of steps 2-3) = {fits / dp_ms[label] * 1e3:.1f} img/s ({card})",
              flush=True)
        del tr
        torch.cuda.empty_cache()
    pair = []  # (step log, state dict on the host) of the data-parallel path, then of the Trainer
    for m in (mesh, None):
        tr = seeded_trainer(CONFIG, DP_F32_BATCH, items[:3 * DP_F32_BATCH], False, dev, os.path.join(tmp.name, "f32"),
                            seed, mesh=m)
        epoch(tr, f"(a) flagship f32 B={DP_F32_BATCH}, " + ("data-parallel" if m is not None else "single-device"),
              m is not None)
        pair.append((tr.step_log, {k: v.detach().cpu() for k, v in tr.model.state_dict().items()}))
        del tr
        torch.cuda.empty_cache()
    rel_loss = max(abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in zip(pair[0][0], pair[1][0]))
    sd_dp, sd_one = pair[0][1], pair[1][1]
    rel_state = max(float((sd_dp[k].double() - v.double()).abs().max() / v.double().abs().max().clamp(min=1e-12))
                    for k, v in sd_one.items() if v.is_floating_point())
    tracked = all(torch.equal(sd_dp[k], v) for k, v in sd_one.items() if not v.is_floating_point())
    print(f"    data-parallel path vs the single-device Trainer, f32 B={DP_F32_BATCH}, 3 steps: relative loss "
          f"difference {rel_loss:.2e}, largest state-dict difference {rel_state:.2e} of the tensor's largest "
          f"magnitude (tol {DP_TOL})", flush=True)
    if not (rel_loss <= DP_TOL and rel_state <= DP_TOL and tracked):
        fail("the data-parallel training step at world size 1 disagrees with the single-device Trainer")
    del pair, sd_dp, sd_one
    mesh.close()
    torch.cuda.empty_cache()

    # (b) two processes on this card over Gloo, against one process at the same global batch
    for r, got in enumerate(gloo_pair_against_one(seed, card, dev, tmp.name, "phase 14(b)", None, run_epochs)):
        count(f"(b) rank {r}", got)
    torch.cuda.empty_cache()

    # (c) serving through the CLI: two processes (torchrun, Gloo barrier, primary merges) against one
    data_dir = generate(os.path.join(tmp.name, "serve"), n=SERVE_IMAGES, size=IMG, seed=seed)
    serve_model = init_random_(create_model(CONFIG, device="cpu"), torch.Generator().manual_seed(seed)).to(dev)
    calibrate_batch_stats_(serve_model, normalize(torch.from_numpy(batch[:16]).to(dev)).permute(0, 3, 1, 2))
    weights_path = os.path.join(tmp.name, "serve.pth")
    torch.save({k: v.cpu() for k, v in serve_model.state_dict().items()}, weights_path)
    del serve_model
    cfg_path = os.path.join(tmp.name, "serve.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump({**CONFIG, "dataset": {"img_size": [IMG, IMG]}, "training": {}, "logging": {}}, f)
    common = ["--config", cfg_path, "--model", weights_path, "--input", data_dir, "--tile_size", str(IMG),
              "--overlap", "0", "--engine", "--bf16", "--batch_size", str(SERVE_BATCH), "--device", "cuda:0"]

    def served(got, n_images):
        """The launches of serving ``n_images`` in batches of SERVE_BATCH: 9/9/7/2 a batch."""
        n = -(-n_images // SERVE_BATCH)
        return got == {**{k: 0 for k in got}, "pooled_attention": 9 * n, "lsa_epilogue": 9 * n, "dfc_tail": 7 * n,
                       "conv3x3_bn_relu": 2 * n}

    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):  # the CLI's per-image lines and table
        serve_cli.main(serve_cli.parse_args([*common, "--output", os.path.join(tmp.name, "one")]))
    one_s = time.perf_counter() - t0
    if not served(launches(), SERVE_IMAGES):
        fail(f"one serving process launched {launches()}")
    counts_dir = os.path.join(tmp.name, "serve_counts")
    os.makedirs(counts_dir)
    t0 = time.perf_counter()
    # its own session, so that a hang is ended with torchrun's workers, not only torchrun; each
    # worker runs the CLI's main (python -m dfc_sa_unet_torch.inference's) and saves its counts
    run = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
                            os.path.abspath(__file__), "--serve_worker", counts_dir, "--",
                            *common, "--output", os.path.join(tmp.name, "two"), "--data_parallel"],
                           cwd=os.path.dirname(os.path.abspath(__file__)),
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        log = run.communicate(timeout=DP_CHILD_TIMEOUT_S)[0]
    except subprocess.TimeoutExpired:
        os.killpg(run.pid, signal.SIGKILL)
        run.communicate()
        fail(f"phase 14(c): two serving processes did not finish in {DP_CHILD_TIMEOUT_S} s")
    two_s = time.perf_counter() - t0
    if run.returncode:
        print(log[-6000:])
        fail("phase 14(c): two serving processes failed")

    def csv_rows(run):
        with open(os.path.join(tmp.name, run, "evaluation_metrics.csv"), newline="") as f:
            return list(csv.DictReader(f))

    want_rows, got_rows = csv_rows("one"), csv_rows("two")
    worst = max((abs(float(g[k]) - float(w[k])) for g, w in zip(got_rows, want_rows) for k in w if k != "file"),
                default=float("inf"))
    names = [r["file"] for r in got_rows]
    print(f"    serving {SERVE_IMAGES} images (engine, bf16, batches of {SERVE_BATCH}): one process {one_s:.1f} s, "
          f"two processes through torchrun {two_s:.1f} s with start-up; merged CSV rows {names}; largest metric "
          f"difference {worst:.1e} (tol 1e-6) ({card})", flush=True)
    if names != [r["file"] for r in want_rows] or len(names) != SERVE_IMAGES or not worst <= 1e-6:
        fail("phase 14(c): the merged CSV of two processes is not the single-process CSV")
    for r in range(2):
        with open(os.path.join(counts_dir, f"launches.rank{r}.json")) as f:
            got = json.load(f)
        if not served(got, SERVE_IMAGES // 2):
            fail(f"phase 14(c): serving process {r} launched {got}, expected 9/9/7/2 a batch of {SERVE_BATCH}")
        count(f"(c) rank {r}", got)
    print(f"    multi-device launches, run by run: {run_counts}; the path's {path}", flush=True)
    tmp.cleanup()
    return path



def accumulation_and_cache(seed, card, dev, fits, fits_ms, run_epochs):
    """Phase 15: gradient accumulation at the configured batch, exact and default, on one process and
    data-parallel; the kernels' build directory (``exe_cache``) in two child processes; and a request
    of POLICY_IMAGES images under the Predictor's batch policy.  ``fits`` and ``fits_ms`` are phase 8's
    bf16 batch and its ms/step, ``run_epochs`` its epoch check.  Returns the launch counts of the
    phase's runs; the single-device and CPU references and the native request of (e) are not
    counted."""
    import torch

    from dfc_sa_unet_torch.data.normalize import normalize
    from dfc_sa_unet_torch.data.synthetic import samples
    from dfc_sa_unet_torch.infer.engine import DFCEngine
    from dfc_sa_unet_torch.infer.predictor import Predictor
    from dfc_sa_unet_torch.models.factory import ModelFactory, create_model
    from dfc_sa_unet_torch.ops import _build, launches, reset_launches
    from dfc_sa_unet_torch.parallel.mesh import data_parallel_mesh, local_coordinator
    from dfc_sa_unet_torch.utils.weights import calibrate_batch_stats_, init_random_

    print(f"[15] gradient accumulation, the kernels' build directory and the batch policy, seed {seed} ({card})",
          flush=True)
    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    path = {k: 0 for k in launches()}  # the phase's launches
    run_counts = {}  # each run's, printed
    default = {"grad_accum": ACCUM}

    def count(label, got):
        run_counts[label] = {k: v for k, v in got.items() if v}
        for k, v in got.items():
            path[k] += v

    def epoch(tr, kind, label, counted=True):
        """One epoch with ACCUM_ATTENTION[kind] attention launches a step, counted into the phase's."""
        reset_launches()
        run_epochs(tr, [0], "pooled_attention", ACCUM_ATTENTION[kind], label)
        if counted:
            count(label, launches())

    items = list(samples(n=ACCUM_STEPS * ACCUM_BATCH, size=IMG, seed=seed))

    # (a) the configured batch of 128 as 2 x 64, bf16, exact and default
    for kind, training in (("exact", EXACT), ("default", default)):
        torch.cuda.reset_peak_memory_stats()
        label = f"(a) flagship bf16 B={ACCUM_BATCH} as {ACCUM} x {ACCUM_BATCH // ACCUM}, {kind}"
        tr = seeded_trainer(CONFIG, ACCUM_BATCH, items, True, dev, os.path.join(tmp.name, "a"), seed,
                            training=training)
        epoch(tr, kind, label)
        ms = float(np.median([r["ms"] for r in tr.step_log[1:]]))
        print(f"    {label}: losses {[round(r['loss'], 4) for r in tr.step_log]}; {ms:.1f} ms/step (median of "
              f"steps 2-3) = {ACCUM_BATCH / ms * 1e3:.1f} img/s; peak allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {ACCUM_ATTENTION[kind]} attention launches a "
              f"step; phase 8's B={fits} step {fits_ms:.1f} ms = {fits / fits_ms * 1e3:.1f} img/s ({card})",
              flush=True)
        del tr
        torch.cuda.empty_cache()

    # (b) f32, B=4 as 2 x 2, exact: 3 steps on the card against the same steps on the CPU
    n_b = 3 * ACCUM_F32_BATCH
    on_card = seeded_trainer(CONFIG, ACCUM_F32_BATCH, items[:n_b], False, dev, os.path.join(tmp.name, "b"), seed,
                             training=EXACT)
    epoch(on_card, "exact", f"(b) flagship f32 B={ACCUM_F32_BATCH} as {ACCUM} x {ACCUM_F32_BATCH // ACCUM}, exact")
    on_cpu = seeded_trainer(CONFIG, ACCUM_F32_BATCH, items[:n_b], False, "cpu", os.path.join(tmp.name, "b_cpu"),
                            seed, training=EXACT)
    on_cpu.train_epoch(0)
    rel = [abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in zip(on_card.step_log, on_cpu.step_log)]
    print(f"    (b) f32 B={ACCUM_F32_BATCH} exact: losses of steps 1-3 on the card "
          f"{[round(m['loss'], 6) for m in on_card.step_log]}, on the CPU {[round(m['loss'], 6) for m in on_cpu.step_log]}; "
          f"relative difference {max(rel):.2e} (tol {TRAIN_LOSS_TOL_CPU})", flush=True)
    if not (len(rel) == 3 and max(rel) <= TRAIN_LOSS_TOL_CPU):
        fail("phase 15(b): the exact accumulation step on the card and on the CPU disagree")
    del on_card, on_cpu
    torch.cuda.empty_cache()

    # (c) the data-parallel Trainer at world size 1 (NCCL) against the single-device Trainer, f32,
    # B=16 as 2 x 8, default and exact; then two Gloo ranks on this card at grad_accum 2, exact
    mesh = data_parallel_mesh(dev, coordinator=local_coordinator(), num_processes=1, process_id=0,
                              timeout_s=DP_CHILD_TIMEOUT_S)
    if mesh.group is None or mesh.backend != "nccl" or mesh.world_size != 1:
        fail(f"expected an NCCL group of one process, got {mesh}")
    n_c = ACCUM_DP_STEPS * ACCUM_DP_BATCH
    for kind, training in (("default", default), ("exact", EXACT)):
        pair = []  # (step log, state dict on the host) of the data-parallel path, then of the Trainer
        for m in (mesh, None):
            label = f"(c) flagship f32 B={ACCUM_DP_BATCH} as {ACCUM} x {ACCUM_DP_BATCH // ACCUM}, {kind}, " + (
                "data-parallel" if m is not None else "single-device")
            tr = seeded_trainer(CONFIG, ACCUM_DP_BATCH, items[:n_c], False, dev, os.path.join(tmp.name, "c"), seed,
                                mesh=m, training=training)
            epoch(tr, kind, label, counted=m is not None)
            pair.append((tr.step_log, {k: v.detach().cpu() for k, v in tr.model.state_dict().items()}))
            del tr
            torch.cuda.empty_cache()
        rel_loss = max(abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in zip(pair[0][0], pair[1][0]))
        sd_dp, sd_one = pair[0][1], pair[1][1]
        rel_state = max(float((sd_dp[k].double() - v.double()).abs().max() / v.double().abs().max().clamp(min=1e-12))
                        for k, v in sd_one.items() if v.is_floating_point())
        tracked = all(torch.equal(sd_dp[k], v) for k, v in sd_one.items() if not v.is_floating_point())
        print(f"    (c) {kind}: the data-parallel path at world size 1 vs the single-device Trainer, "
              f"{ACCUM_DP_STEPS} steps: relative loss difference {rel_loss:.2e}, largest state-dict difference "
              f"{rel_state:.2e} of the tensor's largest magnitude (tol {DP_TOL})", flush=True)
        if not (rel_loss <= DP_TOL and rel_state <= DP_TOL and tracked):
            fail(f"phase 15(c): the data-parallel {kind} accumulation step disagrees with the single-device Trainer")
    mesh.close()
    for r, got in enumerate(gloo_pair_against_one(seed, card, dev, tmp.name, "phase 15(c)", EXACT, run_epochs)):
        count(f"(c) Gloo rank {r}, exact", got)
    torch.cuda.empty_cache()

    # (d) exe_cache: a first child builds every library in a fresh directory, a second loads them
    cache = os.path.join(tmp.name, "exe_cache")

    def child(label):
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--seed", str(seed), "--cache_child", cache],
                             capture_output=True, text=True, timeout=DP_CHILD_TIMEOUT_S)
        if out.returncode:
            print(out.stdout[-3000:], out.stderr[-3000:])
            fail(f"phase 15(d): the {label} child failed")
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        if (rec["launches"] != {**{k: 0 for k in rec["launches"]}, "pooled_attention": 9,
                                "bias_add": BIAS_LAUNCHES[CONFIG["model"]["name"]]} or not rec["finite"]
                or rec["build_dir"] != os.path.realpath(cache)):
            fail(f"phase 15(d): the {label} child launched {rec['launches']} from {rec['build_dir']}, finite "
                 f"{rec['finite']}")
        count(f"(d) {label} child", rec["launches"])
        return rec, time.perf_counter() - t0

    def files():
        return {f: os.stat(os.path.join(cache, f)).st_mtime_ns for f in sorted(os.listdir(cache))}

    first, first_wall = child("first")
    built = files()
    stems = sorted({stem for stem, _ in _build.SIGNATURES.values()})
    made = sorted(f.split("-")[0][3:] for f in built if f.endswith(".so"))
    if made != stems or sorted(f[:-4] for f in built if f.endswith(".log")) != stems:
        fail(f"phase 15(d): the first child left {sorted(built)} in the cache, not one library and log of {stems}")
    second, second_wall = child("second")
    if files() != built:
        fail("phase 15(d): the second child wrote into the cache (it should load the libraries without nvcc)")
    print(f"    (d) exe_cache: the first child built {len(made)} libraries in a fresh directory, first launch "
          f"{first['first_launch_s']:.1f} s after its start ({first_wall:.1f} s in all); the second loaded them, no "
          f"file written or touched, first launch {second['first_launch_s']:.1f} s ({second_wall:.1f} s in all) "
          f"({card})", flush=True)

    # (e) a request of POLICY_IMAGES images through the bf16 engine under the Predictor's batch policy,
    # against the same images served natively as 128 + 22
    rng = np.random.default_rng(seed + 15)
    request = rng.integers(0, 256, (POLICY_IMAGES, IMG, IMG, 3), dtype=np.uint8)
    model = init_random_(create_model(CONFIG, device="cpu"), torch.Generator().manual_seed(seed)).to(dev)
    calibrate_batch_stats_(model, normalize(torch.from_numpy(request[:16]).to(dev)).permute(0, 3, 1, 2))
    pred = Predictor(DFCEngine(CONFIG, model.state_dict(), dtype=torch.bfloat16, device=dev, tail_kernel_levels="auto",
                               conv_kernel_levels="auto"), compute_dtype=torch.bfloat16, device=dev)
    del model
    reset_launches()
    got = pred.predict_probs(request)
    count("(e) predict_probs", launches())
    forwards = POLICY_FORWARDS
    if run_counts["(e) predict_probs"] != {"pooled_attention": 9 * forwards, "lsa_epilogue": 9 * forwards,
                                           "dfc_tail": 7 * forwards, "conv3x3_bn_relu": 2 * forwards}:
        fail(f"phase 15(e): predict_probs of {POLICY_IMAGES} images launched {run_counts['(e) predict_probs']}, "
             f"expected {forwards} forward(s) of 9/9/7/2")
    want = np.concatenate([pred._forward_u8(request[:128]), pred._forward_u8(request[128:])])
    logit_want = logit_of(want)
    std = float(logit_want.std())
    diff = np.abs(logit_of(got) - logit_want) / std
    print(f"    (e) predict_probs of {POLICY_IMAGES} images through the bf16 engine ({forwards} forward(s)) "
          f"against 128 + {POLICY_IMAGES - 128} natively: logit std {std:.3e}; |dlogit| / std max {diff.max():.3e} "
          f"(tol {DLOGIT_TOL_BF16['max']}), mean {diff.mean():.3e} (tol {DLOGIT_TOL_BF16['mean']})", flush=True)
    if got.shape != (POLICY_IMAGES, IMG, IMG) or not np.isfinite(got).all() or std < MIN_LOGIT_STD:
        fail(f"phase 15(e): probabilities of shape {got.shape}, finite {np.isfinite(got).all()}, logit std {std:.3e}")
    if not (diff.max() <= DLOGIT_TOL_BF16["max"] and diff.mean() <= DLOGIT_TOL_BF16["mean"]):
        fail("phase 15(e): the batch policy's request disagrees with the native one")
    del pred
    torch.cuda.empty_cache()
    print(f"    phase 15 launches, run by run: {run_counts}; the phase's {path}; "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    tmp.cleanup()
    return path


# ------------------------------------------------------------------ phase 16: row sharding

def band_cuts(h):
    """The bands phase 16(a) cuts an image of ``h`` rows into, as row counts: 2 and 4 bands, and a band
    of one row beside one of odd height (the rest after them)."""
    odd = 2 * ((h - 1) // 4) + 1
    return {"2 bands": [h // 2, h - h // 2], "4 bands": [h // 4] * 3 + [h - 3 * (h // 4)],
            "1 row, odd": [1, odd, h - 1 - odd] if h - 1 - odd > 0 else [1, h - 1]}


def by_bands(kernel, x, banded, shared, cuts, poison=False):
    """``kernel`` band by band over x's rows (``banded``: its other band-sized operands; ``shared``: the
    rest), each band with its neighbours' rows as ``top`` and ``bottom`` (None at the image's edge),
    stitched back; ``poison``: a launch with NaN rows and halo rows (s8: all +127) before each band's."""
    import torch

    bad = float("nan") if x.is_floating_point() else 127
    outs, r0 = [], 0
    for n in cuts:
        r1 = r0 + n
        top = x[:, r0 - 1].contiguous() if r0 > 0 else None
        bottom = x[:, r1].contiguous() if r1 < x.shape[1] else None
        part = [t[:, r0:r1].contiguous() for t in (x, *banded)]
        if poison:
            nan = [torch.full_like(t, bad) for t in part]
            kernel(*nan, *shared, top=None if top is None else torch.full_like(top, bad),
                   bottom=None if bottom is None else torch.full_like(bottom, bad))
        outs.append(kernel(*part, *shared, top=top, bottom=bottom))
        r0 = r1
    return torch.cat(outs, 1)


def halo_kernels(dev, gen, max_err, card):
    """Phase 16(a): the tail and conv3x3 kernels over bands of rows, reading their neighbours' halo rows,
    at every level shape the flagship's engine launches them at (B=4, 224x224), in bf16 and f32: each
    cut (band_cuts) stitched must equal the whole image's kernel bit for bit (a pixel's K walk is the
    same), and each band must agree with the plain version given the same halo rows (TOL), after a
    launch on NaN rows.  Fails the phase otherwise."""
    import torch

    from dfc_sa_unet_torch.infer.engine import AUTO_TAIL_LEVELS
    from dfc_sa_unet_torch.ops import dfc_tail as tail_ops

    def randn(*shape, dtype, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    bad, t0 = [], time.perf_counter()
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        for name, h, cin, c in BLOCK_SHAPES:
            x = randn(4, h, h, cin, dtype=dtype)
            wc, bc = randn(3, 3, cin, c, dtype=dtype, scale=(9 * cin) ** -0.5), randn(c, dtype=torch.float32)
            if name in AUTO_TAIL_LEVELS:
                kernel, plain, key = tail_ops.dfc_tail, tail_ops.dfc_tail_plain, "dfc_tail"
                banded = (randn(4, h, h, c, dtype=dtype),)
                shared = (wc, bc, randn(2 * c, c, dtype=dtype, scale=(2 * c) ** -0.5), randn(c, dtype=torch.float32),
                          randn(3 * c, c, dtype=dtype, scale=(3 * c) ** -0.5), randn(c, dtype=torch.float32),
                          randn(cin, c, dtype=dtype, scale=0.1 * cin ** -0.5))
            else:
                kernel, plain, key = tail_ops.conv3x3_bn_relu, tail_ops.conv3x3_bn_relu_plain, "conv3x3_bn_relu"
                banded, shared = (), (wc, bc)
            whole = kernel(x, *banded, *shared)
            for label, cuts in band_cuts(h).items():
                got = by_bands(kernel, x, banded, shared, cuts, poison=True)
                want = by_bands(plain, x, banded, shared, cuts)
                torch.cuda.synchronize()
                equal = torch.equal(got, whole)
                err = (got.float() - want.float()).abs().max().item()
                scale = max(1.0, want.float().abs().max().item())
                ok = equal and bool(np.isfinite(err)) and err <= TOL[dn] * scale
                max_err[key] = max(max_err[key], err)
                print(f"    {key:16s} {dn} {name:10s} B=4 {h}x{h} {cin}->{c}, {label} {cuts}: stitched "
                      f"{'equal to' if equal else 'DIFFERENT from'} the whole image's kernel; max_abs_err vs plain "
                      f"{err:.3e} (tol {TOL[dn] * scale:.2e}) {'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    bad.append(f"{key} {dn} {name} {label}")
            del x, banded, shared, whole
    print(f"    halo kernels checked in {time.perf_counter() - t0:.1f} s ({card})", flush=True)
    if bad:
        fail("phase 16(a): the halo kernels disagree: " + "; ".join(bad[:8]))


def rows_worker(args):
    """One process of phase 16(b): the flagship's bf16 engine ("auto" levels) serving one image of
    ``--rows_side`` (one process: the largest of ROWS_SIDES that fits), with ``--rows_world 2`` as
    one band of a Gloo pair on cuda:0 (the Predictor cuts the band, the pair gathers the
    probabilities).  A first request warms cuDNN and cuBLAS up; the second is timed, its launches
    counted and its peak device memory read.  Then the f32 engine's logits of the same image (the
    band's, gathered).  Saves both, with the counts, into ``--rows_out``."""
    import torch

    from dfc_sa_unet_torch.data.normalize import normalize
    from dfc_sa_unet_torch.infer.engine import DFCEngine
    from dfc_sa_unet_torch.infer.predictor import Predictor
    from dfc_sa_unet_torch.ops import launches, reset_launches
    from dfc_sa_unet_torch.parallel import rows
    from dfc_sa_unet_torch.parallel.mesh import serving_mesh

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    mesh = None
    if args.rows_world > 1:
        mesh = serving_mesh(args.rows_world, device=dev, backend="gloo", coordinator=args.rows_coordinator,
                            num_processes=args.rows_world, process_id=args.rows_worker, timeout_s=DP_CHILD_TIMEOUT_S)
    weights = torch.load(os.path.join(args.rows_out, "weights.pt"))
    rec = {}
    try:
        for side in (ROWS_SIDES if args.rows_side is None else (args.rows_side,)):
            image = np.random.default_rng(args.seed).integers(0, 256, (1, side, side, 3), dtype=np.uint8)
            try:
                pred = Predictor(DFCEngine(CONFIG, weights, dtype=torch.bfloat16, device=dev, tail_kernel_levels="auto",
                                           conv_kernel_levels="auto"), compute_dtype=torch.bfloat16, device=dev,
                                 mesh=mesh)
                with torch.inference_mode():
                    pred.predict_probs(image)
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    reset_launches()
                    t0 = time.perf_counter()
                    probs = pred.predict_probs(image)
                    rec.update(side=side, probs=probs, wall_ms=(time.perf_counter() - t0) * 1e3, bf16_launches=launches(),
                               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
            except torch.cuda.OutOfMemoryError:
                if mesh is not None:
                    raise
                print(f"one process does not serve a {side}x{side} image on the card; trying a smaller one", flush=True)
                pred = None
                torch.cuda.empty_cache()
                continue
            break
        del pred
        torch.cuda.empty_cache()
        engine = DFCEngine(CONFIG, weights, dtype=torch.float32, device=dev, tail_kernel_levels="auto",
                           conv_kernel_levels="auto")
        side = rec["side"]
        band = None if mesh is None else mesh.band(side)
        image = np.random.default_rng(args.seed).integers(0, 256, (1, side, side, 3), dtype=np.uint8)
        if band is not None:
            image = image[:, band.row0:band.row0 + band.rows]
        x = normalize(torch.from_numpy(np.ascontiguousarray(image)).to(dev), torch.float32).permute(0, 3, 1, 2)
        reset_launches()
        with torch.inference_mode(), rows.band_context(band):
            logits = engine(x)[:, 0].float()
            if band is not None:
                logits = Predictor._gather_bands(logits, band)
        rec.update(logits=logits.cpu().numpy(), f32_launches=launches())
        torch.save(rec, os.path.join(args.rows_out, f"rank{args.rows_worker}of{args.rows_world}.pt"))
    finally:
        if mesh is not None:
            mesh.close()


def run_children(cmds, label):
    """Start ``cmds`` (this script with child flags) together; fail ``label`` when one fails or
    outlives DP_CHILD_TIMEOUT_S, printing their output."""
    children = [subprocess.Popen([sys.executable, os.path.abspath(__file__), *cmd], stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True) for cmd in cmds]
    try:
        logs = [c.communicate(timeout=DP_CHILD_TIMEOUT_S)[0] for c in children]
    except subprocess.TimeoutExpired:
        logs = None
    finally:
        for c in children:
            if c.poll() is None:
                c.kill()
                c.communicate()
    if logs is None or any(c.returncode for c in children):
        for i, log in enumerate(logs or []):
            print(f"    process {i}: {log[-3000:]}")
        fail(f"{label}: a process failed or hung (limit {DP_CHILD_TIMEOUT_S} s); its output is above")
    return logs


def row_sharding(seed, card, dev, gen, max_err, run_epochs):
    """Phase 16: row sharding.  (a) the halo kernels band by band (``halo_kernels``); (b) one image of
    the largest side one process serves, through the bf16 engine on a Gloo pair sharing the card,
    each rank a band, against one process (phase 5's bf16 limits; in f32 ROWS_F32_TOL of max|logit|),
    with each rank's launches, peak memory and wall time beside one process's; (c) the flagship's
    f32 training at 224x224, B=4, on the pair, against one process (phase 14(b)'s limits), default
    and grad_accum 2 exact.  Returns the launch counts of the pair's runs (not those of the
    comparisons with the plain versions, nor of the single-process references)."""
    import torch

    from dfc_sa_unet_torch.data.normalize import normalize
    from dfc_sa_unet_torch.models.factory import create_model
    from dfc_sa_unet_torch.ops import launches
    from dfc_sa_unet_torch.parallel.mesh import local_coordinator
    from dfc_sa_unet_torch.utils.weights import calibrate_batch_stats_, init_random_

    print(f"[16] row sharding, seed {seed} ({card})", flush=True)
    t_phase = time.perf_counter()
    path = {k: 0 for k in launches()}
    run_counts = {}

    def count(label, got):
        run_counts[label] = {k: v for k, v in got.items() if v}
        for k, v in got.items():
            path[k] += v

    # (a) the halo kernels, in this process
    halo_kernels(dev, gen, max_err, card)

    # (b) one large image on a Gloo pair sharing the card, against one process
    tmp = tempfile.TemporaryDirectory()
    model = init_random_(create_model(CONFIG, device="cpu"), torch.Generator().manual_seed(seed)).to(dev)
    calib = np.random.default_rng(seed).integers(0, 256, (16, IMG, IMG, 3), dtype=np.uint8)
    calibrate_batch_stats_(model, normalize(torch.from_numpy(calib).to(dev)).permute(0, 3, 1, 2))
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, os.path.join(tmp.name, "weights.pt"))
    del model
    torch.cuda.empty_cache()
    child = ["--seed", str(seed), "--rows_out", tmp.name]
    run_children([[*child, "--rows_worker", "0", "--rows_world", "1"]], "phase 16(b), one process")
    one = torch.load(os.path.join(tmp.name, "rank0of1.pt"), weights_only=False)
    side = one["side"]
    coordinator = local_coordinator()
    run_children([[*child, "--rows_worker", str(r), "--rows_world", "2", "--rows_coordinator", coordinator,
                   "--rows_side", str(side)] for r in range(2)], "phase 16(b), the Gloo pair")
    pair = [torch.load(os.path.join(tmp.name, f"rank{r}of2.pt"), weights_only=False) for r in range(2)]
    per_forward = {**{k: 0 for k in path}, "pooled_attention": 9, "lsa_epilogue": 9, "dfc_tail": 7,
                   "conv3x3_bn_relu": 2}
    want_logit = logit_of(one["probs"])
    std = float(want_logit.std())
    bad = []
    if one["bf16_launches"] != per_forward or one["f32_launches"] != per_forward:
        bad.append(f"one process launched {one['bf16_launches']} (bf16), {one['f32_launches']} (f32)")
    for r, got in enumerate(pair):
        count(f"(b) rank {r} bf16", got["bf16_launches"])
        count(f"(b) rank {r} f32", got["f32_launches"])
        d = np.abs(logit_of(got["probs"]) - want_logit) / std
        f32 = float(np.abs(got["logits"] - one["logits"]).max() / np.abs(one["logits"]).max())
        print(f"    (b) rank {r} of 2: a band of {side // 2} rows of a {side}x{side} image; bf16 engine: |dlogit| / std "
              f"max {d.max():.3e} (tol {DLOGIT_TOL_BF16['max']}), mean {d.mean():.3e} (tol {DLOGIT_TOL_BF16['mean']}) "
              f"against one process (logit std {std:.3e}); f32 logits within {f32:.3e} of max|logit| (tol "
              f"{ROWS_F32_TOL}); launches {run_counts[f'(b) rank {r} bf16']} a forward; peak "
              f"{got['peak_gib']:.3f} GiB against one process's {one['peak_gib']:.3f}; request {got['wall_ms']:.1f} ms "
              f"wall against one process's {one['wall_ms']:.1f} ({card})", flush=True)
        if got["probs"].shape != (1, side, side) or not np.isfinite(got["probs"]).all() or std < MIN_LOGIT_STD:
            bad.append(f"rank {r}: probabilities of shape {got['probs'].shape}, logit std {std:.3e}")
        if not (d.max() <= DLOGIT_TOL_BF16["max"] and d.mean() <= DLOGIT_TOL_BF16["mean"] and f32 <= ROWS_F32_TOL):
            bad.append(f"rank {r} disagrees with one process")
        if got["bf16_launches"] != per_forward or got["f32_launches"] != per_forward:
            bad.append(f"rank {r} launched {got['bf16_launches']} (bf16), {got['f32_launches']} (f32), expected "
                       f"9/9/7/2 a forward")
    if bad:
        fail("phase 16(b): " + "; ".join(bad))
    tmp.cleanup()

    # (c) training on the pair, each rank a band of every image's rows, default and exact
    for label, training in (("default", None), ("exact", EXACT)):
        with tempfile.TemporaryDirectory() as work:
            got = gloo_pair_against_one(seed, card, dev, work, f"phase 16(c) {label}", training, run_epochs,
                                        spatial=2, batch=ROWS_TRAIN_BATCH)
        for r, counts in enumerate(got):
            count(f"(c) {label} rank {r}", counts)
    print(f"    row-sharding launches, run by run: {run_counts}; the phase's {path}; "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return path


# ------------------------------------------------------------------ phase 17: the rest of row sharding

def rows17_kernels(dev, gen, max_err, card):
    """Phase 17(a): conv3x3_s8's halo instantiation band by band at the int8 engine's four levels (B=4,
    224x224), bf16 and f32 out, in 2 and 4 bands and a band of one row beside one of odd height, after a
    launch on rows of all +127: stitched, equal bit for bit to the whole image's kernel and to the plain
    version given the same rows; then the pooled attention with a band's queries against every key (2
    bands) at the full-resolution model's key counts (4096, 1024, 256, 64; C' = C / 8), bf16 and f32, after
    a launch on NaN queries: each band within phase 3's limits of the plain version and equal bit for bit
    to the band's rows of the whole image's kernel (a query's row of the product does not depend on the
    others).  Fails the phase otherwise."""
    import torch

    from dfc_sa_unet_torch.ops import conv_s8 as s8_ops
    from dfc_sa_unet_torch.ops import pooled_attention as attn_ops
    from scripts import bench_torch_int8 as int8_bench

    bad, t0 = [], time.perf_counter()
    with torch.inference_mode():
        for out_dtype in (torch.bfloat16, torch.float32):
            dn = str(out_dtype).split(".")[-1]
            for name, h, cin, c in int8_bench.LEVELS:
                x8, w8, scale, bias = int8_bench.inputs(4, h, h, cin, c, gen)

                def kernel(x, top=None, bottom=None, fn=s8_ops.conv3x3_s8):
                    return fn(x, w8, scale, bias, out_dtype, top=top, bottom=bottom)

                whole = kernel(x8)
                for label, cuts in band_cuts(h).items():
                    got = by_bands(kernel, x8, (), (), cuts, poison=True)
                    want = by_bands(lambda x, top=None, bottom=None: kernel(x, top, bottom, s8_ops.conv3x3_s8_plain),
                                    x8, (), (), cuts)
                    torch.cuda.synchronize()
                    equal, plain = torch.equal(got, whole), torch.equal(got, want)
                    err = (got.float() - want.float()).abs().max().item()
                    max_err["conv3x3_s8"] = max(max_err["conv3x3_s8"], err)
                    print(f"    conv3x3_s8 halo  {dn} {name:10s} B=4 {h}x{h} {cin}->{c}, {label} {cuts}: stitched "
                          f"{'equal to' if equal else 'DIFFERENT from'} the whole image's kernel, "
                          f"{'equal to' if plain else 'DIFFERENT from'} the plain version (max_abs_err {err:.1e})",
                          flush=True)
                    if not (equal and plain):
                        bad.append(f"conv3x3_s8 {dn} {name} {label}")
                del x8, w8, whole
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[-1]
            # and an 8x16 map, whose bands of 64 queries sit in another warpgroup's rows than in the whole map
            for name, h, w, c in [(name, h, h, c) for name, h, c in FULLRES_SHAPES[:4]] + [("8x16", 8, 16, 128)]:
                shape = (ROWS17_ATTN_BATCH, h, w)
                q, k = (torch.randn(*shape, c // 8, generator=gen, device=dev).to(dtype) for _ in range(2))
                v = torch.randn(*shape, c, generator=gen, device=dev).to(dtype)
                whole = attn_ops.pooled_attention(q, k, v)
                for s in range(2):
                    qb = q[:, s * h // 2:(s + 1) * h // 2].contiguous()
                    attn_ops.pooled_attention(torch.full_like(qb, float("nan")), k, v)
                    got = attn_ops.pooled_attention(qb, k, v)
                    want = attn_ops.pooled_attention_plain(qb, k, v)
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs().max().item()
                    lim = TOL[dn] * max(1.0, want.float().abs().max().item())
                    equal = torch.equal(got, whole[:, s * h // 2:(s + 1) * h // 2])
                    max_err["pooled_attention"] = max(max_err["pooled_attention"], err)
                    print(f"    pooled_attention {dn} {name:6s} B={ROWS17_ATTN_BATCH} {h * w // 2} queries of {h * w} keys, "
                          f"C' {c // 8}, C {c}, band {s} of 2 ({attn_ops.entry_point(dtype, h * w)}): max_abs_err vs plain "
                          f"{err:.3e} (tol {lim:.2e}); {'equal to' if equal else 'DIFFERENT from'} the band's rows of "
                          f"the whole map's launch", flush=True)
                    if not (equal and np.isfinite(err) and err <= lim):
                        bad.append(f"pooled_attention {dn} {name} band {s}")
    print(f"    halo conv3x3_s8 and fewer-query attention checked in {time.perf_counter() - t0:.1f} s ({card})", flush=True)
    if bad:
        fail("phase 17(a): " + "; ".join(bad[:8]))


def band_logits(fn, x, band):
    """f32 logits [B, C, H, W] of ``fn`` on the normalised NCHW images x: the band's rows, gathered over
    its group (the whole images' without a band)."""
    import torch

    from dfc_sa_unet_torch.parallel import rows

    with torch.inference_mode(), rows.band_context(band):
        part = x if band is None else x[:, :, band.row0:band.row0 + band.rows]
        logits = fn(part.contiguous(memory_format=torch.channels_last)).float()
        return (logits if band is None else rows.all_gather_rows(logits, band)).cpu().numpy()


def rows17_worker(args, device="cuda:0"):
    """One process of phase 17(b)-(c), on cuda:0 in a Gloo group of ``--rows_world`` (2: a serving mesh of
    two bands; 1: one process, whose group makes the Trainer take the data-parallel path, so that its
    dropout seed is the pair's).  For each model of ROWS17_MODELS (the weights in ``--rows_out``): a bf16
    request of ROWS17_IMAGES images through the Predictor (a warm-up, then the timed one: its launches,
    among them the pooled attention's with fewer queries than keys, its peak memory and wall time) and the
    f32 module's logits of two; the int8 engines (calibrated at max |t| on 8 whole synthetic images, the
    same in every process): the bf16 request, the flagship's on one 2048x2048 image, and the f32 int8
    flagship's logits of that image with the same scales; then one f32 training step of each model at a
    global batch of ROWS17_TRAIN_BATCH.  Saves everything into ``--rows_out``."""
    import torch

    from dfc_sa_unet_torch.data.normalize import normalize
    from dfc_sa_unet_torch.data.synthetic import samples
    from dfc_sa_unet_torch.infer.predictor import Predictor
    from dfc_sa_unet_torch.infer.quant import Int8DFCEngine
    from dfc_sa_unet_torch.infer.quant_transunet import Int8TransUNetEngine
    from dfc_sa_unet_torch.infer.quant_vit import Int8ViTEngine
    from dfc_sa_unet_torch.models.factory import create_model
    from dfc_sa_unet_torch.ops import launches, reset_launches
    from dfc_sa_unet_torch.parallel.mesh import serving_mesh

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    mesh = serving_mesh(args.rows_world, device=dev, backend="gloo", coordinator=args.rows_coordinator,
                        num_processes=args.rows_world, process_id=args.rows17_worker, timeout_s=DP_CHILD_TIMEOUT_S)
    weights = torch.load(os.path.join(args.rows_out, "weights17.pt"))
    rec = {"serve": {}, "train": {}}

    def request(pred, images):
        with torch.inference_mode():
            pred.predict_probs(images)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            t0 = time.perf_counter()
            probs = pred.predict_probs(images)
            return {"probs": probs, "wall_ms": (time.perf_counter() - t0) * 1e3, "launches": launches(),
                    "peak_gib": torch.cuda.max_memory_allocated() / 2**30}

    def band_of(side):
        return mesh.band(side) if mesh.spatial > 1 else None

    def calibration(side, dtype):
        synthetic = np.stack([img for _, img, _ in samples(n=INT8_CALIB_IMAGES, size=side, seed=args.seed)])
        return normalize(torch.from_numpy(synthetic).to(dev), dtype).permute(0, 3, 1, 2)

    try:
        bf = torch.bfloat16
        for label, (cfg, side, _) in ROWS17_MODELS.items():
            images = np.random.default_rng(args.seed).integers(0, 256, (ROWS17_IMAGES, side, side, 3), dtype=np.uint8)
            for dtype in (bf, torch.float32):
                model = create_model(cfg, dtype=dtype if dtype == bf else None, device=dev)
                model.load_state_dict(weights[label])
                model.eval()
                if dtype == bf:
                    rec["serve"][label] = request(Predictor(model, compute_dtype=bf, device=dev, mesh=mesh), images)
                else:
                    x = normalize(torch.from_numpy(images[:ROWS17_F32_IMAGES]).to(dev)).permute(0, 3, 1, 2)
                    rec["serve"][label]["logits"] = band_logits(model, x, band_of(side))
                del model
                torch.cuda.empty_cache()
        for label, (source, side, _) in ROWS17_INT8.items():
            images = np.random.default_rng(args.seed).integers(0, 256, (1 if source == "flagship" else ROWS17_IMAGES,
                                                                        side, side, 3), dtype=np.uint8)
            kw = dict(device=dev, calib_batches=[calibration(IMG, bf)])
            with torch.inference_mode():
                if source == "flagship":
                    engine = Int8DFCEngine(CONFIG, weights[source], dtype=bf, tail_kernel_levels="auto",
                                           conv_kernel_levels="auto", **kw)
                elif source == "ViT-B/16":
                    engine = Int8ViTEngine(ZOO["ViT-seg"][0], weights[source], dtype=bf, **kw)
                else:
                    engine = Int8TransUNetEngine(ZOO["TransUNet"][0], weights[source], dtype=bf, **kw)
            rec["serve"][label] = request(Predictor(engine, compute_dtype=bf, device=dev, mesh=mesh), images)
            if source == "flagship":  # the f32 int8 engine with the same scales, on the same image
                scales = engine.act_scales
                del engine
                torch.cuda.empty_cache()
                engine = Int8DFCEngine(CONFIG, weights[source], dtype=torch.float32, device=dev, act_scales=scales,
                                       tail_kernel_levels="auto", conv_kernel_levels="auto")
                x = normalize(torch.from_numpy(images).to(dev)).permute(0, 3, 1, 2)
                rec["serve"][label]["logits"] = band_logits(engine, x, band_of(side))
            del engine
            torch.cuda.empty_cache()
        for label, (cfg, side, _) in ROWS17_MODELS.items():
            data = list(samples(n=ROWS17_TRAIN_BATCH, size=side, seed=args.seed))
            trainer = seeded_trainer(cfg, ROWS17_TRAIN_BATCH, data, False, dev,
                                     os.path.join(args.rows_out, f"train{args.rows17_worker}of{args.rows_world}"),
                                     args.seed, mesh=mesh)
            reset_launches()
            trainer.train_epoch(0)
            rec["train"][label] = {"step_log": trainer.step_log, "launches": launches(),
                                   "state": {k: v.detach().cpu() for k, v in trainer.model.state_dict().items()}}
            del trainer
            torch.cuda.empty_cache()
        torch.save(rec, os.path.join(args.rows_out, f"rows17_rank{args.rows17_worker}of{args.rows_world}.pt"))
    finally:
        mesh.close()


def banded_queries(label, launched):
    """The pooled-attention launches of a band's run, of a model of phase 17 that one process ran with
    ``launched``, that take fewer queries than keys: every one of the full-resolution model's (its band's
    queries against the whole image's keys), none of another's (pooled keys, cut to the band too)."""
    return launched["pooled_attention"] if label == "UNet_FullResAttention" else 0


def row_sharding_families(seed, card, dev, gen, max_err):
    """Phase 17: the rest of row sharding.  (a) the s8 conv's halo instantiation and the attention with
    fewer queries than keys (``rows17_kernels``); (b) ViT-B/16 and R50-ViT-B/16 at 224x224 (the tokens
    gathered over the bands, the transformer whole on each), UNet_FullResAttention at 64x64 (the band's
    queries against the gathered keys) and the bilinear UNet at 224x224 served in bf16 by a Gloo pair
    sharing the card, each rank a band of half the rows, against one process (phase 5's bf16 limits,
    TransUNet at phase 6's wider ones; their f32 logits within ROWS_F32_TOL of max |logit|, R50-ViT-B/16's
    within ROWS17_F32_TOL, each limit failed by the pair's bf16 logits), and the three int8 engines (the
    flagship's on one 2048x2048 image, bf16, and f32 at phase 13's limits; the transformers' at their
    modules' bf16 limits, as phase 13 holds them); each
    rank's launches a forward, peak memory and wall time beside one process's; (c) one f32 training step of
    each of the four models on the pair against one process (phase 14(b)'s limits; the transformers at
    their configured dropout, whose masks the pair draws alike).  Returns the launch counts of the pair's
    runs (not those of (a)'s comparisons, nor of the single-process references), among them the pooled
    attention's with fewer queries than keys: the full-resolution model's, a band's queries against every
    key."""
    import torch

    from dfc_sa_unet_torch.data.normalize import normalize
    from dfc_sa_unet_torch.models.factory import create_model
    from dfc_sa_unet_torch.ops import launches
    from dfc_sa_unet_torch.parallel.mesh import local_coordinator
    from dfc_sa_unet_torch.utils.weights import calibrate_batch_stats_, init_random_

    print(f"[17] row sharding of the transformers, the full-resolution attention, the bilinear UNet and the int8 "
          f"engines, seed {seed} ({card})", flush=True)
    t_phase = time.perf_counter()
    path = {k: 0 for k in launches()}
    run_counts = {}

    def count(label, got):
        run_counts[label] = {k: v for k, v in got.items() if v}
        for k, v in got.items():
            path[k] += v

    # (a) the kernels, in this process
    rows17_kernels(dev, gen, max_err, card)

    # the weights: seeded, BatchNorm statistics fitted to 16 synthetic images so that the logits spread
    tmp = tempfile.TemporaryDirectory()
    weights = {}
    for label, (cfg, side, _) in [("flagship", (CONFIG, IMG, None)), *ROWS17_MODELS.items()]:
        model = init_random_(create_model(cfg, device="cpu"), torch.Generator().manual_seed(seed)).to(dev)
        calib = np.random.default_rng(seed).integers(0, 256, (16, side, side, 3), dtype=np.uint8)
        calibrate_batch_stats_(model, normalize(torch.from_numpy(calib).to(dev)).permute(0, 3, 1, 2))
        weights[label] = {k: v.cpu() for k, v in model.state_dict().items()}
        del model
    torch.save(weights, os.path.join(tmp.name, "weights17.pt"))
    del weights
    torch.cuda.empty_cache()
    t_weights = time.perf_counter() - t_phase

    # (b) and (c): one process, then the pair
    child = ["--seed", str(seed), "--rows_out", tmp.name]
    run_children([[*child, "--rows17_worker", "0", "--rows_world", "1", "--rows_coordinator", local_coordinator()]],
                 "phase 17(b)-(c), one process")
    one = torch.load(os.path.join(tmp.name, "rows17_rank0of1.pt"), weights_only=False)
    coordinator = local_coordinator()
    run_children([[*child, "--rows17_worker", str(r), "--rows_world", "2", "--rows_coordinator", coordinator]
                  for r in range(2)], "phase 17(b)-(c), the Gloo pair")
    pair = [torch.load(os.path.join(tmp.name, f"rows17_rank{r}of2.pt"), weights_only=False) for r in range(2)]
    tmp.cleanup()
    bad = []
    expected = {**{label: want for label, (_, _, want) in ROWS17_MODELS.items()},
                **{label: want for label, (_, _, want) in ROWS17_INT8.items()}}
    for label, want in expected.items():
        ref = one["serve"][label]
        lim = ROWS17_TOL.get(label, DLOGIT_TOL_BF16)
        want_logit = logit_of(ref["probs"])
        std = float(want_logit.std())
        per_forward = {**{k: 0 for k in path}, **want}
        if ref["launches"] != per_forward:
            bad.append(f"{label}: one process launched {ref['launches']}")
        per_band = {**per_forward, "pooled_attention.fewer_queries": banded_queries(label, per_forward)}
        for r, got in enumerate(pair):
            g = got["serve"][label]
            count(f"(b) {label} rank {r}", g["launches"])
            d = np.abs(logit_of(g["probs"]) - want_logit) / std
            f32 = ""
            if "logits" in ref:
                rel = float(np.abs(g["logits"] - ref["logits"]).max() / np.abs(ref["logits"]).max())
                if label.startswith("int8"):  # the f32 int8 flagship: phase 13's limits, in units of std
                    dl = np.abs(g["logits"] - ref["logits"]) / ref["logits"].std()
                    f32 = (f"; f32 int8 |dlogit| / std max {dl.max():.3e} mean {dl.mean():.3e} (tol "
                           f"{DLOGIT_TOL_INT8_CPU['max']}, {DLOGIT_TOL_INT8_CPU['mean']})")
                    f32_ok = dl.max() <= DLOGIT_TOL_INT8_CPU["max"] and dl.mean() <= DLOGIT_TOL_INT8_CPU["mean"]
                else:
                    tol = ROWS17_F32_TOL.get(label, ROWS_F32_TOL)
                    n, ref_logit = ref["logits"].shape[0], ref["logits"][:, 0]
                    seen = np.abs(ref_logit) < ROWS17_LOGIT_CLIP
                    ctl = float(np.abs(logit_of(g["probs"][:n]) - ref_logit)[seen].max() / np.abs(ref_logit).max())
                    f32 = (f"; f32 logits within {rel:.3e} of max|logit| (tol {tol}); control, the bf16 logits "
                           f"{ctl:.3e}")
                    f32_ok = rel <= tol
                    if ctl <= tol:
                        bad.append(f"{label} rank {r}: the bf16 control passes the f32 limit {tol}")
                if not f32_ok:
                    bad.append(f"{label} rank {r}: f32 disagrees with one process")
            fq = g["launches"]["pooled_attention.fewer_queries"]
            print(f"    (b) {label} rank {r} of 2, bf16, {g['probs'].shape[0]} x {g['probs'].shape[1]}x{g['probs'].shape[2]} "
                  f"(a band of {g['probs'].shape[1] // 2} rows): |dlogit| / std max {d.max():.3e} (tol {lim['max']}), "
                  f"mean {d.mean():.3e} (tol {lim['mean']}) against one process (logit std {std:.3e}){f32}; launches "
                  f"{run_counts[f'(b) {label} rank {r}']} a forward ({fq} with fewer queries than keys); peak "
                  f"{g['peak_gib']:.3f} GiB against one process's {ref['peak_gib']:.3f}; request {g['wall_ms']:.1f} ms "
                  f"wall against one process's {ref['wall_ms']:.1f} ({card})", flush=True)
            if not np.isfinite(g["probs"]).all() or g["probs"].shape != ref["probs"].shape or std < MIN_LOGIT_STD:
                bad.append(f"{label} rank {r}: probabilities of shape {g['probs'].shape}, logit std {std:.3e}")
            if not (d.max() <= lim["max"] and d.mean() <= lim["mean"]):
                bad.append(f"{label} rank {r} disagrees with one process")
            if g["launches"] != per_band:
                bad.append(f"{label} rank {r} launched {g['launches']}, expected {per_band} a forward")
    for label, (cfg, side, want) in ROWS17_MODELS.items():
        ref = one["train"][label]
        want_loss = [s["loss"] for s in ref["step_log"]]
        for r, got in enumerate(pair):
            g = got["train"][label]
            count(f"(c) {label} rank {r}", g["launches"])
            loss = [s["loss"] for s in g["step_log"]]
            worst = max(float(((a.double() - b.double()).abs() - (DP_STATE_TOL["atol"] + DP_STATE_TOL["rtol"]
                                                                    * b.double().abs())).max())
                        for a, b in ((g["state"][k], v) for k, v in ref["state"].items()) if b.is_floating_point())
            print(f"    (c) {label} rank {r} of 2, f32, global batch {ROWS17_TRAIN_BATCH} at {side}x{side}: loss "
                  f"{[round(v, 6) for v in loss]} against one process's {[round(v, 6) for v in want_loss]}; state "
                  f"{'within' if worst <= 0 else 'OUTSIDE'} phase 14(b)'s limits; {g['step_log'][0]['ms']:.1f} ms/step "
                  f"against one process's {ref['step_log'][0]['ms']:.1f}; launches {run_counts[f'(c) {label} rank {r}']} "
                  f"({card})", flush=True)
            if not np.allclose(loss, want_loss, **DP_LOSS_TOL) or len(loss) != 1 or worst > 0:
                bad.append(f"(c) {label} rank {r} disagrees with one process")
            per_band = {**ref["launches"], "pooled_attention.fewer_queries": banded_queries(label, ref["launches"])}
            if g["launches"] != per_band:
                bad.append(f"(c) {label} rank {r} launched {g['launches']}, expected {per_band}")
    if bad:
        fail("phase 17: " + "; ".join(bad[:10]))
    print(f"    phase 17 launches, run by run: {run_counts}; the phase's {path}; weights {t_weights:.1f} s; "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return path


def ulps(got, want) -> int:
    """The largest distance of ``got`` from ``want`` (bf16 or f32) in units in the last place: the floats
    as integers in the order of their values (sign and magnitude to two's complement)."""
    import torch

    def ordered(t):
        bits = t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32).to(torch.int64)
        mag = bits & (0x7FFF if t.dtype == torch.bfloat16 else 0x7FFFFFFF)
        return torch.where(bits < 0, -mag, mag)

    return int((ordered(got) - ordered(want)).abs().max().item())


def model_config(name):
    """The YAML model section of one of the DFC zoo's nine names."""
    return {"model": {"name": name, "bilinear": False} if name == "UNet" else {"name": name, **DFC_WIDTHS}}


def without_bias(got, least, label):
    """The launch counts ``got`` without the bias pass's, once those are held to at least ``least``: a
    training step through the layers of nn/layers.py adds each bias through ops.bias_add's kernel."""
    if got.get("bias_add", 0) < least:
        fail(f"{label}: {got.get('bias_add', 0)} bias_add launches, expected at least {least}")
    return {k: v for k, v in got.items() if k != "bias_add"}


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def logit_of(p):
    return np.log(np.clip(p, 1e-7, 1 - 1e-7) / np.clip(1 - p, 1e-7, 1))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    # phase 14(b)'s child processes: this script run as one rank of a group
    ap.add_argument("--dp_worker", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dp_world", type=int, default=2, help=argparse.SUPPRESS)
    ap.add_argument("--dp_coordinator", type=str, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dp_out", type=str, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dp_exact", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--dp_spatial", type=int, default=1, help=argparse.SUPPRESS)
    ap.add_argument("--dp_batch", type=int, default=DP_BATCH, help=argparse.SUPPRESS)
    # phase 16(b)'s serving processes: one band each of a Gloo pair (--rows_world 2), or one process
    ap.add_argument("--rows_worker", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--rows_world", type=int, default=1, help=argparse.SUPPRESS)
    ap.add_argument("--rows_coordinator", type=str, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--rows_out", type=str, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--rows_side", type=int, default=None, help=argparse.SUPPRESS)
    # phase 17(b)-(c)'s processes: one band each of a Gloo pair (--rows_world 2), or one process
    ap.add_argument("--rows17_worker", type=int, default=None, help=argparse.SUPPRESS)
    # phase 14(c)'s serving processes: the inference CLI on the arguments after "--"
    ap.add_argument("--serve_worker", type=str, default=None, help=argparse.SUPPRESS)
    # phase 15(d)'s processes: a first request with the kernels built in, or loaded from, a directory
    ap.add_argument("--cache_child", type=str, default=None, help=argparse.SUPPRESS)
    argv = sys.argv[1:]
    cut = argv.index("--") if "--" in argv else len(argv)
    cli = ap.parse_args(argv[:cut])
    seed = cli.seed

    # ------------------------------------------------------------ phase 1
    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available: chip_smoke.py needs an H100")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import dfc_sa_unet_torch  # noqa: F401
    except ImportError as e:
        fail(f"dfc_sa_unet_torch is not beside chip_smoke.py ({e})")
    if cli.dp_worker is not None:
        return dp_worker(cli)
    if cli.serve_worker is not None:
        return serve_worker(cli, argv[cut + 1:])
    if cli.cache_child is not None:
        return cache_child(cli)
    if cli.rows_worker is not None:
        return rows_worker(cli)
    if cli.rows17_worker is not None:
        return rows17_worker(cli)
    from dfc_sa_unet_torch.infer.engine import AUTO_TAIL_LEVELS, DFCEngine
    from dfc_sa_unet_torch.infer.predictor import Predictor
    from dfc_sa_unet_torch.infer.quant import Int8DFCEngine, int8_self_check
    from dfc_sa_unet_torch.infer.quant_transunet import Int8TransUNetEngine
    from dfc_sa_unet_torch.infer.quant_vit import Int8ViTEngine
    from dfc_sa_unet_torch.models.factory import ModelFactory, create_model
    from dfc_sa_unet_torch.ops import _build, launches, reset_launches
    from dfc_sa_unet_torch.ops import conv_bn_stats as stats_ops
    from dfc_sa_unet_torch.ops import conv_s8 as s8_ops
    from dfc_sa_unet_torch.ops import dfc_tail as tail_ops, mha as mha_ops, pooled_attention as attn_ops
    from dfc_sa_unet_torch.ops import lsa_epilogue as lsa_ops
    from dfc_sa_unet_torch.ops import mxu_probes as probe_ops
    from dfc_sa_unet_torch.data.normalize import normalize
    from dfc_sa_unet_torch.data.synthetic import samples
    from dfc_sa_unet_torch.utils.weights import calibrate_batch_stats_, init_random_, load_state_dict_file
    from scripts import bench_torch_bias_add as bias_bench
    from scripts import bench_torch_bn_stats as probe
    from scripts import bench_torch_conv3x3 as conv_bench
    from scripts import bench_torch_dfc_tail as tail_bench
    from scripts import bench_torch_int8 as int8_bench
    from scripts import bench_torch_mxu as mxu

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    card = smi[0].strip() if smi else "nvidia-smi gave nothing"
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                           capture_output=True, text=True, timeout=60).stdout.split()
    if not clock:
        fail("nvidia-smi gave no maximum SM clock: the exponential bound needs it")
    sm_mhz = float(clock[0])
    exps_per_s = SMS * EXP_PER_CLOCK * sm_mhz * 1e6
    print(f"[1] card: {card}; maximum SM clock {sm_mhz:.0f} MHz; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)

    # ------------------------------------------------------------ phase 2
    t0 = time.perf_counter()
    _build.build()
    print(f"[2] built {sorted(p.name for p in _build.BUILD_DIR.glob('*.so'))} "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    for log in sorted(_build.BUILD_DIR.glob("*.log")):
        regs = [ln.split("Used")[1].split(",")[0].strip() for ln in log.read_text().splitlines() if "Used" in ln]
        spills = sum("0 bytes spill stores" not in ln for ln in log.read_text().splitlines() if "spill stores" in ln)
        print(f"    {log.stem}: registers per kernel instance {regs}; instances with spills: {spills}")
    # the wgmma kernels of conv3x3_bn_relu (and their halo instantiations, row sharding) and
    # conv3x3_bias_stats (the ring's and the persistent one), probe_matmul, conv3x3_s8 and the bf16
    # pooled attention: ptxas must neither serialize their products (C7515) nor spill
    for stem, kernel in (("dfc_tail", "conv3x3_bn_relu_wgmma_kernel"), ("dfc_tail", "conv3x3_bn_relu_narrow_kernel"),
                         ("dfc_tail", "conv3x3_bn_relu_wgmma_halo_kernel"),
                         ("dfc_tail", "conv3x3_bn_relu_narrow_halo_kernel"),
                         ("conv_bn_stats", "conv3x3_bias_stats_wgmma_kernel"),
                         ("conv_bn_stats", "conv3x3_bias_stats_narrow_kernel"), ("mxu_probes", "probe_matmul_kernel"),
                         ("conv3x3_s8", "conv3x3_s8_kernel"), ("conv3x3_s8", "conv3x3_s8_halo_kernel"),
                         ("pooled_attention", "pooled_attention_wgmma_kernel")):
        text = (_build.BUILD_DIR / f"{stem}.log").read_text()
        entry, found = "", []
        for ln in text.splitlines():
            if "Compiling entry function" in ln:
                entry = ln
            elif "spill stores" in ln and kernel in entry:
                found.append(ln.split(":", 1)[-1].strip())
        print(f"    {kernel}: {len(found)} instances, {found}")
        if "C7515" in text or not found or any("0 bytes spill stores" not in ln for ln in found):
            fail(f"ptxas serialized the wgmma products or spilled in {stem}.cu ({kernel}): see {stem}.log")

    # ------------------------------------------------------------ phase 3
    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    def attn_inputs(b, n, c, dtype):
        return (randn(b, n, 1, c // 8, dtype=dtype), randn(b, n, 1, c // 8, dtype=dtype),
                randn(b, n, 1, c, dtype=dtype))

    def conv_inputs(b, h, cin, c, dtype, w=None):
        return (randn(b, h, h if w is None else w, cin, dtype=dtype),
                randn(3, 3, cin, c, dtype=dtype, scale=(9 * cin) ** -0.5), randn(c))

    def tail_inputs(b, h, cin, c, dtype, w=None):
        w = h if w is None else w
        return (randn(b, h, w, cin, dtype=dtype), randn(b, h, w, c, dtype=dtype),
                randn(3, 3, cin, c, dtype=dtype, scale=(9 * cin) ** -0.5), randn(c),
                randn(2 * c, c, dtype=dtype, scale=(2 * c) ** -0.5), randn(c),
                randn(3 * c, c, dtype=dtype, scale=(3 * c) ** -0.5), randn(c),
                randn(cin, c, dtype=dtype, scale=0.1 * cin ** -0.5))

    def mha_inputs(b, n, e, dtype, packed):
        qkv = randn(b, n, 3 * e, dtype=dtype)
        return (qkv,) if packed else tuple(t.contiguous() for t in qkv.chunk(3, dim=-1))

    def grid_attn_inputs(b, h, w, cq, c, dtype):
        return randn(b, h, w, cq, dtype=dtype), randn(b, h, w, cq, dtype=dtype), randn(b, h, w, c, dtype=dtype)

    max_err = {"pooled_attention": 0.0, "dfc_tail": 0.0, "conv3x3_bn_relu": 0.0, "fused_mha": 0.0,
               "fused_mha_sep": 0.0, "conv3x3_bias_stats": 0.0, "probe_matmul": 0.0, "probe_conv_cat": 0.0,
               "probe_conv_9dot": 0.0, "conv3x3_s8": 0.0, "lsa_epilogue": 0.0, "bias_add": 0.0}
    bad = []

    def check(name, kernel, plain, args, label, poison=(), floor=1.0):
        """kernel(*args) against plain(*args), to TOL of max(floor, max|plain|); first, where ``poison``
        names arguments, one launch with those filled with NaN, so that a kernel reading shared memory it
        did not write this launch (padding, a stale buffer) fails the check instead of passing by luck."""
        if poison:
            kernel(*(torch.full_like(a, float("nan")) if i in poison else a for i, a in enumerate(args)))
            torch.cuda.synchronize()
        got = kernel(*args)
        torch.cuda.synchronize()
        want = plain(*args)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        scale = max(floor, want.float().abs().max().item())
        tol = TOL[str(args[0].dtype).split(".")[-1]] * scale
        ok = bool(np.isfinite(err)) and err <= tol and got.shape == want.shape
        max_err[name] = max(max_err[name], err)
        print(f"    {name:16s} {label:38s} max_abs_err {err:.3e} (rel {err / scale:.2e}) "
              f"tol {tol:.2e} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            bad.append(f"{name} {label}")

    def check_stats(args, label):
        """y to TOL of max(1, max|y|); mean and mean2 to TOL of max(1, max|plain|) each; after a launch
        on NaN inputs, as ``check``'s poison."""
        stats_ops.conv3x3_bias_stats(torch.full_like(args[0], float("nan")), *args[1:])
        torch.cuda.synchronize()
        got = stats_ops.conv3x3_bias_stats(*args)
        torch.cuda.synchronize()
        want = stats_ops.conv3x3_bias_stats_plain(*args)
        torch.cuda.synchronize()
        rel = []
        for g, w in zip(got, want):
            err = (g.float() - w.float()).abs().max().item()
            rel.append(err / max(1.0, w.float().abs().max().item()))
            max_err["conv3x3_bias_stats"] = max(max_err["conv3x3_bias_stats"], err)
        tol = TOL[str(args[0].dtype).split(".")[-1]]
        ok = all(np.isfinite(r) and r <= tol for r in rel) and all(g.shape == w.shape for g, w in zip(got, want))
        print(f"    {'conv3x3_bias_stats':16s} {label:38s} rel err y {rel[0]:.2e} mean {rel[1]:.2e} mean2 {rel[2]:.2e} "
              f"tol {tol:.0e} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            bad.append(f"conv3x3_bias_stats {label}")

    def lsa_inputs(b, h, w, c, p, dtype):
        """a (post-ReLU, the attention branch's input), o (the attention's output) and gamma."""
        return (torch.relu(randn(b, h, w, c)).to(dtype), randn(b, p, p, c, dtype=dtype),
                torch.tensor([0.37], device=dev))

    def check_lsa(args, label, band=None):
        """The epilogue kernel against its plain version, within one ulp of the dtype (the kernel spells
        out the roundings and FMAs of torch's upsample kernels, so in practice the same bits)."""
        height, row0 = band or (None, 0)
        got = lsa_ops.lsa_epilogue(*args, height, row0)
        torch.cuda.synchronize()
        want = lsa_ops.lsa_epilogue_plain(*args, height, row0)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        n_ulps, same = ulps(got, want), (got == want).float().mean().item()
        max_err["lsa_epilogue"] = max(max_err["lsa_epilogue"], err)
        ok = n_ulps <= 1 and got.shape == want.shape and got.dtype == want.dtype
        print(f"    {'lsa_epilogue':16s} {label:38s} max_abs_err {err:.3e}, {n_ulps} ulp, {same:.6%} of the elements "
              f"the same bits; tol 1 ulp {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            bad.append(f"lsa_epilogue {label}")

    def check_backward(name, kernel, plain, args, extra, label):
        """Gradients through the wrapper (forward: the kernel; backward: its autograd Function)
        against autograd through the plain version, of the same random output weights."""
        grads = []
        for fn in (kernel, plain):
            leaves = [a.detach().clone().requires_grad_(True) for a in args]
            out = fn(*leaves, *extra)
            if fn is kernel and out.grad_fn is None:
                bad.append(f"{name} {label}: no gradient graph")
                return
            weights = torch.randn(out.shape, generator=torch.Generator(device=dev).manual_seed(1), device=dev)
            (out.float() * weights).sum().backward()
            grads.append([leaf.grad for leaf in leaves])
        torch.cuda.synchronize()
        tol = GRAD_TOL[str(args[0].dtype).split(".")[-1]]
        rel = max((g.float() - w.float()).abs().max().item() / w.float().abs().max().item()
                  for g, w in zip(*grads))
        ok = bool(np.isfinite(rel)) and rel <= tol and all(g.is_contiguous() for g in grads[0])
        print(f"    {name + ' backward':24s} {label:30s} max rel err {rel:.2e} tol {tol:.0e} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            bad.append(f"{name} backward {label}")

    print("[3] kernels vs plain PyTorch on the card", flush=True)
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for c in (64, 128, 256, 512, 1024):
            check("pooled_attention", attn_ops.pooled_attention, attn_ops.pooled_attention_plain,
                  attn_inputs(BATCH, 64, c, dtype), f"{dn} B={BATCH} N=64 C={c}", poison=(0, 1, 2))
        for n in (16, 256, 1024):
            check("pooled_attention", attn_ops.pooled_attention, attn_ops.pooled_attention_plain,
                  attn_inputs(16, n, 256, dtype), f"{dn} B=16 N={n} C=256", poison=(0, 1, 2))
        # the full-resolution model's first level (64x64, Cq=8, C=64), N=1600, N=1025 (a non-square grid, one
        # key in the last chunk), a Cq and a C that no tile divides (Cq 4 and 25, C 100 and 200; rows that are
        # not 16-byte aligned), either side of the f32 threshold (N=128: the 16-row kernel; N=144), one token
        for b, h, w, cq, c in ((8, 64, 64, 8, 64), (4, 40, 40, 8, 64), (4, 25, 41, 8, 64), (2, 40, 40, 4, 100),
                               (4, 8, 16, 8, 64), (4, 12, 12, 8, 64), (4, 1, 1, 8, 64), (4, 8, 8, 25, 200)):
            check("pooled_attention", attn_ops.pooled_attention, attn_ops.pooled_attention_plain,
                  grid_attn_inputs(b, h, w, cq, c, dtype), f"{dn} B={b} N={h * w} ({h}x{w}) Cq={cq} C={c}",
                  poison=(0, 1, 2))
        if dtype == torch.bfloat16:  # the wgmma kernel at every main-path shape and at ragged ones
            for b, h, w, cq, c in ATTN_WGMMA_SHAPES:
                check("pooled_attention", attn_ops.pooled_attention, attn_ops.pooled_attention_plain,
                      grid_attn_inputs(b, h, w, cq, c, dtype), f"{dn} B={b} N={h * w} ({h}x{w}) Cq={cq} C={c}",
                      poison=(0, 1, 2))
        for b, h, w, c, p, band in LSA_SHAPES:
            check_lsa(lsa_inputs(b, h, w, c, p, dtype), f"{dn} B={b} {h}x{w} C={c} p={p}"
                      + (f" band {band[1]}+{h} of {band[0]}" if band else ""), band)
        for name, h, cin, c in BLOCK_SHAPES:
            label = f"{dn} {name} B=4 {h}x{h} {cin}->{c}"
            if name in AUTO_TAIL_LEVELS:
                check("dfc_tail", tail_ops.dfc_tail, tail_ops.dfc_tail_plain,
                      tail_inputs(4, h, cin, c, dtype), label, poison=(0, 1))
            check("conv3x3_bn_relu", tail_ops.conv3x3_bn_relu, tail_ops.conv3x3_bn_relu_plain,
                  conv_inputs(4, h, cin, c, dtype), label, poison=(0,))
        # the conv's tilings: taps packed into a step, steps across taps, B tiles ragged in Cout, blocks
        # ragged in pixels, one pixel
        for b, h, w, cin, c in CONV_ODD_SHAPES:
            tiling = tail_ops.conv_tiling(cin, c)
            check("conv3x3_bn_relu", tail_ops.conv3x3_bn_relu, tail_ops.conv3x3_bn_relu_plain,
                  conv_inputs(b, h, cin, c, dtype, w),
                  f"{dn} B={b} {h}x{w} {cin}->{c} ({tiling.steps} steps, NB {tiling.nb})", poison=(0,))
        # the tail at pixel counts that no block divides (odd H and W, a ragged last block),
        # at C >= 256 (64-pixel blocks) and C <= 128 (128-pixel blocks), at C = 32 and 64, at Cin = 3
        for b, h, w, cin, c in TAIL_ODD_SHAPES:
            check("dfc_tail", tail_ops.dfc_tail, tail_ops.dfc_tail_plain, tail_inputs(b, h, cin, c, dtype, w),
                  f"{dn} B={b} {h}x{w} {cin}->{c}", poison=(0, 1))
        # the ViT-B shape of both models, then N either side of the one-pass kernel's limit and the
        # largest N, at every head dimension the checks name, and awkward ones: a tiny N, one token
        for b, n, e, nh in MHA_SHAPES:
            label = f"{dn} B={b} N={n} E={e} heads={nh} ({mha_ops.entry_point(dtype, n)})"
            check("fused_mha", mha_ops.fused_mha, mha_ops.fused_mha_plain,
                  (*mha_inputs(b, n, e, dtype, packed=True), nh), label, poison=(0,))
            check("fused_mha_sep", mha_ops.fused_mha_sep, mha_ops.fused_mha_sep_plain,
                  (*mha_inputs(b, n, e, dtype, packed=False), nh), label, poison=(0, 1, 2))
        for name, h, cin, c in probe.LEVELS:
            check_stats(conv_inputs(4, h, cin, c, dtype), f"{dn} {name} B=4 {h}x{h} {cin}->{c}")
        check_stats((randn(3, 13, 17, 24, dtype=dtype), randn(3, 3, 24, 40, dtype=dtype, scale=216 ** -0.5), randn(40)),
                    f"{dn} B=3 13x17 24->40")
        # the bf16 kernels' tilings: the persistent kernel and the ring, ragged pixels and columns, one pixel
        for b, h, w, cin, c in STATS_ODD_SHAPES:
            tiling = stats_ops.stats_tiling(cin, c)
            check_stats(conv_inputs(b, h, cin, c, dtype, w),
                        f"{dn} B={b} {h}x{w} {cin}->{c} ({tiling.steps} steps, NB {tiling.nb}, bm {tiling.bm})")
        before = launches()
        check_backward("pooled_attention", attn_ops.pooled_attention, attn_ops.pooled_attention_plain,
                       attn_inputs(8, 64, 256, dtype), (), f"{dn} B=8 N=64 C=256")
        check_backward("pooled_attention", attn_ops.pooled_attention, attn_ops.pooled_attention_plain,
                       grid_attn_inputs(2, 40, 40, 8, 64, dtype), (), f"{dn} B=2 N=1600 C=64")
        check_backward("fused_mha", mha_ops.fused_mha, mha_ops.fused_mha_plain,
                       mha_inputs(4, TOKENS, EMBED, dtype, packed=True), (HEADS,), f"{dn} B=4 N={TOKENS} E={EMBED}")
        check_backward("fused_mha_sep", mha_ops.fused_mha_sep, mha_ops.fused_mha_sep_plain,
                       mha_inputs(4, TOKENS, EMBED, dtype, packed=False), (HEADS,), f"{dn} B=4 N={TOKENS} E={EMBED}")
        delta = {k: v - before[k] for k, v in launches().items() if v != before[k]}
        if delta != {"pooled_attention": 2, "fused_mha": 1, "fused_mha_sep": 1}:
            fail(f"the wrappers' forwards under autograd launched {delta}, expected one launch per forward")
    # the matrix-unit probes, bf16 only: the probe's shape cut in B, an odd H != W with widths that no
    # tile divides, and row counts that are not a multiple of the 128-row tile
    bf = torch.bfloat16
    for m, kk, n in PROBE_MATMUL_SHAPES:
        check("probe_matmul", probe_ops.probe_matmul, probe_ops.probe_matmul_plain,
              (randn(m, kk, dtype=bf), randn(kk, n, dtype=bf)), f"bfloat16 [{m}x{kk}]@[{kk}x{n}]", poison=(0,))
    for b, h, w, cin, c in ((4, 56, 56, 128, 256), (3, 13, 17, 24, 40), (1, 5, 3, 8, 8)):
        x, w4 = randn(b, h, w, cin, dtype=bf), randn(3, 3, cin, c, dtype=bf, scale=0.05)
        label = f"bfloat16 B={b} {h}x{w} {cin}->{c}"
        check("probe_conv_cat", probe_ops.probe_conv_cat, probe_ops.probe_conv_cat_plain,
              (x, w4.reshape(3, 3 * cin, c)), label)
        check("probe_conv_9dot", probe_ops.probe_conv_9dot, probe_ops.probe_conv_9dot_plain,
              (x, w4.reshape(9, cin, c)), label)
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")

    # ------------------------------------------------------------ phase 4
    print(f"[4] flagship DFC-SA-Res-Block at {IMG}x{IMG}, B={BATCH}, seed {seed}", flush=True)
    rng = np.random.default_rng(seed)
    batch = rng.integers(0, 256, (BATCH, IMG, IMG, 3), dtype=np.uint8)
    cpu_model = init_random_(create_model(CONFIG, device="cpu"), torch.Generator().manual_seed(seed))
    model = cpu_model.to(dev, memory_format=torch.channels_last)
    calib = normalize(torch.from_numpy(batch[:16]).to(dev), torch.float32).permute(0, 3, 1, 2)
    weights = calibrate_batch_stats_(model, calib).state_dict()

    def serving(dtype, engine):
        if engine:
            fwd = DFCEngine(CONFIG, weights, dtype=dtype, device=dev, tail_kernel_levels="auto",
                            conv_kernel_levels="auto")
        else:
            fwd = create_model(CONFIG, dtype=None if dtype == torch.float32 else dtype, device=dev)
            fwd.load_state_dict(weights, strict=True)
        return Predictor(fwd, compute_dtype=dtype, device=dev)

    none = {name: 0 for name in launches()}
    per_forward = {"module": {**none, "pooled_attention": 9, "bias_add": BIAS_LAUNCHES[CONFIG["model"]["name"]]},
                   "engine": {**none, "pooled_attention": 9, "lsa_epilogue": 9, "dfc_tail": 7, "conv3x3_bn_relu": 2}}
    reset_launches()  # the flagship's main path starts here (phases 4 and 5)
    probs = {}
    for kind in ("module", "engine"):
        before = launches()
        with torch.inference_mode():
            probs[kind] = serving(torch.float32, kind == "engine").predict_probs(batch)
        delta = {k: v - before[k] for k, v in launches().items()}
        print(f"    {kind} f32: probs {probs[kind].shape}, launches {delta}", flush=True)
        if delta != per_forward[kind]:
            fail(f"{kind} forward launched {delta}, expected {per_forward[kind]}")
        if probs[kind].shape != (BATCH, IMG, IMG) or not np.isfinite(probs[kind]).all():
            fail(f"{kind} probabilities: shape {probs[kind].shape} or non-finite values")
    diff = float(np.abs(probs["module"] - probs["engine"]).max())
    logit = {k: logit_of(p) for k, p in probs.items()}
    dlogit = float(np.abs(logit["module"] - logit["engine"]).max())
    print(f"    module vs engine (f32): max |dprob| {diff:.3e} (tol {PROB_TOL_F32}); max |dlogit| "
          f"{dlogit:.3e} against logit std {logit['module'].std():.3e}, range "
          f"[{logit['module'].min():.3f}, {logit['module'].max():.3f}]", flush=True)
    logit_std = float(logit["module"].std())
    if logit_std < MIN_LOGIT_STD:
        fail(f"logit std {logit_std:.3e} < {MIN_LOGIT_STD}: the output hardly depends on the input")
    if not (diff <= PROB_TOL_F32 and dlogit <= 1e-2 * logit_std):
        fail("module and engine outputs disagree")

    # ------------------------------------------------------------ phase 5
    pred_engine = serving(torch.bfloat16, engine=True)
    pred_module = serving(torch.bfloat16, engine=False)
    requests = [(f"req{i}", rng.integers(0, 256, (512, 512, 3), dtype=np.uint8)) for i in range(3)]
    t0 = time.perf_counter()
    bias_before = launches()["bias_add"]
    with torch.inference_mode():
        served = list(pred_engine.predict_sliding_stream(iter(requests), tta=True))
        engine_bias = launches()["bias_add"] - bias_before
        ref = pred_module.predict_sliding(requests[0][1], tta=True)
    torch.cuda.synchronize()
    module_bias = launches()["bias_add"] - bias_before - engine_bias
    print(f"[5] {len(served)} requests of 512x512 with TTA through the bf16 engine in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for (key, p), (want_key, _) in zip(served, requests):
        if key != want_key or p.shape != (512, 512) or not np.isfinite(p).all() or p.min() < 0 or p.max() > 1:
            fail(f"request {want_key}: got key {key}, shape {p.shape}")
    req_logit = [logit_of(p) for p in (served[0][1], ref)]
    req_std = float(req_logit[1].std())
    req_diff = np.abs(req_logit[0] - req_logit[1]) / req_std
    print(f"    bf16 engine vs bf16 module on req0: logit std {req_std:.3e}; |dlogit| / std: max "
          f"{req_diff.max():.3e} (tol {DLOGIT_TOL_BF16['max']}), mean {req_diff.mean():.3e} "
          f"(tol {DLOGIT_TOL_BF16['mean']})", flush=True)
    if req_std < MIN_LOGIT_STD:
        fail(f"request logit std {req_std:.3e} < {MIN_LOGIT_STD}")
    if not (req_diff.max() <= DLOGIT_TOL_BF16["max"] and req_diff.mean() <= DLOGIT_TOL_BF16["mean"]):
        fail("bf16 engine and module disagree on a request")
    per_module = BIAS_LAUNCHES[CONFIG["model"]["name"]]
    print(f"    bias_add launches: the engine's requests {engine_bias}, the module's request {module_bias} "
          f"({module_bias / per_module:g} forwards of {per_module})", flush=True)
    if engine_bias or module_bias < per_module or module_bias % per_module:
        fail(f"phase 5: bias_add launched {engine_bias} times on the engine's requests and {module_bias} on the "
             f"module's, expected none and whole forwards of {per_module}")
    main_launches = launches()  # the flagship's main path ends here
    print(f"    flagship main-path launches: {main_launches}", flush=True)
    if min(main_launches[k] for k in ("pooled_attention", "lsa_epilogue", "dfc_tail", "conv3x3_bn_relu",
                                      "bias_add")) < 1:
        fail(f"a kernel of the flagship's main path never launched: {main_launches}")

    # ------------------------------------------------------------ phase 6
    print(f"[6] transformer zoo at {IMG}x{IMG}, B={BATCH}, seed {seed}", flush=True)
    reset_launches()  # the transformers' main path starts here
    zoo_pred = {}
    for label, (cfg, kernel_name) in ZOO.items():
        zoo_model = init_random_(create_model(cfg, device="cpu"), torch.Generator().manual_seed(seed))
        zoo_model = zoo_model.to(dev, memory_format=torch.channels_last)
        zoo_weights = calibrate_batch_stats_(zoo_model, calib).state_dict()
        del zoo_model
        zoo_probs = {}
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[-1]
            fwd = create_model(cfg, dtype=None if dtype == torch.float32 else dtype, device=dev)
            fwd.load_state_dict(zoo_weights, strict=True)
            pred = Predictor(fwd, compute_dtype=dtype, device=dev)
            before = launches()
            with torch.inference_mode():
                zoo_probs[dn] = pred.predict_probs(batch)
            delta = {k: v - before[k] for k, v in launches().items()}
            print(f"    {label} {dn}: probs {zoo_probs[dn].shape}, launches {delta}", flush=True)
            want = {**none, kernel_name: LAYERS, "bias_add": BIAS_LAUNCHES[cfg["model"]["name"]]}
            if delta != want:
                fail(f"{label} forward launched {delta}, expected {want}")
            if zoo_probs[dn].shape != (BATCH, IMG, IMG) or not np.isfinite(zoo_probs[dn]).all():
                fail(f"{label} {dn} probabilities: shape {zoo_probs[dn].shape} or non-finite values")
        zoo_pred[label] = pred  # the bf16 predictor, timed in phase 7
        cpu_fwd = create_model(cfg, device="cpu")
        cpu_fwd.load_state_dict(zoo_weights, strict=True)
        with torch.inference_mode():
            cpu_probs = Predictor(cpu_fwd, device="cpu").predict_probs(batch[:4])
        zl = {k: logit_of(p) for k, p in zoo_probs.items()}
        zstd = float(zl["float32"].std())
        d_cpu = float(np.abs(zl["float32"][:4] - logit_of(cpu_probs)).max()) / zstd
        d_bf16 = np.abs(zl["bfloat16"] - zl["float32"]) / zstd
        tol_bf16 = DLOGIT_TOL_BF16_ZOO[label]
        print(f"    {label}: logit std {zstd:.3e}, range [{zl['float32'].min():.3f}, {zl['float32'].max():.3f}]; "
              f"f32 card vs CPU on 4 images max |dlogit| / std {d_cpu:.3e} (tol {DLOGIT_TOL_CPU}); bf16 vs f32 "
              f"|dlogit| / std: max {d_bf16.max():.3e} (tol {tol_bf16['max']}), mean "
              f"{d_bf16.mean():.3e} (tol {tol_bf16['mean']})", flush=True)
        if zstd < MIN_LOGIT_STD:
            fail(f"{label} logit std {zstd:.3e} < {MIN_LOGIT_STD}: the output hardly depends on the input")
        if not d_cpu <= DLOGIT_TOL_CPU:
            fail(f"{label}: f32 on the card and on the CPU disagree")
        if not (d_bf16.max() <= tol_bf16["max"] and d_bf16.mean() <= tol_bf16["mean"]):
            fail(f"{label}: bf16 and f32 disagree on the card")
        del cpu_fwd, fwd, zoo_weights
    zoo_launches = launches()  # the transformers' main path ends here
    print(f"    transformer main-path launches: {zoo_launches}", flush=True)
    if min(zoo_launches[k] for k in ("fused_mha", "fused_mha_sep", "bias_add")) < 1:
        fail(f"a kernel of the transformers' main path never launched: {zoo_launches}")
    main_launches = {k: main_launches[k] + zoo_launches[k] for k in main_launches}

    # ------------------------------------------------------------ phase 7
    print(f"[7] timings, bf16, B={BATCH} ({card})", flush=True)

    def timed(fn, iters):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    import torch.nn.functional as F

    rows = {k: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "bytes": 0.0, "ops": 0.0,
                "exps": 0.0, "peak": PEAK_OPS["bf16"]} for k in max_err}

    def add(name, level, ms, plain_ms, lib_ms, nbytes, ops, exps=0):
        r = rows[name]
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        r["library_ms"] += lib_ms
        r["bytes"] += nbytes
        r["ops"] += ops
        r["exps"] += exps
        bound = max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS["bf16"], exps / exps_per_s) * 1e3
        r["bound_ms"] += bound  # each launch has its own bound: a kernel's is their sum
        print(f"    {name:16s} {level:18s} kernel {ms:8.3f} ms  plain {plain_ms:8.3f} ms  "
              f"library {lib_ms:8.3f} ms  bound {bound:7.3f} ms", flush=True)

    lsa_levels = []  # the attention epilogue's nine launches, level by level, kept in the kernels line
    tail_levels = []  # the tail's seven launches, level by level, kept in the kernels line
    conv_levels = []  # the same for the conv's two
    stats_levels = []  # and for the probe's four
    with torch.inference_mode():
        for name, h, cin, c in BLOCK_SHAPES:
            q, k, v = attn_inputs(BATCH, 64, c, bf)
            qs, ks, vs = (t.reshape(BATCH, 1, 64, -1) for t in (q, k, v))
            add("pooled_attention", name,
                timed(lambda: attn_ops.pooled_attention(q, k, v), 20),
                timed(lambda: attn_ops.pooled_attention_plain(q, k, v), 20),
                timed(lambda: F.scaled_dot_product_attention(qs, ks, vs, scale=1.0), 20),
                2 * (2 * q.numel() + 2 * v.numel()),
                2 * BATCH * 64 * 64 * (c // 8 + c), BATCH * 64 * 64)
        # the flagship's nine launches again at B=ATTN_BIG_BATCH, where the kernel and not the launch weighs
        # (at B=128 both the kernel and SDPA read the host); kept beside row 1 in the kernels line
        attn_big = {"batch": ATTN_BIG_BATCH, "ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
        for name, h, cin, c in BLOCK_SHAPES:
            q, k, v = attn_inputs(ATTN_BIG_BATCH, 64, c, bf)
            qs, ks, vs = (t.reshape(ATTN_BIG_BATCH, 1, 64, -1) for t in (q, k, v))
            attn_big["ms"] += timed(lambda: attn_ops.pooled_attention(q, k, v), 20)
            attn_big["library_ms"] += timed(lambda: F.scaled_dot_product_attention(qs, ks, vs, scale=1.0), 20)
            attn_big["bound_ms"] += max(2 * (2 * q.numel() + 2 * v.numel()) / HBM_BYTES_PER_S,
                                        2 * ATTN_BIG_BATCH * 64 * 64 * (c // 8 + c) / PEAK_OPS["bf16"],
                                        ATTN_BIG_BATCH * 64 * 64 / exps_per_s) * 1e3
        print(f"    pooled_attention, the flagship's 9 launches at B={ATTN_BIG_BATCH}: kernel {attn_big['ms']:.4f} ms  "
              f"SDPA {attn_big['library_ms']:.4f} ms  bound {attn_big['bound_ms']:.4f} ms ({card})", flush=True)
        for name, h, cin, c in BLOCK_SHAPES:
            npix = BATCH * h * h
            if name in AUTO_TAIL_LEVELS:
                args = tail_inputs(BATCH, h, cin, c, bf)
                # held to the plain version at the engine's own shapes before it is timed
                check("dfc_tail", tail_ops.dfc_tail, tail_ops.dfc_tail_plain, args,
                      f"bfloat16 {name} B={BATCH} {h}x{h} {cin}->{c}", poison=(0, 1))
                ms = (timed(lambda: tail_ops.dfc_tail(*args), 3), timed(lambda: tail_ops.dfc_tail_plain(*args), 3),
                      timed(tail_bench.library(args), 3))
                add("dfc_tail", name, *ms, *tail_bench.work(BATCH, h, cin, c))
                tail_levels.append({"level": name, "ms": ms[0], "plain_ms": ms[1], "library_ms": ms[2],
                                    "bound_ms": tail_bench.bound_ms(BATCH, h, cin, c)[0]})
            else:
                x, w, b = conv_inputs(BATCH, h, cin, c, bf)
                # held to the plain version at the engine's own shapes before it is timed
                check("conv3x3_bn_relu", tail_ops.conv3x3_bn_relu, tail_ops.conv3x3_bn_relu_plain, (x, w, b),
                      f"bfloat16 {name} B={BATCH} {h}x{h} {cin}->{c}", poison=(0,))
                ms = (timed(lambda: tail_ops.conv3x3_bn_relu(x, w, b), 5),
                      timed(lambda: tail_ops.conv3x3_bn_relu_plain(x, w, b), 3), timed(conv_bench.library(x, w, b), 5))
                add("conv3x3_bn_relu", name, *ms, *conv_bench.work(BATCH, h, cin, c))
                conv_levels.append({"level": name, "ms": ms[0], "plain_ms": ms[1], "library_ms": ms[2],
                                    "bound_ms": conv_bench.bound_ms(BATCH, h, cin, c)[0]})

        # the attention's epilogue at the engine's nine levels, pool 8: held to its plain version (to one ulp)
        # at B=128 before it is timed, beside F.interpolate and the torch island the engine ran before it
        for name, h, _, c in BLOCK_SHAPES:
            args = lsa_inputs(BATCH, h, h, c, 8, bf)
            check_lsa(args, f"bfloat16 {name} B={BATCH} {h}x{h} C={c}")
            a, o, gamma = args
            an, on = a.permute(0, 3, 1, 2), o.permute(0, 3, 1, 2)

            def island():
                up = F.interpolate(on, size=(h, h), mode="bilinear", align_corners=False)
                return (gamma * up.float() + an.float()).to(an.dtype)

            ms = (timed(lambda: lsa_ops.lsa_epilogue(*args), 10), timed(lambda: lsa_ops.lsa_epilogue_plain(*args), 3),
                  timed(island, 3))
            n = a.numel()
            nbytes, nops = 2 * n + 2 * n + 2 * o.numel() + 4, 10 * n
            add("lsa_epilogue", name, *ms, nbytes, nops)
            lsa_levels.append({"level": name, "ms": ms[0], "plain_ms": ms[1], "library_ms": ms[2],
                               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3})
            del args, a, o, an, on
        print(f"    lsa_epilogue, the flagship's 9 launches: kernel {rows['lsa_epilogue']['ms']:.4f} ms  plain "
              f"{rows['lsa_epilogue']['plain_ms']:.4f} ms  F.interpolate + the torch island "
              f"{rows['lsa_epilogue']['library_ms']:.4f} ms  bound {rows['lsa_epilogue']['bound_ms']:.4f} ms ({card})",
              flush=True)

        # the bias pass of one SegFormer-B5 request (16 1024x1024 tiles): each biased output's shape held to
        # torch's add_ bit for bit, then timed in place beside it, times its launches a request; torch's add_ is
        # both the plain version and the yardstick
        bias_levels = bias_bench.measure("segformer", timed, 10, gen)
        for r in bias_levels:
            n = r["launches"]
            add("bias_add", r["label"], n * r["ms"], n * r["torch_ms"], n * r["torch_ms"], n * r["bytes"], 0)
            max_err["bias_add"] = max(max_err["bias_add"], r["max_abs_err"])
            if not r["same_bits"]:
                bad.append(f"bias_add segformer {r['label']} {r['shape']}")
        bias_request = bias_bench.totals(bias_levels)
        print(f"    bias_add, a SegFormer-B5 request's {bias_request['launches']} launches: kernel "
              f"{bias_request['ms']:.4f} ms  torch's add_ {bias_request['torch_ms']:.4f} ms  bound "
              f"{bias_request['bound_ms']:.4f} ms ({card})", flush=True)
        # and bit for bit at the shapes the other paths give it: TransUNet and the flagship module in bf16 at
        # B=128, TransUNet in f32 at B=128 and the flagship module at phase 8's f32 training batch
        for model, dtype, b in (("transunet", torch.bfloat16, BATCH), ("transunet", torch.float32, BATCH),
                                ("flagship", torch.bfloat16, BATCH), ("flagship", torch.float32, F32_TRAIN_BATCH)):
            held = bias_bench.measure(model, None, 0, gen, dtype, batch=b)
            for r in held:
                max_err["bias_add"] = max(max_err["bias_add"], r["max_abs_err"])
                if not r["same_bits"]:
                    bad.append(f"bias_add {model} {dtype} {r['label']} {r['shape']}")
            print(f"    bias_add at {model}'s {len(held)} shapes, {str(dtype).split('.')[-1]} B={b}: "
                  f"{sum(r['same_bits'] for r in held)} the same bits as torch's add_", flush=True)

        # one forward of either transformer launches its kernel LAYERS times at this shape
        head_dim = EMBED // HEADS
        mha_bytes = LAYERS * 2 * 4 * BATCH * TOKENS * EMBED
        mha_ops_count = LAYERS * 4 * BATCH * HEADS * TOKENS * TOKENS * head_dim
        for name, packed in (("fused_mha", True), ("fused_mha_sep", False)):
            args = mha_inputs(BATCH, TOKENS, EMBED, bf, packed)
            kernel, plain = ((mha_ops.fused_mha, mha_ops.fused_mha_plain) if packed
                             else (mha_ops.fused_mha_sep, mha_ops.fused_mha_sep_plain))
            q4, k4, v4 = (t.reshape(BATCH, TOKENS, HEADS, head_dim).transpose(1, 2)
                          for t in (args[0].chunk(3, dim=-1) if packed else args))

            def layers_of(fn):
                for _ in range(LAYERS):
                    fn()

            add(name, f"{LAYERS} launches",
                timed(lambda: layers_of(lambda: kernel(*args, HEADS)), 5),
                timed(lambda: layers_of(lambda: plain(*args, HEADS)), 3),
                timed(lambda: layers_of(lambda: F.scaled_dot_product_attention(q4, k4, v4)), 5),
                mha_bytes, mha_ops_count, LAYERS * BATCH * HEADS * TOKENS * TOKENS)

        # the probe's own shapes: B=128 at the four encoder levels (scripts/bench_torch_bn_stats.py)
        for name, h, cin, c in probe.LEVELS:
            x, w, b = probe.inputs(BATCH, h, cin, c, gen)
            # held to the plain version at the probe's own shapes before it is timed
            check_stats((x, w, b), f"bfloat16 {name} B={BATCH} {h}x{h} {cin}->{c}")
            kc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            ms = (timed(lambda: stats_ops.conv3x3_bias_stats(x, w, b), 5),
                  timed(lambda: stats_ops.conv3x3_bias_stats_plain(x, w, b), 2),
                  timed(lambda: probe.library(x, kc, b), 5))
            add("conv3x3_bias_stats", name, *ms, *probe.work(BATCH, h, cin, c))
            stats_levels.append({"level": name, "ms": ms[0], "plain_ms": ms[1], "library_ms": ms[2],
                                 "bound_ms": probe.bound_ms(BATCH, h, cin, c)[0]})
            del x, w, b, kc

        # the full-resolution model's nine launches at 64x64 (N = H*H tokens).  The plain version holds
        # chunk*N*N f32 energies, so it runs the batch in chunks.
        flagship_attn = dict(rows["pooled_attention"])
        for name, h, c in FULLRES_SHAPES:
            n = h * h
            q, k, v = grid_attn_inputs(BATCH, h, h, c // 8, c, bf)
            qs, ks, vs = (t.reshape(BATCH, 1, n, -1) for t in (q, k, v))
            chunk = max(1, min(BATCH, 2 ** 27 // (n * n)))

            def plain_in_chunks():
                for i in range(0, BATCH, chunk):
                    attn_ops.pooled_attention_plain(q[i:i + chunk], k[i:i + chunk], v[i:i + chunk])

            add("pooled_attention", f"fullres-{name}",
                timed(lambda: attn_ops.pooled_attention(q, k, v), 5),
                timed(plain_in_chunks, 2),
                timed(lambda: F.scaled_dot_product_attention(qs, ks, vs, scale=1.0), 5),
                2 * (2 * q.numel() + 2 * v.numel()),
                2 * BATCH * n * n * (c // 8 + c), BATCH * n * n)
        print("    pooled_attention, sums: the flagship's 9 launches "
              + ", ".join(f"{key} {flagship_attn[key]:.4f}" for key in ("ms", "bound_ms", "plain_ms", "library_ms"))
              + "; the full-resolution model's 9 launches "
              + ", ".join(f"{key} {rows['pooled_attention'][key] - flagship_attn[key]:.4f}"
                          for key in ("ms", "bound_ms", "plain_ms", "library_ms")), flush=True)

        # SegFormer-B5's four launch shapes at B=SEGFORMER_BATCH, q at 1/8 as the model's folded scale leaves
        # it; kept beside row 1 in the kernels line, the stages weighted by their blocks (52 a request).  The
        # outputs, means of v over 1024 keys, stay well below 1: held to TOL of max|plain| itself
        # (a few roundings of bf16 at the largest output), not of 1
        segformer_attn = {"batch": SEGFORMER_BATCH, "stages": [], "ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
        for stage, (dim, heads, sr, blocks) in enumerate(SEGFORMER_STAGES, start=1):
            side = 1024 >> (1 + stage)
            nq, nk = side * side, (side // sr) ** 2
            q = randn(SEGFORMER_BATCH, nq, dim, dtype=bf, scale=0.125)
            kv = randn(SEGFORMER_BATCH, nk, 2 * dim, dtype=bf)
            k, v = kv[..., :dim], kv[..., dim:]
            check("pooled_attention", lambda a, b, c: attn_ops.pooled_attention(a, b, c, heads),
                  lambda a, b, c: attn_ops.pooled_attention_plain(a, b, c, heads), (q[:2], k[:2], v[:2]),
                  f"bfloat16 segformer stage {stage} {nq}q {nk}k {heads}h", poison=(0,), floor=0.0)
            qs, ks, vs = (t.unflatten(-1, (heads, dim // heads)).transpose(1, 2) for t in (q, k, v))
            ms = timed(lambda: attn_ops.pooled_attention(q, k, v, heads), 10)
            lib_ms = timed(lambda: F.scaled_dot_product_attention(qs, ks, vs, scale=1.0), 10)
            exps = SEGFORMER_BATCH * heads * nq * nk
            bound = max(2 * SEGFORMER_BATCH * 2 * (nq + nk) * dim / HBM_BYTES_PER_S,
                        2 * exps * 2 * (dim // heads) / PEAK_OPS["bf16"], exps / exps_per_s) * 1e3
            segformer_attn["stages"].append({"stage": stage, "queries": nq, "keys": nk, "heads": heads,
                                             "blocks": blocks, "ms": ms, "library_ms": lib_ms, "bound_ms": bound})
            for key, value in (("ms", ms), ("library_ms", lib_ms), ("bound_ms", bound)):
                segformer_attn[key] += blocks * value
            print(f"    pooled_attention segformer stage {stage}: {nq} queries, {nk} keys, {heads} heads, B="
                  f"{SEGFORMER_BATCH}: kernel {ms:.4f} ms  SDPA {lib_ms:.4f} ms  bound {bound:.4f} ms "
                  f"({100 * bound / ms:.1f}%) x {blocks}", flush=True)
        print(f"    pooled_attention, SegFormer-B5's 52 launches a request: kernel {segformer_attn['ms']:.4f} ms  "
              f"SDPA {segformer_attn['library_ms']:.4f} ms  bound {segformer_attn['bound_ms']:.4f} ms ({card})",
              flush=True)

        # the matrix-unit probes at their own shape (scripts/bench_torch_mxu.py): cuBLAS and cuDNN beside them
        mx = mxu.Probe(BATCH, gen)
        need = mxu.bounds(BATCH)
        for name, kind, lib in (("probe_matmul", "matmul", "torch.matmul"), ("probe_conv_cat", "conv", "F.conv2d"),
                                ("probe_conv_9dot", "conv", "F.conv2d")):
            _, fn, plain = mx.rows[name]
            add(name, "down3", timed(fn, 10), timed(lambda: plain(BATCH), 2), timed(mx.rows[lib][1], 10), *need[kind])
        del mx, fn, plain

        xs = torch.from_numpy(batch).to(dev)
        for kind, pred in (("module", pred_module), ("engine", pred_engine), *zoo_pred.items()):
            xn = normalize(xs, bf).permute(0, 3, 1, 2)
            fwd_ms = timed(lambda: pred.model(xn), 3)
            t0 = time.perf_counter()
            for _ in range(3):
                pred.predict_probs(batch)
            serve_s = (time.perf_counter() - t0) / 3
            print(f"    {kind} path bf16: forward {fwd_ms:.2f} ms = {BATCH / fwd_ms * 1e3:.1f} img/s on device; "
                  f"predict_probs (uint8 in, probs out) {BATCH / serve_s:.1f} img/s ({card})", flush=True)


    if bad:
        fail(f"kernels disagree with their plain versions at B={BATCH}: {bad}")

    # ------------------------------------------------------------ phase 8
    del pred, pred_module, pred_engine, zoo_pred, xs, xn, model, weights, served, ref, probs, calib
    del args, q, k, v, qs, ks, vs, q4, k4, v4  # phase 7's last inputs
    torch.cuda.empty_cache()
    print(f"    device memory still allocated before training: {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    print(f"[8] training at {IMG}x{IMG} through the Trainer, seed {seed} ({card})", flush=True)
    items = list(samples(n=2 * max(TRAIN_BATCHES), size=IMG, seed=seed))
    tmp = tempfile.TemporaryDirectory()

    def make_trainer(cfg, batch, n, bf16, device, tag, remat=False, weight_seed=seed, data=None):
        """A Trainer of ``cfg`` with seeded weights over the first ``n`` synthetic samples (of
        ``data``, or of the 224x224 ``items``)."""
        data = items if data is None else data
        return seeded_trainer(cfg, batch, data[:n], bf16, device, os.path.join(tmp.name, tag), seed, remat,
                              weight_seed)

    def run_epochs(trainer, epochs, kernel_name, per_step, label):
        """train_epoch over ``epochs``: every step finite and applied, ``per_step`` launches of
        ``kernel_name`` a step and of nothing else but the bias pass, at least once a step."""
        for epoch in epochs:
            before, n0 = launches(), len(trainer.step_log)
            trainer.train_epoch(epoch)
            steps = len(trainer.step_log) - n0
            delta = without_bias({k: v - before[k] for k, v in launches().items() if v != before[k]}, steps,
                                 f"{label}: epoch {epoch}")
            if steps != len(trainer.train_loader) or trainer.last_epoch_applied != steps:
                fail(f"{label}: epoch {epoch} applied {trainer.last_epoch_applied} of {steps} steps")
            if not all(m["finite"] and np.isfinite(m["loss"]) for m in trainer.step_log[n0:]):
                fail(f"{label}: a step of epoch {epoch} was not finite")
            if delta != ({kernel_name: per_step * steps} if per_step else {}):
                fail(f"{label}: {steps} steps launched {delta}, expected {per_step} of {kernel_name} a step")

    train_launches = {k: 0 for k in launches()}

    def close_run():
        """Add this training run's launch counts to the training path's and start the next at 0."""
        for k, v in launches().items():
            train_launches[k] += v
        reset_launches()

    # f32, B=2: 8 steps an epoch
    reset_launches()  # the training main path starts here
    n32 = 8 * F32_TRAIN_BATCH
    t32 = make_trainer(CONFIG, F32_TRAIN_BATCH, n32, False, dev, "f32")
    run_epochs(t32, [0], "pooled_attention", 9, "flagship f32")
    cpu = make_trainer(CONFIG, F32_TRAIN_BATCH, n32, False, "cpu", "cpu")
    cpu.train_loader.set_epoch(0)
    for i, cpu_batch in zip(range(3), cpu.train_loader):
        cpu.train_step(cpu_batch["image"], cpu_batch["mask"])
    rel = [abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in zip(t32.step_log, cpu.step_log)]
    print(f"    flagship f32 B={F32_TRAIN_BATCH}: losses of steps 1-3 on the card "
          f"{[round(m['loss'], 6) for m in t32.step_log[:3]]}, on the CPU {[round(m['loss'], 6) for m in cpu.step_log]}; "
          f"relative difference {max(rel):.2e} (tol {TRAIN_LOSS_TOL_CPU})", flush=True)
    if not max(rel) <= TRAIN_LOSS_TOL_CPU:
        fail("f32 training on the card and on the CPU disagree")
    del cpu
    val = t32.validate_epoch()
    ckpt = t32.save_checkpoint(0, is_best=True)
    run_epochs(t32, [1], "pooled_attention", 9, "flagship f32")
    resumed = make_trainer(CONFIG, F32_TRAIN_BATCH, n32, False, dev, "f32", weight_seed=seed + 1)
    resumed.load_checkpoint(ckpt)
    if resumed.start_epoch != 1 or resumed.step != 8:
        fail(f"the restored trainer starts at epoch {resumed.start_epoch}, step {resumed.step}; expected 1 and 8")
    run_epochs(resumed, [1], "pooled_attention", 9, "flagship f32 resumed")
    rel = [abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in zip(resumed.step_log, t32.step_log[8:])]
    print(f"    checkpoint after step 8, restored into a fresh trainer: step 9 loss {resumed.step_log[0]['loss']:.6f} "
          f"against {t32.step_log[8]['loss']:.6f}; steps 9-16 relative difference {max(rel):.2e} "
          f"(tol {TRAIN_LOSS_TOL_RESUME}); validation after epoch 1: loss {val['loss']:.4f} dice {val['dice']:.4f}",
          flush=True)
    if not (len(rel) == 8 and max(rel) <= TRAIN_LOSS_TOL_RESUME):
        fail("a restored checkpoint does not reproduce the next steps")
    # the best_model it wrote (the weights after epoch 1), served on the module path
    served_model = create_model(CONFIG, device=dev)
    served_model.load_state_dict(load_state_dict_file(t32.best_model_path), strict=True)
    request = np.stack([img for _, img, _ in items[:4]])
    with torch.inference_mode():
        best_probs = Predictor(served_model, device=dev).predict_probs(request)
        resumed.model.load_state_dict(load_state_dict_file(ckpt), strict=True)
        want = torch.sigmoid(resumed.model.eval()(normalize(torch.from_numpy(request).to(dev)).permute(0, 3, 1, 2)).float())
    d_served = float(np.abs(best_probs - want[:, 0].cpu().numpy()).max())
    print(f"    best_model served through the Predictor: probs {best_probs.shape}, max |dprob| against the "
          f"checkpoint's weights in the trainer's model {d_served:.2e}", flush=True)
    if best_probs.shape != (4, IMG, IMG) or not np.isfinite(best_probs).all() or d_served > 1e-5:
        fail("the served best_model disagrees with the trained weights")
    # the same files read back by the factory's facade from model.pretrained_path, served on the module path
    for path in (t32.best_model_path, ckpt):
        cfg = {**CONFIG, "model": {**CONFIG["model"], "pretrained_path": path}}
        facade_model, facade_sd = ModelFactory.get_model_and_variables(cfg, device=dev)
        before = launches()
        with torch.inference_mode():
            facade_probs = Predictor(facade_model, device=dev).predict_probs(request)
        delta = {k: v - before[k] for k, v in launches().items() if v != before[k]}
        d_facade = float(np.abs(facade_probs - best_probs).max())
        print(f"    {os.path.basename(path)} through ModelFactory.get_model_and_variables, served through the "
              f"Predictor: launches {delta}, max |dprob| against the served best_model {d_facade:.2e} (tol 1e-5)",
              flush=True)
        if facade_sd is None or delta != {"pooled_attention": 9, "bias_add": BIAS_LAUNCHES[CONFIG["model"]["name"]]}:
            fail(f"the facade's model of {path} loaded {facade_sd is not None} and launched {delta}, expected 9 "
                 f"pooled_attention and the module's bias_add launches")
        if facade_probs.shape != best_probs.shape or not np.isfinite(facade_probs).all() or d_facade > 1e-5:
            fail(f"the facade's model of {path} disagrees with the served best_model")
        del facade_model, facade_sd
    del t32, resumed, served_model, want
    torch.cuda.empty_cache()
    close_run()

    # bf16: the largest batch that fits without rematerialisation
    fits = None
    for b in TRAIN_BATCHES:
        torch.cuda.reset_peak_memory_stats()
        probe_trainer = make_trainer(CONFIG, b, b, True, dev, f"probe{b}")
        try:
            run_epochs(probe_trainer, [0], "pooled_attention", 9, f"flagship bf16 B={b}")
            fits = b
        except torch.cuda.OutOfMemoryError:
            print(f"    flagship bf16 B={b} without remat: out of device memory", flush=True)
        del probe_trainer
        torch.cuda.empty_cache()
        if fits:
            break
    if fits is None:
        fail(f"no batch of {TRAIN_BATCHES} trains in bf16 without rematerialisation")
    close_run()
    train_ms = {}
    for remat in (False, "l12"):
        torch.cuda.reset_peak_memory_stats()
        t16 = make_trainer(CONFIG, fits, 2 * fits, True, dev, f"bf16{remat}", remat=remat)
        epochs = range(10) if not remat else range(3)
        # a rematerialised block runs its forward, and so its attention kernel, a second time
        run_epochs(t16, epochs, "pooled_attention", 13 if remat else 9, f"flagship bf16 B={fits} remat={remat}")
        timer, peak = t16.last_epoch_timer, torch.cuda.max_memory_allocated() / 2**30
        train_ms[remat] = float(np.median([m["ms"] for m in t16.step_log[2:]]))
        losses = [m["loss"] for m in t16.step_log]
        print(f"    flagship bf16 B={fits} remat={remat}: {len(losses)} steps, loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
              f"train_step median {train_ms[remat]:.1f} ms = {fits / train_ms[remat] * 1e3:.1f} img/s; last epoch with "
              f"its loader {timer.ms_per_step:.1f} ms/step = {timer.items_per_sec:.1f} img/s; "
              f"peak allocated {peak:.2f} GiB ({card})", flush=True)
        if not remat and not (len(losses) == 20 and losses[-1] < losses[0]):
            fail(f"the bf16 loss did not fall over 20 steps: {losses[0]:.4f} -> {losses[-1]:.4f}")
        del t16
        torch.cuda.empty_cache()
    close_run()

    # the transformers, bf16; ViT-seg without attention dropout so that its kernel runs
    vit_cfg, tu_cfg = ZOO["ViT-seg"][0], ZOO["TransUNet"][0]
    dry_vit = {"model": {**vit_cfg["model"], "dropout": 0.0}}
    for label, cfg, kernel_name, per_step in (("ViT-seg dropout 0.0", dry_vit, "fused_mha", LAYERS),
                                              ("ViT-seg dropout 0.1", vit_cfg, None, 0),
                                              ("TransUNet", tu_cfg, "fused_mha_sep", LAYERS)):
        torch.cuda.reset_peak_memory_stats()
        steps = 3 if per_step else 1
        tz = make_trainer(cfg, ZOO_TRAIN_BATCH, steps * ZOO_TRAIN_BATCH, True, dev, label.replace(" ", "_"))
        run_epochs(tz, [0], kernel_name, per_step, label)
        losses = [m["loss"] for m in tz.step_log]
        print(f"    {label} bf16 B={ZOO_TRAIN_BATCH}: {len(losses)} steps, losses {[round(v, 4) for v in losses]}; "
              f"train_step {tz.step_log[-1]['ms']:.1f} ms (the last step); peak allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})", flush=True)
        del tz
        torch.cuda.empty_cache()
    close_run()  # the training main path ends here
    print(f"    training main-path launches: {train_launches}", flush=True)
    if min(train_launches[k] for k in ("pooled_attention", "fused_mha", "fused_mha_sep", "bias_add")) < 1:
        fail(f"a kernel of the training path never launched: {train_launches}")
    main_launches = {k: main_launches[k] + train_launches[k] for k in main_launches}
    tmp.cleanup()

    # ------------------------------------------------------------ phase 9
    print(f"[9] BatchNorm-statistics probe, bf16, B={BATCH} ({card})", flush=True)
    reset_launches()  # the probe's path starts here
    with torch.inference_mode():
        for name, h, cin, c in probe.LEVELS:
            x, w, b = probe.inputs(BATCH, h, cin, c, gen)
            y, mean, mean2 = stats_ops.conv3x3_bias_stats(x, w, b)
            # no atomics and partial rows per tile of pixels: a second launch gives the same bits
            again = stats_ops.conv3x3_bias_stats(x, w, b)
            if not all(torch.equal(u, v) for u, v in zip((y, mean, mean2), again)):
                fail(f"probe level {name}: two launches on the same inputs gave different bits")
            del again
            var = mean2 - mean * mean
            ok = (y.shape == (BATCH, h, h, c) and mean.shape == var.shape == (c,) and bool(torch.isfinite(y).all())
                  and bool((var > 0).all()))
            # BatchNorm with these statistics gives unit variance: the use the sums are for
            normed = ((y.float() - mean) * torch.rsqrt(var + 1e-5)).var(dim=(0, 1, 2), unbiased=False)
            print(f"    {name}: y {tuple(y.shape)}, the same bits from two launches, batch variance "
                  f"{var.min().item():.3e} .. {var.max().item():.3e}, variance after normalising "
                  f"{normed.min().item():.4f} .. {normed.max().item():.4f}", flush=True)
            if not ok or not bool(((normed - 1).abs() < 2e-2).all()):
                fail(f"probe level {name}: the statistics do not normalise y")
            del x, w, b, y
    probe_launches = launches()  # the probe's path ends here
    if probe_launches["conv3x3_bias_stats"] != 2 * len(probe.LEVELS):
        fail(f"the probe launched {probe_launches}")
    main_launches = {k: main_launches[k] + probe_launches[k] for k in main_launches}
    print(f"    flagship training step bf16 B={fits}: {train_ms[False]:.1f} ms/step = "
          f"{fits / train_ms[False] * 1e3:.1f} img/s; with remat l12 {train_ms['l12']:.1f} ms/step = "
          f"{fits / train_ms['l12'] * 1e3:.1f} img/s ({card})", flush=True)

    # ------------------------------------------------------------ phase 10
    print(f"[10] the DFC zoo at full width, B={BATCH}, seed {seed} ({card})", flush=True)
    reset_launches()  # the DFC zoo's serving path starts here
    batches = {IMG: batch, 64: rng.integers(0, 256, (BATCH, 64, 64, 3), dtype=np.uint8)}
    for name, (size, per_fwd) in DFC_ZOO.items():
        cfg, images = model_config(name), batches[size]
        net = init_random_(create_model(cfg, device="cpu"), torch.Generator().manual_seed(seed))
        net = net.to(dev, memory_format=torch.channels_last)
        calib = normalize(torch.from_numpy(images[:16]).to(dev), torch.float32).permute(0, 3, 1, 2)
        zoo_weights = calibrate_batch_stats_(net, calib).state_dict()
        del net, calib
        zoo_probs, speed = {}, ""
        for dtype, n_img in ((torch.bfloat16, BATCH), (torch.float32, DFC_ZOO_F32_BATCH)):
            dn = str(dtype).split(".")[-1]
            fwd = create_model(cfg, dtype=None if dtype == torch.float32 else dtype, device=dev)
            fwd.load_state_dict(zoo_weights, strict=True)
            pred = Predictor(fwd, compute_dtype=dtype, device=dev)
            before = launches()
            with torch.inference_mode():
                zoo_probs[dn] = pred.predict_probs(images[:n_img])
            delta = {k: v - before[k] for k, v in launches().items()}
            if delta != {**none, "pooled_attention": per_fwd, "bias_add": BIAS_LAUNCHES[name]}:
                fail(f"{name} {dn} forward launched {delta}, expected {per_fwd} of pooled_attention and "
                     f"{BIAS_LAUNCHES[name]} of bias_add")
            if zoo_probs[dn].shape != (n_img, size, size) or not np.isfinite(zoo_probs[dn]).all():
                fail(f"{name} {dn} probabilities: shape {zoo_probs[dn].shape} or non-finite values")
            if dtype == torch.bfloat16:
                with torch.inference_mode():
                    xn = normalize(torch.from_numpy(images).to(dev), dtype).permute(0, 3, 1, 2)
                    fwd_ms = timed(lambda: pred.model(xn), 3)
                    t0 = time.perf_counter()
                    for _ in range(3):
                        pred.predict_probs(images)
                    serve_s = (time.perf_counter() - t0) / 3
                speed = (f"bf16 B={BATCH} {size}x{size}: forward {fwd_ms:.2f} ms = {BATCH / fwd_ms * 1e3:.1f} img/s on "
                         f"device; predict_probs {BATCH / serve_s:.1f} img/s; {per_fwd} attention launches a forward")
                del xn
            del fwd, pred
        cpu_fwd = create_model(cfg, device="cpu")
        cpu_fwd.load_state_dict(zoo_weights, strict=True)
        with torch.inference_mode():
            cpu_probs = Predictor(cpu_fwd, device="cpu").predict_probs(images[:DFC_ZOO_CPU_IMAGES])
        del cpu_fwd, zoo_weights
        zl = {k: logit_of(v) for k, v in zoo_probs.items()}
        zstd = float(zl["float32"].std())
        d_cpu = float(np.abs(zl["float32"][:DFC_ZOO_CPU_IMAGES] - logit_of(cpu_probs)).max()) / zstd
        d_bf16 = np.abs(zl["bfloat16"][:DFC_ZOO_F32_BATCH] - zl["float32"]) / zstd
        print(f"    {name} {speed}\n        logit std {zstd:.3e}; f32 card vs CPU on {DFC_ZOO_CPU_IMAGES} images max "
              f"|dlogit| / std {d_cpu:.3e} (tol {DLOGIT_TOL_CPU}); bf16 vs f32 on {DFC_ZOO_F32_BATCH} images: max "
              f"{d_bf16.max():.3e} (tol {DLOGIT_TOL_BF16_DFC_ZOO['max']}), mean {d_bf16.mean():.3e} "
              f"(tol {DLOGIT_TOL_BF16_DFC_ZOO['mean']})", flush=True)
        if zstd < MIN_LOGIT_STD:
            fail(f"{name} logit std {zstd:.3e} < {MIN_LOGIT_STD}: the output hardly depends on the input")
        if not d_cpu <= DLOGIT_TOL_CPU:
            fail(f"{name}: f32 on the card and on the CPU disagree")
        if not (d_bf16.max() <= DLOGIT_TOL_BF16_DFC_ZOO["max"] and d_bf16.mean() <= DLOGIT_TOL_BF16_DFC_ZOO["mean"]):
            fail(f"{name}: bf16 and f32 disagree on the card")
    dfc_zoo_launches = launches()  # the DFC zoo's serving path ends here
    print(f"    DFC zoo serving launches: {dfc_zoo_launches}", flush=True)
    if dfc_zoo_launches["pooled_attention"] < 1:
        fail(f"the attention kernel never launched while the DFC zoo was served: {dfc_zoo_launches}")
    main_launches = {k: main_launches[k] + dfc_zoo_launches[k] for k in main_launches}
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ phase 11
    print(f"[11] training the DFC zoo through the Trainer, bf16, seed {seed} ({card})", flush=True)
    reset_launches()  # the DFC zoo's training path starts here
    tmp = tempfile.TemporaryDirectory()
    for name, size, b in DFC_ZOO_TRAINING:
        per_step = DFC_ZOO[name][1]
        data = items if size == IMG else list(samples(n=3 * b, size=size, seed=seed))
        torch.cuda.reset_peak_memory_stats()
        tz = make_trainer(model_config(name), b, 3 * b, True, dev, name, data=data)
        run_epochs(tz, [0], "pooled_attention" if per_step else None, per_step, name)
        losses = [m["loss"] for m in tz.step_log]
        print(f"    {name} bf16 B={b} {size}x{size}: {len(losses)} steps, losses {[round(v, 4) for v in losses]}; "
              f"train_step {tz.step_log[-1]['ms']:.1f} ms (the last step) = {b / tz.step_log[-1]['ms'] * 1e3:.1f} img/s; "
              f"peak allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {per_step} attention launches "
              f"a step ({card})", flush=True)
        del tz, data
        torch.cuda.empty_cache()
    dfc_train_launches = launches()  # the DFC zoo's training path ends here
    print(f"    DFC zoo training launches: {dfc_train_launches}", flush=True)
    if dfc_train_launches["pooled_attention"] < 1:
        fail(f"the attention kernel never launched while the DFC zoo trained: {dfc_train_launches}")
    main_launches = {k: main_launches[k] + dfc_train_launches[k] for k in main_launches}
    tmp.cleanup()

    # ------------------------------------------------------------ phase 12
    print(f"[12] matrix-unit probes, bf16, B={BATCH} {mxu.H}x{mxu.W} {mxu.CIN}->{mxu.COUT} ({card})", flush=True)
    reset_launches()  # the probes' path starts here
    with torch.inference_mode():
        mx = mxu.Probe(BATCH, gen)
        errs = mx.check()  # one launch of each kernel, held against its plain version
        mxu_launches = launches()  # the probes' path ends here: the timed rows below are not counted
        if {k: v for k, v in mxu_launches.items() if v} != {k: 1 for k in mxu_launches if k.startswith("probe_")}:
            fail(f"the matrix-unit probes launched {mxu_launches}, expected one launch of each of the three kernels")
        for name, (err, _) in errs.items():
            max_err[name] = max(max_err[name], err)
        mx.time(10, errs, card)
        del mx
    main_launches = {k: main_launches[k] + mxu_launches[k] for k in main_launches}

    # ------------------------------------------------------------ phase 13
    print(f"[13] int8 serving, B={BATCH} ({card})", flush=True)

    def check_s8(args, out_dtype, label):
        """conv3x3_s8 against its plain version bit for bit, after a launch on +127 / -128 inputs."""
        try:
            err = int8_bench.check(s8_ops, *args, out_dtype)
        except RuntimeError as e:
            print(f"    conv3x3_s8       {label:38s} FAIL: {e}", flush=True)
            bad.append(f"conv3x3_s8 {label}")
            return
        print(f"    conv3x3_s8       {label:38s} max_abs_err {err:.1e} ok", flush=True)

    with torch.inference_mode():
        for out_dtype in (torch.bfloat16, torch.float32):
            dn = str(out_dtype).split(".")[-1]
            for name, h, cin, c in int8_bench.LEVELS:
                check_s8(int8_bench.inputs(BATCH, h, h, cin, c, gen), out_dtype,
                         f"{dn} {name} B={BATCH} {h}x{h} {cin}->{c}")
            for b, h, w, cin, c in S8_ODD_SHAPES:
                check_s8(int8_bench.inputs(b, h, w, cin, c, gen), out_dtype,
                         f"{dn} B={b} {h}x{w} {cin}->{c} (NB {s8_ops.s8_tiling(c)})")
    if bad:
        fail(f"conv3x3_s8 disagrees with its plain version: {bad}")

    # phase 4's weights; calibration images: synthetic ellipses, the first 8 and 8 more held out
    model = init_random_(create_model(CONFIG, device="cpu"), torch.Generator().manual_seed(seed))
    model = model.to(dev, memory_format=torch.channels_last)
    calib = normalize(torch.from_numpy(batch[:16]).to(dev), torch.float32).permute(0, 3, 1, 2)
    weights = calibrate_batch_stats_(model, calib).state_dict()
    del model
    synthetic = np.stack([img for _, img, _ in samples(n=2 * INT8_CALIB_IMAGES, size=IMG, seed=seed)])
    cal8, held8 = (normalize(torch.from_numpy(synthetic[i:i + INT8_CALIB_IMAGES]).to(dev), bf).permute(0, 3, 1, 2)
                   for i in (0, INT8_CALIB_IMAGES))
    xs = torch.from_numpy(batch).to(dev)
    xn = normalize(xs, bf).permute(0, 3, 1, 2)
    int8_launches = {k: 0 for k in launches()}
    speed = []  # (label, int8 forward ms, fp forward ms, int8 served img/s, fp served img/s)

    def self_check(label, engine):
        chk = int8_self_check(engine)
        print(f"    {label} self-check (printed, not gated: seeded weights): flip rate {chk['flip_rate']:.3%}, mean "
              f"|dprob| {chk['mean_abs_dprob']:.5f}; held out: flip rate {chk['holdout_flip_rate']:.3%}, mean |dprob| "
              f"{chk['holdout_mean_abs_dprob']:.5f}", flush=True)

    def serve(label, pred, want):
        """One B=128 uint8 batch through the Predictor: the launches of one forward must be ``want``."""
        before = launches()
        with torch.inference_mode():
            probs = pred.predict_probs(batch)
        delta = {k: v - before[k] for k, v in launches().items()}
        print(f"    {label}: probs {probs.shape}, launches {delta}", flush=True)
        if delta != {**none, **want}:
            fail(f"{label} forward launched {delta}, expected {want}")
        if probs.shape != (BATCH, IMG, IMG) or not np.isfinite(probs).all():
            fail(f"{label} probabilities: shape {probs.shape} or non-finite values")
        return probs

    def close_path():
        for k, v in launches().items():
            int8_launches[k] += v

    def time_paths(label, int8_pred, fp_pred):
        with torch.inference_mode():
            ms = [timed(lambda: p.model(xn), 3) for p in (int8_pred, fp_pred)]
            served = []
            for p in (int8_pred, fp_pred):
                t0 = time.perf_counter()
                for _ in range(2):
                    p.predict_probs(batch)
                served.append(2 * BATCH / (time.perf_counter() - t0))
        speed.append((label, *ms, *served))

    # the int8 flagship: calibration, self-check, a B=128 request, the f32 engine against the CPU
    reset_launches()  # the int8 flagship's path starts here
    t0 = time.perf_counter()
    with torch.inference_mode():
        q_flag = Int8DFCEngine(CONFIG, weights, dtype=bf, device=dev, calib_batches=[cal8],
                               calib_percentile=INT8_PERCENTILE, holdout_batch=held8, tail_kernel_levels="auto",
                               conv_kernel_levels="auto")
    print(f"    int8 flagship: int8 levels {sorted(q_flag.int8_levels)}, tail kernel {sorted(q_flag.tail_kernel_levels)}, "
          f"conv kernel {sorted(q_flag.conv_kernel_levels)}; built and calibrated on {INT8_CALIB_IMAGES} images at "
          f"percentile {INT8_PERCENTILE} in {time.perf_counter() - t0:.2f} s", flush=True)
    self_check("int8 flagship", q_flag)
    pred_q = Predictor(q_flag, compute_dtype=bf, device=dev)
    probs_q = serve("int8 flagship bf16", pred_q,
                    {"pooled_attention": 9, "lsa_epilogue": 9, "dfc_tail": 4, "conv3x3_bn_relu": 1, "conv3x3_s8": 4})
    with torch.inference_mode():
        q32 = Int8DFCEngine(CONFIG, weights, dtype=torch.float32, device=dev, act_scales=q_flag.act_scales,
                            tail_kernel_levels="auto", conv_kernel_levels="auto")
        q32_cpu = Int8DFCEngine(CONFIG, {k: v.cpu() for k, v in weights.items()}, dtype=torch.float32, device="cpu",
                                act_scales=q_flag.act_scales)
        # each int8 level from the same input, about 40 quantization steps wide: x8, local and a0 the same bits
        for name, h, cin, _ in BLOCK_SHAPES:
            if name not in q32.int8_levels:
                continue
            xb = torch.randn(INT8_CPU_IMAGES, cin, h, h, generator=torch.Generator().manual_seed(seed))
            xb = (xb * (40 * q_flag.act_scales[f"{name}.x"])).contiguous(memory_format=torch.channels_last)
            got, want = q32._x_branches(name, xb.to(dev)), q32_cpu._x_branches(name, xb)
            same = all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
            print(f"    int8 flagship f32 {name}: x8, local (conv3x3_s8) and a0 (s8_matmul) from the same input on the "
                  f"card and the CPU: {'the same bits' if same else 'DIFFERENT'}", flush=True)
            if not same:
                fail(f"the int8 products of {name} differ between the card and the CPU")
        x2 = normalize(torch.from_numpy(batch[:INT8_CPU_IMAGES]), torch.float32).permute(0, 3, 1, 2)
        card_logit = q32(x2.to(dev))[:, 0].cpu().numpy()
        cpu_logit, cpu_nudged = (q32_cpu(x2 * f)[:, 0].numpy() for f in (1.0, 1.0 + 1e-6))
        fp_cpu = DFCEngine(CONFIG, {k: v.cpu() for k, v in weights.items()}, dtype=torch.float32, device="cpu")
        fp_logit = fp_cpu(x2)[:, 0].numpy()
    close_path()  # the int8 flagship's path ends here
    for what, other in (("its input scaled by 1 + 1e-6", cpu_nudged), ("the f32 fp engine", fp_logit)):
        d = np.abs(cpu_logit - other) / float(cpu_logit.std())
        print(f"    int8 flagship f32 on the CPU against {what}: |dlogit| / std max {d.max():.3e}, mean {d.mean():.3e}",
              flush=True)
    d_cpu = np.abs(card_logit - cpu_logit) / float(card_logit.std())
    tol = DLOGIT_TOL_INT8_CPU
    print(f"    int8 flagship f32, card vs CPU on {INT8_CPU_IMAGES} images, the same scales: logit std "
          f"{card_logit.std():.3e}; |dlogit| / std max {d_cpu.max():.3e} (tol {tol['max']}), mean {d_cpu.mean():.3e} "
          f"(tol {tol['mean']}); masks agree on {((card_logit > 0) == (cpu_logit > 0)).mean():.4%} of pixels",
          flush=True)
    if card_logit.std() < MIN_LOGIT_STD or not (d_cpu.max() <= tol["max"] and d_cpu.mean() <= tol["mean"]):
        fail("the f32 int8 flagship on the card and on the CPU disagree")
    del q32, q32_cpu
    pred_fp = Predictor(DFCEngine(CONFIG, weights, dtype=bf, device=dev, tail_kernel_levels="auto",
                                  conv_kernel_levels="auto"), compute_dtype=bf, device=dev)
    with torch.inference_mode():
        probs_fp = pred_fp.predict_probs(batch)
    fl, ql = logit_of(probs_fp), logit_of(probs_q)
    dq = np.abs(ql - fl) / fl.std()
    print(f"    int8 flagship vs the bf16 engine on the request (printed): logit std {fl.std():.3e}; |dlogit| / std max "
          f"{dq.max():.3e}, mean {dq.mean():.3e}; masks agree on {((probs_q > 0.5) == (probs_fp > 0.5)).mean():.4%} of "
          f"pixels", flush=True)
    time_paths("flagship: int8 engine vs --engine", pred_q, pred_fp)
    del q_flag, pred_q, pred_fp, probs_q, probs_fp, weights

    # int8 ViT-seg and TransUNet: phase 6's weights, held against their bf16 modules
    for label, (cfg, _) in ZOO.items():
        zoo_model = init_random_(create_model(cfg, device="cpu"), torch.Generator().manual_seed(seed))
        zoo_model = zoo_model.to(dev, memory_format=torch.channels_last)
        zoo_weights = calibrate_batch_stats_(zoo_model, calib).state_dict()
        del zoo_model
        engine_cls = Int8ViTEngine if label == "ViT-seg" else Int8TransUNetEngine
        reset_launches()  # this int8 transformer's path starts here
        zoo_probs = {}
        for pct in INT8_ZOO_PERCENTILES:
            tag = f"int8 {label} ({'max |t|' if pct is None else f'percentile {pct}'})"
            with torch.inference_mode():
                q_zoo = engine_cls(cfg, zoo_weights, dtype=bf, device=dev, calib_batches=[cal8],
                                   calib_percentile=pct, holdout_batch=held8)
            self_check(tag, q_zoo)
            pred = Predictor(q_zoo, compute_dtype=bf, device=dev)
            zoo_probs[pct] = serve(f"{tag} bf16", pred,
                                   {"fused_mha": LAYERS, "bias_add": INT8_BIAS_LAUNCHES[cfg["model"]["name"]]})
            if pct is None:
                pred_q = pred  # the gated one, timed below
            del q_zoo, pred
        close_path()  # and ends here
        fp_mod = create_model(cfg, dtype=bf, device=dev)
        fp_mod.load_state_dict(zoo_weights, strict=True)
        pred_fp = Predictor(fp_mod, compute_dtype=bf, device=dev)
        with torch.inference_mode():
            probs_fp = pred_fp.predict_probs(batch)
        fl = logit_of(probs_fp)
        zstd = float(fl.std())
        tol = DLOGIT_TOL_BF16_ZOO[label]
        for pct, probs_q in zoo_probs.items():
            dq = np.abs(logit_of(probs_q) - fl) / zstd
            gated = pct is None
            print(f"    int8 {label} ({'max |t|' if gated else f'percentile {pct}'}) vs its bf16 module: logit std "
                  f"{zstd:.3e}; |dlogit| / std max {dq.max():.3e}, mean {dq.mean():.3e}"
                  + (f" (tol {tol['max']} and {tol['mean']})" if gated else " (printed)")
                  + f"; masks agree on {((probs_q > 0.5) == (probs_fp > 0.5)).mean():.4%} of pixels", flush=True)
            if gated and (zstd < MIN_LOGIT_STD or not (dq.max() <= tol["max"] and dq.mean() <= tol["mean"])):
                fail(f"int8 {label} and its bf16 module disagree")
        time_paths(f"{label}: int8 engine vs bf16 module", pred_q, pred_fp)
        del pred_q, fp_mod, pred_fp, zoo_weights, zoo_probs, probs_fp
    print(f"    int8 main-path launches: {int8_launches}", flush=True)
    if min(int8_launches[k] for k in ("conv3x3_s8", "pooled_attention", "lsa_epilogue", "dfc_tail", "conv3x3_bn_relu",
                                      "fused_mha")) < 1:
        fail(f"a kernel of the int8 paths never launched: {int8_launches}")
    main_launches = {k: main_launches[k] + int8_launches[k] for k in main_launches}
    del calib, cal8, held8, xs, xn
    torch.cuda.empty_cache()

    # the kernel's times at the auto levels (held to its plain version at these shapes above)
    s8_levels = []
    r = rows["conv3x3_s8"]
    r.update(library_ms=None, bf16_ms=0.0, peak=PEAK_OPS["s8"])
    with torch.inference_mode():
        for name, h, cin, c in int8_bench.LEVELS:
            x8, w8, scale, bias = int8_bench.inputs(BATCH, h, h, cin, c, gen)
            ms = (timed(lambda: s8_ops.conv3x3_s8(x8, w8, scale, bias), 5),
                  timed(lambda: s8_ops.conv3x3_s8_plain(x8, w8, scale, bias), 2),
                  timed(int8_bench.yardstick(BATCH, h, cin, c, gen), 5))
            bound, by = int8_bench.bound_ms(BATCH, h, cin, c)
            nbytes, nops = int8_bench.work(BATCH, h, cin, c)
            for key, v in (("ms", ms[0]), ("plain_ms", ms[1]), ("bf16_ms", ms[2]), ("bound_ms", bound),
                           ("bytes", nbytes), ("ops", nops)):
                r[key] += v
            s8_levels.append({"level": name, "ms": ms[0], "plain_ms": ms[1], "bf16_yardstick_ms": ms[2],
                              "bound_ms": bound, "bound_term": by})
            print(f"    conv3x3_s8       {name:18s} kernel {ms[0]:8.3f} ms ({nops / ms[0] / 1e9:6.1f} TOP/s)  plain "
                  f"{ms[1]:8.3f} ms  bf16 yardstick {ms[2]:8.3f} ms  bound {bound:7.3f} ms ({by})", flush=True)
            del x8, w8, scale, bias
    print(f"    conv3x3_s8, the four levels: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, bf16 yardstick "
          f"{r['bf16_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms ({card})", flush=True)
    for label, q_ms, f_ms, q_img, f_img in speed:
        print(f"    {label}, bf16 B={BATCH}: forward {q_ms:.2f} ms ({BATCH / q_ms * 1e3:.1f} img/s on device) against "
              f"{f_ms:.2f} ms ({BATCH / f_ms * 1e3:.1f}); predict_probs {q_img:.1f} img/s against {f_img:.1f} ({card})",
              flush=True)

    # ------------------------------------------------------------ phase 14
    multi = multi_device(seed, card, dev, fits, batch, items, run_epochs)
    main_launches = {k: main_launches[k] + multi[k] for k in main_launches}

    # ------------------------------------------------------------ phase 15
    accum = accumulation_and_cache(seed, card, dev, fits, train_ms[False], run_epochs)
    main_launches = {k: main_launches[k] + accum[k] for k in main_launches}

    # ------------------------------------------------------------ phase 16
    banded = row_sharding(seed, card, dev, gen, max_err, run_epochs)
    main_launches = {k: main_launches[k] + banded[k] for k in main_launches}

    # ------------------------------------------------------------ phase 17
    families = row_sharding_families(seed, card, dev, gen, max_err)
    main_launches = {k: main_launches[k] + families[k] for k in main_launches}

    sources = {"pooled_attention": ("dfc_sa_unet_torch/csrc/pooled_attention.cu",
                                    "dfc_sa_unet_tpu/ops/pallas_attention.py:74"),
               "dfc_tail": ("dfc_sa_unet_torch/csrc/dfc_tail.cu", "dfc_sa_unet_tpu/ops/pallas_conv.py:198"),
               "conv3x3_bn_relu": ("dfc_sa_unet_torch/csrc/dfc_tail.cu", "dfc_sa_unet_tpu/ops/pallas_conv.py:121"),
               "fused_mha": ("dfc_sa_unet_torch/csrc/mha.cu", "dfc_sa_unet_tpu/ops/pallas_attention.py:214"),
               "fused_mha_sep": ("dfc_sa_unet_torch/csrc/mha.cu", "dfc_sa_unet_tpu/ops/pallas_attention.py:276"),
               "conv3x3_bias_stats": ("dfc_sa_unet_torch/csrc/conv_bn_stats.cu", "scripts/bench_bn_stats.py:80"),
               "probe_matmul": ("dfc_sa_unet_torch/csrc/mxu_probes.cu", "scripts/bench_mxu.py:58"),
               "probe_conv_cat": ("dfc_sa_unet_torch/csrc/mxu_probes.cu", "scripts/bench_mxu.py:129"),
               "probe_conv_9dot": ("dfc_sa_unet_torch/csrc/mxu_probes.cu", "scripts/bench_mxu.py:134"),
               # no Pallas kernel: the JAX int8 engine's s8 3x3 conv is an XLA convolution
               "conv3x3_s8": ("dfc_sa_unet_torch/csrc/conv3x3_s8.cu", "dfc_sa_unet_tpu/infer/quant.py:240"),
               # no Pallas kernel: XLA fuses the upsample, gamma and the residual add of the JAX engine's attention
               "lsa_epilogue": ("dfc_sa_unet_torch/csrc/lsa_epilogue.cu", "dfc_sa_unet_tpu/infer/engine.py:161"),
               # no Pallas kernel: XLA fuses each layer's bias add into the ops around it
               "bias_add": ("dfc_sa_unet_torch/csrc/bias_add.cu", "dfc_sa_unet_tpu/nn/layers.py")}
    levels = {"dfc_tail": tail_levels, "conv3x3_bn_relu": conv_levels, "conv3x3_bias_stats": stats_levels,
              "conv3x3_s8": s8_levels, "lsa_epilogue": lsa_levels, "bias_add": bias_levels}
    kernels = []
    for name, r in rows.items():
        terms = {"bytes": r["bytes"] / HBM_BYTES_PER_S, "operations": r["ops"] / r["peak"],
                 "exponentials": r["exps"] / exps_per_s}
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name][0], "replaces": sources[name][1],
            "launches": main_launches[name], "max_abs_err": max_err[name],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            # exponentials are operations of the special-function units; bound_term names which
            # of the three terms is the largest
            "bound_by": "bytes" if max(terms, key=terms.get) == "bytes" else "operations",
            "bound_term": max(terms, key=terms.get),
            "library_ms": r["library_ms"],
            **({"bf16_yardstick_ms": r["bf16_ms"]} if "bf16_ms" in r else {}),
            **({"levels": levels[name]} if name in levels else {}),
            # the launches of the kernel's halo instantiation (row sharding, phases 16 and 17), among "launches"
            **({"halo_launches": banded[name] + families[name]}
               if name in ("dfc_tail", "conv3x3_bn_relu", "conv3x3_s8") else {}),
            # phase 17: the attention's launches with a band's queries against every key, and the MHA's on
            # the token maps gathered over the bands, among "launches"
            **({"fewer_query_launches": families["pooled_attention.fewer_queries"], "flagship_large_batch": attn_big, "segformer": segformer_attn}
               if name == "pooled_attention" else {}),
            **({"gathered_token_launches": families[name]} if name in ("fused_mha", "fused_mha_sep") else {}),
        })
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
