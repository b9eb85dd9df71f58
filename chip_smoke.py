#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py

Phases; any failure exits non-zero:
  1. build the CUDA kernels from dynamic_tuning_tpu_torch/csrc with nvcc;
  2. each kernel wrapper against its plain PyTorch version on the card at
     ViT-B/16 serving shapes (B=128, N=197, C=768, 12 heads, adapter 64,
     MLP 3072), with both times and the card's bound for the same work:
     K2 attention_sublayer_serving, K3 dyt_prologue_serving (with and
     without the router), K4 q8_ln_mlp (dense and dispatch rows), K5
     attention_sublayer_serving_q8, K6 dyt_prologue_serving_q8 (with and
     without the router), K10 attn_core_pairs_q8 (also at B=32, N=512, the
     longest N the JAX package gives it, in 12 heads of 64 and 6 of 128;
     all three also held to the contract check: 99% of outputs within one
     bf16 ulp of the plain version's own value), the adapter/router kernel
     of K3 and K6 alone on an fp32 x_mid, K7
     dyt_prologue_serving_moe (4 experts of 64; with and without the
     router), K8 dyt_prologue_serving_q8_moe (with and without the router,
     and with the K10 core); then the hand int8 GEMM at the int8 path's
     GEMM shapes with its raw int32 store beside torch._int_mm and with
     the stem's bf16 store beside cuBLAS bf16, each with its bound and
     share, every element exact against the float64 product, and the hand
     bf16 GEMM (fp32 out) beside torch.mm(out_dtype=float32) at the same
     shapes, with TFLOP/s and the bound (reference times, not used by the
     port); then K9 mha_windowed_fused at the segmentation
     path's shape (N = 1025 tokens of a 512^2 crop, 12 heads of 64, a bf16
     bias in the layer's padded layout) at batch 1 and 2, also held to the
     contract check (99% of outputs within one bf16 ulp), beside
     F.scaled_dot_product_attention with the bias as its mask (a reference
     time only), and the time of the bias build that feeds it; then K11
     fused_ln_mlp at the speed-test path's rows (dispatch 128*99 without a
     gate, mask 128*197 with one, tanh GELU; a small ragged erf shape),
     beside the cuBLAS chain of fast_vit_forward(use_kernel=False)'s MLP (a
     reference time only); then the attention kernels at B=128, N=197,
     12 heads of 64, each beside F.scaled_dot_product_attention on the same
     q, k, v (a reference time only): K1 mha_serving_fused on raw qkv, K15
     mha_serving on contiguous q, k, v and on views of the raw qkv, K13
     flash_attention (and at B=1, N=1025 with an fp32 bias), K14
     packed_attention, each also held to the contract check (99% of
     outputs within one bf16 ulp of the plain version's own value, which a
     kernel that rounds p at another point fails), and K1 and K15 (views
     of the raw qkv) past the N whose keys and values fit the staged core,
     where they walk them through the ring: B=32, N=901 (12 heads of 64)
     and N=442 (6 heads of 128), each against its plain version, held to
     the contract check, with its bound and SDPA's time; K13 and
     K14, which only tests call, are first run once each as their own
     path with the counts set to 0; then K12
     q8_dispatch_mlp at the int8 dispatch path's shape (B=128, N=197,
     C=768, MLP 3072, K=99, tanh GELU) with seeded router scores of which
     about a tenth of the top K fall under the threshold, beside the
     Block's unfused chain (dispatch_mlp around q8_ln_mlp, a reference
     time) and whether the two agree bit for bit; then K16, the matmul
     probe utils/profile_int8.make_mm, at the probe's five shapes in int8
     (exact) and bf16 (within 2**-16 of the largest |output| of the
     float64 product: fp32 sums), each beside one library call (torch._int_mm,
     torch.mm(out_dtype=float32); reference times only); K12 and K16,
     which no serving path calls, each run once first as their own path
     with the counts set to 0;
  3. the serving main path through dynamic_tuning_tpu_torch.speed.main:
     ViT-B/16 at 224^2, 12 blocks, batch 128, seeded synthetic weights;
     bf16 dispatch, dense and plain, int8 dispatch, dense and plain,
     int8_attn dispatch, and with the MoE adapter (4 experts) bf16, int8
     and int8_attn dispatch.  Per run, with every launch count set to 0
     just before it: finite logits, 12 launches per forward of each of the
     run's kernels and none of the others, img/s; for the dispatch runs,
     logits and gates against the same forward on the plain versions and
     the mean keep ratio;
  4. segmentation serving through dynamic_tuning_tpu_torch.bench.seg_family:
     the DyT segmentor (ViT-B/16 backbone at 512^2, UPerHead 768, 150
     classes, seeded synthetic weights) in dispatch, the dense comparator
     and int8 dispatch, batch-1 crops; with the counts set to 0 just
     before: 12 K9 launches per forward (int8: and 12 K4 and the stem
     once) and none of the other kernels, finite logits, crops/s; each
     first forward against the same forward on the plain
     versions -- for dispatch, its gates against the free-running
     plain-version forward's, and its logits against the plain-version
     forward given the kernel forward's dispatch decisions (per-pixel
     logits: a gate that flips near 0 rewrites its own patch's logits,
     whatever the kernels' error);
  5. slide inference (dispatch) over one 512x683 image (two windows at
     stride 341), the strip only the first window covers held against that
     window's own forward; then SegRunner.evaluate (seg_train.py --eval)
     on 2 synthetic 512^2 images, with K9's launches counted;
  6. the segmentation backbone without windows, with LayerScale and BEiT
     q/v biases (SegVisionTransformer(use_rel_pos_bias=False,
     init_values=0.1, qv_bias_only=True), ViT-B/16 width and depth, seeded
     weights) at 256^2 (257 tokens), batch 8, in dispatch and dense
     (complete_model): 12 K1 launches per forward and none of the others,
     finite features, gate agreement with the plain-version forward and
     the features against it given the same dispatch decisions, img/s;
     then beit_backbone on one 512^2 crop in dispatch, K9 in every block,
     held the same way;
  7. the speed-test path: models/fast_inference.fast_vit_forward on
     ViT-B/16 at 224^2, batch 128, phase 3's weights, in dispatch, mask and
     dense with use_kernel=True; per mode, with the counts set to 0 just
     before it: 12 K11 and 12 K15 launches per forward and none of the
     others, finite logits, gates and logits against the same forward on the plain
     versions, img/s, and img/s with use_kernel=False beside it; then
     predict.serve (the port's predict.py without decoding) on 130
     synthetic uint8 canvases, one chunk of 128 and a tail of 2, in
     dispatch, auto and int8 dispatch: well-formed results, keep ratios in
     [0, 1], and the launches of K15 (bf16) or of the int8 kernels;
  8. past the N whose keys and values fit the staged attention core:
     fast_vit_forward on ViT-B/16 at 480^2 (N = 901, 12 blocks, batch 32)
     in dispatch and dense, then predict.serve at --img_size 480 on 34
     canvases; the serving model of width 768 in 6 heads of 128 at 336^2
     (N = 442, 12 blocks, batch 32) in bf16 and int8 dispatch (K3, or K6
     and K4).  Per run, with every launch count set to 0 just before it:
     12 launches per forward of each of its kernels and none of the
     others, logits and gates against the same forward on the plain
     versions (gate agreement >= 0.995), img/s;
  9. training (after phase 3): the port's train step (train/engine.py:
     student and teacher forwards, the four-term loss, the backward, AdamW)
     on ViT-B/16 at full width and depth with the bench's train setup
     (batch 64, bf16 compute on fp32 master parameters, lr 1e-3, 100 steps
     an epoch) from phase 3's weights, 8 steps: every loss part finite,
     grad_norm finite and above 0, the frozen parameters bit-unchanged and
     every trainable tensor moved, no hand kernel launched (counts set to 0
     just before), peak memory; then the trained model serves in dispatch:
     12 K3 launches, logits equal to those of a fresh copy of the trained
     weights (the serving weight copies refreshed) and held against the
     plain-version forward as in phase 3; then a 2-block fp32 model of
     width 768 (dropout 0, TF32 off) takes 3 steps on the card and on the
     CPU from the same weights and the same gumbel noise: loss parts within
     rtol 1e-4, keep ratios and the final gates identical;
 10. the bench (after phase 5): dynamic_tuning_tpu_torch.bench.main at
     its full protocol (image, int8, MoE, chip probe, train, video and seg
     families), with the counts set to 0 just before: one JSON line whose
     keys are BENCH_r05.json's, every field not null by design (the video
     and int8 seg fields included) a positive number, and K2, K3, K4, K6,
     K7, K8 and K9 launched as often as its forwards need (the train family
     none; the video family K2, K3, K6 + K4 and the int8 stem once a
     forward; the seg family K9, and its int8 model K4 and the stem);
 11. the image runner (after phase 9), through the port's entry points
     main_image.main and main_vtab.main at ViT-B/16 width and depth, phase
     3's weights given as a --finetune .pth: A, two epochs of synthetic
     data at batch 128 (8 steps each, train augmentation on the card, an
     eval of 256 images after each); C, the same flags resumed from A's
     epoch-0 checkpoint (epoch 1 alone, traced by torch.profiler for the
     idle share); C's final_checkpoint.msgpack and optimizer moments equal
     A's bit for bit, step and count equal, C's restored best metric A's
     epoch-0 metric; A's last eval equals a fresh model loaded from A's
     final_checkpoint.msgpack; main_vtab --task synthetic (the VTAB recipe:
     batch 64, no augmentation, adapter 16, dispatch eval), one epoch;
     main_image --eval --eval_ckpt on A's newest checkpoint gives the
     acc1 of the eval that saved it.  Every epoch launches no hand kernel,
     every eval forward K3 12 times and nothing else (counts checked at
     each epoch's and eval's edges), each eval forward held against the
     same forward on the plain versions (5% of the largest logit, gates
     >= 99.5%); train img/s over A's second epoch, the traced epoch's
     idle share, the augmentation's ms a batch, eval img/s, peak memory;
 12. the video runner (after phase 11), through the port's entry point
     main_video.main at the video DyT ViT-B/16's full width and depth (8
     frames at 224^2, 400 classes), phase 3's weights given as a
     --finetune .pth (the head re-drawn, the query token and the attentive
     pooling at their init): A, two epochs of synthetic clips at batch 16
     (16 steps each, the K400 train augmentation on the card: short-side
     jitter, crop, flip), a 3-view eval of 64 clips after each (8 clips x
     3 views x 8 frames = 192 frames a forward); C, the same flags resumed
     from A's epoch-0 checkpoint (epoch 1 alone, its last 4 steps traced
     for the idle share): C's final_checkpoint.msgpack and optimizer moments equal A's bit
     for bit; main_video --eval --eval_ckpt on A's newest checkpoint gives
     the acc1 of the eval that saved it.  Every epoch launches no hand
     kernel, every eval forward K3 12 times and nothing else (counts
     checked at each epoch's and eval's edges), each eval forward held
     against the same forward on the plain versions (5% of the largest
     logit, gates >= 99.5%); then one dispatch forward of the tubelet-2
     model (16 clips, 4 frame groups each: 12 K3 launches) held the same
     way, its stem the image stem inflated over the tubelet, and beside it
     the same forward with the stem at random init as a diagnostic, each
     gate that differs from the plain-version forward's printed with its
     distance from its boundary in bf16 ulps, and K3 on each block's
     inputs no more than twice as far from the plain version evaluated in
     fp32 as its plain version; the SSv2 train batch (RandAugment, random
     resized crop) on the card against the CPU's from the same draws (one
     count); train clips/s over A's second epoch, the traced steps' idle
     share, eval clips/s, peak memory;
 13. segmentation training (after phase 5), through the port's entry
     point seg_train.main: ViT-B/16 at full width and depth + UPerHead 768
     at 512^2 crops, batch 2 of synthetic data, bf16 on fp32 masters, the
     seg family's weights as the backbone's --finetune: A, 16 iterations
     with evaluations (16 crops by slide inference) at 8 and 16; C, resumed
     from A's iteration-8 checkpoint with --quant int8 (training bf16,
     evaluating int8), its last 4 steps traced for the idle share: C's
     trainable tensors and moments equal A's bit for bit; a --seg_norm bn
     run of 2 iterations, whose running statistics a resume restores.
     Training launches no hand kernel; every evaluation forward K9 12
     times (int8: and K4 12 times and the stem once) and nothing else,
     each held against the plain versions (5% of the largest logit given
     the same gates; the evaluation's gates, all its forwards together,
     >= 99.5% against the free-running plain-version forwards'); train
     crops/s and ms a step, peak memory, the idle share.
     Then int8: q8_conv (im2col + torch._int_mm) at the UPerHead's shapes,
     its int32 sums exact against the float64 product, with its time and
     bound; one int8 dispatch crop forward (K9 x12, K4 x12, the stem once)
     against the plain versions;
 14. data-parallel training (after phase 13), through the port's entry
     points under torchrun's variables: (b) two processes on this card
     over gloo (``python3 chip_smoke.py --parallel-worker DIR``, NCCL
     refuses two ranks on one card) run main_image.main at ViT-B/16's
     width and depth, 16 images a rank, 3 steps, then an evaluation of 33
     synthetic images (rank 1's shard padded), against one process at 32
     images a step: the ranks end identical, the first moments (the
     summed gradients) within relative L2 2**-5 of one process's, world
     2's accuracy equal to one process's on world 2's weights, gates >=
     GATE_AGREE; K3 counted in every evaluation; (c) seg_train.main with
     BatchNorm heads, 2 ranks x 2 crops against 1 x 4: the running
     statistics and the auxiliary head's first moments within 2**-5,
     every other group's (backbone, PSP, decode head) within 2**-4; the
     same first iteration in fp32 through SegRunner.train_step: running
     statistics within 1e-4, every settled first moment (at least 2**-5
     of its tensor's largest) of one process's sign, the two
     gradient-free FPN biases below 2**-10 of their group; (a)
     an NCCL group of world 1: 4 image steps through the all-reduce
     against the same steps without a group, and the all-reduce alone at
     the image and seg buckets; (d) the native JPEG loader: built or not
     and why, its canvases of dynamic_tuning_tpu_torch/native/fixtures
     within one count of PIL's, its decode time; prints the ``decoder:``
     line, a ``ddp`` JSON line and a ``ddp:`` summary;
 15. the JAX package's files (after phase 7): (a) phase 3's weights
     written as final_checkpoint.msgpack by the port's writer and as a
     .pth, each loaded by predict.load_params (size, load ms, the card's
     name and power limit) and served by predict.serve (128 canvases) and
     one dispatch forward of 128 images: the serving tensors, results and
     logits bit-identical, 12 K15 launches a forward; (b) main_image at
     batch 16, 2 epochs of 4 steps, --finetune the .msgpack of (a),
     resumed from its checkpoint-0.msgpack: the final_checkpoint.msgpack
     byte-identical, the moments too, K3 12 a forward in every eval; (c)
     a BatchNorm segmentor's running statistics through save_aux_state /
     load_aux_state into a copy without them: buffers and a 512^2 dispatch
     crop's logits bit-identical, 12 K9 a forward; (d) the committed
     JAX-written dynamic_tuning_tpu_torch/fixtures/final_checkpoint.msgpack
     decoded and re-encoded byte for byte; (e) the native video decoder:
     if it builds, the committed clip's frames equal the JAX decoder's
     stored frames, else ``native_video: unavailable: <why>``;
 16. the fp32 forms, the adapter and MoE widths and the head dims 192,
     256 and past 256 (``FORMS``): each fp32 form against its plain
     version at ViT-B/16 width (B=32, N=197, 12 heads of 64, F=64, MoE 4 x
     64; K9 at B=1, N=1025), within 1e-5 of the plain version's largest
     |output|, router logits too (K6/K8 with fp32 adapters also print the
     share within 1e-5: their core's output is requantized, so it must
     land on the plain version's bits), with its bound (float64 products
     at the FP64 tensor peak); the exact core (DMMA) alone at head dims
     64, 128, 192 and 256 and the float64 tail (DMMA) alone, adapter and
     MoE 4 x 64, each bit for bit and timed beside its bound; K1/K9 beside
     SDPA in fp32 (on the register-tiled fp32 core) and the fp32 GEMM alone
     beside torch.matmul with TF32 off; the bf16 forms at F = 8 (padded)
     and 256 (the SIMT tail), MoE 2 x 4 (padded), K7 and K8 at 4 x 192
     (the wgmma tail past 512: lines "...@4x192") and K7 at 4 x 260 (the
     SIMT tail, checked), head dims 192 (C=768) and 256 (C=1024) in 4
     heads and 384 (C=768 in 2 heads): K3, K15 and K1 (the wgmma core; at
     384 the wgmma core past 256, hd a run-time count), K6 with the
     int8-score core, K10 (its int8-score wgmma core; at 384 the wgmma key
     ring), K9 at B=1, N=1025 (the wgmma ring with the bias blocks; at 384
     the core past 256 with them) beside SDPA with its bias as the mask,
     each held to ``ulp_share`` too and timed (the cores through their C
     entries), K10 beside the SIMT form an earlier tree ran; K10 on the key
     ring past the staged core's N (head dim 192 at N = 320, 256 at N =
     300), within two ulps and ``ulp_share``; in fp32 at 384 (the fp32
     core past 256) K1 beside SDPA in fp32, K9 beside SDPA
     with its mask, K3; every core form at 2 heads of 320 and of 832 (past
     the cores' 768: the SIMT core's slices) checked (bf16 and fp32 K1,
     K9, K10, K2, K3, K7, at 320 K5, K6, K8 with and without int8 scores,
     K15, the exact route's slices kernel bit for bit); then the main path
     of each form, the counts set to 0 just before each run and no launch
     in a form the run does not list: speed.main in fp32 (dispatch, int8 and int8_attn at
     batch 128 against the plain-version forward, logits within 1e-3 of
     the largest, gates agreeing on 0.9995 with each differing gate's
     distances printed; dense; plain and MoE at batch 32 held the same
     way, int8 MoE to the int8 bounds of phase 3) and in bf16 at F = 256,
     8, MoE 4 x 192 (bf16 and int8, each against the plain-version
     forward) and 2 x 4, and in fp32 in 2 heads of 384 (dispatch,
     batch 32); a bf16 ViT-B/16 at head dims 192 and 384 against its
     plain-version forward (its img/s at batch 32); the BEiT backbone on a
     512^2 crop (K9) in bf16 at head dims 192 and 384 and in fp32 at 384;
     predict.serve at head dims 192 and 384 (--quant none, at 192 its
     forward against the plain-version forward, and int8_attn, at 384 its
     model's forward against the plain-version forward); main_image,
     main_vtab and main_video with --compute_dtype float32 (short runs,
     each with an evaluation on the dispatch path); an fp32 seg crop
     evaluation (K9 fp32 in every block); the LayerScale backbone (K1) in
     fp32 at head dims 64 and 384 and in bf16 at 384; each with 12
     launches a forward of its kernels and none of the others;
 17. the wall time (and each new phase's), the card's name and power limit
     (nvidia-smi), a JSON line of the kernels, and last the JSON result
     line.
Needs no network and imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import sys
import time
from unittest import mock

REPO = os.path.dirname(os.path.abspath(__file__))
B, N, C, H, FFN = 128, 197, 768, 12, 64
HID = 4 * C
MOE = 4                         # MoE adapter: 4 experts of width FFN
TAU = 1.0                       # the expert router's temperature (default)
DEPTH = 12
K_DISPATCH = 99                 # capacity_for(196, 0.5): rows kept per image
SRC = "dynamic_tuning_tpu_torch/csrc"
JAX_OPS = "dynamic_tuning_tpu/ops"
# name -> (module of the wrapper, JSON fields)
KERNELS = {
    "attention_sublayer_serving": ("ms", dict(
        route="cuda", source=f"{SRC}/attention_sublayer.cu",
        replaces=f"{JAX_OPS}/mha_serving.py:465")),
    "dyt_prologue_serving": ("ms", dict(
        route="cuda", source=f"{SRC}/dyt_prologue.cu",
        replaces=f"{JAX_OPS}/mha_serving.py:581")),
    "q8_ln_mlp": ("qt", dict(
        route="cuda", source=f"{SRC}/quant.cu",
        replaces=f"{JAX_OPS}/quant.py:152")),
    "attention_sublayer_serving_q8": ("qt", dict(
        route="cuda", source=f"{SRC}/quant.cu",
        replaces=f"{JAX_OPS}/quant.py:406")),
    "dyt_prologue_serving_q8": ("qt", dict(
        route="cuda", source=f"{SRC}/quant.cu",
        replaces=f"{JAX_OPS}/quant.py:531")),
    "attn_core_pairs_q8": ("qt", dict(
        route="cuda", source=f"{SRC}/quant.cu",
        replaces=f"{JAX_OPS}/quant.py:309")),
    "dyt_prologue_serving_moe": ("ms", dict(
        route="cuda", source=f"{SRC}/moe_adapter.cu",
        replaces=f"{JAX_OPS}/mha_serving.py:763")),
    "dyt_prologue_serving_q8_moe": ("qt", dict(
        route="cuda", source=f"{SRC}/moe_adapter.cu",
        replaces=f"{JAX_OPS}/quant.py:674")),
    "mha_windowed_fused": ("ms", dict(
        route="cuda", source=f"{SRC}/windowed_attention.cu",
        replaces=f"{JAX_OPS}/mha_serving.py:321")),
    "fused_ln_mlp": ("fm", dict(
        route="cuda", source=f"{SRC}/fused_mlp.cu",
        replaces=f"{JAX_OPS}/fused_mlp.py:53")),
    "mha_serving_fused": ("ms", dict(
        route="cuda", source=f"{SRC}/attention_sublayer.cu",
        replaces=f"{JAX_OPS}/mha_serving.py:219")),
    "flash_attention": ("fa", dict(
        route="cuda", source=f"{SRC}/softmax_attention.cu",
        replaces=f"{JAX_OPS}/flash_attention.py:73")),
    "packed_attention": ("pa", dict(
        route="cuda", source=f"{SRC}/softmax_attention.cu",
        replaces=f"{JAX_OPS}/packed_attention.py:86")),
    "mha_serving": ("ms", dict(
        route="cuda", source=f"{SRC}/attention_sublayer.cu",
        replaces=f"{JAX_OPS}/mha_serving.py:49")),
    "q8_dispatch_mlp": ("qt", dict(
        route="cuda", source=f"{SRC}/quant.cu",
        replaces=f"{JAX_OPS}/quant.py:272")),
    "make_mm": ("pi", dict(
        route="cuda", source=f"{SRC}/quant.cu",
        replaces="scripts/profile_int8.py:24")),
}
# the segmentation path: 512^2 crops of 16^2 patches -> 32x32 + CLS tokens
SEG_GRID = 32
SEG_N = SEG_GRID * SEG_GRID + 1
SEG_CLASSES = 150
# the LayerScale / q-v-bias backbone without windows: 256^2 crops of 16^2
# patches -> 16x16 + CLS = 257 tokens, so every block's Attention takes K1
LS_IMG, LS_BATCH = 256, 8
# (quant, mode, MoE experts, kernels launched once per block of each forward)
RUNS = [
    ("none", "dispatch", 0, ("dyt_prologue_serving",)),
    ("none", "dense", 0, ("dyt_prologue_serving",)),
    ("none", "plain", 0, ("attention_sublayer_serving",)),
    ("int8", "dispatch", 0, ("dyt_prologue_serving_q8", "q8_ln_mlp")),
    ("int8", "dense", 0, ("dyt_prologue_serving_q8", "q8_ln_mlp")),
    ("int8", "plain", 0, ("attention_sublayer_serving_q8", "q8_ln_mlp")),
    ("int8_attn", "dispatch", 0, ("dyt_prologue_serving_q8", "q8_ln_mlp",
                                  "attn_core_pairs_q8")),
    ("none", "dispatch", MOE, ("dyt_prologue_serving_moe",)),
    ("int8", "dispatch", MOE, ("dyt_prologue_serving_q8_moe", "q8_ln_mlp")),
    ("int8_attn", "dispatch", MOE, ("dyt_prologue_serving_q8_moe",
                                    "q8_ln_mlp", "attn_core_pairs_q8")),
]
# Kernel vs plain version on the card: the same rounding points, sums in
# another order, so a bf16 output may move by one ulp on a boundary, and an
# int8 activation on a rounding boundary may take the neighbouring code (one
# code step moves an output by ~|w| * amax / 127, a few 1e-3 of its range):
# every output within 2 bf16 ulps of its largest magnitude.  Router logits
# (fp32): 2e-3 of the largest |logit|; a gate may differ only within that
# distance of 0.
BF16_REL = 2 * 2.0 ** -8
# K16's bf16 product is summed in fp32 and stored as fp32: against the
# float64 product within 2**-16 of its largest |output| (sums in another
# order); a kernel that rounded its sums or its output to bf16 (2**-9 of an
# output) fails.
FP32_SUM_REL = 2.0 ** -16
LOGIT_REL = 2e-3
# Whole-model dispatch logits, kernels vs plain versions: the per-kernel
# differences above, carried through 12 blocks, and a gate may flip where a
# router logit sits within noise of 0 (about 1 in 1000 tokens).
MODEL_REL = 0.05
# the video phase traces the last steps of an epoch (the profiler's event
# processing grows with the ~3400 kernels of each step)
TRACE_STEPS = 4
GATE_AGREE = 0.995
FAST_ITERS = 5                  # timed forwards per run of the fast path
SERVE_N = 130                   # predict.serve canvases: a chunk of 128 + 2
# past the N whose keys and values fit the staged attention core (864 at
# head_dim 64, 416 at 128): ViT-B/16 at 480^2 (30x30 patches + CLS), and
# width 768 in 6 heads of 128 at 336^2 (21x21 + CLS)
LONG_IMG, LONG_B = 480, 32
LONG_N = (LONG_IMG // 16) ** 2 + 1
H128_IMG, H128_HEADS = 336, 6
H128_N = (H128_IMG // 16) ** 2 + 1
LONG_SERVE = 34                 # predict.serve canvases at 480^2
Q8_MAX_N = 512                  # the JAX Block routes int8_attn to K10 to here


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def attn_ops(batch=B, tokens=N):
    """QK^T and PV of the attention core: each 2 * B * H * N * N * hd."""
    return 2 * batch * H * tokens * tokens * (C // H)


def kernel_inputs(torch, ms):
    g = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16

    def r(*shape, s=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=g, device="cuda") * s).to(dtype)

    x = r(B, N, C, dtype=bf)
    sub = (r(C, s=0.05) + 1.0, r(C, s=0.02), r(3 * C, C, s=0.03, dtype=bf),
           r(3 * C, s=0.02), r(C, C, s=0.03, dtype=bf), r(C, s=0.02))
    ad = (r(FFN, C, s=0.03, dtype=bf), r(FFN, s=0.02),
          r(C, FFN, s=0.02, dtype=bf), r(C, s=0.01),
          torch.full((1,), 0.1, device="cuda"), r(1, C, s=25.0 / C ** 0.5),
          r(1, s=0.1))
    mlp = (r(C, s=0.05) + 1.0, r(C, s=0.02), r(HID, C, s=0.03),
           r(HID, s=0.02), r(C, HID, s=0.03), r(C, s=0.02))
    qkv = r(B, N, 3 * C)
    qkv[..., C:2 * C] += 1.0                       # keys with a lane offset
    # MoE experts in the tail's layout; router logits of a few units, so
    # the gates differ per token
    moe = (r(MOE, C, s=2.0 / C ** 0.5),
           *ms.moe_kernel_weights(r(MOE, C, FFN, s=0.03), r(MOE, FFN, s=0.02),
                                  r(MOE, FFN, C, s=0.02), bf),
           r(MOE, C, s=0.01), ad[4])
    return x, sub, ad, mlp, qkv.to(bf), moe


def rel_err(got, want) -> tuple[float, float]:
    err = (got.float() - want.float()).abs().max().item()
    return err, want.float().abs().max().item()


def check_close(what, got, want, rel=BF16_REL) -> float:
    err, mag = rel_err(got, want)
    if not err <= rel * mag:
        fail(f"{what}: max |err| {err} > {rel * mag}")
    return err


def check_logits(what, got, want, rel=LOGIT_REL) -> float:
    lerr, lmag = rel_err(got, want)
    tol = rel * lmag
    sure = want.abs() > tol
    flips = int(((got > 0) != (want > 0))[sure].sum())
    if lerr > tol or flips:
        fail(f"{what} logits: max |err| {lerr} (tol {tol}), {flips} gate "
             "flips beyond the tolerance")
    print(f"{what} router logits: max|err| {lerr:.6g} (tol {tol:.6g}), "
          "gates identical where |logit| > tol")
    return lerr


def check_ulp_share(what, got, want) -> None:
    """99% of outputs within one bf16 ulp of the plain version's own value
    (``ops/flash_attention.ulp_share``), which a kernel that rounds p or q
    at another point fails."""
    from dynamic_tuning_tpu_torch.ops import flash_attention as fa
    share = fa.ulp_share(got, want)
    if share < fa.ULP_SHARE:
        fail(f"{what}: {share} of outputs within one bf16 ulp of the plain "
             f"version's, under {fa.ULP_SHARE}")
    print(f"  {what}: {share:.6f} of outputs within one bf16 ulp of the "
          f"plain version's (needs {fa.ULP_SHARE})")


def measure(name, call, plain, outputs, inputs, ops, timed=None,
            plain_iters=20, rel=BF16_REL, logit_rel=LOGIT_REL,
            library=None, check_only=False) -> dict:
    """Check ``call()`` against ``plain()`` output by output (within ``rel``
    of each output's largest magnitude, router logits within
    ``logit_rel``) and, unless ``check_only``, time both (``timed()`` in
    place of ``call()`` when given: the same launch without the wrapper's
    host work; the plain version over ``plain_iters`` calls) and
    ``library()``, one PyTorch call of the same function, when given.
    ``outputs`` names each output ("logits" for router logits)."""
    import torch
    got, want = call(), plain()
    torch.cuda.synchronize()
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    worst = 0.0
    for out_name, a, b in zip(outputs, got, want):
        if out_name == "logits":
            worst = max(worst, check_logits(name, a, b, logit_rel))
        else:
            worst = max(worst, check_close(f"{name} {out_name}", a, b, rel))
    if check_only:
        print(f"{name}: max|err| {worst:.6g} (checked, not timed)")
        return dict(max_abs_err=worst)
    ms_k = time_ms(timed or call)
    ms_p = time_ms(plain, iters=plain_iters, warmup=min(3, plain_iters))
    ms_l = None if library is None else time_ms(library)
    b_ms, b_by = bound(nbytes(*inputs) + nbytes(*got), ops)
    lib_txt = "" if ms_l is None else f", library {ms_l:.4f} ms"
    print(f"{name}: max|err| {worst:.6g}; kernel {ms_k:.4f} ms, plain "
          f"{ms_p:.4f} ms{lib_txt}, bound {b_ms:.4f} ms ({b_by})")
    return dict(max_abs_err=worst, ms=ms_k, plain_ms=ms_p, bound_ms=b_ms,
                bound_by=b_by, library_ms=ms_l)


def phase_kernels(torch, ms, qt, _build) -> dict:
    """Each wrapper against its plain version at the main path's shapes."""
    x, sub, ad, mlp, qkv, moe = kernel_inputs(torch, ms)
    qsub = (*sub[:2], *qt.quantize_weight(sub[2].float()), sub[3],
            *qt.quantize_weight(sub[4].float()), sub[5])
    qmlp = (*mlp[:2], *qt.quantize_weight(mlp[2]), mlp[3],
            *qt.quantize_weight(mlp[4]), mlp[5])
    M = B * N
    gemm = 2 * M * C * 4 * C                       # qkv + proj
    adapter = 4 * M * C * FFN
    out = {}

    out["attention_sublayer_serving"] = measure(
        "K2 attention_sublayer_serving",
        lambda: ms.attention_sublayer_serving(x, *sub, heads=H),
        lambda: ms.attention_sublayer_plain(x, *sub, heads=H),
        ("x_mid",), (x, *sub), {"bf16": gemm + 2 * attn_ops()})
    for s in (True, False):
        res = measure(
            f"K3 dyt_prologue_serving(with_select={s})",
            lambda s=s: ms.dyt_prologue_serving(x, *sub, *ad, heads=H,
                                                with_select=s),
            lambda s=s: ms.dyt_prologue_plain(x, *sub, *ad, heads=H,
                                              with_select=s),
            ("x_mid", "adapt", "logits"), (x, *sub, *(ad if s else ad[:5])),
            {"bf16": gemm + 2 * attn_ops() + adapter,
             "fp32": 2 * M * C * s})
        if s:
            out["dyt_prologue_serving"] = res

    for rows, tag in ((B * N, "dense"), (B * K_DISPATCH, "dispatch")):
        xr = x[:, :rows // B].contiguous()
        res = measure(
            f"K4 q8_ln_mlp({tag}, {rows} rows)",
            lambda xr=xr: qt.q8_ln_mlp(xr, *qmlp, gelu_approx=True),
            lambda xr=xr: qt.q8_ln_mlp_plain(xr, *qmlp, gelu_approx=True),
            ("mlp",), (xr, *qmlp), {"int8": 4 * rows * C * HID})
        if tag == "dense":
            out["q8_ln_mlp"] = res

    out["attention_sublayer_serving_q8"] = measure(
        "K5 attention_sublayer_serving_q8",
        lambda: qt.attention_sublayer_serving_q8(x, *qsub, heads=H),
        lambda: qt.attention_sublayer_q8_plain(x, *qsub, heads=H),
        ("x_mid",), (x, *qsub), {"int8": gemm, "bf16": 2 * attn_ops()})
    for s in (True, False):
        res = measure(
            f"K6 dyt_prologue_serving_q8(with_select={s})",
            lambda s=s: qt.dyt_prologue_serving_q8(x, *qsub, *ad, heads=H,
                                                   with_select=s),
            lambda s=s: qt.dyt_prologue_q8_plain(x, *qsub, *ad, heads=H,
                                                 with_select=s),
            ("x_mid", "adapt", "logits"),
            (x, *qsub, *(ad if s else ad[:5])),
            {"int8": gemm, "bf16": 2 * attn_ops() + adapter,
             "fp32": 2 * M * C * s})
        if s:
            out["dyt_prologue_serving_q8"] = res

    out["attn_core_pairs_q8"] = measure(
        "K10 attn_core_pairs_q8",
        lambda: qt.attn_core_pairs_q8(qkv, heads=H),
        lambda: qt.attn_core_pairs_q8_plain(qkv, heads=H),
        ("core",), (qkv,), {"int8": attn_ops(), "bf16": attn_ops()})
    check_ulp_share("K10 attn_core_pairs_q8",
                    qt.attn_core_pairs_q8(qkv, heads=H),
                    qt.attn_core_pairs_q8_plain(qkv, heads=H))
    # K10 at the longest N the JAX package gives it (N <= 512), in heads of
    # 64 and of 128
    g = torch.Generator(device="cuda").manual_seed(9)
    for heads in (H, H128_HEADS):
        lq = torch.randn((LONG_B, Q8_MAX_N, 3 * C), generator=g,
                         device="cuda")
        lq[..., C:2 * C] += 1.0
        lq = lq.to(torch.bfloat16)
        tag = (f"K10 attn_core_pairs_q8(B={LONG_B}, N={Q8_MAX_N}, {heads} "
               f"heads of {C // heads})")
        ops = attn_ops(LONG_B, Q8_MAX_N)
        measure(tag, lambda: qt.attn_core_pairs_q8(lq, heads=heads),
                lambda: qt.attn_core_pairs_q8_plain(lq, heads=heads),
                ("core",), (lq,), {"int8": ops, "bf16": ops}, plain_iters=2)
        check_ulp_share(tag, qt.attn_core_pairs_q8(lq, heads=heads),
                        qt.attn_core_pairs_q8_plain(lq, heads=heads))
        del lq
    # the adapter/router kernel alone (the tail of K3 and K6) on an fp32
    # x_mid, beside the bound of its bytes: x_mid read, adapt written
    lib = _build.library()
    xm = torch.randn((B, N, C), generator=g, device="cuda")
    x_mid = xm.to(torch.bfloat16)
    measure("adapter/router kernel alone (K3/K6 tail)",
            lambda: ms.launch_adapter_router(lib, x_mid, xm, *ad, True)[1:],
            lambda: ms.adapter_router_plain(xm, torch.bfloat16, *ad,
                                            with_select=True)[1:],
            ("adapt", "logits"), (xm, *ad),
            {"bf16": adapter, "fp32": 2 * M * C})
    del xm, x_mid
    # K10 inside K5: the sublayer with the int8 core, for the PERF table
    measure("K5 attention_sublayer_serving_q8(attn_q8=True)",
            lambda: qt.attention_sublayer_serving_q8(x, *qsub, heads=H,
                                                     attn_q8=True),
            lambda: qt.attention_sublayer_q8_plain(x, *qsub, heads=H,
                                                   attn_q8=True),
            ("x_mid",), (x, *qsub), {"int8": gemm + attn_ops(),
                                     "bf16": attn_ops()})

    # the MoE prologues: the router dots (E experts + the token router) are
    # fp32 work, the two expert products bf16 tensor work
    experts = 4 * M * C * MOE * FFN
    for s in (True, False):
        res = measure(
            f"K7 dyt_prologue_serving_moe(with_select={s})",
            lambda s=s: ms.dyt_prologue_serving_moe(
                x, *sub, *moe, *ad[5:], heads=H, tau=TAU, with_select=s),
            lambda s=s: ms.dyt_prologue_moe_plain(
                x, *sub, *moe, *ad[5:], heads=H, tau=TAU, with_select=s),
            ("x_mid", "adapt", "logits"),
            (x, *sub, *moe, *(ad[5:] if s else ())),
            {"bf16": gemm + 2 * attn_ops() + experts,
             "fp32": 2 * M * C * (MOE + s)})
        if s:
            out["dyt_prologue_serving_moe"] = res
    for s, aq in ((True, False), (False, False), (True, True)):
        res = measure(
            f"K8 dyt_prologue_serving_q8_moe(with_select={s}, attn_q8={aq})",
            lambda s=s, aq=aq: qt.dyt_prologue_serving_q8_moe(
                x, *qsub, *moe, *ad[5:], heads=H, tau=TAU, with_select=s,
                attn_q8=aq),
            lambda s=s, aq=aq: qt.dyt_prologue_q8_moe_plain(
                x, *qsub, *moe, *ad[5:], heads=H, tau=TAU, with_select=s,
                attn_q8=aq),
            ("x_mid", "adapt", "logits"),
            (x, *qsub, *moe, *(ad[5:] if s else ())),
            {"int8": gemm + aq * attn_ops(),
             "bf16": (2 - aq) * attn_ops() + experts,
             "fp32": 2 * M * C * (MOE + s)})
        if s and not aq:
            out["dyt_prologue_serving_q8_moe"] = res
    return out


def phase_gemm_reference(torch, _build, pi) -> None:
    """The hand GEMMs at the serving path's GEMM shapes, beside the library:
    the int8 one with its raw int32 store (K16's entry) beside
    torch._int_mm, and with the stem's dequantizing bf16 store (unit scales,
    no bias) beside cuBLAS bf16, each with its bound and the share of it
    reached, both exact against the float64 product (the int32 sums as
    they are, and rounded once to bf16); and the bf16 one (fp32 out, as
    K16's probe) beside cuBLAS bf16 with an fp32 output.  Reference times
    only: the port calls neither library."""
    lib = _build.library()
    stream = torch.cuda.current_stream().cuda_stream
    for name, M, Nn, K in (("qkv", B * N, 3 * C, C), ("proj", B * N, C, C),
                           ("fc1", B * N, HID, C), ("fc2", B * N, C, HID),
                           ("fc1 dispatch", B * K_DISPATCH, HID, C)):
        a = torch.randint(-127, 128, (M, K), dtype=torch.int8, device="cuda")
        w = torch.randint(-127, 128, (Nn, K), dtype=torch.int8,
                          device="cuda")
        ones_m = torch.ones(M, device="cuda")
        ones_n = torch.ones(Nn, device="cuda")
        zeros = torch.zeros(Nn, device="cuda")
        out = torch.empty((M, Nn), dtype=torch.bfloat16, device="cuda")
        raw = torch.empty((M, Nn), dtype=torch.int32, device="cuda")

        def stem():
            _build.check(lib, lib.dyt_q8_stem_gemm(
                a.data_ptr(), w.data_ptr(), ones_m.data_ptr(),
                ones_n.data_ptr(), zeros.data_ptr(), M, Nn, K,
                out.data_ptr(), 0, stream), "int8 GEMM (stem store)")

        def hand_raw():
            _build.check(lib, lib.dyt_gemm_s8_s32(
                a.data_ptr(), w.data_ptr(), M, Nn, K, raw.data_ptr(),
                stream), "int8 GEMM (raw store)")

        stem()
        hand_raw()
        ref = torch.matmul(a.double(), w.double().t())      # exact
        bad = int((raw.double() != ref).sum())
        bad_bf = int((out != ref.float().to(torch.bfloat16)).sum())
        if bad or bad_bf:
            fail(f"hand int8 GEMM ({name}): {bad} int32 and {bad_bf} bf16 "
                 "elements differ from the float64 product")
        del ref
        ab, wb = a.to(torch.bfloat16), w.to(torch.bfloat16)
        ops = 2 * M * Nn * K
        line = f"GEMM {name} [{M}x{K}]x[{K}x{Nn}]: hand int8"
        for what, fn, o in (("int32 out", hand_raw, raw),
                            ("bf16 out", stem, out)):
            t = time_ms(fn)
            b_ms, b_by = bound(nbytes(a, w, o), {"int8": ops})
            line += (f" {what} {t:.4f} ms ({ops / t / 1e9:.1f} TOPS; bound "
                     f"{b_ms:.4f} ms {b_by}, {b_ms / t:.0%});")
        try:
            t_int = time_ms(lambda: torch._int_mm(a, w.t()))
            line += (f" torch._int_mm {t_int:.4f} ms "
                     f"({ops / t_int / 1e9:.1f})")
        except RuntimeError as e:          # a reference only
            line += f" torch._int_mm refused: {str(e).splitlines()[0]}"
        t_bf = time_ms(lambda: torch.matmul(ab, wb.t()))
        print(line + f", cuBLAS bf16 {t_bf:.4f} ms "
              f"({ops / t_bf / 1e9:.1f} TFLOP/s); exact")
        del raw

        # the hand bf16 GEMM on bf16 values of the same size
        g = torch.Generator(device="cuda").manual_seed(8)
        ab = torch.randn((M, K), generator=g, device="cuda").to(
            torch.bfloat16)
        wb = (torch.randn((Nn, K), generator=g, device="cuda") * 0.03).to(
            torch.bfloat16)
        mm = pi.make_mm(M, K, Nn, torch.bfloat16, torch.float32)
        got = mm.nt(ab, wb)
        want = torch.matmul(ab.double(), wb.double().t())
        err, mag = rel_err(got.double(), want)
        if not err <= FP32_SUM_REL * mag:
            fail(f"hand bf16 GEMM ({name}): max |err| {err} > "
                 f"{FP32_SUM_REL * mag}")
        del want
        b_ms, b_by = bound(nbytes(ab, wb, got), {"bf16": ops})
        t_hand = time_ms(lambda: mm.nt(ab, wb))
        t_lib = time_ms(lambda: torch.mm(ab, wb.t(), out_dtype=torch.float32))
        print(f"  hand bf16 GEMM, fp32 out: {t_hand:.4f} ms "
              f"({ops / t_hand / 1e9:.1f} TFLOP/s); "
              f"torch.mm(out_dtype=float32) {t_lib:.4f} ms "
              f"({ops / t_lib / 1e9:.1f}); bound {b_ms:.4f} ms ({b_by}); "
              f"max|err| {err:.6g} of {mag:.6g}")
        del a, w, ab, wb, got, out
    torch.cuda.empty_cache()


def windowed_launch(torch, ms, qkv, bias, heads=H):
    """K9's launch through its C entry alone, on ``qkv`` and the layer's
    padded bf16 ``bias`` (what the wrapper launches after its checks)."""
    from dynamic_tuning_tpu_torch.ops import _build
    lib = _build.library()
    batch, n, c3 = qkv.shape
    out = torch.empty((batch, n, c3 // 3), dtype=torch.bfloat16,
                      device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    scale = (c3 // 3 // heads) ** -0.5

    def launch():
        _build.check(lib, lib.dyt_mha_windowed(
            qkv.data_ptr(), bias.data_ptr(), out.data_ptr(), batch, n,
            c3 // 3, heads, bias.stride(0), bias.stride(1), scale, stream),
            "windowed attention kernel")
    return launch


def exact_q8_launch(torch, qt, qkv, heads):
    """fp32 K10 on the exact core's int8-score mode through its C entry
    (the code kernels and the kernel; what the wrapper launches after its
    checks)."""
    from dynamic_tuning_tpu_torch.ops import _build
    lib = _build.library()
    batch, n, c3 = qkv.shape
    C_ = c3 // 3
    out = torch.empty((batch, n, C_), device="cuda")
    scratch = qt._core_scratch(lib, batch, n, C_, heads, qkv.device)
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        _build.check(lib, lib.dyt_exact_core_q8(
            qkv.data_ptr(), out.data_ptr(), scratch.data_ptr(), batch, n, C_,
            heads, (C_ // heads) ** -0.5, stream), "exact int8-score core")
        return out
    return launch


def core_launch(torch, q, k, v, *, k15=False, bias=None):
    """The attention core's launch through its C entry alone (what the
    wrapper launches after its checks) on strided q, k, v [B, H, N, hd]:
    bf16 on the wgmma core (K1's or K15's mode), fp32 on the fp32 core
    (K1's rounding, with K9's padded bf16 ``bias``)."""
    from dynamic_tuning_tpu_torch.ops import _build
    lib = _build.library()
    batch, heads, n, hd = q.shape
    out = torch.empty((batch, n, heads, hd), dtype=q.dtype,
                      device="cuda").transpose(1, 2)
    stream = torch.cuda.current_stream().cuda_stream
    st = _build.strides_arg(q, k, v, out)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), st,
            batch, n, heads, hd, hd ** -0.5)
    if q.dtype == torch.float32:
        def launch():
            _build.check(lib, lib.dyt_f32_core(
                *ptrs, None if bias is None else bias.data_ptr(),
                0 if bias is None else bias.stride(0),
                0 if bias is None else bias.stride(1), stream),
                "fp32 attention core")
    else:
        def launch():
            _build.check(lib, lib.dyt_mha_core(*ptrs, int(k15), stream),
                         "attention core kernel")
    return launch


def phase_windowed(torch, ms, layers) -> dict:
    """K9 against its plain version at the segmentation path's shape (two
    bf16 ulps, and 99% of outputs within one ulp of the plain version's own
    value), with SDPA (the bias as its additive mask) as the library's time
    for the same function (max-subtracted softmax: the same up to the
    clamp)."""
    import torch.nn.functional as F
    from dynamic_tuning_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device="cuda").manual_seed(1)
    ld = ms.bias_row_stride(SEG_N)
    # the bias in the layout the layer builds: rows padded to 16 bytes
    bias = (torch.randn((H, SEG_N, ld), generator=g, device="cuda")
            .to(torch.bfloat16)[:, :, :SEG_N])
    out = {}
    for batch in (1, 2):
        qkv = torch.randn((batch, SEG_N, 3 * C), generator=g,
                          device="cuda").to(torch.bfloat16)
        wrapper = lambda: ms.mha_windowed_fused(qkv, bias, heads=H)
        # at B=1 the wrapper's host checks take longer than the kernel:
        # the kernel is timed through its C entry (the same launch), the
        # wrapper beside it
        res = measure(
            f"K9 mha_windowed_fused(B={batch}, N={SEG_N})", wrapper,
            lambda: ms.mha_windowed_plain(qkv, bias, heads=H),
            ("core",), (qkv, bias.contiguous()),
            {"bf16": 2 * attn_ops(batch, SEG_N)},
            timed=windowed_launch(torch, ms, qkv, bias))
        print(f"  through the wrapper: {time_ms(wrapper):.4f} ms")
        share = fa.ulp_share(ms.mha_windowed_fused(qkv, bias, heads=H),
                             ms.mha_windowed_plain(qkv, bias, heads=H))
        if share < fa.ULP_SHARE:
            fail(f"K9 (B={batch}): {share} of outputs within one bf16 ulp "
                 f"of the plain version's, under {fa.ULP_SHARE}")
        print(f"  K9: {share:.6f} of outputs within one bf16 ulp of the "
              f"plain version's (needs {fa.ULP_SHARE})")
        q, k, v = (t.contiguous() for t in qkv.reshape(
            batch, SEG_N, 3, H, C // H).permute(2, 0, 3, 1, 4))
        mask = bias.contiguous()[None]
        res["library_ms"] = time_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
        print(f"  SDPA with the bias as mask (reference only): "
              f"{res['library_ms']:.4f} ms")
        if batch == 1:
            out["mha_windowed_fused"] = res
    table = torch.randn(((2 * SEG_GRID - 1) ** 2 + 3, H), generator=g,
                        device="cuda").to(torch.bfloat16)
    t_bias = time_ms(lambda: layers._rel_pos_bias_from_table(
        table, SEG_GRID, SEG_GRID, row_stride=ld))
    print(f"rel-pos bias build [{H}, {SEG_N}, {SEG_N}] bf16 (one gather, "
          f"per block per forward): {t_bias:.4f} ms")
    return out


def phase_k11(torch, fm, fast) -> dict:
    """K11 against its plain version at the speed-test path's rows, with
    the cuBLAS chain of fast_vit_forward(use_kernel=False)'s MLP (folded
    LN -> fc1 -> GELU -> fc2 -> gate) beside it: a reference time, since no
    single PyTorch call computes the function."""
    g = torch.Generator(device="cuda").manual_seed(3)
    bf = torch.bfloat16

    def r(*shape, s=1.0):
        return torch.randn(shape, generator=g, device="cuda") * s

    out = {}
    for tag, rows, gated, approx, c, hid in (
            ("dispatch", B * K_DISPATCH, False, True, C, HID),
            ("mask", B * N, True, True, C, HID),
            ("ragged, erf", 77, True, False, 128, 512)):
        ln = (r(c, s=0.05) + 1.0, r(c, s=0.02))
        w1, b1 = r(hid, c, s=0.03), r(hid, s=0.02)
        w2, b2 = r(c, hid, s=0.03), r(c, s=0.02)
        mlp = (*ln, w1.to(bf), b1, w2.to(bf), b2)
        x = r(rows, c).to(bf)
        gate = ((torch.rand((rows, 1), generator=g, device="cuda") > 0.5)
                .to(bf) if gated else None)
        res = measure(
            f"K11 fused_ln_mlp({tag}, {rows} rows{', gate' if gated else ''})",
            lambda: fm.fused_ln_mlp(x, *mlp, gate, gelu_approx=approx),
            lambda: fm.ln_mlp_plain(x, *mlp, gate, gelu_approx=approx),
            ("mlp",), (x, *mlp, gate), {"bf16": 4 * rows * c * hid})
        if gated:
            got = fm.fused_ln_mlp(x, *mlp, gate, gelu_approx=approx)
            if not bool((got[gate[:, 0] == 0] == 0).all()):
                fail(f"K11 ({tag}): a gated-off row is not 0")
        folded = fast._folded(*ln, w1, b1)
        t_chain = time_ms(lambda: fast._mlp_cublas(
            x, gate, *folded, mlp[4], b2, approx))
        print(f"  cuBLAS chain of use_kernel=False (reference only): "
              f"{t_chain:.4f} ms")
        if tag == "dispatch":
            out["fused_ln_mlp"] = res
    return out


def phase_attention(torch, ms, qt, fm) -> dict:
    """K1, K15, K13 and K14 against their plain versions, each beside SDPA
    on the same q, k, v (the max-subtracted softmax: the same function up
    to the serving clamp and the rounding points; a library's time only).
    K13 and K14 have no caller beyond tests in either package: their path
    is one call of each entry point at the shapes below, with every count
    set to 0 just before; the launches of the comparisons are not counted.
    """
    import torch.nn.functional as F
    from dynamic_tuning_tpu_torch.ops import flash_attention as fa
    from dynamic_tuning_tpu_torch.ops import packed_attention as pa

    g = torch.Generator(device="cuda").manual_seed(5)
    hd = C // H
    qkv = torch.randn((B, N, 3 * C), generator=g, device="cuda").to(
        torch.bfloat16)
    views = qkv.view(B, N, 3, H, hd).permute(2, 0, 3, 1, 4)
    q, k, v = (t.contiguous() for t in views)
    bias = torch.randn((H, SEG_N, SEG_N), generator=g, device="cuda")
    sq, sk, sv = (torch.randn((1, H, SEG_N, hd), generator=g, device="cuda")
                  .to(torch.bfloat16) for _ in range(3))
    ops = {"bf16": 2 * attn_ops()}

    reset_counts(ms, qt, fm)
    fa.flash_attention(q, k, v)
    fa.flash_attention(sq, sk, sv, bias)
    pa.packed_attention(qkv, num_heads=H)
    torch.cuda.synchronize()
    path = read_counts(ms, qt, fm)

    def sdpa(what, *args, **kw):
        t = time_ms(lambda: F.scaled_dot_product_attention(*args, **kw))
        print(f"  SDPA {what} (reference only): {t:.4f} ms")
        return t

    def contract(what, call, plain):
        check_ulp_share(what, call(), plain())

    out = {}
    out["mha_serving_fused"] = measure(
        "K1 mha_serving_fused", lambda: ms.mha_serving_fused(qkv, heads=H),
        lambda: ms.attn_core_pairs(qkv, heads=H), ("core",), (qkv,), ops)
    out["mha_serving_fused"]["library_ms"] = sdpa("on q, k, v", q, k, v)
    contract("K1 mha_serving_fused",
             lambda: ms.mha_serving_fused(qkv, heads=H),
             lambda: ms.attn_core_pairs(qkv, heads=H))
    measure("K15 mha_serving (contiguous q, k, v)",
            lambda: ms.mha_serving(q, k, v),
            lambda: ms.mha_serving_plain(q, k, v), ("core",), (q, k, v),
            ops)
    contract("K15 mha_serving (contiguous q, k, v)",
             lambda: ms.mha_serving(q, k, v),
             lambda: ms.mha_serving_plain(q, k, v))
    out["mha_serving"] = measure(
        "K15 mha_serving (views of the raw qkv)",
        lambda: ms.mha_serving(*views),
        lambda: ms.mha_serving_plain(*views), ("core",), (qkv,), ops)
    contract("K15 mha_serving (views of the raw qkv)",
             lambda: ms.mha_serving(*views),
             lambda: ms.mha_serving_plain(*views))
    out["mha_serving"]["library_ms"] = out["mha_serving_fused"]["library_ms"]
    out["flash_attention"] = measure(
        "K13 flash_attention", lambda: fa.flash_attention(q, k, v),
        lambda: fa.flash_attention_plain(q, k, v), ("attention",),
        (q, k, v), ops)
    out["flash_attention"]["library_ms"] = sdpa("on q, k, v", q, k, v)
    contract("K13 flash_attention", lambda: fa.flash_attention(q, k, v),
             lambda: fa.flash_attention_plain(q, k, v))
    measure(f"K13 flash_attention(B=1, N={SEG_N}, fp32 bias)",
            lambda: fa.flash_attention(sq, sk, sv, bias),
            lambda: fa.flash_attention_plain(sq, sk, sv, bias),
            ("attention",), (sq, sk, sv, bias),
            {"bf16": 2 * attn_ops(1, SEG_N)})
    contract(f"K13 flash_attention(B=1, N={SEG_N}, fp32 bias)",
             lambda: fa.flash_attention(sq, sk, sv, bias),
             lambda: fa.flash_attention_plain(sq, sk, sv, bias))
    mask = bias.to(torch.bfloat16)[None]
    sdpa("with the bias as mask", sq, sk, sv, attn_mask=mask)
    out["packed_attention"] = measure(
        "K14 packed_attention", lambda: pa.packed_attention(qkv, num_heads=H),
        lambda: pa.packed_attention_plain(qkv, H), ("attention",), (qkv,),
        ops)
    contract("K14 packed_attention",
             lambda: pa.packed_attention(qkv, num_heads=H),
             lambda: pa.packed_attention_plain(qkv, H))
    out["packed_attention"]["library_ms"] = out["flash_attention"][
        "library_ms"]

    # K1 and K15 past the N whose keys and values fit the staged core: the
    # ring of key/value tiles (the plain versions' float64 sums take ~1 s a
    # call here, so they are timed twice)
    for n, heads in ((LONG_N, H), (H128_N, H128_HEADS)):
        hd = C // heads
        lq = torch.randn((LONG_B, n, 3 * C), generator=g,
                         device="cuda").to(torch.bfloat16)
        lviews = lq.view(LONG_B, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
        tag = f"B={LONG_B}, N={n}, {heads} heads of {hd}"
        ops = {"bf16": 2 * attn_ops(LONG_B, n)}
        measure(f"K1 mha_serving_fused({tag})",
                lambda: ms.mha_serving_fused(lq, heads=heads),
                lambda: ms.attn_core_pairs(lq, heads=heads), ("core",),
                (lq,), ops, plain_iters=2)
        contract(f"K1 mha_serving_fused({tag})",
                 lambda: ms.mha_serving_fused(lq, heads=heads),
                 lambda: ms.attn_core_pairs(lq, heads=heads))
        measure(f"K15 mha_serving(views of the raw qkv, {tag})",
                lambda: ms.mha_serving(*lviews),
                lambda: ms.mha_serving_plain(*lviews), ("core",), (lq,), ops,
                plain_iters=2)
        contract(f"K15 mha_serving(views of the raw qkv, {tag})",
                 lambda: ms.mha_serving(*lviews),
                 lambda: ms.mha_serving_plain(*lviews))
        sdpa(f"on q, k, v ({tag})", *(t.contiguous() for t in lviews))
        del lq, lviews
        torch.cuda.empty_cache()
    torch.cuda.empty_cache()
    return out, {k: path[k] for k in ("flash_attention", "packed_attention")}


def phase_k12(torch, ms, qt, fm, D) -> tuple:
    """K12 against its plain version at the int8 dispatch path's shape,
    beside the Block's unfused chain for the same function (dispatch_mlp
    around K4; a reference time, no single PyTorch call computes it).  Its
    path is one call with every count set to 0 just before."""
    g = torch.Generator(device="cuda").manual_seed(7)

    def r(*shape, s=1.0):
        return torch.randn(shape, generator=g, device="cuda") * s

    x = r(B, N, C).to(torch.bfloat16)
    qmlp = (r(C, s=0.05) + 1.0, r(C, s=0.02),
            *qt.quantize_weight(r(HID, C, s=0.03)), r(HID, s=0.02),
            *qt.quantize_weight(r(C, HID, s=0.03)), r(C, s=0.02))
    # uniform in [0, 0.917): about a tenth of the top K at or under 0.5
    scores = torch.rand((B, N), generator=g, device="cuda") * 0.917
    scores[:, 0] = float("inf")
    call = lambda: qt.q8_dispatch_mlp(x, scores, *qmlp, capacity=K_DISPATCH,
                                      gelu_approx=True)
    reset_counts(ms, qt, fm)
    out, gate = call()
    torch.cuda.synchronize()
    path = read_counts(ms, qt, fm)
    if path != {k: int(k == "q8_dispatch_mlp") for k in KERNELS}:
        fail(f"K12 path: kernel launches {path}")
    masked = 1.0 - gate.float().sum().item() / (B * K_DISPATCH)
    res = measure(
        f"K12 q8_dispatch_mlp(B={B}, N={N}, K={K_DISPATCH}; "
        f"{masked:.4f} of the slots masked)", call,
        lambda: qt.q8_dispatch_mlp_plain(x, scores, *qmlp,
                                         capacity=K_DISPATCH,
                                         gelu_approx=True),
        ("out", "gate"), (x, scores, *qmlp),
        {"int8": 4 * B * K_DISPATCH * C * HID})
    chain = lambda: D.dispatch_mlp(
        x, scores, K_DISPATCH,
        lambda rows: qt.q8_ln_mlp(rows, *qmlp, gelu_approx=True))
    c_out, c_gate = chain()
    torch.cuda.synchronize()
    same_bits = torch.equal(out.view(torch.int16), c_out.view(torch.int16))
    same = torch.equal(out, c_out) and torch.equal(gate, c_gate)
    why = ("bit-identical" if same_bits and same else
           "equal in value, the bits differ only in the sign of zeros (the "
           "chain multiplies a dropped row by 0, K12 never writes it)"
           if same else "NOT equal: max|diff| "
           f"{(out.float() - c_out.float()).abs().max().item():.6g}")
    print(f"  the Block's unfused chain (dispatch_mlp around q8_ln_mlp; "
          f"reference only): {time_ms(chain):.4f} ms; K12 against it: {why}")
    return {"q8_dispatch_mlp": res}, {"q8_dispatch_mlp": path[
        "q8_dispatch_mlp"]}


def phase_k16(torch, ms, qt, fm, pi) -> tuple:
    """K16, the matmul probe, at its five shapes in bf16 and int8 (each
    beside one library call, a reference time).  Its path is one call of
    make_mm's product at the dispatch MLP's shape, with every count set to
    0 just before; the row of the kernels line is that shape in int8."""
    Mx, Kx, Nx = pi.SHAPES[-1]
    a = torch.randint(-127, 127, (Mx, Kx), dtype=torch.int8, device="cuda")
    b = torch.randint(-127, 127, (Kx, Nx), dtype=torch.int8, device="cuda")
    reset_counts(ms, qt, fm)
    pi.make_mm(Mx, Kx, Nx, torch.int8, torch.int32)(a, b)
    torch.cuda.synchronize()
    path = read_counts(ms, qt, fm)
    if path != {k: int(k == "make_mm") for k in KERNELS}:
        fail(f"K16 path: kernel launches {path}")
    del a, b
    out = {}
    for M, K, Nn in pi.SHAPES:
        for dtype, kind in ((torch.bfloat16, "bf16"), (torch.int8, "int8")):
            res = pi.bench(M, K, Nn, dtype, pi.OUT[dtype],
                           f"K16 make_mm {kind} {(M, K, Nn)}")
            tol = 0.0 if kind == "int8" else FP32_SUM_REL * res["ref_max"]
            if not res["max_abs_err"] <= tol:
                fail(f"K16 {kind} {(M, K, Nn)}: max |err| "
                     f"{res['max_abs_err']} > {tol}")
            if kind == "int8" and (M, K, Nn) == (Mx, Kx, Nx):
                out["make_mm"] = {k: res[k] for k in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")}
    torch.cuda.empty_cache()
    return out, {"make_mm": path["make_mm"]}


def phase_layerscale(torch, ms, qt, fm, D, seg_vit, make_seg_state_dict,
                     config, np) -> dict:
    """The LayerScale / q-v-bias backbone without windows at ViT-B width
    (K1 in every block), batch 8 at 256^2, in dispatch and dense
    (complete_model); then the BEiT backbone (K9 in every block) on one
    512^2 crop.  Returns the launches of K1 and K9."""
    launches = {"mha_serving_fused": 0, "mha_windowed_fused": 0}
    g = torch.Generator(device="cuda").manual_seed(6)
    beit = dict(use_abs_pos_embed=False, init_values=0.1, qv_bias_only=True)
    for name, img, batch, knobs, kernel in (
            ("no-window LayerScale backbone", LS_IMG, LS_BATCH,
             dict(use_rel_pos_bias=False, init_values=0.1,
                  qv_bias_only=True), "mha_serving_fused"),
            ("beit_backbone", 512, 1, beit, "mha_windowed_fused")):
        cfg = config.ModelConfig(img_size=img, gelu_approx=True,
                                 residual_dtype="bfloat16")
        build = (seg_vit.beit_backbone if knobs is beit else
                 lambda *a, **kw: seg_vit.SegVisionTransformer(
                     *a, **knobs, **kw))
        model = build(cfg, config.TuningConfig(),
                      config.SelectConfig(token_target_ratio=0.5),
                      dtype=torch.bfloat16)
        sd = make_seg_state_dict(np.random.RandomState(0), depth=DEPTH,
                                 dim=C, ffn=FFN, img=img, patch=16,
                                 num_classes=SEG_CLASSES, head_channels=64,
                                 **knobs)
        model.load_state_dict({k[len("backbone."):]: torch.from_numpy(v)
                               for k, v in sd.items()
                               if k.startswith("backbone.")}, strict=True)
        model = model.to("cuda")
        x = torch.randn((batch, img, img, 3), generator=g, device="cuda")
        modes = (("dispatch", {"dispatch": True}),
                 ("dense", {"complete_model": True}))
        for mode, kw in modes[:2 if kernel == "mha_serving_fused" else 1]:
            reset_counts(ms, qt, fm)
            scores = []
            with routing(D, record=scores), torch.inference_mode():
                feats, aux = model(x, **kw)
            torch.cuda.synchronize()
            counts = read_counts(ms, qt, fm)
            want = {k: DEPTH if k == kernel else 0 for k in KERNELS}
            if counts != want:
                fail(f"{name} {mode}: kernel launches {counts}, want {want}")
            launches[kernel] += counts[kernel]
            if not all(torch.isfinite(f).all() for f in feats):
                fail(f"{name} {mode}: features not finite")
            with plain_versions(ms, qt, fm), torch.inference_mode():
                _, free_aux = model(x, **kw)
            with (routing(D, replay=scores), plain_versions(ms, qt, fm),
                  torch.inference_mode()):
                ref, _ = model(x, **kw)
            agree = (1.0 if aux["token_select"] is None else
                     (aux["token_select"] == free_aux["token_select"])
                     .float().mean().item())
            worst = 0.0
            for f, r in zip(feats, ref):
                err, mag = rel_err(f, r)
                worst = max(worst, err / mag)
            t = time_ms(lambda: model(x, **kw), iters=5, warmup=1)
            print(f"{name} {mode} ({img}^2, batch {batch}): {DEPTH} "
                  f"{kernel} launches per forward; {batch / t * 1e3:.2f} "
                  f"img/s; gate agreement with the plain-version forward "
                  f"{agree:.6f}; features vs plain versions on the same "
                  f"dispatch: max|err| {worst:.6g} of the largest (tol "
                  f"{MODEL_REL:g})")
            if worst > MODEL_REL or agree < GATE_AGREE:
                fail(f"{name} {mode} disagrees with the plain-version "
                     "forward")
        del model
        torch.cuda.empty_cache()
    return launches


def phase_fast(torch, ms, qt, fm, fast, predict, scan_throughput,
               forwards_run, sd) -> int:
    """The speed-test path: fast_vit_forward per mode with use_kernel=True
    (and its img/s with use_kernel=False), then predict.serve.  Returns
    K11's and K15's launches."""
    cuda = torch.device("cuda")
    args = predict.get_args_parser().parse_args(
        ["--ckpt", "synthetic.pth", "--images", "-"])
    cfg, tuning, sel = predict.configs(args)
    params = predict.load_params(args, cuda, state_dict=sd)
    g = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn((B, 224, 224, 3), generator=g, device="cuda")
    launches = {"fused_ln_mlp": 0, "mha_serving": 0}
    for mode in ("dispatch", "mask", "dense"):
        def fwd(use_kernel, mode=mode):
            return fast.fast_vit_forward(params, x, cfg=cfg, tuning=tuning,
                                         select=sel, mode=mode,
                                         use_kernel=use_kernel)
        reset_counts(ms, qt, fm)
        with torch.inference_mode():
            logits, gates = fwd(True)
            ips = scan_throughput(lambda: fwd(True), batch=B,
                                  iters=FAST_ITERS, warmup_iters=2)
        torch.cuda.synchronize()
        n_fwd = 1 + forwards_run(FAST_ITERS, warmup_iters=2)
        counts = read_counts(ms, qt, fm)
        want = {k: DEPTH * n_fwd if k in ("fused_ln_mlp", "mha_serving")
                else 0 for k in KERNELS}
        if counts != want:
            fail(f"fast {mode}: kernel launches {counts}, want {want}")
        for k in launches:
            launches[k] += counts[k]
        if logits.shape != (B, 100) or not torch.isfinite(logits).all():
            fail(f"fast {mode}: logits {tuple(logits.shape)} not "
                 "finite/shaped")
        if (gates is None) != (mode == "dense") or (
                gates is not None and gates.shape != (B, DEPTH, N)):
            fail(f"fast {mode}: gates "
                 f"{None if gates is None else tuple(gates.shape)}")
        with plain_versions(ms, qt, fm), torch.inference_mode():
            ref, ref_gates = fwd(True)
        err, mag = rel_err(logits, ref)
        agree = (1.0 if gates is None
                 else (gates == ref_gates).float().mean().item())
        with torch.inference_mode():
            ips_cublas = scan_throughput(lambda: fwd(False), batch=B,
                                         iters=FAST_ITERS, warmup_iters=2)
        keep = "" if gates is None else (
            f", mean keep ratio {gates[:, :, 1:].mean().item():.4f}")
        print(f"fast {mode}: {ips:.2f} img/s with K11, {ips_cublas:.2f} "
              f"img/s with the cuBLAS chain, at batch {B}; {DEPTH} K11 and "
              f"{DEPTH} K15 launches per forward; vs plain versions: logits "
              f"max|err| "
              f"{err:.6g} (tol {MODEL_REL * mag:.6g}), gate agreement "
              f"{agree:.6f}{keep}")
        if err > MODEL_REL * mag or agree < GATE_AGREE:
            fail(f"fast {mode} forward disagrees with the plain-version "
                 "forward")
        torch.cuda.empty_cache()

    canvases = torch.randint(0, 256, (SERVE_N, 256, 256, 3), generator=g,
                             device="cuda", dtype=torch.uint8)
    chunks = -(-SERVE_N // 128)
    for mode, quant in (("dispatch", "none"), ("auto", "none"),
                        ("dispatch", "int8")):
        a = predict.get_args_parser().parse_args(
            ["--ckpt", "synthetic.pth", "--images", "-", "--mode", mode,
             "--quant", quant, "--batch_size", str(SERVE_N)])
        p = params if quant == "none" else predict.load_params(
            a, cuda, state_dict=sd)
        reset_counts(ms, qt, fm)
        printed = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            results = predict.serve(a, canvases, p)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = read_counts(ms, qt, fm)
        served = (("dyt_prologue_serving_q8", "q8_ln_mlp") if quant != "none"
                  else ("mha_serving",))
        want = {k: DEPTH * chunks if k in served else 0 for k in KERNELS}
        run = f"predict.serve {mode} quant={quant}"
        if counts != want:
            fail(f"{run}: kernel launches {counts}, want {want}")
        ok = (len(results) == SERVE_N
              and len(printed.getvalue().splitlines()) == SERVE_N
              and all(0 <= r["label"] < 100 and 0.0 <= r["prob"] <= 1.0
                      and 0.0 <= r["keep_ratio"] <= 1.0 for r in results))
        if not ok:
            fail(f"{run}: malformed results {results[:2]}")
        # every run here dispatches (auto too: 130 >= its minimum batch)
        keep = sum(r["keep_ratio"] for r in results) / SERVE_N
        if not keep < 1.0:
            fail(f"{run}: mean keep ratio {keep}")
        print(f"{run}: {SERVE_N} canvases in {chunks} chunks, "
              f"{secs:.2f} s (first call), mean keep ratio {keep:.4f}")
        launches["mha_serving"] += counts["mha_serving"]
        del p
        torch.cuda.empty_cache()
    return launches


def phase_long(torch, ms, qt, fm, fast, predict, vit, load_timm_state_dict,
               make_vit_state_dict, np, scan_throughput,
               forwards_run) -> dict:
    """Past the N whose keys and values fit the staged attention core: the
    speed-test forward of ViT-B/16 at 480^2 (N = 901, K15 on the ring) in
    dispatch and dense, then predict.serve at 480^2; the serving model with
    6 heads of 128 at 336^2 (N = 442, its fused prologue's core on the
    ring) in bf16 and int8 dispatch.  Per run, with the counts set to 0
    just before it: 12 launches a forward of each of its kernels and none
    of the others, logits and gates against the same forward on the plain
    versions, img/s.  Returns the launches."""
    cuda = torch.device("cuda")
    g = torch.Generator(device="cuda").manual_seed(9)
    launches = {k: 0 for k in KERNELS}
    sd = make_vit_state_dict(np.random.RandomState(0), depth=DEPTH, dim=C,
                             ffn=FFN, classes=100, img=LONG_IMG, patch=16,
                             router_scale=25.0)
    args = predict.get_args_parser().parse_args(
        ["--ckpt", "synthetic.pth", "--images", "-", "--img_size",
         str(LONG_IMG), "--batch_size", str(LONG_SERVE)])
    cfg, tuning, sel = predict.configs(args)
    params = predict.load_params(args, cuda, state_dict=sd)
    x = torch.randn((LONG_B, LONG_IMG, LONG_IMG, 3), generator=g,
                    device="cuda")
    for mode in ("dispatch", "dense"):
        def fwd(mode=mode):
            return fast.fast_vit_forward(params, x, cfg=cfg, tuning=tuning,
                                         select=sel, mode=mode,
                                         use_kernel=True)
        reset_counts(ms, qt, fm)
        with torch.inference_mode():
            logits, gates = fwd()
            ips = scan_throughput(fwd, batch=LONG_B, iters=FAST_ITERS,
                                  warmup_iters=1)
        torch.cuda.synchronize()
        n_fwd = 1 + forwards_run(FAST_ITERS, warmup_iters=1)
        counts = read_counts(ms, qt, fm)
        want = {k: DEPTH * n_fwd if k in ("fused_ln_mlp", "mha_serving")
                else 0 for k in KERNELS}
        run = f"fast {mode} at {LONG_IMG}^2 (N={LONG_N})"
        if counts != want:
            fail(f"{run}: kernel launches {counts}, want {want}")
        for k in KERNELS:
            launches[k] += counts[k]
        if (logits.shape != (LONG_B, 100) or not torch.isfinite(logits).all()
                or (gates is None) != (mode == "dense")):
            fail(f"{run}: logits {tuple(logits.shape)} or gates malformed")
        with plain_versions(ms, qt, fm), torch.inference_mode():
            ref, ref_gates = fwd()
        err, mag = rel_err(logits, ref)
        agree = (1.0 if gates is None
                 else (gates == ref_gates).float().mean().item())
        print(f"{run}: {ips:.2f} img/s at batch {LONG_B}; {DEPTH} K11 and "
              f"{DEPTH} K15 launches per forward; vs plain versions: logits "
              f"max|err| {err:.6g} (tol {MODEL_REL * mag:.6g}), gate "
              f"agreement {agree:.6f}")
        if err > MODEL_REL * mag or agree < GATE_AGREE:
            fail(f"{run} disagrees with the plain-version forward")
        torch.cuda.empty_cache()

    canvas = LONG_IMG * 256 // 224
    canvases = torch.randint(0, 256, (LONG_SERVE, canvas, canvas, 3),
                             generator=g, device="cuda", dtype=torch.uint8)
    reset_counts(ms, qt, fm)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        results = predict.serve(args, canvases, params)
    torch.cuda.synchronize()
    counts = read_counts(ms, qt, fm)
    want = {k: DEPTH if k == "mha_serving" else 0 for k in KERNELS}
    run = f"predict.serve dispatch at {LONG_IMG}^2"
    if counts != want:
        fail(f"{run}: kernel launches {counts}, want {want}")
    launches["mha_serving"] += counts["mha_serving"]
    if not (len(results) == LONG_SERVE and all(
            0 <= r["label"] < 100 and 0.0 <= r["keep_ratio"] < 1.0
            for r in results)):
        fail(f"{run}: malformed results {results[:2]}")
    print(f"{run}: {LONG_SERVE} canvases of {canvas}^2, mean keep ratio "
          f"{sum(r['keep_ratio'] for r in results) / LONG_SERVE:.4f}")
    del params, sd
    torch.cuda.empty_cache()

    sd = make_vit_state_dict(np.random.RandomState(0), depth=DEPTH, dim=C,
                             ffn=FFN, classes=100, img=H128_IMG, patch=16,
                             router_scale=25.0)
    x = torch.randn((LONG_B, H128_IMG, H128_IMG, 3), generator=g,
                    device="cuda")
    for quant, kernels in (("none", ("dyt_prologue_serving",)),
                           ("int8", ("dyt_prologue_serving_q8",
                                     "q8_ln_mlp"))):
        a = predict.get_args_parser().parse_args(
            ["--ckpt", "synthetic.pth", "--images", "-", "--img_size",
             str(H128_IMG), "--num_heads", str(H128_HEADS), "--quant",
             quant])
        mcfg, mtuning, msel = predict.configs(a)
        model = vit.VisionTransformer(mcfg, tuning=mtuning, select=msel,
                                      dtype=torch.bfloat16)
        load_timm_state_dict(model, sd, log=lambda m: None)
        model = model.to(cuda)
        fwd = lambda: model(x, dispatch=True)
        reset_counts(ms, qt, fm)
        with torch.inference_mode():
            logits, aux = fwd()
            ips = scan_throughput(fwd, batch=LONG_B, iters=FAST_ITERS,
                                  warmup_iters=1)
        torch.cuda.synchronize()
        n_fwd = 1 + forwards_run(FAST_ITERS, warmup_iters=1)
        counts = read_counts(ms, qt, fm)
        want = {k: DEPTH * n_fwd if k in kernels else 0 for k in KERNELS}
        run = (f"quant={quant} dispatch, {H128_HEADS} heads of "
               f"{C // H128_HEADS} at {H128_IMG}^2 (N={H128_N})")
        if counts != want:
            fail(f"{run}: kernel launches {counts}, want {want}")
        for k in KERNELS:
            launches[k] += counts[k]
        if logits.shape != (LONG_B, 100) or not torch.isfinite(logits).all():
            fail(f"{run}: logits {tuple(logits.shape)} not finite/shaped")
        with plain_versions(ms, qt, fm), torch.inference_mode():
            ref, ref_aux = fwd()
        err, mag = rel_err(logits, ref)
        agree = (aux["token_select"] == ref_aux["token_select"]
                 ).float().mean().item()
        keep = aux["token_select"].float().mean().item()
        print(f"{run}: {ips:.2f} img/s at batch {LONG_B}; launches per "
              "forward: " + ", ".join(f"{k} {counts[k] // n_fwd}"
                                      for k in kernels)
              + f"; vs plain versions: logits max|err| {err:.6g} (tol "
              f"{MODEL_REL * mag:.6g}), gate agreement {agree:.6f}, mean "
              f"keep ratio {keep:.4f}")
        if err > MODEL_REL * mag or agree < GATE_AGREE:
            fail(f"{run} disagrees with the plain-version forward")
        del model
        torch.cuda.empty_cache()
    return launches


def count_modules(ms, qt, fm) -> dict:
    """The wrappers' modules by their KERNELS tag."""
    from dynamic_tuning_tpu_torch.ops import flash_attention as fa
    from dynamic_tuning_tpu_torch.ops import packed_attention as pa
    from dynamic_tuning_tpu_torch.utils import profile_int8 as pi
    return {"ms": ms, "qt": qt, "fm": fm, "fa": fa, "pa": pa, "pi": pi}


def reset_counts(ms, qt, fm) -> None:
    for mod in count_modules(ms, qt, fm).values():
        mod.reset_launch_counts()


def read_counts(ms, qt, fm) -> dict:
    """Each KERNELS entry's launches: a wrapper's count, or for a wrapper
    with forms (``ms.form_of``) that of the entry's form after its ":"
    ("bf16" when it names none); 0 for a "name@width" entry (its launches
    are its wrapper's in the runs that name it: ``forms_counts``)."""
    mods = count_modules(ms, qt, fm)
    out = {}
    for k, (m, _) in KERNELS.items():
        if "@" in k:
            out[k] = 0
            continue
        name, _, form = k.partition(":")
        fn = getattr(mods[m], name)
        forms = getattr(fn, "forms", None)
        out[k] = fn.launches if forms is None else forms.get(form or "bf16",
                                                             0)
    return out


def speed_run(torch, speed, args, state_dict):
    """speed.main(args, state_dict).  With a state dict every parameter is
    loaded from it (checked: none missing), so the model's truncated-normal
    init draws, ~86 M of them on the host's CPU for ViT-B, are skipped; the
    model is the same."""
    if state_dict is None:
        return speed.main(args)
    out = io.StringIO()
    with contextlib.redirect_stdout(out), mock.patch.object(
            torch.nn.init, "trunc_normal_", lambda t, *a, **k: t):
        res = speed.main(args, state_dict=state_dict)
    sys.stdout.write(out.getvalue())
    if "; 0 missing" not in out.getvalue():
        fail("speed.main: the state dict left parameters at their init")
    return res


def phase_model(torch, ms, qt, fm, speed, sds) -> dict:
    """The serving main path, through speed.main, per mode and quant."""
    launches = {name: 0 for name in KERNELS}
    for quant, mode, moe, kernels in RUNS:
        args = speed.get_args_parser().parse_args(
            ["--mode", mode, "--quant", quant, "--moe_experts", str(moe),
             "--moe_router_tau", str(TAU), "--warmup", "3", "--iters", "10"])
        reset_counts(ms, qt, fm)
        res = speed_run(torch, speed, args, sds[moe])
        counts = read_counts(ms, qt, fm)
        stem = qt.q8_patch_embed.launches
        fwd = res["forwards"]
        run = f"quant={quant} {mode}" + (f" moe{moe}" if moe else "")
        want = {k: DEPTH * fwd if k in kernels else 0 for k in KERNELS}
        if counts != want:
            fail(f"{run}: kernel launches {counts}, want {want}")
        if stem != (fwd if quant != "none" else 0):
            fail(f"{run}: {stem} int8 stem launches for {fwd} forwards")
        for k in KERNELS:
            launches[k] += counts[k]
        logits = res["logits"]
        if logits.shape != (B, 100) or not torch.isfinite(logits).all():
            fail(f"{run}: logits {tuple(logits.shape)} not finite/shaped")
        line = (f"model {run}: {res['throughput_img_s']} "
                f"img/s at batch {B}; launches per forward: "
                + ", ".join(f"{k} {counts[k] // fwd}" for k in kernels))
        if mode == "dispatch":
            keep = res["aux"]["token_select"].float().mean().item()
            line += f"; mean keep ratio {keep:.4f}"
            compare_with_plain(torch, ms, qt, fm, res, run)
        print(line)
        del res
        torch.cuda.empty_cache()
    return launches


@contextlib.contextmanager
def plain_versions(ms, qt, fm):
    """Every wrapper swapped for its plain version (calls made inside are
    not counted: the wrappers are not called)."""
    plain = {(fm, "fused_ln_mlp"): fm.ln_mlp_plain,
             (ms, "dyt_prologue_serving"): ms.dyt_prologue_plain,
             (ms, "attention_sublayer_serving"): ms.attention_sublayer_plain,
             (ms, "dyt_prologue_serving_moe"): ms.dyt_prologue_moe_plain,
             (ms, "mha_windowed_fused"): ms.mha_windowed_plain,
             (ms, "mha_serving_fused"): ms.attn_core_pairs,
             (ms, "mha_serving"): ms.mha_serving_plain,
             (qt, "dyt_prologue_serving_q8"): qt.dyt_prologue_q8_plain,
             (qt, "attention_sublayer_serving_q8"):
                 qt.attention_sublayer_q8_plain,
             (qt, "dyt_prologue_serving_q8_moe"):
                 qt.dyt_prologue_q8_moe_plain,
             (qt, "q8_ln_mlp"): qt.q8_ln_mlp_plain,
             (qt, "q8_patch_embed"): qt.q8_patch_embed_plain}
    with contextlib.ExitStack() as stack:
        for (m, name), fn in plain.items():
            stack.enter_context(mock.patch.object(m, name, fn))
        yield


@contextlib.contextmanager
def routing(D, *, record=None, replay=None):
    """Record the token scores each dispatch gets, in call order, or feed
    recorded ones back in their place."""
    real = D.dispatch_mlp
    calls = iter(replay or ())

    def dispatch_mlp(x, scores, *args, **kwargs):
        if record is not None:
            record.append(scores.clone())
        return real(x, next(calls) if replay else scores, *args, **kwargs)

    with mock.patch.object(D, "dispatch_mlp", dispatch_mlp):
        yield


@contextlib.contextmanager
def gates_replayed(layers, token_select):
    """Each eval router's hard gate, in call order, replaced by a recorded
    forward's (``token_select`` [B, L, T, 1], CLS stripped): a mask-mode
    forward given the same gate decisions."""
    calls = iter(range(token_select.shape[1]))

    def gate_with_cls(logits, threshold):
        return layers._cls_on(token_select[:, next(calls)].to(logits.dtype))

    with mock.patch.object(layers, "gate_with_cls", gate_with_cls):
        yield


def compare_with_plain(torch, ms, qt, fm, res, run) -> None:
    """The dispatch forward again on the plain versions."""
    model, x = res["model"], res["x"]
    with plain_versions(ms, qt, fm), torch.inference_mode():
        ref, ref_aux = model(x, dispatch=True)
    err, mag = rel_err(res["logits"], ref)
    eq = (res["aux"]["token_select"] == ref_aux["token_select"]).float()
    agree = eq.mean().item()
    # one image's share, beside the seg evaluations' per-crop shares
    per_input = eq.flatten(1).mean(dim=1).min().item()
    print(f"{run} logits vs plain versions: max|err| {err:.6g} (tol "
          f"{MODEL_REL * mag:.6g}), gate agreement {agree:.6f} (per input "
          f"at least {per_input:.6f})")
    if err > MODEL_REL * mag or agree < GATE_AGREE:
        fail(f"{run} forward disagrees with the plain-version forward")


def check_counts(ms, qt, fm, what, want_k9) -> None:
    counts = read_counts(ms, qt, fm)
    want = {k: want_k9 if k == "mha_windowed_fused" else 0 for k in KERNELS}
    if counts != want:
        fail(f"{what}: kernel launches {counts}, want {want}")


SEG_FIELDS = {"dispatch": "seg_crops_s", "dense": "seg_dense_crops_s",
              "q8": "seg_int8_crops_s"}


def check_seg_forward(torch, ms, qt, fm, D, model, x, kw, logits, aux,
                      what) -> str:
    """A seg crop forward against the same forward on the plain versions:
    with dispatch, its gates against the free-running plain-version
    forward's, and its logits against the plain-version forward given the
    kernel forward's dispatch decisions (per-pixel logits: a gate that
    flips near 0 rewrites its own 16x16-pixel patch's logits outright,
    beside any kernel error).  Returns the report."""
    with plain_versions(ms, qt, fm), torch.inference_mode():
        free, _, free_aux = model(x, **kw)
    line = ""
    if kw.get("dispatch"):
        scores = []
        with routing(D, record=scores), torch.inference_mode():
            model(x, **kw)
        with (routing(D, replay=scores), plain_versions(ms, qt, fm),
              torch.inference_mode()):
            ref, _, _ = model(x, **kw)
        agree = (aux["token_select"] == free_aux["token_select"]
                 ).float().mean().item()
        keep = aux["token_select"].float().mean().item()
        ferr, fmag = rel_err(logits, free)
        past = ((logits - free).abs() > MODEL_REL * fmag).float().mean()
        line += (f"; gate agreement with the plain-version forward "
                 f"{agree:.6f} (its logits: max|err| {ferr:.6g} of "
                 f"{fmag:.6g}, a share {past.item():.6f} past "
                 f"{MODEL_REL:g} of it), mean keep ratio {keep:.4f}")
    else:
        ref, agree = free, 1.0
    err, mag = rel_err(logits, ref)
    line += (f"; logits vs plain versions"
             f"{' on the same dispatch' if kw.get('dispatch') else ''}: "
             f"max|err| {err:.6g} (tol {MODEL_REL * mag:.6g})")
    if err > MODEL_REL * mag or agree < GATE_AGREE:
        fail(f"{what} forward disagrees with the plain-version forward")
    return line


def phase_seg(torch, ms, qt, fm, D, bench, sd):
    """Segmentation serving through bench.seg_family: dispatch, dense and
    int8 dispatch.  Returns K9's and K4's launches and the dispatch and
    int8 models."""
    reset_counts(ms, qt, fm)
    fields, runs = bench.seg_family("cuda", state_dict=sd)
    fwd = sum(r["forwards"] for r in runs.values())
    q8 = runs["q8"]["forwards"]
    want = dict.fromkeys(KERNELS, 0)
    want.update(mha_windowed_fused=DEPTH * fwd, q8_ln_mlp=DEPTH * q8)
    counts = read_counts(ms, qt, fm)
    if counts != want or qt.q8_patch_embed.launches != q8:
        fail(f"seg family: kernel launches {counts} (int8 stem "
             f"{qt.q8_patch_embed.launches}), want {want} (stem {q8})")
    for mode, r in runs.items():
        logits = r["logits"]
        if (logits.shape != (1, 512, 512, SEG_CLASSES)
                or not torch.isfinite(logits).all()):
            fail(f"seg {mode}: logits {tuple(logits.shape)} not "
                 "finite/shaped")
        print(f"seg {mode}: {fields[SEG_FIELDS[mode]]} crops/s over "
              f"{r['forwards']} forwards"
              + check_seg_forward(torch, ms, qt, fm, D, r["model"], r["x"],
                                  bench.seg_kwargs(mode), logits, r["aux"],
                                  f"seg {mode}"))
    print("seg family: " + json.dumps(fields))
    models = runs["dispatch"]["model"], runs["q8"]["model"]
    del runs
    torch.cuda.empty_cache()
    return DEPTH * fwd, DEPTH * q8, models


def phase_slide(torch, ms, qt, fm, bench, seg_train, upernet, model,
                sd) -> int:
    """Slide inference over one ADE20K-shaped image, then the evaluation
    entry point on 2 synthetic images."""
    g = torch.Generator(device="cuda").manual_seed(2)
    img = torch.randn((512, 683, 3), generator=g, device="cuda")
    kw = bench.seg_kwargs("dispatch")
    apply = lambda tiles: model(tiles, **kw)[0]
    reset_counts(ms, qt, fm)
    with torch.inference_mode():
        out = upernet.slide_inference(apply, img, num_classes=SEG_CLASSES,
                                      crop=512, stride=341)
        torch.cuda.synchronize()
        check_counts(ms, qt, fm, "slide inference", 2 * DEPTH)
        # columns [0, 171) lie in the first window only
        first = apply(img[None, :, :512])[0]
    if out.shape != (512, 683, SEG_CLASSES) or not torch.isfinite(out).all():
        fail(f"slide inference: {tuple(out.shape)} not finite/shaped")
    err, mag = rel_err(out[:, :171], first[:, :171])
    print(f"slide inference 512x683: 2 windows, {2 * DEPTH} K9 launches; "
          f"first-window strip vs its own forward: max|err| {err:.6g} "
          f"(of {mag:.6g})")
    if err > 1e-3 * mag:
        fail("slide inference does not reproduce its window's logits")

    args = seg_train.get_args_parser().parse_args(
        ["--eval", "--dataset", "synthetic", "--crop_size", "512",
         "--residual_dtype", "bfloat16", "--gelu_approx"])
    runner = seg_train.build_runner(args, log=lambda m: print("  " + m))
    runner.model.load_state_dict({k: torch.from_numpy(v)
                                  for k, v in sd.items()}, strict=True)
    reset_counts(ms, qt, fm)
    stats = runner.evaluate(max_images=2)
    torch.cuda.synchronize()
    check_counts(ms, qt, fm, "SegRunner.evaluate", 2 * DEPTH)
    if not (0.0 <= stats["aAcc"] <= 100.0 and stats["miou"] == stats["miou"]
            and stats["images"] == 2):
        fail(f"SegRunner.evaluate: {stats}")
    return 4 * DEPTH


def phase_train(torch, ms, qt, fm, np, bench, layers, vit, sd) -> None:
    """The training path: the bench's train setup on ViT-B/16 at full width
    and depth (phase 3's weights), 8 steps with no hand kernel, then the
    trained model served on its kernels; and a 2-block fp32 model trained
    on the card and on the CPU from the same weights and noise."""
    model, state, step, x, y = bench.build_train("cuda", state_dict=sd)
    with torch.inference_mode():                # fills the serving caches
        before, _ = model(x, dispatch=True)
    params = dict(model.named_parameters())
    trainable = set(state.optimizer.names)
    start = {n: p.detach().clone() for n, p in params.items()}
    reset_counts(ms, qt, fm)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    parts = [step(state, x, y) for _ in range(bench.TRAIN_STEPS)]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / bench.TRAIN_STEPS
    counts = read_counts(ms, qt, fm)
    if any(counts.values()) or qt.q8_patch_embed.launches:
        fail(f"training launched hand kernels: {counts}")
    for i, p in enumerate(parts):
        bad = [k for k, v in p.items() if not torch.isfinite(v).all()]
        if bad or not p["grad_norm"].item() > 0:
            fail(f"train step {i}: parts {bad} not finite, or grad_norm "
                 f"{p['grad_norm'].item()} not above 0")
    for n, p in params.items():
        if (n in trainable) == torch.equal(p.detach(), start[n]):
            fail(f"train: {n} " + ("did not move" if n in trainable
                                   else "is frozen and moved"))
    last = {k: round(v.item(), 6) for k, v in parts[-1].items()}
    print(f"train ViT-B/16 batch {bench.TRAIN_BATCH}: {bench.TRAIN_STEPS} "
          f"steps, {step_ms:.2f} ms a step on the host's clock, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, no hand "
          f"kernel launched; {len(trainable)} trainable tensors all moved, "
          f"the frozen ones bit-unchanged; last step {last}")

    # the trained model serves on the kernels, with refreshed weight copies
    reset_counts(ms, qt, fm)
    with torch.inference_mode():
        logits, aux = model(x, dispatch=True)
    torch.cuda.synchronize()
    counts = read_counts(ms, qt, fm)
    want = {k: DEPTH if k == "dyt_prologue_serving" else 0 for k in KERNELS}
    if counts != want:
        fail(f"serving after training: launches {counts}, want {want}")
    fresh = vit.VisionTransformer(model.cfg, tuning=model.tuning,
                                  select=model.select_cfg,
                                  dtype=torch.bfloat16)
    fresh.load_state_dict(model.state_dict())
    fresh.to("cuda")
    with torch.inference_mode():
        again, _ = fresh(x, dispatch=True)
    if torch.equal(logits, before) or not torch.equal(logits, again):
        fail("serving after training does not give what a fresh copy of the "
             "trained weights gives")
    compare_with_plain(torch, ms, qt, fm, dict(model=model, x=x,
                                               logits=logits, aux=aux),
                       "serving after training")
    print("serving after training: 12 K3 launches, logits equal to a fresh "
          "copy's (the weight copies refreshed)")
    del model, state, step, fresh, start, params
    torch.cuda.empty_cache()
    train_card_vs_cpu(torch, np, layers, vit)


def train_card_vs_cpu(torch, np, layers, vit) -> None:
    """A 2-block fp32 ViT of width 768 (dropout 0, TF32 off) takes 3 steps on
    the card and on the CPU from the same weights and gumbel noise."""
    from dynamic_tuning_tpu_torch.checkpoint import make_vit_state_dict
    from dynamic_tuning_tpu_torch.config import (ModelConfig, SelectConfig,
                                                 TuningConfig)
    from dynamic_tuning_tpu_torch.train import engine, optim
    depth, batch, steps = 2, 8, 3
    sd = make_vit_state_dict(np.random.RandomState(1), depth=depth, dim=C,
                             ffn=FFN, classes=100, img=224, patch=16)
    rs = np.random.RandomState(2)
    x = torch.from_numpy(rs.randn(batch, 224, 224, 3).astype(np.float32))
    y = torch.from_numpy(rs.randint(0, 100, batch))
    noise = torch.from_numpy(rs.logistic(
        size=(batch, depth, N - 1, 1)).astype(np.float32))
    sel = SelectConfig(token_target_ratio=0.5)
    runs = {}
    for dev in ("cuda", "cpu"):
        model = vit.VisionTransformer(
            ModelConfig(num_classes=100, depth=depth),
            tuning=TuningConfig(dropout=0.0), select=sel,
            dtype=torch.float32)
        model.load_state_dict({k: torch.from_numpy(v) for k, v in
                               sd.items()}, strict=True)
        model.to(dev)
        opt = optim.make_optimizer(optim.freeze(model), 1e-3,
                                   warmup_epochs=0, steps_per_epoch=100)
        state = engine.TrainState(opt, seed=3)
        step = engine.make_train_step(model, sel)
        parts = [step(state, x.to(dev), y.to(dev), gate_noise=noise.to(dev))
                 for _ in range(steps)]
        with torch.no_grad():
            _, aux = model(x.to(dev), training=True, gate_noise=noise.to(dev))
        runs[dev] = ([{k: v.item() for k, v in p.items()} for p in parts],
                     aux["token_select"].cpu())
    (card, card_gates), (cpu, cpu_gates) = runs["cuda"], runs["cpu"]
    # one gate flipped moves the keep ratio by 1 / (batch * depth * 196);
    # identical gates summed in another order, by an fp32 rounding.  Each
    # loss part within rtol 1e-4, plus 1e-6 for the parts near 0 (the KL
    # of two near-equal distributions: fp32 log-probabilities of logits of
    # a few units carry ~1e-7 each)
    worst = 0.0
    for i, (a, b) in enumerate(zip(card, cpu)):
        if abs(a["keep_ratio"] - b["keep_ratio"]) > 1e-6:
            fail(f"train step {i}: keep ratio {a['keep_ratio']} on the card, "
                 f"{b['keep_ratio']} on the CPU")
        for k in a:
            if abs(a[k] - b[k]) > 1e-4 * abs(b[k]) + 1e-6:
                fail(f"train step {i} {k}: card {a[k]}, CPU {b[k]}")
            worst = max(worst, abs(a[k] - b[k]) / max(abs(b[k]), 1e-30))
    if not torch.equal(card_gates, cpu_gates):
        fail("the trained 2-block models gate differently on the card and "
             "the CPU")
    print(f"train 2-block fp32 card vs CPU: {steps} steps, loss parts within "
          f"rtol {worst:.3g} (needs 1e-4, + 1e-6 near 0), keep ratios and "
          "final gates identical")


def trace_summary(prof, what: str):
    """((busy ms, window ms, kernels), the 8 kernels of most device time as
    (name, us)) of a stopped CUDA profile."""
    from torch.autograd import DeviceType

    from dynamic_tuning_tpu_torch.utils.profile_forward import _busy_us
    ks = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not ks:
        fail(f"{what} hold no device activity")
    window = (max(e.time_range.end for e in ks)
              - min(e.time_range.start for e in ks))
    busy = _busy_us((e.time_range.start, e.time_range.end) for e in ks)
    per_name = {}
    for e in ks:
        per_name[e.name] = (per_name.get(e.name, 0.0)
                            + e.time_range.elapsed_us())
    return ((busy / 1e3, window / 1e3, len(ks)),
            sorted(per_name.items(), key=lambda kv: -kv[1])[:8])


class RunnerProbe:
    """Phase 11's instruments on the port's Runner: every evaluate() is timed
    and checked -- no hand kernel since the last eval (training launches
    none), K3 12 times a forward and nothing else during it, each forward's
    logits and gates held against the same forward on the plain versions
    -- and every train epoch is timed (one of them traced)."""

    def __init__(self, torch, ms, qt, fm, R, cls=None):
        self.torch, self.ms, self.qt, self.fm, self.R = torch, ms, qt, fm, R
        self.cls = cls or R.Runner
        self.expect = dict.fromkeys(KERNELS, 0)
        self.evals, self.epochs = [], []
        self.trace_next_epoch = False
        self.trace_steps = None          # None: trace the whole epoch
        self.idle = self.top = None

    def reset(self) -> None:
        reset_counts(self.ms, self.qt, self.fm)
        self.expect = dict.fromkeys(KERNELS, 0)

    def _check_counts(self, what) -> None:
        counts = read_counts(self.ms, self.qt, self.fm)
        if counts != self.expect or self.qt.q8_patch_embed.launches:
            fail(f"runner {what}: kernel launches {counts}, want "
                 f"{self.expect}")

    @contextlib.contextmanager
    def installed(self):
        real_eval, real_epoch = self.cls.evaluate, self.cls.train_one_epoch
        probe = self

        def evaluate(runner):
            return probe.evaluate(runner, real_eval)

        def train_one_epoch(runner, epoch):
            return probe.train_one_epoch(runner, epoch, real_epoch)

        # the runner's log goes to its file only: rank 1 has no console
        quiet = self.R.create_logger
        with mock.patch.object(self.cls, "evaluate", evaluate), \
                mock.patch.object(self.cls, "train_one_epoch",
                                  train_one_epoch), \
                mock.patch.object(self.R, "create_logger",
                                  lambda out, rank=0: quiet(out, 1)):
            yield self

    def train_one_epoch(self, runner, epoch, real):
        torch = self.torch
        self._check_counts(f"before epoch {epoch}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if self.trace_next_epoch:
            from torch.profiler import ProfilerActivity, profile
            self.trace_next_epoch = False
            prof = profile(activities=[ProfilerActivity.CUDA])
            # the whole epoch, or its last trace_steps steps (the profiler
            # started as the first of them begins)
            step, calls = runner.train_step, [0]
            if self.trace_steps:
                first = runner.steps_per_epoch - self.trace_steps

                def train_step(*args, **kwargs):
                    if calls[0] == first:
                        torch.cuda.synchronize()
                        prof.start()
                    calls[0] += 1
                    return step(*args, **kwargs)

                runner.train_step = train_step
            else:
                prof.start()
            try:
                stats = real(runner, epoch)
                torch.cuda.synchronize()
            finally:
                runner.train_step = step
                prof.stop()
            self.idle, self.top = trace_summary(prof, "the traced steps")
        else:
            stats = real(runner, epoch)
        torch.cuda.synchronize()
        self.epochs.append(dict(epoch=epoch, s=time.perf_counter() - t0,
                                steps=runner.steps_per_epoch,
                                batch=runner.cfg.data.batch_size,
                                stats=stats))
        self._check_counts(f"epoch {epoch}")
        bad = [k for k, v in stats.items() if v != v or abs(v) == float("inf")]
        if bad:
            fail(f"runner epoch {epoch}: {bad} not finite")
        return stats

    def evaluate(self, runner, real):
        torch = self.torch
        self._check_counts("before eval")
        forwards = []
        step = runner.eval_step

        def recording(x):
            logits, ts = step(x)
            forwards.append((x, logits, ts))
            return logits, ts

        runner.eval_step = recording
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            stats = real(runner)
        finally:
            runner.eval_step = step
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        self.expect["dyt_prologue_serving"] += DEPTH * len(forwards)
        self._check_counts(f"eval ({len(forwards)} forwards)")
        dispatch = runner.cfg.eval_dispatch
        worst, agree = 0.0, 1.0
        with plain_versions(self.ms, self.qt, self.fm), \
                torch.inference_mode():
            for x, logits, ts in forwards:
                ref, ref_aux = runner.model(x, dispatch=dispatch)
                err, mag = rel_err(logits, ref)
                worst = max(worst, err / mag)
                agree = min(agree, (ts == ref_aux["token_select"]
                                    ).float().mean().item())
                if not torch.isfinite(logits).all():
                    fail("runner eval: logits not finite")
        if worst > MODEL_REL or agree < GATE_AGREE:
            fail(f"runner eval ({'dispatch' if dispatch else 'mask'}) vs "
                 f"plain versions: max rel err {worst}, gate agreement "
                 f"{agree}")
        images = sum(len(x) for x, _, _ in forwards)
        self.evals.append(dict(runner=runner, stats=stats, s=secs,
                               images=images, forwards=forwards,
                               worst=worst, agree=agree))
        gflops = stats.get("gflops", stats.get("gflops_per_clip"))
        print(f"runner eval ({'dispatch' if dispatch else 'mask'}, "
              f"{images} inputs, {len(forwards)} forwards, 12 K3 launches "
              f"each and nothing else): acc1 {stats['acc1']}, keep ratio "
              f"{stats['keep_ratio']:.6f}, gflops {gflops:.4f}; "
              f"{images / secs:.1f} inputs/s; vs plain versions max rel err "
              f"{worst:.3g}, gate agreement {agree:.6f}")
        return stats


def phase_runner(torch, ms, qt, fm, np, vit, sd) -> int:
    """Phase 11: the image runner on the card, through main_image and
    main_vtab; returns K3's launches."""
    import shutil

    from dynamic_tuning_tpu_torch import main_image, main_vtab
    from dynamic_tuning_tpu_torch.checkpoint import (load_timm_state_dict,
                                                     make_vit_state_dict)
    from dynamic_tuning_tpu_torch.train import runner as R
    from dynamic_tuning_tpu_torch.train.checkpoint import load_params
    root = os.path.join(REPO, "build", "phase_runner")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    ft64 = os.path.join(root, "ft64.pth")
    ft16 = os.path.join(root, "ft16.pth")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, ft64)
    torch.save({k: torch.from_numpy(v) for k, v in make_vit_state_dict(
        np.random.RandomState(0), depth=DEPTH, dim=C, ffn=16, classes=100,
        img=224, patch=16, router_scale=25.0).items()}, ft16)
    a, c, v = (os.path.join(root, d) for d in "acv")
    flags = ["--dataset", "synthetic", "--batch_size", "128", "--epochs", "2",
             "--warmup_epochs", "1", "--no_auto_remove", "--finetune", ft64]
    parse = main_image.get_args_parser().parse_args
    probe = RunnerProbe(torch, ms, qt, fm, R)
    k3 = 0
    with probe.installed():
        # A: two epochs, an eval after each
        probe.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        main_image.main(parse(flags + ["--output_dir", a]))
        peak = torch.cuda.max_memory_allocated()
        k3 += probe.expect["dyt_prologue_serving"]
        ev_a, ep_a = list(probe.evals), list(probe.epochs)
        if [e["epoch"] for e in ep_a] != [0, 1] or len(ev_a) != 2:
            fail(f"run A: epochs {[e['epoch'] for e in ep_a]}, "
                 f"{len(ev_a)} evals")
        runner_a = ev_a[-1]["runner"]
        imgs, labels = next(iter(runner_a.train_loader))
        aug_ms = time_ms(lambda: runner_a._device_batch(imgs, labels, True),
                         iters=10)
        # C: resumed from A's epoch-0 checkpoint with the same flags; its
        # one epoch traced for the idle share
        probe.reset()
        probe.trace_next_epoch = True
        main_image.main(parse(flags + [
            "--output_dir", c, "--resume",
            os.path.join(a, "checkpoint-0.msgpack")]))
        k3 += probe.expect["dyt_prologue_serving"]
        ev_c = probe.evals[len(ev_a):]
        runner_c = ev_c[-1]["runner"]
        if [e["epoch"] for e in probe.epochs[len(ep_a):]] != [1]:
            fail("the resumed run did not run epoch 1 alone")
        if runner_c.max_metric != ev_a[0]["stats"]["metric"]:
            fail(f"resumed max_metric {runner_c.max_metric}, A's epoch-0 "
                 f"metric {ev_a[0]['stats']['metric']}")
        fa = load_params(os.path.join(a, "final_checkpoint.msgpack"))
        fc = load_params(os.path.join(c, "final_checkpoint.msgpack"))
        differ = [k for k in fa if not torch.equal(fa[k], fc[k])]
        oa, oc = (r.state.optimizer for r in (runner_a, runner_c))
        if (runner_a.state.step, oa.count) != (runner_c.state.step, oc.count):
            fail(f"resumed step/count {runner_c.state.step}/{oc.count}, "
                 f"uninterrupted {runner_a.state.step}/{oa.count}")
        if fa.keys() != fc.keys() or differ:
            fail(f"the resumed final_checkpoint.msgpack differs from the "
                 f"uninterrupted one in {len(differ)} tensors: {differ[:6]}")
        sa, sc = oa.state_dict()["rule"], oc.state_dict()["rule"]
        for part in ("mu", "nu"):
            for k in sa[part]:
                if not torch.equal(sa[part][k], sc[part][k]):
                    fail(f"resumed optimizer {part} of {k} differs")
        print(f"runner resume: final_checkpoint.msgpack of the resumed run "
              f"equals "
              f"the uninterrupted one bit for bit ({len(fa)} tensors), "
              f"optimizer moments too; step {runner_c.state.step}, count "
              f"{oc.count}; restored max_metric {runner_c.max_metric}")
        # A's epoch-1 eval equals a fresh model loaded from its final weights
        fresh = vit.VisionTransformer(runner_a.model_cfg,
                                      tuning=runner_a.cfg.tuning,
                                      select=runner_a.cfg.select,
                                      dtype=torch.bfloat16)
        load_timm_state_dict(fresh, fa, log=lambda *_: None)
        fresh.to(runner_a.device)
        with torch.inference_mode():
            for x, logits, ts in ev_a[-1]["forwards"]:
                again, aux = fresh(x)
                if not (torch.equal(again, logits)
                        and torch.equal(aux["token_select"], ts)):
                    fail("A's last eval differs from a fresh model loaded "
                         "from its final_checkpoint.msgpack")
        del fresh
        # the VTAB recipe with the dispatch eval
        probe.reset()
        vargs = main_vtab.get_args_parser().parse_args(
            ["--task", "synthetic", "--epochs", "1", "--eval_dispatch",
             "--finetune", ft16, "--output_dir", v])
        main_vtab.main(vargs)
        k3 += probe.expect["dyt_prologue_serving"]
        ev_v = probe.evals[-1]
        if ev_v["runner"].cfg.data.batch_size != 64 or len(
                ev_v["forwards"]) != 4:
            fail("main_vtab did not run its recipe (batch 64, 4 eval "
                 "forwards)")
        # --eval --eval_ckpt on A's newest checkpoint
        newest = max((f for f in os.listdir(a) if f.startswith("checkpoint-")),
                     key=lambda f: int(f[len("checkpoint-"):-len(".msgpack")]))
        saved_by = ev_a[int(newest[len("checkpoint-"):-len(".msgpack")])]
        probe.reset()
        stats = main_image.main(parse(flags + [
            "--output_dir", os.path.join(root, "e"), "--eval",
            "--eval_ckpt", os.path.join(a, newest)]))
        k3 += probe.expect["dyt_prologue_serving"]
        if stats["acc1"] != saved_by["stats"]["acc1"]:
            fail(f"--eval_ckpt {newest}: acc1 {stats['acc1']}, the eval "
                 f"that saved it {saved_by['stats']['acc1']}")
    last = ep_a[-1]
    train_ips = last["steps"] * last["batch"] / last["s"]
    busy_ms, window_ms, kernels = probe.idle
    c_epoch = probe.epochs[len(ep_a)]
    print(f"runner train: epoch 1 of run A {last['s']:.3f} s for "
          f"{last['steps']} steps of {last['batch']}: {train_ips:.1f} img/s "
          f"(loader, copy, augmentation and step, host clock); epoch 1 of "
          f"run C traced ({c_epoch['s']:.3f} s under the profiler): "
          f"kernel-busy {busy_ms:.1f} ms in {kernels} kernels, idle share "
          f"{1 - busy_ms / window_ms:.4f} of its {window_ms:.1f} ms device "
          f"window, {1 - busy_ms / 1e3 / last['s']:.4f} of run A's untraced "
          f"epoch 1; peak memory {peak / 2**30:.2f} GiB")
    print("runner traced epoch, device ms a step by kernel: " + "; ".join(
        f"{name[:90]} {us / 1e3 / c_epoch['steps']:.2f}"
        for name, us in probe.top))
    print(f"runner train batch on the card (copy + crop + flip + normalize), "
          f"CUDA events: {aug_ms:.3f} ms a batch of 128")
    print(f"runner eval: {ev_a[-1]['images'] / ev_a[-1]['s']:.1f} img/s "
          f"(mask, batch 128, with the loader); vtab dispatch "
          f"{ev_v['images'] / ev_v['s']:.1f} img/s (batch 64), keep ratio "
          f"{ev_v['stats']['keep_ratio']:.6f}; --eval_ckpt {newest} acc1 "
          f"{stats['acc1']} as the eval that saved it; K3 launches {k3}")
    shutil.rmtree(root, ignore_errors=True)
    return k3


def phase_video(torch, ms, qt, fm, np, sd) -> int:
    """Phase 12: the video runner on the card, through main_video, then a
    tubelet-2 dispatch forward; returns K3's launches."""
    import shutil

    from dynamic_tuning_tpu_torch import main_video
    from dynamic_tuning_tpu_torch.train import runner as R
    from dynamic_tuning_tpu_torch.train.checkpoint import load_params
    from dynamic_tuning_tpu_torch.train import video_runner as VR
    root = os.path.join(REPO, "build", "phase_video")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    ft = os.path.join(root, "ft.pth")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, ft)
    a, c = (os.path.join(root, d) for d in "ac")
    flags = ["--dataset", "synthetic", "--batch_size", "16", "--epochs", "2",
             "--warmup_epochs", "1", "--no_auto_remove", "--finetune", ft]
    parse = main_video.get_args_parser().parse_args
    probe = RunnerProbe(torch, ms, qt, fm, R, VR.VideoRunner)
    k3 = 0
    with probe.installed():
        # A: two epochs, a 3-view eval after each
        probe.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        main_video.main(parse(flags + ["--output_dir", a]))
        peak = torch.cuda.max_memory_allocated()
        k3 += probe.expect["dyt_prologue_serving"]
        ev_a, ep_a = list(probe.evals), list(probe.epochs)
        if [e["epoch"] for e in ep_a] != [0, 1] or len(ev_a) != 2:
            fail(f"video run A: epochs {[e['epoch'] for e in ep_a]}, "
                 f"{len(ev_a)} evals")
        runner_a = ev_a[-1]["runner"]
        x0 = ev_a[-1]["forwards"][0][0]
        if (runner_a.steps_per_epoch != 16 or len(ev_a[-1]["forwards"]) != 8
                or tuple(x0.shape) != (24, 8, 224, 224, 3)):
            fail(f"video run A: {runner_a.steps_per_epoch} steps, "
                 f"{len(ev_a[-1]['forwards'])} eval forwards of "
                 f"{tuple(x0.shape)}")
        # C: resumed from A's epoch-0 checkpoint, its epoch traced
        probe.reset()
        probe.trace_next_epoch = True
        probe.trace_steps = TRACE_STEPS
        main_video.main(parse(flags + [
            "--output_dir", c, "--resume",
            os.path.join(a, "checkpoint-0.msgpack")]))
        k3 += probe.expect["dyt_prologue_serving"]
        runner_c = probe.evals[-1]["runner"]
        if [e["epoch"] for e in probe.epochs[len(ep_a):]] != [1]:
            fail("the resumed video run did not run epoch 1 alone")
        fa = load_params(os.path.join(a, "final_checkpoint.msgpack"))
        fc = load_params(os.path.join(c, "final_checkpoint.msgpack"))
        differ = [k for k in fa if not torch.equal(fa[k], fc[k])]
        oa, oc = (r.state.optimizer for r in (runner_a, runner_c))
        if (runner_a.state.step, oa.count) != (runner_c.state.step, oc.count):
            fail(f"resumed video step/count {runner_c.state.step}/{oc.count}"
                 f", uninterrupted {runner_a.state.step}/{oa.count}")
        if fa.keys() != fc.keys() or differ:
            fail(f"the resumed video final_checkpoint.msgpack differs in "
                 f"{len(differ)} tensors: {differ[:6]}")
        sa, sc = oa.state_dict()["rule"], oc.state_dict()["rule"]
        for part in ("mu", "nu"):
            for k in sa[part]:
                if not torch.equal(sa[part][k], sc[part][k]):
                    fail(f"resumed video optimizer {part} of {k} differs")
        print(f"video resume: final_checkpoint.msgpack of the resumed run "
              f"equals "
              f"the uninterrupted one bit for bit ({len(fa)} tensors), "
              f"optimizer moments too; step {runner_c.state.step}, count "
              f"{oc.count}")
        # --eval --eval_ckpt on A's newest checkpoint
        newest = max((f for f in os.listdir(a) if f.startswith("checkpoint-")),
                     key=lambda f: int(f[len("checkpoint-"):-len(".msgpack")]))
        saved_by = ev_a[int(newest[len("checkpoint-"):-len(".msgpack")])]
        probe.reset()
        stats = main_video.main(parse(flags + [
            "--output_dir", os.path.join(root, "e"), "--eval",
            "--eval_ckpt", os.path.join(a, newest)]))
        k3 += probe.expect["dyt_prologue_serving"]
        if stats["acc1"] != saved_by["stats"]["acc1"]:
            fail(f"video --eval_ckpt {newest}: acc1 {stats['acc1']}, the "
                 f"eval that saved it {saved_by['stats']['acc1']}")
    # the SSv2 train batch (RandAugment, random resized crop, no flip) on
    # the card against the CPU from the same draws: RandAugment's uint8
    # store may truncate a sum on the other side of an integer
    from dynamic_tuning_tpu_torch.data import video_transforms as vt
    clips = torch.randint(0, 256, (16, 8, 256, 256, 3), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(2))
    ssv2 = dict(crop=224, flip=False, randaug="rand-m7-n4-mstd0.5-inc1")
    cpu = vt.augment_clip_batch(torch.Generator().manual_seed(3),
                                clips[:4], **ssv2)
    card = vt.augment_clip_batch(torch.Generator().manual_seed(3),
                                 clips[:4].cuda(), **ssv2)
    aug_err = (card.cpu() - cpu).abs().max().item()
    aug_ms = time_ms(lambda: vt.augment_clip_batch(
        torch.Generator().manual_seed(3), clips.cuda(), **ssv2), iters=3)
    # one count of 255 after normalization (std 0.225): 0.0175
    print(f"video SSv2 train batch (RandAugment + random resized crop): 4 "
          f"clips, card vs CPU max|err| {aug_err:.6g} (tol 0.0175); "
          f"{aug_ms:.3f} ms a batch of 16 with the copy")
    if not aug_err <= 0.0175:
        fail("the SSv2 train batch on the card disagrees with the CPU's")
    # the tubelet-2 stem: 16 clips of 4 frame groups, dispatch; the image
    # stem inflated over the tubelet (its kernel halved on each of the 2
    # frames), so the routers see the image model's tokens -- the gate;
    # then the stem at random init -- a diagnostic beside it
    k3 += tubelet_forward(torch, ms, qt, fm, np, sd, inflated=True)
    k3 += tubelet_forward(torch, ms, qt, fm, np, sd, inflated=False)
    last = ep_a[-1]
    clips_s = last["steps"] * last["batch"] / last["s"]
    busy_ms, window_ms, kernels = probe.idle
    c_epoch = probe.epochs[len(ep_a)]
    ev = ev_a[-1]
    eval_clips = len(ev["runner"].val_loader.ds)
    print(f"video train: epoch 1 of run A {last['s']:.3f} s for "
          f"{last['steps']} steps of {last['batch']} clips x 8 frames: "
          f"{clips_s:.1f} clips/s (loader, copy, augmentation and step, "
          f"host clock); the last {TRACE_STEPS} steps of run C's epoch 1 "
          f"traced ({c_epoch['s']:.3f} s for the epoch under the profiler):"
          f" kernel-busy {busy_ms:.1f} ms in {kernels} kernels, idle share "
          f"{1 - busy_ms / window_ms:.4f} of their {window_ms:.1f} ms device "
          f"window; peak memory {peak / 2**30:.2f} GiB")
    print("video traced steps, device ms a step by kernel: " + "; ".join(
        f"{name[:90]} {us / 1e3 / TRACE_STEPS:.2f}"
        for name, us in probe.top))
    print(f"video eval: {eval_clips / ev['s']:.1f} clips/s ({eval_clips} "
          f"clips x 3 views, mask, 8 clips a forward, with the loader); "
          f"--eval_ckpt {newest} acc1 {stats['acc1']} as the eval that "
          f"saved it; K3 launches {k3}")
    shutil.rmtree(root, ignore_errors=True)
    return k3




class SegProbe:
    """Watches the seg runners that seg_train.main builds: each evaluation
    forward recorded and held against the plain versions, the launch
    counts checked at every evaluation's edges (training launches no hand
    kernel; an evaluation forward K9 12 times, and with int8 K4 12 times
    and the stem once), the host time at each evaluation's edges, and,
    when asked, the steps before a run's last evaluation traced for the
    idle share.  An evaluation forward's logits are held against the plain
    versions given its gates (``gates_replayed``); the evaluation's gates,
    all of its forwards' together, against the free-running plain-version
    forwards' (``GATE_AGREE``)."""

    def __init__(self, torch, ms, qt, fm, SR):
        from dynamic_tuning_tpu_torch.models import layers
        self.torch, self.ms, self.qt, self.fm, self.SR = torch, ms, qt, fm, SR
        self.layers = layers
        self.trace_steps, self.time_from, self.t_steps = 0, -1, None
        self.evals, self.k9, self.k4 = [], 0, 0
        self.prof = self.idle = None

    @contextlib.contextmanager
    def installed(self):
        probe, cls = self, self.SR.SegRunner
        real_eval, real_step = cls.evaluate, cls.train_step

        def evaluate(runner, max_images=None):
            return probe.evaluate(runner, real_eval, max_images)

        def train_step(runner, *args, **kwargs):
            if runner.state.step == probe.time_from:
                probe.torch.cuda.synchronize()
                probe.t_steps = time.perf_counter()
            if (probe.trace_steps and probe.prof is None and
                    runner.total_iters - runner.state.step
                    == probe.trace_steps):
                from torch.profiler import ProfilerActivity, profile
                probe.torch.cuda.synchronize()
                probe.prof = profile(activities=[ProfilerActivity.CUDA])
                probe.prof.start()
            return real_step(runner, *args, **kwargs)

        quiet = self.SR.create_logger
        with mock.patch.object(cls, "evaluate", evaluate), \
                mock.patch.object(cls, "train_step", train_step), \
                mock.patch.object(self.SR, "create_logger",
                                  lambda out, rank=0: quiet(out, 1)):
            yield self

    def _stop_trace(self):
        self.torch.cuda.synchronize()
        self.prof.stop()
        self.idle, self.top = trace_summary(self.prof, "the traced seg steps")
        self.prof, self.trace_steps = None, 0

    def evaluate(self, runner, real, max_images):
        torch, ms, qt, fm = self.torch, self.ms, self.qt, self.fm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if self.prof is not None:
            self._stop_trace()
        counts = read_counts(ms, qt, fm)
        if any(counts.values()) or qt.q8_patch_embed.launches:
            fail(f"seg training launched hand kernels: {counts}")
        forwards, apply = [], runner._apply

        def recording(tiles):
            logits, _, aux = runner.model(tiles, aux_logits=False)
            forwards.append((tiles, logits, aux))
            return logits

        runner._apply = recording
        try:
            stats = real(runner, max_images)
        finally:
            del runner._apply
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n = len(forwards)
        q8 = runner.cfg.model.quant != "none"
        want = dict.fromkeys(KERNELS, 0)
        want.update(mha_windowed_fused=DEPTH * n,
                    q8_ln_mlp=DEPTH * n if q8 else 0)
        counts = read_counts(ms, qt, fm)
        if counts != want or qt.q8_patch_embed.launches != (n if q8 else 0):
            fail(f"seg eval ({n} forwards): launches {counts} (stem "
                 f"{qt.q8_patch_embed.launches}), want {want}")
        self.k9 += DEPTH * n
        self.k4 += want["q8_ln_mlp"]
        reset_counts(ms, qt, fm)
        # per-pixel logits: a gate that flips near the threshold rewrites
        # its own patch's logits, so the logits are held against the plain
        # versions given the same gates; the gates against the free-running
        # plain-version forward's, over all of the evaluation's gates (a
        # forward holds one crop, 12288 gates; the image runner's forwards
        # hold 128 images, ~300k)
        worst, same, gates, crop_min, flips = 0.0, 0, 0, 1.0, []
        with plain_versions(ms, qt, fm), torch.inference_mode():
            for tiles, logits, aux in forwards:
                ts = aux["token_select"]
                _, _, free_aux = runner.model(tiles, aux_logits=False)
                eq = ts == free_aux["token_select"]
                same, gates = same + int(eq.sum()), gates + eq.numel()
                crop_min = min(crop_min, eq.float().mean().item())
                flips += gate_flips(torch, aux, free_aux, ts.shape[2] + 1)
                with gates_replayed(self.layers, ts):
                    ref, _, _ = runner.model(tiles, aux_logits=False)
                err, mag = rel_err(logits, ref)
                worst = max(worst, err / mag)
                if not torch.isfinite(logits).all():
                    fail("seg eval: logits not finite")
        agree = same / gates
        if worst > MODEL_REL or agree < GATE_AGREE:
            fail(f"seg eval vs plain versions: max rel err {worst}, gate "
                 f"agreement {agree} ({gates - same} of {gates} gates "
                 f"differ; per crop at least {crop_min})")
        self.evals.append(dict(runner=runner, step=runner.state.step,
                               stats=stats, t0=t0, s=secs,
                               forwards=n, worst=worst, agree=agree,
                               crop_min=crop_min))
        print(f"seg eval at iteration {runner.state.step}"
              f"{' (int8)' if q8 else ''}: {n} crops, K9 x12"
              f"{' + K4 x12 + the stem' if q8 else ''} a forward and nothing "
              f"else; miou {stats['miou']:.4f}; vs plain versions given the "
              f"same gates max rel err {worst:.3g}; gate agreement "
              f"{agree:.6f} ({gates - same} of {gates} gates differ; per "
              f"crop at least {crop_min:.6f}; the differing router logits "
              f"at most {max([f[1] for f in flips], default=0):.3g} bf16 "
              f"ulps from 0); {n / secs:.1f} crops/s with the loader")
        return stats


def phase_seg_train(torch, ms, qt, fm, D, seg_sd, q8_model) -> dict:
    """Phase 13: segmentation training through seg_train.main on the card
    (A; C resumed from A's iteration-8 checkpoint, evaluating in int8; a
    BatchNorm pair), then int8 segmentation: q8_conv at the UPerHead's
    shapes, one int8 dispatch crop forward.  Returns the launches of K9
    and K4."""
    import shutil

    from dynamic_tuning_tpu_torch import seg_train
    from dynamic_tuning_tpu_torch.train import seg_runner as SR
    root = os.path.join(REPO, "build", "phase_seg_train")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    ft = os.path.join(root, "ft.pth")
    torch.save({k[len("backbone."):]: torch.from_numpy(v)
                for k, v in seg_sd.items() if k.startswith("backbone.")}, ft)
    a, c, bn_a, bn_c = (os.path.join(root, d)
                        for d in ("a", "c", "bn_a", "bn_c"))
    flags = ["--dataset", "synthetic", "--crop_size", "512", "--batch_size",
             "2", "--total_iters", "16", "--eval_interval", "8",
             "--no_auto_remove", "--num_workers", "2", "--finetune", ft]
    parse = seg_train.get_args_parser().parse_args
    probe = SegProbe(torch, ms, qt, fm, SR)
    with probe.installed():
        reset_counts(ms, qt, fm)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        probe.time_from = 8            # iterations 9-16, up to the eval
        seg_train.main(parse(flags + ["--output_dir", a]))
        peak = torch.cuda.max_memory_allocated()
        probe.time_from = -1
        ev_a = list(probe.evals)
        runner_a = ev_a[-1]["runner"]
        if [(e["step"], e["forwards"]) for e in ev_a] != [(8, 16), (16, 16)]:
            fail("seg run A: evaluations (iteration, crops) "
                 f"{[(e['step'], e['forwards']) for e in ev_a]}")
        steps_s = ev_a[1]["t0"] - probe.t_steps
        # C: resumed from A's iteration-8 checkpoint, evaluating in int8
        # (training runs bf16 all the same); its last 4 steps traced
        probe.trace_steps = TRACE_STEPS
        seg_train.main(parse(flags + [
            "--output_dir", c, "--quant", "int8", "--resume",
            os.path.join(a, "checkpoint-8.msgpack")]))
        runner_c = probe.evals[-1]["runner"]
        if (len(probe.evals) != 3 or runner_c.start_iter != 8
                or runner_c.cfg.model.quant != "int8"):
            fail("the resumed seg run did not run iterations 9-16 alone")
        oa, oc = runner_a.state.optimizer, runner_c.state.optimizer
        if (runner_a.state.step, oa.count) != (runner_c.state.step, oc.count):
            fail(f"resumed seg step/count {runner_c.state.step}/{oc.count}, "
                 f"uninterrupted {runner_a.state.step}/{oa.count}")
        pa = dict(runner_a.model.named_parameters())
        pc = dict(runner_c.model.named_parameters())
        differ = [n for n in oa.names if not torch.equal(pa[n], pc[n])]
        sa, sc = oa.state_dict()["rule"], oc.state_dict()["rule"]
        differ += [f"{part} {n}" for part in ("mu", "nu") for n in oa.names
                   if not torch.equal(sa[part][n], sc[part][n])]
        if differ:
            fail(f"the resumed seg run differs from the uninterrupted one "
                 f"in {len(differ)} tensors: {differ[:6]}")
        print(f"seg resume: the run resumed at iteration 8 (evaluating in "
              f"int8) ends with A's {len(oa.names)} trainable tensors and "
              f"their moments bit for bit; step {runner_c.state.step}, count "
              f"{oc.count}")
        del runner_a, runner_c, pa, pc, sa, sc
        # BatchNorm heads: two steps, then a resume restores the running
        # statistics of the checkpoint's aux-batch_stats sidecar
        bn = flags[:4] + ["--batch_size", "2", "--total_iters", "2",
                          "--eval_interval", "2", "--no_auto_remove",
                          "--num_workers", "2", "--finetune", ft,
                          "--seg_norm", "bn"]
        seg_train.main(parse(bn + ["--output_dir", bn_a]))
        runner_bn = probe.evals[-1]["runner"]
        resumed = seg_train.build_runner(parse(bn + [
            "--output_dir", bn_c, "--resume",
            os.path.join(bn_a, "checkpoint-2.msgpack")]),
            log=lambda m: None)
        ba = dict(runner_bn.model.named_buffers())
        bc = dict(resumed.model.named_buffers())
        names = runner_bn.buffers
        if (not names or any(not torch.equal(ba[n], bc[n]) for n in names)
                or all(torch.equal(bc[n], torch.ones_like(bc[n]))
                       for n in names if n.endswith("running_var"))):
            fail("the BatchNorm running statistics did not come back on "
                 "resume")
        print(f"seg BatchNorm: 2 steps, then --resume restores its "
              f"{len(names)} running statistics bit for bit")
        del runner_bn, resumed
    busy_ms, window_ms, kernels = probe.idle
    print(f"seg train ViT-B/16 + UPerHead 768 at 512^2, batch 2 (bf16 on "
          f"fp32 masters, no hand kernel): iterations 9-16 of run A "
          f"{steps_s:.3f} s, {steps_s * 1e3 / 8:.1f} ms a step, "
          f"{16 / steps_s:.2f} crops/s (loader, copy and step, host clock); "
          f"peak memory {peak / 2**30:.2f} GiB; run C's last {TRACE_STEPS} "
          f"steps traced: kernel-busy {busy_ms:.1f} ms in {kernels} kernels,"
          f" idle share {1 - busy_ms / window_ms:.4f} of their "
          f"{window_ms:.1f} ms device window")
    print("seg traced steps, device ms a step by kernel: " + "; ".join(
        f"{name[:90]} {us / 1e3 / TRACE_STEPS:.2f}"
        for name, us in probe.top))

    # (b) int8: q8_conv at the UPerHead's shapes, its int32 sums exact
    g = torch.Generator(device="cuda").manual_seed(5)
    shapes = [("fpn_bottleneck 3x3 3072->768 at 128^2", 128, 3072, 3),
              ("psp bottleneck 3x3 3840->768 at 16^2", 16, 3840, 3),
              ("lateral 1x1 768->768 at 128^2", 128, 768, 1)] + [
        (f"psp pool_{i} 1x1 768->768 at {sc}^2", sc, 768, 1)
        for i, sc in enumerate((1, 2, 3, 6))]
    for name, hw, cin, k in shapes:
        x = torch.randn((1, hw, hw, cin), generator=g, device="cuda")
        w = torch.randn((768, cin, k, k), generator=g, device="cuda") * 0.02
        wq, ws = qt.quantize_conv_weight(w)
        xq, _ = qt.sample_quant(x)
        rows = qt.im2col(xq, k)
        got = qt._int_mm_padded(rows, wq)
        # float64 holds each sum exactly
        want = torch.matmul(rows.double(), wq.double().t())
        if got.dtype != torch.int32 or not torch.equal(got.double(), want):
            fail(f"q8_conv {name}: int32 sums differ from the float64 "
                 "product")
        out = qt.q8_conv_codes(x, wq, ws, kernel=k)
        ms_k = time_ms(lambda: qt.q8_conv_codes(x, wq, ws, kernel=k))
        ms_p = time_ms(lambda: qt.int_matmul(qt.im2col(
            qt.sample_quant(x)[0], k), wq), iters=5)
        ops = 2 * rows.shape[0] * rows.shape[1] * 768
        b_ms, b_by = bound(nbytes(x, wq, out), {"int8": ops})
        print(f"q8_conv {name}: int32 sums exact ({rows.shape[0]} x "
              f"{rows.shape[1]} x 768); {ms_k:.4f} ms (im2col + _int_mm + "
              f"scales), the float64 product alone {ms_p:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by})")
    # one int8 dispatch crop forward: K9 x12, K4 x12, the stem once
    x = torch.randn((1, 512, 512, 3), generator=g, device="cuda")
    kw = dict(dispatch=True, aux_logits=False)
    reset_counts(ms, qt, fm)
    with torch.inference_mode():
        logits, _, aux = q8_model(x, **kw)
    torch.cuda.synchronize()
    want = dict.fromkeys(KERNELS, 0)
    want.update(mha_windowed_fused=DEPTH, q8_ln_mlp=DEPTH)
    counts = read_counts(ms, qt, fm)
    if counts != want or qt.q8_patch_embed.launches != 1:
        fail(f"int8 seg crop forward: launches {counts} (stem "
             f"{qt.q8_patch_embed.launches}), want {want} and the stem once")
    print("int8 seg dispatch crop forward: K9 x12, K4 x12, the stem once"
          + check_seg_forward(torch, ms, qt, fm, D, q8_model, x, kw, logits,
                              aux, "int8 seg crop"))
    shutil.rmtree(root, ignore_errors=True)
    return {"mha_windowed_fused": probe.k9 + DEPTH,
            "q8_ln_mlp": probe.k4 + DEPTH}


def _bf16_ulp(v: float) -> float:
    """The spacing of bf16 values at magnitude ``v``."""
    return 2.0 ** (math.floor(math.log2(max(abs(v), 1e-30))) - 7)


def gate_flips(torch, aux, ref_aux, capacity: int) -> list:
    """Each gate of a dispatch forward that differs from the plain-version
    forward's, as (block, threshold distance, threshold band, capacity
    distance, capacity band), in bf16 ulps.  Threshold: the plain
    forward's router logit's distance from 0, and the two forwards' logit
    difference at that token, in ulps of the block's largest |logit|.
    Capacity: its score's distance from the score on the other side of the
    last kept place, and twice the row's largest score difference between
    the forwards (the token's score and the boundary -- an order
    statistic, which moves no more than the largest difference -- may move
    apart), in ulps of the boundary score.  A flip lies inside the band
    when a distance is at most its band."""
    gate = aux["token_select"][..., 0]
    ref_gate = ref_aux["token_select"][..., 0]
    logits = aux["token_logits"][..., 0].float()
    ref = ref_aux["token_logits"][..., 0].float()
    kept = capacity - 1                    # CLS takes one place
    out = []
    for b, blk, t in (gate != ref_gate).nonzero().tolist():
        row, krow = ref[b, blk], logits[b, blk]
        lu = _bf16_ulp(row.abs().max().item())
        flip = [blk, abs(row[t].item()) / lu,
                abs(krow[t].item() - row[t].item()) / lu, math.inf, 0.0]
        if kept < row.numel():
            s, ks = torch.sigmoid(row), torch.sigmoid(krow)
            order = torch.sort(s, descending=True, stable=True).indices
            pos = (order == t).nonzero().item()
            other = s[order[kept] if pos < kept else order[kept - 1]].item()
            su = _bf16_ulp(other)
            flip[3] = abs(s[t].item() - other) / su
            flip[4] = 2 * (ks - s).abs().max().item() / su
        out.append(tuple(flip))
    return out


def k3_against_fp32(torch, ms, blocks) -> None:
    """K3 and its plain version on each block's inputs of a plain-version
    forward, both held against the plain version evaluated in fp32 (the
    weights and x in fp32, no bf16 rounding inside): the router logits'
    largest error in bf16 ulps of the block's largest |logit|, and x_mid's
    largest relative error.  Fails where K3 is more than twice as far from
    the fp32 evaluation as the plain version -- an error of K3's own, not
    the rounding both share."""
    bf16 = torch.bfloat16
    rows, launches = [], ms.dyt_prologue_serving.launches
    with torch.inference_mode():
        for i, (args, kwargs) in enumerate(blocks):
            exact = ms.dyt_prologue_plain(
                *(a.float() if torch.is_tensor(a) and a.dtype == bf16 else a
                  for a in args), **kwargs)
            lu = _bf16_ulp(exact[2].abs().max().item())
            xm = exact[0].abs().max().item()
            row = [i]
            for out in (ms.dyt_prologue_serving(*args, **kwargs),
                        ms.dyt_prologue_plain(*args, **kwargs)):
                row += [(out[2] - exact[2]).abs().max().item() / lu,
                        (out[0].float() - exact[0]).abs().max().item() / xm]
            rows.append(row)
    ms.dyt_prologue_serving.launches = launches
    worse = [r for r in rows if r[1] > 2 * r[3] or r[2] > 2 * r[4]]
    print("  K3 per block on the plain forward's inputs, against the plain "
          "version in fp32 (block, K3 logit err in ulps, K3 x_mid rel err, "
          "plain bf16 logit err in ulps, plain x_mid rel err): "
          + ", ".join(f"({r[0]}, {r[1]:.3g}, {r[2]:.3g}, {r[3]:.3g}, "
                      f"{r[4]:.3g})" for r in rows))
    if worse:
        fail(f"K3 is more than twice as far from the fp32 evaluation as its "
             f"plain version: {worse}")


def tubelet_forward(torch, ms, qt, fm, np, sd, *, inflated: bool) -> int:
    """One dispatch forward of the tubelet-2 video model (16 clips of 4
    frame groups) held against the plain-version forward, each differing
    gate's distance from its boundary printed; the gate applies to the
    inflated stem, the random-init stem is a diagnostic.  Returns K3's
    launches."""
    from dynamic_tuning_tpu_torch import config
    from dynamic_tuning_tpu_torch.checkpoint import load_timm_state_dict
    from dynamic_tuning_tpu_torch.models import video_vit
    from dynamic_tuning_tpu_torch.ops import dispatch as D
    cfg = config.ModelConfig(num_classes=400, num_frames=8, tubelet_size=2,
                             gelu_approx=True, residual_dtype="bfloat16")
    tub = video_vit.VideoVisionTransformer(
        cfg, tuning=config.TuningConfig(),
        select=config.SelectConfig(token_target_ratio=0.5),
        dtype=torch.bfloat16, generator=torch.Generator().manual_seed(1))
    stem = "patch_embed.proj.weight"
    if inflated:
        tub_sd = dict(sd, **{stem: np.repeat(sd[stem][:, :, None] / 2, 2,
                                             axis=2)})
    else:
        tub_sd = {k: v for k, v in sd.items() if k != stem}
    load_timm_state_dict(tub, tub_sd, log=lambda *_: None)
    tub.to("cuda")
    x = torch.randn((16, 8, 224, 224, 3), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(0))
    reset_counts(ms, qt, fm)
    with torch.inference_mode():
        logits, aux = tub(x, dispatch=True)
    want = dict.fromkeys(KERNELS, 0)
    want["dyt_prologue_serving"] = DEPTH
    counts = read_counts(ms, qt, fm)
    if counts != want or tuple(aux["token_select"].shape) != (
            64, DEPTH, N - 1, 1) or not torch.isfinite(logits).all():
        fail(f"tubelet-2 forward: launches {counts}, gates "
             f"{tuple(aux['token_select'].shape)}")
    blocks = []

    def recording(*args, **kwargs):
        blocks.append((args, kwargs))
        return ms.dyt_prologue_plain(*args, **kwargs)

    with plain_versions(ms, qt, fm), torch.inference_mode(), \
            mock.patch.object(ms, "dyt_prologue_serving", recording):
        ref, ref_aux = tub(x, dispatch=True)
    err, mag = rel_err(logits, ref)
    agree = (aux["token_select"] == ref_aux["token_select"]
             ).float().mean().item()
    if not inflated:
        k3_against_fp32(torch, ms, blocks)
    del blocks
    stem_name = ("the image stem inflated" if inflated
                 else "its stem at random init (diagnostic)")
    print(f"video tubelet-2 dispatch forward, {stem_name} (16 clips x 4 "
          f"frame groups, 12 K3 launches): logits vs plain versions max|err| "
          f"{err:.6g} (tol {MODEL_REL * mag:.6g}), gate agreement "
          f"{agree:.6f}")
    flips = gate_flips(torch, aux, ref_aux, D.capacity_for(N - 1, 0.5))
    if flips:
        thr = [f for f in flips if f[1] <= f[2]]
        cap = [f for f in flips if f[1] > f[2] and f[3] <= f[4]]
        outside = [f for f in flips if f[1] > f[2] and f[3] > f[4]]
        by_block = {}
        for f in flips:
            by_block[f[0]] = by_block.get(f[0], 0) + 1
        print(f"  {len(flips)} gates differ (per block {by_block}): "
              f"{len(thr)} straddle the threshold (logit within the "
              f"forwards' difference of 0: at most {max([f[1] for f in thr], default=0):.4g} "
              f"ulps), {len(cap)} sit at the capacity boundary (score within "
              f"twice the row's largest score difference of the boundary "
              f"score: at most {max([f[3] for f in cap], default=0):.4g} "
              f"ulps, bands up to {max([f[4] for f in cap], default=0):.4g}),"
              f" {len(outside)} outside the band"
              + (f" (block, threshold distance, band, capacity distance, "
                 f"band): {outside[:8]}" if outside else ""))
    if inflated and (err > MODEL_REL * mag or agree < GATE_AGREE):
        fail("the tubelet-2 forward disagrees with the plain-version forward")
    del tub
    torch.cuda.empty_cache()
    return DEPTH


FILES_DIR = "phase_files"
FILES_SERVE = 128               # canvases served from each weights file
FILES_BATCH, FILES_STEPS = 16, 4    # the small runner of phase 15 (b)


def _serve_file(torch, ms, qt, fm, predict, path, canvases, x) -> tuple:
    """predict's load of ``path`` (timed), its serve of ``canvases`` and
    one fast forward of ``x`` on the loaded tensors: (load s, serving
    tensors, results, logits, K15 launches of the forward)."""
    args = predict.get_args_parser().parse_args(
        ["--ckpt", path, "--images", "-", "--batch_size", str(FILES_SERVE)])
    cfg, tuning, sel = predict.configs(args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = predict.load_params(args, torch.device("cuda"))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    reset_counts(ms, qt, fm)
    with contextlib.redirect_stdout(io.StringIO()):
        results = predict.serve(args, canvases, params)
    torch.cuda.synchronize()
    want = {k: DEPTH if k == "mha_serving" else 0 for k in KERNELS}
    if read_counts(ms, qt, fm) != want:
        fail(f"files: predict.serve of {os.path.basename(path)}: launches "
             f"{read_counts(ms, qt, fm)}, want {want}")
    reset_counts(ms, qt, fm)
    with torch.inference_mode():
        logits, _ = predict.fast_vit_forward(params, x, cfg=cfg,
                                             tuning=tuning, select=sel,
                                             mode="dispatch",
                                             use_kernel=False)
    torch.cuda.synchronize()
    return load_s, params, results, logits, read_counts(ms, qt, fm)


def phase_files(torch, ms, qt, fm, np, predict, config, sd) -> dict:
    """Phase 15: the JAX package's files on the card.  (a) phase 3's
    weights as final_checkpoint.msgpack (the port's writer) and as a .pth,
    each loaded and served by predict; (b) the image runner at a small
    batch resumed from its checkpoint-0.msgpack; (c) the segmentor's
    BatchNorm statistics through the aux-batch_stats sidecar; (d) the
    committed JAX-written .msgpack decoded and re-encoded; (e) the native
    video decoder on the committed clip.  Returns the launches of K15, K3
    and K9."""
    import shutil

    from dynamic_tuning_tpu_torch import main_image, serialization
    from dynamic_tuning_tpu_torch.checkpoint import (make_seg_state_dict,
                                                     to_flax_params)
    from dynamic_tuning_tpu_torch.models.upernet import DyTSegmentor
    from dynamic_tuning_tpu_torch.train import checkpoint as TC
    from dynamic_tuning_tpu_torch.train import runner as R
    root = os.path.join(REPO, "build", FILES_DIR)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    launches = {"mha_serving": 0, "dyt_prologue_serving": 0,
                "mha_windowed_fused": 0}
    card = card_line()

    # (a) serving from a .msgpack: the same tensors, logits and launches as
    # from the .pth of the same weights
    t0 = time.perf_counter()
    mp_path = os.path.join(root, "final_checkpoint.msgpack")
    pth_path = os.path.join(root, "final_checkpoint.pth")
    size = serialization.write_file(mp_path, to_flax_params(sd)[0])
    write_s = time.perf_counter() - t0
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, pth_path)
    g = torch.Generator(device="cuda").manual_seed(15)
    canvases = torch.randint(0, 256, (FILES_SERVE, 256, 256, 3), generator=g,
                             device="cuda", dtype=torch.uint8)
    x = torch.randn((B, 224, 224, 3), generator=g, device="cuda")
    mp = _serve_file(torch, ms, qt, fm, predict, mp_path, canvases, x)
    pt = _serve_file(torch, ms, qt, fm, predict, pth_path, canvases, x)
    flat_mp, spec_mp = torch.utils._pytree.tree_flatten(mp[1])
    flat_pt, spec_pt = torch.utils._pytree.tree_flatten(pt[1])
    if spec_mp != spec_pt or not all(
            torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
            for a, b in zip(flat_mp, flat_pt)):
        fail("files: the .msgpack's serving tensors differ from the .pth's")
    if not torch.equal(mp[3], pt[3]) or mp[2] != pt[2]:
        fail("files: logits served from the .msgpack differ from the .pth's")
    want = {k: DEPTH if k == "mha_serving" else 0 for k in KERNELS}
    if mp[4] != want or pt[4] != want:
        fail(f"files: forward launches {mp[4]} / {pt[4]}, want {want}")
    launches["mha_serving"] += 4 * DEPTH
    print(f"files (a): final_checkpoint.msgpack of ViT-B/16 (adapter {FFN}, "
          f"keep 0.5) {size / 1e6:.3f} MB, written in {write_s:.3f} s; "
          f"predict.load_params to the card {mp[0] * 1e3:.1f} ms (.pth of "
          f"the same weights {pt[0] * 1e3:.1f} ms); predict.serve of "
          f"{FILES_SERVE} canvases and a dispatch forward of {B} images "
          f"equal bit for bit from both, {DEPTH} K15 launches a forward; "
          f"{card}")
    del mp, pt, flat_mp, flat_pt
    os.remove(pth_path)
    torch.cuda.empty_cache()

    # (b) the image runner resumed from checkpoint-0.msgpack, --finetune
    # the .msgpack of (a)
    real_build = R.build_image_dataset

    def build(*a, **kw):
        train, val, nc, metric = real_build(*a, **kw)
        train.n, val.n = FILES_STEPS * FILES_BATCH, 2 * FILES_BATCH
        return train, val, nc, metric

    a_dir, c_dir = os.path.join(root, "a"), os.path.join(root, "c")
    flags = ["--dataset", "synthetic", "--batch_size", str(FILES_BATCH),
             "--epochs", "2", "--warmup_epochs", "1", "--no_auto_remove",
             "--num_workers", "2", "--finetune", mp_path]
    parse = main_image.get_args_parser().parse_args
    probe = RunnerProbe(torch, ms, qt, fm, R)
    t0 = time.perf_counter()
    with mock.patch.object(R, "build_image_dataset", build), \
            probe.installed():
        probe.reset()
        main_image.main(parse(flags + ["--output_dir", a_dir]))
        launches["dyt_prologue_serving"] += probe.expect[
            "dyt_prologue_serving"]
        runner_a = probe.evals[-1]["runner"]
        ckpt = os.path.join(a_dir, "checkpoint-0.msgpack")
        if not os.path.exists(ckpt):
            fail(f"files (b): no {ckpt}: {sorted(os.listdir(a_dir))}")
        probe.reset()
        main_image.main(parse(flags + ["--output_dir", c_dir, "--resume",
                                       ckpt]))
        launches["dyt_prologue_serving"] += probe.expect[
            "dyt_prologue_serving"]
        runner_c = probe.evals[-1]["runner"]
    fa, fc = (open(os.path.join(d, "final_checkpoint.msgpack"), "rb").read()
              for d in (a_dir, c_dir))
    oa, oc = runner_a.state.optimizer, runner_c.state.optimizer
    moments = all(torch.equal(p, q) for p, q in zip(oa.rule.mu + oa.rule.nu,
                                                    oc.rule.mu + oc.rule.nu))
    if fa != fc or not moments or (runner_a.state.step, oa.count) != (
            runner_c.state.step, oc.count):
        fail("files (b): the run resumed from checkpoint-0.msgpack differs "
             "from the uninterrupted one")
    print(f"files (b): main_image at batch {FILES_BATCH}, 2 epochs of "
          f"{FILES_STEPS} steps (--finetune the .msgpack of (a)), resumed "
          f"from checkpoint-0.msgpack ({os.path.getsize(ckpt) / 1e6:.3f} MB): "
          f"final_checkpoint.msgpack equal byte for byte "
          f"({len(fa) / 1e6:.3f} MB), moments bit-identical, step "
          f"{runner_c.state.step}; {time.perf_counter() - t0:.1f} s")
    del runner_a, runner_c, oa, oc, probe
    shutil.rmtree(a_dir, ignore_errors=True)
    shutil.rmtree(c_dir, ignore_errors=True)
    torch.cuda.empty_cache()

    # (c) the segmentor's BatchNorm statistics through the sidecar
    t0 = time.perf_counter()
    seg_sd = make_seg_state_dict(np.random.RandomState(15), depth=DEPTH,
                                 dim=C, ffn=FFN, img=512, patch=16,
                                 num_classes=SEG_CLASSES, norm="bn")

    def segmentor(with_stats):
        m = DyTSegmentor(config.ModelConfig(img_size=512, gelu_approx=True,
                                            residual_dtype="bfloat16"),
                         num_classes=SEG_CLASSES,
                         tuning=config.TuningConfig(),
                         select=config.SelectConfig(token_target_ratio=0.5),
                         norm="bn", dtype=torch.bfloat16)
        m.load_state_dict({k: torch.from_numpy(v) for k, v in seg_sd.items()
                           if with_stats or ".running_" not in k},
                          strict=with_stats)
        return m.cuda()

    src, dst = segmentor(True), segmentor(False)
    names = [n for n, _ in src.named_buffers()
             if n.endswith((".running_mean", ".running_var"))]
    own = dict(src.named_buffers())
    path = TC.save_aux_state(root, "batch_stats",
                             {n: own[n] for n in names}, 16)
    stats = TC.load_aux_state(root, "batch_stats")
    with torch.no_grad():
        theirs = dict(dst.named_buffers())
        for n, v in stats.items():
            theirs[n].copy_(v)
    if set(stats) != set(names) or not all(
            torch.equal(own[n], theirs[n]) for n in names):
        fail("files (c): the BatchNorm statistics did not round-trip")
    crop = torch.randn((1, 512, 512, 3), generator=g, device="cuda")
    outs = []
    for m in (src, dst):
        reset_counts(ms, qt, fm)
        with torch.inference_mode():
            outs.append(m(crop, dispatch=True, aux_logits=False)[0])
        torch.cuda.synchronize()
        want = {k: DEPTH if k == "mha_windowed_fused" else 0
                for k in KERNELS}
        if read_counts(ms, qt, fm) != want:
            fail(f"files (c): launches {read_counts(ms, qt, fm)}, want "
                 f"{want}")
        launches["mha_windowed_fused"] += DEPTH
    if not torch.equal(*outs) or not torch.isfinite(outs[0]).all():
        fail("files (c): the crop's logits differ after the sidecar")
    print(f"files (c): {len(names)} BatchNorm statistics through "
          f"{os.path.basename(path)} ({os.path.getsize(path)} bytes) bit for "
          f"bit, and a dispatch crop's logits {tuple(outs[0].shape)} equal "
          f"({DEPTH} K9 launches a forward); "
          f"{time.perf_counter() - t0:.1f} s")
    del src, dst, outs, seg_sd
    torch.cuda.empty_cache()

    # (d) the committed file the JAX package wrote: decoded here, where
    # no msgpack, flax or ml_dtypes is installed, and written back
    fixture = os.path.join(REPO, "dynamic_tuning_tpu_torch", "fixtures",
                           "final_checkpoint.msgpack")
    data = open(fixture, "rb").read()
    t0 = time.perf_counter()
    tree = serialization.unpackb(data)
    decode_ms = (time.perf_counter() - t0) * 1e3
    if serialization.packb(tree) != data:
        fail("files (d): the JAX-written .msgpack does not re-encode to its "
             "own bytes")
    print(f"files (d): the JAX package's final_checkpoint.msgpack "
          f"({len(data)} bytes, fp32 and bf16 leaves) decoded in "
          f"{decode_ms:.2f} ms and re-encoded byte for byte")

    # (e) the native video decoder, if it builds on this host
    from dynamic_tuning_tpu_torch.data import native_video
    fixtures = os.path.join(REPO, "dynamic_tuning_tpu_torch", "native",
                            "fixtures")
    if native_video.available():
        clip = os.path.join(fixtures, "clip_64x48.mp4")
        stored = np.load(os.path.join(fixtures, "clip_64x48_frames.npz"))
        n = int(stored["probe"][0])
        got = native_video.read_frames(clip, list(range(n)))
        if tuple(native_video.probe(clip)) != tuple(
                int(v) for v in stored["probe"]) or not np.array_equal(
                np.stack([got[i] for i in range(n)]), stored["frames"]):
            fail("files (e): the native decoder's frames differ from the "
                 "JAX decoder's stored frames")
        print(f"native_video: built; {n} frames of the fixture clip equal "
              "the JAX decoder's bit for bit")
    else:
        why = native_video.why_unavailable().strip().splitlines()
        print(f"native_video: unavailable: {why[0] if why else '?'}")
    shutil.rmtree(root, ignore_errors=True)
    return launches


def phase_bench(torch, ms, qt, fm, bench, sds, seg_sd) -> dict:
    """bench.main at its full protocol: its line has the root bench's key
    set and every field not null by design is a positive number; every
    image-serving kernel and K9 ran as many times as its forwards need."""
    from dynamic_tuning_tpu_torch.utils.profiling import forwards_run
    with open(os.path.join(REPO, "BENCH_r05.json")) as f:
        want_keys = list(json.load(f)["parsed"])
    reset_counts(ms, qt, fm)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        bench.main(state_dicts=sds, seg_sd=seg_sd)
    lines = out.getvalue().splitlines()
    print("bench: " + lines[-1])
    line = json.loads(lines[-1])
    if len(lines) != 1 or list(line) != want_keys:
        fail(f"bench printed {len(lines)} lines, keys {list(line)}")
    for k, v in line.items():
        if k in bench.NULL_BY_DESIGN:
            ok = v is None
        elif k in ("metric", "unit", "seg_protocol"):
            ok = isinstance(v, str)
        else:
            ok = isinstance(v, (int, float)) and v > 0
        if not ok:
            fail(f"bench field {k} = {v!r}")
    fwd = bench.IMAGE_FORWARDS * DEPTH
    vfwd = bench.VIDEO_FORWARDS * DEPTH
    seg = DEPTH * len(bench.SEG_MODES) * (1 + forwards_run(
        bench.SEG_ITERS, bench.SEG_REPEATS, bench.SEG_WARMUP))
    want = dict.fromkeys(KERNELS, 0)
    # the image families, the video family's dense, dyt and q8 models and
    # the seg family's int8 model (K4 and the stem beside K9)
    seg_q8 = seg // len(bench.SEG_MODES)      # the int8 model's forwards
    want.update(attention_sublayer_serving=fwd + vfwd,
                dyt_prologue_serving=fwd + vfwd,
                dyt_prologue_serving_q8=fwd + vfwd,
                q8_ln_mlp=2 * fwd + vfwd + seg_q8,
                dyt_prologue_serving_moe=fwd,
                dyt_prologue_serving_q8_moe=fwd, mha_windowed_fused=seg)
    counts = read_counts(ms, qt, fm)
    stem = (2 * fwd + vfwd + seg_q8) // DEPTH
    if counts != want or qt.q8_patch_embed.launches != stem:
        fail(f"bench: kernel launches {counts} (int8 stem "
             f"{qt.q8_patch_embed.launches}), want {want} (stem {stem})")
    return counts


# --- phase 14: data-parallel training ----------------------------------------

PAR_BATCH = 16                  # images a rank of (b): the global batch 32
PAR_STEPS = 3
PAR_EVAL = 33                   # odd: rank 1's shard ends in a pad
PAR_NCCL_BATCH, PAR_NCCL_STEPS = 64, 4
# world 2 against world 1: each rank rounds its bf16 gradient products
# before the sum over ranks, and a batch of 16 takes other GEMM tilings
# than one of 32, so the summed gradients (the optimizer's first moments)
# agree to bf16 noise: their relative L2 distance within 2**-5.  Seg runs
# a global batch of 4 crops (2 a rank): at 2 the PSP's 1x1 pooled map
# would normalise 2 values a channel, a BatchNorm whose output is +-1 and
# whose gradient is 0 in exact arithmetic.  Even at 4 that BatchNorm's
# values are global means of near-alike synthetic crops, and flax's fast
# variance E[x^2] - E[x]^2 loses u * mean^2 / var of its precision, so the
# order of its sums moves the decode head and, backward, the backbone: in
# fp32 the first moments downstream of it agree to ~1e-3 where the
# running statistics and the auxiliary head agree to ~1e-6.  In bf16 the
# running statistics and the auxiliary head are held to 2**-5 and every
# other group of seg's first moments to 2**-4 (bf16 noise reaches 3.2e-2
# in the backbone's FPN).  The same first iteration in fp32 (the training
# path has no hand kernel) holds the running statistics to PAR_FP32_REL
# and, in every group, the settled elements: where the gradient is at
# least SETTLED of its tensor's largest, Adam's first step is
# lr * sign(g), and noise of 1e-3 cannot flip that sign.  Two biases have
# no gradient in exact arithmetic (a constant before a 1x1 conv and a
# BatchNorm): their first moments are rounding noise, held below
# NO_GRADIENT_REL of their group's largest instead.
PAR_REL = 2.0 ** -5
PAR_FP32_REL = 1e-4
SETTLED = 2.0 ** -5
SEG_NO_GRADIENT = ("backbone.fpn1_deconv2.bias", "backbone.fpn2_deconv.bias")
NO_GRADIENT_REL = 2.0 ** -10
PAR_SEG_BATCH = 2               # crops a rank of (c): the global batch 4
JPEG_DIR = os.path.join(REPO, "dynamic_tuning_tpu_torch", "native",
                        "fixtures")


PAR_GROUPS = ("psp", "decode_head", "auxiliary_head", "adaptmlp",
              "mlp_token_select", "relative_position", "fpn", "head")


def _groups(names) -> dict:
    """group -> the tensor names of PAR_GROUPS' group."""
    groups = {}
    for k in names:
        g = next((g for g in PAR_GROUPS
                  if any(part.startswith(g) for part in k.split("."))),
                 "other")
        groups.setdefault(g, []).append(k)
    return groups


def _group_rel(got: dict, want: dict) -> dict:
    """The relative L2 distance of each group of tensors."""
    return {g: _rel_l2({k: got[k] for k in ks}, {k: want[k] for k in ks})
            for g, ks in _groups(want).items()}


def _by_group(rel: dict) -> str:
    return ", ".join(f"{g} {r:.2e}" for g, r in rel.items())


def _settled_flips(got: dict, want: dict) -> tuple:
    """By group, [elements whose first moment in ``got`` has another sign
    than in ``want``, elements compared]: those where ``want``'s first
    moment is at least SETTLED of its tensor's largest, SEG_NO_GRADIENT
    aside; the tensors with a flip; and the largest first moment of
    SEG_NO_GRADIENT in either run over its group's largest."""
    out, where, free = {}, {}, 0.0
    for g, ks in _groups(want).items():
        out[g] = [0, 0]
        top = max(float(want[k].abs().max()) for k in ks
                  if k not in SEG_NO_GRADIENT)
        for k in ks:
            if k in SEG_NO_GRADIENT:
                free = max(free, float(want[k].abs().max()) / top,
                           float(got[k].abs().max()) / top)
                continue
            m = want[k].abs() >= SETTLED * want[k].abs().max()
            flips = int((got[k][m].sign() != want[k][m].sign()).sum())
            out[g][0] += flips
            out[g][1] += int(m.sum())
            if flips:
                where[k] = flips
    return out, where, free


def _train_gate_agreement(ranks: list, one: dict) -> float:
    """The first training step's student gates of the ranks (rows r::world
    of the global batch) against one process's."""
    world = len(ranks)
    return float(sum((r["gates"] == one["gates"][i::world]).float().sum()
                     for i, r in enumerate(ranks)) / one["gates"].numel())


def _rel_l2(got: dict, want: dict, base: dict | None = None) -> float:
    """||got - want|| / ||want - base|| over every tensor (base 0)."""
    num = den = 0.0
    for k, w in want.items():
        b = 0.0 if base is None else base[k]
        num += float((got[k].double() - w.double()).pow(2).sum())
        den += float((w.double() - b).pow(2).sum())
    return math.sqrt(num / max(den, 1e-300))


@contextlib.contextmanager
def _par_probe(torch, cls, rec: dict):
    """Record a runner's instance, each train step's host-clock ms (the
    card synchronised before and after) and each eval forward's logits and
    gates."""
    real_init, real_eval = cls.__init__, cls.evaluate

    def init(self, *a, **kw):
        real_init(self, *a, **kw)
        rec["runner"] = self
        rec["start"] = _trained(self)["params"]
        fwd = self.model.forward

        def traced(*a, **kw):
            out = fwd(*a, **kw)
            ts = out[-1]["token_select"]
            if (kw.get("training") and not kw.get("complete_model")
                    and ts is not None and not rec["train_gates"]):
                rec["train_gates"].append(ts.detach().float().cpu())
            return out
        self.model.forward = traced
        if hasattr(self, "eval_step"):
            ev = self.eval_step

            def recorded(xb):
                logits, ts = ev(xb)
                rec["forwards"].append((logits.float().cpu(),
                                        ts.float().cpu()))
                return logits, ts
            self.eval_step = recorded
        step = self.train_step

        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            parts = step(*a, **kw)
            torch.cuda.synchronize()
            rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
            rec["parts"].append({k: float(v) for k, v in parts.items()})
            return parts
        self.train_step = timed

    def evaluate(self, *a, **kw):
        rec["stats"].append(real_eval(self, *a, **kw))
        return rec["stats"][-1]

    rec.update(step_ms=[], parts=[], forwards=[], stats=[], train_gates=[])
    with mock.patch.object(cls, "__init__", init), \
            mock.patch.object(cls, "evaluate", evaluate):
        yield rec


def _trained(runner) -> dict:
    """A runner's trainable tensors, first moments and buffers, on the
    host."""
    opt = runner.state.optimizer
    params = dict(runner.model.named_parameters())
    rule = opt.state_dict()["rule"]
    return dict(params={n: params[n].detach().float().cpu()
                        for n in opt.names},
                mu={n: rule["mu"][n].float().cpu() for n in opt.names},
                buffers={n: b.float().cpu()
                         for n, b in runner.model.named_buffers()
                         if n.endswith((".running_mean", ".running_var"))},
                bucket=sum(p.numel() for p in opt.params) * 4)


def _eval_rows(torch, runner, rec) -> dict:
    """label -> (logits, gates) of each evaluated image (the synthetic
    val images' labels are distinct), pads dropped."""
    labels = torch.cat([torch.from_numpy(lb) for _, lb in runner.val_loader])
    logits = torch.cat([f[0] for f in rec["forwards"]])
    gates = torch.cat([f[1] for f in rec["forwards"]])
    return {int(lb): (logits[i], gates[i]) for i, lb in enumerate(labels)
            if lb >= 0}


def par_image_run(torch, ms, ft: str, out: str, batch: int) -> dict:
    """main_image.main on PAR_STEPS steps of the global batch (96 synthetic
    images) and one evaluation of PAR_EVAL images, ``batch`` images a
    process."""
    from dynamic_tuning_tpu_torch import main_image
    from dynamic_tuning_tpu_torch.train import runner as R
    real_build = R.build_image_dataset

    def build(*a, **kw):
        train, val, nc, metric = real_build(*a, **kw)
        train.n, val.n = PAR_STEPS * 2 * PAR_BATCH, PAR_EVAL
        return train, val, nc, metric

    flags = ["--dataset", "synthetic", "--batch_size", str(batch),
             "--epochs", "1", "--warmup_epochs", "1", "--no_auto_remove",
             "--num_workers", "2", "--finetune", ft, "--output_dir", out]
    rec = {}
    ms.reset_launch_counts()
    with mock.patch.object(R, "build_image_dataset", build), \
            _par_probe(torch, R.Runner, rec):
        main_image.main(main_image.get_args_parser().parse_args(flags))
    runner = rec["runner"]
    return dict(_trained(runner), step_ms=rec["step_ms"], parts=rec["parts"],
                gates=rec["train_gates"][0],
                rows=_eval_rows(torch, runner, rec), stats=rec["stats"][-1],
                start=rec["start"], k3=ms.dyt_prologue_serving.launches,
                runner=runner)


def _seg_flags(ft: str, out: str, batch: int) -> list:
    return ["--dataset", "synthetic", "--crop_size", "512", "--batch_size",
            str(batch), "--total_iters", "1", "--eval_interval", "1",
            "--seg_norm", "bn", "--no_auto_remove", "--num_workers", "2",
            "--finetune", ft, "--output_dir", out]


def par_seg_run(torch, ms, ft: str, out: str, batch: int) -> dict:
    """seg_train.main with BatchNorm heads: one iteration of the global
    batch of 4 crops at 512^2, ``batch`` a process, then its evaluation of
    16 crops (rank-strided)."""
    from dynamic_tuning_tpu_torch import seg_train
    from dynamic_tuning_tpu_torch.train import seg_runner as SR
    flags = _seg_flags(ft, out, batch)
    rec = {}
    ms.reset_launch_counts()
    with _par_probe(torch, SR.SegRunner, rec):
        seg_train.main(seg_train.get_args_parser().parse_args(flags))
    return dict(_trained(rec["runner"]), step_ms=rec["step_ms"],
                parts=rec["parts"], miou=rec["stats"][-1]["miou"],
                gates=rec["train_gates"][0],
                k9=ms.mha_windowed_fused.launches)


def par_seg_step32(torch, ft: str, out: str, batch: int) -> dict:
    """par_seg_run's first iteration in fp32, through
    ``SegRunner.train_step``: the training path has no hand kernel."""
    from dynamic_tuning_tpu_torch import seg_train
    args = seg_train.get_args_parser().parse_args(
        _seg_flags(ft, out, batch) + ["--compute_dtype", "float32"])
    runner = seg_train.build_runner(args)
    runner.train_loader.set_epoch(0)
    batches = runner.train_loader.iter_from(0)
    imgs, anns = next(batches)
    batches.close()
    start = _trained(runner)["params"]
    runner.train_step(*runner._device_batch(imgs, anns))
    res = dict(_trained(runner), start=start)
    del runner
    torch.cuda.empty_cache()
    return res


def parallel_worker(out: str) -> None:
    """One process of phase 14 (b, c): two of them share cuda:0 over gloo,
    launched with torchrun's variables."""
    import torch

    sys.path.insert(0, REPO)
    from dynamic_tuning_tpu_torch.ops import _build
    from dynamic_tuning_tpu_torch.ops import mha_serving as ms
    from dynamic_tuning_tpu_torch.parallel import multihost as MH
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.library()
    if not MH.maybe_initialize_distributed("cuda", backend="gloo"):
        fail("parallel worker: no process group from the environment")
    rank = MH.process_index()
    img = par_image_run(torch, ms, os.path.join(out, "ft64.pth"),
                        os.path.join(out, "img_w2"), PAR_BATCH)
    img.pop("runner")
    seg = par_seg_run(torch, ms, os.path.join(out, "ft_seg.pth"),
                      os.path.join(out, "seg_w2"), PAR_SEG_BATCH)
    seg32 = par_seg_step32(torch, os.path.join(out, "ft_seg.pth"),
                           os.path.join(out, "seg32_w2"), PAR_SEG_BATCH)
    torch.save(dict(img=img, seg=seg, seg32=seg32),
               os.path.join(out, f"rank{rank}.pt"))
    MH.shutdown()


def _launch_world(out: str, world: int = 2, timeout: int = 600) -> list:
    """``world`` processes of ``parallel_worker`` on cuda:0, torchrun's
    variables each; their results in rank order."""
    import socket
    import subprocess

    import torch
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs, logs = [], []
    for r in range(world):
        log = open(os.path.join(out, f"rank{r}.log"), "w")
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--parallel-worker",
             out], cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT))
        logs.append(log)
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(out, f"rank{r}.log")) as f:
                print(f.read()[-4000:], file=sys.stderr)
            fail(f"parallel worker rank {r} exited {p.returncode}")
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def par_nccl(torch, ft: str, out: str, seg_bucket: int) -> dict:
    """(a) an NCCL process group of world 1 on the card: PAR_NCCL_STEPS
    steps of the image runner through the all-reduce, against the same
    steps without a group; the all-reduce alone at the image and the seg
    buckets."""
    import socket

    from dynamic_tuning_tpu_torch import main_image
    from dynamic_tuning_tpu_torch.cli import args_to_config
    from dynamic_tuning_tpu_torch.parallel import mesh as P
    from dynamic_tuning_tpu_torch.parallel import multihost as MH
    from dynamic_tuning_tpu_torch.train import runner as R
    flags = ["--dataset", "synthetic", "--batch_size", str(PAR_NCCL_BATCH),
             "--epochs", "1", "--warmup_epochs", "1", "--no_auto_remove",
             "--num_workers", "2", "--finetune", ft, "--output_dir", out]
    cfg = args_to_config(main_image.get_args_parser().parse_args(flags))
    res = {}
    for mode in ("nccl", "plain"):
        if mode == "nccl":
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                port = s.getsockname()[1]
            MH.initialize(f"127.0.0.1:{port}", 1, 0, device="cuda")
        try:
            rec = {}
            with _par_probe(torch, R.Runner, rec):
                runner = R.Runner(cfg, torch.device("cuda"))
            runner.train_loader.ds.n = PAR_NCCL_STEPS * PAR_NCCL_BATCH
            runner.train_one_epoch(0)
            res[mode] = dict(step_ms=rec["step_ms"], parts=rec["parts"],
                             params=_trained(runner)["params"],
                             backend=(torch.distributed.get_backend()
                                      if P.group_active() else "none"))
            if mode == "nccl":
                opt = runner.state.optimizer
                grads = [torch.ones_like(p) for p in opt.params]
                res["image_bucket"] = P.all_reduce_bytes(grads)
                res["image_ar_ms"] = time_ms(
                    lambda: P.all_reduce_grads(grads), iters=10)
                big = [torch.ones(seg_bucket // 4, device="cuda")]
                res["seg_ar_ms"] = time_ms(lambda: P.all_reduce_grads(big),
                                           iters=5)
                del big, grads
        finally:
            MH.shutdown()
        del runner
        torch.cuda.empty_cache()
    return res


def par_decoder(np) -> str:
    """(d) the native JPEG loader: built or not and why; its canvases
    against PIL's (stored beside the JPEGs of ``native/fixtures``, each
    within one count); its decode time."""
    import importlib.util

    from dynamic_tuning_tpu_torch.data import native_loader as NL
    if not NL.available():
        pil = ("PIL" if importlib.util.find_spec("PIL")
               else "PIL, which this host lacks too")
        return (f"{pil} (the native loader did not build: "
                f"{NL.why_unavailable().splitlines()[0]})")
    ref = np.load(os.path.join(JPEG_DIR, "pil_canvases.npz"))
    worst, n = 0, 0
    for key in ref.files:
        name, canvas, square = key.rsplit("_", 2)
        got = NL.decode_resize(os.path.join(JPEG_DIR, name + ".jpg"),
                               int(canvas), square=square == "square")
        if got is None:
            fail(f"native decode of {name}.jpg failed")
        worst = max(worst, int(np.abs(got.astype(np.int32)
                                      - ref[key].astype(np.int32)).max()))
        n += 1
    if worst > 1:
        fail(f"native decode differs from PIL by {worst} counts")
    big = os.path.join(JPEG_DIR, "smooth_500x375.jpg")
    t0 = time.perf_counter()
    for _ in range(20):
        NL.decode_resize(big, 256)
    native_ms = (time.perf_counter() - t0) / 20 * 1e3
    try:
        from dynamic_tuning_tpu_torch.data.datasets import decode_canvas
        t0 = time.perf_counter()
        for _ in range(20):
            decode_canvas(big, 256)
        pil = f"{(time.perf_counter() - t0) / 20 * 1e3:.3f} ms"
    except ImportError:
        pil = "not installed on this host"
    return (f"native ({NL.library_path()}): {n} canvases within {worst} "
            f"count of PIL's; a 500x375 JPEG to a 256 canvas in "
            f"{native_ms:.3f} ms (host clock, one thread), PIL {pil}")


def phase_parallel(torch, ms, qt, fm, np, sd, seg_sd) -> dict:
    """Phase 14: data-parallel training (``parallel/``).  (b, c) two gloo
    processes on this card against one process: the image runner at
    ViT-B/16's width and depth, 16 images a rank, 3 steps, then an
    evaluation of 33 images (padded); the seg runner with BatchNorm heads,
    2 ranks x 2 crops against 1 x 4; (a) an NCCL group of world 1, 4 image
    steps through the all-reduce; (d) the native JPEG loader.  Returns K3's
    and K9's launches (the evaluations')."""
    import shutil
    root = os.path.join(REPO, "build", "phase_parallel")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    ft = os.path.join(root, "ft64.pth")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, ft)
    torch.save({k[len("backbone."):]: torch.from_numpy(v)
                for k, v in seg_sd.items() if k.startswith("backbone.")},
               os.path.join(root, "ft_seg.pth"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ranks = _launch_world(root)
    t_world = time.perf_counter() - t0
    w2 = [r["img"] for r in ranks]
    s2 = [r["seg"] for r in ranks]
    f2 = [r["seg32"] for r in ranks]
    for what, runs in (("image", w2), ("seg", s2), ("fp32 seg", f2)):
        for part in ("params", "buffers"):
            a, b = runs[0][part], runs[1][part]
            if any(not torch.equal(a[n], b[n]) for n in a):
                fail(f"parallel {what}: the ranks' {part} differ")
        if runs[0].get("parts") != runs[1].get("parts"):
            fail(f"parallel {what}: the ranks report other loss parts")
    # (b) one process on the global batch
    reset_counts(ms, qt, fm)
    w1 = par_image_run(torch, ms, ft, os.path.join(root, "img_w1"),
                       2 * PAR_BATCH)
    k3 = sum(r["k3"] for r in w2) + w1["k3"]
    if not all(r["k3"] for r in w2):
        fail("parallel image: an evaluation forward launched no K3")
    problems = []
    mu_rel = _rel_l2(w2[0]["mu"], w1["mu"])
    upd_rel = _rel_l2(w2[0]["params"], w1["params"], base=w1["start"])
    img_train_gates = _train_gate_agreement(w2, w1)
    print(f"ddp image, world 2 vs 1: first moments by group "
          f"{_by_group(_group_rel(w2[0]['mu'], w1['mu']))}; first step's training "
          f"gates {img_train_gates:.6f}")
    runner = w1.pop("runner")
    if mu_rel > PAR_REL:
        problems.append(f"image world 2 vs 1: first moments at relative L2 "
                        f"{mu_rel:.3e} (> {PAR_REL})")
    rows1 = w1["rows"]
    rows2 = {k: v for r in w2 for k, v in r["rows"].items()}
    if sorted(rows2) != sorted(rows1) or len(rows1) != PAR_EVAL:
        fail(f"parallel eval: world 2 evaluated {sorted(rows2)}, world 1 "
             f"{sorted(rows1)}")
    agree_trained = float(np.mean([
        float((rows2[k][1] == rows1[k][1]).float().mean()) for k in rows1]))
    # the same weights (world 2's) evaluated by one process
    with torch.no_grad():
        own = dict(runner.model.named_parameters())
        for n, p in w2[0]["params"].items():
            own[n].copy_(p.to(own[n].device))
    rec = dict(forwards=[])
    real_step = runner.eval_step

    def recorded(xb):
        logits, ts = real_step(xb)
        rec["forwards"].append((logits.float().cpu(), ts.float().cpu()))
        return logits, ts
    runner.eval_step = recorded
    ms.reset_launch_counts()
    same = runner.evaluate()
    k3 += ms.dyt_prologue_serving.launches
    rows_same = _eval_rows(torch, runner, rec)
    acc2 = w2[0]["stats"]["acc1"]
    agree_same = float(np.mean([
        float((rows2[k][1] == rows_same[k][1]).float().mean())
        for k in rows_same]))
    logit_rel = max(float((rows2[k][0] - rows_same[k][0]).abs().max())
                    for k in rows_same) / max(
        float(rows_same[k][0].abs().max()) for k in rows_same)
    if same["acc1"] != acc2 or w2[1]["stats"]["acc1"] != acc2 \
            or same["acc5"] != w2[0]["stats"]["acc5"] \
            or logit_rel > MODEL_REL or agree_same < GATE_AGREE \
            or agree_trained < GATE_AGREE:
        problems.append(f"eval: acc1 world 2 {acc2}, one process on its "
                        f"weights {same['acc1']}, logits {logit_rel:.3e}; "
                        f"gates {agree_same:.5f} "
                        f"(same weights), {agree_trained:.5f} (each run's "
                        "own)")
    del runner
    torch.cuda.empty_cache()
    # (c) seg: one process on the global batch
    s1 = par_seg_run(torch, ms, os.path.join(root, "ft_seg.pth"),
                     os.path.join(root, "seg_w1"), 2 * PAR_SEG_BATCH)
    k9 = sum(r["k9"] for r in s2) + s1["k9"]
    seg_groups = _group_rel(s2[0]["mu"], s1["mu"])
    init = {n: (torch.ones_like(b) if n.endswith("running_var")
                else torch.zeros_like(b)) for n, b in s1["buffers"].items()}
    seg_bn = _rel_l2(s2[0]["buffers"], s1["buffers"], base=init)
    seg_train_gates = _train_gate_agreement(s2, s1)
    f1 = par_seg_step32(torch, os.path.join(root, "ft_seg.pth"),
                        os.path.join(root, "seg32_w1"), 2 * PAR_SEG_BATCH)
    f32_groups = _group_rel(f2[0]["mu"], f1["mu"])
    f32_bn = _rel_l2(f2[0]["buffers"], f1["buffers"], base=init)
    f32_flips, flipped, no_grad = _settled_flips(f2[0]["mu"], f1["mu"])
    print(f"ddp seg, world 2 vs 1: first moments by group "
          f"{_by_group(seg_groups)}; BatchNorm statistics "
          f"{seg_bn:.2e}; training gates {seg_train_gates:.6f}; in fp32: "
          f"{_by_group(f32_groups)}; BatchNorm statistics {f32_bn:.2e}; "
          f"settled signs flipped {f32_flips} {flipped}; gradient-free "
          f"biases' first moments {no_grad:.2e} of their group's largest")
    aux = seg_groups.get("auxiliary_head", math.inf)
    if not s1["buffers"] or "psp" not in seg_groups \
            or max(seg_groups.values()) > 2 * PAR_REL or aux > PAR_REL \
            or seg_bn > PAR_REL:
        problems.append(f"seg: first moments by group "
                        f"{_by_group(seg_groups)} (> {2 * PAR_REL}, the "
                        f"auxiliary head > {PAR_REL}), BatchNorm statistics "
                        f"{seg_bn:.3e} (> {PAR_REL})")
    if sorted(f32_flips) != sorted(seg_groups) \
            or any(f or not n for f, n in f32_flips.values()) \
            or f32_bn > PAR_FP32_REL or not no_grad < NO_GRADIENT_REL:
        problems.append(f"fp32 seg: settled first moments of another sign "
                        f"by group {f32_flips} (of those compared) "
                        f"{flipped}, BatchNorm statistics {f32_bn:.3e} "
                        f"(> {PAR_FP32_REL}), gradient-free biases "
                        f"{no_grad:.3e} (> {NO_GRADIENT_REL})")
    # (a) NCCL, world 1
    nccl = par_nccl(torch, ft, os.path.join(root, "nccl"), s1["bucket"])
    parts_rel = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12)
                    for a, b in zip(nccl["nccl"]["parts"],
                                    nccl["plain"]["parts"]) for k in b)
    if nccl["nccl"]["backend"] != "nccl" or parts_rel > 1e-3:
        problems.append(f"NCCL world 1: backend {nccl['nccl']['backend']}, "
                        f"loss parts {parts_rel:.3e} from the steps without "
                        "a group")
    decoder = par_decoder(np)
    print(f"decoder: {decoder}")

    def ms_of(v):
        return "/".join(f"{x:.1f}" for x in v)
    print(json.dumps({"ddp": {
        "world_2_gloo_one_card": {
            "image_step_ms_rank0": w2[0]["step_ms"],
            "image_step_ms_rank1": w2[1]["step_ms"],
            "seg_step_ms_rank0": s2[0]["step_ms"],
            "wall_s_both_processes": round(t_world, 1)},
        "world_1_no_group": {"image_step_ms": w1["step_ms"],
                             "seg_step_ms": s1["step_ms"]},
        "world_1_nccl": {"image_step_ms_batch64": nccl["nccl"]["step_ms"],
                         "plain_step_ms_batch64": nccl["plain"]["step_ms"],
                         "loss_parts_rel_vs_plain": parts_rel,
                         "image_all_reduce_ms": nccl["image_ar_ms"],
                         "seg_all_reduce_ms": nccl["seg_ar_ms"]},
        "all_reduce_bytes": {"image": nccl["image_bucket"],
                             "seg": s1["bucket"]},
        "image_first_moments_rel_l2": mu_rel,
        "image_params_rel_l2": upd_rel,
        "eval_acc1_world2": acc2, "eval_acc1_one_process_same_weights":
            same["acc1"], "eval_acc1_world1_trained": w1["stats"]["acc1"],
        "eval_acc5_world2": w2[0]["stats"]["acc5"],
        "eval_acc5_one_process_same_weights": same["acc5"],
        "eval_logits_rel_same_weights": logit_rel,
        "gate_agreement_same_weights": agree_same,
        "gate_agreement_each_trained": agree_trained,
        "seg_first_moments_rel_l2_by_group": seg_groups,
        "seg_fp32_first_moments_rel_l2_by_group": f32_groups,
        "seg_fp32_bn_stats_rel_l2": f32_bn,
        "seg_fp32_settled_sign_flips_by_group": f32_flips,
        "seg_fp32_gradient_free_biases_first_moment": no_grad,
        "seg_bn_stats_rel_l2": seg_bn,
        "seg_miou_world2": s2[0]["miou"], "seg_miou_world1": s1["miou"],
        "training_gate_agreement": {"image": img_train_gates,
                                    "seg": seg_train_gates}}}))
    print(f"ddp: world 2 (gloo, one card) vs 1: image steps "
          f"{ms_of(w2[0]['step_ms'])} ms a rank vs {ms_of(w1['step_ms'])} "
          f"ms; first moments at relative L2 {mu_rel:.2e}, gates "
          f"{agree_same:.5f} / {agree_trained:.5f}, acc1 {acc2} = "
          f"{same['acc1']}; seg moments at most "
          f"{max(seg_groups.values()):.2e} a group, BatchNorm "
          f"{seg_bn:.2e} (fp32: moments {max(f32_groups.values()):.2e}, "
          f"settled signs flipped "
          f"{sum(f for f, _ in f32_flips.values())}, BatchNorm "
          f"{f32_bn:.2e}); NCCL world 1 steps "
          f"{ms_of(nccl['nccl']['step_ms'])} ms vs "
          f"{ms_of(nccl['plain']['step_ms'])} ms without a group, "
          f"all-reduce {nccl['image_bucket'] / 1e6:.2f} MB in "
          f"{nccl['image_ar_ms']:.3f} ms (image), {s1['bucket'] / 1e6:.1f} "
          f"MB in {nccl['seg_ar_ms']:.3f} ms (seg)")
    if problems:
        fail("parallel: " + "; ".join(problems))
    shutil.rmtree(root, ignore_errors=True)
    return {"dyt_prologue_serving": k3, "mha_windowed_fused": k9}


# --- phase 16: fp32 forms, adapter and MoE widths, head dims 192 and up ----

F32_B = 32                      # fp32 kernel checks: ViT-B/16 rows of 32 images
F32_REL = 1e-5                  # an fp32 form against its plain version
# fp32 ViT-B/16 forwards against the plain-version forward: the kernels'
# fp32 sums in other orders, carried through 12 blocks (int8: one code
# step where an activation sits on a rounding boundary)
F32_MODEL_REL = 1e-3
F32_GATE_AGREE = 0.9995
WIDE_F = 256                    # an adapter past the wgmma tail's 128:
#                                 the MoE tail's wgmma kernel, gate-free
SIMT_F = 1040                   # past its 1024: the SIMT tail
WIDE_MOE = (4, 192)             # E * b = 768: the wgmma tail past 512
SIMT_MOE = (4, 260)             # E * b = 1040, past the wgmma tail's 1024
HD192_HEADS = 4                 # C = 768 in 4 heads of 192
HD384_HEADS = 2                 # C = 768 in 2 heads of 384 (past 256)
SEG_HD192_IMG = 512             # the head-dim-192 BEiT backbone's crop
# name:form -> (module of the wrapper, JSON fields): the forms this phase
# adds to the kernels line ("name@width": a width of the wrapper's bf16
# form that gets a line of its own, counted in the runs that name it)
FORMS = {
    "attention_sublayer_serving:fp32": ("ms", dict(
        route="cuda", source=f"{SRC}/simt_chain.cu",
        replaces=f"{JAX_OPS}/mha_serving.py:465")),
    "dyt_prologue_serving:fp32": ("ms", dict(
        route="cuda", source=f"{SRC}/simt_chain.cu",
        replaces=f"{JAX_OPS}/mha_serving.py:581")),
    "dyt_prologue_serving_moe:fp32": ("ms", dict(
        route="cuda", source=f"{SRC}/simt_chain.cu",
        replaces=f"{JAX_OPS}/mha_serving.py:763")),
    # the int8 chains of quant.cu with fp32 adapters: the exact core and the
    # float64 tail on the FP64 tensor cores (DMMA)
    "dyt_prologue_serving_q8:fp32": ("qt", dict(
        route="cuda", source=f"{SRC}/exact_core.cu",
        replaces=f"{JAX_OPS}/quant.py:531")),
    "dyt_prologue_serving_q8_moe:fp32": ("qt", dict(
        route="cuda", source=f"{SRC}/f64_tail.cu",
        replaces=f"{JAX_OPS}/quant.py:674")),
    # K10 on fp32 qkv (and K6 with fp32 adapters and int8 scores): up to
    # head dim 256 the exact core's int8-score mode (IMMA scores, DMMA
    # P V), past it the SIMT int8-score form (2 heads of 384)
    "attn_core_pairs_q8:fp32+q8_exact": ("qt", dict(
        route="cuda", source=f"{SRC}/exact_core.cu",
        replaces=f"{JAX_OPS}/quant.py:309")),
    "dyt_prologue_serving_q8:fp32+q8_exact": ("qt", dict(
        route="cuda", source=f"{SRC}/exact_core.cu",
        replaces=f"{JAX_OPS}/quant.py:531")),
    "attn_core_pairs_q8:fp32": ("qt", dict(
        route="cuda", source=f"{SRC}/simt_core_q8.cu",
        replaces=f"{JAX_OPS}/quant.py:309")),
    "mha_windowed_fused:fp32": ("ms", dict(
        route="cuda", source=f"{SRC}/f32_core.cu",
        replaces=f"{JAX_OPS}/mha_serving.py:321")),
    "mha_serving_fused:fp32": ("ms", dict(
        route="cuda", source=f"{SRC}/f32_core.cu",
        replaces=f"{JAX_OPS}/mha_serving.py:219")),
    "dyt_prologue_serving:bf16+wide_heads": ("ms", dict(
        route="cuda", source=f"{SRC}/attention_sublayer.cu",
        replaces=f"{JAX_OPS}/mha_serving.py:581")),
    "dyt_prologue_serving_q8:bf16+wide_heads": ("qt", dict(
        route="cuda", source=f"{SRC}/quant.cu",
        replaces=f"{JAX_OPS}/quant.py:531")),
    "attn_core_pairs_q8:bf16+wide_heads": ("qt", dict(
        route="cuda", source=f"{SRC}/quant.cu",
        replaces=f"{JAX_OPS}/quant.py:309")),
    "mha_serving:bf16+wide_heads": ("ms", dict(
        route="cuda", source=f"{SRC}/attention_sublayer.cu",
        replaces=f"{JAX_OPS}/mha_serving.py:49")),
    "mha_windowed_fused:bf16+wide_heads": ("ms", dict(
        route="cuda", source=f"{SRC}/attention_sublayer.cu",
        replaces=f"{JAX_OPS}/mha_serving.py:321")),
    # past head dim 256 (2 heads of 384 at ViT-B/16 width): the wgmma core
    # past 256 and the fp32 core's (hd a run-time count); with int8 scores
    # the SIMT core's 64-column slices
    "dyt_prologue_serving:bf16+past_256": ("ms", dict(
        route="cuda", source=f"{SRC}/attention_sublayer.cu",
        replaces=f"{JAX_OPS}/mha_serving.py:581")),
    "mha_serving:bf16+past_256": ("ms", dict(
        route="cuda", source=f"{SRC}/attention_sublayer.cu",
        replaces=f"{JAX_OPS}/mha_serving.py:49")),
    "mha_serving_fused:bf16+past_256": ("ms", dict(
        route="cuda", source=f"{SRC}/attention_sublayer.cu",
        replaces=f"{JAX_OPS}/mha_serving.py:219")),
    "mha_windowed_fused:bf16+past_256": ("ms", dict(
        route="cuda", source=f"{SRC}/attention_sublayer.cu",
        replaces=f"{JAX_OPS}/mha_serving.py:321")),
    "dyt_prologue_serving:fp32+past_256": ("ms", dict(
        route="cuda", source=f"{SRC}/f32_core.cu",
        replaces=f"{JAX_OPS}/mha_serving.py:581")),
    "mha_serving_fused:fp32+past_256": ("ms", dict(
        route="cuda", source=f"{SRC}/f32_core.cu",
        replaces=f"{JAX_OPS}/mha_serving.py:219")),
    "mha_windowed_fused:fp32+past_256": ("ms", dict(
        route="cuda", source=f"{SRC}/f32_core.cu",
        replaces=f"{JAX_OPS}/mha_serving.py:321")),
    # with int8 scores past head dim 256: the int8-score wgmma key ring
    "dyt_prologue_serving_q8:bf16+q8_ring": ("qt", dict(
        route="cuda", source=f"{SRC}/q8_ring.cu",
        replaces=f"{JAX_OPS}/quant.py:531")),
    "attn_core_pairs_q8:bf16+q8_ring": ("qt", dict(
        route="cuda", source=f"{SRC}/q8_ring.cu",
        replaces=f"{JAX_OPS}/quant.py:309")),
    # the bf16 adapter tail past width 128: up to 1024 the MoE tail's
    # wgmma kernel gate-free (F = 256), past it the SIMT tail (F = 1040)
    "dyt_prologue_serving:bf16+wide_tail": ("ms", dict(
        route="cuda", source=f"{SRC}/moe_adapter.cu",
        replaces=f"{JAX_OPS}/mha_serving.py:581")),
    "dyt_prologue_serving_q8:bf16+wide_tail": ("qt", dict(
        route="cuda", source=f"{SRC}/moe_adapter.cu",
        replaces=f"{JAX_OPS}/quant.py:531")),
    "dyt_prologue_serving:bf16+simt_tail": ("ms", dict(
        route="cuda", source=f"{SRC}/simt_chain.cu",
        replaces=f"{JAX_OPS}/mha_serving.py:581")),
    "dyt_prologue_serving_q8:bf16+simt_tail": ("qt", dict(
        route="cuda", source=f"{SRC}/simt_chain.cu",
        replaces=f"{JAX_OPS}/quant.py:531")),
    # the wgmma MoE tail past E * b = 512 (up to 1024)
    "dyt_prologue_serving_moe@4x192": ("ms", dict(
        route="cuda", source=f"{SRC}/moe_adapter.cu",
        replaces=f"{JAX_OPS}/mha_serving.py:763")),
    "dyt_prologue_serving_q8_moe@4x192": ("qt", dict(
        route="cuda", source=f"{SRC}/moe_adapter.cu",
        replaces=f"{JAX_OPS}/quant.py:674")),
}
KERNELS.update(FORMS)
# speed.main runs of the phase: (flags, batch, state dict (MoE experts) or
# None for speed's own random weights, KERNELS entries launched once a
# block, the bounds it is held to against the plain-version forward:
# "fp32" (F32_MODEL_REL, F32_GATE_AGREE), "int8" (MODEL_REL: K5's qkv
# scratch is bf16 at fp32 compute, as the TPU kernel's, so its core rounds
# as the bf16 core does), "bf16" (MODEL_REL, GATE_AGREE), or None)
F32 = ["--compute_dtype", "float32", "--residual_dtype", "float32"]
FORM_RUNS = [
    (F32 + ["--mode", "dispatch"], B, 0, ("dyt_prologue_serving:fp32",),
     "fp32"),
    (F32 + ["--mode", "dispatch", "--quant", "int8"], B, 0,
     ("dyt_prologue_serving_q8:fp32", "q8_ln_mlp"), "fp32"),
    (F32 + ["--mode", "dispatch", "--quant", "int8_attn"], B, 0,
     ("dyt_prologue_serving_q8:fp32+q8_exact", "q8_ln_mlp",
      "attn_core_pairs_q8:fp32+q8_exact"), "fp32"),
    (F32 + ["--mode", "dispatch", "--quant", "int8_attn", "--num_heads",
            str(HD384_HEADS)], F32_B, 0,
     ("dyt_prologue_serving_q8:fp32", "q8_ln_mlp", "attn_core_pairs_q8:fp32"),
     "fp32"),
    (F32 + ["--mode", "dense"], B, 0, ("dyt_prologue_serving:fp32",), None),
    (F32 + ["--mode", "plain"], F32_B, 0,
     ("attention_sublayer_serving:fp32",), "fp32"),
    (F32 + ["--mode", "dispatch", "--moe_experts", str(MOE)], F32_B, MOE,
     ("dyt_prologue_serving_moe:fp32",), "fp32"),
    (F32 + ["--mode", "dispatch", "--moe_experts", str(MOE), "--quant",
            "int8"], F32_B, MOE,
     ("dyt_prologue_serving_q8_moe:fp32", "q8_ln_mlp"), "fp32"),
    (F32 + ["--mode", "plain", "--quant", "int8"], F32_B, 0,
     ("attention_sublayer_serving_q8", "q8_ln_mlp"), "int8"),
    (F32 + ["--mode", "dispatch", "--num_heads", str(HD384_HEADS)], F32_B,
     0, ("dyt_prologue_serving:fp32+past_256",), "fp32"),
    (["--mode", "dispatch", "--ffn_num", str(WIDE_F)], F32_B, None,
     ("dyt_prologue_serving:bf16+wide_tail",), "bf16"),
    (["--mode", "dispatch", "--ffn_num", str(WIDE_F), "--quant", "int8"],
     F32_B, None, ("dyt_prologue_serving_q8:bf16+wide_tail", "q8_ln_mlp"),
     "int8"),
    (["--mode", "dispatch", "--ffn_num", str(SIMT_F)], F32_B, None,
     ("dyt_prologue_serving:bf16+simt_tail",), None),
    (["--mode", "dispatch", "--ffn_num", str(SIMT_F), "--quant", "int8"],
     F32_B, None, ("dyt_prologue_serving_q8:bf16+simt_tail", "q8_ln_mlp"),
     None),
    (["--mode", "dispatch", "--moe_experts", str(WIDE_MOE[0]), "--ffn_num",
      str(WIDE_MOE[1])], F32_B, None,
     ("dyt_prologue_serving_moe@4x192",), "bf16"),
    (["--mode", "dispatch", "--moe_experts", str(WIDE_MOE[0]), "--ffn_num",
      str(WIDE_MOE[1]), "--quant", "int8"], F32_B, None,
     ("dyt_prologue_serving_q8_moe@4x192", "q8_ln_mlp"), "int8"),
    (["--mode", "dispatch", "--ffn_num", "8"], F32_B, None,
     ("dyt_prologue_serving",), None),
    (["--mode", "dispatch", "--moe_experts", "2", "--ffn_num", "4"], F32_B,
     None, ("dyt_prologue_serving_moe",), None),
]


def forms_inputs(torch, ms, qt, *, dtype, batch=F32_B, C_=C, F=FFN,
                 moe=(MOE, FFN), seed=19):
    """Kernel arguments at ViT-B/16 scales in ``dtype`` weights: x, the
    sublayer (and its int8 form), the adapter and router, the MoE
    experts."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    f32 = torch.float32

    def r(*shape, s=1.0, dt=f32):
        return (torch.randn(shape, generator=g, device="cuda") * s).to(dt)
    x = r(batch, N, C_, dt=dtype)
    sub = (r(C_, s=0.05) + 1.0, r(C_, s=0.02), r(3 * C_, C_, s=0.03),
           r(3 * C_, s=0.02), r(C_, C_, s=0.03), r(C_, s=0.02))
    qsub = (*sub[:2], *qt.quantize_weight(sub[2]), sub[3],
            *qt.quantize_weight(sub[4]), sub[5])
    sub = (*sub[:2], sub[2].to(dtype), sub[3], sub[4].to(dtype), sub[5])
    ad = (r(F, C_, s=0.03, dt=dtype), r(F, s=0.02),
          r(C_, F, s=0.02, dt=dtype), r(C_, s=0.01),
          torch.full((1,), 0.1, device="cuda"), r(1, C_, s=25.0 / C_ ** 0.5),
          r(1, s=0.1))
    E, b = moe
    experts = (r(E, C_, s=2.0 / C_ ** 0.5),
               *ms.moe_kernel_weights(r(E, C_, b, s=0.03), r(E, b, s=0.02),
                                      r(E, b, C_, s=0.02), dtype),
               r(E, C_, s=0.01), ad[4])
    return x, sub, qsub, ad, experts


def share_within(got, want, rel) -> float:
    """The share of outputs within ``rel`` of the largest |want|."""
    tol = rel * want.float().abs().max().item()
    return ((got.float() - want.float()).abs() <= tol).float().mean().item()


def forms_kernels(torch, ms, qt, _build) -> dict:
    """Each new form against its plain version at the main path's widths,
    timed beside its bound (and the library's call where one computes the
    same function)."""
    import torch.nn.functional as F
    out = {}
    f32, bf = torch.float32, torch.bfloat16
    M = F32_B * N
    gemm = 2 * M * C * 4 * C                       # qkv + proj
    attn = attn_ops(F32_B)
    adapter = 4 * M * C * FFN
    experts = 4 * M * C * MOE * FFN
    x, sub, qsub, ad, moe = forms_inputs(torch, ms, qt, dtype=f32)
    fp32 = dict(rel=F32_REL, logit_rel=F32_REL, plain_iters=5)
    out["attention_sublayer_serving:fp32"] = measure(
        "K2 fp32", lambda: ms.attention_sublayer_serving(x, *sub, heads=H),
        lambda: ms.attention_sublayer_plain(x, *sub, heads=H), ("x_mid",),
        (x, *sub), {"fp32": gemm + 2 * attn}, **fp32)
    # the float64 products (the exact core, the fp32 tails) at the FP64
    # tensor cores' peak, "fp64"
    out["dyt_prologue_serving:fp32"] = measure(
        "K3 fp32", lambda: ms.dyt_prologue_serving(x, *sub, *ad, heads=H),
        lambda: ms.dyt_prologue_plain(x, *sub, *ad, heads=H),
        ("x_mid", "adapt", "logits"), (x, *sub, *ad),
        {"fp32": gemm + 2 * attn, "fp64": adapter + 2 * M * C}, **fp32)
    out["dyt_prologue_serving_moe:fp32"] = measure(
        "K7 fp32 (4 x 64)",
        lambda: ms.dyt_prologue_serving_moe(x, *sub, *moe, *ad[5:], heads=H,
                                            tau=TAU),
        lambda: ms.dyt_prologue_moe_plain(x, *sub, *moe, *ad[5:], heads=H,
                                          tau=TAU),
        ("x_mid", "adapt", "logits"), (x, *sub, *moe, *ad[5:]),
        {"fp32": gemm + 2 * attn, "fp64": experts + 2 * M * C * (MOE + 1)},
        **fp32)
    # int8 forms with fp32 adapters: the core's fp32 output is quantized for
    # proj, so it must land on the plain version's bits (the exact core sums
    # in float64 as the plain version does); the share of outputs within
    # 1e-5 printed beside
    for key, name, call, plain, ins, ops in (
            ("dyt_prologue_serving_q8:fp32", "K6 fp32",
             lambda: qt.dyt_prologue_serving_q8(x, *qsub, *ad, heads=H),
             lambda: qt.dyt_prologue_q8_plain(x, *qsub, *ad, heads=H),
             (x, *qsub, *ad),
             {"int8": gemm, "fp64": 2 * attn + adapter + 2 * M * C}),
            ("dyt_prologue_serving_q8:fp32+q8_exact",
             "K6 fp32 with int8 scores (the exact core's int8-score mode)",
             lambda: qt.dyt_prologue_serving_q8(x, *qsub, *ad, heads=H,
                                                attn_q8=True),
             lambda: qt.dyt_prologue_q8_plain(x, *qsub, *ad, heads=H,
                                              attn_q8=True),
             (x, *qsub, *ad),
             {"int8": gemm + attn,
              "fp64": attn + adapter + 2 * M * C}),
            ("dyt_prologue_serving_q8_moe:fp32", "K8 fp32 (4 x 64)",
             lambda: qt.dyt_prologue_serving_q8_moe(
                 x, *qsub, *moe, *ad[5:], heads=H, tau=TAU),
             lambda: qt.dyt_prologue_q8_moe_plain(
                 x, *qsub, *moe, *ad[5:], heads=H, tau=TAU),
             (x, *qsub, *moe, *ad[5:]),
             {"int8": gemm,
              "fp64": 2 * attn + experts + 2 * M * C * (MOE + 1)})):
        out[key] = measure(name, call, plain, ("x_mid", "adapt", "logits"),
                           ins, ops, **fp32)
        got, want = call(), plain()
        print(f"  {name}: x_mid {share_within(got[0], want[0], F32_REL):.6f}"
              f", adapt {share_within(got[1], want[1], F32_REL):.6f} of "
              f"outputs within {F32_REL} of the largest; bit-identical: "
              f"x_mid {share_within(got[0], want[0], 0.0):.6f}, adapt "
              f"{share_within(got[1], want[1], 0.0):.6f}")
    forms_exact(torch, ms, _build, x, ad, moe)
    g = torch.Generator(device="cuda").manual_seed(20)
    qkv = torch.randn((F32_B, N, 3 * C), generator=g, device="cuda")
    qkv[..., C:2 * C] += 1.0
    # K10 on fp32 qkv: the exact core's int8-score mode at head dims 64 to
    # 256 (timed through its C entry), the SIMT int8-score form at 2 heads
    # of 384.  Both sum P V and l
    # in float64 and round once, as the plain version does, so they land on
    # its bits but where a float64 sum of another order straddles an fp32
    # rounding boundary (an output near 0 after cancellation): 12 heads of
    # 64 (the main path's) held bit for bit, the others to F32_REL, the
    # share of bit-identical outputs printed for both forms
    exact = dict(rel=0.0, plain_iters=5)
    for width, heads in ((C, H), (C, 6), (C, HD192_HEADS), (1024, 4),
                         (C, HD384_HEADS)):
        hd = width // heads
        qkv_ = torch.randn((F32_B, N, 3 * width), generator=g, device="cuda")
        qkv_[..., width:2 * width] += 1.0
        ops = {"int8": attn_ops(F32_B) * width // C,
               "fp64": attn_ops(F32_B) * width // C}
        route = qt._core_q8_route(_build.library(), N, width, heads, f32)
        res = measure(
            f"K10 fp32 head_dim {hd} (route {route}"
            + ("; bit for bit)" if hd == C // H else ")"),
            lambda: qt.attn_core_pairs_q8(qkv_, heads=heads),
            lambda: qt.attn_core_pairs_q8_plain(qkv_, heads=heads),
            ("core",), (qkv_,), ops,
            timed=(exact_q8_launch(torch, qt, qkv_, heads)
                   if route == "q8_exact" else None),
            **(exact if hd == C // H else fp32))
        same = share_within(qt.attn_core_pairs_q8(qkv_, heads=heads),
                            qt.attn_core_pairs_q8_plain(qkv_, heads=heads),
                            0.0)
        print(f"  K10 fp32 head_dim {hd}: bit-identical share {same:.8f}")
        if hd == C // H:
            out["attn_core_pairs_q8:fp32+q8_exact"] = res
        elif hd > 256:
            out["attn_core_pairs_q8:fp32"] = res
        del qkv_
    q, k, v = (t.contiguous() for t in qkv.view(F32_B, N, 3, H, C // H)
               .permute(2, 0, 3, 1, 4))
    out["mha_serving_fused:fp32"] = measure(
        "K1 fp32 (the fp32 core)", lambda: ms.mha_serving_fused(qkv, heads=H),
        lambda: ms.attn_core_pairs(qkv, heads=H), ("core",), (qkv,),
        {"fp32": 2 * attn}, library=lambda:
        F.scaled_dot_product_attention(q, k, v),
        timed=core_launch(torch, *qkv.view(F32_B, N, 3, H, C // H).permute(
            2, 0, 3, 1, 4)), **fp32)
    ld = ms.bias_row_stride(SEG_N)
    bias = (torch.randn((H, SEG_N, ld), generator=g, device="cuda")
            .to(bf)[:, :, :SEG_N])
    sq = torch.randn((1, SEG_N, 3 * C), generator=g, device="cuda")
    q9, k9, v9 = (t.contiguous() for t in sq.view(1, SEG_N, 3, H, C // H)
                  .permute(2, 0, 3, 1, 4))
    mask = bias.float().contiguous()[None]
    out["mha_windowed_fused:fp32"] = measure(
        f"K9 fp32 (B=1, N={SEG_N}; the fp32 core)",
        lambda: ms.mha_windowed_fused(sq, bias, heads=H),
        lambda: ms.mha_windowed_plain(sq, bias, heads=H), ("core",),
        (sq, bias.contiguous()), {"fp32": 2 * attn_ops(1, SEG_N)},
        library=lambda: F.scaled_dot_product_attention(q9, k9, v9,
                                                       attn_mask=mask),
        timed=core_launch(torch, *sq.view(1, SEG_N, 3, H, C // H).permute(
            2, 0, 3, 1, 4), bias=bias), **fp32)
    # the fp32 GEMM alone at the qkv product's shape, beside torch.matmul
    # with TF32 off (cuBLAS's fp32 SGEMM): a reference time
    lib = _build.library()
    a = torch.randn((M, C), generator=g, device="cuda")
    w = sub[2]
    prod = torch.empty((M, 3 * C), device="cuda")

    def hand():
        _build.check(lib, lib.dyt_gemm_f32(
            a.data_ptr(), w.data_ptr(), M, 3 * C, C, prod.data_ptr(),
            torch.cuda.current_stream().cuda_stream), "fp32 GEMM")
        return prod
    hand()
    check_close("fp32 GEMM", hand(),
                torch.matmul(a.double(), w.double().t()).float(), F32_REL)
    t_hand, t_lib = time_ms(hand), time_ms(lambda: torch.matmul(a, w.t()))
    ops = 2 * M * C * 3 * C
    b_ms, b_by = bound(nbytes(a, w, prod), {"fp32": ops})
    print(f"fp32 GEMM ({M} x {3 * C} x {C}): hand {t_hand:.4f} ms "
          f"({ops / t_hand / 1e9:.1f} TFLOP/s), torch.matmul TF32 off "
          f"{t_lib:.4f} ms ({ops / t_lib / 1e9:.1f} TFLOP/s), bound "
          f"{b_ms:.4f} ms ({b_by})")
    del a, prod, qkv, q, k, v, sq, q9, k9, v9, mask

    # bf16 at other widths and head dims, against the plain versions
    bfq = dict(plain_iters=5)
    for F_ in (8, WIDE_F, SIMT_F):
        x_, s_, qs_, ad_, _ = forms_inputs(torch, ms, qt, dtype=bf, F=F_)
        pad = (*ms.pad_adapter_weights(*ad_[:3],
                                       ms.adapter_kernel_width(F_, bf)),
               *ad_[3:])
        tail = "wide_tail" if F_ == WIDE_F else "simt_tail"
        for key, name, call, plain, ops in (
                (f"dyt_prologue_serving:bf16+{tail}", "K3",
                 lambda: ms.dyt_prologue_serving(x_, *s_, *pad, heads=H),
                 lambda: ms.dyt_prologue_plain(x_, *s_, *ad_, heads=H),
                 {"bf16": gemm + 2 * attn + 4 * M * C * F_,
                  "fp32": 2 * M * C}),
                (f"dyt_prologue_serving_q8:bf16+{tail}", "K6",
                 lambda: qt.dyt_prologue_serving_q8(x_, *qs_, *pad, heads=H),
                 lambda: qt.dyt_prologue_q8_plain(x_, *qs_, *ad_, heads=H),
                 {"int8": gemm, "bf16": 2 * attn + 4 * M * C * F_,
                  "fp32": 2 * M * C})):
            res = measure(f"{name} bf16 F={F_}" + (
                " (padded to the wgmma tail's 16)" if F_ == 8 else
                " (the MoE tail's wgmma kernel, gate-free)" if F_ == WIDE_F
                else " (the SIMT tail)"), call, plain,
                ("x_mid", "adapt", "logits"), (x_, *s_, *ad_), ops, **bfq)
            if F_ != 8:
                out[key] = res
        if F_ == WIDE_F:
            wide_tail_alone(torch, ms, _build, x_, pad, ad_)
    for (E_, b_), tag in (((2, 4), "padded to 2 x 8"),
                          (WIDE_MOE, "the wgmma tail past 512"),
                          (SIMT_MOE, "the SIMT tail")):
        x_, s_, qs_, ad_, moe_ = forms_inputs(torch, ms, qt, dtype=bf,
                                              moe=(E_, b_))
        tail_ops = {"bf16": 4 * M * C * E_ * b_, "fp32": 2 * M * C * (E_ + 1)}
        res = measure(
            f"K7 bf16 {E_} x {b_} ({tag})",
            lambda: ms.dyt_prologue_serving_moe(x_, *s_, *moe_, *ad_[5:],
                                                heads=H, tau=TAU),
            lambda: ms.dyt_prologue_moe_plain(x_, *s_, *moe_, *ad_[5:],
                                              heads=H, tau=TAU),
            ("x_mid", "adapt", "logits"), (x_, *s_, *moe_, *ad_[5:]),
            {"bf16": gemm + 2 * attn + tail_ops["bf16"],
             "fp32": tail_ops["fp32"]}, check_only=(E_, b_) == SIMT_MOE,
            **bfq)
        if (E_, b_) == WIDE_MOE:
            out["dyt_prologue_serving_moe@4x192"] = res
            out["dyt_prologue_serving_q8_moe@4x192"] = measure(
                f"K8 bf16 {E_} x {b_} ({tag})",
                lambda: qt.dyt_prologue_serving_q8_moe(
                    x_, *qs_, *moe_, *ad_[5:], heads=H, tau=TAU),
                lambda: qt.dyt_prologue_q8_moe_plain(
                    x_, *qs_, *moe_, *ad_[5:], heads=H, tau=TAU),
                ("x_mid", "adapt", "logits"), (x_, *qs_, *moe_, *ad_[5:]),
                {"int8": gemm, "bf16": 2 * attn + tail_ops["bf16"],
                 "fp32": tail_ops["fp32"]}, **bfq)
    for C_, heads in ((C, HD192_HEADS), (1024, 4), (C, HD384_HEADS)):
        hd = C_ // heads
        past = hd > 256                # the wgmma core past 256
        core = "the wgmma core past 256" if past else "the wgmma core"
        x_, s_, qs_, ad_, _ = forms_inputs(torch, ms, qt, dtype=bf, C_=C_)
        g_ = 2 * M * C_ * 4 * C_
        a_ = 2 * F32_B * heads * N * N * hd        # one product of the core
        # the cores' products take bf16 operands (K10's q.k int8): the bound
        # counts them at the bf16 (int8) tensor rate; every form is timed,
        # the kernels line holds head dims 192 and 384
        res = measure(
            f"K3 bf16 head_dim {hd} (C={C_}, {heads} heads; {core})",
            lambda: ms.dyt_prologue_serving(x_, *s_, *ad_, heads=heads),
            lambda: ms.dyt_prologue_plain(x_, *s_, *ad_, heads=heads),
            ("x_mid", "adapt", "logits"), (x_, *s_, *ad_),
            {"bf16": g_ + 2 * a_ + 4 * M * C_ * FFN, "fp32": 2 * M * C_},
            **bfq)
        res6 = measure(
            f"K6 bf16 head_dim {hd} with the int8-score core",
            lambda: qt.dyt_prologue_serving_q8(x_, *qs_, *ad_, heads=heads,
                                               attn_q8=True),
            lambda: qt.dyt_prologue_q8_plain(x_, *qs_, *ad_, heads=heads,
                                             attn_q8=True),
            ("x_mid", "adapt", "logits"), (x_, *qs_, *ad_),
            {"int8": g_ + a_, "bf16": a_ + 4 * M * C_ * FFN,
             "fp32": 2 * M * C_}, **bfq)
        qkv_ = torch.randn((F32_B, N, 3 * C_), generator=g,
                           device="cuda").to(bf)
        qkv_[..., C_:2 * C_] += 1.0
        q_, k_, v_ = qkv_.view(F32_B, N, 3, heads, hd).permute(2, 0, 3, 1, 4)
        qc, kc, vc = (t.contiguous() for t in (q_, k_, v_))
        sdpa = lambda: F.scaled_dot_product_attention(qc, kc, vc)  # noqa
        res15 = measure(
            f"K15 bf16 head_dim {hd} (views of the raw qkv; {core})",
            lambda: ms.mha_serving(q_, k_, v_),
            lambda: ms.mha_serving_plain(q_, k_, v_), ("core",), (qkv_,),
            {"bf16": 2 * a_}, library=sdpa,
            timed=core_launch(torch, q_, k_, v_, k15=True), **bfq)
        check_ulp_share(f"K15 bf16 head_dim {hd}", ms.mha_serving(q_, k_, v_),
                        ms.mha_serving_plain(q_, k_, v_))
        res1 = measure(f"K1 bf16 head_dim {hd}",
                       lambda: ms.mha_serving_fused(qkv_, heads=heads),
                       lambda: ms.attn_core_pairs(qkv_, heads=heads),
                       ("core",), (qkv_,), {"bf16": 2 * a_}, library=sdpa,
                       timed=core_launch(torch, q_, k_, v_, k15=False),
                       **bfq)
        check_ulp_share(f"K1 bf16 head_dim {hd}",
                        ms.mha_serving_fused(qkv_, heads=heads),
                        ms.attn_core_pairs(qkv_, heads=heads))
        route10 = qt._core_q8_route(_build.library(), N, C_, heads, bf)
        res10 = measure(
            f"K10 bf16 head_dim {hd} (route {route10})",
            lambda: qt.attn_core_pairs_q8(qkv_, heads=heads),
            lambda: qt.attn_core_pairs_q8_plain(qkv_, heads=heads),
            ("core",), (qkv_,), {"int8": a_, "bf16": a_}, **bfq)
        check_ulp_share(f"K10 bf16 head_dim {hd}",
                        qt.attn_core_pairs_q8(qkv_, heads=heads),
                        qt.attn_core_pairs_q8_plain(qkv_, heads=heads))
        # K9 at the seg crop (B=1, N=SEG_N) with the layer's padded bias
        sq = torch.randn((1, SEG_N, 3 * C_), generator=g,
                         device="cuda").to(bf)
        ld = ms.bias_row_stride(SEG_N)
        b9 = (torch.randn((heads, SEG_N, ld), generator=g, device="cuda")
              .to(bf)[:, :, :SEG_N])
        q9, k9, v9 = (t.contiguous() for t in sq.view(
            1, SEG_N, 3, heads, hd).permute(2, 0, 3, 1, 4))
        mask = b9.contiguous()[None]
        res9 = measure(
            f"K9 bf16 head_dim {hd} (B=1, N={SEG_N}; "
            + ("the wgmma core past 256" if past else "the wgmma ring")
            + " with the bias blocks)",
            lambda: ms.mha_windowed_fused(sq, b9, heads=heads),
            lambda: ms.mha_windowed_plain(sq, b9, heads=heads),
            ("core",), (sq, b9.contiguous()),
            {"bf16": 4 * SEG_N * SEG_N * hd * heads},
            timed=windowed_launch(torch, ms, sq, b9, heads),
            library=lambda: F.scaled_dot_product_attention(
                q9, k9, v9, attn_mask=mask), **bfq)
        check_ulp_share(f"K9 bf16 head_dim {hd}",
                        ms.mha_windowed_fused(sq, b9, heads=heads),
                        ms.mha_windowed_plain(sq, b9, heads=heads))
        if hd == 192:
            out["dyt_prologue_serving:bf16+wide_heads"] = res
            out["dyt_prologue_serving_q8:bf16+wide_heads"] = res6
            out["mha_serving:bf16+wide_heads"] = res15
            out["attn_core_pairs_q8:bf16+wide_heads"] = res10
            out["mha_windowed_fused:bf16+wide_heads"] = res9
        elif past:
            out["dyt_prologue_serving:bf16+past_256"] = res
            out["dyt_prologue_serving_q8:bf16+q8_ring"] = res6
            out["mha_serving:bf16+past_256"] = res15
            out["mha_serving_fused:bf16+past_256"] = res1
            out["mha_windowed_fused:bf16+past_256"] = res9
            out["attn_core_pairs_q8:bf16+q8_ring"] = res10
        del x_, s_, qs_, ad_, qkv_, q_, k_, v_, qc, kc, vc, sq, b9, q9, k9
        del v9, mask
        torch.cuda.empty_cache()
    # K10 on the int8-score key ring past the staged core's layout (head
    # dim 192 at N = 320, 256 at N = 300; B=32, 2 heads), held to K10's
    # bounds and timed
    for heads, hd, n in ((2, 192, 320), (2, 256, 300)):
        C_ = heads * hd
        qkv_ = torch.randn((F32_B, n, 3 * C_), generator=g,
                           device="cuda").to(bf)
        qkv_[..., C_:2 * C_] += 1.0
        route10 = qt._core_q8_route(_build.library(), n, C_, heads, bf)
        if route10 != "q8_ring":
            fail(f"K10 at head dim {hd}, N={n} routed to {route10}")
        a_ = 2 * F32_B * heads * n * n * hd
        measure(f"K10 bf16 head_dim {hd}, N={n} (route {route10})",
                lambda: qt.attn_core_pairs_q8(qkv_, heads=heads),
                lambda: qt.attn_core_pairs_q8_plain(qkv_, heads=heads),
                ("core",), (qkv_,), {"int8": a_, "bf16": a_}, **bfq)
        check_ulp_share(f"K10 bf16 head_dim {hd}, N={n}",
                        qt.attn_core_pairs_q8(qkv_, heads=heads),
                        qt.attn_core_pairs_q8_plain(qkv_, heads=heads))
        del qkv_
    # fp32 past head dim 256 (2 heads of 384, the fp32 core past 256): K1
    # beside SDPA in fp32 (TF32 off), K9 at the seg crop beside SDPA with
    # the bias as its mask, K3
    heads, hd = HD384_HEADS, C // HD384_HEADS
    qkv_ = torch.randn((F32_B, N, 3 * C), generator=g, device="cuda")
    qkv_[..., C:2 * C] += 1.0
    q_, k_, v_ = (t.contiguous() for t in qkv_.view(
        F32_B, N, 3, heads, hd).permute(2, 0, 3, 1, 4))
    out["mha_serving_fused:fp32+past_256"] = measure(
        f"K1 fp32 head_dim {hd} (the fp32 core past 256)",
        lambda: ms.mha_serving_fused(qkv_, heads=heads),
        lambda: ms.attn_core_pairs(qkv_, heads=heads), ("core",), (qkv_,),
        {"fp32": 2 * attn}, library=lambda: F.scaled_dot_product_attention(
            q_, k_, v_), rel=F32_REL, plain_iters=5)
    sq = torch.randn((1, SEG_N, 3 * C), generator=g, device="cuda")
    sq[..., C:2 * C] += 1.0
    ld = ms.bias_row_stride(SEG_N)
    b9 = (torch.randn((heads, SEG_N, ld), generator=g, device="cuda")
          .to(bf)[:, :, :SEG_N])
    q9, k9, v9 = (t.contiguous() for t in sq.view(
        1, SEG_N, 3, heads, hd).permute(2, 0, 3, 1, 4))
    mask = b9.float().contiguous()[None]
    out["mha_windowed_fused:fp32+past_256"] = measure(
        f"K9 fp32 head_dim {hd} (B=1, N={SEG_N}; the fp32 core past 256)",
        lambda: ms.mha_windowed_fused(sq, b9, heads=heads),
        lambda: ms.mha_windowed_plain(sq, b9, heads=heads), ("core",),
        (sq, b9.contiguous()), {"fp32": 4 * SEG_N * SEG_N * C},
        library=lambda: F.scaled_dot_product_attention(q9, k9, v9,
                                                       attn_mask=mask),
        rel=F32_REL, plain_iters=5)
    out["dyt_prologue_serving:fp32+past_256"] = measure(
        f"K3 fp32 head_dim {hd}",
        lambda: ms.dyt_prologue_serving(x, *sub, *ad, heads=heads),
        lambda: ms.dyt_prologue_plain(x, *sub, *ad, heads=heads),
        ("x_mid", "adapt", "logits"), (x, *sub, *ad),
        {"fp32": gemm + 2 * attn, "fp64": adapter + 2 * M * C}, **fp32)
    del qkv_, q_, k_, v_, sq, b9, q9, k9, v9, mask
    torch.cuda.empty_cache()
    forms_past_256(torch, ms, qt, _build)
    return out


def wide_tail_alone(torch, ms, _build, x_, pad, ad_) -> None:
    """The adapter/router tail at WIDE_F alone on ViT-B/16 rows (B=32): the
    MoE tail's wgmma kernel gate-free through its C entry, against the plain
    tail on the unpadded weights, beside its bound."""
    lib = _build.library()
    xm = x_.float()
    adapt = torch.empty_like(x_)
    lw = torch.empty((F32_B, N, 1), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    M, F_ = F32_B * N, pad[0].shape[0]
    if ms._adapter_tail(pad[0]) != "wide":
        fail(f"the adapter tail at F={F_} is not on the wide tail")

    def entry():
        _build.check(lib, lib.dyt_moe_adapter_router(
            xm.data_ptr(), M, C, None, *(t.data_ptr() for t in pad),
            adapt.data_ptr(), 0, lw.data_ptr(), 1, F_, 1.0, stream),
            "wide adapter tail")
        return adapt, lw
    measure(f"adapter tail bf16 F={F_} alone (gate-free wgmma; C entry)",
            entry, lambda: ms.adapter_router_plain(
                xm, torch.bfloat16, *ad_, with_select=True)[1:],
            ("adapt", "logits"), (xm, *pad),
            {"bf16": 4 * M * C * F_, "fp32": 2 * M * C}, plain_iters=5)


def forms_exact(torch, ms, _build, x, ad, moe) -> None:
    """The two parts of the exact fp32 route on the FP64 tensor cores,
    each alone against its plain version bit for bit and timed beside its
    bound: the exact core (K6's and K8's core with fp32 adapters) at head
    dims 64, 128, 192 and 256 (B=32, N=197; C=768 in 12, 6 and 4 heads,
    C=1024 in 4), and the float64 tail with fp32 weights (the adapter, F=64,
    and the MoE tail, 4 x 64, both with the token router) on fp32 rows of
    ViT-B/16 width (B=32, N=197); the MoE tail with 200 experts of 1 is
    checked, not timed."""
    lib = _build.library()
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device="cuda").manual_seed(23)
    exact = dict(rel=0.0, logit_rel=0.0, plain_iters=5)
    for width, heads in ((C, H), (C, 6), (C, HD192_HEADS), (1024, 4)):
        hd = width // heads
        qkv = torch.randn((F32_B, N, 3 * width), generator=g, device="cuda")
        qkv[..., width:2 * width] += 1.0
        out = torch.empty((F32_B, N, width), device="cuda")

        def core(qkv=qkv, out=out, heads=heads, width=width, hd=hd):
            _build.check(lib, lib.dyt_exact_core(
                qkv.data_ptr(), out.data_ptr(), F32_B, N, width, heads,
                hd ** -0.5, stream), "exact core")
            return out
        measure(f"exact core head_dim {hd} (DMMA; bit for bit)", core,
                lambda qkv=qkv, heads=heads: ms.attn_core_pairs(
                    qkv, heads=heads),
                ("core",), (qkv,),
                {"fp64": 4 * F32_B * heads * N * N * hd}, **exact)
        del qkv, out
    M = F32_B * N
    xm = x.reshape(F32_B, N, C)
    f32 = torch.float32
    measure("fp32 adapter tail (F=64, router; DMMA; bit for bit)",
            lambda: ms.launch_adapter_router(lib, xm, xm, *ad, True)[1:],
            lambda: ms.adapter_router_plain(xm, f32, *ad,
                                            with_select=True)[1:],
            ("adapt", "logits"), (xm, *ad),
            {"fp64": 4 * M * C * FFN + 2 * M * C}, **exact)
    measure(f"fp32 MoE tail ({MOE} x {FFN}, router; DMMA; bit for bit)",
            lambda: ms.launch_moe_adapter_router(lib, xm, xm, *moe, *ad[5:],
                                                 TAU, True)[1:],
            lambda: ms.moe_adapter_router_plain(
                xm, f32, *moe, *ad[5:], experts=MOE, bneck=FFN, tau=TAU,
                with_select=True)[1:],
            ("adapt", "logits"), (xm, *moe, *ad[5:]),
            {"fp64": 4 * M * C * MOE * FFN + 2 * M * C * (MOE + 1)},
            **exact)
    # more router columns than one round of the kernel's (192): the router
    # rounds come first, the softmax after the last of them
    E2, b2 = 200, 1

    def w(*shape, sc):
        return torch.randn(shape, generator=g, device="cuda") * sc
    many = (w(E2, C, sc=2.0 / C ** 0.5),
            *ms.moe_kernel_weights(w(E2, C, b2, sc=0.03), w(E2, b2, sc=0.02),
                                   w(E2, b2, C, sc=0.02), f32),
            w(E2, C, sc=0.01), moe[-1])
    measure(f"fp32 MoE tail ({E2} x {b2}, router; DMMA; bit for bit)",
            lambda: ms.launch_moe_adapter_router(lib, xm, xm, *many, *ad[5:],
                                                 TAU, True)[1:],
            lambda: ms.moe_adapter_router_plain(
                xm, f32, *many, *ad[5:], experts=E2, bneck=b2, tau=TAU,
                with_select=True)[1:],
            ("adapt", "logits"), (xm, *many, *ad[5:]), {}, check_only=True,
            **exact)


def forms_past_256(torch, ms, qt, _build) -> None:
    """Every core form at 2 heads of 320 (the wgmma core past 256 and the
    fp32 core's; with int8 scores and on the exact route the SIMT core's
    64-column slices) and of 832 (past ms.WIDE_MAX_HD: every form on the
    slices) against its plain version, checked and not timed: bf16 and
    fp32 K1, K9 (bias), K10 and the sublayer chains K2, K3, K7, K5, K6, K8
    (with and without int8 scores; at 320 only: the int8 chains take C up
    to 1024), K15, and the exact route's slices kernel bit for bit."""
    f32, bf = torch.float32, torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(32)
    lib = _build.library()
    for hd, dt in ((320, bf), (320, f32), (832, bf), (832, f32)):
        heads, Bq, Nq = 2, 4, N
        C_ = heads * hd
        qkv = torch.randn((Bq, Nq, 3 * C_), generator=g, device="cuda")
        qkv[..., C_:2 * C_] += 1.0
        qkv = qkv.to(dt)
        rel = dict(rel=F32_REL) if dt == f32 else {}
        tag = f"hd {hd} {'fp32' if dt == f32 else 'bf16'}"
        bias = torch.randn((heads, Nq, Nq), generator=g,
                           device="cuda").to(bf)
        for name, call, plain in (
                ("K1", lambda: ms.mha_serving_fused(qkv, heads=heads),
                 lambda: ms.attn_core_pairs(qkv, heads=heads)),
                ("K9", lambda: ms.mha_windowed_fused(qkv, bias, heads=heads),
                 lambda: ms.mha_windowed_plain(qkv, bias, heads=heads))):
            measure(f"{name} {tag}", call, plain, ("core",), (qkv,), {},
                    check_only=True, **rel)
        measure(f"K10 {tag}", lambda: qt.attn_core_pairs_q8(qkv, heads=heads),
                lambda: qt.attn_core_pairs_q8_plain(qkv, heads=heads),
                ("core",), (qkv,), {}, check_only=True)
        if dt == bf:
            q_, k_, v_ = qkv.view(Bq, Nq, 3, heads, hd).permute(2, 0, 3, 1, 4)
            measure(f"K15 {tag}", lambda: ms.mha_serving(q_, k_, v_),
                    lambda: ms.mha_serving_plain(q_, k_, v_), ("core",),
                    (qkv,), {}, check_only=True)
        else:
            out = torch.empty((Bq, Nq, C_), device="cuda")
            _build.check(lib, lib.dyt_simt_core_exact(
                qkv.data_ptr(), out.data_ptr(), Bq, Nq, C_, heads,
                hd ** -0.5, torch.cuda.current_stream().cuda_stream),
                "exact SIMT core")
            same = torch.equal(out, ms.attn_core_pairs(qkv, heads=heads))
            print(f"exact SIMT core {tag}: bit-identical to the plain "
                  f"version: {same}")
            if not same:
                fail(f"exact SIMT core {tag} differs from its plain version")
        x_, s_, qs_, ad_, moe_ = forms_inputs(torch, ms, qt, dtype=dt,
                                              batch=Bq, C_=C_)
        for name, call, plain, outs in (
                ("K2", lambda: ms.attention_sublayer_serving(
                    x_, *s_, heads=heads),
                 lambda: ms.attention_sublayer_plain(x_, *s_, heads=heads),
                 ("x_mid",)),
                ("K3", lambda: ms.dyt_prologue_serving(x_, *s_, *ad_,
                                                       heads=heads),
                 lambda: ms.dyt_prologue_plain(x_, *s_, *ad_, heads=heads),
                 ("x_mid", "adapt", "logits")),
                ("K7", lambda: ms.dyt_prologue_serving_moe(
                    x_, *s_, *moe_, *ad_[5:], heads=heads, tau=TAU),
                 lambda: ms.dyt_prologue_moe_plain(
                     x_, *s_, *moe_, *ad_[5:], heads=heads, tau=TAU),
                 ("x_mid", "adapt", "logits"))):
            measure(f"{name} {tag}", call, plain, outs, (x_,), {},
                    check_only=True, **(dict(rel=F32_REL, logit_rel=F32_REL)
                                        if dt == f32 else {}))
        for q8 in (False, True) if C_ <= 1024 else ():
            kw = dict(heads=heads, attn_q8=q8)
            q8rel = dict(rel=F32_REL, logit_rel=F32_REL) if dt == f32 else {}
            if dt == bf:
                measure(f"K5 {tag} attn_q8={q8}",
                        lambda: qt.attention_sublayer_serving_q8(x_, *qs_,
                                                                 **kw),
                        lambda: qt.attention_sublayer_q8_plain(x_, *qs_,
                                                               **kw),
                        ("x_mid",), (x_,), {}, check_only=True)
            measure(f"K6 {tag} attn_q8={q8}",
                    lambda: qt.dyt_prologue_serving_q8(x_, *qs_, *ad_, **kw),
                    lambda: qt.dyt_prologue_q8_plain(x_, *qs_, *ad_, **kw),
                    ("x_mid", "adapt", "logits"), (x_,), {}, check_only=True,
                    **q8rel)
            measure(f"K8 {tag} attn_q8={q8}",
                    lambda: qt.dyt_prologue_serving_q8_moe(
                        x_, *qs_, *moe_, *ad_[5:], tau=TAU, **kw),
                    lambda: qt.dyt_prologue_q8_moe_plain(
                        x_, *qs_, *moe_, *ad_[5:], tau=TAU, **kw),
                    ("x_mid", "adapt", "logits"), (x_,), {}, check_only=True,
                    **q8rel)
    torch.cuda.empty_cache()


def forms_compare(torch, ms, qt, fm, res, run, kwargs, fp32: bool) -> None:
    """A forward of the phase against the plain-version forward: logits
    within F32_MODEL_REL (fp32) or MODEL_REL (bf16) of their largest, gates
    (dispatch) agreeing on F32_GATE_AGREE or GATE_AGREE of the tokens, each
    differing gate printed with its distances from its boundaries."""
    model, x = res["model"], res["x"]
    with plain_versions(ms, qt, fm), torch.inference_mode():
        ref, ref_aux = model(x, **kwargs)
    err, mag = rel_err(res["logits"], ref)
    tol = (F32_MODEL_REL if fp32 else MODEL_REL) * mag
    line = f"{run} vs plain versions: logits max|err| {err:.6g} (tol {tol:.6g})"
    agree = 1.0
    if res["aux"]["token_select"] is not None:
        eq = res["aux"]["token_select"] == ref_aux["token_select"]
        agree = eq.float().mean().item()
        line += f", gate agreement {agree:.6f}"
        if kwargs.get("dispatch"):
            flips = gate_flips(torch, res["aux"], ref_aux, K_DISPATCH)
            if flips:
                line += ("; differing gates (block, threshold distance, band,"
                         " capacity distance, band; bf16 ulps): " + ", ".join(
                             f"({f[0]}, {f[1]:.3g}, {f[2]:.3g}, {f[3]:.3g},"
                             f" {f[4]:.3g})" for f in flips[:12]))
    print(line)
    if err > tol or agree < (F32_GATE_AGREE if fp32 else GATE_AGREE):
        fail(f"{run} forward disagrees with the plain-version forward")


def unlisted_forms(ms, qt, fm) -> dict:
    """Launches since the counts were set to 0 in a (wrapper, form) that
    KERNELS does not list (a bf16 head dim 192 launch on the SIMT core, say):
    read_counts cannot see them."""
    mods = count_modules(ms, qt, fm)
    listed = {(m, k.partition(":")[0], k.partition(":")[2] or "bf16")
              for k, (m, _) in KERNELS.items()}
    out = {}
    for m, mod in mods.items():
        for name in dir(mod):
            forms = getattr(getattr(mod, name), "forms", None)
            if not isinstance(forms, dict):
                continue
            for form, n in forms.items():
                if n and (m, name, form) not in listed:
                    out[f"{name}:{form}"] = n
    return out


def forms_counts(ms, qt, fm, run, kernels, forwards=None) -> dict:
    """The launches since the counts were set to 0: DEPTH a forward of each
    of ``kernels`` and none of the others, in any form (``forwards`` None:
    as many forwards as the first of ``kernels`` shows, at least one); a
    "name@width" entry of ``kernels`` stands for its wrapper's bf16 form
    and gets its launches."""
    counts = read_counts(ms, qt, fm)
    base = [k.partition("@")[0] for k in kernels]
    if forwards is None:
        forwards = max(counts[base[0]] // DEPTH, 1)
    want = {k: DEPTH * forwards if k in base else 0 for k in KERNELS}
    if counts != want:
        fail(f"{run}: kernel launches {counts}, want {want}")
    extra = unlisted_forms(ms, qt, fm)
    if extra:
        fail(f"{run}: launches in forms the run does not list: {extra}")
    for k, b in zip(kernels, base):
        counts[k] = counts[b]
    return counts


def forms_main_path(torch, ms, qt, fm, speed, predict, config,
                    sds) -> dict:
    """The main path of every new form, through the entry points: speed.main
    in fp32 (dispatch, dense, plain, int8, int8_attn, MoE) and at the bf16
    widths; a bf16 ViT at head dims 192 and 384; the BEiT backbone at head
    dim 192 (K9); predict.serve at head dims 192 and 384 (--quant none:
    K15, at 192 its forward against the plain versions'; int8_attn: K6 and
    K10); main_image, main_vtab and main_video in fp32 (short runs, each
    with a dispatch evaluation); an fp32 seg crop evaluation (K9); the fp32
    LayerScale backbone (K1).  Launches counted for each, the counts set
    to 0 just before."""
    import shutil

    from dynamic_tuning_tpu_torch import main_image, seg_train
    from dynamic_tuning_tpu_torch.checkpoint import load_timm_state_dict
    from dynamic_tuning_tpu_torch.data import datasets
    from dynamic_tuning_tpu_torch.models import fast_inference as fast
    from dynamic_tuning_tpu_torch.models import seg_vit
    from dynamic_tuning_tpu_torch.models.vit import VisionTransformer
    from dynamic_tuning_tpu_torch.ops import dispatch as D
    launches = {k: 0 for k in KERNELS}
    ips = {}
    for flags, batch, sd, kernels, compare in FORM_RUNS:
        args = speed.get_args_parser().parse_args(
            flags + ["--batch_size", str(batch), "--moe_router_tau", str(TAU),
                     "--warmup", "1", "--iters", "1"])
        t0 = time.perf_counter()
        reset_counts(ms, qt, fm)
        res = speed_run(torch, speed, args, None if sd is None else sds[sd])
        run = "speed " + " ".join(flags) + f" (batch {batch})"
        counts = forms_counts(ms, qt, fm, run, kernels, res["forwards"])
        for k in KERNELS:
            launches[k] += counts[k]
        if not torch.isfinite(res["logits"]).all():
            fail(f"{run}: logits not finite")
        ips[run] = res["throughput_img_s"]
        print(f"{run}: {res['throughput_img_s']} img/s; launches per "
              "forward: " + ", ".join(f"{k} {counts[k] // res['forwards']}"
                                      for k in kernels))
        if compare:
            forms_compare(torch, ms, qt, fm, res, run,
                          dict(complete_model=args.mode == "dense",
                               dispatch=args.mode == "dispatch"),
                          compare == "fp32")
        print(f"  ({time.perf_counter() - t0:.1f} s)")
        del res
        torch.cuda.empty_cache()
    # a bf16 ViT-B/16 at head dims 192 (4 heads: the wgmma core) and 384 (2
    # heads: the wgmma core past 256): the model's forward (its init draws
    # skipped: every parameter is loaded, checked)
    g = torch.Generator(device="cuda").manual_seed(21)
    x = torch.randn((F32_B, 224, 224, 3), generator=g, device="cuda")
    for heads, form in ((HD192_HEADS, "wide_heads"),
                        (HD384_HEADS, "past_256")):
        t0 = time.perf_counter()
        cfg = config.ModelConfig(num_classes=100, num_heads=heads,
                                 gelu_approx=True, residual_dtype="bfloat16")
        with mock.patch.object(torch.nn.init, "trunc_normal_",
                               lambda t, *a, **k: t):
            model = VisionTransformer(cfg, tuning=config.TuningConfig(),
                                      select=config.SelectConfig(
                                          token_target_ratio=0.5),
                                      dtype=torch.bfloat16)
        missing, _ = load_timm_state_dict(model, {
            k: torch.from_numpy(v) for k, v in sds[0].items()},
            log=lambda m: None)
        if missing:
            fail(f"head dim {C // heads} ViT: {len(missing)} parameters not "
                 "loaded")
        model = model.cuda().eval()
        reset_counts(ms, qt, fm)
        with torch.inference_mode():
            logits, aux = model(x, dispatch=True)
        run = f"ViT-B/16 bf16 head_dim {C // heads} dispatch"
        counts = forms_counts(ms, qt, fm, run,
                              (f"dyt_prologue_serving:bf16+{form}",), 1)
        for k in KERNELS:
            launches[k] += counts[k]
        forms_compare(torch, ms, qt, fm, dict(model=model, x=x,
                                              logits=logits, aux=aux), run,
                      dict(dispatch=True), False)
        with torch.inference_mode():
            t_fwd = time_ms(lambda: model(x, dispatch=True), iters=10)
        print(f"{run}: {F32_B / t_fwd * 1e3:.2f} img/s at batch {F32_B} "
              f"({t_fwd:.4f} ms a forward) "
              f"({time.perf_counter() - t0:.1f} s)")
        del model
    # the BEiT backbone (K9 in every block) on one 512^2 crop, dispatch,
    # against its plain-version forward: bf16 at head dim 192 (the wgmma
    # ring) and 384 (the wgmma core past 256), fp32 at 384 (the fp32 core
    # past 256)
    for heads, dtype, key, rel, agree_min in (
            (HD192_HEADS, torch.bfloat16,
             "mha_windowed_fused:bf16+wide_heads", MODEL_REL, GATE_AGREE),
            (HD384_HEADS, torch.bfloat16,
             "mha_windowed_fused:bf16+past_256", MODEL_REL, GATE_AGREE),
            (HD384_HEADS, torch.float32,
             "mha_windowed_fused:fp32+past_256", F32_MODEL_REL,
             F32_GATE_AGREE)):
        t0 = time.perf_counter()
        kind = "bfloat16" if dtype == torch.bfloat16 else "float32"
        cfg = config.ModelConfig(img_size=SEG_HD192_IMG, num_heads=heads,
                                 gelu_approx=True, residual_dtype=kind)
        model = seg_vit.beit_backbone(
            cfg, config.TuningConfig(), config.SelectConfig(
                token_target_ratio=0.5), dtype=dtype,
            generator=torch.Generator().manual_seed(1)).cuda().eval()
        xs = torch.randn((1, SEG_HD192_IMG, SEG_HD192_IMG, 3), generator=g,
                         device="cuda")
        reset_counts(ms, qt, fm)
        scores = []
        with routing(D, record=scores), torch.inference_mode():
            feats, aux = model(xs, dispatch=True)
        run = f"beit_backbone {kind} head_dim {C // heads}"
        counts = forms_counts(ms, qt, fm, run, (key,), 1)
        for k in KERNELS:
            launches[k] += counts[k]
        # the plain-version forward free (its gates) and on the kernels'
        # dispatch (its features), as phase 6 holds the BEiT backbone
        with plain_versions(ms, qt, fm), torch.inference_mode():
            _, free_aux = model(xs, dispatch=True)
        with (routing(D, replay=scores), plain_versions(ms, qt, fm),
              torch.inference_mode()):
            ref, _ = model(xs, dispatch=True)
        agree = (aux["token_select"] == free_aux["token_select"]).float(
        ).mean().item()
        worst = max(rel_err(f, r)[0] / rel_err(f, r)[1]
                    for f, r in zip(feats, ref))
        print(f"{run} ({SEG_HD192_IMG}^2, dispatch): {DEPTH} K9 launches; "
              f"gate agreement with the plain-version forward {agree:.6f}; "
              f"features vs plain versions on the same dispatch: max rel "
              f"err {worst:.3g} (tol {rel:g}) "
              f"({time.perf_counter() - t0:.1f} s)")
        if (not all(torch.isfinite(f).all() for f in feats) or worst > rel
                or agree < agree_min):
            fail(f"{run} disagrees with its plain versions")
        del model, feats, ref
    # predict.serve at head dims 192 and 384: the fast path (K15) and
    # int8_attn (K6 and K10)
    t0 = time.perf_counter()
    canv = torch.randint(0, 256, (F32_B, 256, 256, 3), generator=g,
                         device="cuda", dtype=torch.uint8)
    sd = {k: torch.from_numpy(v) for k, v in sds[0].items()}
    for heads, form, q8_form in ((HD192_HEADS, "wide_heads", "wide_heads"),
                                 (HD384_HEADS, "past_256", "q8_ring")):
        for quant, kernels in (
                ("none", (f"mha_serving:bf16+{form}",)),
                ("int8_attn", (f"dyt_prologue_serving_q8:bf16+{q8_form}",
                               f"attn_core_pairs_q8:bf16+{q8_form}",
                               "q8_ln_mlp"))):
            a = predict.get_args_parser().parse_args(
                ["--ckpt", "unused", "--images", "unused", "--num_heads",
                 str(heads), "--quant", quant, "--batch_size", str(F32_B)])
            params = predict.load_params(a, torch.device("cuda"),
                                         state_dict=sd)
            reset_counts(ms, qt, fm)
            with contextlib.redirect_stdout(io.StringIO()):
                results = predict.serve(a, canv, params)
            run = f"predict.serve head_dim {C // heads} quant={quant}"
            counts = forms_counts(ms, qt, fm, run, kernels)
            for k in KERNELS:
                launches[k] += counts[k]
            if len(results) != F32_B:
                fail(f"{run}: {len(results)} results")
            print(f"{run}: {len(results)} canvases, {DEPTH} launches of "
                  f"{', '.join(kernels)} a forward "
                  f"({time.perf_counter() - t0:.1f} s since the first)")
            if quant == "int8_attn" and heads == HD384_HEADS:
                # its model's forward on the int8-score key ring, against
                # the plain versions'
                with torch.inference_mode():
                    logits, aux = params(x, dispatch=True)
                forms_compare(torch, ms, qt, fm,
                              dict(model=params, x=x, logits=logits,
                                   aux=aux), f"{run}: its model",
                              dict(dispatch=True), False)
            if quant == "none" and heads == HD192_HEADS:
                # the forward predict.serve runs, against the plain
                # versions'
                cfg_, tuning_, sel_ = predict.configs(a)

                def fwd():
                    return fast.fast_vit_forward(
                        params, x, cfg=cfg_, tuning=tuning_, select=sel_,
                        mode="dispatch", use_kernel=False)
                with torch.inference_mode():
                    logits, gates = fwd()
                    with plain_versions(ms, qt, fm):
                        ref, ref_gates = fwd()
                err, mag = rel_err(logits, ref)
                agree = (gates == ref_gates).float().mean().item()
                print(f"  its forward vs plain versions: logits max|err| "
                      f"{err:.6g} (tol {MODEL_REL * mag:.6g}), gate "
                      f"agreement {agree:.6f}")
                if err > MODEL_REL * mag or agree < GATE_AGREE:
                    fail(f"{run}: the forward disagrees with the "
                         "plain-version forward")
            del params
    # main_image in fp32: 2 training steps, an evaluation on the dispatch
    # path (64 synthetic images of each split, batch 32)
    root = os.path.join(REPO, "build", "phase_forms")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    ft = os.path.join(root, "ft64.pth")
    torch.save(sd, ft)
    real = datasets.SyntheticDataset
    flags = ["--dataset", "synthetic", "--batch_size", str(F32_B),
             "--epochs", "1", "--warmup_epochs", "1", "--no_auto_remove",
             "--compute_dtype", "float32", "--eval_dispatch", "--finetune",
             ft, "--output_dir", os.path.join(root, "image")]
    reset_counts(ms, qt, fm)
    t0 = time.perf_counter()
    with mock.patch.object(datasets, "SyntheticDataset",
                           lambda n, *a, **kw: real(min(n, 2 * F32_B), *a,
                                                    **kw)):
        stats = main_image.main(main_image.get_args_parser().parse_args(
            flags))
    counts = forms_counts(ms, qt, fm, "main_image fp32",
                          ("dyt_prologue_serving:fp32",))
    for k in KERNELS:
        launches[k] += counts[k]
    if not 0.0 <= stats["max_metric"] <= 100.0:
        fail(f"main_image fp32: run stats {stats}")
    print(f"main_image fp32: 2 steps of {F32_B} and an evaluation of "
          f"{2 * F32_B} images on the dispatch path in "
          f"{time.perf_counter() - t0:.1f} s, acc1 {stats['max_metric']}, "
          f"{counts['dyt_prologue_serving:fp32']} K3 fp32 launches "
          f"({DEPTH} a forward)")
    # main_vtab and main_video in fp32 (the VTAB recipe's one epoch on 64
    # synthetic images; one epoch of 32 synthetic clips of 8 frames and a
    # 3-view evaluation of 16), each with a dispatch evaluation
    import numpy as np

    from dynamic_tuning_tpu_torch import main_video, main_vtab
    from dynamic_tuning_tpu_torch.checkpoint import make_vit_state_dict
    from dynamic_tuning_tpu_torch.data import video as vdata
    real_v = vdata.DummyVideoDataset
    ft16 = os.path.join(root, "ft16.pth")        # the VTAB recipe's F = 16
    torch.save({k: torch.from_numpy(v) for k, v in make_vit_state_dict(
        np.random.RandomState(0), depth=DEPTH, dim=C, ffn=16, classes=100,
        img=224, patch=16, router_scale=25.0).items()}, ft16)
    for name, main, patch, flags in (
            ("main_vtab fp32", main_vtab,
             mock.patch.object(datasets, "SyntheticDataset",
                               lambda n, *a, **kw: real(min(n, 2 * F32_B),
                                                        *a, **kw)),
             ["--task", "synthetic", "--epochs", "1", "--finetune", ft16]),
            ("main_video fp32", main_video,
             mock.patch.object(vdata, "DummyVideoDataset",
                               lambda n, *a, **kw: real_v(
                                   min(n, 32 if n > 64 else 16), *a, **kw)),
             ["--dataset", "synthetic", "--batch_size", "16", "--epochs",
              "1", "--warmup_epochs", "1", "--no_auto_remove", "--finetune",
              ft])):
        reset_counts(ms, qt, fm)
        t0 = time.perf_counter()
        with patch:
            stats = main.main(main.get_args_parser().parse_args(
                flags + ["--compute_dtype", "float32", "--eval_dispatch",
                         "--output_dir", os.path.join(root,
                                                      name.split()[0])]))
        counts = forms_counts(ms, qt, fm, name,
                              ("dyt_prologue_serving:fp32",))
        for k in KERNELS:
            launches[k] += counts[k]
        stats = stats.get("synthetic", stats)      # main_vtab: by task
        acc = stats.get("max_metric", stats.get("acc1"))
        if acc is None or not 0.0 <= acc <= 100.0:
            fail(f"{name}: run stats {stats}")
        print(f"{name}: trained and evaluated on the dispatch path in "
              f"{time.perf_counter() - t0:.1f} s, acc1 {acc}, "
              f"{counts['dyt_prologue_serving:fp32']} K3 fp32 launches")
    # an fp32 seg crop evaluation (slide inference of one synthetic image)
    args = seg_train.get_args_parser().parse_args(
        ["--dataset", "synthetic", "--crop_size", "512", "--compute_dtype",
         "float32", "--eval", "--output_dir", os.path.join(root, "seg")])
    t0 = time.perf_counter()
    runner = seg_train.build_runner(args, log=lambda m: None)
    reset_counts(ms, qt, fm)
    seg_stats = runner.evaluate(max_images=1)
    counts = forms_counts(ms, qt, fm, "seg fp32 evaluation",
                          ("mha_windowed_fused:fp32",))
    for k in KERNELS:
        launches[k] += counts[k]
    print(f"seg fp32 evaluation of 1 image: "
          f"{counts['mha_windowed_fused:fp32'] // DEPTH} crops, {DEPTH} K9 "
          f"fp32 launches a crop, mIoU {seg_stats['miou']} "
          f"({time.perf_counter() - t0:.1f} s with the build)")
    del runner
    shutil.rmtree(root, ignore_errors=True)
    # the LayerScale / q-v-bias backbone without windows (K1): fp32 in 12
    # heads of 64 (the fp32 core) and 2 of 384 (the fp32 core past 256),
    # bf16 in 2 heads of 384 (the wgmma core past 256)
    for heads, dtype, key, rel in (
            (H, torch.float32, "mha_serving_fused:fp32", F32_MODEL_REL),
            (HD384_HEADS, torch.float32, "mha_serving_fused:fp32+past_256",
             F32_MODEL_REL),
            (HD384_HEADS, torch.bfloat16, "mha_serving_fused:bf16+past_256",
             MODEL_REL)):
        t0 = time.perf_counter()
        kind = "bfloat16" if dtype == torch.bfloat16 else "float32"
        cfg = config.ModelConfig(img_size=LS_IMG, num_heads=heads,
                                 gelu_approx=True, residual_dtype=kind)
        model = seg_vit.SegVisionTransformer(
            cfg, config.TuningConfig(), config.SelectConfig(
                token_target_ratio=0.5), use_rel_pos_bias=False,
            init_values=0.1, qv_bias_only=True, dtype=dtype,
            generator=torch.Generator().manual_seed(0)).cuda().eval()
        x = torch.randn((LS_BATCH, LS_IMG, LS_IMG, 3), generator=g,
                        device="cuda")
        run = f"{kind} LayerScale backbone head_dim {C // heads}"
        reset_counts(ms, qt, fm)
        with torch.inference_mode():
            feats, _ = model(x, complete_model=True)
        counts = forms_counts(ms, qt, fm, run, (key,), 1)
        for k in KERNELS:
            launches[k] += counts[k]
        with plain_versions(ms, qt, fm), torch.inference_mode():
            ref, _ = model(x, complete_model=True)
        worst = max(rel_err(f, r)[0] / rel_err(f, r)[1]
                    for f, r in zip(feats, ref))
        print(f"{run} ({LS_IMG}^2, batch {LS_BATCH}, dense): {DEPTH} K1 "
              f"launches; features vs plain versions max rel err "
              f"{worst:.3g} (tol {rel:g}) ({time.perf_counter() - t0:.1f} s)")
        if not all(torch.isfinite(f).all() for f in feats) or worst > rel:
            fail(f"{run} disagrees with its plain versions")
        del model, feats, ref
    print(json.dumps({"fp32_img_s": {k: v for k, v in ips.items()
                                     if "float32" in k}}))
    return launches


def phase_forms(torch, ms, qt, fm, speed, predict, config, _build,
                sds) -> tuple:
    """Phase 16: the fp32 forms, adapter and MoE widths and head dims 192,
    256 and past 256.  Returns (measured, launches) of the FORMS
    entries."""
    t0 = time.perf_counter()
    measured = forms_kernels(torch, ms, qt, _build)
    print(f"phase forms, kernel checks: {time.perf_counter() - t0:.1f} s")
    launches = forms_main_path(torch, ms, qt, fm, speed, predict, config,
                               sds)
    print(f"phase forms: {time.perf_counter() - t0:.1f} s")
    return measured, launches


def main() -> None:
    # the port's timing, bound and card helpers serve every phase
    global bound, card_line, time_ms
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, REPO)
    try:
        import numpy as np

        from dynamic_tuning_tpu_torch import (bench, config, predict,
                                              seg_train, speed)
        from dynamic_tuning_tpu_torch.checkpoint import (
            load_timm_state_dict, make_seg_state_dict, make_vit_state_dict)
        from dynamic_tuning_tpu_torch.models import fast_inference as fast
        from dynamic_tuning_tpu_torch.models import (layers, seg_vit, upernet,
                                                     vit)
        from dynamic_tuning_tpu_torch.ops import _build
        from dynamic_tuning_tpu_torch.ops import dispatch as D
        from dynamic_tuning_tpu_torch.ops import fused_mlp as fm
        from dynamic_tuning_tpu_torch.ops import mha_serving as ms
        from dynamic_tuning_tpu_torch.ops import quant as qt
        from dynamic_tuning_tpu_torch.utils import profile_int8 as pi
        from dynamic_tuning_tpu_torch.utils.profiling import (
            bound_ms as bound, card_line, forwards_run, scan_throughput,
            time_ms)
    except ImportError as e:
        fail(f"the port is not here: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _build.library()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_seconds} s; by source: "
          + ", ".join(f"{k} {v}" for k, v in sorted(
              _build.file_seconds.items(), key=lambda kv: -kv[1])) + ")")
    for ln in _build.build_log.splitlines():
        if "registers" in ln or "spill" in ln:
            print("  ptxas:", ln.strip(), file=sys.stderr)

    measured = phase_kernels(torch, ms, qt, _build)
    phase_gemm_reference(torch, _build, pi)
    measured.update(phase_windowed(torch, ms, layers))
    measured.update(phase_k11(torch, fm, fast))
    attention, attention_path = phase_attention(torch, ms, qt, fm)
    measured.update(attention)
    k12, k12_path = phase_k12(torch, ms, qt, fm, D)
    measured.update(k12)
    k16, k16_path = phase_k16(torch, ms, qt, fm, pi)
    measured.update(k16)

    t0 = time.perf_counter()
    sds = {moe: make_vit_state_dict(np.random.RandomState(0), depth=DEPTH,
                                    dim=C, ffn=FFN, classes=100, img=224,
                                    patch=16, router_scale=25.0,
                                    moe_experts=moe)
           for moe in (0, MOE)}
    print(f"synthetic ViT-B/16 weights: {time.perf_counter() - t0:.1f} s")
    launches = phase_model(torch, ms, qt, fm, speed, sds)
    forms_measured, forms_launches = phase_forms(torch, ms, qt, fm, speed,
                                                 predict, config, _build, sds)
    measured.update(forms_measured)
    for k, n in forms_launches.items():
        launches[k] += n
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_train(torch, ms, qt, fm, np, bench, layers, vit, sds[0])
    print(f"phase train: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches["dyt_prologue_serving"] += phase_runner(torch, ms, qt, fm, np,
                                                     vit, sds[0])
    print(f"phase runner: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches["dyt_prologue_serving"] += phase_video(torch, ms, qt, fm, np,
                                                    sds[0])
    print(f"phase video: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    seg_sd = bench.seg_state_dict(0)
    print(f"synthetic seg weights: {time.perf_counter() - t0:.1f} s")
    k9, k4, (seg_model, q8_model) = phase_seg(torch, ms, qt, fm, D, bench,
                                              seg_sd)
    k9 += phase_slide(torch, ms, qt, fm, bench, seg_train, upernet,
                      seg_model, seg_sd)
    launches["mha_windowed_fused"] = k9
    launches["q8_ln_mlp"] += k4
    del seg_model
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    for k, n in phase_seg_train(torch, ms, qt, fm, D, seg_sd,
                                q8_model).items():
        launches[k] += n
    print(f"phase seg train: {time.perf_counter() - t0:.1f} s")
    del q8_model
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    for k, n in phase_parallel(torch, ms, qt, fm, np, sds[0],
                               seg_sd).items():
        launches[k] += n
    print(f"phase parallel: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    for k, n in phase_bench(torch, ms, qt, fm, bench, sds, seg_sd).items():
        launches[k] += n
    print(f"phase bench: {time.perf_counter() - t0:.1f} s")
    for k, n in phase_layerscale(torch, ms, qt, fm, D, seg_vit,
                                 make_seg_state_dict, config, np).items():
        launches[k] += n
    launches.update(phase_fast(torch, ms, qt, fm, fast, predict,
                               scan_throughput, forwards_run, sds[0]))
    t0 = time.perf_counter()
    for k, n in phase_files(torch, ms, qt, fm, np, predict, config,
                            sds[0]).items():
        launches[k] += n
    print(f"phase files: {time.perf_counter() - t0:.1f} s")
    del sds
    torch.cuda.empty_cache()
    for k, n in phase_long(torch, ms, qt, fm, fast, predict, vit,
                           load_timm_state_dict, make_vit_state_dict, np,
                           scan_throughput, forwards_run).items():
        launches[k] += n
    launches.update(attention_path)
    launches.update(k12_path)
    launches.update(k16_path)
    if not all(launches.values()):
        fail(f"a kernel never ran on the main path: {launches}")

    print(f"wall time: {time.perf_counter() - t_start:.1f} s")
    print(card_line())
    print(json.dumps({"kernels": [
        dict(name=name, **fields, launches=launches[name], **measured[name])
        for name, (_, fields) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-worker"]:
        parallel_worker(sys.argv[2])
    else:
        main()
