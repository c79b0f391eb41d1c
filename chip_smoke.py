"""Drive the PyTorch port's serving path (eager and exported), training
step, TTA test path, evaluation path (easy and hard scenes, HRSC
scoring), Swin-T, HRNet-W32, SSD-VGG16
and R-101 serving and training, ResNeXt-50 serving, the seven
configs that had no other phase (trained a step and scored), the
single DCNv1, a torchvision
backbone file loaded, the synthetic benchmark's training, plain and
with the hard-aug recipe, real DOTA input (PNG scenes, the
multi-scale prep, the test tool and training on the tiles), and data
parallelism (serving sharded over two replicas, the training step as
one- and two-process groups), corruption robustness, a long run that
re-executes itself, horizontal-box NMS, the FLOP counter, the overfit
sanity check, the profiler and the two visualisation tools, on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line or more (a failed phase exits non-zero):
  1. device: the card, its power limit, the build of the CUDA kernels and
     of the host library of polygon IoUs (devkit/native.py, g++);
  2. kernels: each kernel against its plain PyTorch version on the card, at
     the shapes of the R-50 1344^2 batch-4 serving path (min-area rect with
     its hull output, also timed at the training step's three calls;
     over-mask bit for bit with the share of live pairs whose clip empties
     at each stage; scan exactly with its time a row; DCN sampling bit for
     bit and also timed at the training and the 2016^2 TTA shapes), of the
     batch-2 training step (hull IoU with the step's masks, bit for bit
     over every pair, with the share of live pairs whose clip empties at
     each stage; DCN backward on f32 sample grads, its table grads bit for
     bit, and two launches on inputs that pile tens of thousands of
     corners onto a few pixels bit for bit) and of the quad-IoU
     entries (full and upper-triangle f32 IoU bit for bit with the share
     of pairs whose clip empties at each stage, the single-image over-mask
     and the scan at batch 1, the over-mask against the triangle,
     soft_rnms and box_iou_rotated), with times, each kernel's bound and,
     where one PyTorch call computes the same function, that call's time
     (grid_sample for the DCN kernels); the single DCNv1's two kernels
     (the DCN kernels at one table) the same way: the forward bit for bit
     at the serving pyramid (f32 and bf16), the backward at the training
     step's shape;
  2a. dcn_single: ops/deform_conv.py's deform_conv2d_pyramid forward and
     backward at the training step's pyramid (bf16, C 256 -> 256),
     counted (each single-table kernel once), against the same through
     their plain versions (outputs, the features' and the weight's grads
     bit for bit, the offsets' grads within DCN_BWD_RTOL);
  2b. host: host.imrescale (cv2's uint8 resize) on the card equals the
     same call on the CPU at sizes that resize;
  2c. hbb_nms: ops/nms.py's nms_hbb over 4096 seeded horizontal boxes
     (clustered, scores tied in steps of 1/64, every tenth row invalid),
     counted: the scan kernel keeps exactly what the plain scan keeps on
     the card and the plain route on the CPU; soft_nms_hbb (linear and
     gaussian) on the card as on the CPU; ms of each;
  3. slice: Predictor on configs/dota/orientedreppoints_r50_demo.py (R-50,
     canvas 1344^2, bf16, batch 4) over 8 seeded 1024^2 images, with seeded
     random weights perturbed so that the decode has thousands of
     candidates; launch counts, finiteness, images/s and peak memory;
  3b. shard_infer: parallel/infer.py's sharded serving on the card: the
     R-50 Predictor (bf16, batch 4) over [cuda:0, cuda:0], two replicas of
     two images each, counted (launches 2 a batch), bit for bit equal to
     the one-device Predictor at the replica's batch of 2; against the
     one-device batch of 4 (cuDNN picks other bf16 convolutions there)
     the head outputs' largest difference and the share of its dets the
     sharded run finds are read; with cuDNN off (PyTorch's convolutions,
     a sample at a time) the batch-4 head outputs equal the batch-2
     halves' and the sharded run the one-device batch of 4 det for det,
     bit for bit; images/s of both, data_devices() and the card count;
  4. decode: the same head outputs decoded through the kernels and through
     the plain versions, det for det (a box that differs must be a
     min-area tie, rect_check), and both NMS kernels checked and timed
     on that decode's own candidates (the top 4096 class-offset boxes an
     image);
  4a. export: tools/export_model_torch.py's path on the slice phase's
     model (its canvas, bf16, batch 4): torch.export through the four
     serving kernels' custom ops, saved, loaded, and the slice phase's 8
     images through ExportedProgram.module(), counted: det for det equal
     to the eager module (the decode rule), the four kernels launched;
     export, save and load seconds, the file's MB, images/s of both;
  4b. profile: utils/collect_env's report; utils/profiling.trace around
     one slice batch with annotate ranges around the forward and the
     decode, both in the written trace, and a CUDA event of each of the
     four ctypes-launched serving kernels (by __global__ name);
  5. tta: run_inference_tta with the multi-scale x flip recipe TTA_AUGS
     (scales 0.5, 1.0, 1.5, each on its own /32 canvas, x flip; R-50 bf16,
     batch 2) over 4 seeded 1024^2 images resized to fill the canvas: per
     aug the candidates, then dets, launches, finiteness, det centres in
     the image frame, images/s (median of 3 passes after a warm-up) and
     peak memory;
  6. tta_check: (a) the identity recipe [(1.0, False)] equals
     run_inference det for det; (b) one batch of the full recipe with
     every DCN forward (bit for bit) and min-area-rect call (each scale's
     canvas) held against its plain version on the same inputs, and its
     merged candidates through the kernels and through the plain
     over-mask and scan giving the same dets;
  7. iou_path: soft_rnms and the upper-triangle IoU entry over the merged
     TTA candidates of one image, the path of the f32 IoU kernels; then
     soft_rnms end to end (its picks, one host sync each) beside its IoU
     matrix alone, and box_iou_rotated's time;
  7b. swin: the slice phase on SWIN_CONFIG, the Swin-T demo config
     (Swin-T + FPN with max-pool extra levels, canvas 1344^2,
     bf16, batch 4; its own seeded weights, perturbed the same way), with
     the backbone's device time on one batch;
  7c. swin_decode: the decode phase on the Swin head's outputs;
  7d. hrnet, hrnet_decode: the slice and decode phases on HRNET_CONFIG
     (HRNetV2p-W32 + FPN at start level 1 with extra convs, canvas
     1344^2, bf16, batch 4); hrnet_dcn: the DCN forward of one more batch
     against its plain version, bit for bit;
  7e. ssd_vgg, ssd_vgg_decode, ssd_vgg_dcn: the same on SSD_VGG_CONFIG
     (SSD-VGG16@512: its first five maps, 168 .. 11 at 1344^2, under an
     FPN without extra levels);
  7f. resnext, resnext_decode, resnext_dcn: the same on the R-50 demo
     config with its backbone a ResNeXt-50 32x4d (RESNEXT_BACKBONE);
     r101, r101_decode, r101_dcn: the same on R101_CONFIG (R-101 at full
     width); a line r101_vs_r50 sets its images/s, backbone ms and step
     ms beside R-50's;
  7g. weights: a torchvision-named resnext50_32x4d state dict made from a
     seed, written to a .pth and loaded on the card through
     utils/checkpoint.load_pretrained_backbone; every backbone tensor equal
     to its source under torchvision's names, the neck and head untouched,
     one finite forward;
  7h. flops: tools/get_flops_torch.py's count (FlopCounterMode) for the
     R-50 demo and Swin-T configs at 1024^2 and 1344^2: params, forward
     GFLOPs, the counter's seconds; parallel/train.step_cost_analysis of
     each one's train step (1344^2, batch 2): its GFLOPs, the model
     unchanged after;
  7i. sanity: tools/sanity_overfit_torch.py --backbone r18 at its
     defaults (300 SGD steps on 4 seeded 256^2 scenes, then decode),
     counted: SANITY PASS (the last loss below 0.7 x the first, recall@0.5
     at least 0.5); the losses, recall and seconds;
  8. eval: tools/synth_benchmark.py's evaluation path without training:
     12 val scenes of 768^2 rendered and cut into 48 tiles of 512^2, the
     COCO-poly json, the dataset with configs/dota/synth_r18_512.py's test
     pipeline; run_inference with R-18 (bf16, canvas 512^2, batch 4,
     seeded weights perturbed as below) counted, then tiles/s (median of 3
     passes, the dataset's loading included) and peak memory;
     the same tiles through the plain DCN forward, over-mask and scan
     (each min-area-rect call checked against its plain version) equal
     det for det and Task1 file for file; Task1 files -> merge_by_poly ->
     Task1 mAP (area) and mAOE (IoU 0.7) with each stage's seconds (random
     weights score near 0; not gated); the scene labels as detections
     score mAP 1 and mAOE 0; apis.evaluate_results gives a finite mAP;
     the Task1 and mAOE scoring and evaluate_results again with their
     polygon IoUs through the numpy poly_iou (the plain version) instead
     of the host library: the same scores, both timed;
  8a. robustness: tools/test_robustness_torch.py's path in this process
     on the eval phase's first 24 tiles with its weights: the clean
     baseline, then the nine corruptions at severities 1, 3 and 5, each
     setting counted (rect, over-mask, scan and DCN forward launched);
     P, mPC, rPC and each setting's mAP (read, not gated), the tiles/s of
     the pass; jpeg_compression@3 through the plain versions too, det for
     det; a seeded 512^2 probe through the 27 settings with
     RandomState(7), each output's SHA-256 equal to CORRUPT_DIGESTS (the
     JAX package's cv2 bytes), each corruption's host ms on that tile;
  8c. visual: tools/browse_dataset_torch.py (the train pipeline, seed
     SEED) and tools/show_points_and_boxes_torch.py (on the card, counted)
     on the eval phase's tiles and weights, VISUAL_IMAGES images each:
     each PNG read back through data/image_io, gts and dets drawn, the
     four serving kernels launched;
  8b. hard_eval: the hard benchmark (tools/synth_benchmark.py --hard) on
     4 val scenes (16 tiles) with configs/dota/synth_r18_512_hard.py's test
     pipeline and seeded weights: run_inference counted, and through the
     plain versions Task1 file for file; merge, Task1 mAP and mAOE; then
     run_inference_tta with TTA_AUGS counted (each aug's candidates, and
     its dets when it runs alone) and one pass timed stage by stage
     (resize, forward + decode of each aug, merge, NMS, the rest); then 2
     ship-only scenes (--hrsc) scored by eval_hrsc2016, their labels as
     detections scoring 1;
  9. train: the config's SGD step (R-50, canvas 1344^2, bf16, batch 2,
     frozen_stages 1, max_gt 512, max_pos 1024) on a seeded batch of 150
     rotated gts per image, seeded random weights with the point convs
     scaled up (else all 9 points coincide and the refine assigner
     degenerates): 1 warm-up step, 5 timed steps; per step the losses and
     assignment statistics, then step ms, images/s, peak memory, launches;
     the 6 steps again in a fresh model from the same weights, every loss
     and tensor bit for bit;
  10. train_check: one f32 step from the same weights and batch through
     the kernels and through the plain versions: the same refine
     assignment, the same losses, the grads within GRAD_RTOL (the DCN
     backward's offset grads sum in another order);
  10a. ddp: the train phase's R-50 SGD step (bf16, 1344^2, its batch of 2
     and gts), 3 steps, run three times in this process (bit for bit
     equal) and once with the batch's rows forwarded one at a time, then
     as a group of one NCCL process and of two gloo processes on cuda:0 (a
     row each), each rank a child of this script (--ddp_rank); the W = 1
     group equal to the one-process run bit for bit; W = 2 against the
     by-rows run, whose grads associate otherwise: the parameters within
     DDP_W2_UPDATE_RTOL of the update, each loss on its own value (step 1
     within DDP_STEP1_RTOL, later steps within DDP_W2_LOSS_RTOL); a
     planted fault (the rbox losses over a rank's own positives) must
     fail that gate; per rank the step
     ms (nothing else timed in them), the all-reduce ms of 2 more steps,
     peak memory and the launches a step (hull 1, rect 2, hull IoU 1, DCN
     forward and backward 1 each);
  10b. swin_train: the train phase on the Swin-T config (its repeat
     too): AdamW with its
     no-decay set, nothing frozen, DropPath 0.2 drawing JAX's masks under
     dropout_key(SEED, step) (22 masks a step, each one's dropped samples
     recorded, the share and the masks that drop a sample a step
     reported), on the same batch; the model's masks at three (seed,
     step) pairs equal DROP_PATH_TABLE (computed with jax.random and
     flax);
  10c. swin_train_check: the train_check phase on the Swin-T config: the
     same DropPath masks in both runs, then the same checks;
  10d. hrnet_train, hrnet_train_check, ssd_vgg_train, ssd_vgg_train_check,
     r101_train, r101_train_check: the two phases on HRNET_CONFIG,
     SSD_VGG_CONFIG and R101_CONFIG (SGD; HRNet's and SSD-VGG's
     frozen_stages 1 freezes nothing, as in JAX: neither has ResNet's stem
     or layer1_* names);
  11. synth_train: tools/synth_benchmark_torch.py --train's path at the
     full width of configs/dota/synth_r18_512.py (R-18, bf16, canvas
     512^2, batch 8, max_gt 64, max_pos 512): 8 train scenes rendered and
     cut into 32 tiles, the config's train pipeline (CorrectBox without
     cv2) and loader, the seeded initial weights; epoch 1 (a warm-up step,
     then counted and timed) and a checkpoint, epoch 2 (A), then epoch 2
     twice more from the checkpoint in fresh objects (B, C), all through
     apis.train_epochs: per step the losses, num_pos and refine
     positives; step ms, images/s, the wait for the loader's batch, peak
     memory, launches a step (the min-area rect's hull and rect entries
     apart); the restored state equal to the saved one bit for bit, and B
     equal to A bit for bit (every step's losses, the parameters, the
     momentum buffers, the LR and the step count); one more step with
     each training kernel's entry held against its plain version on the
     same inputs, and each kernel timed at those inputs;
  12. hard_aug_train: tools/synth_benchmark_torch.py --hard --train's
     path with configs/dota/synth_r50_512_hard_aug.py at its own widths
     and sizes (R-50, bf16, canvas 512^2, batch 8, max_gt 128, max_pos
     512): 8 hard train scenes cut into 32 tiles; the train pipeline
     (mosaic x mixup, HSV, rotation, resize, flip; cv2's warps and colour
     conversions rebuilt) over the tiles on the host alone, each
     transform's ms a sample and the samples a second; two loaders from
     one seed bitwise equal over the first epoch; a warm-up step and 6
     counted steps through the loader and apis.train_epochs (losses,
     refine positives, step ms, the loader's wait share, launches); one
     more step with each training kernel's entry held against its plain
     version, and each kernel timed at those inputs;
  12a. configs: CONFIGS_PHASE, the seven configs no other phase runs
     (R-18, Swin-T, R-101 and R-50 1024^2 hard-aug, R-18 with max_pos
     1024, R-18 HRSC-aug, the R-50 mosaic demo), each at its own widths,
     batch, canvas, max_gt, max_pos, optimizer, schedule and pipelines,
     on CONFIGS_SCENES hard scenes cut into 512^2 tiles (ship-only scenes
     for the HRSC config) that each pipeline resizes: the seeded initial
     weights (Swin's biases drawn as perturbed_weights draws them), a
     warm-up step and a counted one through the loader and
     apis.train_epochs (step ms, the loader's wait share, peak memory),
     one step with each training kernel's entry against its plain
     version, run_inference over a val scene's tiles with the config's
     test pipeline and canvas (counted), Task1 files, merge, Task1 mAP /
     mAOE and evaluate_results (random weights: read, not gated);
  13. dota_input: DOTA_SCENES (2048 x 1536 and 1600 x 2400) rendered and
     written as PNG (data/image_io) in raw/{train,val,test}, read back
     equal, the decoder's ms a megapixel; devkit/prepare.py's
     prepare_dota1_ms at subsize 1024 (rates 0.5, 1.0, 1.5; seconds by
     rate), every tile equal to its crop of host.resize_cubic_uint8, the
     rate-1 labels equal to the .npy route's; two ship-only BMP scenes
     through prepare_hrsc2016 and the HrscDataset; tools/test_torch.py's
     path (R-50 demo config, bf16, batch 4, seeded weights from a state
     dict file) over the test split's PNG tiles counted, its first 8
     tiles through the plain versions too (Task1 file for file), images/s
     with the PNG loading and the test pipeline's ms a tile alone,
     the merged files, the val labels as detections scoring mAP 1; 3 SGD
     steps on the trainval tiles through the config's train pipeline and
     loader (batch 2): finite losses, the loader's wait share, launches a
     step.  The test tool's Task1 files are merged twice, by the default
     pool (15 class files, 15 spawned workers) and in one process: byte
     for byte, both timed, their IoUs through the host library; poly_nms
     on the largest class file's first scene (its first DOTA_NMS_CHECK
     dets) keeps what the numpy IoU's loop keeps, both timed;
  14. chunked: tools/synth_benchmark_torch.py --train (R-18 of
     synth_r18_512.py, 2 scenes, a step an epoch) to epoch 3 as
     subprocesses: with --rss_limit_gb 0.001 two re-executions (the
     kernels found built after each) and exit 3; once uninterrupted; the
     re-executed run's weights equal to the uninterrupted run's bit for
     bit; --skip_train of
     its work dir scoring as its checkpoint's weights scored in this
     process (counted).
Each counted run (slice, shard_infer, tta, iou_path, swin, hrnet,
ssd_vgg, resnext, r101, eval, robustness's settings, hard_eval's two,
train, ddp's ranks, swin_train, hrnet_train, ssd_vgg_train, r101_train,
synth_train, hard_aug_train, configs' steps and eval passes,
dota_input's two, chunked's scoring, hbb_nms, export, sanity, visual's
show_points_and_boxes, dcn_single) sets the launch
counts to 0 just before and reads them just after; it fails if a kernel
of its path was not launched.  Then one JSON line
with every kernel's numbers, the card's line from nvidia-smi, and
{"ok": true, "device": {...}} last.

bound_ms is the least time the card could take for a kernel's work on this
run's inputs: the larger of its bytes (each input read once, each output
written once) over 3.35 TB/s and its f32 operations over 33.5 T op/s (the
published 67 TFLOP/s of an H100 SXM counts a fused multiply-add as two; the
library is built with -fmad=false, so each multiply and add is one
instruction).  The operation counts are the op models of *_ops below,
evaluated on this run's data where the work depends on it (clip vertex
counts, hull sizes, live pairs, kept rows; the hull IoU's live pairs are
those of a valid gt and a valid point set); work that depends on one input
of a pair only counts once for that input.

Imports torch, numpy and the port only.  Exits non-zero, printing no
result, without a GPU or outside a checkout of the repository.
"""

from __future__ import annotations

import contextlib
import hashlib
import importlib.util
import io
import json
import math
import multiprocessing
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

if __name__ != "__mp_main__":
    # a worker of the merge's spawn pool re-imports this file as
    # __mp_main__ and runs nothing of it: without torch it starts in a
    # fraction of a second
    import torch

CONFIG = "configs/dota/orientedreppoints_r50_demo.py"
SWIN_CONFIG = "configs/dota/orientedreppoints_swin_tiny_demo.py"
HRNET_CONFIG = "configs/dota/orientedreppoints_hrnet_w32_demo.py"
SSD_VGG_CONFIG = "configs/dota/orientedreppoints_ssd_vgg16_demo.py"
R101_CONFIG = "configs/dota/orientedreppoints_r101_demo.py"
# the R-50 demo config with this backbone: ResNeXt-50 32x4d
RESNEXT_BACKBONE = dict(type="ResNeXt", depth=50, groups=32, base_width=4,
                        frozen_stages=1)
SEED = 0
BATCH = 4
N_IMAGES = 8
PTS_SCALE = 30.0  # point-conv gain: R-50 width, spread ~1 stride
SWIN_NORM_STD = 0.02  # Swin's biases and norm affines (perturbed_weights)
NMS_THR = 0.4
LEVELS = [(BATCH, 168, 168), (BATCH, 84, 84), (BATCH, 42, 42),
          (BATCH, 21, 21), (BATCH, 11, 11)]  # 1344^2 canvas, strides 8..128
RECT_TOL = 1e-3  # px, corners up to order; coordinates <= ~1.5e3 in f32
TRAIN_BATCH = 2  # data.imgs_per_gpu
TRAIN_CANVAS = 1344
TRAIN_HW = ((1280, 1280), (1024, 1024))  # true image sizes on the canvas
TRAIN_GTS = 150  # rotated gts per image: long side 12-300 px, aspect 1-6
TRAIN_STEPS = 5
STRIDES = (8, 16, 32, 64, 128)
TRAIN_LEVELS = [(TRAIN_BATCH, -(-TRAIN_CANVAS // s), -(-TRAIN_CANVAS // s))
                for s in STRIDES]
# DCN backward: its table grads equal the plain version's bit for bit (the
# kernel sums in the plain version's order).  Its offset grads sum over
# channels in the kernel's own order, which the plain version's reduction
# cannot spell: by the dtype of the grad, f32 sums of up to ~500 terms;
# bf16: one rounding step (2^-8) either side; both relative to the largest
# element of that grad
DCN_BWD_RTOL = {"float32": 1e-5, "bfloat16": 2 ** -7}
# train_check: grads through the kernels vs the plain versions, relative to
# each tensor's largest element.  The DCN backward's offset grads sum in
# another order in the two routes (~1e-6 of a grad); 1e-3 leaves room for
# that through ~60 layers
GRAD_RTOL = 1e-3
# the DCN backward's repeat case: every sample of each level and image
# sent near one of PILE_TARGETS pixels (tens of thousands of corners on
# each)
PILE_TARGETS = 4

TTA_AUGS = [(0.5, False), (0.5, True), (1.0, False), (1.0, True),
            (1.5, False), (1.5, True)]  # TTA_BENCH.json's recipe shape
TTA_BATCH = 2
TTA_LEVELS = [(TTA_BATCH, -(-2016 // s), -(-2016 // s)) for s in STRIDES]
TTA_IMAGES = 4
TTA_SIZE = 1024
NQ = 4096  # NMS candidates an image: pre_nms_cap
TRI_NV = [NQ, 3000, 1000, 0]  # the upper-triangle kernel's prefixes
HBM_BYTES_PER_MS = 3.35e12 / 1e3  # H100 SXM
# GPU clock cycles to cover the host's enqueue of one timed call (~100 us
# at ~2 GHz, more than a wrapper's allocations and ctypes launch take)
HOST_CYCLES_PER_CALL = 2e5
FP32_OPS_PER_MS = 33.5e12 / 1e3  # 67 TFLOP/s with an FMA counted as two
# grid_sample against the plain DCN in f32: the normalised grid moves a
# sample by up to ~1e-5 px (at w = 168), so values differ by that times the
# difference of neighbouring values (up to ~8 here); the offset grads are
# compared away from pixel lines, where that move may change the cell
LIBRARY_TOL = 1e-3
CELL_EDGE = 1e-3  # px
# random point sets reach up to about a stride past their location, so a
# det's centre may lie that far outside the image; an aug's boxes mapped
# back with a wrong scale land hundreds of px away
FRAME_SPREAD = 128

SOURCES = {
    "min_area_rect": ("orientedreppoints_tpu_torch/csrc/minarearect.cu",
                      "orientedreppoints_tpu/ops/pallas_minarearect.py:30"),
    "quad_over_mask": ("orientedreppoints_tpu_torch/csrc/quad_over.cu",
                       "orientedreppoints_tpu/ops/pallas_quad_iou.py:208"),
    "nms_scan": ("orientedreppoints_tpu_torch/csrc/nms_scan.cu",
                 "orientedreppoints_tpu/ops/nms.py:35"),
    "deform_sample_pair": ("orientedreppoints_tpu_torch/csrc/deform_sample.cu",
                           "orientedreppoints_tpu/ops/deform_conv.py:380"),
    "hull_quad_iou": ("orientedreppoints_tpu_torch/csrc/hull_iou.cu",
                      "orientedreppoints_tpu/ops/pallas_quad_iou.py:347"),
    "deform_sample_pair_backward": (
        "orientedreppoints_tpu_torch/csrc/deform_sample_bwd.cu",
        "orientedreppoints_tpu/ops/deform_conv.py:410"),
    "quad_iou_full": ("orientedreppoints_tpu_torch/csrc/quad_iou.cu",
                      "orientedreppoints_tpu/ops/pallas_quad_iou.py:154"),
    "quad_iou_tri": ("orientedreppoints_tpu_torch/csrc/quad_iou.cu",
                     "orientedreppoints_tpu/ops/pallas_quad_iou.py:158"),
    "quad_over_mask_single": (
        "orientedreppoints_tpu_torch/csrc/quad_over.cu",
        "orientedreppoints_tpu/ops/pallas_quad_iou.py:253"),
    # the single DCNv1: the sampling of bilinear_gather and its autodiff
    "deform_sample": ("orientedreppoints_tpu_torch/csrc/deform_sample.cu",
                      "orientedreppoints_tpu/ops/deform_conv.py:94"),
    "deform_sample_backward": (
        "orientedreppoints_tpu_torch/csrc/deform_sample_bwd.cu",
        "orientedreppoints_tpu/ops/deform_conv.py:94"),
}
SERVING_KERNELS = ("min_area_rect", "quad_over_mask", "nms_scan",
                   "deform_sample_pair")
TRAIN_KERNELS = ("min_area_rect", "hull_quad_iou", "deform_sample_pair",
                 "deform_sample_pair_backward")
TTA_KERNELS = ("min_area_rect", "deform_sample_pair", "quad_over_mask",
               "nms_scan")  # the over-mask here is the single-image entry
IOU_PATH_KERNELS = ("quad_iou_full", "quad_iou_tri")
# phase eval: tools/synth_benchmark.py's val set (12 scenes of 768^2 with
# 24 objects, seed 0 + 10000, prefix V) cut into 512^2 tiles at gap 256,
# scored with R-18 (configs/dota/synth_r18_512.py) at canvas 512^2, batch 4
EVAL_CONFIG = "configs/dota/synth_r18_512.py"
EVAL_SCENES = 12
EVAL_SCENE_SIZE = 768
EVAL_OBJECTS = 24
EVAL_SEED = 10000
EVAL_SUBSIZE = 512
EVAL_GAP = 256
EVAL_BATCH = 4
# cls_out's bias: R-18's random head moves a logit by only ~0.02 over the
# map and ~0.035 between classes (f32 on the CPU at 256^2), so the bias
# decides which classes pass score_thr (logit -2.944), each at every
# location.  This seeded draw passes two of them: every tile keeps
# max_per_img (512) dets, ~2,000 a scene and class reach the numpy merge,
# and the phase stays within its ~90 s
EVAL_BIAS = (-5.0, -2.0)
# phase hard_eval: tools/synth_benchmark.py --hard's val scenes (the first
# 4 of 12; 16 tiles) with configs/dota/synth_r18_512_hard.py, and the
# first 2 of --hrsc's ship-only val scenes
HARD_CONFIG = "configs/dota/synth_r18_512_hard.py"
HARD_SCENES = 4
HRSC_SCENES = 2


# phase synth_train: tools/synth_benchmark_torch.py --train's path on 8 of
# its train scenes (768^2, seed 0, prefix T; 32 tiles of 512^2, 4 steps an
# epoch at batch 8)
SYNTH_TRAIN_SCENES = 8
# phase hard_aug_train: tools/synth_benchmark_torch.py --hard --train's
# path with the hard-aug recipe (mosaic x mixup, HSV, rotation) on 8 hard
# train scenes (32 tiles, 4 steps an epoch at batch 8)
HARD_AUG_CONFIG = "configs/dota/synth_r50_512_hard_aug.py"
HARD_AUG_SCENES = 8
HARD_AUG_STEPS = 6  # counted, after one warm-up step
# phase dota_input: two DOTA-sized scenes (h, w) through the PNG codec,
# the multi-scale prep (subsize 1024), the test tool and 3 training steps
DOTA_SCENES = ((1536, 2048), (2400, 1600))
DOTA_OBJECTS = 120
DOTA_SEED = 30000
DOTA_SUBSIZE = 1024
DOTA_GAPS = (824, 500)  # prepare_dota1_ms's: rate 1.0, the other rates
DOTA_TRAIN_STEPS = 3
DOTA_PLAIN_IMAGES = 2 * BATCH  # test tiles through the plain versions too
HRSC_PREP_SCENES = 2
HRSC_PREP_SIZE = (600, 1000)  # (h, w) of the ship-only BMP scenes
# phase robustness: tools/test_robustness_torch.py's path on the eval
# phase's first ROBUST_IMAGES val tiles with its seeded weights: the clean
# baseline, then every corruption at these severities
ROBUST_IMAGES = 24
ROBUST_SEVERITIES = (1, 3, 5)
ROBUST_PLAIN = ("jpeg_compression", 3)  # also through the plain versions
# corruptions.corrupt(corruption_probe(), name, sev, RandomState(7)): the
# SHA-256 of each output, computed from the JAX package's cv2 corruptions
# (tests/test_torch_corruptions.py recomputes them).  One exception:
# motion_blur@5's 17^2 kernel takes cv2's DFT path, which the port's
# direct sum leaves 1 grey level off at a few values (9 of 786,432 here;
# data/filter.py): its digest is the port's own, held to cv2's within
# that bound by the test
CORRUPT_PROBE_SEED = 16
CORRUPT_RNG_SEED = 7
CORRUPT_DFT_PATH = ("motion_blur@5",)
CORRUPT_DIGESTS = {
    "gaussian_noise@1":
        "153e9817e85c3e69a9f6dca68b267d0136f08ce05442cb5b1ba30c021b8d4e02",
    "gaussian_noise@3":
        "7155c3e5fd0ec68ace51178caaeb982c777cd9eb81201bde437fe7d04aabc9df",
    "gaussian_noise@5":
        "470b12eac0cb0330943fe63ad7900374e1b9f724b7f0c2b254a3f3215d50be68",
    "shot_noise@1":
        "89d11d3be0291e5b74dc7ff76b994a6bfd542c396abf362c3856f4feba79bd0d",
    "shot_noise@3":
        "072a36bf920345a5d1717f09d32041863bb0f5522475fbd1ec7664a02cb3fad5",
    "shot_noise@5":
        "895abd76baf12103670824f98bcd13c290f873cde926726ade502f11b7f06626",
    "impulse_noise@1":
        "f62c8e46aa5f1939fb2a2ab499d45fa0d6f1a9653aa5c5870fad2ce355d8554d",
    "impulse_noise@3":
        "6bdd23d9d7cc80595d33853086a706d15e34635760a6eb1189acfce37a15ba7f",
    "impulse_noise@5":
        "a2f37a64f1b2e02b1b083ce1c15bf9eb268fa82b0e860bb7b6b805bd8d01fd6e",
    "defocus_blur@1":
        "a870d29a1970e596712c28f87ac5e18b67ac266aedfc93a82f652368b347de48",
    "defocus_blur@3":
        "b44e43fb00a144735d0679ee7ea1b462cb27d1cec15b63421629a232c872edac",
    "defocus_blur@5":
        "2818dcd668ecb8cbb08afcf4094c6471f789ac9ca5c9f74d09e03d019de431f5",
    "motion_blur@1":
        "7a7e13c644a44e2124ade96d56767c7e830fb810ad20fcfacd37e9cb983149d9",
    "motion_blur@3":
        "90260c5223c2d9535a9d5b8b59a0a8ecc9d62df4043021b9f74d0f8607a6da1d",
    "motion_blur@5":
        "ef33e27744efcb74884ce2b475d65981aa4b04d09905e5e3812ac67c1fc2db45",
    "brightness@1":
        "f2da6dde97e64f669cc342c317d556d7bff09a289c78671d71e68221a367317d",
    "brightness@3":
        "3ad315b700e3629150ab59d2c2490b0a4d4a4f8330e6b946a7a805ecd33ba4d9",
    "brightness@5":
        "375eda45195fec204ba21968a96f27ed055fcc8e3934d88cf83dc9f5148872a5",
    "contrast@1":
        "3cf9b2b1125fb5d3dfb817794968ad41a729e5099c856f0f877c732df8ca4da5",
    "contrast@3":
        "2b2ac2200b8e8137c5cfb8ce477f4f451dd83bf805800c06c2312f314221a97c",
    "contrast@5":
        "6a923a1608173986f8a27fe58c2fd32dea3444fc434e8df92574c0cc0bbebffe",
    "jpeg_compression@1":
        "f2cbde069b349f82741e98881bb4c418a817b05f494699a3649f5fa29202347e",
    "jpeg_compression@3":
        "9d98b2241d96616be9b2495ab4a1cae586a064a247059a3b5f387850e820ba32",
    "jpeg_compression@5":
        "d119ed616d9549b66e1023e04fad5d6ec9032c29282a04fdc00f1535346661a8",
    "pixelate@1":
        "5773e7a1d9fc0ea8b59764a0b41f9ce7e5654b5349208a534586ec57c14b540b",
    "pixelate@3":
        "afdf921ff6ac0044a1fb9468764d39b2f43b4a75aaf5b83de9de64ed9d049c8f",
    "pixelate@5":
        "b9ed7dd6f0dbb583811d2bb656c79ea6887f06fb1ceabf2d9fbe131cc1e27748",
}
# phase dota_input: poly_nms through the host library against the numpy
# loop on the largest class file's first scene, cut to this many dets
DOTA_NMS_CHECK = 3000
# phase swin_train: Swin-T's DropPath keep masks (SWIN_CONFIG, rate 0.2)
# of a global batch of 8 under the JAX step's key fold_in(key(seed), step),
# computed with jax.random.bernoulli on flax's make_rng keys
# (flax.core.scope._fold_in_static of ("backbone", block, n)): per (seed,
# step) one group of 8 samples (1 kept) a draw, in
# SwinTransformer.drawing order (stage0_block1 attention, then MLP, ...)
DROP_PATH_BATCH = 8
DROP_PATH_TABLE = {
    (0, 0): (
        "11111111 11011111 11111111 11111101 10111111 10111111 "
        "11111110 11111011 11110111 11011110 10111111 10111101 "
        "11111011 11111111 11111101 11111111 10111110 10011101 "
        "10101101 11111110 10111011 11111111"),
    (0, 3): (
        "11110111 11111111 11111111 11111111 11101111 11111111 "
        "11011111 11111101 11111111 11110011 11111110 00111011 "
        "00111111 11111111 11001011 10111111 11111111 11110111 "
        "11111110 11111111 00011011 01111110"),
    (7, 250): (
        "11111111 11111111 11111111 11101111 11111111 11111111 "
        "11111111 11111111 11111111 10110110 11111111 10111111 "
        "11101111 11111111 11111111 01101111 01111110 10111111 "
        "01111011 01110111 11111101 00111111"),
}
# phase visual: each tool's images, and show_points_and_boxes' threshold
# (the eval weights' scores reach ~0.12: EVAL_BIAS)
VISUAL_IMAGES = 4
VISUAL_SCORE_THR = 0.05
# phase chunked: tools/synth_benchmark_torch.py --train on EVAL_CONFIG, 2
# train scenes (8 tiles: a step an epoch), to epoch 3, as subprocesses
CHUNKED_TRAIN_SCENES = 2
CHUNKED_VAL_SCENES = 2
CHUNKED_EPOCHS = 3
CHUNKED_TIMEOUT = 300.0


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields), flush=True)


SUMMARY = {}  # phase -> its headline numbers, for lines that compare them


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call over reps calls, after one
    warm-up.  The card is first kept busy (torch.cuda._sleep) for longer
    than the host takes to enqueue the calls, so that a small kernel is
    timed back to back and not at the host's launch rate."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(reps * HOST_CYCLES_PER_CALL))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, ops: float) -> dict:
    """The least time for nbytes of traffic and ops f32 operations."""
    t_bytes = nbytes / HBM_BYTES_PER_MS
    t_ops = ops / FP32_OPS_PER_MS
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=float(nbytes), operations=float(ops))


def clip_pair_ops(sub, cnt, quads, live=None, exits=None) -> float:
    """f32 operations of the pair IoU (clip_ring.cuh) over subjects sub
    (B, N, V, 2) with vertex counts cnt (B, N) and clip quads (B, M, 8),
    over the live (B, N, M) pairs only if live(rows, cols) gives a mask.  Work that depends on one side only counts once for each row
    or column with a live pair (an area does not change when the pair is
    recentred, so a kernel may take it once): a subject's area and half of
    it 4 n0 + 1, a clip quad's shift to its vertex 0, area, half area and
    four edge vectors 8 + 16 + 1 + 8.  Per pair, with n0 the subject's
    vertices, c_e and x_e the vertices entering and the edges crossing
    clip stage e, c4 the clipped vertices: the subject's shift 2 n0, per
    stage 5 c_e + 8 x_e, the clipped area 4 c4, the union and ratio 5.
    exits, a list of 5 counts if given, receives the live pairs whose clip
    empties at stage 0, 1, 2, 3, and those that keep a vertex."""
    from orientedreppoints_tpu_torch.ops.geometry import _clip_half_plane

    b, n, v, _ = sub.shape
    m = quads.shape[1]
    total = 0.0
    col_live = torch.zeros((b, m), dtype=torch.bool, device=sub.device)
    step = max(1, (1 << 20) // max(1, b * m))
    for r0 in range(0, n, step):
        r1 = min(n, r0 + step)
        o = quads[:, None, :, None, :2]  # (B, 1, M, 1, 2)
        verts = sub[:, r0:r1, None] - o
        c = cnt[:, r0:r1, None].expand(-1, -1, m).to(torch.int64)
        q = quads.view(b, 1, m, 4, 2) - o
        area2 = (q[..., 0] * q[..., [1, 2, 3, 0], 1]
                 - q[..., [1, 2, 3, 0], 0] * q[..., 1]).sum(-1)
        q = torch.where((area2 < 0)[..., None, None], q[..., [0, 3, 2, 1], :],
                        q).expand(-1, r1 - r0, -1, -1, -1)
        lv = torch.ones_like(c, dtype=torch.bool)
        if live is not None:
            rows = torch.arange(r0, r1, device=sub.device)[None, :, None]
            cols = torch.arange(m, device=sub.device)[None, None, :]
            lv = live(rows, cols).expand_as(c)
        ops = 2 * c + 5
        for e in range(4):
            a, bb = q[..., e, :], q[..., (e + 1) % 4, :]
            ex, ey = (bb - a).unbind(-1)
            side = ex[..., None] * (verts[..., 1] - a[..., None, 1]) - \
                ey[..., None] * (verts[..., 0] - a[..., None, 0])
            slots = torch.arange(verts.shape[-2], device=sub.device)
            inside = ((side >= 0) & (slots < c[..., None])).sum(-1)
            verts, c_out = _clip_half_plane(verts, c, a, bb,
                                            v + 1 + e)
            ops = ops + 5 * c + 8 * (c_out - inside)
            if exits is not None:
                exits[e] += int((lv & (c > 0) & (c_out == 0)).sum())
            c = c_out
        ops = ops + 4 * c
        if exits is not None:
            exits[4] += int((lv & (c > 0)).sum())
        row_ops = 4 * cnt[:, r0:r1].to(torch.int64) + 1
        total += float(torch.where(lv, ops, 0).sum())
        total += float(torch.where(lv.any(-1), row_ops, 0).sum())
        col_live |= lv.any(1)
    return total + 33.0 * float(col_live.sum())


def exit_shares(exits, live: int) -> dict:
    """A kernel line's clip-stage fields from clip_pair_ops' exits over
    live pairs: the share whose clip empties at each stage, and the share
    that keeps a vertex."""
    share = 1.0 / max(1, live)
    return dict(live_pairs=live, live_stage0_exit_share=exits[0] * share,
                live_exit_share_by_stage=[x * share for x in exits[:4]],
                live_clip_nonempty_share=exits[4] * share)


def quad_subjects(quads):
    """(B, N, 8) quads as clip_pair_ops subjects: 4 slots, count 4."""
    b, n, _ = quads.shape
    return quads.view(b, n, 4, 2), torch.full((b, n), 4, device=quads.device)


def tri_live(nv):
    """The upper triangle inside the valid prefixes nv (B,)."""
    nv = nv.to(torch.int64).view(-1, 1, 1)
    return lambda rows, cols: (cols > rows) & (rows < nv) & (cols < nv)


def over_mask_case(entry, q, nv, thr=NMS_THR, reps=10):
    """The over-mask kernel (entry() launches it on quads q (B, N, 8) with
    prefixes nv and threshold thr) against its plain version, bit for bit:
    (the kernel line's fields, the plain version's words).  The live pairs
    are those of the upper triangle inside the prefixes; their clip-stage
    exits come from clip_pair_ops."""
    from orientedreppoints_tpu_torch.ops import quad_iou

    n = q.shape[1]
    got = entry()
    want = quad_iou.quad_over_mask_plain(q, thr, nv)
    diff = int(quad_iou.unpack_bits(got ^ want, n).sum())
    exits = [0] * 5
    ops = clip_pair_ops(*quad_subjects(q), q, tri_live(nv), exits)
    v = nv.to(torch.int64).clamp(0, n)
    return dict(
        max_abs_err=float(diff), differing_bits=diff, ok=diff == 0,
        set_bits=int(quad_iou.unpack_bits(want, n).sum()),
        **exit_shares(exits, int((v * (v - 1) // 2).sum())),
        ms=cuda_ms(entry, reps),
        plain_ms=cuda_ms(lambda: quad_iou.quad_over_mask_plain(q, thr, nv),
                         1),
        library_ms=None,
        **bound(q.numel() * 4 + nv.numel() * 4 + want.numel() * 8, ops)), \
        want


def scan_case(words, valid, nv, reps=20):
    """The scan kernel against its plain version on one bitmask: the same
    keep exactly; the time per row is the kernel's over the longest prefix
    (the images run side by side)."""
    from orientedreppoints_tpu_torch.ops import nms

    n = valid.shape[1]
    keep = nms.greedy_scan(words, valid, nv)
    keep_plain = nms.greedy_scan_plain(words, valid, nv)
    ms = cuda_ms(lambda: nms.greedy_scan(words, valid, nv), reps)
    rows = max(1, int(nv.max()))
    inside = torch.arange(n, device=words.device) < nv[:, None].long()
    row_words = words.shape[-1] - torch.arange(n, device=words.device) // 64
    return dict(
        max_abs_err=float((keep != keep_plain).sum()),
        ok=bool(torch.equal(keep, keep_plain)), kept=int(keep.sum()),
        ms=ms, rows_walked=rows, ns_per_row=ms * 1e6 / rows,
        plain_ms=cuda_ms(lambda: nms.greedy_scan_plain(words, valid, nv), 1),
        library_ms=None,
        # the kept rows' mask words from their own word on, valid in, keep
        # out; no arithmetic
        **bound(float(((keep & inside) * row_words).sum()) * 8
                + 2 * keep.numel(), 0.0))


def min_area_rect_ops(counts) -> float:
    """Op model of one min-area rect per set with a hull of h vertices:
    the centroid 20, per gift-wrapping step (h + 1 of them) 9 distances
    and 81 cross products 279, per caliper edge (h) the rotated hull and
    its extent 6 h + 50, the rotation back 30."""
    h = counts.to(torch.float64)
    return float((50 + (h + 1) * 279 + h * (6 * h + 50)).sum())


def dcn_bytes_ops(rows, c, k, elem, backward, grad_elem=4, n_tables=2):
    """Bytes and ops of the DCN sampling over rows x k samples of C
    channels of n_tables tables (2: the paired DCN; 1: the single) in an
    elem-byte dtype.  Forward: the tables and the offsets in, a (rows,
    k C) buffer a table out; per sample 30 ops of plan, per channel and
    table 7 (four weighted corners).  Backward: tables, offsets and the
    buffers' grads (grad_elem bytes: f32, as the autograd node hands them
    over) in, table and offset grads out; per channel and table 22 (four
    weighted scatters, two corner differences and their products with the
    grad)."""
    tables, offs = n_tables * rows * c * elem, rows * 2 * k * elem
    if backward:
        return (tables + offs + n_tables * rows * k * c * grad_elem + tables
                + offs, rows * k * (30 + 22 * n_tables * c))
    return (tables + offs + n_tables * rows * k * c * elem,
            rows * k * (30 + 7 * n_tables * c))


def rect_err(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-row max corner distance over b's corner rotations/reversal."""
    a, b = a.view(-1, 4, 2), b.view(-1, 4, 2)
    errs = [(a - bb.roll(s, 1)).abs().amax((1, 2))
            for bb in (b, b.flip(1)) for s in range(4)]
    return torch.stack(errs).amin(0)


def rect_area(r: torch.Tensor) -> torch.Tensor:
    r = r.view(-1, 4, 2).double()
    return (r[:, 1] - r[:, 0]).norm(dim=-1) * (r[:, 2] - r[:, 1]).norm(dim=-1)


def pair_boxes(points: torch.Tensor):
    """Each set's boxes along the directions between two of its points,
    in float64 -> (corners (n, pairs, 4, 2), areas (n, pairs)).  The
    min-area rect lies along a hull edge, so it is among them."""
    p = points.view(points.shape[0], -1, 2).double()
    mean = p.mean(1, keepdim=True)
    p = p - mean
    i, j = torch.triu_indices(p.shape[1], p.shape[1], 1, device=p.device)
    d = p[:, j] - p[:, i]
    th = torch.atan2(d[..., 1], d[..., 0])[..., None]  # (n, pairs, 1)
    c, s = th.cos(), th.sin()
    x, y = p[:, None, :, 0], p[:, None, :, 1]
    u, v = c * x + s * y, c * y - s * x
    u0, u1, v0, v1 = u.amin(-1), u.amax(-1), v.amin(-1), v.amax(-1)
    uv = torch.stack([torch.stack([u0, v0], -1), torch.stack([u1, v0], -1),
                      torch.stack([u1, v1], -1), torch.stack([u0, v1], -1)],
                     -2)  # (n, pairs, 4, 2)
    box = torch.stack([c * uv[..., 0] - s * uv[..., 1],
                       s * uv[..., 0] + c * uv[..., 1]], -1) + mean[:, None]
    return box, (u1 - u0) * (v1 - v0)


def tie_check(points: torch.Tensor, rect: torch.Tensor):
    """Each rect against its set's float64 boxes (pair_boxes) -> (the
    least corner distance to a box over the tolerance of what float32
    corners resolve, 4 u + 1e-6 (w + h) with u = 2^-23 of the largest
    coordinate; the least area of the boxes within that tolerance, less
    the set's least area, over the tie band, the tie rule's relative 1e-5
    twice (for the two roundings) and 1e-9 px^2 for float64's own; ok: a
    box within both)."""
    from orientedreppoints_tpu_torch.ops.geometry import TIE_RTOL

    box, area = pair_boxes(points)
    least = area.amin(1, keepdim=True)
    r = rect.view(-1, 1, 4, 2).double()
    size = ((r[..., 1, :] - r[..., 0, :]).norm(dim=-1)
            + (r[..., 2, :] - r[..., 1, :]).norm(dim=-1))
    tol = 4 * 2.0 ** -23 * r.abs().amax((2, 3)) + 1e-6 * size
    over = torch.stack([(box - rr.roll(k, 2)).abs().amax((2, 3))
                        for rr in (r, r.flip(2)) for k in range(4)]
                       ).amin(0) / tol  # (n, pairs)
    band = (area - least) / (2 * TIE_RTOL * least + 1e-9)
    band = torch.where(over <= 1, band, math.inf).amin(1)
    return over.amin(1), band, band <= 1


def rect_check(got: torch.Tensor, want: torch.Tensor, points: torch.Tensor):
    """Min-area rects of the kernel against the plain version on the same
    point sets: (max corner error over the boxes that agree, boxes that
    differ by more than RECT_TOL, ok).  A differing box is accepted only
    as a tie: each of its two rects passes tie_check.  Areas of the
    float32 corners would not do: at 500 px their rounding moves the area
    of a sub-pixel rect by more than the tie rule.  Each box that fails is
    printed with its points, rects and readings."""
    err = rect_err(got, want)
    off = err > RECT_TOL
    ok = True
    if bool(off.any()):
        pts, g, w = points[off], got[off], want[off]
        (og, eg, okg), (ow, ew, okw) = tie_check(pts, g), tie_check(pts, w)
        bad = torch.nonzero(~(okg & okw))[:, 0]
        ok = not bad.numel()
        for k in bad[:4].tolist():
            say("rect_tie_failed", points=pts[k].tolist(), got=g[k].tolist(),
                want=w[k].tolist(), got_corner_err_over_tol=float(og[k]),
                want_corner_err_over_tol=float(ow[k]),
                got_tie_band_use=float(eg[k]), want_tie_band_use=float(ew[k]))
    return (float(err[~off].max()) if bool((~off).any()) else 0.0,
            int(off.sum()), ok)


def point_sets(rng, n):
    """n 9-point sets over a 1344^2 canvas; 1% coincident, 1% collinear."""
    pts = rng.uniform(0, 1344, (n, 1, 2)) + rng.normal(0, 24, (n, 9, 2))
    m = n // 100
    pts[:m] = pts[:m, :1]
    t = rng.integers(-8, 9, (m, 9, 1)).astype(np.float64)
    pts[m:2 * m] = np.round(pts[m:2 * m, :1]) + t * np.array([3.0, 1.0])
    return pts.reshape(n, 18)


def nms_quads(rng, b, n, classes=15):
    """Score-sorted-like quads: jittered copies of n/8 base boxes (many
    IoUs near the threshold), shifted by class as multiclass NMS does."""
    base = rng.integers(0, n // 8, (b, n))
    c = rng.uniform(0, 1344, (b, n // 8, 2))[np.arange(b)[:, None], base]
    c = c + rng.normal(0, 8, (b, n, 2))
    wh = rng.uniform(16, 96, (b, n, 2))
    ang = rng.uniform(0, np.pi, (b, n))
    lx = np.array([-0.5, 0.5, 0.5, -0.5]) * wh[..., :1]
    ly = np.array([-0.5, -0.5, 0.5, 0.5]) * wh[..., 1:]
    cs, sn = np.cos(ang)[..., None], np.sin(ang)[..., None]
    q = np.stack([cs * lx - sn * ly + c[..., :1],
                  sn * lx + cs * ly + c[..., 1:]], -1).reshape(b, n, 8)
    return q + (base % classes)[..., None] * 1345.0


def phase_kernels(dev, rng):
    from orientedreppoints_tpu_torch.ops import minarearect, quad_iou

    res = {}

    # min-area rect: the decode's B * sum(min(2000, HW)) = 25304 sets
    n = BATCH * sum(min(2000, h * w) for _, h, w in LEVELS)
    p = torch.tensor(point_sets(rng, n), dtype=torch.float32, device=dev)
    err, ties, ok = rect_check(minarearect.min_area_rect(p),
                               minarearect.min_area_rect_plain(p), p)
    # the hull output (the assigner's) must give the plain version's bits
    hull, count = minarearect.convex_hull_entry(p)
    hull_p, count_p = minarearect.convex_hull_plain(p)
    hull_exact = torch.equal(hull, hull_p) and torch.equal(count, count_p)
    res["min_area_rect"] = dict(
        max_abs_err=err, ok=ok and hull_exact,
        shape=[n, 18], hull_exact=hull_exact,
        hull_max_abs_err=float((hull - hull_p).abs().max()),
        ms=cuda_ms(lambda: minarearect.min_area_rect(p), 100),
        plain_ms=cuda_ms(lambda: minarearect.min_area_rect_plain(p), 3),
        hull_plain_ms=cuda_ms(lambda: minarearect.convex_hull_plain(p), 3),
        library_ms=None,
        # 72 bytes in, rect, hull and count (108 bytes) out a set
        **bound(n * (72 + 108), min_area_rect_ops(count_p)))
    say("kernel", name="min_area_rect", sets=n, ties=ties,
        tol_px=RECT_TOL, **res["min_area_rect"])

    # over-mask: B 4, N 4096 class-offset quads, nv = 4096; the scan over
    # the plain version's words
    q = torch.tensor(nms_quads(rng, BATCH, NQ), dtype=torch.float32,
                     device=dev)
    nv = torch.full((BATCH,), NQ, dtype=torch.int32, device=dev)
    res["quad_over_mask"], words = over_mask_case(
        lambda: quad_iou.quad_over_mask(q, NMS_THR, nv), q, nv)
    say("kernel", name="quad_over_mask", batch=BATCH, n=NQ,
        **res["quad_over_mask"])
    valid = torch.ones((BATCH, NQ), dtype=torch.bool, device=dev)
    res["nms_scan"] = scan_case(words, valid, nv)
    say("kernel", name="nms_scan", batch=BATCH, n=NQ, **res["nms_scan"])

    # paired DCN sampling over the 1344^2 batch-4 pyramid, C = 256, then
    # at the training and the 2016^2 TTA shapes
    rows = sum(b * h * w for b, h, w in LEVELS)
    errs, times = {}, {}
    for dt in (torch.float32, torch.bfloat16):
        errs[dt], times[dt] = dcn_forward_case(dev, LEVELS, dt, 5)
    lib_err, lib_ms = grid_sample_check(dev, rows, LEVELS, backward=False)
    res["deform_sample_pair"] = dict(
        max_abs_err=errs[torch.bfloat16][0],
        ok=all(e[1] for e in errs.values()) and lib_err <= LIBRARY_TOL,
        ms=times[torch.bfloat16][0], plain_ms=times[torch.bfloat16][1],
        library_ms=lib_ms, **bound(*dcn_bytes_ops(rows, 256, 9, 2, False)))
    say("kernel", name="deform_sample_pair", rows=rows, channels=256,
        max_abs_err_f32=errs[torch.float32][0],
        max_abs_err_bf16=errs[torch.bfloat16][0],
        bit_equal_f32=errs[torch.float32][1],
        bit_equal_bf16=errs[torch.bfloat16][1],
        ms_f32=times[torch.float32][0], plain_ms_f32=times[torch.float32][1],
        ms_bf16=times[torch.bfloat16][0],
        plain_ms_bf16=times[torch.bfloat16][1],
        library="grid_sample, one call per level, bf16",
        library_max_abs_err_f32=lib_err, library_tol=LIBRARY_TOL,
        **{k: res["deform_sample_pair"][k] for k in
           ("library_ms", "bound_ms", "bound_by", "ok")})
    for what, levels in (("train", TRAIN_LEVELS), ("tta_2016", TTA_LEVELS)):
        n = sum(b * h * w for b, h, w in levels)
        (err, same), (ms, plain_ms) = dcn_forward_case(dev, levels,
                                                       torch.bfloat16, 5)
        res["deform_sample_pair"]["ok"] &= same
        say("kernel_shape", name="deform_sample_pair", shape=what, rows=n,
            channels=256, dtype="bfloat16", max_abs_err=err, bit_equal=same,
            ms=ms, plain_ms=plain_ms, ok=same,
            **bound(*dcn_bytes_ops(n, 256, 9, 2, False)))

    # the single DCNv1's sampling (the same kernel at one table) at the
    # serving pyramid, bit for bit as the pair's
    for dt in (torch.float32, torch.bfloat16):
        errs[dt], times[dt] = dcn_forward_case(dev, LEVELS, dt, 5, 1)
    lib_err, lib_ms = grid_sample_check(dev, rows, LEVELS, backward=False,
                                        n_tables=1)
    res["deform_sample"] = dict(
        max_abs_err=errs[torch.bfloat16][0],
        ok=all(e[1] for e in errs.values()) and lib_err <= LIBRARY_TOL,
        ms=times[torch.bfloat16][0], plain_ms=times[torch.bfloat16][1],
        library_ms=lib_ms,
        **bound(*dcn_bytes_ops(rows, 256, 9, 2, False, n_tables=1)))
    say("kernel", name="deform_sample", rows=rows, channels=256,
        max_abs_err_f32=errs[torch.float32][0],
        max_abs_err_bf16=errs[torch.bfloat16][0],
        bit_equal_f32=errs[torch.float32][1],
        bit_equal_bf16=errs[torch.bfloat16][1],
        ms_f32=times[torch.float32][0], plain_ms_f32=times[torch.float32][1],
        ms_bf16=times[torch.bfloat16][0],
        plain_ms_bf16=times[torch.bfloat16][1],
        library="grid_sample, one call per level, bf16",
        library_max_abs_err_f32=lib_err, library_tol=LIBRARY_TOL,
        **{k: res["deform_sample"][k] for k in
           ("library_ms", "bound_ms", "bound_by", "ok")})
    return res


def dcn_forward_case(dev, levels, dt, reps, n_tables=2):
    """The DCN forward kernel (paired, or at n_tables 1 the single-table
    entry) against its plain version on seeded random tables and offsets
    (C 256, K 9): ((max error, bit equal), (kernel ms, plain ms))."""
    from orientedreppoints_tpu_torch.ops import deform_conv

    rows = sum(b * h * w for b, h, w in levels)
    tabs = [torch.randn(rows, 256, device=dev).to(dt)
            for _ in range(n_tables)]
    offs = (torch.randn(rows, 18, device=dev) * 3).to(dt)
    if n_tables == 2:
        kernel, plain = (deform_conv.deform_sample_pair,
                         deform_conv.deform_sample_pair_plain)
    else:
        kernel = lambda *a: (deform_conv.deform_sample(*a),)  # noqa: E731
        plain = lambda *a: (deform_conv.deform_sample_plain(*a),)  # noqa
    got = kernel(*tabs, offs, levels)
    want = plain(*tabs, offs, levels)
    err = max(float((g.float() - w.float()).abs().max())
              for g, w in zip(got, want))
    same = all(differing_bits(g, w) == 0 for g, w in zip(got, want))
    del got, want
    times = (cuda_ms(lambda: kernel(*tabs, offs, levels), reps),
             cuda_ms(lambda: plain(*tabs, offs, levels), 2))
    del tabs, offs
    torch.cuda.empty_cache()
    return (err, same), times


def grid_sample_check(dev, rows, levels, backward: bool, n_tables=2):
    """torch's grid_sample over the paired DCN's sample points (bilinear,
    zero padding; a pixel x lies at (2 x + 1) / w - 1), both
    tables as one 2C-channel map, one call per pyramid level; backward:
    its autograd backward (aten.grid_sampler_2d_backward).  Returns (max
    |grid_sample - plain version| in f32 over the outputs, relative to
    each output's largest element for the backward; the time of the calls
    in bf16).  n_tables 1: the single DCN, one C-channel map.  Offset grads are compared at samples more than CELL_EDGE
    from a pixel line only: there the gradient jumps from one cell's
    difference to the next, and the two formulations round the position
    differently."""
    from orientedreppoints_tpu_torch.ops import deform_conv

    c, k = 256, 9
    errs, ms = [], None
    for dt in (torch.float32, torch.bfloat16):
        tabs = [torch.randn(rows, c, device=dev).to(dt)
                for _ in range(n_tables)]
        offs = (torch.randn(rows, 2 * k, device=dev) * 3).to(dt)
        grads = ([torch.randn(rows, k * c, device=dev).to(dt)
                  for _ in range(n_tables)] if backward else None)
        base = deform_conv.dcn_base_offset(3).to(dev).view(k, 2)
        calls, start, edge = [], 0, []
        for b, h, w in levels:
            n = b * h * w
            off = offs[start:start + n].float().view(b, h, w, k, 2) + base
            py = off[..., 0] + torch.arange(h, device=dev).view(1, h, 1, 1)
            px = off[..., 1] + torch.arange(w, device=dev).view(1, 1, w, 1)
            grid = torch.stack([(2 * px + 1) / w - 1, (2 * py + 1) / h - 1],
                               -1).view(b, h * w * k, 1, 2).to(dt)
            frac = torch.stack([py, px], -1).frac().abs()
            edge.append((torch.minimum(frac, 1 - frac) < CELL_EDGE).any(-1)
                        .reshape(-1, k).repeat_interleave(2, 1))
            x = torch.cat([t[start:start + n] for t in tabs], 1)
            x = x.view(b, h, w, n_tables * c).permute(0, 3, 1,
                                                      2).contiguous()
            g = None
            if backward:
                g = torch.cat([gg[start:start + n].view(b, h * w * k, c)
                               for gg in grads], 2)
                g = g.permute(0, 2, 1)[..., None].contiguous()
            calls.append((x, grid, g, (b, h, w)))
            start += n

        def library():
            if backward:
                return [torch.ops.aten.grid_sampler_2d_backward(
                    g, x, grid, 0, 0, False, [True, True])
                    for x, grid, g, _ in calls]
            return [torch.nn.functional.grid_sample(
                x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=False) for x, grid, _, _ in calls]

        if dt == torch.bfloat16:
            ms = cuda_ms(library, 5) if dev.type == "cuda" else None
            break
        outs = library()
        if backward:
            want = (deform_conv.deform_sample_pair_backward_plain(
                *tabs, offs, *grads, levels) if n_tables == 2 else
                deform_conv.deform_sample_backward_plain(
                    *tabs, offs, *grads, levels))
            gtab = torch.cat([gx.permute(0, 2, 3, 1).reshape(-1,
                                                             n_tables * c)
                              for gx, _ in outs])
            goff = torch.cat([
                (gg.view(b, h, w, k, 2)
                 * torch.tensor([2 / w, 2 / h], device=dev)
                 ).flip(-1).reshape(-1, 2 * k)
                for (_, gg), (_, _, _, (b, h, w)) in zip(outs, calls)])
            goff = torch.where(torch.cat(edge), want[-1], goff)
            got = (*(gtab[:, i * c:(i + 1) * c] for i in range(n_tables)),
                   goff)
            errs = [float((x - y).abs().max() / y.abs().max())
                    for x, y in zip(got, want)]
        else:
            want = (deform_conv.deform_sample_pair_plain(*tabs, offs, levels)
                    if n_tables == 2 else
                    (deform_conv.deform_sample_plain(*tabs, offs, levels),))
            out = torch.cat([o.permute(0, 2, 1, 3).reshape(-1, k,
                                                           n_tables * c)
                             for o in outs])
            got = [out[..., i * c:(i + 1) * c].reshape(rows, -1)
                   for i in range(n_tables)]
            errs = [float((x - y).abs().max()) for x, y in zip(got, want)]
        del calls, outs, want, got
    return max(errs), ms


def rotated_gts(rng, h, w, n):
    """n rotated rectangles centred in an h x w image: long side 12-300 px,
    aspect 1-6, any angle -> (n, 8)."""
    long = rng.uniform(12, 300, n)
    short = long / rng.uniform(1, 6, n)
    c = rng.uniform(0, 1, (n, 2)) * [w, h]
    ang = rng.uniform(0, np.pi, n)
    lx = np.array([-0.5, 0.5, 0.5, -0.5]) * long[:, None]
    ly = np.array([-0.5, -0.5, 0.5, 0.5]) * short[:, None]
    cs, sn = np.cos(ang)[:, None], np.sin(ang)[:, None]
    return np.stack([cs * lx - sn * ly + c[:, :1],
                     sn * lx + cs * ly + c[:, 1:]], -1).reshape(n, 8)


def train_batch(rng, max_gt):
    """A seeded batch in the collated layout (data/loader.py): uint8
    canvases with content inside img_hw, TRAIN_GTS gts per image padded to
    max_gt, labels 1-15."""
    b = len(TRAIN_HW)
    images = np.zeros((b, TRAIN_CANVAS, TRAIN_CANVAS, 3), np.uint8)
    polys = np.zeros((b, max_gt, 8), np.float32)
    labels = np.zeros((b, max_gt), np.int32)
    valid = np.zeros((b, max_gt), bool)
    for i, (h, w) in enumerate(TRAIN_HW):
        images[i, :h, :w] = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        polys[i, :TRAIN_GTS] = rotated_gts(rng, h, w, TRAIN_GTS)
        labels[i, :TRAIN_GTS] = rng.integers(1, 16, TRAIN_GTS)
        valid[i, :TRAIN_GTS] = True
    return dict(images=images, gt_polys=polys, gt_labels=labels,
                gt_valid=valid, img_hw=np.array(TRAIN_HW, np.int32))


def phase_train_kernels(dev, rng):
    """The training step's kernels at its shapes: kernel 1's hulls of the
    B 2 x 37,606 point sets, hull IoU with G 512 gts of which 150 real, and
    the DCN backward, paired and single (75,212 rows, C 256)."""
    from orientedreppoints_tpu_torch.core import points
    from orientedreppoints_tpu_torch.ops import hull_iou, minarearect
    res = {}
    b = TRAIN_BATCH
    n = sum(h * w for _, h, w in TRAIN_LEVELS)
    g = 512  # the config's tpu.max_gt
    quads = np.zeros((b, g, 8), np.float32)
    for i, (h, w) in enumerate(TRAIN_HW):
        quads[i, :TRAIN_GTS] = rotated_gts(rng, h, w, TRAIN_GTS)
    quads = torch.tensor(quads, device=dev)
    pts = torch.tensor(point_sets(rng, b * n), dtype=torch.float32,
                       device=dev).view(b, n, 9, 2)
    # as convex_iou does: shift by the mean of all gt corners (padding too)
    shift = quads.view(b, -1, 2).mean(1)[:, None, None, :]
    sets = (pts - shift).reshape(b * n, 18).contiguous()
    hulls, counts = minarearect.convex_hull_entry(sets)
    hulls_p, counts_p = minarearect.convex_hull_plain(sets)
    hull_exact = torch.equal(hulls, hulls_p) and torch.equal(counts, counts_p)
    hull_ms = cuda_ms(lambda: minarearect.convex_hull_entry(sets), 20)
    hull_plain_ms = cuda_ms(lambda: minarearect.convex_hull_plain(sets), 3)
    hulls, counts = hulls.view(b, n, 9, 2), counts.view(b, n)
    q = (quads.view(b, g, 4, 2) - shift).reshape(b, g, 8).contiguous()
    # the step's masks: 150 valid gts, the points inside the true sizes
    gt_valid = torch.zeros((b, g), dtype=torch.bool, device=dev)
    gt_valid[:, :TRAIN_GTS] = True
    rows_valid = torch.cat(points.multi_level_valid_flags(
        (TRAIN_CANVAS, TRAIN_CANVAS), STRIDES,
        torch.tensor(TRAIN_HW, device=dev)), 1).contiguous()
    got = hull_iou.hull_quad_iou_matrix(hulls, counts, q, gt_valid,
                                        rows_valid)
    want = hull_iou.hull_quad_iou_matrix_plain(hulls, counts, q, gt_valid,
                                               rows_valid)
    bits = differing_bits(got, want)
    # the entry without masks, every pair computed
    got_all = hull_iou.hull_quad_iou_matrix(hulls, counts, q)
    bits_all = differing_bits(got_all, hull_iou.hull_quad_iou_matrix_plain(
        hulls, counts, q))
    del got_all
    exits = [0] * 5
    ops = clip_pair_ops(hulls, counts, q, lambda rows, cols: (
        rows_valid[:, rows[0, :, 0], None] & gt_valid[:, None, cols[0, 0]]),
        exits)
    live_pairs = int((rows_valid[:, :, None] & gt_valid[:, None, :]).sum())
    res["hull_quad_iou"] = dict(
        max_abs_err=float((got - want).abs().max()), differing_bits=bits,
        differing_bits_unmasked=bits_all,
        ok=bits == 0 and bits_all == 0 and hull_exact,
        pairs_iou_gt_0p1=int((want > 0.1).sum()),
        ms=cuda_ms(lambda: hull_iou.hull_quad_iou_matrix(
            hulls, counts, q, gt_valid, rows_valid), 10),
        ms_unmasked=cuda_ms(lambda: hull_iou.hull_quad_iou_matrix(
            hulls, counts, q), 10),
        plain_ms=cuda_ms(lambda: hull_iou.hull_quad_iou_matrix_plain(
            hulls, counts, q, gt_valid, rows_valid), 1),
        library_ms=None,
        # hulls, counts, quads and masks in; the (B, G, N) f32 matrix out;
        # the operations of the live pairs only
        **bound(hulls.numel() * 4 + counts.numel() * 4 + q.numel() * 4
                + gt_valid.numel() + rows_valid.numel() + got.numel() * 4,
                ops))
    say("kernel", name="hull_quad_iou", batch=b, hulls=n, gts=g,
        valid_gts=TRAIN_GTS, valid_rows=int(rows_valid.sum()),
        pairs=b * n * g, **exit_shares(exits, live_pairs),
        hull_sets=b * n, hull_exact=hull_exact, hull_ms=hull_ms,
        hull_plain_ms=hull_plain_ms, **res["hull_quad_iou"])
    del got, want

    # the min-area rect at the step's other two calls: APAA's rects of the
    # init and refine point sets of B x max_pos candidates
    apaa = torch.tensor(point_sets(rng, b * 1024), dtype=torch.float32,
                        device=dev)
    err, ties, ok = rect_check(minarearect.min_area_rect(apaa),
                               minarearect.min_area_rect_plain(apaa), apaa)
    hull_a, count_a = minarearect.convex_hull_entry(apaa)
    hull_ap, count_ap = minarearect.convex_hull_plain(apaa)
    exact = torch.equal(hull_a, hull_ap) and torch.equal(count_a, count_ap)
    res["min_area_rect_train"] = dict(ok=ok and exact and hull_exact)
    for what, x, counts in (("train_apaa", apaa, count_ap),
                            ("train_convex_iou", sets, counts_p)):
        say("kernel_shape", name="min_area_rect", shape=what,
            sets=int(x.shape[0]), max_abs_err=err if x is apaa else None,
            ties=ties if x is apaa else None, hull_exact=exact
            if x is apaa else hull_exact,
            ms=cuda_ms(lambda: minarearect.min_area_rect_kernel(x), 100),
            plain_ms=cuda_ms(lambda: minarearect.min_area_rect_plain(x), 3),
            **bound(x.shape[0] * (72 + 108), min_area_rect_ops(counts)))

    rows = sum(bb * h * w for bb, h, w in TRAIN_LEVELS)
    c, k = 256, 9
    for n_tables, name in ((2, "deform_sample_pair_backward"),
                           (1, "deform_sample_backward")):
        res[name] = dcn_backward_case(dev, rows, c, k, n_tables, name)
    return res


def piled_offsets(gen, levels, dt):
    """(rows, 18) offsets that send every sample of each level and image
    near one of PILE_TARGETS seeded pixels of its map."""
    from orientedreppoints_tpu_torch.ops import deform_conv

    dev = gen.device
    base = deform_conv.dcn_base_offset(3).to(dev).view(9, 2)
    offs = []
    for b, h, w in levels:
        yy, xx = torch.meshgrid(torch.arange(h, device=dev),
                                torch.arange(w, device=dev), indexing="ij")
        yx = torch.stack([yy, xx], -1).view(1, h * w, 1, 2).float()
        targets = torch.stack([
            torch.randint(0, h, (b, PILE_TARGETS), device=dev,
                          generator=gen),
            torch.randint(0, w, (b, PILE_TARGETS), device=dev,
                          generator=gen)], -1).float()
        pick = torch.randint(0, PILE_TARGETS, (b, h * w, 9), device=dev,
                             generator=gen)
        at = torch.gather(targets, 1, pick.view(b, -1, 1).expand(-1, -1, 2))
        at = at.view(b, h * w, 9, 2) + torch.rand(
            (b, h * w, 9, 2), device=dev, generator=gen)
        offs.append((at - yx - base).reshape(-1, 18))
    return torch.cat(offs).to(dt)


def dcn_backward_case(dev, rows, c, k, n_tables, name):
    """The DCN backward kernel (paired, or the single-table entry) against
    its plain version at the training step's shape, f32 and bf16 tables
    with f32 sample grads: the table grads bit for bit (the plain version
    under the step's deterministic settings, utils/determinism.py, whose
    index_add_ sums in the same order on the card), the offset grads
    against their own largest element; then twice on bf16 inputs whose
    corners pile up (piled_offsets): every output bit for bit from launch
    to launch, the table grads the plain version's; timed beside
    grid_sampler_2d_backward."""
    from orientedreppoints_tpu_torch.ops import deform_conv
    from orientedreppoints_tpu_torch.utils.determinism import deterministic

    if n_tables == 2:
        kernel = deform_conv.deform_sample_pair_backward
        plain = deform_conv.deform_sample_pair_backward_plain
    else:
        kernel = deform_conv.deform_sample_backward
        plain = deform_conv.deform_sample_backward_plain
    errs, times, table_bits = {}, {}, {}
    for dt in (torch.float32, torch.bfloat16):
        tabs = [torch.randn(rows, c, device=dev).to(dt)
                for _ in range(n_tables)]
        offs = (torch.randn(rows, 2 * k, device=dev) * 3).to(dt)
        # the sample grads come from the autograd node's f32 matmul
        grads = [torch.randn(rows, k * c, device=dev)
                 for _ in range(n_tables)]
        args = (*tabs, offs, *grads, TRAIN_LEVELS)
        got = kernel(*args)
        with deterministic():
            want = plain(*args)
        dname = str(dt).split(".")[-1]
        table_bits[dname] = [differing_bits(x, y)
                             for x, y in zip(got[:-1], want[:-1])]
        errs[dname] = (float((got[-1].float() - want[-1].float()).abs()
                             .max()),
                       max(float(want[-1].float().abs().max()), 1e-30))
        del got, want
        times[dname] = (cuda_ms(lambda: kernel(*args), 5),
                        cuda_ms(lambda: plain(*args), 1))
        del args, tabs, offs, grads
        torch.cuda.empty_cache()
    # the repeat: two launches on inputs whose corners pile up
    gen = torch.Generator(device=dev).manual_seed(SEED)
    tabs = [torch.randn(rows, c, device=dev, generator=gen).to(
        torch.bfloat16) for _ in range(n_tables)]
    grads = [torch.randn(rows, k * c, device=dev, generator=gen)
             for _ in range(n_tables)]
    args = (*tabs, piled_offsets(gen, TRAIN_LEVELS, torch.bfloat16), *grads,
            TRAIN_LEVELS)
    first, again = kernel(*args), kernel(*args)
    with deterministic():
        want = plain(*args)
    repeat_bits = [differing_bits(x, y) for x, y in zip(first, again)]
    piled_table_bits = [differing_bits(x, y)
                        for x, y in zip(first[:-1], want[:-1])]
    longest = int(torch.bincount(torch.cat([
        i[o] for i, o in zip(*deform_conv.pyramid_plan(
            TRAIN_LEVELS, args[n_tables], 3)[:2])])).max())
    piled_ms = cuda_ms(lambda: kernel(*args), 2)
    del first, again, want, args, tabs, grads
    torch.cuda.empty_cache()
    ok = (all(e <= DCN_BWD_RTOL[dname] * scale
              for dname, (e, scale) in errs.items())
          and not any(b for bits in table_bits.values() for b in bits)
          and not any(repeat_bits) and not any(piled_table_bits))
    lib_err, lib_ms = grid_sample_check(dev, rows, TRAIN_LEVELS,
                                        backward=True, n_tables=n_tables)
    torch.cuda.empty_cache()
    out = dict(
        max_abs_err=errs["bfloat16"][0],
        ok=ok and lib_err <= LIBRARY_TOL,
        ms=times["bfloat16"][0], plain_ms=times["bfloat16"][1],
        library_ms=lib_ms,
        **bound(*dcn_bytes_ops(rows, c, k, 2, True, n_tables=n_tables)))
    say("kernel", name=name, rows=rows, channels=c,
        table_grad_differing_bits=table_bits,
        offset_grad_max_abs_err={d: e for d, (e, _) in errs.items()},
        offset_grad_scale={d: s for d, (_, s) in errs.items()},
        rtol=DCN_BWD_RTOL, repeat_differing_bits=repeat_bits,
        piled_table_grad_differing_bits=piled_table_bits,
        piled_longest_row_entries=longest, piled_ms=piled_ms,
        ms_f32=times["float32"][0],
        plain_ms_f32=times["float32"][1], ms_bf16=times["bfloat16"][0],
        plain_ms_bf16=times["bfloat16"][1],
        library="aten.grid_sampler_2d_backward, one call per level, bf16",
        library_max_rel_err_f32=lib_err, library_tol=LIBRARY_TOL,
        **{key: out[key] for key in
           ("library_ms", "bound_ms", "bound_by", "ok")})
    return out


def phase_dcn_single(dev, ops_mod, card):
    """The single DCNv1's entry, deform_conv2d_pyramid, forward and
    backward at the training step's pyramid (75,212 rows, C 256 -> 256,
    bf16 features and offsets, an f32 weight), counted: the two
    single-table kernels launch once each; then the same through their
    plain versions (under the step's deterministic settings,
    utils/determinism.py): the outputs, the features' grads and the
    weight's grad bit for bit, the offsets' grads within DCN_BWD_RTOL of
    their largest element (the kernel sums them over channels in its own
    order); the op's ms (host clock, both passes)."""
    from orientedreppoints_tpu_torch.ops import deform_conv
    from orientedreppoints_tpu_torch.utils.determinism import deterministic

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=gen) * scale)

    feats = [randn(b, h, w, 256).to(torch.bfloat16)
             for b, h, w in TRAIN_LEVELS]
    offs = [randn(b, h, w, 18, scale=3.0).to(torch.bfloat16)
            for b, h, w in TRAIN_LEVELS]
    weight = randn(9, 256, 256, scale=0.02)
    cots = [randn(b, h, w, 256).to(torch.bfloat16)
            for b, h, w in TRAIN_LEVELS]

    def run():
        leaves = [t.detach().requires_grad_(True)
                  for t in feats + offs + [weight]]
        n = len(feats)
        t0 = time.perf_counter()
        outs = deform_conv.deform_conv2d_pyramid(leaves[:n],
                                                 leaves[n:2 * n], leaves[-1])
        torch.autograd.backward(outs, cots)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        return [o.detach() for o in outs], [t.grad for t in leaves], ms

    run()  # warm-up
    ops_mod.reset_launch_counts()
    outs, grads, ms = run()
    launches = ops_mod.launch_counts()
    with deterministic(), swapped([
            (deform_conv, "deform_sample", deform_conv.deform_sample_plain),
            (deform_conv, "deform_sample_backward",
             deform_conv.deform_sample_backward_plain)]):
        outs_p, grads_p, plain_ms = run()
    n = len(feats)
    outs_equal = all(torch.equal(a, b) for a, b in zip(outs, outs_p))
    feat_bits = [differing_bits(a, b) for a, b in zip(grads[:n],
                                                      grads_p[:n])]
    weight_equal = torch.equal(grads[-1], grads_p[-1])
    rel = [float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp_min(1e-30))
           for a, b in zip(grads[n:2 * n], grads_p[n:2 * n])]
    finite = all(bool(torch.isfinite(t.float()).all()) for t in outs + grads)
    ok = (launches["deform_sample"] == 1
          and launches["deform_sample_backward"] == 1 and finite
          and outs_equal and not any(feat_bits) and weight_equal
          and max(rel) <= DCN_BWD_RTOL["bfloat16"])
    say("dcn_single", rows=sum(b * h * w for b, h, w in TRAIN_LEVELS),
        channels=256, out_channels=256, dtype="bfloat16", launches={
            k: launches[k] for k in ("deform_sample",
                                     "deform_sample_backward")},
        outputs_bit_equal=outs_equal, feature_grad_differing_bits=feat_bits,
        weight_grad_bit_equal=weight_equal,
        offset_grad_max_rel_err=max(rel), rtol=DCN_BWD_RTOL["bfloat16"],
        finite=finite, fwd_bwd_ms=ms, plain_fwd_bwd_ms=plain_ms, card=card,
        ok=ok)
    return ok, launches


@contextlib.contextmanager
def swapped(swaps):
    """Set each (module, name, fn) of swaps for the duration, then put the
    originals back."""
    saved = [getattr(mod, name) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(swaps, saved):
            setattr(mod, name, fn)


def plain_quad_iou():
    """Route the f32 IoU entries (soft_rnms, box_iou_rotated) through the
    plain version on the card."""
    from orientedreppoints_tpu_torch.ops import nms, quad_iou

    plain = (lambda a, b: quad_iou.quad_iou_matrix_plain(a[None],
                                                         b[None])[0])
    return swapped([(nms, "quad_iou_matrix", plain),
                    (quad_iou, "quad_iou_matrix", plain)])


def differing_bits(a: torch.Tensor, b: torch.Tensor) -> int:
    """Elements of two f32 or bf16 tensors whose bits differ."""
    as_int = {4: torch.int32, 2: torch.int16}[a.element_size()]
    return int((a.view(as_int) != b.view(as_int)).sum())


def phase_quad_kernels(dev, rng):
    """Kernels 4 and 5 (full and upper-triangle f32 IoU) and the
    single-image over-mask at NMS shapes, each against its plain version;
    the over-mask bits against (tri > thr); soft_rnms and box_iou_rotated
    through the kernel and through the plain version."""
    from orientedreppoints_tpu_torch.ops import geometry, nms, quad_iou

    res = {}
    nq = NQ
    q4 = torch.tensor(nms_quads(rng, 4, nq), dtype=torch.float32,
                      device=dev)
    q = q4[0].contiguous()
    full = quad_iou.quad_iou_matrix(q, q)
    full_p = quad_iou.quad_iou_matrix_plain(q[None], q[None])[0]
    bits = differing_bits(full, full_p)
    exits = [0] * 5
    ops = clip_pair_ops(*quad_subjects(q[None]), q[None], exits=exits)
    res["quad_iou_full"] = dict(
        max_abs_err=float((full - full_p).abs().max()), differing_bits=bits,
        ok=bits == 0, iou_gt_0p4=int((full_p > NMS_THR).sum()),
        ms=cuda_ms(lambda: quad_iou.quad_iou_matrix(q, q), 10),
        plain_ms=cuda_ms(lambda: quad_iou.quad_iou_matrix_plain(
            q[None], q[None]), 1),
        library_ms=None,
        **bound(2 * q.numel() * 4 + full.numel() * 4, ops))
    say("kernel", name="quad_iou_full", n=nq, m=nq,
        **exit_shares(exits, nq * nq), **res["quad_iou_full"])
    del full, full_p

    nv = torch.tensor(TRI_NV, dtype=torch.int32, device=dev)
    tri = quad_iou.quad_iou_matrix_batch(q4, q4, True, nv)
    tri_p = quad_iou.quad_iou_matrix_plain(q4, q4, True, nv)
    bits = differing_bits(tri, tri_p)
    exits = [0] * 5
    ops = clip_pair_ops(*quad_subjects(q4), q4, tri_live(nv), exits)
    v = nv.to(torch.int64).clamp(0, nq)
    res["quad_iou_tri"] = dict(
        max_abs_err=float((tri - tri_p).abs().max()), differing_bits=bits,
        ok=bits == 0,
        ms=cuda_ms(lambda: quad_iou.quad_iou_matrix_batch(q4, q4, True, nv),
                   10),
        plain_ms=cuda_ms(lambda: quad_iou.quad_iou_matrix_plain(
            q4, q4, True, nv), 1),
        library_ms=None,
        **bound(2 * q4.numel() * 4 + nv.numel() * 4 + tri.numel() * 4, ops))
    say("kernel", name="quad_iou_tri", batch=4, n=nq, num_valid=TRI_NV,
        **exit_shares(exits, int((v * (v - 1) // 2).sum())),
        **res["quad_iou_tri"])
    del tri_p

    # the over-mask's bits are (tri > thr) of the same pairs, every bit
    mask = quad_iou.quad_over_mask(q4, NMS_THR, nv)
    over_vs_tri = int(quad_iou.unpack_bits(
        mask ^ quad_iou.pack_bits(tri > NMS_THR), nq).sum())
    del mask, tri
    res["quad_over_mask_single"], words = over_mask_case(
        lambda: quad_iou.quad_over_matrix(q, NMS_THR, nv[0])[None], q[None],
        nv[:1])
    res["quad_over_mask_single"].update(
        over_mask_vs_tri_differing_bits=over_vs_tri,
        ok=res["quad_over_mask_single"]["ok"] and over_vs_tri == 0)
    say("kernel", name="quad_over_mask_single", n=nq,
        **res["quad_over_mask_single"])

    # the scan at the merge's shape (one image), over the same words
    valid = torch.ones((1, nq), dtype=torch.bool, device=dev)
    scan = scan_case(words, valid, nv[:1])
    say("kernel_shape", name="nms_scan", batch=1, n=nq, **scan)
    same = scan["ok"]

    # the entries of kernel 4 through the kernel and the plain version
    qs = q[:nq // 2].contiguous()
    scores = torch.tensor(rng.uniform(0.05, 1.0, len(qs)),
                          dtype=torch.float32, device=dev)
    rb = torch.tensor(np.concatenate([rng.uniform(0, 1344, (3000, 2)),
                                      rng.uniform(8, 120, (3000, 2)),
                                      rng.uniform(-np.pi, np.pi, (3000, 1))],
                                     1), dtype=torch.float32, device=dev)
    runs = []
    for route in ("kernel", "plain"):
        with plain_quad_iou() if route == "plain" else \
                contextlib.nullcontext():
            runs.append((nms.soft_rnms(qs, scores),
                         geometry.box_iou_rotated(rb[:2000], rb[1000:])))
    ((sk, kk), bk), ((sp, kp), bp) = runs
    same_soft = bool(torch.equal(kk, kp)) and bool(torch.equal(sk, sp))
    bits = differing_bits(bk, bp)
    say("entries", soft_rnms_same_keep_and_scores=same_soft,
        soft_rnms_kept=int(kk.sum()), box_iou_rotated_differing_bits=bits,
        box_iou_rotated_pairs_gt_0p3=int((bp > 0.3).sum()),
        ok=same_soft and bits == 0)
    return res, same_soft and bits == 0 and same


def normalized_images(cfg, rng, n, size):
    """n seeded size^2 BGR uint8 images as the dataset items run_inference
    takes: normalized, and resized (bilinear, keep ratio) to fill the
    canvas, with that scale factor.  Random weights detect all over the
    canvas, padding included; filling it puts every det's origin inside
    the image, so that mapped back each must land in its size^2 frame."""
    from orientedreppoints_tpu_torch.host import Normalize, resize_linear

    norm = Normalize(**cfg["img_norm_cfg"])
    canvas = tuple(cfg["tpu"]["canvas_buckets"][-1])
    factor = min(canvas) / size
    side = int(size * factor + 0.5)
    items = []
    for i in range(n):
        img = norm(torch.from_numpy(
            (rng.random((size, size, 3)) * 255).astype(np.uint8)))
        items.append(dict(
            img=resize_linear(img[None], (side, side))[0].numpy(),
            scale_factor=factor, img_info=dict(file_name=f"img{i}.png")))
    return items


@contextlib.contextmanager
def wrapping(module, name, on_call):
    """Wrap module.name so that every call also passes (args, kwargs,
    result) to on_call."""
    fn = getattr(module, name)

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        on_call(args, kwargs, out)
        return out
    setattr(module, name, wrapped)
    try:
        yield
    finally:
        setattr(module, name, fn)


def recording(module, name, record):
    """Append (args, kwargs, result) of every call of module.name."""
    return wrapping(module, name, lambda *call: record.append(call))


def checking(module, name, plain, compare, record):
    """Also run plain on the inputs of every call of module.name and
    append compare(args, result, plain result) to record."""
    return wrapping(module, name, lambda args, kwargs, out: record.append(
        compare(args, out, plain(*args, **kwargs))))


def dcn_compare(args, got, want):
    """One paired-DCN forward call against its plain version: the
    pyramid's first level and rows, the max error, and ok if the two give
    the same bits."""
    err = max(float((g.float() - w.float()).abs().max())
              for g, w in zip(got, want))
    bits = sum(differing_bits(g, w) for g, w in zip(got, want))
    return dict(level0=list(args[3][0]), rows=int(args[0].shape[0]),
                dtype=str(got[0].dtype).split(".")[-1], max_abs_err=err,
                differing_bits=bits, ok=bits == 0)


def rect_compare(args, got, want):
    err, ties, ok = rect_check(got, want, args[0])
    return dict(sets=int(args[0].shape[0]), max_abs_err=err, ties=ties,
                median_area_px2=float(rect_area(want).median()), ok=ok)


def centres_in_frame(results, size):
    """(every det finite, dets whose centre lies in the size^2 image frame
    +- 8 px, dets within +- (8 px + FRAME_SPREAD), dets) over
    run_inference-style results."""
    dets = np.concatenate([a for per_class in results.values()
                           for a in per_class])
    c = np.stack([dets[:, 0:8:2].mean(1), dets[:, 1:8:2].mean(1)], 1)

    def inside(margin):
        return int(((c > -margin) & (c < size + margin)).all(1).sum())
    return (bool(np.isfinite(dets).all()), inside(8),
            inside(8 + FRAME_SPREAD), len(dets))


def phase_tta(model, cfg, test_cfg, dataset, ops_mod, card):
    from orientedreppoints_tpu_torch import apis

    canvas = tuple(cfg["tpu"]["canvas_buckets"][-1])

    def run(data, record=None):
        with (recording(apis, "decode_no_nms", record)
              if record is not None else contextlib.nullcontext()):
            out = apis.run_inference_tta(model, data, test_cfg, TTA_AUGS,
                                         canvas=canvas, batch_size=TTA_BATCH)
        torch.cuda.synchronize()
        return out

    run(dataset[:TTA_BATCH])  # warm-up batch
    torch.cuda.reset_peak_memory_stats()
    record = []
    ops_mod.reset_launch_counts()
    results = run(dataset, record)
    launches = ops_mod.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        run(dataset)
        times.append(time.perf_counter() - t0)

    # decode_no_nms calls: per batch, the augs of each scale in turn
    order = [ai for r in dict.fromkeys(r for r, _ in TTA_AUGS)
             for ai, (rr, _) in enumerate(TTA_AUGS) if rr == r]
    thr = test_cfg["score_thr"]
    per_aug = {ai: [] for ai in range(len(TTA_AUGS))}
    for i, (_, _, (boxes, scores)) in enumerate(record):
        per_aug[order[i % len(order)]] += (scores > thr).sum((1, 2)).tolist()
    for ai, (r, flip) in enumerate(TTA_AUGS):
        say("tta_aug", scale=r, flip=flip,
            candidates_per_image=per_aug[ai][:TTA_IMAGES])
    merged = [min(sum(per_aug[ai][i] for ai in per_aug),
                  test_cfg.get("pre_nms_cap", 4096))
              for i in range(TTA_IMAGES)]
    finite, near, within, dets = centres_in_frame(results, TTA_SIZE)
    kept = [sum(len(a) for a in results[f"img{i}"])
            for i in range(TTA_IMAGES)]
    ips = [TTA_IMAGES / t for t in times]
    ok = (len(results) == TTA_IMAGES and min(kept) > 0 and finite
          and within == dets and min(merged) >= 1000
          and all(launches[k] > 0 for k in TTA_KERNELS))
    say("tta", config=CONFIG, augs=TTA_AUGS, batch=TTA_BATCH,
        images=TTA_IMAGES, image_size=TTA_SIZE, dtype="bfloat16",
        merged_candidates_per_image=merged, dets_kept=kept,
        launches=launches, finite=finite, dets=dets,
        centres_within_8px_of_frame=near,
        centres_within_8px_plus_spread=within, spread_px=FRAME_SPREAD,
        images_per_s_median=statistics.median(ips), images_per_s=ips,
        max_memory_allocated_bytes=peak, card=card, ok=ok)
    return ok, launches


def merge_swaps():
    """The NMS's over-mask and scan -> their plain versions."""
    from orientedreppoints_tpu_torch.ops import nms, quad_iou

    return [(nms, "quad_over_mask", quad_iou.quad_over_mask_plain),
            (nms, "greedy_scan", nms.greedy_scan_plain)]


def plain_merge():
    """Route the TTA merge's NMS through the plain versions on the card."""
    return swapped(merge_swaps())


def numpy_iou():
    """Route the host library's polygon IoUs (poly_nms, soft_poly_nms, the
    Task1 / mAOE evaluators, evaluate_results) through the numpy
    poly_iou, a pair at a time: the plain version."""
    from orientedreppoints_tpu_torch import apis
    from orientedreppoints_tpu_torch.devkit import evaluation, native, polygon

    def quads(p):
        return np.asarray(p, np.float64).reshape(-1, 8)

    def pairs(p1, p2):
        p1 = quads(p1)
        p2 = np.broadcast_to(quads(p2), p1.shape)
        return np.array([polygon.poly_iou(a, b) for a, b in zip(p1, p2)],
                        np.float64)

    def one_many(q, polys):
        return np.array([polygon.poly_iou(q, b) for b in quads(polys)],
                        np.float64)

    return swapped([(native, "poly_iou_one_many", one_many),
                    (evaluation, "poly_iou_pairs", pairs),
                    (apis, "poly_iou_pairs", pairs)])


def same_dets(a, b) -> tuple[bool, float, float]:
    """(labels equal, max poly error px, max score error) of two
    (dets, labels, valid) triples."""
    (d, lab, v), (d2, lab2, v2) = a, b
    if not (torch.equal(v, v2) and torch.equal(lab[v], lab2[v])):
        return False, float("inf"), float("inf")
    return (True, float(rect_err(d[v][:, :8], d2[v][:, :8]).max()),
            float((d[v][:, 8] - d2[v][:, 8]).abs().max()))


def phase_tta_check(model, cfg, test_cfg, dataset):
    from orientedreppoints_tpu_torch import apis
    from orientedreppoints_tpu_torch.models import detector

    canvas = tuple(cfg["tpu"]["canvas_buckets"][-1])
    data = dataset[:TTA_BATCH]
    plain = apis.run_inference(model, data, test_cfg, canvas=canvas,
                               batch_size=TTA_BATCH)
    ident = apis.run_inference_tta(model, data, test_cfg, [(1.0, False)],
                                   canvas=canvas, batch_size=TTA_BATCH)
    same_labels, poly_err, score_err, dets = True, 0.0, 0.0, 0
    for name, per_class in plain.items():
        for a, b in zip(per_class, ident[name]):
            same_labels &= a.shape == b.shape
            if same_labels and len(a):
                poly_err = max(poly_err, float(rect_err(
                    torch.from_numpy(a[:, :8]),
                    torch.from_numpy(b[:, :8])).max()))
                score_err = max(score_err, float(np.abs(a[:, 8]
                                                        - b[:, 8]).max()))
                dets += len(a)
    ok_a = (same_labels and set(plain) == set(ident) and dets > 0
            and poly_err <= RECT_TOL and score_err == 0.0)

    # (b) one batch of the full recipe: every DCN forward and min-area-rect
    # call of the path (each scale's canvas) against its plain version on
    # the same inputs, then the merged candidates through the kernels and
    # through the plain over-mask and scan
    from orientedreppoints_tpu_torch.ops import deform_conv, geometry

    record, dcn, rects = [], [], []
    with recording(apis, "merge_aug_and_nms", record), \
            checking(deform_conv, "deform_sample_pair",
                     deform_conv.deform_sample_pair_plain, dcn_compare, dcn), \
            checking(detector, "min_area_rect", geometry.min_area_rect,
                     rect_compare, rects):
        apis.run_inference_tta(model, data, test_cfg, TTA_AUGS,
                               canvas=canvas, batch_size=TTA_BATCH)
    for name, calls in (("deform_sample_pair", dcn), ("min_area_rect", rects)):
        for c in calls:
            say("tta_kernel", name=name, **c)
    ok_b = (len(dcn) == len(rects) == len(TTA_AUGS)
            and all(c["ok"] for c in dcn + rects))
    errs = []
    with torch.inference_mode():
        for args, kwargs, out in record:
            with plain_merge():
                out_p = detector.merge_aug_and_nms(*args, **kwargs)
            same, pe, se = same_dets(out, out_p)
            errs.append((int(out[2].sum()), pe, se))
            ok_b &= same and pe <= RECT_TOL and se == 0.0
    say("tta_check", identity_same_labels=same_labels, identity_dets=dets,
        identity_max_err_poly_px=poly_err, identity_max_err_score=score_err,
        dcn_calls_checked=len(dcn), min_area_rect_calls_checked=len(rects),
        merge_dets_poly_err_score_err=errs, ok=ok_a and ok_b)
    return ok_a and ok_b, record


def phase_iou_path(record, ops_mod, test_cfg):
    """The f32 IoU kernels' path: soft_rnms over one image's merged TTA
    candidates (the top 2048 boxes by best class score) and the
    upper-triangle IoU entry over them, score-sorted with their valid
    prefix.  After the counted run: what kernel 4 is worth to its callers,
    soft_rnms end to end (host clock, median of 3; one host sync a pick)
    beside its IoU matrix alone, and box_iou_rotated over 2048 x 2048
    seeded boxes (device time)."""
    from orientedreppoints_tpu_torch.ops import geometry, nms, quad_iou

    args, _, _ = record[0]
    boxes = torch.cat(args[0])  # each aug in its test-scale frame
    scores = torch.cat(args[1])[:, 1:].amax(1)
    top, idx = nms.topk_stable(scores, 2048)
    quads = boxes[idx].contiguous()
    ops_mod.reset_launch_counts()
    with torch.inference_mode():
        decayed, keep = nms.soft_rnms(quads, top, method="gaussian")
        nv = (top > test_cfg["score_thr"]).sum(dtype=torch.int32)
        tri = quad_iou.quad_iou_matrix(quads, quads, upper_tri=True,
                                       num_valid=nv)
    torch.cuda.synchronize()
    launches = ops_mod.launch_counts()
    ok = (all(launches[k] > 0 for k in IOU_PATH_KERNELS)
          and bool(torch.isfinite(decayed).all()) and int(keep.sum()) > 0
          and bool(torch.isfinite(tri).all()))
    # picks: one host sync each, and one more for the pick that stops
    picks = int(keep.sum())
    soft_ms = []
    with torch.inference_mode():
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            nms.soft_rnms(quads, top, method="gaussian")
            torch.cuda.synchronize()
            soft_ms.append((time.perf_counter() - t0) * 1e3)
        rng = np.random.default_rng(SEED + 4)
        rb = torch.tensor(np.concatenate([
            rng.uniform(0, 1344, (2048, 2)), rng.uniform(8, 120, (2048, 2)),
            rng.uniform(-np.pi, np.pi, (2048, 1))], 1), dtype=torch.float32,
            device=quads.device)
        box_ms = cuda_ms(lambda: geometry.box_iou_rotated(rb, rb), 10)
        iou_ms = cuda_ms(lambda: quad_iou.quad_iou_matrix(quads, quads), 10)
    soft_med = statistics.median(soft_ms)
    say("iou_path", candidates=int(quads.shape[0]), num_valid=int(nv),
        soft_kept=picks, tri_pairs_gt_0p4=int((tri > 0.4).sum()),
        launches=launches, soft_rnms_ms_median=soft_med, soft_rnms_ms=soft_ms,
        soft_picks=picks,
        soft_host_syncs=picks + int(picks < quads.shape[0]),
        soft_ms_per_pick=soft_med / max(1, picks),
        soft_iou_matrix_ms=iou_ms, box_iou_rotated_ms=box_ms,
        box_iou_rotated_boxes=[2048, 2048], ok=ok)
    return ok, launches


@contextlib.contextmanager
def plain_inference(record):
    """Route run_inference through the plain versions of the DCN forward,
    the over-mask and the scan on the card, while the min-area rect runs
    its kernel and appends each call's check against its plain version
    to record (the two differ by rounding, up to RECT_TOL; equal inputs
    downstream keep the rest of the comparison exact)."""
    from orientedreppoints_tpu_torch.models import detector
    from orientedreppoints_tpu_torch.ops import deform_conv, geometry

    swaps = [(deform_conv, "deform_sample_pair",
              deform_conv.deform_sample_pair_plain)] + merge_swaps()
    with swapped(swaps), checking(detector, "min_area_rect",
                                  geometry.min_area_rect, rect_compare,
                                  record):
        yield


def same_results(a, b) -> bool:
    """run_inference results equal array for array."""
    return a.keys() == b.keys() and all(
        len(a[k]) == len(b[k]) and all(np.array_equal(x, y)
                                       for x, y in zip(a[k], b[k]))
        for k in a)


def count_lines(folder) -> int:
    return sum(open(os.path.join(folder, f)).read().count("\n")
               for f in os.listdir(folder))


def phase_eval(dev, ops_mod, card, wd):
    """The synthetic benchmark's evaluation path without training: render
    the val scenes, tile them, build the dataset from the config's test
    pipeline, run_inference with seeded weights (counted), the same tiles
    through the plain versions (det for det, Task1 files byte for byte),
    then write -> merge -> Task1 mAP and mAOE, an oracle of the scene
    labels (mAP 1, mAOE 0) and apis.evaluate_results on the tiles.  The
    scenes, tiles and json stay in wd (phase robustness scores them)."""
    from orientedreppoints_tpu_torch import apis
    from orientedreppoints_tpu_torch.data.synth import (SYNTH_CLASS_SPECS,
                                                        generate_synth_dota)
    from orientedreppoints_tpu_torch.devkit import evaluation, result_merge
    from orientedreppoints_tpu_torch.devkit.dota2coco import dota2coco_train
    from orientedreppoints_tpu_torch.devkit.dota_utils import (
        DOTA10_CLASSES, parse_dota_poly)
    from orientedreppoints_tpu_torch.devkit.img_split import ImgSplit
    from orientedreppoints_tpu_torch.host import load_config

    secs = {}
    clock = [time.perf_counter()]

    def stage(name):
        now = time.perf_counter()
        secs[name] = now - clock[0]
        clock[0] = now

    classnames = list(SYNTH_CLASS_SPECS)

    def path(*p):
        return os.path.join(wd, *p)

    names = generate_synth_dota(path("val_raw"), EVAL_SCENES,
                                size=EVAL_SCENE_SIZE,
                                n_objects=EVAL_OBJECTS, seed=EVAL_SEED,
                                prefix="V")
    stage("render_s")
    ImgSplit(path("val_raw"), path("val_split"), gap=EVAL_GAP,
             subsize=EVAL_SUBSIZE, ext=".npy", num_process=1).splitdata()
    stage("split_s")
    cfg = load_config(EVAL_CONFIG)
    cfg["data"]["test"].update(
        ann_file=dota2coco_train(path("val_split"), path("test.json"),
                                 ext=".npy"),
        img_prefix=path("val_split", "images"), test_mode=True)
    ds = apis.build_dataset(cfg["data"]["test"])
    stage("json_dataset_s")
    scene_gts = {n: parse_dota_poly(path("val_raw", "labelTxt",
                                         n + ".txt")) for n in names}
    say("eval_data", scenes=len(names), scene_size=EVAL_SCENE_SIZE,
        tiles=len(ds), tile_size=EVAL_SUBSIZE, gap=EVAL_GAP,
        scene_gts=sum(len(v) for v in scene_gts.values()),
        tile_gts=sum(len(a["labels"]) for a in ds.anns),
        tile_gts_difficult=sum(int(a["difficult"].astype(bool).sum())
                               for a in ds.anns), **secs)

    model, _ = apis.init_detector(
        cfg, state_dict=perturbed_weights(np.random.default_rng(SEED + 5),
                                          EVAL_CONFIG, EVAL_BIAS),
        compute_dtype=cfg["tpu"]["compute_dtype"], device=dev)
    tc = cfg["test_cfg"]
    kw = dict(canvas=tuple(cfg["tpu"]["canvas_buckets"][-1]),
              batch_size=EVAL_BATCH, num_fg=len(ds.CLASSES))
    clock[0] = time.perf_counter()
    apis.run_inference(model, ds, tc, max_images=EVAL_BATCH, **kw)
    torch.cuda.synchronize()
    stage("warmup_batch_s")
    torch.cuda.reset_peak_memory_stats()
    ops_mod.reset_launch_counts()
    results = apis.run_inference(model, ds, tc, **kw)
    torch.cuda.synchronize()
    launches = ops_mod.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        apis.run_inference(model, ds, tc, **kw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    clock[0] = time.perf_counter()

    rects = []
    with plain_inference(rects):
        results_plain = apis.run_inference(model, ds, tc, **kw)
    torch.cuda.synchronize()
    stage("plain_inference_s")
    same = same_results(results, results_plain)
    result_merge.write_task1_results(results, DOTA10_CLASSES,
                                     path("task1_raw"))
    stage("write_task1_s")
    result_merge.write_task1_results(results_plain, DOTA10_CLASSES,
                                     path("task1_plain"))
    task1_equal = all(
        open(path("task1_raw", f), "rb").read()
        == open(path("task1_plain", f), "rb").read()
        for f in os.listdir(path("task1_raw")))
    clock[0] = time.perf_counter()
    result_merge.merge_by_poly(path("task1_raw"), path("task1_merged"))
    stage("merge_s")
    detpath = path("task1_merged", "Task1_{:s}.txt")
    annopath = path("val_raw", "labelTxt", "{:s}.txt")
    mAP, aps = evaluation.eval_dota_task1(detpath, annopath, names,
                                          classnames=classnames,
                                          use_07_metric=False)
    stage("eval_task1_s")
    mAOE, aoes, mod90, _ = evaluation.eval_maoe(
        detpath, annopath, names, classnames=classnames, ovthresh=0.7,
        return_mod90=True)
    stage("eval_maoe_s")
    # the same scoring through the numpy IoU, a pair at a time (before
    # the host library): the same scores
    with numpy_iou():
        np_task1 = evaluation.eval_dota_task1(
            detpath, annopath, names, classnames=classnames,
            use_07_metric=False)
        stage("eval_task1_numpy_s")
        np_maoe = evaluation.eval_maoe(
            detpath, annopath, names, classnames=classnames, ovthresh=0.7,
            return_mod90=True)
        stage("eval_maoe_numpy_s")
    scores_equal = (same_scores(np_task1, (mAP, aps))
                    and same_scores(np_maoe[:3], (mAOE, aoes, mod90)))

    # the oracle: each scene's labels as its detections, score 1, in
    # float64 (printed as labelTxt prints them)
    oracle = {n: [np.array([list(o["poly"]) + [1.0] for o in objs
                            if o["name"] == c], np.float64).reshape(-1, 9)
                  for c in DOTA10_CLASSES]
              for n, objs in scene_gts.items()}
    result_merge.write_task1_results(oracle, DOTA10_CLASSES,
                                     path("oracle"))
    oracle_det = path("oracle", "Task1_{:s}.txt")
    o_map, o_aps = evaluation.eval_dota_task1(
        oracle_det, annopath, names, classnames=classnames,
        use_07_metric=False)
    o_maoe, _ = evaluation.eval_maoe(oracle_det, annopath, names,
                                     classnames=classnames, ovthresh=0.7)
    stage("oracle_s")
    tile_map, _ = apis.evaluate_results(results, ds)
    stage("evaluate_results_s")
    with numpy_iou():
        scores_equal &= same_scores(apis.evaluate_results(results, ds)[0],
                                    tile_map)
    stage("evaluate_results_numpy_s")
    dets_tiles = [sum(len(a) for a in per_class)
                  for per_class in results.values()]
    dets_merged = count_lines(path("task1_merged"))
    per_class = {c: sum(len(r[i]) for r in results.values())
                 for i, c in enumerate(DOTA10_CLASSES)}

    tiles = len(dets_tiles)
    # the oracle's AP sums its recall steps in float64: 1 within 1e-12
    ok_oracle = abs(o_map - 1.0) <= 1e-12 and o_maoe == 0.0
    ok = (all(launches[k] > 0 for k in SERVING_KERNELS)
          and min(dets_tiles) > 0 and tiles == len(ds) and same
          and task1_equal and len(rects) == launches["min_area_rect"]
          and all(r["ok"] for r in rects) and ok_oracle and scores_equal
          and bool(np.isfinite([mAP, mAOE, mod90, tile_map]).all()))
    say("eval", config=EVAL_CONFIG, batch=EVAL_BATCH,
        dtype=cfg["tpu"]["compute_dtype"],
        tiles=tiles, launches=launches,
        tiles_per_s_median=statistics.median(tiles / t for t in times),
        tiles_per_s=[tiles / t for t in times],
        max_memory_allocated_bytes=peak,
        dets_per_tile_min=min(dets_tiles), dets_per_tile_max=max(dets_tiles),
        dets_tiles=sum(dets_tiles), dets_merged=dets_merged,
        dets_per_class={c: n for c, n in per_class.items() if n},
        plain_equal_det_for_det=same, task1_byte_equal=task1_equal,
        min_area_rect_calls_checked=len(rects),
        min_area_rect_max_err=max(r["max_abs_err"] for r in rects),
        min_area_rect_ties=sum(r["ties"] for r in rects),
        mAP=mAP, per_class_ap=aps, mAOE_deg=mAOE, per_class_aoe=aoes,
        mAOE_mod90_deg=mod90, oracle_mAP=o_map, oracle_mAOE_deg=o_maoe,
        oracle_per_class_ap=o_aps, evaluate_results_mAP=tile_map,
        scores_equal_numpy_iou=scores_equal, **secs, card=card, ok=ok)
    return ok, launches


def same_scores(a, b) -> bool:
    """Equal floats, NaN equal to NaN, through tuples and dicts."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            same_scores(a[k], b[k]) for k in a)
    if isinstance(a, tuple):
        return len(a) == len(b) and all(map(same_scores, a, b))
    return a == b or (np.isnan(a) and np.isnan(b))



def phase_visual(dev, ops_mod, card, wd):
    """tools/browse_dataset_torch.py and tools/show_points_and_boxes_torch
    .py in this process on the eval phase's tiles (in wd) with EVAL_CONFIG
    (R-18, bf16, canvas 512^2) and the eval phase's seeded weights from a
    state dict file, VISUAL_IMAGES images each: the tiles through the
    config's train pipeline (seed SEED) with their gts drawn, and the
    test split through the model on the card at VISUAL_SCORE_THR,
    counted; each PNG read back through data/image_io."""
    from orientedreppoints_tpu_torch.data import image_io
    from orientedreppoints_tpu_torch.utils import visualize

    t_phase = time.perf_counter()
    with open(EVAL_CONFIG) as f:
        text = f.read()
    for split in ("train", "test"):
        text += (f"\ndata[{split!r}].update(ann_file="
                 f"{os.path.join(wd, 'test.json')!r}, img_prefix="
                 f"{os.path.join(wd, 'val_split', 'images')!r})\n")
    config = os.path.join(wd, "visual.py")
    with open(config, "w") as f:
        f.write(text)
    weights = os.path.join(wd, "visual_w.pt")
    torch.save(perturbed_weights(np.random.default_rng(SEED + 5),
                                 EVAL_CONFIG, EVAL_BIAS), weights)
    out = {t: os.path.join(wd, t) for t in ("browse", "show")}
    gts, dets, secs = [], [], {}
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()), wrapping(
            visualize, "draw_gts", lambda a, kw, r: gts.append(len(a[1]))):
        rc_browse = load_tool("browse_dataset_torch").main(
            [config, "--split", "train", "--output-dir", out["browse"],
             "--num", str(VISUAL_IMAGES), "--seed", str(SEED)])
    secs["browse_s"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    ops_mod.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()), wrapping(
            visualize, "draw_dets", lambda a, kw, r: dets.append(r)):
        rc_show = load_tool("show_points_and_boxes_torch").main(
            [config, "--checkpoint", weights, "--split", "test",
             "--output-dir", out["show"], "--num", str(VISUAL_IMAGES),
             "--score-thr", str(VISUAL_SCORE_THR), "--device", str(dev)])
    torch.cuda.synchronize()
    secs["show_s"] = time.perf_counter() - t0
    launches = ops_mod.launch_counts()
    files = {t: sorted(os.listdir(d)) for t, d in out.items()}
    shapes = {t: [list(image_io.imread(os.path.join(out[t], f)).shape)
                  for f in names] for t, names in files.items()}
    ok = (rc_browse == rc_show == 0
          and all(len(v) == VISUAL_IMAGES for v in files.values())
          and all(len(sh) == 3 and sh[2] == 3 for v in shapes.values()
                  for sh in v)
          and len(gts) == len(dets) == VISUAL_IMAGES
          and sum(gts) > 0 and sum(dets) > 0
          and all(launches[k] > 0 for k in SERVING_KERNELS))
    say("visual", config=EVAL_CONFIG, images=VISUAL_IMAGES,
        score_thr=VISUAL_SCORE_THR, files=files, shapes=shapes,
        gts_drawn=gts, dets_drawn=dets, launches=launches, **secs,
        phase_s=time.perf_counter() - t_phase, card=card, ok=ok)
    return ok, launches


def hard_val_set(wd, n, hard, specs=None):
    """n val scenes of EVAL_SCENE_SIZE^2 (hard, or with specs' classes)
    rendered under wd, cut into EVAL_SUBSIZE^2 tiles, and the dataset of
    HARD_CONFIG's test pipeline over them -> (scene names, dataset,
    config)."""
    from orientedreppoints_tpu_torch import apis
    from orientedreppoints_tpu_torch.data.synth import generate_synth_dota
    from orientedreppoints_tpu_torch.devkit.dota2coco import dota2coco_train
    from orientedreppoints_tpu_torch.devkit.img_split import ImgSplit
    from orientedreppoints_tpu_torch.host import load_config

    names = generate_synth_dota(os.path.join(wd, "val_raw"), n,
                                size=EVAL_SCENE_SIZE, n_objects=EVAL_OBJECTS,
                                seed=EVAL_SEED, prefix="V", hard=hard,
                                specs=specs)
    ImgSplit(os.path.join(wd, "val_raw"), os.path.join(wd, "val_split"),
             gap=EVAL_GAP, subsize=EVAL_SUBSIZE, ext=".npy",
             num_process=1).splitdata()
    cfg = load_config(HARD_CONFIG)
    cfg["data"]["test"].update(
        ann_file=dota2coco_train(os.path.join(wd, "val_split"),
                                 os.path.join(wd, "test.json"), ext=".npy"),
        img_prefix=os.path.join(wd, "val_split", "images"), test_mode=True)
    return names, apis.build_dataset(cfg["data"]["test"]), cfg


@contextlib.contextmanager
def tta_stage_clock(model, stages):
    """Add to stages each TTA stage's seconds, the card synchronized at
    every boundary: resize (the scale canvases), forward_decode (the model
    and decode_no_nms of each aug, in call order), merge (unflip, unscale,
    concatenate) and nms (multiclass_rnms)."""
    from orientedreppoints_tpu_torch import apis
    from orientedreppoints_tpu_torch.models import detector

    def now():
        torch.cuda.synchronize()
        return time.perf_counter()

    mark = {}

    def timed(fn, key):
        def run(*args, **kwargs):
            t0 = now()
            out = fn(*args, **kwargs)
            stages[key] = stages.get(key, 0.0) + now() - t0
            return out
        return run

    def decode(*args, **kwargs):
        out = decode_fn(*args, **kwargs)
        stages["forward_decode"].append(now() - mark["forward"])
        return out

    def merge(*args, **kwargs):
        mark["merge"] = now()
        return merge_fn(*args, **kwargs)

    def rnms(*args, **kwargs):
        t0 = now()
        stages["merge"] = stages.get("merge", 0.0) + t0 - mark["merge"]
        out = rnms_fn(*args, **kwargs)
        stages["nms"] = stages.get("nms", 0.0) + now() - t0
        return out

    decode_fn, merge_fn = apis.decode_no_nms, apis.merge_aug_and_nms
    rnms_fn = detector.multiclass_rnms
    stages.setdefault("forward_decode", [])
    hook = model.register_forward_pre_hook(
        lambda *_: mark.__setitem__("forward", now()))
    swaps = [(apis, "resize_linear", timed(apis.resize_linear, "resize")),
             (apis, "decode_no_nms", decode),
             (apis, "merge_aug_and_nms", merge),
             (detector, "multiclass_rnms", rnms)]
    try:
        with swapped(swaps):
            yield
    finally:
        hook.remove()


def phase_hard_eval(dev, ops_mod, card):
    """The hard benchmark's evaluation and TTA paths and the HRSC scorer:
    HARD_SCENES hard val scenes tiled and loaded through HARD_CONFIG's
    test pipeline; run_inference with seeded R-18 weights (counted), the
    same tiles through the plain versions (Task1 files byte for byte),
    merge and Task1 mAP / mAOE; run_inference_tta with TTA_AUGS (counted),
    each aug's candidates and its dets alone, and one timed pass split
    into its stages; then HRSC_SCENES ship-only scenes scored by
    eval_hrsc2016, with the scene labels as detections (AP 1)."""
    from orientedreppoints_tpu_torch import apis
    from orientedreppoints_tpu_torch.data.synth import (
        SYNTH_CLASS_SPECS, SYNTH_HARD_CLASS_SPECS)
    from orientedreppoints_tpu_torch.devkit import evaluation, result_merge
    from orientedreppoints_tpu_torch.devkit.dota_utils import (
        DOTA10_CLASSES, parse_dota_poly)
    from orientedreppoints_tpu_torch.devkit.hrsc import eval_hrsc2016

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as wd:
        def path(*p):
            return os.path.join(wd, *p)

        names, ds, cfg = hard_val_set(path("hard"), HARD_SCENES, True)
        model, _ = apis.init_detector(
            cfg, state_dict=perturbed_weights(np.random.default_rng(SEED + 6),
                                              HARD_CONFIG, EVAL_BIAS),
            compute_dtype=cfg["tpu"]["compute_dtype"], device=dev)
        tc = cfg["test_cfg"]
        canvas = tuple(cfg["tpu"]["canvas_buckets"][-1])
        kw = dict(canvas=canvas, batch_size=EVAL_BATCH,
                  num_fg=len(ds.CLASSES))
        apis.run_inference(model, ds, tc, max_images=EVAL_BATCH, **kw)
        ops_mod.reset_launch_counts()
        results = apis.run_inference(model, ds, tc, **kw)
        torch.cuda.synchronize()
        launches = ops_mod.launch_counts()
        rects = []
        with plain_inference(rects):
            results_plain = apis.run_inference(model, ds, tc, **kw)
        same = same_results(results, results_plain)
        result_merge.write_task1_results(results, DOTA10_CLASSES,
                                         path("task1_raw"))
        result_merge.write_task1_results(results_plain, DOTA10_CLASSES,
                                         path("task1_plain"))
        task1_equal = all(
            open(path("task1_raw", f), "rb").read()
            == open(path("task1_plain", f), "rb").read()
            for f in os.listdir(path("task1_raw")))
        result_merge.merge_by_poly(path("task1_raw"), path("task1_merged"))
        detpath = path("task1_merged", "Task1_{:s}.txt")
        annopath = path("hard", "val_raw", "labelTxt", "{:s}.txt")
        classnames = list(SYNTH_HARD_CLASS_SPECS)
        mAP, _ = evaluation.eval_dota_task1(detpath, annopath, names,
                                            classnames=classnames,
                                            use_07_metric=False)
        mAOE, _ = evaluation.eval_maoe(detpath, annopath, names,
                                       classnames=classnames, ovthresh=0.7)

        # TTA: the counted run with each aug's candidates, then each aug
        # alone for its dets, then one pass timed stage by stage
        tta_kw = dict(canvas=canvas, batch_size=TTA_BATCH,
                      num_fg=len(ds.CLASSES))
        apis.run_inference_tta(model, ds, tc, TTA_AUGS, max_images=TTA_BATCH,
                               **tta_kw)
        record = []
        ops_mod.reset_launch_counts()
        with recording(apis, "decode_no_nms", record):
            results_tta = apis.run_inference_tta(model, ds, tc, TTA_AUGS,
                                                 **tta_kw)
        torch.cuda.synchronize()
        launches_tta = ops_mod.launch_counts()
        order = [ai for r in dict.fromkeys(r for r, _ in TTA_AUGS)
                 for ai, (rr, _) in enumerate(TTA_AUGS) if rr == r]
        cands = [0] * len(TTA_AUGS)
        for i, (_, _, (_, scores)) in enumerate(record):
            cands[order[i % len(order)]] += int(
                (scores > tc["score_thr"]).sum())
        for ai, aug in enumerate(TTA_AUGS):
            alone = apis.run_inference_tta(model, ds, tc, [aug], **tta_kw)
            say("hard_eval_tta_aug", scale=aug[0], flip=aug[1],
                candidates=cands[ai],
                dets=sum(len(a) for v in alone.values() for a in v))
        stages = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with tta_stage_clock(model, stages):
            apis.run_inference_tta(model, ds, tc, TTA_AUGS, **tta_kw)
        total = time.perf_counter() - t0
        per_aug = [0.0] * len(TTA_AUGS)
        for i, sec in enumerate(stages["forward_decode"]):
            per_aug[order[i % len(order)]] += sec
        split = dict(
            forward_decode_ms={f"{r}{'_flip' if f else ''}": per_aug[ai] * 1e3
                               for ai, (r, f) in enumerate(TTA_AUGS)},
            resize_ms=stages.get("resize", 0.0) * 1e3,
            merge_ms=stages.get("merge", 0.0) * 1e3,
            nms_ms=stages.get("nms", 0.0) * 1e3, total_ms=total * 1e3)
        split["other_ms"] = split["total_ms"] - sum(
            split["forward_decode_ms"].values()) - sum(
            split[k] for k in ("resize_ms", "merge_ms", "nms_ms"))
        tta_dets = sum(len(a) for v in results_tta.values() for a in v)
        finite = all(np.isfinite(a).all() for r in (results, results_tta)
                     for v in r.values() for a in v)

        # HRSC: ship-only scenes, their dets and their labels scored by the
        # VOC-07 HRSC evaluator
        hnames, hds, _ = hard_val_set(path("hrsc"), HRSC_SCENES, False,
                                      {"ship": SYNTH_CLASS_SPECS["ship"]})
        hres = apis.run_inference(model, hds, tc, **kw)
        result_merge.write_task1_results(hres, DOTA10_CLASSES,
                                         path("hrsc_raw"))
        result_merge.merge_by_poly(path("hrsc_raw"), path("hrsc_merged"))
        hanno = path("hrsc", "val_raw", "labelTxt", "{:s}.txt")
        hrsc_ap = float(eval_hrsc2016(path("hrsc_merged", "Task1_{:s}.txt"),
                                      hanno, hnames))
        oracle = {n: [np.array([list(o["poly"]) + [1.0]
                                for o in parse_dota_poly(hanno.format(n))
                                if o["name"] == c], np.float64).reshape(-1, 9)
                      for c in DOTA10_CLASSES] for n in hnames}
        result_merge.write_task1_results(oracle, DOTA10_CLASSES,
                                         path("oracle"))
        hrsc_oracle = float(eval_hrsc2016(path("oracle", "Task1_{:s}.txt"),
                                          hanno, hnames))
        hrsc_gts = sum(len(parse_dota_poly(hanno.format(n))) for n in hnames)

    secs = time.perf_counter() - t_phase
    ok = (all(launches[k] > 0 for k in SERVING_KERNELS)
          and all(launches_tta[k] > 0 for k in TTA_KERNELS)
          and same and task1_equal and len(rects) == launches["min_area_rect"]
          and all(r["ok"] for r in rects) and finite and tta_dets > 0
          and min(cands) > 0 and bool(np.isfinite([mAP, mAOE, hrsc_ap]).all())
          and abs(hrsc_oracle - 1.0) <= 1e-12)
    say("hard_eval_tta_split", config=HARD_CONFIG, augs=TTA_AUGS,
        batch=TTA_BATCH, tiles=len(ds), **split, card=card)
    say("hard_eval", config=HARD_CONFIG, scenes=len(names), tiles=len(ds),
        launches=launches, tta_launches=launches_tta,
        plain_equal_det_for_det=same, task1_byte_equal=task1_equal,
        min_area_rect_calls_checked=len(rects),
        dets_tiles=sum(len(a) for v in results.values() for a in v),
        mAP=mAP, mAOE_deg=mAOE, tta_dets=tta_dets, finite=finite,
        hrsc_scenes=len(hnames), hrsc_gts=hrsc_gts, hrsc_ap07=hrsc_ap,
        hrsc_oracle_ap07=hrsc_oracle, phase_s=secs, card=card, ok=ok)
    return ok, launches, launches_tta


def perturbed_weights(rng, config=CONFIG, bias_range=(-2.0, 1.0)):
    """Seeded random weights of config with cls_out's bias drawn from
    bias_range (above score_thr) and the point convs scaled up, so that
    the decode sees thousands of candidates and spread point sets (random
    init scores ~0.0099 everywhere and puts all 9 points together).

    A Swin backbone's biases and LayerNorm affines also get a normal
    draw of std SWIN_NORM_STD, as trained weights have them: with the
    init's zero biases, a token of the canvas's zero padding stays
    exactly 0 through the backbone, every LayerNorm there has variance 0
    and scales its grad by 1 / sqrt(1e-6), and the grads overflow f32
    within the backbone's depth (the JAX package's LayerNorm gives the
    same grads: 2.856e26 at the patch embedding's bias on a 448^2 canvas
    padded from 320 x 384, in both)."""
    from orientedreppoints_tpu_torch.apis import init_detector

    model, _ = init_detector(config, compute_dtype="float32", device="cpu",
                             seed=SEED)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    bias = sd["bbox_head.cls_out.bias"]
    sd["bbox_head.cls_out.bias"] = torch.from_numpy(
        rng.uniform(*bias_range, bias.shape).astype(np.float32))
    for name in ("pts_init_out", "pts_refine_out"):
        sd[f"bbox_head.{name}.weight"] *= PTS_SCALE
    if model.backbone_type == "swin":
        for k, v in sd.items():
            if k.startswith("backbone.") and v.dim() == 1:
                sd[k] = v + torch.from_numpy(rng.normal(
                    0.0, SWIN_NORM_STD, v.shape).astype(np.float32))
    return sd


def candidates(outs, tc):
    """Per-image count of (box, class) pairs entering NMS: the decode's
    top nms_pre rows per level, scores above score_thr, capped."""
    from orientedreppoints_tpu_torch.ops.nms import topk_stable

    counts = 0
    for s in outs["cls_scores"]:
        b, h, w, c = s.shape
        sc = torch.sigmoid(s.reshape(b, h * w, c).float())
        top = topk_stable(sc.amax(-1), min(tc["nms_pre"], h * w))[1]
        sc = torch.gather(sc, 1, top[..., None].expand(-1, -1, c))
        counts = counts + (sc > tc["score_thr"]).sum((1, 2))
    return counts.clamp(max=tc.get("pre_nms_cap", 4096)).tolist()


def phase_host(dev, rng):
    """host.imrescale (cv2's uint8 INTER_LINEAR in int32) on the card
    against the same call on the CPU, at sizes that resize under the demo
    config's (1333, 1024) test scale: integer arithmetic, so equal."""
    from orientedreppoints_tpu_torch.host import imrescale

    ok, lines = True, []
    for h, w in ((1023, 767), (1500, 2000), (800, 800)):
        img = torch.from_numpy(rng.integers(0, 256, (h, w, 3),
                                            dtype=np.uint8))
        want, factor = imrescale(img, (1333, 1024))
        got, factor_dev = imrescale(img.to(dev), (1333, 1024))
        same = (got.dtype == want.dtype == torch.uint8
                and factor_dev == factor
                and torch.equal(got.cpu(), want))
        ok &= same
        lines.append(dict(size=[h, w], out=list(want.shape[:2]),
                          equal=same))
    say("host", name="imrescale", cases=lines, ok=ok)
    return ok


def phase_slice(dev, rng, ops_mod, card, config=CONFIG, phase="slice"):
    from orientedreppoints_tpu_torch.serving import Predictor

    pred = Predictor(config, state_dict=perturbed_weights(rng, config),
                     batch_size=BATCH, compute_dtype="bfloat16", device=dev)
    images = [(rng.random((1024, 1024, 3)) * 255).astype(np.uint8)
              for _ in range(N_IMAGES)]
    pred(images[:BATCH])  # warm-up batch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops_mod.reset_launch_counts()
    out = pred(images)
    torch.cuda.synchronize()
    launches = ops_mod.launch_counts()
    peak = torch.cuda.max_memory_allocated()

    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        pred(images)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)

    cand, first_outs = [], None
    with torch.inference_mode():
        for lo in range(0, N_IMAGES, BATCH):
            outs = pred.model(pred.prepare(images[lo:lo + BATCH])[0])
            cand += candidates(outs, pred.test_cfg)
            first_outs = first_outs or outs
        # the backbone alone on the first batch's canvases, device time
        x = pred.prepare(images[:BATCH])[0].to(pred.model.dtype)
        if pred.model.backbone_type != "swin":
            x = x.permute(0, 3, 1, 2).contiguous(
                memory_format=torch.channels_last)
        backbone_ms = cuda_ms(lambda: pred.model.backbone(x), 5)
        del x
    kept = [sum(len(a) for a in per_class) for per_class in out]
    finite = all(np.isfinite(a).all() for per_class in out
                 for a in per_class) and all(
        bool(torch.isfinite(t.float()).all()) for ts in first_outs.values()
        for t in ts)
    ok = (min(cand) >= 1000 and all(launches[k] > 0 for k in SERVING_KERNELS)
          and finite and min(kept) > 0 and len(out) == N_IMAGES)
    pred.images = images  # for the export and profile phases
    ips = [N_IMAGES / t for t in times]
    say(phase, config=config if isinstance(config, str)
        else config["model"]["backbone"], batch=BATCH, images=N_IMAGES,
        dtype="bfloat16", candidates_per_image=cand, dets_kept=kept,
        launches=launches, finite=finite,
        images_per_s_median=statistics.median(ips), images_per_s=ips,
        backbone_ms=backbone_ms, max_memory_allocated_bytes=peak,
        card=card, ok=ok)
    SUMMARY[phase] = dict(images_per_s_median=statistics.median(ips),
                          backbone_ms=backbone_ms)
    return ok, launches, pred, first_outs


def plain_decode():
    """Route decode_detections through the plain versions on the card."""
    from orientedreppoints_tpu_torch.models import detector
    from orientedreppoints_tpu_torch.ops import geometry

    return swapped([(detector, "min_area_rect", geometry.min_area_rect)]
                   + merge_swaps())


def phase_decode(pred, outs, phase="decode"):
    from orientedreppoints_tpu_torch.models.detector import decode_detections
    from orientedreppoints_tpu_torch.ops import nms, quad_iou

    tc = pred.test_cfg
    kw = dict(nms_pre=tc["nms_pre"], score_thr=tc["score_thr"],
              iou_thr=tc["nms"]["iou_thr"], max_per_img=tc["max_per_img"],
              pre_nms_cap=tc.get("pre_nms_cap", 4096))
    outs = {k: [t.float() for t in outs[k]]
            for k in ("cls_scores", "pts_refine")}
    overs, scans = [], []
    with torch.inference_mode():
        with recording(nms, "quad_over_mask", overs), \
                recording(nms, "greedy_scan", scans):
            dets, labels, valid = decode_detections(outs, **kw)
        with plain_decode():
            dets_p, labels_p, valid_p = decode_detections(outs, **kw)
    agree = decode_agreement((dets, labels, valid), (dets_p, labels_p,
                                                     valid_p))
    ok = agree["ok"] and len(overs) == len(scans) == 1
    # both NMS kernels on this batch's own candidates (the top 4096
    # class-offset boxes an image), bit for bit and timed
    (q, thr, nv), _, _ = overs[0]
    (words, top_valid, _), _, _ = scans[0]
    with torch.inference_mode():
        over, want = over_mask_case(
            lambda: quad_iou.quad_over_mask(q, thr, nv), q, nv, thr)
        scan = scan_case(want, top_valid, nv)
    ok = ok and over["ok"] and scan["ok"] and torch.equal(words, want)
    for name, line in (("quad_over_mask", over), ("nms_scan", scan)):
        say("kernel_shape", name=name, shape=f"{phase}_candidates",
            batch=int(q.shape[0]), n=int(q.shape[1]),
            num_valid=nv.tolist(), **line)
    agree.pop("ok")
    say(phase, dets=int(valid.sum()), **agree, ok=ok)
    return ok


def decode_agreement(got, want) -> dict:
    """Two decode_detections results det for det: the same valid slots and
    labels, reppoints and scores exactly, and a box that differs only as a
    min-area tie of its (equal) points (rect_check, as the kernel phases
    hold them)."""
    dets, labels, valid = got
    dets_p, labels_p, valid_p = want
    same_valid = bool(torch.equal(valid, valid_p))
    same_labels = same_valid and bool(torch.equal(labels[valid],
                                                  labels_p[valid]))
    err_pts = err_poly = err_score = float("inf")
    ties, ties_ok = -1, False
    if same_valid:
        d, p = dets[valid], dets_p[valid]
        err_pts = float((d[:, :18] - p[:, :18]).abs().max())
        err_poly, ties, ties_ok = rect_check(d[:, 18:26], p[:, 18:26],
                                             d[:, :18])
        err_score = float((d[:, 26] - p[:, 26]).abs().max())
    ok = (same_labels and err_pts == 0.0 and err_score == 0.0 and ties_ok
          and err_poly <= RECT_TOL)
    return dict(same_valid=same_valid, same_labels=same_labels,
                max_err_reppoints=err_pts, max_err_poly_px=err_poly,
                rect_ties=ties, max_err_score=err_score, ok=ok)


def phase_dcn(pred, rng, phase):
    """Every paired-DCN forward of one serving batch (seeded 1024^2
    images) against its plain version on the same inputs, bit for bit."""
    from orientedreppoints_tpu_torch.ops import deform_conv

    images = [(rng.random((1024, 1024, 3)) * 255).astype(np.uint8)
              for _ in range(BATCH)]
    calls = []
    with torch.inference_mode(), checking(
            deform_conv, "deform_sample_pair",
            deform_conv.deform_sample_pair_plain, dcn_compare, calls):
        pred.model(pred.prepare(images)[0])
    ok = len(calls) == 1 and all(c["ok"] for c in calls)
    say(phase, calls=calls, ok=ok)
    return ok


def resnext_config() -> dict:
    """The R-50 demo config with RESNEXT_BACKBONE as its backbone."""
    from orientedreppoints_tpu_torch.host import load_config

    cfg = load_config(CONFIG)
    cfg["model"]["backbone"] = dict(RESNEXT_BACKBONE)
    return cfg


def torchvision_resnext_sd(rng) -> dict:
    """A state dict with torchvision's names and shapes of
    resnext50_32x4d (Bottleneck, width int(planes * 4 / 64) * 32, the
    grouped conv2 of in / 32 channels, downsample.0 / .1, BN running
    statistics, fc), values from rng."""
    sd = {}

    def conv(key, cout, cin, k):
        sd[key + ".weight"] = torch.from_numpy(rng.normal(
            0, math.sqrt(2 / (cout * k * k)), (cout, cin, k, k)).astype(
                np.float32))

    def bn(key, c):
        for leaf, lo, hi in (("weight", 0.5, 1.5), ("bias", -0.2, 0.2),
                             ("running_mean", -0.2, 0.2),
                             ("running_var", 0.5, 2.0)):
            sd[f"{key}.{leaf}"] = torch.from_numpy(
                rng.uniform(lo, hi, c).astype(np.float32))
        sd[key + ".num_batches_tracked"] = torch.tensor(1)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for s, blocks in enumerate((3, 4, 6, 3)):
        planes = 64 * 2 ** s
        width = planes * 4 // 64 * 32
        for b in range(blocks):
            key = f"layer{s + 1}.{b}"
            conv(key + ".conv1", width, cin, 1)
            conv(key + ".conv2", width, width // 32, 3)
            conv(key + ".conv3", planes * 4, width, 1)
            for i, c in ((1, width), (2, width), (3, planes * 4)):
                bn(f"{key}.bn{i}", c)
            if b == 0:
                conv(key + ".downsample.0", planes * 4, cin, 1)
                bn(key + ".downsample.1", planes * 4)
            cin = planes * 4
    sd["fc.weight"] = torch.zeros(1000, cin)
    sd["fc.bias"] = torch.zeros(1000)
    return sd


def torchvision_name(key: str) -> str:
    """The torchvision name of a port backbone tensor (`backbone.` cut):
    stem.conv -> conv1, stem.bn -> bn1, layer{s}_{b}.conv{i}.conv /
    .bn -> layer{s}.{b}.conv{i} / .bn{i}, .downsample.conv / .bn ->
    .downsample.0 / .1; BN scale, bias, mean, var -> weight, bias,
    running_mean, running_var."""
    parts = key.split(".")
    leaf = {"scale": "weight", "mean": "running_mean",
            "var": "running_var"}.get(parts[-1], parts[-1])
    if parts[0] == "stem":
        return ("conv1" if parts[1] == "conv" else "bn1") + "." + leaf
    stage, block = parts[0][len("layer"):].split("_")
    if parts[1] == "downsample":
        mod = "downsample." + ("0" if parts[2] == "conv" else "1")
    else:
        mod = parts[1] if parts[2] == "conv" else "bn" + parts[1][4:]
    return f"layer{stage}.{block}.{mod}.{leaf}"


def phase_weights(dev, rng, card):
    """A torchvision resnext50_32x4d .pth through load_pretrained_backbone
    into the ResNeXt detector on the card."""
    from orientedreppoints_tpu_torch.apis import init_detector
    from orientedreppoints_tpu_torch.utils.checkpoint import \
        load_pretrained_backbone

    sd = torchvision_resnext_sd(rng)
    model, _ = init_detector(resnext_config(), device=dev, seed=SEED)
    before = {k: v.clone() for k, v in model.state_dict().items()
              if not k.startswith("backbone.")}
    with tempfile.TemporaryDirectory() as wd:
        path = os.path.join(wd, "resnext50_32x4d.pth")
        torch.save({"state_dict": sd}, path)
        load_pretrained_backbone(model, path, 50)
    after = model.backbone.state_dict()
    equal = all(torch.equal(v.cpu(), sd[torchvision_name(k)])
                for k, v in after.items())
    used = {torchvision_name(k) for k in after}
    unused = sorted(k for k in sd if k not in used
                    and not k.endswith("num_batches_tracked"))
    kept = all(torch.equal(model.state_dict()[k], v)
               for k, v in before.items())
    x = torch.from_numpy(rng.normal(size=(1, 512, 512, 3)).astype(
        np.float32)).to(dev)
    with torch.inference_mode():
        outs = model(x)
    finite = all(bool(torch.isfinite(t.float()).all())
                 for ts in outs.values() for t in ts)
    ok = (equal and kept and finite and unused == ["fc.bias", "fc.weight"]
          and next(model.parameters()).device.type == "cuda")
    say("weights", file="resnext50_32x4d (torchvision names, seeded)",
        backbone_tensors=len(after), equal_to_source=equal,
        unused_source=unused, neck_and_head_unchanged=kept, finite=finite,
        card=card, ok=ok)
    return ok


def build_trainer(sd, compute_dtype, dev, config=CONFIG):
    """The config's training setup (apis.build_trainer: frozen_stages
    frozen, SGD or AdamW with its LR schedule, the step with
    device_normalize and DropPath seeded from (SEED, step)) on a model
    with the weights sd."""
    from orientedreppoints_tpu_torch import apis

    model, cfg = apis.init_detector(config, state_dict=sd,
                                    compute_dtype=compute_dtype, device=dev)
    return model, apis.build_trainer(model, cfg, seed=SEED)[2]


def counting_drop_path(draws: list):
    """Record every DropPath mask Swin draws: which samples it drops (a
    dropped sample's branch is all zeros)."""
    from orientedreppoints_tpu_torch.models import swin

    def on_call(args, kwargs, out):
        y, rate, mask = args
        if mask is not None and rate > 0:
            draws.append((out.reshape(out.shape[0], -1) == 0).all(1))
    return wrapping(swin, "drop_path", on_call)


def drop_path_table(model) -> dict:
    """The model's DropPath masks under dropout_key(seed, step) against
    DROP_PATH_TABLE (JAX's): {"seed,step": equal}."""
    from orientedreppoints_tpu_torch.parallel.train import dropout_key

    out = {}
    for (seed, step), want in DROP_PATH_TABLE.items():
        got = model.backbone.drop_masks(dropout_key(seed, step),
                                        DROP_PATH_BATCH)
        out[f"{seed},{step}"] = " ".join(
            "".join("1" if v else "0" for v in row) for row in got) == want
    return out


def dropped_share(draws: list) -> float:
    return float(torch.cat(draws).float().mean()) if draws else 0.0


def masks_per_step(model) -> int:
    """DropPath masks a training forward draws: two a block of nonzero
    rate (22 in Swin-T: its first block's rate is 0)."""
    from orientedreppoints_tpu_torch.models.swin import SwinBlock

    return 2 * sum(m.drop_path > 0 for m in model.modules()
                   if isinstance(m, SwinBlock))


def phase_train(dev, ops_mod, card, sd, batch, config=CONFIG,
                phase="train", repeat=False):
    """The config's step: R-50 with SGD (stem and layer1 frozen), HRNet or
    SSD-VGG with SGD (nothing frozen), or Swin-T with AdamW (nothing
    frozen) and DropPath, whose draws and dropped share are counted.
    repeat: the same steps again from the same weights in a fresh model
    and optimizer must give every loss and tensor bit for bit (the step's
    deterministic settings, utils/determinism.py)."""
    model, step = build_trainer(sd, "bfloat16", dev, config)
    swin = model.backbone_type == "swin"
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    n = sum(h * w for _, h, w in TRAIN_LEVELS)
    first = [step(batch)]  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops_mod.reset_launch_counts()
    times, records, draws = [], [], []
    with counting_drop_path(draws):
        for i in range(TRAIN_STEPS):
            stats = {}
            t0 = time.perf_counter()
            losses = step(batch, stats)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            first.append(losses)
            rec = {k: float(v) for k, v in losses.items()}
            rec["refine_pos_per_image"] = (stats["gt_inds"] > 0).sum(
                1).tolist()
            rec["iou_gt_0p1_share"] = stats["iou_gt_0p1"].tolist()
            records.append(rec)
            say(f"{phase}_step", step=i, **rec)
    launches = ops_mod.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    repeat_equal = None
    if repeat:
        model_2, step_2 = build_trainer(sd, "bfloat16", dev, config)
        again = [step_2(batch) for _ in first]
        repeat_equal = (same_states(model.state_dict(), model_2.state_dict())
                        and all(same_states(a, b)
                                for a, b in zip(first, again)))
        del model_2, step_2, again
    frozen_same, unchanged, unreached, trainable = 0, [], [], 0
    for k, p in model.named_parameters():
        same = torch.equal(p.detach(), before[k])
        if p.requires_grad:
            trainable += 1
            unchanged += [k] if same else []
            # the loss does not reach it (HRNet's last stride-4 fusion: the
            # FPN starts at level 1, as in JAX): a zero grad, so only the
            # decay moves it, and a zero bias stays zero
            unreached += [k] if same and not (p.grad.any()
                                              or p.detach().any()) else []
        else:
            frozen_same += same
    n_frozen = sum(not p.requires_grad for p in model.parameters())
    finite = all(np.isfinite(v) for r in records for k, v in r.items()
                 if not isinstance(v, list))
    # Swin: DropPath fires (Swin-T drops ~10% of samples on average: the
    # mean of its rates) with JAX's masks; nothing is frozen
    table = drop_path_table(model) if swin else {}
    fired = (len(draws) == TRAIN_STEPS * masks_per_step(model) > 0
             and dropped_share(draws) > 0
             and all(table.values())) if swin else not draws
    per = masks_per_step(model)
    dropping = [sum(bool(d.any()) for d in draws[i * per:(i + 1) * per])
                for i in range(TRAIN_STEPS)] if swin else []
    ok = (finite and min(r["num_pos"] for r in records) > 0
          and max(max(r["refine_pos_per_image"]) for r in records) < n
          and min(min(r["iou_gt_0p1_share"]) for r in records) > 0
          and all(launches[k] > 0 for k in TRAIN_KERNELS)
          and (n_frozen > 0) == (model.backbone_type == "resnet")
          and frozen_same == n_frozen and unchanged == unreached and fired
          and repeat_equal is not False)
    med = statistics.median(times)
    say(phase, config=config, batch=TRAIN_BATCH, canvas=TRAIN_CANVAS,
        dtype="bfloat16", steps=TRAIN_STEPS, point_sets_per_image=n,
        step_ms=[t * 1e3 for t in times], step_ms_median=med * 1e3,
        train_images_per_s=TRAIN_BATCH / med,
        max_memory_allocated_bytes=peak, launches=launches,
        launches_per_step={k: launches[k] / TRAIN_STEPS
                           for k in TRAIN_KERNELS},
        drop_path_masks=len(draws),
        drop_path_dropped_share=dropped_share(draws),
        drop_path_masks_dropping_per_step=dropping,
        drop_path_table_equal_jax=table,
        frozen_tensors=n_frozen, frozen_unchanged=frozen_same,
        trainable_tensors=trainable, trainable_unchanged=unchanged,
        unchanged_zero_without_grad=unreached,
        repeat_bitwise=repeat_equal, finite=finite, card=card, ok=ok)
    SUMMARY[phase] = dict(step_ms_median=med * 1e3)
    return ok, launches


def plain_train():
    """Route the training step through the plain versions on the card."""
    from orientedreppoints_tpu_torch.core import apaa
    from orientedreppoints_tpu_torch.ops import (deform_conv, geometry,
                                                 hull_iou, minarearect)

    swaps = [(deform_conv, "deform_sample_pair",
              deform_conv.deform_sample_pair_plain),
             (deform_conv, "deform_sample_pair_backward",
              deform_conv.deform_sample_pair_backward_plain),
             (hull_iou, "hull_quad_iou_matrix",
              hull_iou.hull_quad_iou_matrix_plain),
             (minarearect, "convex_hull_entry", minarearect.convex_hull_plain),
             (apaa, "min_area_rect", geometry.min_area_rect)]
    return swapped(swaps)


def phase_train_check(dev, ops_mod, sd, batch, config=CONFIG,
                      phase="train_check"):
    runs = {}
    for route in ("kernels", "plain"):
        model, step = build_trainer(sd, "float32", dev, config)
        ops_mod.reset_launch_counts()
        stats, draws = {}, []
        route_ctx = (plain_train() if route == "plain"
                     else contextlib.nullcontext())
        with route_ctx, counting_drop_path(draws):
            losses = step(batch, stats)
        torch.cuda.synchronize()
        grads = {k: p.grad.detach().clone()
                 for k, p in model.named_parameters() if p.requires_grad}
        runs[route] = (losses, stats["gt_inds"], grads,
                       ops_mod.launch_counts(), draws)
        n_masks = masks_per_step(model)
        del model, step
        torch.cuda.empty_cache()
    (lk, gk, grk, nk, dk), (lp, gp, grp, np_, dp) = (runs["kernels"],
                                                     runs["plain"])
    # the same DropPath masks in both runs (none without Swin)
    same_masks = len(dk) == len(dp) == n_masks and all(
        torch.equal(a, b) for a, b in zip(dk, dp))
    same_assign = torch.equal(gk, gp)
    loss_rel = max(abs(float(lk[k]) - float(lp[k]))
                   / max(abs(float(lp[k])), 1e-6) for k in lp)
    grad_rel = max(float((grk[k] - grp[k]).abs().max())
                   / max(float(grp[k].abs().max()), 1e-30) for k in grp)
    # a non-finite value compares false and Python's max may skip it
    finite = all(bool(torch.isfinite(g).all()) for run in (grk, grp)
                 for g in run.values()) and all(
        np.isfinite(float(v)) for run in (lk, lp) for v in run.values())
    ok = (finite and same_assign and loss_rel <= 1e-5
          and grad_rel <= GRAD_RTOL
          and all(nk[k] > 0 for k in TRAIN_KERNELS)
          and not any(np_.values()) and same_masks)
    say(phase, config=config, dtype="float32", tf32=False,
        drop_path_masks=len(dk), same_drop_path_masks=same_masks,
        drop_path_dropped_share=dropped_share(dk),
        refine_assignment_identical=same_assign, finite=finite,
        refine_pos=int((gk > 0).sum()), max_loss_rel_err=loss_rel,
        max_grad_rel_err=grad_rel, grad_rtol=GRAD_RTOL,
        losses={k: float(v) for k, v in lk.items()},
        launches_kernels=nk, launches_plain=np_, ok=ok)
    return ok


def count_calls(module, name, counter: list):
    """Append 1 to counter at every call of module.name."""
    return wrapping(module, name, lambda *call: counter.append(1))


def train_state(model, optimizer, scheduler):
    """Copies of what a checkpoint restores: the model's tensors, the SGD
    momentum buffers, the LR and the scheduler's step."""
    momentum = [optimizer.state[p]["momentum_buffer"].detach().clone()
                for g in optimizer.param_groups for p in g["params"]]
    return ({k: v.detach().clone() for k, v in model.state_dict().items()},
            momentum, scheduler.get_last_lr(), scheduler.last_epoch)


def same_train_state(a, b) -> bool:
    return (a[0].keys() == b[0].keys()
            and all(torch.equal(a[0][k], b[0][k]) for k in a[0])
            and len(a[1]) == len(b[1]) > 0
            and all(torch.equal(x, y) for x, y in zip(a[1], b[1]))
            and a[2:] == b[2:])


def param_diffs(a: dict, b: dict, start: dict) -> dict:
    """Two runs' states after one epoch that began at `start`, in f32 over
    the tensors that the epoch moved: the norm of a - b over all of them
    relative to the norm of b's update (b - start); the median over
    tensors of that ratio per tensor; and the largest |a - b| of any
    tensor relative to that tensor's largest element, with its name."""
    moved = [k for k in b if b[k].is_floating_point()
             and not torch.equal(b[k], start[k])]
    diff = {k: float((a[k].float() - b[k].float()).norm()) for k in moved}
    upd = {k: float((b[k].float() - start[k].float()).norm()) for k in moved}
    worst, name = max((float((a[k].float() - b[k].float()).abs().max())
                       / max(float(b[k].float().abs().max()), 1e-30), k)
                      for k in moved)
    return dict(update_rel=(sum(d * d for d in diff.values())
                            / sum(u * u for u in upd.values())) ** 0.5,
                median_tensor_update_rel=statistics.median(
                    diff[k] / upd[k] for k in moved),
                max_element_rel=worst, max_element_tensor=name,
                tensors=len(moved))


def loss_diff(a: list, b: list) -> tuple[float, float]:
    """The largest absolute and relative difference of any loss of any
    step between two runs' per-step loss dicts."""
    pairs = [(ra[k], rb[k]) for ra, rb in zip(a, b) for k in rb]
    return (max(abs(x - y) for x, y in pairs),
            max(abs(x - y) / max(abs(y), 1e-12) for x, y in pairs))


def dcn_bwd_compare(args, got, want):
    """One DCN backward call against its plain version (run inside the
    step, under its deterministic settings): the table grads bit for bit,
    the offset grads' largest error relative to their largest grad within
    DCN_BWD_RTOL of their dtype."""
    bits = [differing_bits(x, y) for x, y in zip(got[:-1], want[:-1])]
    err = float((got[-1].float() - want[-1].float()).abs().max())
    scale = float(want[-1].float().abs().max())
    rel = err / max(scale, 1e-30)
    dtype = str(got[-1].dtype).split(".")[-1]
    return dict(rows=int(args[0].shape[0]), dtype=dtype,
                table_grad_differing_bits=bits, offset_grad_max_abs_err=err,
                offset_grad_scale=scale, offset_grad_max_rel_err=rel,
                ok=not any(bits) and rel <= DCN_BWD_RTOL[dtype])


def hull_compare(args, got, want):
    same = all(torch.equal(x, y) for x, y in zip(got, want))
    return dict(sets=int(args[0].shape[0]), ok=same)


def hull_iou_compare(args, got, want):
    bits = differing_bits(got.contiguous(), want.contiguous())
    return dict(shape=list(got.shape), differing_bits=bits, ok=bits == 0)


def synth_kernel_routes():
    """(entry module, entry name, plain version, compare) of the four
    training kernels' entries on the synthetic step's path."""
    from orientedreppoints_tpu_torch.core import apaa
    from orientedreppoints_tpu_torch.ops import (deform_conv, geometry,
                                                 hull_iou, minarearect)
    return {
        "min_area_rect_hull": (minarearect, "convex_hull_entry",
                               minarearect.convex_hull_plain, hull_compare),
        "min_area_rect_rect": (apaa, "min_area_rect", geometry.min_area_rect,
                               rect_compare),
        "hull_quad_iou": (hull_iou, "hull_quad_iou_matrix",
                          hull_iou.hull_quad_iou_matrix_plain,
                          hull_iou_compare),
        "deform_sample_pair": (deform_conv, "deform_sample_pair",
                               deform_conv.deform_sample_pair_plain,
                               dcn_compare),
        "deform_sample_pair_backward": (
            deform_conv, "deform_sample_pair_backward",
            deform_conv.deform_sample_pair_backward_plain, dcn_bwd_compare),
    }


def synth_train_data(wd, scenes, config=None, hard=False):
    """Render `scenes` train scenes (768^2, seed 0, prefix T; hard: the
    15-class benchmark) in wd, cut them into tiles with train.json, and
    build the train dataset of `config` (EVAL_CONFIG when None) -> (cfg,
    dataset)."""
    from orientedreppoints_tpu_torch.data.synth import generate_synth_dota
    from orientedreppoints_tpu_torch.devkit.dota2coco import dota2coco_train
    from orientedreppoints_tpu_torch.devkit.img_split import ImgSplit
    from orientedreppoints_tpu_torch.host import load_config

    raw, split = os.path.join(wd, "train_raw"), os.path.join(wd,
                                                             "train_split")
    generate_synth_dota(raw, scenes, size=EVAL_SCENE_SIZE,
                        n_objects=EVAL_OBJECTS, seed=SEED, prefix="T",
                        hard=hard)
    ImgSplit(raw, split, gap=EVAL_GAP, subsize=EVAL_SUBSIZE, ext=".npy",
             num_process=1).splitdata()
    cfg = load_config(config or EVAL_CONFIG)
    cfg["data"]["train"].update(
        ann_file=dota2coco_train(split, os.path.join(wd, "train.json"),
                                 ext=".npy"),
        img_prefix=os.path.join(split, "images"))
    return cfg, train_dataset(cfg)


def train_dataset(cfg):
    """The config's train dataset, normalized on the card when it says so."""
    from orientedreppoints_tpu_torch import apis

    return apis.build_dataset(
        cfg["data"]["train"],
        device_normalize=apis.build_img_norm(cfg) is not None)


def synth_trainer(cfg, ds, dev):
    """The config's model from its seeded initial weights, the loader and
    the SGD recipe -> (model, loader, optimizer, scheduler, step)."""
    from orientedreppoints_tpu_torch import apis

    model, _ = apis.init_detector(cfg, compute_dtype=cfg["tpu"]["compute_dtype"],
                                  device=dev, seed=SEED)
    loader = apis.build_dataloader(ds, cfg, seed=SEED)
    return (model, loader) + apis.build_trainer(model, cfg, len(loader))


def model_state(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def resumed_epoch(cfg, ds, dev, ckpt, ckpt_dir, on_step=None,
                  after_load=None):
    """Epoch 2 from the epoch-1 checkpoint in a fresh model, optimizer and
    scheduler through apis.train_epochs (after_load(model, loader,
    optimizer, scheduler) may change them first) -> (objects, step count
    and restored state as loaded, the state after the epoch)."""
    from orientedreppoints_tpu_torch import apis
    from orientedreppoints_tpu_torch.utils import checkpoint

    model, loader, opt, sched, step = synth_trainer(cfg, ds, dev)
    it, meta = checkpoint.load_checkpoint(ckpt, model, opt, sched)
    loaded = it, train_state(model, opt, sched)
    if after_load:
        after_load(model, loader, opt, sched)
    apis.train_epochs(model, loader, step, opt, sched, ckpt_dir, 2,
                      start_epoch=meta["epoch"], it=it, on_step=on_step)
    return (model, opt, sched, step), loaded, model_state(model)


def checked_step(routes, loader, step, phase: str, timed=True) -> dict:
    """One step on the loader's next batch with every training kernel's
    entry checked against its plain version on the same inputs, then
    (timed) each kernel and its plain version timed at the inputs of its
    first call -> {name: dict(calls, ok, checks, ms, plain_ms)}, each
    printed under `phase`."""
    checks = {name: [] for name in routes}
    calls = {}

    def keep(name):
        return lambda args, kwargs, out: calls.setdefault(name,
                                                          (args, kwargs))

    with contextlib.ExitStack() as stack:
        for name, (module, fn, plain, compare) in routes.items():
            stack.enter_context(checking(module, fn, plain, compare,
                                         checks[name]))
            stack.enter_context(wrapping(module, fn, keep(name)))
        step(next(iter(loader)))
        torch.cuda.synchronize()
    shapes = {}
    for name, (module, fn, plain, _) in routes.items():
        args, kwargs = calls[name]
        entry = getattr(module, fn)
        shapes[name] = dict(
            calls=len(checks[name]),
            ok=bool(checks[name]) and all(c["ok"] for c in checks[name]),
            checks=checks[name][:2],
            ms=cuda_ms(lambda: entry(*args, **kwargs), 10) if timed else None,
            plain_ms=(cuda_ms(lambda: plain(*args, **kwargs), 1) if timed
                      else None))
        say(phase, name=name, **shapes[name])
    return shapes


def same_states(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def phase_synth_train(dev, ops_mod, card):
    """tools/synth_benchmark_torch.py --train's path at the full width of
    configs/dota/synth_r18_512.py: 8 train scenes rendered and tiled, the
    config's train pipeline and loader, R-18 (bf16, batch 8, canvas 512^2)
    from its seeded initial weights, through apis.train_epochs.  Epoch 1
    (its first step a warm-up) and epoch 2 are counted and timed (A), with
    a checkpoint after epoch 1; epoch 2 again from that checkpoint in a
    fresh model, optimizer and scheduler (B).  The step repeats bit for
    bit (utils/determinism.py), so B must equal A bit for bit: every
    step's losses, the parameters, the momentum buffers, the LR and the
    step count.  Then one step with each training kernel's entry checked
    against its plain version on the same inputs, and the kernels timed at
    those inputs."""
    from orientedreppoints_tpu_torch import apis

    routes = synth_kernel_routes()
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as wd:
        def path(*p):
            return os.path.join(wd, *p)

        t0 = time.perf_counter()
        cfg, ds = synth_train_data(wd, SYNTH_TRAIN_SCENES)
        data_s = time.perf_counter() - t0
        hull_calls, rect_calls = [], []

        def recorder(run, records, warmup=0):
            """on_step: per step the losses, num_pos and refine positives,
            printed and kept.  The first `warmup` steps are not kept, and
            the launch and call counts restart after them."""
            left = [warmup]

            def on_step(epoch, losses, stats, batch):
                if left[0]:
                    left[0] -= 1
                    ops_mod.reset_launch_counts()
                    hull_calls.clear()
                    rect_calls.clear()
                    return
                records.append({k: float(v) for k, v in losses.items()})
                say("synth_train_step", run=run, step=len(records),
                    **records[-1],
                    refine_pos_per_image=(stats["gt_inds"] > 0).sum(
                        1).tolist(),
                    gts=int(batch["gt_valid"].sum()))
            return on_step

        def uninterrupted(run, records, ckpt_dir, warmup=0):
            """Epochs 1 and 2 from the seeded weights, a checkpoint after
            each -> (train_epochs' result, the kept steps, step count and
            state after epoch 1, the state after epoch 2)."""
            model, loader, opt, sched, step = synth_trainer(cfg, ds, dev)
            at_1 = {}

            def epoch_done(reached, it):
                if reached == 1:
                    at_1.update(steps=len(records), it=it,
                                state=train_state(model, opt, sched))
            res = apis.train_epochs(
                model, loader, step, opt, sched, ckpt_dir, 2,
                meta=dict(classes=list(ds.CLASSES)),
                on_step=recorder(run, records, warmup), on_epoch=epoch_done)
            return res, at_1, train_state(model, opt, sched)

        def resumed(run, ckpt_dir, at_1):
            """resumed_epoch from ckpt_dir's epoch-1 checkpoint -> (its
            steps, its state after the epoch, whether the restored state
            equals the saved one bit for bit, the objects)."""
            records = []
            objs, (it, loaded), _ = resumed_epoch(
                cfg, ds, dev, os.path.join(ckpt_dir, "epoch_1.pt"),
                ckpt_dir + "_" + run, on_step=recorder(run, records))
            return (records, train_state(*objs[:3]),
                    it == at_1["it"] and same_train_state(loaded,
                                                          at_1["state"]),
                    objs)

        # A: epochs 1 and 2, counted and timed after the warm-up step
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rec_a = []
        with count_calls(*routes["min_area_rect_hull"][:2], hull_calls), \
                count_calls(*routes["min_area_rect_rect"][:2], rect_calls):
            run_a, at_a, state_a = uninterrupted("A", rec_a, path("ckpts"),
                                                 warmup=1)
        launches = ops_mod.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        n_steps, steps_1 = len(rec_a), at_a["steps"]
        waits, times = run_a["wait_s"][1:], run_a["step_s"][1:]
        # B: epoch 2 resumed
        rec_b, state_b, exact_b, objs = resumed("B", path("ckpts"), at_a)
        diffs = param_diffs(state_a[0], state_b[0], at_a["state"][0])
        ab_loss = loss_diff(rec_a[steps_1:], rec_b)
        model, opt, sched, step = objs

        loader = apis.build_dataloader(ds, cfg, seed=SEED)
        loader.epoch = 2
        shapes = checked_step(routes, loader, step, "synth_train_kernel")

    finite = all(np.isfinite(v) for r in rec_a + rec_b for v in r.values())
    per_step = {k: launches[k] / n_steps for k in TRAIN_KERNELS}
    # the restored state exact, then the resumed epoch the uninterrupted
    # one bit for bit: every step's losses, the parameters, the momentum
    # buffers, the LR and the step count
    losses_equal = rec_a[steps_1:] == rec_b
    state_equal = same_train_state(state_a, state_b)
    ok_resume = (exact_b and len(rec_b) == n_steps - steps_1 and losses_equal
                 and state_equal)
    ok = (finite and ok_resume and all(launches[k] > 0 for k in TRAIN_KERNELS)
          and all(v["ok"] for v in shapes.values()))
    batch_size = cfg["tpu"]["global_batch_size"]
    med = statistics.median(times)
    say("synth_train", config=EVAL_CONFIG, scenes=SYNTH_TRAIN_SCENES,
        tiles=len(ds), batch=batch_size, dtype=cfg["tpu"]["compute_dtype"],
        canvas=cfg["tpu"]["canvas_buckets"][-1],
        max_gt=cfg["tpu"]["max_gt"], max_pos=cfg["tpu"]["max_pos"],
        steps_per_epoch=len(loader), counted_steps=n_steps, data_s=data_s,
        checkpoint_save_s=run_a["save_s"],
        step_ms=[t * 1e3 for t in times],
        step_ms_median=med * 1e3, train_images_per_s=batch_size / med,
        loader_wait_ms=[w * 1e3 for w in waits],
        loader_wait_ms_median=statistics.median(waits) * 1e3,
        loader_wait_share=sum(waits) / (sum(waits) + sum(times)),
        max_memory_allocated_bytes=peak, launches=launches,
        launches_per_step=per_step,
        min_area_rect_entry_calls_per_step=dict(
            hull=len(hull_calls) / n_steps, rect=len(rect_calls) / n_steps),
        restored_state_exact=exact_b, a_vs_b_losses_bitwise=losses_equal,
        a_vs_b_state_bitwise=state_equal, param_diffs=diffs,
        a_vs_b_max_loss_abs=ab_loss[0], a_vs_b_max_loss_rel=ab_loss[1],
        finite=finite, phase_s=time.perf_counter() - t_phase, card=card,
        ok=ok)
    return ok, launches


class TimedStep:
    """A pipeline step that adds the seconds of each call to
    clock[its class name]; it draws and fuses as the step does."""

    def __init__(self, step, clock: dict):
        self.step, self.clock = step, clock
        self.name = type(step).__name__
        self.draws = getattr(step, "draws", False)
        self.NUM_SAMPLES = getattr(step, "NUM_SAMPLES", 1)

    def __call__(self, results, rng=None):
        t0 = time.perf_counter()
        out = self.step(results, rng) if self.draws else self.step(results)
        self.clock[self.name] = (self.clock.get(self.name, 0.0)
                                 + time.perf_counter() - t0)
        return out


def time_transforms(pipeline, clock: dict):
    """Wrap every step of a MultiSamplePipeline in a TimedStep."""
    pipeline.pre.steps = [TimedStep(s, clock) for s in pipeline.pre.steps]
    pipeline.fusions = [TimedStep(s, clock) for s in pipeline.fusions]
    pipeline.post.steps = [TimedStep(s, clock) for s in pipeline.post.steps]


def same_batches(a: list, b: list) -> bool:
    return len(a) == len(b) and all(
        x.keys() == y.keys() and all(
            x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k])
            for k in x) for x, y in zip(a, b))


def phase_hard_aug_train(dev, ops_mod, card):
    """tools/synth_benchmark_torch.py --hard --train's path with
    configs/dota/synth_r50_512_hard_aug.py at its own widths and sizes
    (R-50, bf16, canvas 512^2, batch 8, max_gt 128, max_pos 512, the image
    normalized on the card): 8 hard train scenes rendered and cut into 32
    tiles; the config's train pipeline (mosaic x mixup, HSV, rotation,
    resize, flip) run over the tiles twice on the host alone, each
    transform timed (the second pass, the image cache filled, is the one
    reported); two loaders from one seed bitwise equal over the first
    epoch; then 1 warm-up step and HARD_AUG_STEPS counted steps from the
    seeded initial weights through the loader and apis.train_epochs; one
    more step with each training kernel's entry checked against its plain
    version, and each kernel timed at those inputs."""
    from orientedreppoints_tpu_torch import apis

    routes = synth_kernel_routes()
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as wd:
        t0 = time.perf_counter()
        cfg, ds = synth_train_data(wd, HARD_AUG_SCENES, HARD_AUG_CONFIG,
                                   hard=True)
        data_s = time.perf_counter() - t0

        # the pipeline on the host alone, transform by transform
        timed, clock = train_dataset(cfg), {}
        time_transforms(timed.pipeline, clock)
        rng = np.random.RandomState(SEED)
        passes = []
        for _ in range(2):
            clock.clear()
            t0 = time.perf_counter()
            kept = sum(timed.prepare(i, rng) is not None
                       for i in range(len(timed)))
            passes.append(dict(
                seconds=time.perf_counter() - t0, samples=kept,
                ms_per_sample={k: v * 1e3 / len(timed)
                               for k, v in clock.items()}))
        host_rate = len(timed) / passes[1]["seconds"]
        del timed

        # two loaders from one seed: the same bytes over the first epoch
        t0 = time.perf_counter()
        first = list(apis.build_dataloader(ds, cfg, seed=SEED))
        second = list(apis.build_dataloader(train_dataset(cfg), cfg,
                                            seed=SEED))
        loaders_equal = same_batches(first, second)
        loaders_s = time.perf_counter() - t0
        gts_per_image = [int(b["gt_valid"].sum(1).max()) for b in first]
        del first, second

        records, warmed = [], []

        def on_step(epoch, losses, stats, batch):
            if not warmed:  # the warm-up step: count from the next one
                warmed.append(True)
                ops_mod.reset_launch_counts()
                return
            records.append({k: float(v) for k, v in losses.items()})
            say("hard_aug_train_step", step=len(records), **records[-1],
                refine_pos_per_image=(stats["gt_inds"] > 0).sum(1).tolist(),
                gts=int(batch["gt_valid"].sum()))

        model, loader, opt, sched, step = synth_trainer(cfg, ds, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        run = apis.train_epochs(model, loader, step, opt, sched,
                                os.path.join(wd, "ckpts"), 2,
                                max_iters=1 + HARD_AUG_STEPS,
                                ckpt_interval=10,
                                meta=dict(classes=list(ds.CLASSES)),
                                on_step=on_step)
        launches = ops_mod.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        waits, times = run["wait_s"][1:], run["step_s"][1:]

        loader.epoch = 2
        shapes = checked_step(routes, loader, step, "hard_aug_train_kernel")
        del model, opt, sched, step

    n_steps = len(records)
    finite = all(np.isfinite(v) for r in records for v in r.values())
    ok = (finite and loaders_equal and n_steps == HARD_AUG_STEPS
          and passes[1]["samples"] > 0
          and all(launches[k] > 0 for k in TRAIN_KERNELS)
          and all(v["ok"] for v in shapes.values()))
    batch_size = cfg["tpu"]["global_batch_size"]
    med = statistics.median(times)
    say("hard_aug_train", config=HARD_AUG_CONFIG, scenes=HARD_AUG_SCENES,
        tiles=len(ds), batch=batch_size, dtype=cfg["tpu"]["compute_dtype"],
        canvas=cfg["tpu"]["canvas_buckets"][-1],
        max_gt=cfg["tpu"]["max_gt"], max_pos=cfg["tpu"]["max_pos"],
        data_s=data_s, host_passes=passes,
        host_samples_per_s=host_rate, loaders_bitwise_equal=loaders_equal,
        loaders_s=loaders_s, max_gts_per_image_by_batch=gts_per_image,
        counted_steps=n_steps, step_ms=[t * 1e3 for t in times],
        step_ms_median=med * 1e3, train_images_per_s=batch_size / med,
        loader_wait_ms=[w * 1e3 for w in waits],
        loader_wait_ms_median=statistics.median(waits) * 1e3,
        loader_wait_share=sum(waits) / (sum(waits) + sum(times)),
        max_memory_allocated_bytes=peak, launches=launches,
        launches_per_step={k: launches[k] / n_steps for k in TRAIN_KERNELS},
        finite=finite, phase_s=time.perf_counter() - t_phase, card=card,
        ok=ok)
    return ok, launches


# phase configs: the configs that had never run on the card, each at its
# own widths, batch, canvas, max_gt / max_pos, optimizer, schedule and
# pipelines, on one shared set of hard tiles (ship-only for the HRSC one)
CONFIGS_PHASE = ("synth_r18_512_hard_aug", "synth_swin_512_hard_aug",
                 "synth_r101_512_hard_aug", "synth_r50_1024_hard_aug",
                 "synth_r18_512_hard_aug_mp1024", "synth_r18_512_hrsc_aug",
                 "orientedreppoints_r50_mosaic")
CONFIGS_SCENES = 4  # hard train scenes of EVAL_SCENE_SIZE^2: 16 tiles
CONFIGS_SHIP_SCENES = 2  # ship-only train scenes: 8 tiles
CONFIGS_VAL_SCENES = 1  # val scenes a kind: 4 tiles, all scored


def render_tiles(wd, split, scenes, seed, prefix, specs=None):
    """scenes hard (or specs') scenes of EVAL_SCENE_SIZE^2 rendered under
    wd/split_raw and cut into EVAL_SUBSIZE^2 tiles with their json ->
    (scene names, json path, tile image folder)."""
    from orientedreppoints_tpu_torch.data.synth import generate_synth_dota
    from orientedreppoints_tpu_torch.devkit.dota2coco import dota2coco_train
    from orientedreppoints_tpu_torch.devkit.img_split import ImgSplit

    raw = os.path.join(wd, f"{split}_raw")
    tiles = os.path.join(wd, f"{split}_split")
    names = generate_synth_dota(raw, scenes, size=EVAL_SCENE_SIZE,
                                n_objects=EVAL_OBJECTS, seed=seed,
                                prefix=prefix, hard=specs is None,
                                specs=specs)
    ImgSplit(raw, tiles, gap=EVAL_GAP, subsize=EVAL_SUBSIZE, ext=".npy",
             num_process=1).splitdata()
    ann = dota2coco_train(tiles, os.path.join(wd, f"{split}.json"),
                          ext=".npy")
    return names, ann, os.path.join(tiles, "images")


def config_run(name, data, dev, ops_mod, card, wd):
    """One config of CONFIGS_PHASE through the port's entry points: its
    seeded initial weights (a Swin's biases drawn as perturbed_weights
    draws them), its train dataset and loader on the shared tiles, its
    recipe; a warm-up step and a counted one through apis.train_epochs,
    one step with each training kernel's entry held against its plain
    version, then run_inference over the val tiles with its test pipeline
    and canvas (counted), Task1 files, merge and Task1 mAP / mAOE, and
    apis.evaluate_results -> (ok, launches of the step, of the eval)."""
    from orientedreppoints_tpu_torch import apis
    from orientedreppoints_tpu_torch.data.synth import SYNTH_HARD_CLASS_SPECS
    from orientedreppoints_tpu_torch.devkit import evaluation, result_merge
    from orientedreppoints_tpu_torch.devkit.dota_utils import DOTA10_CLASSES
    from orientedreppoints_tpu_torch.host import load_config

    t_run = time.perf_counter()
    config = f"configs/dota/{name}.py"
    cfg = load_config(config)
    kind = "ship" if "hrsc" in name else "hard"
    train_ann, train_imgs, val_names, val_ann, val_imgs = data[kind]
    cfg["data"]["train"].update(ann_file=train_ann, img_prefix=train_imgs)
    cfg["data"]["test"].update(ann_file=val_ann, img_prefix=val_imgs,
                               test_mode=True)
    tpu = cfg["tpu"]
    model, _ = apis.init_detector(cfg, compute_dtype=tpu["compute_dtype"],
                                  device=dev, seed=SEED)
    if model.backbone_type == "swin":
        rng = np.random.default_rng(SEED + 11)
        with torch.no_grad():
            for k, v in model.backbone.named_parameters():
                if v.dim() == 1:
                    v += torch.from_numpy(rng.normal(
                        0.0, SWIN_NORM_STD, v.shape).astype(np.float32)).to(
                            dev, v.dtype)
    ds = train_dataset(cfg)
    loader = apis.build_dataloader(ds, cfg, seed=SEED)
    opt, sched, step = apis.build_trainer(model, cfg, len(loader), seed=SEED)
    records, warmed = [], []

    def on_step(epoch, losses, stats, batch):
        if not warmed:  # the warm-up step: count from the next one
            warmed.append(True)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops_mod.reset_launch_counts()
            return
        records.append(dict(
            {k: float(v) for k, v in losses.items()},
            refine_pos=int((stats["gt_inds"] > 0).sum()),
            gts=int(batch["gt_valid"].sum())))

    run = apis.train_epochs(model, loader, step, opt, sched,
                            os.path.join(wd, "ckpts", name), 10, max_iters=2,
                            ckpt_interval=100, on_step=on_step)
    launches = ops_mod.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    step_s, wait_s = run["step_s"][-1], run["wait_s"][-1]
    grads_finite = all(bool(torch.isfinite(p.grad).all())
                       for p in model.parameters() if p.grad is not None)
    loader.epoch = run["epoch"] + 1
    # the kernels' times at these shapes are the kernel phases' business;
    # timing the plain versions here (the mosaic config's batch 8 at 1344^2)
    # would cost ~20 s and tens of GB
    shapes = checked_step(synth_kernel_routes(), loader, step,
                          "configs_kernel", timed=False)

    # the test pipeline and canvas over the val tiles, counted
    val_ds = apis.build_dataset(cfg["data"]["test"])
    canvas = tuple(tpu["canvas_buckets"][-1])
    model.eval()
    ops_mod.reset_launch_counts()
    t0 = time.perf_counter()
    results = apis.run_inference(model, val_ds, cfg["test_cfg"],
                                 canvas=canvas, num_fg=len(val_ds.CLASSES))
    torch.cuda.synchronize()
    infer_s = time.perf_counter() - t0
    launches_eval = ops_mod.launch_counts()
    raw, merged = (os.path.join(wd, name, d) for d in ("raw", "merged"))
    result_merge.write_task1_results(results, DOTA10_CLASSES, raw)
    result_merge.merge_by_poly(raw, merged, num_process=1)
    task1_files = sorted(os.listdir(merged))
    detpath = os.path.join(merged, "Task1_{:s}.txt")
    annopath = os.path.join(wd, f"{kind}_val_raw", "labelTxt", "{:s}.txt")
    classnames = list(SYNTH_HARD_CLASS_SPECS) if kind == "hard" else ["ship"]
    mAP, _ = evaluation.eval_dota_task1(detpath, annopath, val_names,
                                        classnames=classnames,
                                        use_07_metric=False)
    mAOE, _ = evaluation.eval_maoe(detpath, annopath, val_names,
                                   classnames=classnames, ovthresh=0.7)
    tile_map, _ = apis.evaluate_results(results, val_ds)

    finite = grads_finite and all(np.isfinite(v) for r in records
                                  for v in r.values())
    ok = (finite and len(records) == 1
          and all(launches[k] > 0 for k in TRAIN_KERNELS)
          and all(v["ok"] for v in shapes.values())
          and all(launches_eval[k] > 0 for k in SERVING_KERNELS)
          and len(results) == len(val_ds) and bool(task1_files)
          and task1_files == sorted(os.listdir(raw)))
    say("configs", config=name, backbone=cfg["model"]["backbone"]["type"],
        optimizer=cfg["optimizer"]["type"], canvas=canvas,
        batch=tpu["global_batch_size"], max_gt=tpu["max_gt"],
        max_pos=tpu["max_pos"], tiles=len(ds), losses=records,
        step_ms=step_s * 1e3, loader_wait_share=wait_s / (wait_s + step_s),
        peak_gb=peak / 1e9, launches=launches, grads_finite=grads_finite,
        kernels_ok={k: v["ok"] for k, v in shapes.items()},
        val_tiles=len(val_ds), infer_s=infer_s,
        launches_eval=launches_eval, task1_files=len(task1_files),
        mAP=mAP, mAOE_deg=mAOE, tile_mAP=tile_map,
        seconds=time.perf_counter() - t_run, card=card, ok=ok)
    return ok, launches, launches_eval


def phase_configs(dev, ops_mod, card):
    """Every config of CONFIGS_PHASE (config_run) on one set of hard tiles
    (CONFIGS_SCENES scenes, 768^2, cut into 512^2 tiles; each config's
    pipeline resizes them) and ship-only ones for the HRSC config, and a
    val scene of each kind.  Random weights: mAP and mAOE are read, not
    gated -> (ok, [launches of each counted run])."""
    from orientedreppoints_tpu_torch.data.synth import SYNTH_CLASS_SPECS

    t_phase = time.perf_counter()
    ships = {"ship": SYNTH_CLASS_SPECS["ship"]}
    oks, runs = [], []
    with tempfile.TemporaryDirectory() as wd:
        data = {}
        for kind, scenes, specs in (("hard", CONFIGS_SCENES, None),
                                    ("ship", CONFIGS_SHIP_SCENES, ships)):
            _, train_ann, train_imgs = render_tiles(
                wd, f"{kind}_train", scenes, SEED, "T", specs)
            val_names, val_ann, val_imgs = render_tiles(
                wd, f"{kind}_val", CONFIGS_VAL_SCENES, EVAL_SEED, "V", specs)
            data[kind] = (train_ann, train_imgs, val_names, val_ann,
                          val_imgs)
        data_s = time.perf_counter() - t_phase
        for name in CONFIGS_PHASE:
            ok, launches, launches_eval = config_run(name, data, dev, ops_mod,
                                                     card, wd)
            oks.append(ok)
            runs += [launches, launches_eval]
            torch.cuda.empty_cache()
    say("configs_phase", configs=len(CONFIGS_PHASE), data_s=data_s,
        phase_s=time.perf_counter() - t_phase, ok=all(oks))
    return all(oks), runs


def cpu_quota() -> str | None:
    """The cgroup's CPU limit ("quota period", or "max"), if it has one."""
    with contextlib.suppress(OSError):
        with open("/sys/fs/cgroup/cpu.max") as f:
            return f.read().strip()
    return None


def render_dota_scene(rng, h: int, w: int, n_objects: int, specs=None):
    """A scene of h x w: render_scene at the longer side, cropped, with
    the objects that lie wholly inside the crop."""
    from orientedreppoints_tpu_torch.data.synth import render_scene

    img, objs = render_scene(rng, size=max(h, w), n_objects=n_objects,
                             specs=specs)
    keep = [o for o in objs if o["poly"][0::2].max() < w
            and o["poly"][1::2].max() < h]
    return np.ascontiguousarray(img[:h, :w]), keep


def paeth_png(path: str, img: np.ndarray) -> None:
    """img (H, W, 3) BGR as an RGB PNG whose every row is Paeth-filtered
    (libpng's adaptive encoder picks Paeth and Average, which the decoder
    rebuilds as a wavefront; the port's writer filters Up)."""
    import struct
    import zlib

    from orientedreppoints_tpu_torch.data import image_io

    h, w, _ = img.shape
    x = img[..., ::-1].reshape(h, w * 3).astype(np.int16)
    up = np.vstack([np.zeros((1, w * 3), np.int16), x[:-1]])
    left = np.hstack([np.zeros((h, 3), np.int16), x[:, :-3]])
    upleft = np.hstack([np.zeros((h, 3), np.int16), up[:, :-3]])
    pa, pb = np.abs(up - upleft), np.abs(left - upleft)
    pc = np.abs(left + up - 2 * upleft)
    pred = np.where((pa <= pb) & (pa <= pc), left,
                    np.where(pb <= pc, up, upleft))
    rows = np.hstack([np.full((h, 1), 4, np.uint8),
                      ((x - pred) & 255).astype(np.uint8)])
    with open(path, "wb") as f:
        f.write(image_io.PNG_SIGNATURE
                + image_io._chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                                       2, 0, 0, 0))
                + image_io._chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
                + image_io._chunk(b"IEND", b""))


def decode_ms_per_mpx(path: str, reps: int = 3) -> tuple[float, np.ndarray]:
    """image_io.imread of path: the best of reps in ms a megapixel, and
    the image."""
    from orientedreppoints_tpu_torch.data import image_io

    best = math.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        img = image_io.imread(path)
        best = min(best, time.perf_counter() - t0)
    return best * 1e3 / (img.shape[0] * img.shape[1] / 1e6), img


@contextlib.contextmanager
def timed_by_rate(cls, clock: dict):
    """cls.splitdata's seconds added up by rate into clock."""
    fn = cls.splitdata

    def timed(self, rate=1.0):
        t0 = time.perf_counter()
        fn(self, rate)
        clock[rate] = clock.get(rate, 0.0) + time.perf_counter() - t0
    cls.splitdata = timed
    try:
        yield
    finally:
        cls.splitdata = fn


def tile_errors(folder: str, scenes: dict) -> tuple[int, int]:
    """Every tile image under folder against the crop of
    resize_cubic_uint8(scene, rate) that its name gives (zero-padded to
    DOTA_SUBSIZE) -> (tiles checked, tiles that differ)."""
    from orientedreppoints_tpu_torch.data import image_io
    from orientedreppoints_tpu_torch.devkit.dota_utils import parse_tile_name
    from orientedreppoints_tpu_torch.host import resize_cubic_uint8

    resized, checked, bad = {}, 0, 0
    for f in sorted(os.listdir(folder)):
        name, rate, left, up = parse_tile_name(os.path.splitext(f)[0])
        if (name, rate) not in resized:
            resized[name, rate] = resize_cubic_uint8(scenes[name], rate)
        want = np.zeros((DOTA_SUBSIZE, DOTA_SUBSIZE, 3), np.uint8)
        crop = resized[name, rate][up:up + DOTA_SUBSIZE,
                                   left:left + DOTA_SUBSIZE]
        want[:crop.shape[0], :crop.shape[1]] = crop
        checked += 1
        bad += not np.array_equal(image_io.imread(os.path.join(folder, f)),
                                  want)
    return checked, bad


def hrsc_xml(objs) -> str:
    """HRSC2016 XML of rotated boxes (poly2rbox's cx, cy, w, h, angle)."""
    from orientedreppoints_tpu_torch.core.rbox import poly2rbox

    boxes = poly2rbox(np.stack([o["poly"] for o in objs])) if objs else []
    body = "".join(
        f"<HRSC_Object><difficult>0</difficult><mbox_cx>{b[0]}</mbox_cx>"
        f"<mbox_cy>{b[1]}</mbox_cy><mbox_w>{b[2]}</mbox_w><mbox_h>{b[3]}"
        f"</mbox_h><mbox_ang>{b[4]}</mbox_ang></HRSC_Object>" for b in boxes)
    return f"<HRSC_Image><HRSC_Objects>{body}</HRSC_Objects></HRSC_Image>"


def phase_dota_input(dev, ops_mod, card):
    """Real DOTA input without cv2: two DOTA-sized scenes rendered and
    written as PNG in raw/{train,val,test} (test without labels), each
    read back equal; the decoder's ms a megapixel (the port's Up-filtered
    PNGs and a Paeth-filtered one); devkit/prepare.prepare_dota1_ms
    (subsize 1024, rate 1.0 at gap 824, 0.5 and 1.5 at 500; seconds by
    rate), every tile equal to its crop of resize_cubic_uint8(scene,
    rate), the rate-1 labels equal to the .npy route's; two ship-only
    scenes as BMP through prepare_hrsc2016 and the HrscDataset; then
    tools/test_torch.py's path in this process over the test split's PNG
    tiles with the R-50 demo config at full width (bf16, batch 4, seeded
    weights perturbed as in `slice`, from a state dict file): counted
    through the kernels, then the first DOTA_PLAIN_IMAGES tiles through
    the plain DCN forward, over-mask and scan (each min-area-rect call
    checked against its plain version), Task1 files of those tiles byte
    for byte; images/s with the PNG loading, the test pipeline's ms a
    tile alone, the merged files (the test tool's default pool, then one
    process: byte for byte, both timed; their polygon IoUs through the
    host library), poly_nms on the largest class file's first scene (its
    first DOTA_NMS_CHECK dets) keeping exactly what the numpy IoU's loop
    keeps, both timed, and the val scene's labels as
    detections scoring mAP 1 and mAOE 0; last DOTA_TRAIN_STEPS SGD steps of the config (batch
    TRAIN_BATCH) on the trainval tiles through its train pipeline and
    loader, every loss finite and each training kernel launched as often
    a step as the step calls it."""
    import logging

    from orientedreppoints_tpu_torch import apis
    from orientedreppoints_tpu_torch.data import image_io
    from orientedreppoints_tpu_torch.data.synth import SYNTH_CLASS_SPECS
    from orientedreppoints_tpu_torch.devkit import (dota_utils, evaluation,
                                                    hrsc, img_split, native,
                                                    polygon, prepare,
                                                    result_merge)
    from orientedreppoints_tpu_torch.devkit.dota_utils import (
        DOTA10_CLASSES, parse_dota_poly, write_dota_poly)
    from orientedreppoints_tpu_torch.host import load_config

    rng = np.random.RandomState(DOTA_SEED)
    secs = {}
    clock = [time.perf_counter()]

    def stage(name):
        now = time.perf_counter()
        secs[name] = now - clock[0]
        clock[0] = now

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as wd:
        def path(*p):
            return os.path.join(wd, *p)

        # 1. scenes: A in train, B in val and (unlabelled) test
        scenes, labels = {}, {}
        for name, (h, w) in zip(("DA0000", "DB0000"), DOTA_SCENES):
            scenes[name], labels[name] = render_dota_scene(
                rng, h, w, DOTA_OBJECTS)
        stage("render_s")
        where = {"train": ["DA0000"], "val": ["DB0000"], "test": ["DB0000"]}
        for split, names in where.items():
            os.makedirs(path("raw", split, "images"))
            if split != "test":
                os.makedirs(path("raw", split, "labelTxt"))
            for n in names:
                image_io.imwrite(path("raw", split, "images", n + ".png"),
                                 scenes[n])
                if split != "test":
                    write_dota_poly(path("raw", split, "labelTxt",
                                         n + ".txt"), labels[n])
        stage("write_png_s")
        round_trip = all(
            np.array_equal(image_io.imread(path("raw", s, "images",
                                                n + ".png")), scenes[n])
            for s, names in where.items() for n in names)
        decode = {}
        for n in scenes:
            decode[n], _ = decode_ms_per_mpx(path("raw", "train" if n ==
                                                  "DA0000" else "val",
                                                  "images", n + ".png"))
        paeth_png(path("paeth.png"), scenes["DA0000"])
        decode["DA0000_paeth"], back = decode_ms_per_mpx(path("paeth.png"),
                                                          1)
        round_trip &= np.array_equal(back, scenes["DA0000"])
        stage("decode_checks_s")

        # 2. prep: split seconds by rate, every tile, the .npy route
        split_s = {}
        with timed_by_rate(img_split.ImgSplit, split_s):
            trainval, test = prepare.prepare_dota1_ms(
                path("raw"), path("prep"), gap_ss=DOTA_GAPS[0],
                gap_ms=DOTA_GAPS[1], subsize=DOTA_SUBSIZE)
        stage("prepare_dota1_ms_s")
        tiles = {d: sorted(os.listdir(os.path.join(d, "images")))
                 for d in (trainval, test)}
        checked, bad = 0, 0
        for d in (trainval, test):
            c, b = tile_errors(os.path.join(d, "images"), scenes)
            checked, bad = checked + c, bad + b
        stage("tile_checks_s")
        os.makedirs(path("raw_npy", "images"))
        np.save(path("raw_npy", "images", "DA0000.npy"), scenes["DA0000"])
        shutil.copytree(path("raw", "train", "labelTxt"),
                        path("raw_npy", "labelTxt"))
        img_split.ImgSplit(path("raw_npy"), path("npy_split"),
                           gap=DOTA_GAPS[0],
                           subsize=DOTA_SUBSIZE, ext=".npy",
                           num_process=1).splitdata(1.0)
        npy_labels = sorted(os.listdir(path("npy_split", "labelTxt")))
        png_labels = sorted(f for f in os.listdir(os.path.join(
            trainval, "labelTxt")) if f.startswith("DA0000__1.0__"))
        labels_equal = npy_labels == png_labels and all(
            open(path("npy_split", "labelTxt", f), "rb").read()
            == open(os.path.join(trainval, "labelTxt", f), "rb").read()
            for f in npy_labels)
        stage("npy_route_s")

        # HRSC: ship-only scenes as BMP -> prepare_hrsc2016 -> dataset
        ships = {"ship": SYNTH_CLASS_SPECS["ship"]}
        hrsc_dir = path("hrsc", "Train")
        os.makedirs(os.path.join(hrsc_dir, "AllImages"))
        os.makedirs(os.path.join(hrsc_dir, "Annotations"))
        bmps, n_ships = {}, 0
        for k in range(HRSC_PREP_SCENES):
            name = f"10000{k}"
            bmps[name + ".bmp"], objs = render_dota_scene(
                rng, *HRSC_PREP_SIZE, 12,
                specs=ships)
            n_ships += len(objs)
            image_io.imwrite(os.path.join(hrsc_dir, "AllImages",
                                          name + ".bmp"),
                             bmps[name + ".bmp"])
            with open(os.path.join(hrsc_dir, "Annotations", name + ".xml"),
                      "w") as f:
                f.write(hrsc_xml(objs))
        hrsc.prepare_hrsc2016(path("hrsc"))
        hrsc_ds = apis.build_dataset(dict(
            type="HrscDataset",
            ann_file=os.path.join(hrsc_dir, "hrsc_train.json"),
            img_prefix=os.path.join(hrsc_dir, "images"), test_mode=True,
            pipeline=[dict(type="LoadImageFromFile")]))
        hrsc_ok = (len(hrsc_ds) == HRSC_PREP_SCENES
                   and sum(len(a["labels"]) for a in hrsc_ds.anns) == n_ships
                   and all(np.array_equal(
                       hrsc_ds[i]["img"],
                       bmps[hrsc_ds[i]["img_info"]["file_name"]])
                       for i in range(len(hrsc_ds))))
        stage("hrsc_s")
        say("dota_input_data", scenes={n: list(s.shape[:2])
                                       for n, s in scenes.items()},
            scene_gts={n: len(v) for n, v in labels.items()},
            png_round_trip_equal=round_trip, decode_ms_per_mpx=decode,
            split_s_by_rate={str(r): s for r, s in split_s.items()},
            tiles_trainval=len(tiles[trainval]),
            tiles_test=len(tiles[test]), tiles_checked=checked,
            tiles_differing=bad, rate1_labels_equal_npy_route=labels_equal,
            hrsc_images=len(hrsc_ds), hrsc_ships=n_ships, hrsc_ok=hrsc_ok,
            **secs)

        # 3. serving: tools/test_torch.py's path on the test split
        with open(CONFIG) as f:
            text = f.read()
        for split, d, ann in (("test", test, "test_dota.json"),
                              ("train", trainval, "trainval_dota.json")):
            text += (f"\ndata[{split!r}].update(ann_file="
                     f"{os.path.join(d, ann)!r}, img_prefix="
                     f"{os.path.join(d, 'images')!r})\n")
        with open(path("dota_r50.py"), "w") as f:
            f.write(text)
        sd = perturbed_weights(np.random.default_rng(SEED + 8), CONFIG)
        torch.save(sd, path("w.pt"))
        tool = load_tool("test_torch")
        log = logging.getLogger("test_torch")
        common = [path("dota_r50.py"), "--checkpoint", path("w.pt"),
                  "--batch_size", str(BATCH), "--device", str(dev)]
        args = tool.parse_args(common + [
            "--out", path("results.npz"), "--format_task1", path("task1"),
            "--merge_dir", path("merged")])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops_mod.reset_launch_counts()
        results, ds, serve_s = tool.infer(args, log)
        launches = ops_mod.launch_counts()
        serve_peak = torch.cuda.max_memory_allocated()
        clock[0] = time.perf_counter()
        pool_s = []  # the test tool's merge (the default pool) alone
        merge_fn = result_merge.merge_by_poly

        def timed_merge(*a, **kw):
            t0 = time.perf_counter()
            merge_fn(*a, **kw)
            pool_s.append(time.perf_counter() - t0)

        result_merge.merge_by_poly = timed_merge
        try:
            tool.emit_outputs(args, results, ds, log)
        finally:
            result_merge.merge_by_poly = merge_fn
        stage("write_merge_s")
        # the same Task1 files merged in this process: byte for byte, each
        # class file's time (the pool's is at least its largest's)
        file_s = {}
        single_fn = result_merge.merge_single

        def timed_single(dst, thresh, fn):
            t0 = time.perf_counter()
            single_fn(dst, thresh, fn)
            file_s[os.path.basename(fn)] = time.perf_counter() - t0

        result_merge.merge_single = timed_single
        t0 = time.perf_counter()
        try:
            result_merge.merge_by_poly(path("task1"), path("merged_1"),
                                       num_process=1)
        finally:
            result_merge.merge_single = single_fn
        one_s = time.perf_counter() - t0
        task1_files = sorted(os.listdir(path("task1")))
        # what the pool's workers cost to start: spawned, each imports the
        # devkit and this file without torch (tools/test_torch.py: numpy)
        t0 = time.perf_counter()
        with multiprocessing.get_context("spawn").Pool(
                len(task1_files)) as pool:
            pool.map(dota_utils.basename_noext, task1_files, chunksize=1)
        pool_start_s = time.perf_counter() - t0
        merge_equal = sorted(os.listdir(path("merged"))) == sorted(
            os.listdir(path("merged_1"))) == task1_files and all(
            open(path("merged", f), "rb").read()
            == open(path("merged_1", f), "rb").read() for f in task1_files)
        largest = max(task1_files, key=lambda f: os.path.getsize(
            path("task1", f)))
        nms_dets = first_scene_dets(path("task1", largest))[:DOTA_NMS_CHECK]
        t0 = time.perf_counter()
        keep_lib = polygon.poly_nms(nms_dets, result_merge.NMS_THRESH)
        nms_lib_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        with numpy_iou():
            keep_np = polygon.poly_nms(nms_dets, result_merge.NMS_THRESH)
        nms_numpy_s = time.perf_counter() - t0
        nms_equal = keep_lib == keep_np and 0 < len(keep_lib) < len(nms_dets)
        clock[0] = time.perf_counter()
        # the host's share: the test pipeline alone (PNG decode included)
        t0 = time.perf_counter()
        for i in range(DOTA_PLAIN_IMAGES):
            ds[i]
        host_ms = (time.perf_counter() - t0) * 1e3 / DOTA_PLAIN_IMAGES
        # the first batches through the plain versions (the plain
        # over-mask takes ~2.2 s a batch): their Task1 files against the
        # kernel route's of the same tiles
        rects = []
        with plain_inference(rects):
            results_plain, _, plain_s = tool.infer(tool.parse_args(
                common + ["--max_images", str(DOTA_PLAIN_IMAGES)]), log)
        subset = {k: results[k] for k in results_plain}
        same = same_results(subset, results_plain)
        for folder, res in (("sub_kernel", subset),
                            ("sub_plain", results_plain)):
            result_merge.write_task1_results(res, DOTA10_CLASSES,
                                             path(folder))
        task1_equal = sorted(os.listdir(path("sub_kernel"))) == sorted(
            os.listdir(path("sub_plain"))) and all(
            open(path("sub_kernel", f), "rb").read()
            == open(path("sub_plain", f), "rb").read()
            for f in os.listdir(path("sub_kernel")))
        clock[0] = time.perf_counter()
        # the classes the val scene has (VOC AP of a class without a gt
        # is not 1)
        classnames = sorted({o["name"] for o in labels["DB0000"]})
        annopath = path("raw", "val", "labelTxt", "{:s}.txt")
        mAP, _ = evaluation.eval_dota_task1(
            path("merged", "Task1_{:s}.txt"), annopath, ["DB0000"],
            classnames=classnames, use_07_metric=False)
        oracle = {"DB0000": [np.array(
            [list(o["poly"]) + [1.0] for o in parse_dota_poly(
                annopath.format("DB0000")) if o["name"] == c],
            np.float64).reshape(-1, 9) for c in DOTA10_CLASSES]}
        result_merge.write_task1_results(oracle, DOTA10_CLASSES,
                                         path("oracle"))
        o_det = path("oracle", "Task1_{:s}.txt")
        o_map, _ = evaluation.eval_dota_task1(
            o_det, annopath, ["DB0000"], classnames=classnames,
            use_07_metric=False)
        o_maoe, _ = evaluation.eval_maoe(o_det, annopath, ["DB0000"],
                                         classnames=classnames,
                                         ovthresh=0.7)
        stage("score_s")
        dets = [sum(len(a) for a in per) for per in results.values()]
        npz_keys = len(np.load(path("results.npz")).files)
        merged_dets = count_lines(path("merged"))

        # 4. training: DOTA_TRAIN_STEPS steps on the trainval tiles
        cfg = load_config(path("dota_r50.py"))
        train_ds = train_dataset(cfg)
        loader = apis.build_dataloader(train_ds, cfg, batch_size=TRAIN_BATCH,
                                       seed=SEED)
        model, _ = apis.init_detector(cfg, state_dict=sd,
                                      compute_dtype=cfg["tpu"][
                                          "compute_dtype"], device=dev)
        opt, sched, step = apis.build_trainer(model, cfg, len(loader),
                                              seed=SEED)
        routes = synth_kernel_routes()
        records, hull_calls, rect_calls = [], [], []

        def on_step(epoch, losses, stats, batch):
            records.append({k: float(v) for k, v in losses.items()})
            say("dota_input_train_step", step=len(records), **records[-1],
                refine_pos_per_image=(stats["gt_inds"] > 0).sum(1).tolist(),
                gts=int(batch["gt_valid"].sum()))

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops_mod.reset_launch_counts()
        with count_calls(*routes["min_area_rect_hull"][:2], hull_calls), \
                count_calls(*routes["min_area_rect_rect"][:2], rect_calls):
            run = apis.train_epochs(model, loader, step, opt, sched,
                                    path("ckpts"), 1,
                                    max_iters=DOTA_TRAIN_STEPS,
                                    ckpt_interval=10,
                                    meta=dict(classes=list(train_ds.CLASSES)),
                                    on_step=on_step)
        train_launches = ops_mod.launch_counts()
        train_peak = torch.cuda.max_memory_allocated()
        del model, opt, sched, step
        n_train = len(train_ds)

    n = len(records)
    per_step = {k: train_launches[k] / max(n, 1) for k in TRAIN_KERNELS}
    calls = dict(hull=len(hull_calls) / max(n, 1),
                 rect=len(rect_calls) / max(n, 1))
    # a step: the min-area-rect kernel for the hull once and the rect
    # twice, the hull IoU once, the paired DCN forward and backward once
    launches_ok = (n == DOTA_TRAIN_STEPS and calls == dict(hull=1, rect=2)
                   and per_step == {"min_area_rect": 3, "hull_quad_iou": 1,
                                    "deform_sample_pair": 1,
                                    "deform_sample_pair_backward": 1})
    finite = all(np.isfinite(v) for r in records for v in r.values())
    ok_serve = (all(launches[k] > 0 for k in SERVING_KERNELS)
                and len(results) == len(tiles[test])
                and len(results_plain) == DOTA_PLAIN_IMAGES and same
                and task1_equal
                and len(rects) == -(-DOTA_PLAIN_IMAGES // BATCH)
                and all(r["ok"] for r in rects) and min(dets) > 0
                and abs(o_map - 1.0) <= 1e-12 and o_maoe == 0.0
                and np.isfinite(mAP) and merged_dets > 0)
    ok = (round_trip and bad == 0 and checked == sum(map(len, tiles.values()))
          and labels_equal and hrsc_ok and ok_serve and finite
          and launches_ok and merge_equal and len(pool_s) == 1
          and nms_equal)
    waits, times = run["wait_s"], run["step_s"]
    say("dota_input", config=CONFIG, batch=BATCH,
        dtype=cfg["tpu"]["compute_dtype"],
        test_tiles=len(results), launches=launches,
        images_per_s=len(results) / serve_s, serve_s=serve_s,
        host_pipeline_ms_per_tile=host_ms, plain_tiles=len(results_plain),
        plain_serve_s=plain_s, max_memory_allocated_bytes=serve_peak,
        dets_per_tile_min=min(dets), dets_tiles=sum(dets),
        dets_merged=merged_dets, npz_arrays=npz_keys,
        merge_pool_s=pool_s[0] if pool_s else None,
        merge_one_process_s=one_s,
        merge_workers=min(16, len(task1_files)), cpu_count=os.cpu_count(),
        merge_pool_start_s=pool_start_s,
        merge_largest_files_s=dict(sorted(
            file_s.items(), key=lambda kv: -kv[1])[:3]),
        cpu_affinity=len(os.sched_getaffinity(0)), cpu_quota=cpu_quota(),
        merge_byte_equal=merge_equal,
        host_lib_build_s=native.build_seconds, nms_check_file=largest,
        nms_check_dets=len(nms_dets), nms_check_kept=len(keep_lib),
        nms_lib_s=nms_lib_s, nms_numpy_s=nms_numpy_s,
        nms_equal_numpy=nms_equal,
        plain_equal_det_for_det=same, task1_byte_equal=task1_equal,
        min_area_rect_calls_checked=len(rects),
        min_area_rect_ties=sum(r["ties"] for r in rects),
        merged_mAP=mAP, oracle_mAP=o_map, oracle_mAOE_deg=o_maoe,
        train_tiles=n_train, train_batch=TRAIN_BATCH, train_steps=n,
        train_losses=records, step_ms=[t * 1e3 for t in times],
        loader_wait_ms=[w * 1e3 for w in waits],
        loader_wait_share=sum(waits) / (sum(waits) + sum(times)),
        train_max_memory_allocated_bytes=train_peak,
        train_launches=train_launches, launches_per_step=per_step,
        min_area_rect_entry_calls_per_step=calls, finite=finite,
        phase_s=time.perf_counter() - t_phase, **secs, card=card, ok=ok)
    return ok, launches, train_launches


def first_scene_dets(fn: str) -> np.ndarray:
    """The (n, 9) dets of a Task1 file of tiles that belong to its first
    line's scene, mapped into the scene as merge_single maps them."""
    from orientedreppoints_tpu_torch.devkit import dota_utils

    dets, scene = [], None
    with open(fn) as f:
        for line in f:
            parts = line.split()
            name, rate, left, up = dota_utils.parse_tile_name(parts[0])
            scene = scene or name
            if name != scene:
                continue
            poly = np.array([float(v) for v in parts[2:10]], np.float64)
            row = np.empty(9, np.float64)
            row[0:8:2] = (poly[0::2] + left) / rate
            row[1:8:2] = (poly[1::2] + up) / rate
            row[8] = float(parts[1])
            dets.append(row)
    return np.stack(dets)


SHARD_BATCH = 4  # the sharded Predictor's batch: 2 a replica
SHARD_SCORE_TOL = 2e-3  # bf16 head outputs of another cuDNN algorithm
SHARD_CENTRE_TOL = 1.0  # px
DDP_STEPS = 3
DDP_PROBE_STEPS = 2  # more steps a rank, their all-reduces timed
# (backend, world, planted fault): W = 2 is two processes on cuda:0
DDP_RUNS = (("nccl", 1, None), ("gloo", 2, None), ("gloo", 2, "giou_local"))
DDP_TIMEOUT = 300.0
# step 1 of a group against the one-process losses of the same forward:
# only the order of the sums differs
DDP_STEP1_RTOL = 1e-4
# W = 2 against the one-process run that forwards its rows one at a time,
# where they differ: the grads associate otherwise (each rank sums its
# levels, then the all-reduce adds the ranks), and the rounding grows
# through bf16 and the assigners.  The parameters within 3 x 0.00507 of
# the update over the 3 steps, which the earlier gate (3 x the run-to-run
# noise of the DCN backward's float atomics, ROADMAP Queue 3 item 4) let
# through; each later loss within DDP_W2_LOSS_RTOL of its value
DDP_W2_UPDATE_RTOL = 3 * 0.00507
DDP_W2_LOSS_RTOL = 1e-2
# a training step's launches: min-area rect 3 (hull 1, rect 2), hull IoU 1,
# DCN forward 1 and backward 1
DDP_LAUNCHES = {"min_area_rect": 3.0, "hull_quad_iou": 1.0,
                "deform_sample_pair": 1.0, "deform_sample_pair_backward": 1.0}


def first_batch_differences(model, x, n: int = 3) -> list:
    """The first n leaf modules (in module order) whose output on the
    batch x differs from their outputs on its two halves stacked, each
    with its type and largest difference."""
    rec, hooks = {}, []
    for name, m in model.named_modules():
        if not any(m.children()):
            hooks.append(m.register_forward_hook(
                lambda mod, i, o, name=name: rec.setdefault(
                    name, (type(mod).__name__, []))[1].append(o)))
    try:
        half = len(x) // 2
        model(x), model(x[:half]), model(x[half:])
    finally:
        for h in hooks:
            h.remove()
    out = []
    for name, (kind, outs) in rec.items():
        if len(outs) == 3 and all(isinstance(o, torch.Tensor) for o in outs):
            whole, halves = outs[0], torch.cat(outs[1:])
            if not torch.equal(whole, halves):
                out.append([name, kind, float(
                    (whole.float() - halves.float()).abs().max())])
    return out[:n]


def phase_shard_infer(dev, rng, ops_mod, card, sd):
    """parallel/infer.py on the card: the R-50 demo Predictor (bf16,
    batch 4) sharded over [dev, dev], two replicas of two images each,
    counted; bit for bit against the one-device Predictor at the
    replica's batch (2: each shard's own program).  Against the
    one-device Predictor at batch 4 cuDNN picks other bf16 convolutions
    (it chooses its algorithm by the batch: the first output that differs
    is a layer4 3x3 convolution's), so with cuDNN that comparison is read:
    the head outputs' largest difference, and the share of its dets that
    the sharded run has too (same label, score within SHARD_SCORE_TOL,
    centre within SHARD_CENTRE_TOL px).  With cuDNN off (PyTorch's own
    convolutions, one sample at a time) it is gated: the batch-4 head
    outputs equal the batch-2 halves' bit for bit, and the sharded run
    the one-device batch-4 run det for det, bit for bit."""
    from orientedreppoints_tpu_torch.parallel.infer import data_devices
    from orientedreppoints_tpu_torch.serving import Predictor

    preds = {name: Predictor(CONFIG, state_dict=sd, batch_size=bs,
                             compute_dtype="bfloat16", device=dev,
                             devices=devs)
             for name, bs, devs in (("sharded", SHARD_BATCH, [dev, dev]),
                                    ("one_b4", SHARD_BATCH, None),
                                    ("one_b2", SHARD_BATCH // 2, None))}
    images = [(rng.random((1024, 1024, 3)) * 255).astype(np.uint8)
              for _ in range(N_IMAGES)]

    def run(name):
        p = preds[name]
        outs = [p.infer(images[lo:lo + p.batch_size])
                for lo in range(0, N_IMAGES, p.batch_size)]
        return tuple(torch.cat(t) for t in zip(*outs))

    with torch.inference_mode():
        run("sharded")  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops_mod.reset_launch_counts()
        t0 = time.perf_counter()
        got = run("sharded")
        torch.cuda.synchronize()
        sharded_s = time.perf_counter() - t0
        launches = ops_mod.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        times = {}
        for name in ("one_b4", "sharded"):
            t0 = time.perf_counter()
            out = run(name)
            torch.cuda.synchronize()
            times[name] = time.perf_counter() - t0
            if name == "one_b4":
                b4 = out
        b2 = run("one_b2")
        canvases = preds["one_b4"].prepare(images[:SHARD_BATCH])[0]
        model = preds["one_b4"].model
        heads = [model(canvases), model(canvases[:2]), model(canvases[2:])]
        first_diffs = first_batch_differences(model, canvases)
        with torch.backends.cudnn.flags(enabled=False, benchmark=False,
                                        deterministic=False,
                                        allow_tf32=False):
            t0 = time.perf_counter()
            off = [run("sharded"), run("one_b4")]
            off_heads = [model(canvases), model(canvases[:2]),
                         model(canvases[2:])]
            torch.cuda.synchronize()
            off_s = time.perf_counter() - t0
    off_equal = all(torch.equal(a, b) for a, b in zip(*off))
    off_heads_equal = all(
        torch.equal(a, torch.cat([b, c]))
        for k in off_heads[0]
        for a, b, c in zip(*(h[k] for h in off_heads)))
    head_err = max(float((a.float() - torch.cat([b, c]).float()).abs().max()
                         / a.float().abs().max())
                   for k in ("cls_scores", "pts_refine")
                   for a, b, c in zip(*(h[k] for h in heads)))
    exact_b2 = all(torch.equal(a, b) for a, b in zip(got, b2))
    (d, lab, v), (d4, lab4, v4) = got, b4
    found = []  # per image: the batch-4 dets the sharded run also has
    for i in range(N_IMAGES):
        a, b = d[i][v[i]], d4[i][v4[i]]
        ca, cb = (x[:, 18:26].reshape(-1, 4, 2).mean(1) for x in (a, b))
        near = ((torch.cdist(cb, ca) <= SHARD_CENTRE_TOL)
                & ((b[:, None, 26] - a[None, :, 26]).abs() <= SHARD_SCORE_TOL)
                & (lab4[i][v4[i]][:, None] == lab[i][v[i]][None, :]))
        found.append(near.any(1).float().mean())
    batches = N_IMAGES // SHARD_BATCH
    want = {k: 2 * batches for k in SERVING_KERNELS}
    finite = bool(torch.isfinite(d[v]).all())
    ok = (exact_b2 and off_equal and off_heads_equal and finite
          and int(v.sum()) > 0
          and all(launches[k] == want[k] for k in SERVING_KERNELS))
    devices = data_devices()
    say("shard_infer", config=CONFIG, devices=[str(x) for x in (dev, dev)],
        data_devices=devices and [str(x) for x in devices],
        cuda_device_count=torch.cuda.device_count(), batch=SHARD_BATCH,
        per_replica=SHARD_BATCH // 2, images=N_IMAGES, dtype="bfloat16",
        dets=int(v.sum()), equal_to_one_device_batch2=exact_b2,
        batch4_head_max_rel_diff=head_err,
        batch4_dets=int(v4.sum()),
        batch4_dets_found_share=[float(f) for f in found],
        batch4_first_differing_modules=first_diffs,
        cudnn_off_batch4_heads_equal_halves=off_heads_equal,
        cudnn_off_equal_to_one_device_batch4=off_equal,
        cudnn_off_dets=int(off[0][2].sum()), cudnn_off_s=off_s,
        launches=launches, launches_expected=want, finite=finite,
        images_per_s_sharded=N_IMAGES / times["sharded"],
        images_per_s_one_device=N_IMAGES / times["one_b4"],
        counted_run_s=sharded_s, max_memory_allocated_bytes=peak, card=card,
        ok=ok)
    return ok, launches


def plant_fault(name: str | None) -> None:
    """Phase ddp's planted fault, in a rank: "giou_local" makes the
    rbox losses divide by the rank's own positives (each level's n_lvl
    and num_pos, as stock DDP would), not the group's."""
    if name is None:
        return
    from orientedreppoints_tpu_torch.core import loss_head

    assert name == "giou_local", name
    real = loss_head.giou_loss

    def local(pred, gt, weight, divisor, **kw):
        return real(pred, gt, weight, divisor=(weight > 0).sum(), **kw)
    loss_head.giou_loss = local


def ddp_rank(spec_path: str) -> int:
    """One rank of phase ddp's group (run as python3 chip_smoke.py
    --ddp_rank SPEC by tools/launch_torch.launch_local): the R-50 step of
    apis.build_trainer on this rank's rows of the batch, DDP_STEPS steps,
    each timed to its end (one synchronize) with nothing else in it;
    rank 0 saves their losses and the parameters after them.  Then
    DDP_PROBE_STEPS more steps with every all-reduce timed between two
    synchronizes.  Prints one line: the steps' ms, the probe steps' ms and
    all-reduce ms, peak memory, launches a step (over the timed steps),
    losses."""
    from orientedreppoints_tpu_torch import apis
    from orientedreppoints_tpu_torch import ops as ops_mod
    from orientedreppoints_tpu_torch.parallel import dist
    from orientedreppoints_tpu_torch.parallel.train import to_device

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = torch.load(spec_path, weights_only=False)
    plant_fault(spec["fault"])
    dev = torch.device("cuda", dist.local_rank())
    group = dist.init_from_env(dev, spec["backend"])
    try:
        r, w = dist.rank(group), dist.world_size(group)
        model, cfg = apis.init_detector(CONFIG, state_dict=spec["sd"],
                                        compute_dtype="bfloat16", device=dev)
        step = apis.build_trainer(model, cfg, seed=SEED, group=group)[2]
        b = len(spec["batch"]["images"]) // w
        batch = to_device({k: v[r * b:(r + 1) * b]
                           for k, v in spec["batch"].items()}, dev)
        torch.cuda.reset_peak_memory_stats(dev)
        ops_mod.reset_launch_counts()
        losses, step_ms = [], []
        for _ in range(DDP_STEPS):
            t0 = time.perf_counter()
            out = step(batch)
            torch.cuda.synchronize(dev)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append({k: float(v) for k, v in out.items()})
        launches = ops_mod.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        if r == 0:
            torch.save(dict(losses=losses, launches=launches, params={
                k: v.detach().float().cpu() for k, v in
                model.state_dict().items()}), spec["out"])
        reduce_s, real = [], dist.all_reduce_sum

        def timed(t, g):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            out = real(t, g)
            torch.cuda.synchronize(dev)
            reduce_s.append(time.perf_counter() - t0)
            return out

        probe_ms, reduce_ms, n_reduce = [], [], 0
        dist.all_reduce_sum = timed
        try:
            for _ in range(spec["probe_steps"]):
                reduce_s.clear()
                t0 = time.perf_counter()
                step(batch)
                torch.cuda.synchronize(dev)
                probe_ms.append((time.perf_counter() - t0) * 1e3)
                reduce_ms.append(sum(reduce_s) * 1e3)
                n_reduce = len(reduce_s)
        finally:
            dist.all_reduce_sum = real
        say("ddp_rank", rank=r, world=w, backend=spec["backend"],
            fault=spec["fault"], device=str(dev), rows=b, step_ms=step_ms,
            probe_step_ms=probe_ms, allreduce_ms=reduce_ms,
            allreduces_a_step=n_reduce, max_memory_allocated_bytes=peak,
            launches=launches,
            launches_per_step={k: launches[k] / DDP_STEPS
                               for k in TRAIN_KERNELS},
            losses=losses)
        dist.barrier(group)
    finally:
        dist.destroy(group)
    return 0


def tree_cat(outs: list) -> dict:
    """The detector's output dicts (lists of per-level tensors) of
    several batches, concatenated along the batch."""
    return {k: [torch.cat(x) for x in zip(*(o[k] for o in outs))]
            for k in outs[0]}


def forward_by_rows(model) -> None:
    """Make the model forward its batch one row at a time and stack the
    outputs, as W ranks of a row each forward it: cuDNN picks its
    convolutions by the batch, so a batch of 2 rounds otherwise than two
    of 1 (phase shard_infer names the first module that differs)."""
    forward = model.forward
    model.forward = lambda x, gen=None: tree_cat(
        [forward(x[i:i + 1], gen) for i in range(len(x))])


def loss_rel(a: dict, b: dict) -> dict:
    """Each loss of a relative to b's value of it (the counts left out)."""
    return {k: abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
            for k in b if k.startswith("loss")}


def ddp_gate(got: list, ref: list, tol: dict) -> dict:
    """A group's per-step losses against the one-process run ref of the
    same forward, loss by loss: step 1 within DDP_STEP1_RTOL of each loss
    and with the same counts, every later step within tol[k] of loss
    k."""
    first = loss_rel(got[0], ref[0])
    later = [loss_rel(g, r) for g, r in zip(got[1:], ref[1:])]
    counts = all(got[0][k] == ref[0][k] for k in ref[0]
                 if not k.startswith("loss"))
    ok = (counts and len(got) == len(ref)
          and all(v <= DDP_STEP1_RTOL for v in first.values())
          and all(v <= tol[k] for rel in later for k, v in rel.items()))
    return dict(step1_rel=first, step1_counts_equal=counts,
                later_rel=later, ok=ok)


def phase_ddp(dev, ops_mod, card, sd, batch):
    """Data-parallel training on the card: the R-50 demo's SGD step (bf16,
    1344^2) on the train phase's batch of 2 and its gts, DDP_STEPS steps,
    as one NCCL process (W = 1) and as two gloo processes on this card
    (W = 2, a row each: NCCL refuses two ranks on one GPU), each a child
    process (tools/launch_torch.launch_local), held against the
    one-process step at batch 2 of the same forward: for W = 1 the step
    run here (a), for W = 2 the step with the batch's rows forwarded one
    at a time (rows, forward_by_rows: the ranks' convolutions are cuDNN's
    at batch 1).  The step repeats bit for bit (utils/determinism.py): a
    and two more runs (b, c) must be equal bit for bit, and so must the
    W = 1 group and a, every loss and parameter.  W = 2 sums the grads of
    its two rows in another order than rows does (each rank's levels,
    then the all-reduce), so it is held where it differs: the parameters
    within DDP_W2_UPDATE_RTOL of the update, each loss on its own value
    (ddp_gate) at step 1 within DDP_STEP1_RTOL with the same counts,
    later steps within DDP_W2_LOSS_RTOL.  A planted fault, the W = 2 group
    with the rbox losses over each rank's own positives (plant_fault),
    must fail the same gate.  Every rank must launch the training kernels
    each step (hull 1, rect 2, hull IoU 1, DCN forward 1 and backward
    1)."""
    from tools.launch_torch import launch_local

    host_batch = {k: v.cpu().numpy() for k, v in batch.items()}
    start = {k: v.float() for k, v in sd.items()}
    runs = []
    for rows in (False, False, False, True):  # a, b, c (the noise), rows
        model, step = build_trainer(sd, "bfloat16", dev)
        if rows:
            forward_by_rows(model)
        losses = []
        for _ in range(DDP_STEPS):
            losses.append({k: float(v) for k, v in step(batch).items()})
        torch.cuda.synchronize()
        runs.append((losses, {k: v.detach().float().cpu()
                              for k, v in model.state_dict().items()}))
        del model, step
        torch.cuda.empty_cache()
    (la, pa), (lb, pb), (lc, pc), (lr, pr) = runs
    repeat_equal = (la == lb == lc and same_states(pa, pb)
                    and same_states(pa, pc))
    tol = {k: DDP_W2_LOSS_RTOL for k in loss_rel(la[0], la[0])}
    ok, results, totals = repeat_equal, {}, {k: 0 for k in ops_mod.KERNELS}
    wd = tempfile.mkdtemp(prefix="ddp_")
    try:
        for backend, world, fault in DDP_RUNS:
            name = f"{backend}_w{world}" + (f"_{fault}" if fault else "")
            spec = dict(sd=sd, batch=host_batch, backend=backend, fault=fault,
                        probe_steps=0 if fault else DDP_PROBE_STEPS,
                        out=os.path.join(wd, f"{name}.pt"))
            spec_path = os.path.join(wd, f"{name}.spec.pt")
            torch.save(spec, spec_path)
            t0 = time.perf_counter()
            try:
                outs = launch_local(
                    [sys.executable, os.path.abspath(__file__), "--ddp_rank",
                     spec_path], world, local_ranks=[dev.index or 0] * world,
                    timeout=DDP_TIMEOUT)
            except RuntimeError as e:
                say("ddp_failed", run=name, error=str(e)[-4000:])
                ok = False
                continue
            wall = time.perf_counter() - t0
            lines = [json.loads(line.split("] ", 1)[1]) for o in outs
                     for line in o.splitlines()
                     if line.startswith("[ddp_rank] ")]
            res = torch.load(spec["out"], weights_only=False)
            ref_losses, ref_params = (la, pa) if world == 1 else (lr, pr)
            diff = param_diffs(res["params"], ref_params, start)
            exact = (res["losses"] == ref_losses
                     and same_states(res["params"], ref_params))
            gate = ddp_gate(res["losses"], ref_losses, tol)
            per_step_ok = len(lines) == world and all(
                line["launches_per_step"] == DDP_LAUNCHES for line in lines)
            finite = all(np.isfinite(v) for rec in res["losses"]
                         for v in rec.values())
            within = exact or (world > 1 and gate["ok"] and diff[
                "update_rel"] <= DDP_W2_UPDATE_RTOL)
            held = (per_step_ok and finite and within
                    and all(line["losses"] == lines[0]["losses"]
                            for line in lines))
            # the planted fault must fail the gate; it launches as any
            # other run, so its counts stay out of the kernels' line
            run_ok = (not gate["ok"]) if fault else held
            ok &= run_ok
            if not fault:
                for line in lines:
                    for k in totals:
                        totals[k] += line["launches"][k]
            results[name] = dict(
                world=world, backend=backend, fault=fault, wall_s=wall,
                bitwise=exact, params_vs_one_process=diff,
                params_vs_batch2_forward=param_diffs(res["params"], pa,
                                                     start),
                loss_gate=gate,
                held=held, losses=res["losses"], ranks=lines, ok=run_ok)
            say("ddp_run", run=name, **results[name])
    finally:
        shutil.rmtree(wd, ignore_errors=True)
    complete = len(results) == len(DDP_RUNS)
    say("ddp", config=CONFIG, batch=TRAIN_BATCH, canvas=TRAIN_CANVAS,
        dtype="bfloat16", steps=DDP_STEPS, one_process_losses=la,
        one_process_losses_again=[lb, lc], one_process_losses_by_rows=lr,
        by_rows_vs_batch2=dict(
            step1_loss_rel=loss_rel(lr[0], la[0]),
            update_rel=param_diffs(pr, pa, start)["update_rel"]),
        one_process_repeat_bitwise=repeat_equal,
        w2_update_rtol=DDP_W2_UPDATE_RTOL, w2_loss_rtol=DDP_W2_LOSS_RTOL,
        step1_rtol=DDP_STEP1_RTOL,
        runs={k: dict(bitwise=v["bitwise"],
                      update_rel=v["params_vs_one_process"]["update_rel"],
                      update_rel_vs_batch2_forward=v[
                          "params_vs_batch2_forward"]["update_rel"],
                      step1_rel=v["loss_gate"]["step1_rel"],
                      later_rel=v["loss_gate"]["later_rel"],
                      held=v["held"], ok=v["ok"])
              for k, v in results.items()},
        launches=totals, card=card, ok=ok and complete)
    return ok and complete, totals

def load_tool(name: str):
    """tools/<name>.py as a module, its main not run."""
    spec = importlib.util.spec_from_file_location(name, f"tools/{name}.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def corruption_probe() -> np.ndarray:
    """A seeded 512^2 BGR uint8 image: 11-px cells of random colours
    (edges for the blurs, cells across the JPEG blocks) under +-24 of
    noise."""
    rng = np.random.RandomState(CORRUPT_PROBE_SEED)
    cells = rng.randint(0, 256, (47, 47, 3))
    img = (np.repeat(np.repeat(cells, 11, 0), 11, 1)[:512, :512]
           + rng.randint(-24, 25, (512, 512, 3)))
    return np.clip(img, 0, 255).astype(np.uint8)


def corruption_digests(reps: int = 2) -> tuple[dict, dict]:
    """Every (corruption, severity) of ROBUST_SEVERITIES applied to the
    probe by corruptions.corrupt with RandomState(CORRUPT_RNG_SEED) ->
    ({"name@sev": SHA-256 of the output}, {"name@sev": host ms of the
    last of reps calls})."""
    from orientedreppoints_tpu_torch.data import corruptions

    img = corruption_probe()
    digests, host_ms = {}, {}
    for name in corruptions.CORRUPTIONS:
        for sev in ROBUST_SEVERITIES:
            key = f"{name}@{sev}"
            for _ in range(reps):
                t0 = time.perf_counter()
                out = corruptions.corrupt(
                    img, name, sev, np.random.RandomState(CORRUPT_RNG_SEED))
                host_ms[key] = (time.perf_counter() - t0) * 1e3
            digests[key] = hashlib.sha256(
                np.ascontiguousarray(out)).hexdigest()
    return digests, host_ms


def phase_robustness(dev, ops_mod, card, wd):
    """tools/test_robustness_torch.py's path in this process, at the full
    width of EVAL_CONFIG (R-18, bf16, canvas 512^2, batch 4) with the eval
    phase's seeded weights, on its first ROBUST_IMAGES val tiles (in wd):
    the clean baseline, then each corruption at ROBUST_SEVERITIES, each
    setting counted on its own; ROBUST_PLAIN also through the plain
    versions (det for det); P, mPC, rPC and each setting's mAP (random
    weights: read, not gated); each corruption's host ms on one 512^2
    tile alone and the probe's 27 digests against CORRUPT_DIGESTS."""
    from orientedreppoints_tpu_torch import apis
    from orientedreppoints_tpu_torch.data.corruptions import CORRUPTIONS
    from orientedreppoints_tpu_torch.host import load_config

    t_phase = time.perf_counter()
    digests, host_ms = corruption_digests()
    differing = sorted(k for k in CORRUPT_DIGESTS
                       if digests.get(k) != CORRUPT_DIGESTS[k])
    tool = load_tool("test_robustness_torch")
    cfg = load_config(EVAL_CONFIG)
    cfg["data"]["val"].update(ann_file=os.path.join(wd, "test.json"),
                              img_prefix=os.path.join(wd, "val_split",
                                                      "images"))
    model, _ = apis.init_detector(
        cfg, state_dict=perturbed_weights(np.random.default_rng(SEED + 5),
                                          EVAL_CONFIG, EVAL_BIAS),
        compute_dtype=cfg["tpu"]["compute_dtype"], device=dev)
    settings = [(None, 0)] + [(c, s) for c in CORRUPTIONS
                              for s in ROBUST_SEVERITIES]
    maps, launches, secs = {}, {}, {}
    rects, same = [], None
    for corr, sev in settings:
        key = "clean" if corr is None else f"{corr}@{sev}"
        torch.cuda.synchronize()
        ops_mod.reset_launch_counts()
        t0 = time.perf_counter()
        maps[key], results, ds = tool.eval_setting(
            model, cfg, corr, sev, ROBUST_IMAGES, EVAL_BATCH)
        torch.cuda.synchronize()
        secs[key] = time.perf_counter() - t0
        launches[key] = ops_mod.launch_counts()
        say("robustness_setting", setting=key, mAP=maps[key],
            tiles=len(results), seconds=secs[key], launches=launches[key])
        if (corr, sev) == ROBUST_PLAIN:
            t0 = time.perf_counter()
            with plain_inference(rects):
                plain = apis.run_inference(
                    model, ds, cfg["test_cfg"],
                    canvas=tuple(cfg["tpu"]["canvas_buckets"][-1]),
                    batch_size=EVAL_BATCH, max_images=ROBUST_IMAGES,
                    num_fg=len(ds.CLASSES))
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
            same = same_results(results, plain) and len(results) == len(
                plain) == ROBUST_IMAGES
    per_setting = {k: round(v, 4) for k, v in maps.items() if k != "clean"}
    out = tool.summary(maps["clean"], per_setting, ROBUST_IMAGES)
    total = {k: sum(n[k] for n in launches.values())
             for k in ops_mod.KERNELS}
    pass_s = sum(secs.values())
    ok = (not differing and same is True
          and all(all(n[k] > 0 for k in SERVING_KERNELS)
                  for n in launches.values())
          and len(rects) == -(-ROBUST_IMAGES // EVAL_BATCH)
          and all(r["ok"] for r in rects)
          and bool(np.isfinite(list(maps.values())).all()))
    say("robustness", config=EVAL_CONFIG, batch=EVAL_BATCH,
        dtype=cfg["tpu"]["compute_dtype"], tiles=ROBUST_IMAGES,
        settings=len(settings), P=out["P"], mPC=out["mPC"], rPC=out["rPC"],
        per_setting=out["per_setting"],
        corruption_host_ms_per_tile=host_ms,
        tiles_per_s=len(settings) * ROBUST_IMAGES / pass_s, pass_s=pass_s,
        plain_setting="{}@{}".format(*ROBUST_PLAIN),
        plain_equal_det_for_det=same, plain_s=plain_s,
        min_area_rect_calls_checked=len(rects),
        digests_checked=len(CORRUPT_DIGESTS), digests_differing=differing,
        launches=total, phase_s=time.perf_counter() - t_phase, card=card,
        ok=ok)
    return ok, total


def last_json(text: str, prefix: str = "") -> dict | None:
    """The last line of text that starts with prefix and then holds a JSON
    object, parsed; None if there is none."""
    for line in reversed(text.strip().splitlines()):
        if line.startswith(prefix):
            with contextlib.suppress(ValueError):
                return json.loads(line[len(prefix):])
    return None


def phase_chunked(dev, ops_mod, card):
    """tools/synth_benchmark_torch.py --train on EVAL_CONFIG (R-18, bf16,
    512^2, batch 8; CHUNKED_TRAIN_SCENES scenes, a step an epoch) to epoch
    CHUNKED_EPOCHS, as subprocesses (os.execv replaces the process), run
    side by side: A with --rss_limit_gb 0.001 must re-execute once an
    epoch while epochs remain (two [chunked] lines), resume with the
    kernels found built, and exit 3; B runs uninterrupted
    (--rss_limit_gb 0).  A's weights at the last epoch must equal B's bit
    for bit (the step repeats bit for bit: utils/determinism.py).  Then
    --skip_train on A's work dir must score as a plain scoring of its
    checkpoint in this process (--state_dict of its weights, counted)."""
    from orientedreppoints_tpu_torch import apis
    from orientedreppoints_tpu_torch.host import load_config

    t_phase = time.perf_counter()
    cfg = load_config(EVAL_CONFIG)
    with tempfile.TemporaryDirectory() as wd:
        def tool_argv(run, *flags):
            return ["--config", EVAL_CONFIG, "--work_dir",
                    os.path.join(wd, run), "--train_scenes",
                    str(CHUNKED_TRAIN_SCENES), "--val_scenes",
                    str(CHUNKED_VAL_SCENES), "--device", str(dev), *flags]

        def tool_runs(*flag_sets):
            """The tool once per (work dir, flags...), all at once (their
            start-up is mostly the host's) -> ([CompletedProcess], the
            seconds until the last ended)."""
            t0 = time.perf_counter()
            procs = [subprocess.Popen(
                [sys.executable, "tools/synth_benchmark_torch.py",
                 *tool_argv(*flags)], stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True) for flags in flag_sets]
            done = []
            try:
                for flags, p in zip(flag_sets, procs):
                    out, err = p.communicate(timeout=CHUNKED_TIMEOUT)
                    done.append(subprocess.CompletedProcess(
                        flags, p.returncode, out, err))
            finally:
                for p in procs:
                    p.kill()  # a no-op on a process that has ended
            return done, time.perf_counter() - t0

        train = ["--train", "--stop_epoch", str(CHUNKED_EPOCHS)]
        (a, b), train_s = tool_runs(
            ("a", *train, "--rss_limit_gb", "0.001"),
            ("b", *train, "--rss_limit_gb", "0"))
        for name, res in (("a", a), ("b", b)):
            if res.returncode != 3:
                print(f"chunked {name}: rc {res.returncode}\n{res.stdout}\n"
                      f"{res.stderr}", file=sys.stderr)

        def weights(run):
            return torch.load(os.path.join(
                wd, run, "ckpts", f"epoch_{CHUNKED_EPOCHS}.pt"),
                map_location="cpu", weights_only=True)["model"]

        start = apis.init_detector(
            cfg, device="cpu", seed=SEED,
            compute_dtype=cfg["tpu"]["compute_dtype"])[0].state_dict()
        sa, sb = weights("a"), weights("b")
        ab, ab_equal = param_diffs(sa, sb, start), same_states(sa, sb)
        reexecs = sum(line.startswith("[chunked]")
                      for line in a.stdout.splitlines())
        resumed = [last_json(x.stdout, "training done: ") for x in (a, b)]

        (d,), skip_s = tool_runs(("a", "--skip_train", "--skip_gen"))
        skip = last_json(d.stdout)
        torch.save(sa, os.path.join(wd, "a.pt"))
        bench = load_tool("synth_benchmark_torch")
        text = io.StringIO()
        torch.cuda.synchronize()
        ops_mod.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(text):
            bench.main(tool_argv("a", "--skip_gen", "--state_dict",
                                 os.path.join(wd, "a.pt")))
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        launches = ops_mod.launch_counts()
        plain = last_json(text.getvalue())

    keys = ("mAP", "mAOE_deg", "per_class_ap", "per_class_aoe",
            "mAOE_mod90_deg")
    scores_equal = (skip is not None and plain is not None
                    and all(skip[k] == plain[k] for k in keys))
    ok = (a.returncode == b.returncode == 3
          and reexecs == CHUNKED_EPOCHS - 1
          and a.stdout.count("resumed at epoch") == CHUNKED_EPOCHS - 1
          and None not in resumed and resumed[0]["kernel_build_s"] == 0.0
          and resumed[0]["epochs"] == [CHUNKED_EPOCHS - 1, CHUNKED_EPOCHS]
          and all(resumed[0]["launches"][k] > 0 for k in TRAIN_KERNELS)
          and ab_equal
          and d.returncode in (0, 1) and scores_equal
          and all(launches[k] > 0 for k in SERVING_KERNELS))
    say("chunked", config=EVAL_CONFIG, train_scenes=CHUNKED_TRAIN_SCENES,
        epochs=CHUNKED_EPOCHS, rcs=[a.returncode, b.returncode,
                                    d.returncode],
        reexecs=reexecs, run_s=dict(a_b=train_s, skip_train=skip_s,
                                    plain_scoring=plain_s),
        resumed_train=resumed[0], uninterrupted_train=resumed[1],
        a_vs_b_bitwise=ab_equal, param_diffs=ab,
        skip_train_scores={k: skip and skip[k] for k in keys},
        plain_scores={k: plain and plain[k] for k in keys},
        scores_equal=scores_equal, launches=launches,
        phase_s=time.perf_counter() - t_phase, card=card, ok=ok)
    return ok, launches


# ---------------------------------------------------------------------------
# hbb_nms, export, profile, flops, sanity
# ---------------------------------------------------------------------------

HBB_N = 4096  # horizontal boxes of the hbb_nms phase
HBB_THR = 0.5
HBB_REPS = 5
EXPORT_BATCH = BATCH  # the slice phase's batch and canvas
EXPORT_REPS = 3
FLOPS_CASES = ((CONFIG, (1024, 1024)), (CONFIG, (1344, 1344)),
               (SWIN_CONFIG, (1024, 1024)), (SWIN_CONFIG, (1344, 1344)))
# the four serving kernels' __global__ functions (csrc/*.cu), looked for
# among the trace's CUDA events; each must be there.  The DCN's other
# kernels, which a serving batch does not launch, are deform_sample_kernel
# (the single table) and deform_sample{_pair,}_bwd_{tile,scalar} (the
# backward): no name is a substring of another's
TRACE_KERNELS = {"min_area_rect": "mar_kernel",
                 "quad_over_mask": "quad_over_kernel",
                 "nms_scan": "nms_scan_kernel",
                 "deform_sample_pair": "deform_sample_pair_kernel"}
TRACE_RANGES = ("orp_forward", "orp_decode")


def hbb_boxes(rng, n):
    """n seeded x1y1x2y2 boxes in clusters (so that many overlap), scores
    in steps of 1/64 (so that many tie), every tenth row invalid."""
    centres = rng.uniform(0, 1024, (n // 16, 2)).repeat(16, 0)[:n]
    xy = centres + rng.normal(0, 12, (n, 2))
    wh = rng.uniform(8, 96, (n, 2))
    boxes = np.concatenate([xy - wh / 2, xy + wh / 2], 1).astype(np.float32)
    scores = (rng.integers(1, 64, n) / 64.0).astype(np.float32)
    valid = np.arange(n) % 10 != 9
    return boxes, scores, valid


def host_ms(fn, reps: int) -> list:
    """Host-clock ms of each of reps calls, each ended by a synchronize."""
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def phase_hbb_nms(dev, rng, ops_mod):
    """nms_hbb over HBB_N seeded boxes with tied scores and invalid rows,
    counted: its scan on the card keeps exactly what the plain scan keeps
    on the card, and what the whole plain route keeps on the CPU;
    soft_nms_hbb, linear and gaussian, on the card as on the CPU (linear's
    scores exactly, gaussian's within 1e-6: the card's exp); the ms of
    each."""
    from orientedreppoints_tpu_torch.ops import nms

    boxes, scores, valid = hbb_boxes(rng, HBB_N)
    cpu = [torch.from_numpy(a) for a in (boxes, scores, valid)]
    b, s, v = (t.to(dev) for t in cpu)
    nms.nms_hbb(b, s, HBB_THR, v)  # warm-up
    torch.cuda.synchronize()
    ops_mod.reset_launch_counts()
    keep = nms.nms_hbb(b, s, HBB_THR, v)
    torch.cuda.synchronize()
    launches = ops_mod.launch_counts()
    with swapped([(nms, "greedy_scan", nms.greedy_scan_plain)]):
        keep_plain = nms.nms_hbb(b, s, HBB_THR, v)
    keep_cpu = nms.nms_hbb(*cpu[:2], HBB_THR, cpu[2])
    ms = host_ms(lambda: nms.nms_hbb(b, s, HBB_THR, v), HBB_REPS)
    ok = (launches["nms_scan"] == 1 and torch.equal(keep, keep_plain)
          and torch.equal(keep.cpu(), keep_cpu)
          and not bool(keep[~v].any()) and 0 < int(keep.sum()) < int(v.sum()))
    soft = {}
    for method, tol in (("linear", 0.0), ("gaussian", 1e-6)):
        got_s, got_k = nms.soft_nms_hbb(b, s, method=method, valid=v)
        want_s, want_k = nms.soft_nms_hbb(*cpu[:2], method=method,
                                          valid=cpu[2])
        err = float((got_s.cpu() - want_s).abs().max())
        same = torch.equal(got_k.cpu(), want_k) and err <= tol
        ok &= same
        soft[method] = dict(kept=int(got_k.sum()), max_err_score=err,
                            equal=same, ms=host_ms(lambda: nms.soft_nms_hbb(
                                b, s, method=method, valid=v), 1)[0])
    say("hbb_nms", n=HBB_N, valid=int(v.sum()), iou_thr=HBB_THR,
        kept=int(keep.sum()), same_as_plain_scan=torch.equal(keep,
                                                             keep_plain),
        same_as_cpu=torch.equal(keep.cpu(), keep_cpu),
        launches=launches, ms_median=statistics.median(ms), ms=ms,
        soft_nms_hbb=soft, ok=ok)
    return ok, launches


def canvases(pred, images):
    """The Predictor's (canvases, scale factors) of each batch of images."""
    return [pred.prepare(images[lo:lo + pred.batch_size])
            for lo in range(0, len(images), pred.batch_size)]


def phase_export(pred, images, ops_mod, card):
    """tools/export_model_torch.py's path on the slice phase's model (R-50
    demo, bf16) at its canvas and batch: export, save, load, then the slice
    phase's images through ExportedProgram.module(), counted; det for det
    equal to the eager module (decode_agreement), the four serving kernels
    launched by the exported program; export seconds, the file's MB and
    images/s of both."""
    tool = load_tool("export_model_torch")
    module = tool.inference_module(pred.model, pred.test_cfg)
    canvas = tuple(pred.cfg["tpu"]["canvas_buckets"][-1])
    t0 = time.perf_counter()
    program = tool.export(module, EXPORT_BATCH, canvas, pred.device)
    export_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as wd:
        path = os.path.join(wd, "r50_demo.pt2")
        t0 = time.perf_counter()
        size = tool.save(program, path)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = torch.export.load(path).module()
        load_s = time.perf_counter() - t0
    batches = [imgs for imgs, _ in canvases(pred, images)]
    with torch.no_grad():
        loaded(batches[0])  # warm-up
        torch.cuda.synchronize()
        ops_mod.reset_launch_counts()
        got = [loaded(x) for x in batches]
        torch.cuda.synchronize()
        launches = ops_mod.launch_counts()
        want = [module(x) for x in batches]
        agree = [decode_agreement(g, w) for g, w in zip(got, want)]
        ips = {}
        for name, fn in (("exported", loaded), ("eager", module)):
            ips[name] = [len(images) / (t / 1e3) for t in host_ms(
                lambda: [fn(x) for x in batches], EXPORT_REPS)]
    ok = (all(a["ok"] for a in agree)
          and all(launches[k] > 0 for k in SERVING_KERNELS))
    say("export", config=CONFIG, batch=EXPORT_BATCH, canvas=list(canvas),
        dtype=str(pred.model.dtype), export_s=export_s, save_s=save_s,
        load_s=load_s,
        file_mb=size / 1e6, dets=[int(g[2].sum()) for g in got],
        agreement=agree,
        launches=launches,
        images_per_s_exported_median=statistics.median(ips["exported"]),
        images_per_s_eager_median=statistics.median(ips["eager"]),
        images_per_s=ips, card=card, ok=ok)
    return ok, launches


def trace_reading(path: str) -> tuple[set, dict]:
    """(the TRACE_RANGES named in the trace, {kernel: CUDA kernel events
    named after its __global__ function})."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ranges = {e.get("name") for e in events} & set(TRACE_RANGES)
    kernels = {k: sum(1 for e in events if e.get("cat") == "kernel"
                      and fn in e.get("name", ""))
               for k, fn in TRACE_KERNELS.items()}
    return ranges, kernels


def phase_profile(pred, images):
    """utils/collect_env's report, then utils/profiling.trace around one
    slice batch with annotate ranges around the forward and the decode:
    the written trace must hold both ranges and a CUDA event of each
    serving kernel (launched through ctypes, on the library's own CUDA
    runtime); profile_time's line."""
    import logging

    from orientedreppoints_tpu_torch.models.detector import decode_detections
    from orientedreppoints_tpu_torch.utils import profiling
    from orientedreppoints_tpu_torch.utils.collect_env import collect_env

    say("collect_env", **{k: str(v) for k, v in collect_env().items()})
    tc = pred.test_cfg
    imgs, sf = canvases(pred, images[:pred.batch_size])[0]
    lines = []
    handler = logging.Handler()
    handler.emit = lambda record: lines.append(record.getMessage())
    logger = logging.getLogger("chip_smoke.profile")
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    with tempfile.TemporaryDirectory() as wd, torch.inference_mode():
        with profiling.trace(wd):
            with profiling.profile_time("slice_batch", logger=logger):
                with profiling.annotate(TRACE_RANGES[0]):
                    outs = pred.model(imgs)
                with profiling.annotate(TRACE_RANGES[1]):
                    dets = decode_detections(
                        outs, nms_pre=tc["nms_pre"],
                        score_thr=tc["score_thr"],
                        iou_thr=tc["nms"]["iou_thr"],
                        max_per_img=tc["max_per_img"],
                        pre_nms_cap=tc.get("pre_nms_cap", 4096),
                        scale_factor=sf[:, None, None])
            torch.cuda.synchronize()
        ranges, kernels = trace_reading(os.path.join(wd, "trace.json"))
    with torch.inference_mode(), profiling.profile_time(
            "slice_batch_synced", stream=dets, logger=logger):
        pred.model(imgs)
    logger.removeHandler(handler)
    ok = (ranges == set(TRACE_RANGES) and len(lines) == 2
          and all(n > 0 for n in kernels.values()))
    say("profile", ranges=sorted(ranges),
        kernel_events_in_trace=kernels, profile_time_lines=lines, ok=ok)
    return ok


def phase_flops(dev, card):
    """tools/get_flops_torch.py's count for the R-50 demo and Swin-T at
    1024^2 and 1344^2 on the card: params, forward GFLOPs, the counted
    forward's seconds; and parallel/train.step_cost_analysis of each
    one's train step (bf16, 1344^2, batch 2, a seeded batch of the train
    phase's kind): the step's GFLOPs, above the forward's, the model
    unchanged after it."""
    from orientedreppoints_tpu_torch.host import load_config
    from orientedreppoints_tpu_torch.parallel.train import (
        step_cost_analysis, to_device)

    tool = load_tool("get_flops_torch")
    ok, rows = True, []
    for config, shape in FLOPS_CASES:
        n_params, flops, secs = tool.count(config, shape, dev)
        ok &= n_params > 0 and flops > 0
        rows.append(dict(config=config, shape=list(shape),
                         params_m=n_params / 1e6, gflops=flops / 1e9,
                         counter_s=secs))
        torch.cuda.empty_cache()
    # the same model counts the same params at any shape, more FLOPs at more
    # pixels
    for a, b in zip(rows[0::2], rows[1::2]):
        ok &= a["params_m"] == b["params_m"] and b["gflops"] > a["gflops"]
    rng = np.random.default_rng(SEED + 12)
    steps = []
    for config, fwd in ((CONFIG, rows[1]), (SWIN_CONFIG, rows[3])):
        model, step = build_trainer(perturbed_weights(rng, config),
                                    "bfloat16", dev, config)
        batch = to_device(train_batch(rng, load_config(config)["tpu"][
            "max_gt"]), dev)
        before = model_state(model)
        t0 = time.perf_counter()
        flops = step_cost_analysis(step, batch)
        secs = time.perf_counter() - t0
        same = same_states(before, model_state(model))
        ok &= flops > fwd["gflops"] * 1e9 * TRAIN_BATCH and same
        steps.append(dict(config=config, batch=TRAIN_BATCH,
                          canvas=TRAIN_CANVAS, step_gflops=flops / 1e9,
                          forward_gflops_batch=fwd["gflops"] * TRAIN_BATCH,
                          model_unchanged=same, counter_s=secs))
        del model, step, batch, before
        torch.cuda.empty_cache()
    say("flops", cases=rows, steps=steps, card=card, ok=ok)
    return ok


def phase_sanity(dev, ops_mod, card):
    """tools/sanity_overfit_torch.py --backbone r18 at its defaults (300
    steps, 256^2, batch 4) on the card, counted: SANITY PASS; the first
    and final loss, recall@0.5 and seconds."""
    tool = load_tool("sanity_overfit_torch")
    lines = []
    ops_mod.reset_launch_counts()
    t0 = time.perf_counter()
    res = tool.overfit(backbone="r18", device=dev, log=lines.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops_mod.launch_counts()
    ok = bool(res.pop("ok")) and "SANITY PASS" in lines and all(
        launches[k] > 0 for k in TRAIN_KERNELS + SERVING_KERNELS)
    say("sanity", **res, wall_s=wall, lines=lines, launches=launches,
        card=card, ok=ok)
    return ok, launches


def main() -> int:
    if sys.argv[1:2] == ["--ddp_rank"]:
        return ddp_rank(sys.argv[2])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    os.chdir(os.path.dirname(os.path.abspath(__file__)))
    from orientedreppoints_tpu_torch import ops as ops_mod
    from orientedreppoints_tpu_torch.ops import _ext

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    from orientedreppoints_tpu_torch.devkit import native

    t0 = time.perf_counter()
    _ext.lib()
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    native.lib()
    say("device", name=torch.cuda.get_device_name(0), card=card,
        torch=torch.__version__, cuda=torch.version.cuda,
        build_s=_ext.build_seconds, load_s=load_s,
        host_lib_build_s=native.build_seconds,
        host_lib_load_s=time.perf_counter() - t0)

    torch.manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    rng_train = np.random.default_rng(SEED + 1)
    rng_quad = np.random.default_rng(SEED + 2)
    rng_host = np.random.default_rng(SEED + 3)
    rng_swin = np.random.default_rng(SEED + 4)
    rng_hrnet = np.random.default_rng(SEED + 5)
    rng_ssd = np.random.default_rng(SEED + 6)
    rng_resnext = np.random.default_rng(SEED + 7)
    rng_r101 = np.random.default_rng(SEED + 10)
    kernels = phase_kernels(dev, rng)
    train_res = phase_train_kernels(dev, rng_train)
    kernels["min_area_rect"]["ok"] &= train_res.pop(
        "min_area_rect_train")["ok"]
    kernels.update(train_res)
    ok_dcn_single, launches_dcn_single = phase_dcn_single(dev, ops_mod, card)
    quad_res, ok_entries = phase_quad_kernels(dev, rng_quad)
    kernels.update(quad_res)
    ok_host = phase_host(dev, rng_host)
    ok_hbb, launches_hbb = phase_hbb_nms(dev, np.random.default_rng(SEED + 9),
                                         ops_mod)
    ok_slice, launches, pred, outs = phase_slice(dev, rng, ops_mod, card)
    ok_decode = phase_decode(pred, outs)
    del outs
    ok_export, launches_export = phase_export(pred, pred.images, ops_mod,
                                              card)
    ok_profile = phase_profile(pred, pred.images)
    torch.cuda.empty_cache()
    ok_shard, launches_shard = phase_shard_infer(
        dev, np.random.default_rng(SEED + 8), ops_mod, card,
        pred.model.state_dict())
    torch.cuda.empty_cache()
    dataset = normalized_images(pred.cfg, rng, TTA_IMAGES, TTA_SIZE)
    ok_tta, launches_tta = phase_tta(pred.model, pred.cfg, pred.test_cfg,
                                     dataset, ops_mod, card)
    ok_tta_check, merges = phase_tta_check(pred.model, pred.cfg,
                                           pred.test_cfg, dataset)
    ok_iou, launches_iou = phase_iou_path(merges, ops_mod, pred.test_cfg)
    del pred, merges
    torch.cuda.empty_cache()
    ok_swin, launches_swin, pred, outs = phase_slice(
        dev, rng_swin, ops_mod, card, SWIN_CONFIG, "swin")
    ok_swin_decode = phase_decode(pred, outs, "swin_decode")
    del pred, outs
    torch.cuda.empty_cache()
    # HRNet, SSD-VGG, ResNeXt and R-101 serving
    ok_more, launches_more = [], []
    serving = (("hrnet", HRNET_CONFIG, rng_hrnet),
               ("ssd_vgg", SSD_VGG_CONFIG, rng_ssd),
               ("resnext", resnext_config(), rng_resnext),
               ("r101", R101_CONFIG, rng_r101))
    for name, config, rng_bb in serving:
        ok_bb, launches_bb, pred, outs = phase_slice(dev, rng_bb, ops_mod,
                                                     card, config, name)
        ok_more += [ok_bb, phase_decode(pred, outs, f"{name}_decode"),
                    phase_dcn(pred, rng_bb, f"{name}_dcn")]
        launches_more.append(launches_bb)
        del pred, outs
        torch.cuda.empty_cache()
    ok_more.append(phase_weights(dev, rng_resnext, card))
    torch.cuda.empty_cache()
    ok_flops = phase_flops(dev, card)
    ok_sanity, launches_sanity = phase_sanity(dev, ops_mod, card)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as eval_wd:
        ok_eval, launches_eval = phase_eval(dev, ops_mod, card, eval_wd)
        torch.cuda.empty_cache()
        ok_robust, launches_robust = phase_robustness(dev, ops_mod, card,
                                                      eval_wd)
        torch.cuda.empty_cache()
        ok_visual, launches_visual = phase_visual(dev, ops_mod, card,
                                                  eval_wd)
    torch.cuda.empty_cache()
    ok_hard, launches_hard, launches_hard_tta = phase_hard_eval(dev, ops_mod,
                                                                card)
    torch.cuda.empty_cache()

    from orientedreppoints_tpu_torch.host import load_config
    from orientedreppoints_tpu_torch.parallel.train import to_device

    sd = perturbed_weights(rng_train)
    max_gt = load_config(CONFIG)["tpu"]["max_gt"]
    batch = to_device(train_batch(rng_train, max_gt), dev)
    ok_train, launches_train = phase_train(dev, ops_mod, card, sd, batch,
                                           repeat=True)
    torch.cuda.empty_cache()
    ok_check = phase_train_check(dev, ops_mod, sd, batch)
    torch.cuda.empty_cache()
    ok_ddp, launches_ddp = phase_ddp(dev, ops_mod, card, sd, batch)
    torch.cuda.empty_cache()
    sd = perturbed_weights(rng_swin, SWIN_CONFIG)
    ok_swin_train, launches_swin_train = phase_train(
        dev, ops_mod, card, sd, batch, SWIN_CONFIG, "swin_train",
        repeat=True)
    torch.cuda.empty_cache()
    ok_swin_check = phase_train_check(dev, ops_mod, sd, batch, SWIN_CONFIG,
                                      "swin_train_check")
    torch.cuda.empty_cache()
    for name, config, rng_bb in (("hrnet", HRNET_CONFIG, rng_hrnet),
                                 ("ssd_vgg", SSD_VGG_CONFIG, rng_ssd),
                                 ("r101", R101_CONFIG, rng_r101)):
        sd = perturbed_weights(rng_bb, config)
        ok_bb, launches_bb = phase_train(dev, ops_mod, card, sd, batch,
                                         config, f"{name}_train")
        torch.cuda.empty_cache()
        ok_more += [ok_bb, phase_train_check(
            dev, ops_mod, sd, batch, config, f"{name}_train_check")]
        launches_more.append(launches_bb)
        torch.cuda.empty_cache()
    del batch, sd
    torch.cuda.empty_cache()
    ok_synth, launches_synth = phase_synth_train(dev, ops_mod, card)
    torch.cuda.empty_cache()
    ok_hard_aug, launches_hard_aug = phase_hard_aug_train(dev, ops_mod, card)
    torch.cuda.empty_cache()
    ok_configs, launches_configs = phase_configs(dev, ops_mod, card)
    torch.cuda.empty_cache()
    ok_dota, launches_dota, launches_dota_train = phase_dota_input(
        dev, ops_mod, card)
    torch.cuda.empty_cache()
    ok_chunked, launches_chunked = phase_chunked(dev, ops_mod, card)

    # launches: each kernel's count over the counted runs of the paths
    # that run it (serving, training, TTA, the IoU path, eval, Swin,
    # HRNet, SSD-VGG, ResNeXt and R-101 serving, Swin, HRNet, SSD-VGG and
    # R-101 training, the DOTA input's serving and training, the
    # robustness settings, the chunked phase's scoring, nms_hbb's scan,
    # the exported program, the sanity run, show_points_and_boxes, the
    # single DCNv1's entry, the configs phase's steps and eval passes);
    # the single-image over-mask is the TTA run's over-mask count
    runs = (launches, launches_train, launches_tta, launches_iou,
            launches_eval, launches_hard, launches_hard_tta, launches_synth,
            launches_hard_aug, launches_swin, launches_swin_train,
            launches_dota, launches_dota_train, launches_shard, launches_ddp,
            launches_robust, launches_chunked, launches_hbb, launches_export,
            launches_sanity, launches_visual, launches_dcn_single,
            *launches_configs, *launches_more)
    single = (launches_tta, launches_hard_tta)  # the single-image entry
    counts = {name: sum(r[name] for r in runs) for name in ops_mod.KERNELS}
    counts["quad_over_mask"] = sum(
        r["quad_over_mask"] for r in runs
        if not any(r is x for x in single + (launches_iou,)))
    counts["quad_over_mask_single"] = sum(r["quad_over_mask"]
                                          for r in single)
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    say("r101_vs_r50", card=card, **{
        phase: SUMMARY[phase] for phase in ("slice", "r101", "train",
                                            "r101_train")})
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=SOURCES[name][0],
             replaces=SOURCES[name][1], launches=counts[name],
             **{k: r[k] for k in keys})
        for name, r in kernels.items()]}))
    print(card)
    if not (all(r["ok"] for r in kernels.values()) and ok_entries
            and ok_host and ok_slice and ok_decode and ok_tta and ok_tta_check
            and ok_iou and ok_eval and ok_hard and ok_train and ok_check
            and ok_synth and ok_hard_aug and ok_dota and ok_robust
            and ok_chunked and ok_hbb and ok_export and ok_profile
            and ok_flops and ok_sanity and ok_visual
            and ok_swin and ok_swin_decode and ok_swin_train
            and ok_swin_check and ok_shard and ok_ddp and all(ok_more)
            and ok_dcn_single and ok_configs):
        print("chip_smoke: a phase failed", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
