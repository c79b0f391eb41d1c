"""Oriented RepPoints in PyTorch, with hand-written CUDA kernels for Hopper.

The PyTorch counterpart of the JAX package ``orientedreppoints_tpu``; module
names mirror it so each function has an obvious counterpart:

  host.py      config loader, resize / normalize on tensors, rbbox2result
  models/      ResNet, FPN, OrientedRepPointsHead, detector + decode
  core/        point grids, offset decoding, polygon -> rbox, and the
               training loss: assigners, targets, APAA, losses,
               compute_losses
  data/        synthetic DOTA scenes (cv2's fills in numpy), PNG / BMP
               files (image_io), DotaDataset and its pipelines, cv2's
               warps and colour conversions (warp, color), the image
               corruptions of the robustness benchmark (corruptions, with
               cv2's filter2D and area / nearest resizes in filter and
               libjpeg-turbo's lossy round trip in jpeg)
  devkit/      DOTA devkit in numpy: labelTxt, polygon IoU and NMS,
               ImgSplit at any rate, COCO-poly json, the DOTA and HRSC
               prep, Task1 / Task2 / mAOE / UCAS-AOD evaluators, soft
               polygon NMS, the merge (a spawn pool over the class
               files)
  ops/         geometry, min-area-rect and hulls, hull-gt IoU, quad IoU
               over-mask, rotated and horizontal NMS, deformable conv
               (forward and backward); each kernel beside its plain
               PyTorch version, the serving ones as torch.library ops
  parallel/    the SGD / AdamW training step, sharded inference and the
               data-parallel process group
  utils/       flax -> torch weight conversion, checkpoints and weight
               importers, the host-RSS re-exec of long runs (chunked),
               the environment report and profiling
  apis.py      init_detector, build_dataset, run_inference(_tta),
               evaluate_results, build_loss_config, build_img_norm
  serving.py   Predictor (one device)

Every kernel wrapper runs its plain PyTorch version for CPU tensors and its
CUDA kernel (built from ``csrc/`` at first use) for CUDA tensors.  Nothing
here imports JAX, flax, cv2, PIL or imageio.
"""

__version__ = "0.1.0"
