"""Oriented RepPoints in PyTorch, with hand-written CUDA kernels for Hopper.

The PyTorch counterpart of the JAX package ``orientedreppoints_tpu``; module
names mirror it so each function has an obvious counterpart:

  host.py      config loader, resize / normalize on tensors, rbbox2result
  models/      ResNet, FPN, OrientedRepPointsHead, detector + decode
  core/        point grids, offset decoding, and the training loss:
               assigners, targets, APAA, losses, compute_losses
  ops/         geometry, min-area-rect and hulls, hull-gt IoU, quad IoU
               over-mask, rotated NMS, deformable conv (forward and
               backward); each kernel beside its plain PyTorch version
  parallel/    the one-device SGD training step
  utils/       flax -> torch weight conversion
  apis.py      init_detector, build_loss_config, build_img_norm
  serving.py   Predictor (one device)

Every kernel wrapper runs its plain PyTorch version for CPU tensors and its
CUDA kernel (built from ``csrc/`` at first use) for CUDA tensors.  Nothing
here imports JAX, flax or cv2.
"""

__version__ = "0.1.0"
