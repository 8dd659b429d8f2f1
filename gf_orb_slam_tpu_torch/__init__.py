"""gf_orb_slam_tpu_torch — the PyTorch / CUDA port of gf_orb_slam_tpu.

The whole SLAM system — two-view initialization, per-frame tracking (ORB
extraction → motion-model tracking → Good-Feature selection in every mode →
local-map tracking), keyframe insertion with local mapping, place
recognition (BoW retrieval, relocalization, Sim(3) loop closing), the
system's state machine with its loop-recall instrumentation, distributed
global bundle adjustment, dataset, snapshot and vocabulary I/O, the viz
exports, the bench, the GF-budget sweep and the entry point — as plain
functions on torch tensors, with the
Hamming distance matrix as a hand-written CUDA kernel for Hopper
(kernels/hamming.py, csrc/hamming.cu). The JAX package is the reference each
module is tested against; this package never imports it.

Layout mirrors the reference:
  geometry/   quaternions, SE(3), Sim(3), pinhole camera, PWLS state, small linalg
  ops/        pyramid, FAST, ORB (gather and patch-matmul paths), BoxLOG, Hamming matching
  kernels/    CUDA kernel wrappers and their nvcc build (sources in csrc/)
  gf/         measurement Jacobians, Max-logDet selections, active matching
  solvers/    pose-only LM, two-view initializer, Schur bundle adjustment,
              PnP, Sim(3), pose graph
  mapping/    MapState and its functional updates, keyframe operations, FrameData
  retrieval/  BoW vocabulary (and its files), keyframe database
  loop/       loop detection, verification and correction
  pipeline/   track view, per-frame tracking, local mapping, SlamSystem
  parallel/   keyframe-sharded global BA on torch.distributed, process groups
  io_utils/   datasets, images, settings, prefetch, map snapshots, the
              synthetic scenes, evaluation, timing, the stage probe, viz,
              loop-recall evaluation
  run_slam    the command line (python -m gf_orb_slam_tpu_torch.run_slam)
  bench       the one-line throughput bench (python -m gf_orb_slam_tpu_torch.bench)
  batch_sweep the GF-budget sweep (python -m gf_orb_slam_tpu_torch.batch_sweep)
  entry       entry() → the GF tracking step and its inputs; dryrun_multichip

Descriptors are (·, 8) int32 bit views of the reference's uint32 words.
"""

__version__ = "0.1.0"

import torch as _torch

# Full-f32 matmuls and convolutions: the estimation stack (pose LM normal
# equations, GF information matrices) loses accuracy at reduced precision,
# as the reference documents for bf16 Hessians (gf_orb_slam_tpu/__init__.py).
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
