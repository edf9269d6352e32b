"""hfvo_tpu_torch — the PyTorch + CUDA port of `hfvo_tpu`.

The package mirrors `hfvo_tpu`'s module tree and names. It imports `torch`
and never `jax` or `hfvo_tpu`. Plain tensor code is PyTorch; each Pallas
kernel of the JAX package becomes a hand-written CUDA kernel under `csrc/`,
built at first use (see `ops/_kernels.py`). Every function that owns a kernel
keeps a plain PyTorch version beside it, which CPU tensors take.

Scope so far: points-only RGB-D tracking (ORB extraction, BoW words,
projection matching, pose LM and host keyframe bookkeeping), point + line
tracking (Hough line segments, 3D line fits, structural refinement, line
searches, flow-based line recovery, line and direction edges in the LM, map
lines) and the full default step (with planes and Manhattan axes: rotation
prior and axis anchors, plane segmentation and association, map planes,
coarse and fine Manhattan inits) through `VOSystem.track_rgbd`
(`config.points_only`, `config.points_and_lines`, `config.full_step`); the
keyframe path of the JAX package's default system (`tum3_config()` with
local BA: epipolar point and two-view line triangulation, Schur local BA);
relocalization (BoW candidates, 3D-3D and PnP RANSAC), loop closing (pose
graph, global BA) and the metric 3D point term, so that `VOSystem(
tum3_config())` with every default is the JAX package's default system;
and any tracking configuration for several sequences at once
(`BatchTracker`). The facade's options, the async paths and the
distributed solvers raise `NotImplementedError` naming their ROADMAP item.
"""

__version__ = "0.1.0"

import torch as _torch

# Full float32 everywhere (the policy of hfvo_tpu/__init__.py): VO geometry is
# chains of small matmuls on meter-scale coordinates, and reduced-precision
# matmul inputs drifted the tracker ~10 cm per frame. TF32 keeps ~3 decimal
# digits, so both TF32 switches are off and matmuls run at "highest".
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
