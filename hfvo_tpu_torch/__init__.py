"""hfvo_tpu_torch — the PyTorch + CUDA port of `hfvo_tpu`.

The package mirrors `hfvo_tpu`'s module tree and names. It imports `torch`
and never `jax` or `hfvo_tpu`. Plain tensor code is PyTorch; each Pallas
kernel of the JAX package becomes a hand-written CUDA kernel under `csrc/`,
built at first use (see `ops/_kernels.py`). Every function that owns a kernel
keeps a plain PyTorch version beside it, which CPU tensors take.

Scope: everything the JAX package does on one device. Points-only RGB-D
tracking (ORB extraction, BoW words, projection matching, pose LM and host
keyframe bookkeeping), point + line tracking (Hough line segments, 3D line
fits, structural refinement, line searches, flow-based line recovery, line
and direction edges in the LM, map lines) and the full default step (with
planes and Manhattan axes) through `VOSystem.track_rgbd`; the keyframe path
(epipolar point and two-view line triangulation, Schur local BA);
relocalization (BoW candidates, 3D-3D and PnP RANSAC), loop closing (pose
graph, global BA) and the metric 3D point term, so that `VOSystem()` with
every default is the JAX package's default system; any tracking
configuration for several sequences at once (`BatchTracker`); the
pipelined paths (`Tracker.track_rgbd_async`, `BatchTracker.
track_batch_async`); and the facade and IO: the CLIs (`cli`, `stream_cli`,
`eval_cli`), the TUM loaders (Python and the native C++ prefetcher),
settings YAML, checkpoints, the stream server, DBoW2 vocabularies, the
static mask, the viewers and the two-view initializer; and the distributed
layer (`parallel/`, `bow/sharded_db.py`) on `torch.distributed`: the
('seq', 'edge') mesh, the edge-sharded local BA, pose LM, pose graph and
global BA, the sharded BoW database, the batch's sequence axis over ranks
and the multi-process BA.
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
