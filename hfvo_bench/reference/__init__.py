"""The plain reference of the benchmark's correctness check.

Plain PyTorch and NumPy, written from the published definitions (FAST-9/16,
the antialiased bilinear pyramid of `jax.image.resize`, the Sobel operator,
the tiled Hough vote, the stereo reprojection and point-to-line costs of
ORB-SLAM2's local BA, rigid alignment). It imports nothing of the program
(`hfvo_tpu_torch`), of the JAX package or of JAX, and takes nothing the
program made except the outputs it judges and, where it follows the
program stage by stage, that stage's input (see PERF.md).

Every function takes `tf32`: with it, the inputs and the result are rounded
to TF32 (10-bit mantissa), the precision a float32 matmul has with TF32 on.
That is the control, the reference one precision below the float32 that
the configuration states, which the comparison has to reject.
"""
import torch


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest-even at 10 mantissa bits (TF32), kept as
    float32; other dtypes are rounded through float32."""
    dt = x.dtype
    b = x.to(torch.float32).contiguous().view(torch.int32)
    lsb = (b >> 13) & 1
    b = (b + 0x0FFF + lsb) & ~0x1FFF
    return b.view(torch.float32).to(dt)


def rounder(tf32: bool):
    return to_tf32 if tf32 else (lambda x: x)
