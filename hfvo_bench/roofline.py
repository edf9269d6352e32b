"""The yardstick of the kernels' roofline shares: the published peaks of
one NVIDIA H100 SXM (NVIDIA's data sheet: 3.35 TB/s of HBM3, 67 TFLOP/s
float32 outside the tensor cores) and each kernel's bytes and operations
as its launch's shapes need them. `bound` is a frozen copy of
chip_smoke.py::bound at commit ccf1f66; the byte and operation counts are
those chip_smoke.py states for K1/K1b and K3/K3b."""
from __future__ import annotations

HBM_BYTES_PER_MS = 3.35e12 / 1e3
F32_OPS_PER_MS = 67e12 / 1e3

# Kernel name in the device trace -> per-layer metric.
FAST_KERNEL = "fast_levels_kernel"
HOUGH_KERNEL = "hough_vote_kernel"
TILE, N_THETA, N_RHO = 64, 36, 48


def bound(bytes_moved: float, operations: float):
    """(bound ms, bound_by): the least time the card could take."""
    b_ms, o_ms = bytes_moved / HBM_BYTES_PER_MS, operations / F32_OPS_PER_MS
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def fast_launch(level_shapes, n_thresholds: int = 2):
    """(bytes, operations) of one FAST launch over levels of the given
    shapes ((H, W) or (S, H, W)): each pixel read once and its score
    written once (8 B); per threshold 16 ring pixels x (2 compares, ~2
    adds)."""
    px = 0
    for s in level_shapes:
        n = 1
        for d in s:
            n *= d
        px += n
    return 8.0 * px, n_thresholds * 16 * 4.0 * px


def hough_launch(shape, n_voting_px: int):
    """(bytes, operations) of one Hough launch on a (H, W) or (S, H, W)
    image with `n_voting_px` pixels above the threshold inside whole tiles:
    magnitude and angle of the tiled region read once (8 B a pixel), the
    accumulators written once; ~3 operations a pixel for its theta bin and
    ~8 a vote (3 votes a voting pixel) for rho, its bin and the add."""
    s = shape[0] if len(shape) == 3 else 1
    h, w = shape[-2:]
    tiles = s * (h // TILE) * (w // TILE)
    tiled_px = tiles * TILE * TILE
    n_bins = tiles * N_THETA * N_RHO
    return 8.0 * tiled_px + 4.0 * n_bins, 3.0 * tiled_px + 8.0 * 3 * n_voting_px
