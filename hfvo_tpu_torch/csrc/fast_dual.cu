// Kernels K1, K1b, K2 and K2b: the FAST-9/16 arc-strength score, at two
// thresholds combined (K1) or at one (K2), for one image or, with a batch
// count S > 1, for an (S, H, W) stack in one launch (K1b, K2b).
//
// Replaces hfvo_tpu/ops/pallas_fast.py::_kernel_dual (K1, via _dual_2d; K1b
// via _dual_batched) and ::_kernel (K2 via _score_2d, K2b via
// _score_batched); their shared tile body is _fast_score_tile, the arc test
// _contiguous_arc. Computes, per
// pixel, for each threshold th:
//   bright_k = ring_k > c + th,  dark_k = ring_k < c - th   (k = 0..15)
//   corner   = >= 9 circularly contiguous bright, or >= 9 contiguous dark
//   score    = corner ? max(sum_k bright_k (ring_k - c - th),
//                           sum_k dark_k  (c - th - ring_k)) : 0
// with the sums accumulated in ring order k = 0..15, and combines the two
// thresholds as where(s_high > 0, s_high + bonus, s_low), zero within
// 3 px of the border. Ring offsets are hfvo_tpu/ops/fast.py CIRCLE_OFFSETS.
//
// What bounds it on Hopper: per pixel it reads 4 B (plus a 3-px halo per
// tile) and writes 4 B, against ~150 integer and float operations, so at
// the pyramid's sizes (480x640 down to 134x179) it is bound by memory
// traffic and, for the small levels, by launch latency. The design keeps
// the traffic at one read and one write: both thresholds share one
// shared-memory tile load, the 16 ring reads come from shared memory, and
// the 16-bit bright/dark masks live in registers. Later work, not done
// here: batching the 8 levels into one launch, and TMA tile loads. The
// batch of S images is the grid's z dimension: image z is read at offset
// z*h*w and its score written at the same offset, so S = 1 is the
// single-image kernel and each image of a stack is scored exactly as
// alone. Tensor cores have nothing to do here: the score is compares, bit
// logic and adds, with no product to feed them.
//
// Threshold count is a template parameter: NTH = 2 is K1/K1b (dual),
// NTH = 1 the single-threshold score of pallas_fast.py::_kernel (K2/K2b),
// so the two cannot diverge. Both are bound below.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_X = 32;
constexpr int TILE_Y = 8;
constexpr int HALO = 3;
constexpr int SM_X = TILE_X + 2 * HALO;
constexpr int SM_Y = TILE_Y + 2 * HALO;

__constant__ int kRingDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int kRingDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};

// True where any 9-long circular run of set bits exists in the 16-bit mask:
// double the mask to 32 bits, then r &= r >> 1, >> 2, >> 4 (runs of 8) and
// one more >> 1 (runs of 9); bit k survives iff bits k..k+8 were all set.
__device__ __forceinline__ bool contiguous_arc9(uint32_t m) {
  uint32_t x = m | (m << 16);
  x &= x >> 1;
  x &= x >> 2;
  x &= x >> 4;
  x &= x >> 1;
  return (x & 0xFFFFu) != 0u;
}

__device__ __forceinline__ float score_at(const float (&ring)[16], float c, float th) {
  uint32_t bright = 0u, dark = 0u;
  float bright_s = 0.0f, dark_s = 0.0f;
  const float hi = c + th;
  const float lo = c - th;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const float r = ring[k];
    const bool b = r > hi;
    const bool d = r < lo;
    bright |= static_cast<uint32_t>(b) << k;
    dark |= static_cast<uint32_t>(d) << k;
    bright_s = bright_s + (b ? (r - c) - th : 0.0f);
    dark_s = dark_s + (d ? lo - r : 0.0f);
  }
  const bool corner = contiguous_arc9(bright) || contiguous_arc9(dark);
  return corner ? fmaxf(bright_s, dark_s) : 0.0f;
}

template <int NTH>
__global__ void __launch_bounds__(TILE_X * TILE_Y)
fast_score_kernel(const float* __restrict__ img, float* __restrict__ out,
                  int h, int w, float th_low, float th_high, float bonus) {
  __shared__ float tile[SM_Y][SM_X];
  const size_t plane = static_cast<size_t>(blockIdx.z) * h * w;
  img += plane;
  out += plane;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x0 = blockIdx.x * TILE_X - HALO;
  const int y0 = blockIdx.y * TILE_Y - HALO;
  // Cooperative tile + halo load; outside the image reads as 0 (those
  // values only reach pixels that the border mask zeroes).
  for (int i = ty * TILE_X + tx; i < SM_X * SM_Y; i += TILE_X * TILE_Y) {
    const int sy = i / SM_X, sx = i % SM_X;
    const int gy = y0 + sy, gx = x0 + sx;
    tile[sy][sx] = (gy >= 0 && gy < h && gx >= 0 && gx < w) ? img[gy * w + gx] : 0.0f;
  }
  __syncthreads();

  const int x = blockIdx.x * TILE_X + tx;
  const int y = blockIdx.y * TILE_Y + ty;
  if (x >= w || y >= h) return;  // ragged edge of the grid
  float res = 0.0f;
  if (y >= 3 && y < h - 3 && x >= 3 && x < w - 3) {
    const float c = tile[ty + HALO][tx + HALO];
    float ring[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) ring[k] = tile[ty + HALO + kRingDy[k]][tx + HALO + kRingDx[k]];
    if (NTH == 2) {
      const float s_low = score_at(ring, c, th_low);
      const float s_high = score_at(ring, c, th_high);
      res = s_high > 0.0f ? s_high + bonus : s_low;
    } else {
      res = score_at(ring, c, th_low);
    }
  }
  out[y * w + x] = res;
}

}  // namespace

extern "C" {

// Launch K1 (s = 1) or K1b (s > 1) on `stream` over s contiguous (h, w)
// images; returns cudaGetLastError() (0 on success).
int hfvo_fast_score_dual(const float* img, float* out, int s, int h, int w,
                         float th_low, float th_high, float bonus, void* stream) {
  const dim3 block(TILE_X, TILE_Y);
  const dim3 grid((w + TILE_X - 1) / TILE_X, (h + TILE_Y - 1) / TILE_Y, s);
  fast_score_kernel<2><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      img, out, h, w, th_low, th_high, bonus);
  return static_cast<int>(cudaGetLastError());
}

// Launch K2 (s = 1) or K2b (s > 1): the single-threshold score.
int hfvo_fast_score(const float* img, float* out, int s, int h, int w, float th,
                    void* stream) {
  const dim3 block(TILE_X, TILE_Y);
  const dim3 grid((w + TILE_X - 1) / TILE_X, (h + TILE_Y - 1) / TILE_Y, s);
  fast_score_kernel<1><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      img, out, h, w, th, 0.0f, 0.0f);
  return static_cast<int>(cudaGetLastError());
}

const char* hfvo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
