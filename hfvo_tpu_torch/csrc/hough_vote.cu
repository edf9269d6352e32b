// Kernels K3 and K3b: per-tile gradient-weighted Hough vote of the line
// detector, for one image (K3) or an (S, H, W) stack in one launch (K3b).
//
// Replaces hfvo_tpu/ops/pallas_hough.py::_kernel (entry hough_vote_pallas;
// K3b is its custom_vmap rule, pallas_hough.py:116-129, the same
// pl.pallas_call over a leading sequence axis),
// which runs the vote as per-tile bf16 one-hot matmuls. This kernel computes
// the float32 definition instead: the scan of hfvo_tpu/ops/lines.py:116-145,
// which is what the JAX package computes off the TPU. Per 64x64 tile
// (row-major tile order, ragged right and bottom edges dropped), each pixel
// with mag > mag_th adds
//   mag     at (tb,           rho_bin(tb))
//   mag / 2 at (tb - 1 mod 36, rho_bin(tb - 1)) and (tb + 1 mod 36, ...)
// with tb = clamp(int(ang / pi * 36), 0, 35), rho = xl cos(t) + yl sin(t)
// at the TARGET row's centre angle t, and
// rho_bin = clamp(int((rho / (64 sqrt 2) + 1) * 0.5 * 48), 0, 47).
// cos and sin of the 36 centres come from the host's float32 table, the one
// the plain version (ops/lines.py::hough_vote_reference) reads. The rho and
// bin arithmetic uses round-to-nearest intrinsics so that nvcc cannot
// contract x cos + y sin into an FMA: bin edges then fall where the plain
// version puts them.
//
// What bounds it on Hopper: it reads 8 B a pixel (mag and angle) over the
// tiled region and writes 36 x 48 x 4 B a tile, about 2.8 MB at 480x640
// (70 tiles): under 1 us at 3.35 TB/s. The work is ~30 operations and 3
// shared-memory atomics a voting pixel. So at the main path's one launch a
// frame the kernel is bound by launch latency, and then by latency: with
// one block a tile (70 blocks at 480x640, fewer than the 132 SMs) each SM
// runs one block, whose votes are short dependent chains (two IEEE
// divisions, table reads, a shared-memory atomic). So the block has 1,024
// threads (32 warps, 4 pixels a thread) to hide those latencies, and each
// thread issues its loads before its first vote. The traffic stays at one
// read of each input and one write of the output: the accumulator
// (6,912 B) lives in shared memory, so the votes never touch device
// memory, and the block writes it out once. Measured on the H100: 256
// threads took 27.7 us a frame, 1,024 take 17.6 us; adding a warp's
// same-bin votes in registers first (__match_any_sync) was slower
// (48.0 us), so the atomics' contention is not what binds. Splitting a
// tile over several blocks is later work. The batch is the grid's z
// dimension: image z is read at offset z*h*w and its T tiles written at
// offset z*T*36*48, so S = 1 is the single-image kernel; at S = 8 the
// 480x640 stack is 560 blocks for the card's 132 SMs, where one frame
// gave 70.
// Shared-memory float atomics make the sums' order vary from run to run,
// so values agree with the plain version to float32 rounding, not bit for
// bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;
constexpr int N_THETA = 36;
constexpr int N_RHO = 48;
constexpr int THREADS = 1024;
constexpr int PX_PER_THREAD = TILE * TILE / THREADS;  // 4
constexpr float PI_F = 3.14159265358979323846f;
constexpr float DIAG_F = 90.50966799187808f;  // 64 * sqrt(2), rounded to float32

__global__ void __launch_bounds__(THREADS)
hough_vote_kernel(const float* __restrict__ mag, const float* __restrict__ ang,
                  const float* __restrict__ table, float* __restrict__ out,
                  int h, int w, float mag_th) {
  __shared__ float acc[N_THETA * N_RHO];
  __shared__ float cos_t[N_THETA];
  __shared__ float sin_t[N_THETA];
  const int tid = threadIdx.x;
  for (int i = tid; i < N_THETA * N_RHO; i += THREADS) acc[i] = 0.0f;
  if (tid < N_THETA) {
    cos_t[tid] = table[tid];
    sin_t[tid] = table[N_THETA + tid];
  }
  __syncthreads();

  const size_t plane = static_cast<size_t>(blockIdx.z) * h * w;
  mag += plane;
  ang += plane;
  const int x0 = blockIdx.x * TILE;
  const int y0 = blockIdx.y * TILE;
  // All of a thread's loads are issued before any vote, so their latencies
  // overlap (a loop that loads, tests and votes pixel by pixel waits one
  // device-memory round trip per pixel). Neighbouring threads read
  // neighbouring pixels of one tile row.
  float mv[PX_PER_THREAD], av[PX_PER_THREAD];
#pragma unroll
  for (int i = 0; i < PX_PER_THREAD; ++i) {
    const int p = tid + i * THREADS;
    const int g = (y0 + p / TILE) * w + (x0 + p % TILE);
    mv[i] = mag[g];
    av[i] = ang[g];
  }
#pragma unroll
  for (int i = 0; i < PX_PER_THREAD; ++i) {
    const int p = tid + i * THREADS;
    const int yl = p / TILE, xl = p % TILE;
    const float m = mv[i];
    if (!(m > mag_th)) continue;
    const float a = av[i];
    int tb = static_cast<int>(__fmul_rn(__fdiv_rn(a, PI_F), static_cast<float>(N_THETA)));
    tb = min(max(tb, 0), N_THETA - 1);
    const float fx = static_cast<float>(xl), fy = static_cast<float>(yl);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int delta = k == 0 ? 0 : (k == 1 ? -1 : 1);
      const int t = (tb + delta + N_THETA) % N_THETA;
      const float rho = __fadd_rn(__fmul_rn(fx, cos_t[t]), __fmul_rn(fy, sin_t[t]));
      const float r = __fmul_rn(__fmul_rn(__fadd_rn(__fdiv_rn(rho, DIAG_F), 1.0f), 0.5f),
                                static_cast<float>(N_RHO));
      int rb = static_cast<int>(r);
      rb = min(max(rb, 0), N_RHO - 1);
      atomicAdd(&acc[t * N_RHO + rb], k == 0 ? m : __fmul_rn(m, 0.5f));
    }
  }
  __syncthreads();

  const int64_t tile = (static_cast<int64_t>(blockIdx.z) * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  float* dst = out + tile * (N_THETA * N_RHO);
  for (int i = tid; i < N_THETA * N_RHO; i += THREADS) dst[i] = acc[i];
}

}  // namespace

extern "C" {

// Launches K3 (s = 1) or K3b (s > 1) on `stream` over the (h / 64) x
// (w / 64) whole tiles of each of s contiguous (h, w) images; `out` holds
// s * (h / 64) * (w / 64) * 36 * 48 floats and `table` the 36 cosines then
// the 36 sines. Returns cudaGetLastError().
int hfvo_hough_vote(const float* mag, const float* ang, const float* table, float* out,
                    int s, int h, int w, float mag_th, void* stream) {
  const dim3 grid(w / TILE, h / TILE, s);
  hough_vote_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      mag, ang, table, out, h, w, mag_th);
  return static_cast<int>(cudaGetLastError());
}

const char* hfvo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
