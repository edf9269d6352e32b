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
//
// Exact bins with no division. The host's table (ops/lines.py::kernel_table)
// holds the cosines and sines of the 36 centres, which the plain version
// (ops/lines.py::hough_vote_reference) reads too, and the theta edges:
// edge k is the least float32 whose plain-version theta bin is >= k (-inf
// and +inf at k = 0 and 36), found by bisection over float32 order; the
// plain bin is monotone in the angle, since each of its steps (divide,
// multiply, truncate) is. The kernel guesses tb = int(ang * (36 / pi)),
// which is never more than one bin off, and corrects it by one comparison
// on each side against the edges. rho's bin is int(rho * (24 / diag) + 24):
// its inputs are integers 0-63 and one of 36 table rows, and on all 147,456
// such triples it equals the plain version's (tests/test_torch_hough.py).
// The nearest rho lies 6 ulps from a bin edge, so rho and the bin are
// computed with round-to-nearest intrinsics, which nvcc does not contract
// into an FMA.
//
// What bounds it on Hopper: it reads 8 B a pixel (mag and angle) over the
// tiled region and writes 36 x 48 x 4 B a tile, 2.8 MB at 480x640 (70
// tiles), 22 MB for a stack of 8: 0.8 and 6.6 us at 3.35 TB/s. The work is
// ~10 operations a pixel and ~60 a voting pixel (7.5 % of a rendered
// frame's pixels vote): well under the bytes. So the bound is bytes and,
// at one launch a frame, launch latency. What keeps the kernel from them
// is latency, above all in the votes: a shared-memory float atomic is a
// compare-and-swap loop on the card (ATOMS.CAST.SPIN in the SASS), so
// votes to one bin serialize, and the pixels of one edge mostly share
// their bins. The design:
// - One thread-block cluster of CLUSTER = 2 blocks of 256 threads a tile,
//   each block taking 32 of its rows and voting into its own 6,912 B
//   shared accumulator. After a cluster barrier, block r sums its half of
//   the 1,728 bins over the two accumulators through distributed shared
//   memory, in rank order, and writes it once, as float4, coalesced; a
//   second cluster barrier keeps each block's shared memory alive until
//   the other has read it. Traffic stays at one read of each input and one
//   write of the output. K3 is 140 blocks for the 132 SMs, where one
//   1,024-thread block a tile was 70; K3b at S = 8 is 1,120, of which the
//   card holds 1,056 at once.
// - Each thread issues all of its loads first; neighbouring threads read
//   neighbouring pixels of a tile row.
// - Each warp lists its voting pixels in shared memory with their theta
//   bins, in row order, and votes from the list 32 at a time, so no lane
//   idles. Neighbouring list entries are mostly pixels of one edge: each
//   run of equal bins on neighbouring lanes is summed with shuffles and
//   added by one atomic.
// hough_ablation.py times each step against the kernel before this design
// (one 1,024-thread block a tile, votes in place, IEEE divisions).
// Float atomics make the sums' order vary from run to run, so values agree
// with the plain version to float32 rounding, not bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int TILE = 64;
constexpr int N_THETA = 36;
constexpr int N_RHO = 48;
constexpr int BINS = N_THETA * N_RHO;  // 1,728
constexpr int CLUSTER = 2;             // blocks a tile
constexpr int THREADS = 256;
constexpr int ROWS = TILE / CLUSTER;                   // tile rows a block
constexpr int PIXELS = ROWS * TILE;                    // a block's pixels
constexpr int PX_PER_THREAD = PIXELS / THREADS;        // 8 at CLUSTER = 2
constexpr int SHARE4 = BINS / 4 / CLUSTER;             // float4s a block sums
constexpr unsigned FULL_WARP = 0xffffffffu;
constexpr float THETA_SCALE = static_cast<float>(36.0 / 3.14159265358979323846);
constexpr float RHO_SCALE = static_cast<float>(24.0 / 90.50966799187808);  // 24 / (64 sqrt 2)
static_assert(TILE % CLUSTER == 0 && PIXELS % THREADS == 0 && THREADS % TILE == 0, "tile split");
static_assert(BINS % (4 * CLUSTER) == 0, "bins split in float4s");

// The plain version's theta bin of angle a, exactly: the guess is at most
// one bin off, and edge[tb] = (least angle of bin tb, least of bin tb + 1).
// The last min keeps a = +inf (an angle the plain version never bins) in
// the accumulator.
__device__ __forceinline__ int theta_bin(float a, const float2* edge) {
  int tb = static_cast<int>(__fmul_rn(a, THETA_SCALE));
  tb = min(max(tb, 0), N_THETA - 1);
  const float2 e = edge[tb];
  return min(tb - (a < e.x) + (a >= e.y), N_THETA - 1);
}

// The plain version's rho bin, exactly, for rho = x cos + y sin at integer
// x, y in 0..63 and a table row (no FMA: intrinsics round each step).
__device__ __forceinline__ int rho_bin(float rho) {
  const int rb = static_cast<int>(__fadd_rn(__fmul_rn(rho, RHO_SCALE), 24.0f));
  return min(max(rb, 0), N_RHO - 1);
}

// Grid: (tiles_x * CLUSTER, tiles_y, S); the CLUSTER consecutive blocks of
// a cluster share one tile.
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
hough_vote_kernel(const float* __restrict__ mag, const float* __restrict__ ang,
                  const float* __restrict__ table, float* __restrict__ out,
                  int h, int w, float mag_th) {
  __shared__ float4 acc4[BINS / 4];
  __shared__ float2 cs[N_THETA];    // (cos, sin) of each row's centre
  __shared__ float2 edge[N_THETA];  // (edge k, edge k + 1)
  __shared__ float vote_m[PIXELS];  // each warp's voting pixels: magnitude,
  __shared__ int vote_c[PIXELS];    // and theta bin << 12 | place in the tile (y * 64 + x)
  float* acc = reinterpret_cast<float*>(acc4);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int tiles_x = gridDim.x / CLUSTER;
  const int tx = blockIdx.x / CLUSTER;

  // Every load is issued before anything waits on one, so their latencies
  // overlap; neighbouring threads read neighbouring pixels of a tile row.
  float tab[4];
  if (tid < N_THETA) {
    tab[0] = table[tid];
    tab[1] = table[N_THETA + tid];
    tab[2] = table[2 * N_THETA + tid];
    tab[3] = table[2 * N_THETA + tid + 1];
  }
  const size_t plane = static_cast<size_t>(blockIdx.z) * h * w;
  const int col = tid % TILE;
  const int row0 = rank * ROWS + tid / TILE;  // in the tile
  const size_t at = plane + static_cast<size_t>(blockIdx.y * TILE + row0) * w + tx * TILE + col;
  float mv[PX_PER_THREAD], av[PX_PER_THREAD];
#pragma unroll
  for (int i = 0; i < PX_PER_THREAD; ++i) {
    const size_t off = at + static_cast<size_t>(i) * (THREADS / TILE) * w;
    mv[i] = mag[off];
    av[i] = ang[off];
  }
  for (int i = tid; i < BINS / 4; i += THREADS) acc4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (tid < N_THETA) {
    cs[tid] = make_float2(tab[0], tab[1]);
    edge[tid] = make_float2(tab[2], tab[3]);
  }
  __syncthreads();

  // Each warp lists its voting pixels (mag > mag_th, ~8 % of a rendered
  // frame's) with their theta bins, row by row, left to right, and then
  // votes from its list with every lane busy. A warp waits for no other:
  // one votes while another's loads are still in flight.
  const int warp = tid / 32;
  float* const list_m = vote_m + warp * 32 * PX_PER_THREAD;
  int* const list_c = vote_c + warp * 32 * PX_PER_THREAD;
  const unsigned below = (1u << lane) - 1u;
  int n = 0;
#pragma unroll
  for (int i = 0; i < PX_PER_THREAD; ++i) {
    const unsigned ballot = __ballot_sync(FULL_WARP, mv[i] > mag_th);
    if (ballot & (1u << lane)) {
      const int e = n + __popc(ballot & below);
      list_m[e] = mv[i];
      list_c[e] = theta_bin(av[i], edge) << 12 | ((row0 + i * (THREADS / TILE)) * TILE + col);
    }
    n += __popc(ballot);
  }
  __syncwarp();

  // Pixels of one edge mostly vote into one bin, and a shared-memory float
  // atomic is a compare-and-swap loop, so votes to one bin serialize: each
  // run of equal bins on neighbouring lanes is summed first, with
  // shuffles, and its last lane adds the sum.
  for (int base = 0; base < n; base += 32) {
    const bool on = base + lane < n;
    const float m = on ? list_m[base + lane] : 0.0f;
    const int code = on ? list_c[base + lane] : 0;
    const int tb = code >> 12;
    const float fx = static_cast<float>(code % TILE);
    const float fy = static_cast<float>((code >> 6) % TILE);
    int bin[3];
    float v[3];
    bool tail[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int t = k == 0 ? tb : (k == 1 ? (tb == 0 ? N_THETA - 1 : tb - 1)
                                          : (tb == N_THETA - 1 ? 0 : tb + 1));
      const float2 c = cs[t];
      const float rho = __fadd_rn(__fmul_rn(fx, c.x), __fmul_rn(fy, c.y));
      bin[k] = on ? t * N_RHO + rho_bin(rho) : -1 - lane;
      v[k] = k == 0 ? m : __fmul_rn(m, 0.5f);
      const int prev = __shfl_up_sync(FULL_WARP, bin[k], 1);
      const unsigned heads = __ballot_sync(FULL_WARP, lane == 0 || prev != bin[k]);
      const int start = 31 - __clz(heads & (FULL_WARP >> (31 - lane)));  // this run's first lane
#pragma unroll
      for (int d = 1; d < 32; d *= 2) {
        const float u = __shfl_up_sync(FULL_WARP, v[k], d);
        if (lane - d >= start) v[k] += u;
      }
      tail[k] = on && (lane == 31 || (heads >> (lane + 1)) & 1u);
    }
    // The three votes' sums are independent, so their shuffles overlap; the
    // atomics come after.
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if (tail[k]) atomicAdd(&acc[bin[k]], v[k]);
    }
  }

  // Block `rank` sums its share of the bins over the cluster's
  // accumulators, in rank order, and writes it once.
  cluster.sync();
  const int64_t tile = (static_cast<int64_t>(blockIdx.z) * gridDim.y + blockIdx.y) * tiles_x + tx;
  float4* dst = reinterpret_cast<float4*>(out + tile * BINS) + rank * SHARE4;
  for (int i = tid; i < SHARE4; i += THREADS) {
    const int j = rank * SHARE4 + i;
    float4 v = cluster.map_shared_rank(&acc4[0], 0)[j];
#pragma unroll
    for (int q = 1; q < CLUSTER; ++q) {
      const float4 u = cluster.map_shared_rank(&acc4[0], q)[j];
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    dst[i] = v;
  }
  cluster.sync();
}

}  // namespace

extern "C" {

// Launches K3 (s = 1) or K3b (s > 1) on `stream` over the (h / 64) x
// (w / 64) whole tiles of each of s contiguous (h, w) images, one cluster
// of CLUSTER blocks a tile; `out` holds s * (h / 64) * (w / 64) * 36 * 48
// floats (16-byte aligned) and `table` the 36 cosines, the 36 sines and the
// 37 theta edges. Returns cudaGetLastError().
int hfvo_hough_vote(const float* mag, const float* ang, const float* table, float* out,
                    int s, int h, int w, float mag_th, void* stream) {
  const dim3 grid((w / TILE) * CLUSTER, h / TILE, s);
  hough_vote_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      mag, ang, table, out, h, w, mag_th);
  return static_cast<int>(cudaGetLastError());
}

// The launch shape of hfvo_hough_vote for s (h, w) images: shape[0..5] =
// cluster size, threads a block, grid x, y, z, and the most clusters the
// card holds at once. Returns a cudaError_t.
int hfvo_hough_launch_shape(int s, int h, int w, int* shape) {
  const dim3 grid((w / TILE) * CLUSTER, h / TILE, s);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS, 1, 1);
  int clusters = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(&clusters, hough_vote_kernel, &cfg);
  shape[0] = CLUSTER;
  shape[1] = THREADS;
  shape[2] = static_cast<int>(grid.x);
  shape[3] = static_cast<int>(grid.y);
  shape[4] = static_cast<int>(grid.z);
  shape[5] = clusters;
  return static_cast<int>(err);
}

const char* hfvo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
