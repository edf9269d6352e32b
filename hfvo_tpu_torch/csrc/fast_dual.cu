// Kernels K1, K1b, K2 and K2b: the FAST-9/16 arc-strength score, at two
// thresholds combined (K1) or at one (K2), over every level of an image
// pyramid in one launch: a table of up to 16 levels, each (H_l, W_l) or,
// with a batch count S > 1, an (S, H_l, W_l) stack (K1b, K2b).
//
// Replaces hfvo_tpu/ops/pallas_fast.py::_kernel_dual (K1 via _dual_2d, K1b
// via _dual_batched) and ::_kernel (K2 via _score_2d, K2b via
// _score_batched); their shared tile body is _fast_score_tile, the arc test
// _contiguous_arc. The TPU runs them once per level. Computes, per pixel,
// for each threshold th:
//   bright_k = ring_k > c + th,  dark_k = ring_k < c - th   (k = 0..15)
//   corner   = >= 9 circularly contiguous bright, or >= 9 contiguous dark
//   score    = corner ? max(sum_k bright_k ((ring_k - c) - th),
//                           sum_k dark_k  ((c - th) - ring_k)) : 0
// with the sums accumulated in ring order k = 0..15, c + th and c - th
// rounded before the compares, and no multiply anywhere (nothing can
// contract to an FMA), so the result is bit-equal to the plain version. It
// combines the two thresholds as where(s_high > 0, s_high + bonus, s_low),
// zero within 3 px of the border. Ring offsets are hfvo_tpu/ops/fast.py
// CIRCLE_OFFSETS.
//
// What binds it on Hopper: instructions and latency, not bytes. A pixel
// moves 8 B but costs some 300 instructions through the two full tests; a
// one-level 32x8 design (the first version of this source) reached 289 GB/s
// of the card's 3.35 TB/s at 480x640 x 8 and paid a ~6.6 us launch floor per
// level. The design against that (PERF.md has each step's measured share):
//   1. One launch per pyramid. The level table is a kernel parameter
//      (passed by value, no symbol copy); the grid is flat, the last level's
//      blocks first (a pyramid's small levels are dense in corners, so their
//      long blocks start early), and each block finds its level by the
//      table's first blocks, then its image and tile. 8 launches an
//      extraction become 1.
//   2. Coarsened threads. A block is 8 warps over a 32 x 64 tile (halo
//      over-fetch 1.30x instead of 2.1x); a warp's 32 lanes sit on 32
//      consecutive x (coalesced loads and stores) and each thread scores a
//      vertical strip of P = 8 pixels. A warp issues all its tile loads
//      before its first shared store, so ~18 loads a warp are in flight. Down
//      the strip, the pre-test's column (ring 0, center, ring 8) rolls in
//      registers: one new shared read a pixel, plus ring 4 and 12. The full
//      test, run on flagged rows only, reads its 16 ring values from shared
//      memory in a loop: a 7 x 7 register window with the full test inline
//      at each of the P steps (fast_ablation.py's window_7x7) took 64
//      registers and ran 1.4x slower.
//   3. An exact early exit. A 9-arc of the 16-ring always holds one of
//      ring positions {0, 8} and one of {4, 12}, so a pixel can be a corner
//      only where (r0 | r8) & (r4 | r12), bright or dark, holds at
//      min(th_low, th_high); a corner at the higher threshold is one at the
//      lower (c + th and c - th round monotonically). Where no lane of a
//      warp passes, the warp writes 0 for that pixel row and skips both full
//      tests (about two thirds of warp rows on rendered 640x480 pyramids).
//      The same test at max(th_low, th_high) skips that threshold's full
//      test where no lane of the row passes it (its score is 0 there).
//   4. Both thresholds in one pass over the 16 ring values: one unrolled
//      loop builds both thresholds' masks and sums, sharing r - c, with
//      predicated adds (bit-equal to adding 0.0f: neither sum is ever -0).
// Tensor cores have nothing to do here: the score is compares, bit logic and
// adds, with no product to feed them.
//
// Threshold count is a template parameter: NTH = 2 is K1/K1b (dual),
// NTH = 1 the single-threshold score of pallas_fast.py::_kernel (K2/K2b),
// so the two cannot diverge. One C entry point takes the table and NTH.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEVELS = 16;
constexpr int TILE_W = 32;   // one warp across
constexpr int WARPS = 8;     // warps a block, stacked vertically
constexpr int P = 8;         // pixel rows a thread scores
constexpr int TILE_H = WARPS * P;
constexpr int HALO = 3;
constexpr int SM_W = TILE_W + 2 * HALO;
constexpr int SM_H = TILE_H + 2 * HALO;
constexpr unsigned FULL_WARP = 0xFFFFFFFFu;

struct Level {
  const float* img;
  float* out;
  int h, w;
  int tiles_x;      // tiles across the level
  int tiles;        // tiles of one image of the level
  int first_block;  // the level's first block of the flat grid
};

struct LevelTable {
  Level lv[MAX_LEVELS];
  int n;
};

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

// The full test at NTH thresholds (th[0] = low, th[1] = high) in one pass
// over the ring; returns the combined score (NTH = 2) or the score (NTH = 1).
template <int NTH>
__device__ __forceinline__ float full_score(const float (&ring)[16], float c, const float (&th)[NTH],
                                            float bonus) {
  uint32_t bright[NTH], dark[NTH];
  float bright_s[NTH], dark_s[NTH], hi[NTH], lo[NTH];
#pragma unroll
  for (int t = 0; t < NTH; ++t) {
    bright[t] = dark[t] = 0u;
    bright_s[t] = dark_s[t] = 0.0f;
    hi[t] = c + th[t];
    lo[t] = c - th[t];
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const float r = ring[k];
    const float rc = r - c;
#pragma unroll
    for (int t = 0; t < NTH; ++t) {
      if (r > hi[t]) {
        bright[t] |= 1u << k;
        bright_s[t] = bright_s[t] + (rc - th[t]);
      }
      if (r < lo[t]) {
        dark[t] |= 1u << k;
        dark_s[t] = dark_s[t] + (lo[t] - r);
      }
    }
  }
  float s[NTH];
#pragma unroll
  for (int t = 0; t < NTH; ++t)
    s[t] = (contiguous_arc9(bright[t]) || contiguous_arc9(dark[t])) ? fmaxf(bright_s[t], dark_s[t]) : 0.0f;
  if (NTH == 2) return s[NTH - 1] > 0.0f ? s[NTH - 1] + bonus : s[0];
  return s[0];
}

// The paired cardinal test of the early exit at threshold th: ring
// positions 0 or 8, and 4 or 12, all bright or all dark.
__device__ __forceinline__ bool cardinal_pass(float c, float th, float r0, float r4, float r8, float r12) {
  const float hi = c + th, lo = c - th;
  const bool bright = ((r0 > hi) | (r8 > hi)) & ((r4 > hi) | (r12 > hi));
  const bool dark = ((r0 < lo) | (r8 < lo)) & ((r4 < lo) | (r12 < lo));
  return bright || dark;
}

template <int NTH>
__global__ void __launch_bounds__(TILE_W * WARPS)
fast_levels_kernel(const LevelTable table, float th_low, float th_high, float bonus) {
  __shared__ float tile[SM_H][SM_W];
  // This block's level: the one with the largest first block <= blockIdx.x
  // (the table's levels are laid out last first). The unrolled scan reads
  // the table at constant offsets (no local copy).
  const int bid = blockIdx.x;
  Level L = table.lv[0];
  int best = -1;
#pragma unroll
  for (int i = 0; i < MAX_LEVELS; ++i) {
    if (i < table.n && table.lv[i].tiles > 0 && table.lv[i].first_block <= bid &&
        table.lv[i].first_block > best) {
      L = table.lv[i];
      best = L.first_block;
    }
  }
  const int local = bid - L.first_block;
  const int z = local / L.tiles;
  const int t = local - z * L.tiles;
  const int by = t / L.tiles_x;
  const int h = L.h, w = L.w;
  const int x0 = (t - by * L.tiles_x) * TILE_W, y0 = by * TILE_H;
  const size_t plane = static_cast<size_t>(z) * h * w;
  const float* __restrict__ img = L.img + plane;
  float* __restrict__ out = L.out + plane;
  const int lane = threadIdx.x, warp = threadIdx.y;

  // Tile + halo, a warp a row at a time: all of a warp's loads are issued
  // before the first store to shared memory. Outside the image reads as 0
  // (those values only reach pixels that the border mask zeroes).
  constexpr int ROWS = (SM_H + WARPS - 1) / WARPS;  // rows a warp loads
  const int gx = x0 - HALO + lane;  // columns lane and, for lane < 6, lane + 32
  const bool col_in = gx >= 0 && gx < w, col2_in = lane < 2 * HALO && gx + TILE_W < w;
  float v[ROWS], v2[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int sy = warp + i * WARPS, gy = y0 - HALO + sy;
    const bool row_in = sy < SM_H && gy >= 0 && gy < h;
    v[i] = (row_in && col_in) ? img[gy * w + gx] : 0.0f;
    v2[i] = (row_in && col2_in) ? img[gy * w + gx + TILE_W] : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int sy = warp + i * WARPS;
    if (sy < SM_H) {
      tile[sy][lane] = v[i];
      if (lane < 2 * HALO) tile[sy][lane + TILE_W] = v2[i];
    }
  }
  __syncthreads();

  const int ys = y0 + warp * P;  // the strip's first row, one per warp
  if (ys >= h) return;           // warp-uniform
  const int x = x0 + lane;
  const bool x_in = x >= 3 && x < w - 3;
  const float th_min = NTH == 2 ? fminf(th_low, th_high) : th_low;
  const float* col = &tile[warp * P][lane];  // strip row r, column j: col[r * SM_W + j]

  // Pass 1, the early exit: the pre-test at th_min down the strip, its
  // column of ring positions 0, 8 and the center rolling in registers (one
  // new shared read a step, plus positions 4 and 12). Pixel rows where no
  // lane passes are written as 0 here; the others are flagged.
  float wc[7];  // wc[3 + dy]: the pixel at (y + dy, x)
#pragma unroll
  for (int r = 0; r < 6; ++r) wc[r + 1] = col[r * SM_W + 3];
  unsigned todo = 0u;  // warp-uniform: bit p flags pixel row ys + p
#pragma unroll
  for (int p = 0; p < P; ++p) {
#pragma unroll
    for (int r = 0; r < 6; ++r) wc[r] = wc[r + 1];
    wc[6] = col[(p + 6) * SM_W + 3];
    const int y = ys + p;
    const bool inside = x_in && y >= 3 && y < h - 3;
    const bool cand = cardinal_pass(wc[3], th_min, wc[0], col[(p + 3) * SM_W + 6], wc[6], col[(p + 3) * SM_W]);
    if (__any_sync(FULL_WARP, inside && cand))
      todo |= 1u << p;
    else if (x < w && y < h)
      out[y * w + x] = 0.0f;
  }

  // Pass 2: the full test on the flagged rows, its ring from shared memory.
#pragma unroll 1
  while (todo != 0u) {
    const int p = __ffs(todo) - 1;
    todo &= todo - 1u;
    const float* cp = col + (p + 3) * SM_W + 3;
    // Ring k at (dy_k, dx_k) of CIRCLE_OFFSETS.
    const float ring[16] = {cp[-3 * SM_W], cp[-3 * SM_W + 1], cp[-2 * SM_W + 2], cp[-SM_W + 3],
                            cp[3], cp[SM_W + 3], cp[2 * SM_W + 2], cp[3 * SM_W + 1],
                            cp[3 * SM_W], cp[3 * SM_W - 1], cp[2 * SM_W - 2], cp[SM_W - 3],
                            cp[-3], cp[-SM_W - 3], cp[-2 * SM_W - 2], cp[-3 * SM_W - 1]};
    const float c = cp[0];
    const int y = ys + p;
    const bool inside = x_in && y >= 3 && y < h - 3;
    float s;
    if constexpr (NTH == 2) {
      // Where no lane passes the pre-test at the larger threshold, that
      // threshold's score is 0 in the whole row: only th_min's is computed.
      const float th_max = fmaxf(th_low, th_high);
      if (__any_sync(FULL_WARP, inside && cardinal_pass(c, th_max, ring[0], ring[4], ring[8], ring[12]))) {
        const float th[NTH] = {th_low, th_high};
        s = full_score<NTH>(ring, c, th, bonus);
      } else {
        const float th1[1] = {th_min};
        const float s1 = full_score<1>(ring, c, th1, 0.0f);
        s = th_min == th_high ? (s1 > 0.0f ? s1 + bonus : 0.0f) : s1;
      }
    } else {
      const float th1[1] = {th_low};
      s = full_score<1>(ring, c, th1, 0.0f);
    }
    if (x < w && y < h) out[y * w + x] = inside ? s : 0.0f;
  }
}

}  // namespace

extern "C" {

// One level of the table, as the caller gives it.
struct HfvoFastLevel {
  const float* img;
  float* out;
  int h, w;
};

// Launch the score on `stream` over n_levels (1..16) levels, each s
// contiguous (h, w) images: K1 (s = 1) or K1b (s > 1) with nth = 2, K2 or
// K2b with nth = 1 (th_low only). Returns cudaGetLastError() (0 on success),
// or cudaErrorInvalidValue for a table it cannot take.
int hfvo_fast_score_levels(const HfvoFastLevel* levels, int n_levels, int s, int nth, float th_low,
                           float th_high, float bonus, void* stream) {
  if (n_levels < 1 || n_levels > MAX_LEVELS || s < 1 || (nth != 1 && nth != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  LevelTable table{};
  long long blocks = 0;
  // The last level's blocks first: a pyramid's smallest levels are the
  // densest in corners, so their longer blocks start early.
  for (int i = n_levels - 1; i >= 0; --i) {
    const HfvoFastLevel& in = levels[i];
    if (in.h < 0 || in.w < 0) return static_cast<int>(cudaErrorInvalidValue);
    Level& L = table.lv[i];
    L.img = in.img;
    L.out = in.out;
    L.h = in.h;
    L.w = in.w;
    L.tiles_x = (in.w + TILE_W - 1) / TILE_W;
    L.tiles = L.tiles_x * ((in.h + TILE_H - 1) / TILE_H);
    L.first_block = static_cast<int>(blocks);
    blocks += static_cast<long long>(L.tiles) * s;
    if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  }
  table.n = n_levels;
  if (blocks == 0) return 0;  // only empty levels
  const dim3 block(TILE_W, WARPS);
  const auto st = static_cast<cudaStream_t>(stream);
  if (nth == 2)
    fast_levels_kernel<2><<<static_cast<unsigned>(blocks), block, 0, st>>>(table, th_low, th_high, bonus);
  else
    fast_levels_kernel<1><<<static_cast<unsigned>(blocks), block, 0, st>>>(table, th_low, 0.0f, 0.0f);
  return static_cast<int>(cudaGetLastError());
}

const char* hfvo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
