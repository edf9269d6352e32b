// The pose LM: hfvo_tpu_torch/solve/lm.py::pose_optimization, every round
// and iteration of every sequence, in one launch a call.
//
// Replaces no TPU kernel: the JAX package's LM (hfvo_tpu/solve/lm.py) is a
// jitted XLA while loop, which XLA fuses into one program on the TPU. The
// port ran it op by op, ~100 small PyTorch ops an iteration over up to
// 4 rounds x 10 iterations, with a host sync on every convergence test and
// on each proposal's constants: ~8,300 launches and ~27 host syncs a frame
// for work of ~1e5 flops an iteration. This kernel computes the plain
// version (`pose_optimization_reference`, the same module) on the device:
// - the edge terms of solve/residuals.py: point/stereo (point_stereo_terms_t),
//   metric 3D (point3d_terms_t), line endpoint (line_terms_t), line
//   direction (dir_terms_t), plane kinds 0/1/2 (plane_edge_terms_t), and
//   the per-axis rotation anchors (lm.py::_axis_terms);
// - Huber weights in rounds 0 and 1; the damped step H + lam diag(H) +
//   1e-8 I solved by Gaussian elimination with partial pivoting (LAPACK's
//   getrf/getrs order, as torch.linalg.solve_ex); the left update by
//   exp_se3 with geometry/se3.py's series limits below 1e-8;
// - deferred accept (a lower cost and a finite pose), lam halved on accept
//   (>= 1e-7) and quadrupled on reject (<= 1e4), done on an accepted step
//   with relative gain <= 1e-5 or two negligible-margin rejections in a
//   row; chi2 re-classification after each round; the final inlier chi2.
//
// What bounds it on Hopper: neither bytes nor operations. A vo frame's
// tables are ~100 KB, read once into L1/L2 and reused by every iteration;
// an iteration is ~1e5 flops. Both bounds are well under a microsecond.
// What is left is latency along a serial chain: each iteration is a block
// reduction of 28 sums (21 of H's upper triangle, 6 of g, the cost) and a
// 6x6 solve and exp on one thread, and the next iteration needs its pose.
// The design:
// - One thread block a sequence (grid = S); the block leaves a round as
//   soon as its sequence is done. After `done` the plain version's masks
//   freeze pose, lam, cost and rejection count, and a batch runs until all
//   are done, so a block that stops on its own computes the same poses.
// - Each thread strides over the edges of each table and accumulates its
//   28 sums in registers; a warp-shuffle reduction and a fixed-order sum
//   over the warps' partials in shared memory give the block's sums: no
//   atomics, so a run repeats bit for bit, and a sequence's result does
//   not depend on S.
// - Thread 0 holds the LM state in shared memory, solves, proposes and
//   decides; two barriers an iteration.
// - The per-edge inlier flags live in dynamic shared memory (a byte an
//   edge); each thread re-classifies the edges it strides over, so only
//   it reads them back.
// The sums round in another order than the plain version's einsums, so
// results agree to float32 rounding, not bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

extern "C" {

// The call's tables, each with a leading sequence axis of S and
// contiguous; a table that is absent has a null pointer and a count of 0.
// Masks are bytes (torch.bool), plane kinds int32.
struct HfvoPoseLmArgs {
  const float* T0;               // (S, 4, 4)
  const float* pt_X;             // (S, N, 3)
  const float* pt_obs;           // (S, N, 3) u, v, u_r
  const uint8_t* pt_stereo;      // (S, N)
  const float* pt_isig;          // (S, N)
  const uint8_t* pt_valid;       // (S, N)
  const float* pt_Xc;            // (S, N, 3) depth-measured camera points, or null (no 3D term)
  const uint8_t* pt_valid3d;     // (S, N), or null: the 3D edges are the stereo ones
  const float* ln_X;             // (S, M, 3)
  const float* ln_l;             // (S, M, 3)
  const float* ln_isig;          // (S, M)
  const uint8_t* ln_valid;       // (S, M)
  const float* pl_piw;           // (S, P, 4)
  const float* pl_pio;           // (S, P, 4)
  const int32_t* pl_kind;        // (S, P)
  const float* pl_w;             // (S, P, 3)
  const float* pl_th;            // (S, P)
  const uint8_t* pl_valid;       // (S, P)
  const float* dr_dw;            // (S, V, 3)
  const float* dr_dc;            // (S, V, 3)
  const float* dr_isig;          // (S, V)
  const uint8_t* dr_valid;       // (S, V)
  const float* ax_c;             // (S, 3, 3), or null (no axis anchors)
  const float* ax_w;             // (S, 3, 3)
  const float* ax_wt;            // (S, 3), or null: every anchor weighs w_axis
  float* T_out;                  // (S, 4, 4)
  uint8_t* pt_inl;               // (S, N)
  int64_t* n_inl;                // (S,)
  float* chi2_out;               // (S,)
  uint8_t* ln_inl;               // (S, M)
  uint8_t* pl_inl;               // (S, P)
  int S, N, M, P, V, n_rounds, n_iters;
  float fx, fy, cx, cy, bf;
  float chi2_mono, chi2_stereo, chi2_line, chi2_vp, chi2_3d, inv_sigma2_3d, w_axis;
};

}  // extern "C"

namespace {

constexpr int NH = 21;               // H's upper triangle, row by row
constexpr int NG = 6;                // g
constexpr int NSUM = NH + NG + 1;    // and the cost
constexpr unsigned FULL_WARP = 0xffffffffu;
constexpr uint8_t PT_IN = 1;         // a point's flags: its image edge is an inlier,
constexpr uint8_t P3_IN = 2;         // its metric 3D edge is an inlier

enum Mode { BUILD, CLASSIFY, FINAL };

struct Pose {
  float R[9];
  float t[3];
};

// Thread 0's LM state, in shared memory.
struct LmState {
  float T_best[16];
  float T_try[16];
  float hg_b[NH + NG];  // H and g at T_best
  float c_b;
  float lam;
  int rej;
  int done;
};

// One sequence's tables and flags.
struct Seq {
  const float *X, *obs, *isig, *Xc;
  const uint8_t *stereo, *valid, *valid3d;
  const float *lX, *ll, *lisig;
  const uint8_t* lvalid;
  const float *piw, *pio, *pw, *pth;
  const int32_t* kind;
  const uint8_t* pvalid;
  const float *dw, *dc, *disig;
  const uint8_t* dvalid;
  const float *axc, *axw, *axwt;
  uint8_t *pflag, *lflag, *plflag, *dflag;
};

template <typename T>
__device__ __forceinline__ T* at(T* p, long long offset) {
  return p == nullptr ? nullptr : p + offset;
}

__device__ __forceinline__ Seq seq_view(const HfvoPoseLmArgs& a, int s, uint8_t* flags) {
  const long long N = a.N, M = a.M, P = a.P, V = a.V;
  Seq q;
  q.X = at(a.pt_X, s * N * 3);
  q.obs = at(a.pt_obs, s * N * 3);
  q.isig = at(a.pt_isig, s * N);
  q.Xc = at(a.pt_Xc, s * N * 3);
  q.stereo = at(a.pt_stereo, s * N);
  q.valid = at(a.pt_valid, s * N);
  q.valid3d = at(a.pt_valid3d, s * N);
  q.lX = at(a.ln_X, s * M * 3);
  q.ll = at(a.ln_l, s * M * 3);
  q.lisig = at(a.ln_isig, s * M);
  q.lvalid = at(a.ln_valid, s * M);
  q.piw = at(a.pl_piw, s * P * 4);
  q.pio = at(a.pl_pio, s * P * 4);
  q.pw = at(a.pl_w, s * P * 3);
  q.pth = at(a.pl_th, s * P);
  q.kind = at(a.pl_kind, s * P);
  q.pvalid = at(a.pl_valid, s * P);
  q.dw = at(a.dr_dw, s * V * 3);
  q.dc = at(a.dr_dc, s * V * 3);
  q.disig = at(a.dr_isig, s * V);
  q.dvalid = at(a.dr_valid, s * V);
  q.axc = at(a.ax_c, s * 9LL);
  q.axw = at(a.ax_w, s * 9LL);
  q.axwt = at(a.ax_wt, s * 3LL);
  q.pflag = flags;
  q.lflag = flags + N;
  q.plflag = flags + N + M;
  q.dflag = flags + N + M + P;
  return q;
}

__device__ __forceinline__ Pose load_pose(const float* T) {
  Pose p;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) p.R[3 * i + j] = T[4 * i + j];
    p.t[i] = T[4 * i + 3];
  }
  return p;
}

// R v, and R v + t.
__device__ __forceinline__ void rotate(const Pose& T, const float* v, float out[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = T.R[3 * i] * v[0] + T.R[3 * i + 1] * v[1] + T.R[3 * i + 2] * v[2];
}

__device__ __forceinline__ void transform(const Pose& T, const float* X, float out[3]) {
  rotate(T, X, out);
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] += T.t[i];
}

__device__ __forceinline__ void cross(const float a[3], const float b[3], float out[3]) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ float dot3(const float a[3], const float b[3]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// H += w J J^T, g += w r J, for one residual row J (6).
__device__ __forceinline__ void add_row(float* acc, const float J[6], float w, float r) {
  float wj[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) wj[i] = w * J[i];
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = i; j < 6; ++j) acc[k++] += wj[i] * J[j];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) acc[NH + i] += wj[i] * r;
}

// A rotation-only row [0, 0, 0, a, b, c].
__device__ __forceinline__ void add_rot_row(float* acc, float a, float b, float c, float w, float r) {
  const float J[6] = {0.0f, 0.0f, 0.0f, a, b, c};
  add_row(acc, J, w, r);
}

__device__ __forceinline__ float huber(float chi2, float delta) {
  return fminf(delta / sqrtf(fmaxf(chi2, 1e-12f)), 1.0f);
}

__device__ __forceinline__ float inv_z(float z) {
  return 1.0f / (fabsf(z) > 1e-9f ? z : 1e-9f);
}

// Visits this thread's edges at pose T. BUILD adds H, g and the cost of the
// active edges (weights Huber-scaled when `robust`) into acc; CLASSIFY
// writes each edge's inlier flag at T; FINAL adds the final inlier chi2
// into acc[0], counts the point inliers into *count, and writes the masks.
template <int MODE, int THREADS>
__device__ __forceinline__ void visit(const HfvoPoseLmArgs& a, const Seq& q, const Pose& T, bool robust,
                                      float* acc, int* count, int s) {
  const int tid = threadIdx.x;
  const float d_mono = sqrtf(a.chi2_mono), d_stereo = sqrtf(a.chi2_stereo);
  for (int n = tid; n < a.N; n += THREADS) {
    const bool valid = q.valid[n] != 0;
    uint8_t f = q.pflag[n];
    if (MODE == FINAL) a.pt_inl[static_cast<long long>(s) * a.N + n] = valid && (f & PT_IN);
    if (MODE != CLASSIFY && !valid) continue;
    float Xc[3];
    transform(T, q.X + 3 * n, Xc);
    const float x = Xc[0], y = Xc[1], z = Xc[2];
    const bool st = q.stereo[n] != 0;
    if (MODE == CLASSIFY || (f & PT_IN)) {
      const float iz = inv_z(z);
      const float iz2 = iz * iz;
      const float u = a.fx * x * iz + a.cx;
      const float v = a.fy * y * iz + a.cy;
      const float ur = u - a.bf * iz;
      const float* o = q.obs + 3 * n;
      const float r[3] = {u - o[0], v - o[1], ur - o[2]};
      const float isig = q.isig[n];
      const float chi2 = (r[0] * r[0] + r[1] * r[1] + (st ? r[2] * r[2] : 0.0f)) * isig;
      const bool okd = z > 1e-3f;
      if (MODE == BUILD) {
        if (okd) {
          const float rows[3][3] = {{a.fx * iz, 0.0f, -a.fx * x * iz2},
                                    {0.0f, a.fy * iz, -a.fy * y * iz2},
                                    {a.fx * iz, 0.0f, (a.bf - a.fx * x) * iz2}};
          float w = isig;
          if (robust) w *= huber(chi2, st ? d_stereo : d_mono);
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            if (k == 2 && !st) break;
            float c[3];
            cross(Xc, rows[k], c);
            const float J[6] = {rows[k][0], rows[k][1], rows[k][2], c[0], c[1], c[2]};
            add_row(acc, J, w, r[k]);
          }
          acc[NSUM - 1] += chi2;
        }
      } else if (MODE == CLASSIFY) {
        const bool in = chi2 <= (st ? a.chi2_stereo : a.chi2_mono) && okd;
        f = (f & ~PT_IN) | (in ? PT_IN : 0);
      } else {
        *count += 1;
        if (okd) acc[0] += chi2;
      }
    }
    if (q.Xc != nullptr) {
      const bool has3 = q.valid3d != nullptr ? q.valid3d[n] != 0 : st;
      if (MODE == CLASSIFY || (has3 && (f & P3_IN))) {
        const float* o = q.Xc + 3 * n;
        const float r[3] = {x - o[0], y - o[1], z - o[2]};
        const float chi2 = (r[0] * r[0] + r[1] * r[1] + r[2] * r[2]) * a.inv_sigma2_3d;
        if (MODE == BUILD) {
          float w = a.inv_sigma2_3d;
          if (robust) w *= huber(chi2, sqrtf(a.chi2_3d));
          const float J0[6] = {1.0f, 0.0f, 0.0f, 0.0f, z, -y};
          const float J1[6] = {0.0f, 1.0f, 0.0f, -z, 0.0f, x};
          const float J2[6] = {0.0f, 0.0f, 1.0f, y, -x, 0.0f};
          add_row(acc, J0, w, r[0]);
          add_row(acc, J1, w, r[1]);
          add_row(acc, J2, w, r[2]);
          acc[NSUM - 1] += chi2;
        } else if (MODE == CLASSIFY) {
          f = (f & ~P3_IN) | (chi2 <= a.chi2_3d ? P3_IN : 0);
        } else {
          acc[0] += chi2;
        }
      }
    }
    if (MODE == CLASSIFY) q.pflag[n] = f;
  }

  const float d_ln = sqrtf(a.chi2_line);
  for (int m = tid; m < a.M; m += THREADS) {
    const bool valid = q.lvalid[m] != 0;
    const bool f = q.lflag[m] != 0;
    if (MODE == FINAL) a.ln_inl[static_cast<long long>(s) * a.M + m] = valid && f;
    if (MODE != CLASSIFY && !(valid && f)) continue;
    float Xc[3];
    transform(T, q.lX + 3 * m, Xc);
    const float x = Xc[0], y = Xc[1], z = Xc[2];
    const float iz = inv_z(z);
    const float iz2 = iz * iz;
    const float u = a.fx * x * iz + a.cx;
    const float v = a.fy * y * iz + a.cy;
    const float* l = q.ll + 3 * m;
    const float r = l[0] * u + l[1] * v + l[2];
    const float chi2 = r * r * q.lisig[m];
    const bool okd = z > 1e-3f;
    if (MODE == BUILD) {
      if (okd) {
        const float dl[3] = {l[0] * a.fx * iz, l[1] * a.fy * iz, -(l[0] * a.fx * x + l[1] * a.fy * y) * iz2};
        float c[3];
        cross(Xc, dl, c);
        const float J[6] = {dl[0], dl[1], dl[2], c[0], c[1], c[2]};
        float w = q.lisig[m];
        if (robust) w *= huber(chi2, d_ln);
        add_row(acc, J, w, r);
        acc[NSUM - 1] += chi2;
      }
    } else if (MODE == CLASSIFY) {
      q.lflag[m] = chi2 <= a.chi2_line && okd;
    } else if (okd) {
      acc[0] += chi2;
    }
  }

  for (int p = tid; p < a.P; p += THREADS) {
    const bool valid = q.pvalid[p] != 0;
    const bool f = q.plflag[p] != 0;
    if (MODE == FINAL) a.pl_inl[static_cast<long long>(s) * a.P + p] = valid && f;
    if (MODE != CLASSIFY && !(valid && f)) continue;
    const float* pw = q.piw + 4 * p;
    const float* po = q.pio + 4 * p;
    float n_c[3];
    rotate(T, pw, n_c);
    const float d_c = pw[3] - dot3(n_c, T.t);
    const int kind = q.kind[p];
    const bool full = kind == 0;
    const bool pf = kind == 1 || full;
    float r0, rot0[3];
    if (pf) {
      float cx[3], cn[3];
      cross(po, n_c, cx);
      const float r_par = sqrtf(dot3(cx, cx));
      cross(cx, po, cn);
      const float den = fmaxf(r_par, 1e-9f);
      const float dr_dn[3] = {cn[0] / den, cn[1] / den, cn[2] / den};
      cross(n_c, dr_dn, rot0);
      r0 = r_par;
    } else {
      cross(n_c, po, rot0);
      r0 = dot3(po, n_c);
    }
    const float* wt = q.pw + 3 * p;
    const float r2 = po[3] - d_c;
    const float chi2 = r0 * r0 * wt[0] + (full ? r2 * r2 * wt[2] : 0.0f);
    if (MODE == BUILD) {
      const float scale = robust ? huber(chi2, sqrtf(q.pth[p])) : 1.0f;
      add_rot_row(acc, rot0[0], rot0[1], rot0[2], wt[0] * scale, r0);
      if (full) {
        const float J[6] = {n_c[0], n_c[1], n_c[2], 0.0f, 0.0f, 0.0f};
        add_row(acc, J, wt[2] * scale, r2);
      }
      acc[NSUM - 1] += chi2;
    } else if (MODE == CLASSIFY) {
      q.plflag[p] = chi2 <= q.pth[p];
    } else {
      acc[0] += chi2;
    }
  }

  const float d_vp = sqrtf(a.chi2_vp);
  for (int k = tid; k < a.V; k += THREADS) {
    const bool valid = q.dvalid[k] != 0;
    const bool f = q.dflag[k] != 0;
    if (MODE != CLASSIFY && !(valid && f)) continue;
    float v[3];
    rotate(T, q.dw + 3 * k, v);
    const float* dc = q.dc + 3 * k;
    const float proj = dot3(v, dc);
    const float sg = proj < 0.0f ? -1.0f : 1.0f;  // the observed direction's sign folded onto v's
    const float r[3] = {v[0] - dc[0] * sg, v[1] - dc[1] * sg, v[2] - dc[2] * sg};
    const float chi2 = dot3(r, r) * q.disig[k];
    if (MODE == BUILD) {
      float w = q.disig[k];
      if (robust) w *= huber(chi2, d_vp);
      add_rot_row(acc, 0.0f, v[2], -v[1], w, r[0]);
      add_rot_row(acc, -v[2], 0.0f, v[0], w, r[1]);
      add_rot_row(acc, v[1], -v[0], 0.0f, w, r[2]);
      acc[NSUM - 1] += chi2;
    } else if (MODE == CLASSIFY) {
      q.dflag[k] = chi2 <= a.chi2_vp;
    } else {
      acc[0] += chi2;
    }
  }

  // The axis anchors: three rows of three on thread 0. No gate, no Huber.
  if (MODE != CLASSIFY && tid == 0 && q.axc != nullptr) {
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      float v[3];
      rotate(T, q.axw + 3 * ax, v);
      const float* ac = q.axc + 3 * ax;
      const float r[3] = {v[0] - ac[0], v[1] - ac[1], v[2] - ac[2]};
      const float wa = q.axwt != nullptr ? q.axwt[ax] : a.w_axis;
      const float cost = wa * dot3(r, r);
      if (MODE == BUILD) {
        add_rot_row(acc, 0.0f, v[2], -v[1], wa, r[0]);
        add_rot_row(acc, -v[2], 0.0f, v[0], wa, r[1]);
        add_rot_row(acc, v[1], -v[0], 0.0f, wa, r[2]);
        acc[NSUM - 1] += cost;
      } else {
        acc[0] += cost;
      }
    }
  }
}

// Warp partials of acc[0..n) into red[warp][.]; a barrier; then warp 0's
// lanes sum the warps' partials in warp order into out[.].
template <int THREADS, int NV>
__device__ __forceinline__ void block_sum(const float* acc, float (*red)[NSUM], float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    float v = acc[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(FULL_WARP, v, off);
    if (lane == 0) red[warp][j] = v;
  }
  __syncthreads();
  if (warp == 0) {
    if (lane < NV) {
      float v = red[0][lane];
#pragma unroll
      for (int w = 1; w < THREADS / 32; ++w) v += red[w][lane];
      out[lane] = v;
    }
    __syncwarp();
  }
}

// x = A^-1 b for the 6x6 system in A's first 6 columns and b in its 7th:
// Gaussian elimination with partial pivoting (the first largest pivot, the
// column scaled by the pivot's reciprocal), then back substitution column
// by column, as LAPACK's getrf and getrs. A zero pivot gives a non-finite x.
__device__ __forceinline__ void solve6(float A[6][7], float x[6]) {
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    int p = k;
    float best = fabsf(A[k][k]);
#pragma unroll
    for (int r = k + 1; r < 6; ++r) {
      const float m = fabsf(A[r][k]);
      if (m > best) {
        best = m;
        p = r;
      }
    }
#pragma unroll
    for (int r = k + 1; r < 6; ++r) {
      if (r == p) {
#pragma unroll
        for (int c = k; c < 7; ++c) {
          const float tmp = A[k][c];
          A[k][c] = A[r][c];
          A[r][c] = tmp;
        }
      }
    }
    const float inv = 1.0f / A[k][k];
#pragma unroll
    for (int r = k + 1; r < 6; ++r) {
      const float l = A[r][k] * inv;
#pragma unroll
      for (int c = k + 1; c < 7; ++c) A[r][c] -= l * A[k][c];
    }
  }
  float b[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) b[i] = A[i][6];
#pragma unroll
  for (int j = 5; j >= 0; --j) {
    x[j] = b[j] / A[j][j];
#pragma unroll
    for (int i = 0; i < j; ++i) b[i] -= x[j] * A[i][j];
  }
}

// T_try = exp_se3(-(H + lam diag(H) + 1e-8 I)^-1 g) T_best.
__device__ void propose(LmState& st) {
  float A[6][7];
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = i; j < 6; ++j) A[i][j] = A[j][i] = st.hg_b[k++];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    A[i][i] = (A[i][i] + st.lam * A[i][i]) + 1e-8f;
    A[i][6] = st.hg_b[NH + i];
  }
  float x[6];
  solve6(A, x);
  const float rho[3] = {-x[0], -x[1], -x[2]};
  const float w[3] = {-x[3], -x[4], -x[5]};
  // geometry/se3.py::exp_se3 with its _sincos_coeffs.
  const float theta2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const bool big = theta2 > 1e-8f;
  const float t2 = big ? theta2 : 1.0f;
  const float th = sqrtf(t2);
  const float sn = sinf(th), cs = cosf(th);
  const float ca = big ? sn / th : 1.0f - theta2 / 6.0f;
  const float cb = big ? (1.0f - cs) / t2 : 0.5f - theta2 / 24.0f;
  const float cc = big ? (th - sn) / (t2 * th) : 1.0f / 6.0f - theta2 / 120.0f;
  const float W[3][3] = {{0.0f, -w[2], w[1]}, {w[2], 0.0f, -w[0]}, {-w[1], w[0], 0.0f}};
  float W2[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) W2[i][j] = W[i][0] * W[0][j] + W[i][1] * W[1][j] + W[i][2] * W[2][j];
  }
  float E[4][4];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float Vr[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float eye = i == j ? 1.0f : 0.0f;
      E[i][j] = (eye + ca * W[i][j]) + cb * W2[i][j];
      Vr[j] = (eye + cb * W[i][j]) + cc * W2[i][j];
    }
    E[i][3] = Vr[0] * rho[0] + Vr[1] * rho[1] + Vr[2] * rho[2];
  }
  E[3][0] = E[3][1] = E[3][2] = 0.0f;
  E[3][3] = 1.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      st.T_try[4 * i + j] = E[i][0] * st.T_best[j] + E[i][1] * st.T_best[4 + j] + E[i][2] * st.T_best[8 + j] +
                            E[i][3] * st.T_best[12 + j];
    }
  }
}

// A round's first build, at T_best.
__device__ void round_start(LmState& st, const float* sums) {
#pragma unroll
  for (int i = 0; i < NH + NG; ++i) st.hg_b[i] = sums[i];
  st.c_b = sums[NSUM - 1];
  st.lam = 1e-3f;
  st.rej = 0;
  st.done = 0;
  propose(st);
}

// One iteration's decision, on the build at T_try of a sequence not done.
__device__ void lm_step(LmState& st, const float* sums) {
  const float c = sums[NSUM - 1];
  bool finite = true;
#pragma unroll
  for (int i = 0; i < 16; ++i) finite &= isfinite(st.T_try[i]);
  const bool ok = c < st.c_b && finite;
  const bool rel = fabsf(st.c_b - c) <= 1e-5f * (st.c_b + 1e-9f);
  st.rej = (!ok && rel) ? st.rej + 1 : 0;
  const bool done = (ok && rel) || st.rej >= 2;
  if (ok) {
#pragma unroll
    for (int i = 0; i < 16; ++i) st.T_best[i] = st.T_try[i];
#pragma unroll
    for (int i = 0; i < NH + NG; ++i) st.hg_b[i] = sums[i];
    st.c_b = c;
  }
  st.done = done;
  if (!done) {
    st.lam = ok ? fmaxf(st.lam * 0.5f, 1e-7f) : fminf(st.lam * 4.0f, 1e4f);
    propose(st);
  }
}

template <int THREADS>
__global__ void __launch_bounds__(THREADS) pose_lm_kernel(const HfvoPoseLmArgs a) {
  extern __shared__ uint8_t flags[];  // points, lines, planes, directions
  __shared__ float red[THREADS / 32][NSUM];
  __shared__ float sums[NSUM];
  __shared__ int red_n[THREADS / 32];
  __shared__ LmState st;
  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const Seq q = seq_view(a, s, flags);

  for (int i = tid; i < a.N; i += THREADS) q.pflag[i] = PT_IN | P3_IN;
  for (int i = tid; i < a.M + a.P + a.V; i += THREADS) q.lflag[i] = 1;
  if (tid < 16) st.T_best[tid] = a.T0[16 * s + tid];
  __syncthreads();

  // Every round runs 2 ceil(n_iters / 2) iterations at most: the plain
  // version tests `done` once every two.
  const int iters = 2 * ((a.n_iters + 1) / 2);
  float acc[NSUM];
  for (int rnd = 0; rnd < a.n_rounds; ++rnd) {
    const bool robust = rnd < 2;
#pragma unroll
    for (int j = 0; j < NSUM; ++j) acc[j] = 0.0f;
    visit<BUILD, THREADS>(a, q, load_pose(st.T_best), robust, acc, nullptr, s);
    block_sum<THREADS, NSUM>(acc, red, sums);
    if (tid == 0) round_start(st, sums);
    __syncthreads();
    for (int it = 0; it < iters && !st.done; ++it) {
#pragma unroll
      for (int j = 0; j < NSUM; ++j) acc[j] = 0.0f;
      visit<BUILD, THREADS>(a, q, load_pose(st.T_try), robust, acc, nullptr, s);
      block_sum<THREADS, NSUM>(acc, red, sums);
      if (tid == 0) lm_step(st, sums);
      __syncthreads();
    }
    visit<CLASSIFY, THREADS>(a, q, load_pose(st.T_best), robust, acc, nullptr, s);
    __syncthreads();
  }

  acc[0] = 0.0f;
  int count = 0;
  visit<FINAL, THREADS>(a, q, load_pose(st.T_best), false, acc, &count, s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) count += __shfl_down_sync(FULL_WARP, count, off);
  if ((tid & 31) == 0) red_n[tid >> 5] = count;
  block_sum<THREADS, 1>(acc, red, sums);
  if (tid == 0) {
    long long n = 0;
    for (int w = 0; w < THREADS / 32; ++w) n += red_n[w];
    a.n_inl[s] = n;
    a.chi2_out[s] = sums[0];
  }
  if (tid < 16) a.T_out[16 * s + tid] = st.T_best[tid];
}

template <int THREADS>
int launch(const HfvoPoseLmArgs& a, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(a.N) + a.M + a.P + a.V;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(pose_lm_kernel<THREADS>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  pose_lm_kernel<THREADS><<<a.S, THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch the LM on `stream`: one block of `threads` (128, 256 or 512)
// threads a sequence. Returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for arguments it cannot take.
int hfvo_pose_lm(const HfvoPoseLmArgs* args, int threads, void* stream) {
  const HfvoPoseLmArgs& a = *args;
  if (a.S < 0 || a.N < 0 || a.M < 0 || a.P < 0 || a.V < 0 || a.n_rounds < 0 || a.n_iters < 0 ||
      a.S > 0x7FFFFFFF / 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.S == 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  switch (threads) {
    case 128: return launch<128>(a, st);
    case 256: return launch<256>(a, st);
    case 512: return launch<512>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* hfvo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
