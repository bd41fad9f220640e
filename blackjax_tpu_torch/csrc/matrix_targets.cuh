// Device functions of the matrix targets, shared by the four kernels:
//
// - the continuous NUTS machine's logistic regression, Finnish horseshoe and
//   eight schools (csrc/fused_nuts_dc.cu), which replace the target tiles of
//   blackjax_tpu/ops/targets_dc.py (make_logreg_target_dc :61-124,
//   make_finnish_horseshoe_target_dc :144-350, make_eight_schools_target_dc
//   :365-457) that the Pallas kernel _nuts_kernel_dc traces in;
// - the fused kernels' logistic regression (csrc/fused_leapfrog.cu,
//   csrc/fused_mclmc.cu, and the older NUTS machine csrc/fused_nuts.cu), which
//   replaces make_logistic_regression_target
//   (blackjax_tpu/ops/fused_leapfrog.py:324-400) inside _leapfrog_kernel,
//   _mclmc_kernel and _nuts_kernel.
//
// Each keeps its own reference's spelling, so that each is held against its
// own reference: the dc logistic regression sums softplus over the
// 8-padded data rows and subtracts the padding constant, the fused one masks
// the padded rows out (here: skips them, which adds the same exact zeros).
//
// Layout. One warp holds one chain: lane j holds dims j, j+32, ... in N
// registers per vector. A gradient is two contractions with the data matrix
// X (rows x cols, row-major; X^T beside it): q = X v and X^T t(q), with t a
// function of each row's q. The warp stages v (the weights, or the
// horseshoe's beta) in a per-warp shared-memory scratch; each lane takes
// data rows n = lane, lane + 32, ... and forms q_n against the broadcast v;
// then the warp stages the 32 rows' t in shared memory and each lane
// accumulates the columns it owns from X's rows, coalesced. __syncwarp()
// separates each write of the scratch from the reads of other lanes. The
// horseshoe's log_lam[m] (row m) and beta_t[m] (row M + m) sit in different
// lanes, so it reads x from the scratch too, and its four tail scalars (rows
// 2M..2M+3) are read by every lane.
//
// Where X is read from: in the L2 form (row_pass) from device memory, X^T[:,
// n] and X's rows, coalesced across lanes; it stays in L2. In the
// shared-memory form (row_pass_shared, the horseshoe only) the dc machine's
// block has copied X once, at the top of the kernel, into shared memory,
// zero padded to a row stride of 4 mod 8 floats (204 for 200 columns), and
// only reads it afterwards, as float4: lane n reads its row n in the forward
// pass, and consecutive column groups of each row in the backward pass,
// neither with bank conflicts. The backward pass leaves X^T t in the
// scratch rather than in registers. The wrapper picks the form before the
// launch from the block's bytes (shared_memory_plan in ops/fused_nuts_dc.py):
// shared memory where X and the block's four warps fit in 227 KB, L2 where
// they do not.
//
// Bound. Per gradient and chain the kernel reads X twice (2 rows x cols
// floats) and does 4 rows x cols FP32 operations. In the L2 form X (80 KB
// for the horseshoe at 100 x 200, 864 KB for logistic regression at 4,096 x
// 54) is read from L2, 8 bytes a multiply-add: by its latency where few warps
// share an SM, by its bandwidth where many do (the fused kernels at 4,096
// chains). In the shared-memory form the two reads of X are 2 x 80 KB of
// shared-memory traffic per gradient at 100 x 200, against 128 bytes a
// clock per SM; with one warp
// per scheduler, what bounds it in practice is the latency of the loads that
// the few registers left by the N = 13 machine keep in flight. Tensor cores
// do not apply: each warp's product is a matrix times one vector, the warps
// of a block sit at different leaves of different trees, and TF32 would lose
// the agreement with the plain version.
//
// Logistic regression's tiles form. Its X (864 KB at 4,096 x 54) fits no
// block, so the kernels whose chains can meet at every gradient run the
// chains of a block together and logreg_tiles computes one gradient for all
// of them, streaming X through shared memory in tiles, each read from L2
// once a block and gradient: the dc machine runs its block's leaves in
// lockstep (see the header of fused_nuts_dc.cuh), and the fused leapfrog and
// MCLMC kernels' chains run the same stages in the same order anyway. Only
// the older NUTS machine, whose chains sit at different leaves, keeps the
// per-warp L2 form (logreg_grad, logreg_logdensity).
//
// Numerics. Every expression keeps the reference's operation order (the
// tiles' _core, _value and _grad, with JAX's NaN rule for logaddexp and its
// overflow behaviour, e.g. log1p(exp(2 log_tau))); what is left is the order
// of the sums over data rows and columns.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "analytic_targets.cuh"  // kFull, warp_sum

namespace {

// target ids beyond analytic_targets.cuh's: the fused kernels' logistic
// regression, and the dc machine's three matrix targets
constexpr int kLogisticRegression = 2;
constexpr int kLogRegDC = 2;
constexpr int kHorseshoeDC = 3;
constexpr int kEightSchoolsDC = 4;

// What a matrix target reads (MatrixTargetData in ops/fused_nuts_dc.py):
// - dc logistic regression: X as tiles (logreg_tiles), rows = n_pad8,
//   u = X^T y (d,), k = {1/s^2, -0.5/s^2, padding constant};
// - fused logistic regression: X (n, d), u = y (n,), k = {1/s^2, -0.5/s^2};
// - horseshoe: X (N, M), u = X^T y, s = X^T 1 (M,),
//   k = {tau0, df/2, slab_scale^2, y.y, sum y, N, N/2};
// - eight schools: u = y, s = 1/sigma^2 (8,).
struct MatrixData {
  const float* X;   // (rows, cols), row-major
  const float* Xt;  // (cols, rows), row-major
  const float* u;
  const float* s;
  int rows, cols;
  float k[8];
};

// floats of per-warp scratch a matrix target uses with N registers per
// vector: x (or v), the gradient, the horseshoe's beta, one chunk of rows
template <int N>
__host__ __device__ constexpr int scratch_floats() { return 3 * N * 32 + 32; }

// the horseshoe's: x, the gradient and beta (M <= 16 N - 2 floats, 16-byte
// aligned for the float4 reads); the chunk of rows aliases the gradient,
// which is written only after both contractions
template <int N>
__host__ __device__ constexpr int horseshoe_scratch_floats() { return 2 * N * 32 + 16 * N; }

// X's row stride in shared memory: cols rounded up to a multiple of 4 that is
// 4 mod 8 (204 floats for 200 columns), for float4 reads without bank
// conflicts by row and by column; and its floats
__host__ __device__ constexpr int shared_x_stride(int cols) { return ((cols + 3) & ~3) | 4; }
__host__ __device__ constexpr int shared_x_floats(int rows, int cols) {
  return rows * shared_x_stride(cols);
}

// JAX's logaddexp: a NaN difference means equal infinities (or a NaN input),
// and a + b then gives -inf for (-inf, -inf) where max + log1p(exp(-|a-b|))
// would give NaN.
__device__ __forceinline__ float logaddexp(float a, float b) {
  const float delta = a - b;
  if (isnan(delta)) return a + b;
  return fmaxf(a, b) + log1pf(expf(-fabsf(delta)));
}

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

// the warp's vector into the scratch, readable by every lane afterwards
template <int N>
__device__ __forceinline__ void stage(float* dst, const float (&v)[N], int lane) {
  __syncwarp();
#pragma unroll
  for (int k = 0; k < N; ++k) dst[k * 32 + lane] = v[k];
  __syncwarp();
}

// q_n = sum_j X[n, j] v[j] for every data row n, t_n = row(n, q_n), and (if
// kBack) acc[k] += sum_n X[n, j] t_n for the columns j = k * 32 + lane, k < K.
template <bool kBack, int K, class Row>
__device__ __forceinline__ void row_pass(const MatrixData& m, const float* v, float* chunk,
                                         int lane, float (&acc)[K], Row row) {
  const int rows = m.rows, cols = m.cols;
  for (int n0 = 0; n0 < rows; n0 += 32) {
    const int n = n0 + lane;
    float t = 0.f;
    if (n < rows) {
      float q = 0.f;
      for (int j = 0; j < cols; ++j) q += m.Xt[(size_t)j * rows + n] * v[j];
      t = row(n, q);
    }
    if constexpr (kBack) {
      chunk[lane] = t;
      __syncwarp();
      const int r_end = min(32, rows - n0);
      for (int r = 0; r < r_end; ++r) {
        const float tr = chunk[r];
        const float* xrow = m.X + (size_t)(n0 + r) * cols;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int j = k * 32 + lane;
          if (j < cols) acc[k] += xrow[j] * tr;
        }
      }
      __syncwarp();
    }
  }
}

// row_pass on X in shared memory (xs, rows x shared_x_stride(cols), zero
// padded), always with the backward pass, which it writes to shared memory:
// xt[j] = sum_n X[n, j] t_n for j < cols (xt may alias chunk: it is written
// after the chunk's last read; chunk holds 32 R floats). Both passes read X
// as float4, so that each load brings four columns. Forward: lane l sums
// the R rows l, l + 32, ..., l + 32 (R - 1) of a group of 32 R rows at once,
// each in four partial sums (columns j mod 4), against v read as float4
// broadcasts (v 16-byte aligned); the row stride is 4 mod 8 floats, so a
// quarter-warp's eight rows fall in eight different 16-byte bank groups.
// Backward: lane l accumulates the column groups 4 (l + 32 h), h < H, of
// each row of the group in order, read consecutively; lanes past the last
// group read it again (a broadcast), and their sums are never written.
// H * 128 >= cols.
template <int H, int R, class Row>
__device__ __forceinline__ void row_pass_shared(const float* xs, int rows, int cols,
                                                const float* v, float* chunk, float* xt,
                                                int lane, Row row) {
  const int stride = shared_x_stride(cols);
  const int groups = stride / 4;
  const int cols4 = cols & ~3;
  const float4* v4 = reinterpret_cast<const float4*>(v);
  float4 acc[H];
#pragma unroll
  for (int h = 0; h < H; ++h) acc[h] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int n0 = 0; n0 < rows; n0 += 32 * R) {
    // rows past the last read it again, and are dropped
    const float4* x4[R];
    float4 q[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      x4[i] = reinterpret_cast<const float4*>(xs + min(n0 + 32 * i + lane, rows - 1) * stride);
      q[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll 2
    for (int j4 = 0; j4 < cols4 / 4; ++j4) {
      const float4 b = v4[j4];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float4 x = x4[i][j4];
        q[i].x += x.x * b.x;
        q[i].y += x.y * b.y;
        q[i].z += x.z * b.z;
        q[i].w += x.w * b.w;
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float* xrow = reinterpret_cast<const float*>(x4[i]);
      for (int j = cols4; j < cols; ++j) q[i].x += xrow[j] * v[j];
      const int n = n0 + 32 * i + lane;
      chunk[32 * i + lane] = n < rows ? row(n, (q[i].x + q[i].y) + (q[i].z + q[i].w)) : 0.f;
    }
    __syncwarp();
    const int r_end = min(32 * R, rows - n0);
    const float4* xr = reinterpret_cast<const float4*>(xs + n0 * stride);
#pragma unroll 4
    for (int r = 0; r < r_end; ++r, xr += groups) {
      const float tr = chunk[r];
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const float4 x = xr[min(lane + 32 * h, groups - 1)];
        acc[h].x += x.x * tr;
        acc[h].y += x.y * tr;
        acc[h].z += x.z * tr;
        acc[h].w += x.w * tr;
      }
    }
    __syncwarp();
  }
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const int c = 4 * (lane + 32 * h);
    const float a[4] = {acc[h].x, acc[h].y, acc[h].z, acc[h].w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (c + i < cols) xt[c + i] = a[i];
  }
  __syncwarp();
}

// ---- the dc machine's targets: logdensity (returned, replicated) and
// gradient (per lane), as vg_tile computes them ----

// ---- logistic regression's tiles form: the dc machine's and the fused
// kernels' ----

// Rows of X a tile holds, with N registers per vector and K chains a block:
// the forward pass gives each thread one row of the tile (R <= 32 K), and
// the cap keeps the ring of two tiles near 128 KB up to cols = 32 N.
template <int N>
__host__ __device__ constexpr int lr_tile_cap() {
  return N <= 2 ? 256 : N <= 4 ? 128 : N <= 8 ? 64 : 32;
}
template <int N, int K>
__host__ __device__ constexpr int lr_tile_rows() {
  return lr_tile_cap<N>() < 32 * K ? lr_tile_cap<N>() : 32 * K;
}

// chains a warp accumulates in the backward pass, N columns each (16
// accumulators a lane, N of them from N = 13); the block's K warps split
// each tile's rows into as many groups
template <int N, int K>
__host__ __device__ constexpr int lr_back_chains() {
  return N > 8 ? 1 : 16 / N < K ? 16 / N : K;
}

// floats of the block's shared memory for the gradient with tiles of R
// rows: the ring of two tiles (which the backward pass's partial sums reuse
// once the last tile is done), the positions wt (round_up(cols, 4) x K) and
// the sigmoids st (R x K, whose floats the softplus partial sums reuse)
template <int N, int K, int R = lr_tile_rows<N, K>()>
__host__ __device__ constexpr int lr_region_floats(int cols) {
  return 2 * R * shared_x_stride(cols) > lr_back_chains<N, K>() * K * 32 * N
             ? 2 * R * shared_x_stride(cols)
             : lr_back_chains<N, K>() * K * 32 * N;
}
template <int N, int K, int R = lr_tile_rows<N, K>()>
__host__ __device__ constexpr int lr_tiles_floats(int cols) {
  return lr_region_floats<N, K, R>(cols) + ((cols + 3) & ~3) * K + R * K;
}

// 16 bytes from device memory into shared memory, asynchronously, through
// L2 only (cp.async.cg), in the calling thread's current commit group
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most `pending` of this thread's commit groups are in flight
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

// B consecutive floats from shared memory, 16 (or 8, or 4) bytes a load
template <int B>
__device__ __forceinline__ void load_run(const float* src, float (&out)[B]) {
  if constexpr (B % 4 == 0) {
#pragma unroll
    for (int i = 0; i < B / 4; ++i) {
      const float4 v = reinterpret_cast<const float4*>(src)[i];
      out[4 * i] = v.x; out[4 * i + 1] = v.y; out[4 * i + 2] = v.z; out[4 * i + 3] = v.w;
    }
  } else if constexpr (B == 2) {
    const float2 v = *reinterpret_cast<const float2*>(src);
    out[0] = v.x; out[1] = v.y;
  } else {
    static_assert(B == 1, "runs of 1, 2 or a multiple of 4 floats");
    out[0] = *src;
  }
}

// What a call of logreg_tiles computes, in whose spelling: the dc machine's
// log density and gradient (targets_dc.py:82-107), or the fused kernels'
// gradient or log density (fused_leapfrog.py:353-382).
constexpr int kTilesDC = 0;
constexpr int kTilesGrad = 1;
constexpr int kTilesValue = 2;

// Logistic regression for the block's K chains at once, each warp's for its
// own chain, in the spelling kSpell:
// - kTilesDC: ld = v.w - (sum softplus(Xw) - pad) + prior, g = v - X^T
//   sigmoid(Xw) - w / s^2 (m.u = v = X^T y; m.rows counts the rows that
//   enter the softplus sum, the reference's rows padded to 8);
// - kTilesGrad: g = X^T (y - sigmoid(Xw)) - w / s^2, returns 0;
// - kTilesValue: ld = sum_n (y_n q_n - logaddexp(0, q_n)) - 0.5 |w|^2 / s^2,
//   g untouched (m.u = y; m.rows = the data rows: the rows past it are the
//   reference's masked padding, which adds exact zeros, so they are skipped).
// Every warp of the block calls it at the same point (it holds
// __syncthreads), a warp without a chain with w = 0, whose result it
// ignores.
//
// X comes as tiles of R rows at the row stride shared_x_stride(cols), zero
// padded in device memory to whole tiles (m.X, ops/fused_nuts_dc.py:_lr_tiles).
// Tile t + 1 is copied (cp.async) into the ring's other half while tile t
// is used. On each tile the forward pass gives thread (row r, chains
// c0..c0+B-1) its B logits q = X[r] . w_c, summed over the columns in order
// from X read as float4 (the stride is 4 mod 8: no bank conflicts) and the
// positions as broadcasts; it adds its row's term of the log density to its
// own partial sums and writes the backward pass's weight (sigmoid(q), or y -
// sigmoid(q)) to st. The backward pass reads the same tile: warp (rho,
// gamma) adds X[r, j] st[r, c] for its rows r = rho, rho + BC, ... and its BC
// chains to 16 accumulators a lane (columns j = lane + 32 k). After the last
// tile the block writes the partial sums to shared memory and each warp adds
// its chain's, in a fixed order, so a chain's result does not depend on
// which warp of which block ran it.
template <int N, int K, int kSpell = kTilesDC, int R = lr_tile_rows<N, K>()>
__device__ float logreg_tiles(const MatrixData& m, const float (&w)[N], float (&g)[N], int lane,
                              float* sh) {
  static_assert(K >= 4 && (K & (K - 1)) == 0, "float4 rows of positions and sigmoids");
  static_assert(R % 32 == 0 && R <= 32 * K, "a row of the tile for every thread");
  constexpr int B = R / 32;                 // chains of a thread's forward pass
  constexpr int BC = lr_back_chains<N, K>();  // chains of a warp's backward pass
  constexpr int T = 32 * K;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int rows = m.rows, cols = m.cols;
  const int sx = shared_x_stride(cols), cols4 = (cols + 3) & ~3;
  float* ring = sh;
  float* wt = sh + lr_region_floats<N, K, R>(cols);
  float* st = wt + cols4 * K;
  const int tile_floats = R * sx;
  const int n_tiles = (rows + R - 1) / R;
  const auto issue = [&](int t) {  // tile t into its half of the ring
    const float* src = m.X + (size_t)t * tile_floats;
    float* dst = ring + (t & 1) * tile_floats;
    for (int i = 4 * tid; i < tile_floats; i += 4 * T) cp_async16(dst + i, src + i);
    cp_async_commit();
  };

  float yxw = 0.f, ww = 0.f;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int j = k * 32 + lane;
    if (j < cols4) wt[j * K + warp] = j < cols ? w[k] : 0.f;
    if (j < cols) {
      if constexpr (kSpell == kTilesDC) yxw += m.u[j] * w[k];
      ww += w[k] * w[k];
    }
  }
  // the positions are staged, and every warp has read the last call's sums
  __syncthreads();
  issue(0);

  const int r_f = tid % R, c0 = (tid / R) * B;   // forward: a row, B chains
  const int rho = warp % BC, gamma = warp / BC;  // backward: rows rho + BC i, BC chains
  int jc[N];                                     // backward columns, clamped into the row
#pragma unroll
  for (int k = 0; k < N; ++k) jc[k] = min(k * 32 + lane, sx - 1);
  float sp[B] = {};
  float acc[N][BC] = {};
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      issue(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t has landed for every thread
    const float* xt = ring + (t & 1) * tile_floats;
    {
      const float4* x4 = reinterpret_cast<const float4*>(xt + r_f * sx);
      float q[B] = {};
      for (int j4 = 0; j4 < cols4 / 4; ++j4) {
        const float4 x = x4[j4];
        const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float wr[B];
          load_run<B>(wt + (4 * j4 + i) * K + c0, wr);
#pragma unroll
          for (int b = 0; b < B; ++b) q[b] = __fmaf_rn(xs[i], wr[b], q[b]);
        }
      }
      const bool real = t * R + r_f < rows;
      const float y = kSpell != kTilesDC && real ? m.u[t * R + r_f] : 0.f;
      float s[B];
#pragma unroll
      for (int b = 0; b < B; ++b) {
        s[b] = 0.f;
        if (real) {
          if constexpr (kSpell == kTilesDC) {
            sp[b] += logaddexp(0.f, q[b]);
            s[b] = sigmoid(q[b]);
          } else if constexpr (kSpell == kTilesGrad) {
            s[b] = y - sigmoid(q[b]);
          } else {
            sp[b] += y * q[b] - logaddexp(0.f, q[b]);
          }
        }
      }
#pragma unroll
      for (int b = 0; b < B; ++b) st[r_f * K + c0 + b] = s[b];
    }
    __syncthreads();  // the sigmoids are in st
    // rows past r_end add exact zeros; the log density needs no backward pass
    const int r_end = kSpell == kTilesValue ? 0 : min(R, rows - t * R);
    for (int r = rho; r < r_end; r += BC) {
      const float* xr = xt + r * sx;
      float s[BC];
      load_run<BC>(st + r * K + gamma * BC, s);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float x = xr[jc[k]];
#pragma unroll
        for (int b = 0; b < BC; ++b) acc[k][b] = __fmaf_rn(x, s[b], acc[k][b]);
      }
    }
    __syncthreads();  // this half of the ring and st may be written again
  }

  // the partial sums: X^T st by (row group, chain, column) over the ring,
  // the log density's terms by (row, chain) over st; then each warp adds
  // its chain's
  float* part = ring;
#pragma unroll
  for (int k = 0; k < N; ++k)
#pragma unroll
    for (int b = 0; b < BC; ++b)
      part[(rho * K + gamma * BC + b) * (32 * N) + k * 32 + lane] = acc[k][b];
#pragma unroll
  for (int b = 0; b < B; ++b) st[r_f * K + c0 + b] = sp[b];
  __syncthreads();
  float spl = 0.f;
  for (int r = lane; r < R; r += 32) spl += st[r * K + warp];
  float xts[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float a = 0.f;
    for (int i = 0; i < BC; ++i) a += part[(i * K + warp) * (32 * N) + k * 32 + lane];
    xts[k] = a;
  }
  if constexpr (kSpell == kTilesValue) return warp_sum(spl) + m.k[1] * warp_sum(ww);
  if constexpr (kSpell == kTilesGrad) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int j = k * 32 + lane;
      g[k] = j < m.cols ? xts[k] - m.k[0] * w[k] : 0.f;
    }
    return 0.f;
  }
  const float softplus = warp_sum(spl);
  const float ld = warp_sum(yxw) - (softplus - m.k[2]) + m.k[1] * warp_sum(ww);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int j = k * 32 + lane;
    g[k] = j < m.cols ? (m.u[j] - xts[k]) - m.k[0] * w[k] : 0.f;
  }
  return ld;
}

// targets_dc.py:204-298, the layout [log_lam(M), beta_t(M), alpha,
// log_sigma, log_tau, log_c2]; d = 2 M + 4. kSharedX: X is read from the
// block's copy in shared memory (x_sh), else from device memory (L2).
template <int N, bool kSharedX>
__device__ float horseshoe_dc(const MatrixData& m, int d, const float (&x)[N], float (&g)[N],
                              int lane, float* scratch, const float* x_sh) {
  float* xs = scratch;
  float* gs = scratch + N * 32;
  float* bs = scratch + 2 * N * 32;  // horseshoe_scratch_floats<N>()
  const int M = m.cols;
  // M <= 16 N - 2 (d = 2 M + 4 <= 32 N): the predictors sit in k < KH, and
  // in H column groups of 128 in the shared-memory form, whose forward pass
  // takes R rows a lane (its chunk of 32 R floats fits the gradient's N x 32)
  constexpr int KH = (N + 1) / 2;
  constexpr int H = (16 * N + 125) / 128;
  constexpr int R = N < 4 ? N : 4;
  stage<N>(xs, x, lane);
  const float alpha = xs[2 * M], log_sigma = xs[2 * M + 1];
  const float log_tau = xs[2 * M + 2], log_c2 = xs[2 * M + 3];
  const float tau0 = m.k[0], half_df = m.k[1], slab2 = m.k[2], yy = m.k[3], sy = m.k[4];
  const float n_data = m.k[5], half_n = m.k[6];

  // _core: beta, with X beta shared by the value and the gradient
  const float sigma = expf(log_sigma);
  const float inv_s2 = expf(-2.f * log_sigma);
  const float tau = tau0 * sigma * expf(log_tau);
  const float c2 = slab2 * expf(log_c2);
  float ub = 0.f, sb = 0.f, lam_terms = 0.f, bt2 = 0.f;
  float lam2_k[KH], denom_k[KH], lam_reg_k[KH];  // kept for _grad
#pragma unroll
  for (int k = 0; k < KH; ++k) {
    const int mi = k * 32 + lane;
    if (mi < M) {
      const float log_lam = xs[mi], beta_t = xs[M + mi];
      const float lam2 = lam2_k[k] = expf(2.f * log_lam);
      const float denom = denom_k[k] = c2 + tau * tau * lam2;
      const float lam_reg = lam_reg_k[k] = sqrtf(c2 * lam2 / denom);
      const float beta = tau * lam_reg * beta_t;
      bs[mi] = beta;
      ub += m.u[mi] * beta;
      sb += m.s[mi] * beta;
      lam_terms += -log1pf(lam2) + log_lam;
      bt2 += beta_t * beta_t;
    }
  }
  __syncwarp();
  float xtq[KH] = {};
  float sq = 0.f, sq2 = 0.f;
  const auto row = [&](int, float q) {
    sq += q;
    sq2 += q * q;
    return q;
  };
  if constexpr (kSharedX) {
    row_pass_shared<H, R>(x_sh, m.rows, m.cols, bs, gs, gs, lane, row);  // X^T q in gs
  } else {
    row_pass<true>(m, bs, gs, lane, xtq, row);
  }
  const float sum_q = warp_sum(sq), sum_q2 = warp_sum(sq2);
  const float u_beta = warp_sum(ub), s_beta = warp_sum(sb);
  const float ssr = yy - 2.f * (u_beta + alpha * sy) + sum_q2 + 2.f * alpha * (s_beta + half_n * alpha);

  // _value
  const float loglik = -n_data * log_sigma - 0.5f * ssr * inv_s2;
  float lp = -0.125f * (alpha * alpha);
  lp = lp + (-0.125f * (sigma * sigma) + log_sigma);
  lp = lp + (-log1pf(expf(2.f * log_tau)) + log_tau);
  lp = lp + (-half_df * log_c2 - half_df * expf(-log_c2));
  lp = lp + warp_sum(lam_terms);
  lp = lp + -0.5f * warp_sum(bt2);
  const float value = lp + loglik;

  // _grad: g_beta = (u - X^T q - alpha s) / sigma^2 through beta's chain rule
  float tl = 0.f, tc = 0.f;
#pragma unroll
  for (int k = 0; k < KH; ++k) {
    const int mi = k * 32 + lane;
    if (mi < M) {
      const float beta_t = xs[M + mi];
      const float lam2 = lam2_k[k], denom = denom_k[k], lam_reg = lam_reg_k[k];
      const float beta = bs[mi];
      const float xt_q = kSharedX ? gs[mi] : xtq[k];  // read before gs[mi] is written
      const float g_beta = (m.u[mi] - xt_q - alpha * m.s[mi]) * inv_s2;
      const float frac = c2 / denom;
      const float gbf = g_beta * beta * frac;
      gs[M + mi] = g_beta * tau * lam_reg - beta_t;
      gs[mi] = gbf + 1.f - 2.f * lam2 / (1.f + lam2);
      tl += gbf;
      tc += g_beta * beta * (tau * tau * lam2) / (2.f * denom);
    }
  }
  const float t_lik = warp_sum(tl), c_sum = warp_sum(tc);
  if (lane == 0) {
    gs[2 * M] = (sy - sum_q - n_data * alpha) * inv_s2 - 0.25f * alpha;
    gs[2 * M + 1] = -n_data + ssr * inv_s2 + t_lik - 0.25f * (sigma * sigma) + 1.f;
    gs[2 * M + 2] = t_lik + 1.f - 2.f * sigmoid(2.f * log_tau);
    gs[2 * M + 3] = c_sum - half_df + half_df * expf(-log_c2);
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int j = k * 32 + lane;
    g[k] = j < d ? gs[j] : 0.f;
  }
  return value;
}

// targets_dc.py:394-432, the layout [z(8), mu, log_tau]: one register per
// lane (d = 10), z in lanes 0..7, mu and log_tau in lanes 8 and 9 (the
// registers form; the thread form's is eight_schools_thread below)
__device__ float eight_schools_dc(const MatrixData& m, const float (&x)[1], float (&g)[1],
                                  int lane) {
  const float mu = __shfl_sync(kFull, x[0], 8), log_tau = __shfl_sync(kFull, x[0], 9);
  const float tau = expf(log_tau);
  const bool is_z = lane < 8;
  const float z = is_z ? x[0] : 0.f;
  const float resid = is_z ? m.u[lane] - mu - tau * z : 0.f;
  const float r = is_z ? resid * m.s[lane] : 0.f;  // weighted residual
  const float zz = warp_sum(z * z), rr = warp_sum(resid * r);
  const float r_sum = warp_sum(r), rz = warp_sum(r * z);
  float lp = -0.02f * (mu * mu) - 0.02f * (log_tau * log_tau);
  lp = lp + -0.5f * zz;
  lp = lp + -0.5f * rr;
  g[0] = is_z ? -z + r * tau
              : lane == 8 ? -0.04f * mu + r_sum
              : lane == 9 ? -0.04f * log_tau + tau * rz : 0.f;
  return lp;
}

// warp_sum of a chain's values in lanes 0..7 (8) or 0..9 (10), zeros in the
// other lanes, summed by one thread in the butterfly's association order:
// offset 16 adds each lane's zero partner, offset 8 pairs lanes 0, 1 with 8,
// 9, and offsets 4, 2, 1 form the tree below. Adding +0.0 is exact but for a
// zero's sign: the butterfly's sum is never -0, which the closing + 0.f
// gives here too, so both hold the same bits.
__device__ __forceinline__ float thread_sum8(const float (&v)[8]) {
  return (((v[0] + v[4]) + (v[2] + v[6])) + ((v[1] + v[5]) + (v[3] + v[7]))) + 0.f;
}
__device__ __forceinline__ float thread_sum10(const float (&v)[10]) {
  const float s0 = v[0] + v[8], s1 = v[1] + v[9];
  return (((s0 + v[4]) + (v[2] + v[6])) + ((s1 + v[5]) + (v[3] + v[7]))) + 0.f;
}

// eight_schools_dc for one thread's chain, the layout [z(8), mu, log_tau] in
// ten registers; u and s are y and 1/sigma^2. The same operations in the same
// order, so the same bits.
__device__ __forceinline__ float eight_schools_thread(const float (&u)[8], const float (&s)[8],
                                                      const float (&x)[10], float (&g)[10]) {
  const float mu = x[8], log_tau = x[9];
  const float tau = expf(log_tau);
  float resid[8], r[8], zz[8], rr[8], rz[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    resid[i] = u[i] - mu - tau * x[i];
    r[i] = resid[i] * s[i];
    zz[i] = x[i] * x[i];
    rr[i] = resid[i] * r[i];
    rz[i] = r[i] * x[i];
  }
  const float z2 = thread_sum8(zz), r2 = thread_sum8(rr);
  const float r_sum = thread_sum8(r), rzs = thread_sum8(rz);
  float lp = -0.02f * (mu * mu) - 0.02f * (log_tau * log_tau);
  lp = lp + -0.5f * z2;
  lp = lp + -0.5f * r2;
#pragma unroll
  for (int i = 0; i < 8; ++i) g[i] = -x[i] + r[i] * tau;
  g[8] = -0.04f * mu + r_sum;
  g[9] = -0.04f * log_tau + tau * rzs;
  return lp;
}

// ---- the fused kernels' logistic regression (fused_leapfrog.py:353-382) ----

// The per-warp form, which the older NUTS machine (csrc/fused_nuts.cu) takes:
// its chains sit at different leaves of different trees.

// grad_tile: X^T (y - sigmoid(X w)) - w / s^2
template <int N>
__device__ void logreg_grad(const MatrixData& m, const float (&w)[N], float (&g)[N], int lane,
                            float* scratch) {
  stage<N>(scratch, w, lane);
  float gl[N] = {};
  row_pass<true>(m, scratch, scratch + 3 * N * 32, lane, gl,
                    [&](int n, float q) { return m.u[n] - sigmoid(q); });
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int j = k * 32 + lane;
    g[k] = j < m.cols ? gl[k] - m.k[0] * w[k] : 0.f;
  }
}

// logdensity_tile: sum_n (y q - logaddexp(0, q)) - 0.5 |w|^2 / s^2
template <int N>
__device__ float logreg_logdensity(const MatrixData& m, const float (&w)[N], int lane,
                                   float* scratch) {
  stage<N>(scratch, w, lane);
  float unused[N] = {};
  float ll = 0.f;
  row_pass<false>(m, scratch, nullptr, lane, unused, [&](int n, float q) {
    ll += m.u[n] * q - logaddexp(0.f, q);
    return 0.f;
  });
  float ww = 0.f;
#pragma unroll
  for (int k = 0; k < N; ++k) ww += w[k] * w[k];
  return warp_sum(ll) + m.k[1] * warp_sum(ww);
}

// The tiles form, which the fused leapfrog and MCLMC kernels take: their
// chains all run the same stages in the same order (no tree, no accept
// step, no early exit), so the kFusedChainsLR warps of a block meet at every
// gradient at no cost, and logreg_tiles computes it for all of them, each
// tile of X read from L2 once a gradient for the block instead of twice for
// each chain. Chains a block and rows a tile at most, picked by measurement
// (fused_logreg_tiles.py: PERF.md §6); the wrappers read the layout from
// the leapfrog's library (bjt_fused_tiles_layout).
constexpr int kFusedChainsLR = 16;
constexpr int kFusedTileRowsLR = 256;

// chains a block of the fused kernels, one warp each: kFusedWarps for the
// analytic targets, kFusedChainsLR in the tiles form
constexpr int kFusedWarps = 4;
template <int F>
__host__ __device__ constexpr int fused_block_warps() {
  return F == kLogisticRegression ? kFusedChainsLR : kFusedWarps;
}

template <int N>
__host__ __device__ constexpr int fused_lr_tile_rows() {
  return kFusedTileRowsLR < lr_tile_rows<N, kFusedChainsLR>() ? kFusedTileRowsLR
                                                               : lr_tile_rows<N, kFusedChainsLR>();
}

// bytes of a block's dynamic shared memory in the tiles form
template <int N>
__host__ __device__ constexpr size_t fused_lr_block_bytes(int cols) {
  return (size_t)lr_tiles_floats<N, kFusedChainsLR, fused_lr_tile_rows<N>()>(cols) *
         sizeof(float);
}

// the tiles form's layout for a d-column X, for the wrapper's checks:
// out[0] chains a block, out[1] rows a tile, out[2] bytes of shared memory a
// block; returns -1 where no instantiation takes d
template <int N>
void fused_lr_layout_n(int d, long long* out) {
  out[0] = kFusedChainsLR;
  out[1] = fused_lr_tile_rows<N>();
  out[2] = (long long)fused_lr_block_bytes<N>(d);
}
inline int fused_lr_layout(int d, long long* out) {
  const int n = (d + 31) / 32;
  if (d < 1 || n > 8) return -1;
  if (n <= 1) fused_lr_layout_n<1>(d, out);
  else if (n <= 2) fused_lr_layout_n<2>(d, out);
  else if (n <= 4) fused_lr_layout_n<4>(d, out);
  else fused_lr_layout_n<8>(d, out);
  return 0;
}

// The fused kernels' target dispatch: F = 0 for the analytic targets
// (hierarchical or Gaussian, chosen at run time), F = kLogisticRegression in
// the per-warp form (scratch: the warp's) or, kTiles, in the tiles form
// (scratch: the block's shared memory; every warp of the block calls it at
// the same point).
template <int N, int F, bool kTiles = false, class P>
__device__ __forceinline__ void target_grad(const P& p, const float (&x)[N],
                                            const float (&iv)[N], float (&g)[N], int lane,
                                            float* scratch) {
  if constexpr (F == kLogisticRegression && kTiles) {
    logreg_tiles<N, kFusedChainsLR, kTilesGrad, fused_lr_tile_rows<N>()>(p.mat, x, g, lane,
                                                                          scratch);
  } else if constexpr (F == kLogisticRegression) {
    logreg_grad<N>(p.mat, x, g, lane, scratch);
  } else {
    grad<N>(p, x, iv, g, lane);
  }
}

template <int N, int F, bool kTiles = false, class P>
__device__ __forceinline__ float target_logdensity(const P& p, const float (&x)[N],
                                                   const float (&iv)[N], int lane,
                                                   float* scratch) {
  if constexpr (F == kLogisticRegression && kTiles) {
    float unused[N];
    return logreg_tiles<N, kFusedChainsLR, kTilesValue, fused_lr_tile_rows<N>()>(
        p.mat, x, unused, lane, scratch);
  } else if constexpr (F == kLogisticRegression) {
    return logreg_logdensity<N>(p.mat, x, lane, scratch);
  } else {
    return logdensity<N>(p, x, iv, lane);
  }
}

}  // namespace
