// The CG step of the whole-map bundle adjustment (optim/global_ba.py): the
// observation half of H·v, its pose sums, the block-Jacobi preconditioner's
// apply, and the step's vector updates around it.
//
// Replaces no Pallas kernel: the JAX package left these products to XLA
// (orb_slam3_rgbl_tpu/optim/global_ba.py, H_apply / precond), and the port
// first wrote them as torch.einsum, which cuBLAS runs as strided-batched gemv,
// one warp-sized matrix-vector product per (M, D) slot. Plain PyTorch
// versions: ops/gba_cuda.py hv_plain, precond_plain, cg_update_plain and
// cg_direction_plain.
//
// What bounds it on an H100: bytes. A CG step's least traffic is the live
// slots' Jacobians (3x6 + 3x3 floats, 108 B), their weight and keyframe index,
// the weights of all slots, the pose table and the vectors: ~45 MB at the
// KITTI cell's 1,048,576 slots (333,253 live), ~14 us at 3.35 TB/s. The
// arithmetic is ~110 fp32 operations a live slot: nothing near the card's
// compute, and no use for tensor cores.
//
// Design.
// gba_hv_kernel, landmark-major: a 256-thread block owns the D slots of each
// of its `lpb` landmarks, a contiguous stretch of the (M, D, 3, 6) and
// (M, D, 3, 3) arrays. It reads the weights of its slots, then stages the
// Jacobians in shared memory with 16-byte loads, loading a 16-byte chunk
// only where one of the (at most two) slots it touches has w != 0: a masked
// slot's Jacobians are not read. Thread t then owns slot t: Jv = Jp v_p[kf]
// + Jl v_l, u = w Jv, its pose partial Jp^T u goes to `part`, and its
// landmark partial Jl^T u to shared memory. A slot with w == 0 writes no
// partial and adds an exact zero to its landmark, as 0 * (finite J) does in
// the plain version. One thread a landmark then adds its D partials in slot
// order and finishes the landmark half, (sum + lam_l v_l) * lm_free, and the
// block writes its landmarks' share of v_l . Hv_l, reduced in a fixed
// pattern, to `dot_part`.
// gba_pose_sum_kernel: block k adds the partials of pose k in the order of
// its row of the PoseSegments table (each thread a strided subset, then a
// fixed shuffle tree and the warps in order); an entry past the observation
// count (the table's sentinel) or with w == 0 is skipped by a test. One more
// block adds the landmark blocks' dot partials in order. No atomics: two
// solves of one problem give the same bits.
// gba_cg_update_kernel: one thread a 6x6 pose block or a 3x3 landmark block
// of the preconditioner, fused with the step's updates before it: alpha =
// rz / pAp, x + alpha p, r - alpha Ap, then z = Minv r. Without p (the PCG
// set-up, once a linearization) it applies Minv to r alone. And
// gba_cg_direction_kernel: beta = rz_new / rz, z + beta p. They read alpha
// and beta from the card, so nothing waits for the device, and round each
// product and sum once, as the separate PyTorch operations they replace do:
// the same bits.
//
// The whole-map inertial solve (optim/global_inertial_ba.py) runs the same
// kernels on 15-wide states [pose(6), vel(3), bg(3), ba(3)]: gba_hv reads the
// pose columns 0:6 of each state's row (its stride a runtime argument),
// gba_pose_sum is unchanged, and gba_cg_update / gba_cg_direction are
// templated over the state width (6 or 15; the 6-wide code is as it was).
// gba_pair_hv_kernel adds the inertial pairs' half of H·v: one block of
// PAIR_THREADS threads. First u = W (J1 v_i + J2 v_j) for each pair's 15
// rows (a thread a row: the 30 products added in column order), then each
// state's 15 outputs (a thread an output): the visual pose sum (columns 0:6),
// the pair terms J_side^T u in the order of the state's row of the sorted
// pair table, lam * v, the state mask; and the dot product v . Hv over the
// states (a thread's outputs in order, a shuffle tree, the warps in order)
// plus the landmark half from gba_pose_sum. Every product and sum is rounded
// once (__fmul_rn / __fadd_rn), so the plain version in ops/gba_cuda.py
// (pair_hv_plain) gives the same bits. The pairs' Jacobians (15 x 30 floats,
// 1.8 KB a pair) stay in L2 from the linearization: ~360 KB for 198 pairs.
//
// D (observations a landmark) is a runtime argument, up to MAX_D.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;            // threads of every block; slots of an H·v tile
constexpr int PAIR_THREADS = 1024;      // threads of the one gba_pair_hv block
constexpr int NS = 15;                  // width of an inertial state
constexpr int NJ = 2 * NS;              // columns of a pair's Jacobian (both states)
constexpr int MAX_D = THREADS;          // most slots a landmark (one landmark a tile)
constexpr int JP = 18;                  // floats of a slot's pose Jacobian (3x6)
constexpr int JL = 9;                   // floats of a slot's landmark Jacobian (3x3)
constexpr unsigned FULL = 0xffffffffu;

// Copies the `ns` slots' blocks of W floats at src[off ..] into dst, for the
// slots whose weight in sw is non-zero: 16 bytes a thread where src + off is
// 16-byte aligned, one float a thread otherwise and in the tail. dst is
// 16-byte aligned shared memory.
template <int W>
__device__ __forceinline__ void stage_live(const float* __restrict__ src, long long off, int ns,
                                           const float* sw, float* dst) {
  const int n = ns * W;
  const float* s = src + off;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(s) & 15) == 0) {
    const int n4 = n >> 2;
    const float4* s4 = reinterpret_cast<const float4*>(s);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int c = threadIdx.x; c < n4; c += THREADS) {
      const int f = 4 * c;
      if (sw[f / W] != 0.f || sw[(f + 3) / W] != 0.f) d4[c] = __ldg(s4 + c);
    }
    done = 4 * n4;
  }
  for (int f = done + threadIdx.x; f < n; f += THREADS)
    if (sw[f / W] != 0.f) dst[f] = __ldg(s + f);
}

// The sum of v over a block of T threads, the same on every thread of warp 0
// and in a fixed order: a shuffle tree in each warp, then the warps in order.
template <int T = THREADS>
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < T / 32; ++i) s += red[i];
  return s;
}

__global__ void __launch_bounds__(THREADS)
gba_hv_kernel(const float* __restrict__ Jp, const float* __restrict__ Jl,
              const float* __restrict__ w, const long long* __restrict__ obs_kf,
              const float* __restrict__ v_p, const float* __restrict__ v_l,
              const float* __restrict__ lam_l, const unsigned char* __restrict__ lm_free,
              float* __restrict__ Hv_l, float* __restrict__ part, float* __restrict__ dot_part,
              int M, int D, int lpb, int vp_stride) {
  __shared__ __align__(16) float sJp[THREADS * JP];
  __shared__ __align__(16) float sJl[THREADS * JL];
  __shared__ float sw[THREADS];
  __shared__ float sL[THREADS * 3];
  __shared__ float red[THREADS / 32];

  const int t = threadIdx.x;
  const long long m0 = (long long)blockIdx.x * lpb;
  const long long left = (long long)M - m0;
  const int nl = left <= 0 ? 0 : (left < lpb ? (int)left : lpb);   // landmarks here
  const int ns = nl * D;                                            // slots here
  const long long s0 = m0 * D;

  sw[t] = t < ns ? __ldg(w + s0 + t) : 0.f;
  __syncthreads();
  stage_live<JP>(Jp, s0 * JP, ns, sw, sJp);
  stage_live<JL>(Jl, s0 * JL, ns, sw, sJl);
  __syncthreads();

  float lx = 0.f, ly = 0.f, lz = 0.f;
  const float ws = sw[t];
  if (t < ns && ws != 0.f) {
    const long long s = s0 + t;
    const long long m = m0 + t / D;
    const float* jp = sJp + t * JP;
    const float* jl = sJl + t * JL;
    const float* vp = v_p + (long long)vp_stride * __ldg(obs_kf + s);
    float p[6], q[3], u[3];
#pragma unroll
    for (int j = 0; j < 6; ++j) p[j] = __ldg(vp + j);
#pragma unroll
    for (int j = 0; j < 3; ++j) q[j] = __ldg(v_l + 3 * m + j);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      float a = 0.f, b = 0.f;
#pragma unroll
      for (int j = 0; j < 6; ++j) a = fmaf(jp[6 * i + j], p[j], a);
#pragma unroll
      for (int j = 0; j < 3; ++j) b = fmaf(jl[3 * i + j], q[j], b);
      u[i] = ws * (a + b);
    }
    float* out = part + 6 * s;
#pragma unroll
    for (int j = 0; j < 6; ++j)
      out[j] = fmaf(jp[12 + j], u[2], fmaf(jp[6 + j], u[1], jp[j] * u[0]));
    lx = fmaf(jl[6], u[2], fmaf(jl[3], u[1], jl[0] * u[0]));
    ly = fmaf(jl[7], u[2], fmaf(jl[4], u[1], jl[1] * u[0]));
    lz = fmaf(jl[8], u[2], fmaf(jl[5], u[1], jl[2] * u[0]));
  }
  sL[3 * t] = lx;
  sL[3 * t + 1] = ly;
  sL[3 * t + 2] = lz;
  __syncthreads();

  float d = 0.f;
  if (t < nl) {
    const long long m = m0 + t;
    float h[3] = {0.f, 0.f, 0.f};
    for (int k = 0; k < D; ++k) {
      const float* l = sL + 3 * (t * D + k);
      h[0] += l[0];
      h[1] += l[1];
      h[2] += l[2];
    }
    const float f = lm_free[m] ? 1.f : 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float v = __ldg(v_l + 3 * m + c);
      // (Hl + lam_l * v_l) * lm_free, each operation rounded as in the plain version
      const float hv = __fmul_rn(__fadd_rn(h[c], __fmul_rn(__ldg(lam_l + 3 * m + c), v)), f);
      Hv_l[3 * m + c] = hv;
      d = fmaf(v, hv, d);
    }
  }
  const float total = block_sum(d, red);
  if (t == 0) dot_part[blockIdx.x] = total;
}

__global__ void __launch_bounds__(THREADS)
gba_pose_sum_kernel(const float* __restrict__ part, const float* __restrict__ w,
                    const long long* __restrict__ table, int K, int L, long long n_obs,
                    const float* __restrict__ dot_part, int nb, float* __restrict__ Hp,
                    float* __restrict__ lm_half) {
  __shared__ float red[6][THREADS / 32];
  const int k = blockIdx.x, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (k < K) {
    const long long* row = table + (long long)k * L;
    for (int j = t; j < L; j += THREADS) {
      const long long idx = __ldg(row + j);
      if (idx >= 0 && idx < n_obs && __ldg(w + idx) != 0.f) {
        const float2* p = reinterpret_cast<const float2*>(part + 6 * idx);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float2 v = p[c];
          acc[2 * c] += v.x;
          acc[2 * c + 1] += v.y;
        }
      }
    }
  } else {
    for (int j = t; j < nb; j += THREADS) acc[0] += __ldg(dot_part + j);
  }
#pragma unroll
  for (int c = 0; c < 6; ++c) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc[c] += __shfl_xor_sync(FULL, acc[c], o);
    if (lane == 0) red[c][warp] = acc[c];
  }
  __syncthreads();
  if (t < 6) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < THREADS / 32; ++i) s += red[t][i];
    if (k < K) Hp[6 * k + t] = s;
    else if (t == 0) lm_half[0] = s;
  }
}

// z = (A v) * (free ? 1 : 0) for one row-major N x N block A.
template <int N>
__device__ __forceinline__ void block_apply(const float* __restrict__ A, const float* v, bool free,
                                            float* __restrict__ z) {
  const float f = free ? 1.f : 0.f;
#pragma unroll
  for (int r = 0; r < N; ++r) {
    float a = 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j) a = fmaf(__ldg(A + N * r + j), v[j], a);
    z[r] = a * f;
  }
}

// num / den.clamp_min(1e-20) as PyTorch computes it: a NaN stays NaN, the
// division is IEEE's.
__device__ __forceinline__ float cg_ratio(const float* num, const float* den) {
  const float d = __ldg(den);
  return __fdiv_rn(__ldg(num), d < 1e-20f ? 1e-20f : d);
}

// Block b of N values of the CG update: x + alpha p, r - alpha Ap, and the
// preconditioner's apply to the new r; each product and sum rounded once,
// as PyTorch's separate operations round them. With `step` false, the apply
// to r alone: x, p, Ap, xo and ro may then be null, and are not touched.
template <int N>
__device__ __forceinline__ void update_block(long long b, bool step, float alpha,
                                             const float* __restrict__ x,
                                             const float* __restrict__ r,
                                             const float* __restrict__ p,
                                             const float* __restrict__ Ap,
                                             const float* __restrict__ Minv,
                                             const unsigned char* __restrict__ free,
                                             float* __restrict__ xo, float* __restrict__ ro,
                                             float* __restrict__ z) {
  const long long o = N * b;
  float rn[N];
#pragma unroll
  for (int j = 0; j < N; ++j) rn[j] = __ldg(r + o + j);
  if (step) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      xo[o + j] = __fadd_rn(__ldg(x + o + j), __fmul_rn(alpha, __ldg(p + o + j)));
      rn[j] = __fsub_rn(rn[j], __fmul_rn(alpha, __ldg(Ap + o + j)));
      ro[o + j] = rn[j];
    }
  }
  block_apply<N>(Minv + N * N * b, rn, free[b], z + o);
}

template <int NP>
__global__ void __launch_bounds__(THREADS)
gba_cg_update_kernel(const float* __restrict__ Minv_p, const float* __restrict__ Minv_l,
                     const unsigned char* __restrict__ pose_free,
                     const unsigned char* __restrict__ lm_free, const float* __restrict__ rz,
                     const float* __restrict__ pAp, const float* __restrict__ x_p,
                     const float* __restrict__ x_l, const float* __restrict__ r_p,
                     const float* __restrict__ r_l, const float* __restrict__ p_p,
                     const float* __restrict__ p_l, const float* __restrict__ Ap_p,
                     const float* __restrict__ Ap_l, float* __restrict__ xo_p,
                     float* __restrict__ xo_l, float* __restrict__ ro_p,
                     float* __restrict__ ro_l, float* __restrict__ z_p,
                     float* __restrict__ z_l, int K, int M) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  const bool step = p_p != nullptr;
  const float alpha = step ? cg_ratio(rz, pAp) : 0.f;
  if (i < K)
    update_block<NP>(i, step, alpha, x_p, r_p, p_p, Ap_p, Minv_p, pose_free, xo_p, ro_p, z_p);
  else if (i - K < M)
    update_block<3>(i - K, step, alpha, x_l, r_l, p_l, Ap_l, Minv_l, lm_free, xo_l, ro_l, z_l);
}

// The new search direction z + beta p, beta = rz_new / rz.clamp_min(1e-20),
// one value a thread over the pose (or state) half of NP a row, then the
// landmark half.
template <int NP>
__global__ void __launch_bounds__(THREADS)
gba_cg_direction_kernel(const float* __restrict__ rz_new, const float* __restrict__ rz,
                        const float* __restrict__ z_p, const float* __restrict__ z_l,
                        const float* __restrict__ p_p, const float* __restrict__ p_l,
                        float* __restrict__ po_p, float* __restrict__ po_l, int K, int M) {
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long np = (long long)NP * K;
  const float beta = cg_ratio(rz_new, rz);
  if (e < np) po_p[e] = __fadd_rn(__ldg(z_p + e), __fmul_rn(beta, __ldg(p_p + e)));
  else if (e - np < 3LL * M)
    po_l[e - np] = __fadd_rn(__ldg(z_l + e - np), __fmul_rn(beta, __ldg(p_l + e - np)));
}

// The inertial pairs' half of H·v on the 15-wide states, with the visual
// pose sums Hp (K x 6) added to columns 0:6, the damping lam * v and the
// state mask, and the dot product v . Hv + lm_half; one block (see the top
// of the file). J (P x 15 x 30) row-major, the first 15 columns the first
// state's; w (P x 15); table (K x Lp) entries 2 * pair + side, an entry
// outside [0, 2P) skipped; u (P x 15) scratch.
__global__ void __launch_bounds__(PAIR_THREADS)
gba_pair_hv_kernel(const float* __restrict__ Hp, const float* __restrict__ J,
                   const float* __restrict__ w, const long long* __restrict__ pair_i,
                   const long long* __restrict__ pair_j, const long long* __restrict__ table,
                   const float* __restrict__ v, const float* __restrict__ lam,
                   const unsigned char* __restrict__ free, const float* __restrict__ lm_half,
                   float* __restrict__ u, float* __restrict__ Hv, float* __restrict__ pAp, int K,
                   int P, int Lp) {
  __shared__ float red[PAIR_THREADS / 32];
  const int t = threadIdx.x;
  const long long rows = (long long)P * NS;
  for (long long e = t; e < rows; e += PAIR_THREADS) {
    const long long p = e / NS;
    const float* row = J + e * NJ;
    const float* vi = v + NS * __ldg(pair_i + p);
    const float* vj = v + NS * __ldg(pair_j + p);
    float a = 0.f;
#pragma unroll
    for (int c = 0; c < NS; ++c) a = __fadd_rn(a, __fmul_rn(__ldg(row + c), __ldg(vi + c)));
#pragma unroll
    for (int c = 0; c < NS; ++c) a = __fadd_rn(a, __fmul_rn(__ldg(row + NS + c), __ldg(vj + c)));
    u[e] = __fmul_rn(__ldg(w + e), a);
  }
  __syncthreads();
  const long long outs = (long long)K * NS;
  const long long n_entries = 2LL * P;
  float d = 0.f;
  for (long long e = t; e < outs; e += PAIR_THREADS) {
    const long long k = e / NS;
    const int c = (int)(e - k * NS);
    float acc = c < 6 ? __ldg(Hp + 6 * k + c) : 0.f;
    for (int l = 0; l < Lp; ++l) {
      const long long q = __ldg(table + k * Lp + l);
      if (q < 0 || q >= n_entries) continue;
      const long long p = q >> 1;
      const float* col = J + p * NS * NJ + (q & 1) * NS + c;
      const float* up = u + p * NS;
      float h = 0.f;
#pragma unroll
      for (int r = 0; r < NS; ++r) h = __fadd_rn(h, __fmul_rn(__ldg(col + r * NJ), up[r]));
      acc = __fadd_rn(acc, h);
    }
    const float vv = __ldg(v + e);
    const float hv = __fmul_rn(__fadd_rn(acc, __fmul_rn(__ldg(lam + e), vv)), free[k] ? 1.f : 0.f);
    Hv[e] = hv;
    d = __fadd_rn(d, __fmul_rn(vv, hv));
  }
  const float total = block_sum<PAIR_THREADS>(d, red);
  if (t == 0) pAp[0] = __fadd_rn(total, __ldg(lm_half));
}

}  // namespace

extern "C" int gba_hv_f32(const float* Jp, const float* Jl, const float* w,
                          const long long* obs_kf, const float* v_p, const float* v_l,
                          const float* lam_l, const unsigned char* lm_free, float* Hv_l,
                          float* part, float* dot_part, int M, int D, int lpb, int nb,
                          int vp_stride, cudaStream_t stream) {
  if (D < 1 || D > MAX_D || lpb < 1 || lpb * D > THREADS || nb < 1 || vp_stride < 6)
    return cudaErrorInvalidValue;
  gba_hv_kernel<<<nb, THREADS, 0, stream>>>(Jp, Jl, w, obs_kf, v_p, v_l, lam_l, lm_free, Hv_l,
                                           part, dot_part, M, D, lpb, vp_stride);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gba_pose_sum_f32(const float* part, const float* w, const long long* table, int K,
                                int L, long long n_obs, const float* dot_part, int nb, float* Hp,
                                float* lm_half, cudaStream_t stream) {
  gba_pose_sum_kernel<<<K + 1, THREADS, 0, stream>>>(part, w, table, K, L, n_obs, dot_part, nb,
                                                     Hp, lm_half);
  return static_cast<int>(cudaGetLastError());
}

static int grid_for(long long n) { return (int)((n + THREADS - 1) / THREADS); }

// z = Minv r after the step's updates; with p_p null (then rz, pAp, x, p, Ap,
// xo and ro may be null too) z = Minv r of the r given: the PCG set-up.
// `width`: the pose (6) or inertial state (15) block's size.
extern "C" int gba_cg_update_f32(const float* Minv_p, const float* Minv_l,
                                 const unsigned char* pose_free, const unsigned char* lm_free,
                                 const float* rz, const float* pAp, const float* x_p,
                                 const float* x_l, const float* r_p, const float* r_l,
                                 const float* p_p, const float* p_l, const float* Ap_p,
                                 const float* Ap_l, float* xo_p, float* xo_l, float* ro_p,
                                 float* ro_l, float* z_p, float* z_l, int K, int M, int width,
                                 cudaStream_t stream) {
  if (width != 6 && width != NS) return cudaErrorInvalidValue;
  const int blocks = grid_for((long long)K + M);
  if (blocks < 1) return cudaSuccess;
  if (width == 6)
    gba_cg_update_kernel<6><<<blocks, THREADS, 0, stream>>>(
        Minv_p, Minv_l, pose_free, lm_free, rz, pAp, x_p, x_l, r_p, r_l, p_p, p_l, Ap_p, Ap_l,
        xo_p, xo_l, ro_p, ro_l, z_p, z_l, K, M);
  else
    gba_cg_update_kernel<NS><<<blocks, THREADS, 0, stream>>>(
        Minv_p, Minv_l, pose_free, lm_free, rz, pAp, x_p, x_l, r_p, r_l, p_p, p_l, Ap_p, Ap_l,
        xo_p, xo_l, ro_p, ro_l, z_p, z_l, K, M);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gba_cg_direction_f32(const float* rz_new, const float* rz, const float* z_p,
                                    const float* z_l, const float* p_p, const float* p_l,
                                    float* po_p, float* po_l, int K, int M, int width,
                                    cudaStream_t stream) {
  if (width != 6 && width != NS) return cudaErrorInvalidValue;
  const int blocks = grid_for((long long)width * K + 3LL * M);
  if (blocks < 1) return cudaSuccess;
  if (width == 6)
    gba_cg_direction_kernel<6><<<blocks, THREADS, 0, stream>>>(rz_new, rz, z_p, z_l, p_p, p_l,
                                                               po_p, po_l, K, M);
  else
    gba_cg_direction_kernel<NS><<<blocks, THREADS, 0, stream>>>(rz_new, rz, z_p, z_l, p_p, p_l,
                                                                po_p, po_l, K, M);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gba_pair_hv_f32(const float* Hp, const float* J, const float* w,
                               const long long* pair_i, const long long* pair_j,
                               const long long* table, const float* v, const float* lam,
                               const unsigned char* free, const float* lm_half, float* u, float* Hv,
                               float* pAp, int K, int P, int Lp, cudaStream_t stream) {
  if (K < 1 || P < 0 || Lp < 1) return cudaErrorInvalidValue;
  gba_pair_hv_kernel<<<1, PAIR_THREADS, 0, stream>>>(Hp, J, w, pair_i, pair_j, table, v, lam,
                                                     free, lm_half, u, Hv, pAp, K, P, Lp);
  return static_cast<int>(cudaGetLastError());
}
