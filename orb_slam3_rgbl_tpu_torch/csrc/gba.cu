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
// The LM iteration outside CG (the visual solve's linearization, gradient,
// preconditioner blocks and accept test). They replace no Pallas kernel
// either: the JAX package left these products to XLA, and the port ran them as
// PyTorch ops and cuBLAS batched gemm / gemv over every (M, D) slot, ~550
// launches an iteration. Plain PyTorch versions: optim/global_ba.py
// linearize_plain (both passes) and cost_plain; ops/gba_cuda.py
// apply_step_plain.
// What bounds them on an H100: bytes. A live observation reads ~25 B (its
// keyframe index, uv, uR, 1/sigma^2, mask; the pose and landmark from L2) and
// the linearization writes ~31 values of it (Jp 18, Jl 9, w r 3, w 1), which
// the pose pass reads back (22): ~45 MB at the EuRoC cell's 188,776 live of
// 262,144 slots, ~14 us at 3.35 TB/s. The arithmetic (~300 fp32 operations a
// live slot) is nothing near the card's compute.
// Design.
// gba_linearize_kernel, landmark-major like gba_hv: a block owns the D slots
// of each of its `lpb` landmarks and thread t slot t. A masked slot reads its
// mask and nothing else. fit_slot (shared with the cost pass) does what
// optim/local_ba._linearize does for one slot: T X, the projection (pinhole,
// with the five distortion terms, or KB8: the template parameter), the
// residual (u, v, uR), chi^2, the Huber weight, the active test and the
// capped cost term (1e7 for a slot behind its camera), each operation rounded
// once (__fmul_rn, __fadd_rn) in the order of the PyTorch code; then, for a
// slot of weight w != 0, Jp = -Jproj [I | -[pc]x] and Jl = -Jproj R (fmaf).
// The slots' Jp, Jl and w r go through shared memory and out in 16-byte
// stores, zeros for a slot of w = 0: no pass reads those, but no reader finds
// unwritten memory either (~26 us a linearization at the KITTI cell's 715k
// such slots, ~3 us at EuRoC's 74k). Every slot's w is written. One thread a landmark
// adds its D slots' Jl^T w r and w Jl^T Jl in slot order (g_l, masked by
// lm_free; Hll, 6 sums mirrored), and the block writes its partial cost and
// active count, reduced in a fixed pattern.
// gba_pose_blocks_kernel, pose-major like gba_pose_sum: block k walks its
// PoseSegments row, forms Jp^T (w r) (6) and (w Jp)^T Jp (21, mirrored) of
// each live slot in registers and adds them; no (M, D, 36) tensor is made. A
// last block adds the linearization's block partials of cost and count.
// The cost pass (the accept test's, and the final classification's) is
// gba_linearize_kernel without its Jacobians (the JAC template parameter):
// fit_slot alone, the same blocks and partials (and, for the final pass,
// chi^2 and the active mask of every slot); gba_pose_blocks_kernel with no
// pose then adds the partials as its last block does (sum_partials), so the
// accept test compares two costs rounded alike.
// gba_apply_step_kernel: the step's update, exp(dp) T renormalized a pose (a
// thread), X + dl a landmark value, in the PyTorch code's order with no
// batched 3x3 products. No atomics: two solves of one problem give the same bits.
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

// ---- the LM iteration outside CG ------------------------------------------

constexpr int PINHOLE = 0;          // camera models of fit_slot (the template parameter)
constexpr int PINHOLE_DISTORTED = 1;
constexpr int KB8 = 2;
constexpr int WR = 3;               // floats of a slot's w r

// The camera, as ops/gba_cuda.py camera_params lays it out: pinhole k =
// (k1, k2, p1, p2, k3), KB8 k = (k0, k1, k2, k3, 0); the Huber thresholds.
struct Camera {
  float fx, fy, cx, cy, bf;
  float k[5];
  float huber_stereo, huber_mono;
};

__device__ __forceinline__ float rmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float radd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float rsub(float a, float b) { return __fsub_rn(a, b); }

// a x b as lie._cross computes it.
__device__ __forceinline__ void cross_rn(const float* a, const float* b, float* c) {
  c[0] = rsub(rmul(a[1], b[2]), rmul(a[2], b[1]));
  c[1] = rsub(rmul(a[2], b[0]), rmul(a[0], b[2]));
  c[2] = rsub(rmul(a[0], b[1]), rmul(a[1], b[0]));
}

// v rotated by q = [w, x, y, z] as lie.quat_rotate does it: t = 2 (q_xyz x v),
// v + w t + q_xyz x t.
__device__ __forceinline__ void quat_rotate_rn(const float* q, const float* v, float* out) {
  float c[3], t[3], c2[3];
  cross_rn(q + 1, v, c);
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = rmul(2.f, c[i]);
  cross_rn(q + 1, t, c2);
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = radd(radd(v[i], rmul(q[0], t[i])), c2[i]);
}

// 1 / z with |z| held at `floor` (torch.where(z.abs() < floor, floor, z)).
__device__ __forceinline__ float inv_guarded(float z, float floor) {
  return __frcp_rn(fabsf(z) < floor ? floor : z);
}

// The KB8 polynomial r(theta) and dr/dtheta (geometry/camera._kb8_r, _kb8_dr).
__device__ __forceinline__ float kb8_r(const Camera& c, float th) {
  const float t2 = rmul(th, th);
  return rmul(th, radd(1.f, rmul(t2, radd(c.k[0], rmul(t2, radd(c.k[1],
              rmul(t2, radd(c.k[2], rmul(t2, c.k[3])))))))));
}
__device__ __forceinline__ float kb8_dr(const Camera& c, float th) {
  const float t2 = rmul(th, th);
  return radd(1.f, rmul(t2, radd(rmul(3.f, c.k[0]), rmul(t2, radd(rmul(5.f, c.k[1]),
              rmul(t2, radd(rmul(7.f, c.k[2]), rmul(rmul(t2, 9.f), c.k[3]))))))));
}

// One observation slot, as optim/local_ba._linearize computes it.
struct SlotFit {
  float pc[3];          // the landmark in the camera's frame
  float r[3];           // residual (u, v, uR); r[2] = 0 without a stereo row
  bool stereo;          // a uR row: obs_ur >= 0 and not a fisheye camera
  bool depth_ok;        // z > 1e-3: active (the slot is considered)
  float chi2, w_rob;
  float term;           // the cost: min(chi2, 1e7) w_rob, or 1e7 behind the camera
  float w;              // the weight: 1/sigma^2 w_rob where active, else 0
};

// The residual, weight and cost of a considered slot: pose T (7), landmark X,
// the observation (u, v, uR) and 1/sigma^2. Each operation rounded once, in
// the order of the PyTorch code. The one routine of the linearization and
// the cost pass: the accept test compares costs that both rounded alike.
template <int MODEL, bool HUBER>
__device__ __forceinline__ void fit_slot(const Camera& c, const float* __restrict__ T,
                                         const float* __restrict__ X, float2 uv, float ur,
                                         float is2, SlotFit& f) {
  float q[4], X3[3], rx[3];
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = __ldg(T + i);
#pragma unroll
  for (int i = 0; i < 3; ++i) X3[i] = __ldg(X + i);
  quat_rotate_rn(q, X3, rx);
#pragma unroll
  for (int i = 0; i < 3; ++i) f.pc[i] = radd(rx[i], __ldg(T + 4 + i));
  const float px = f.pc[0], py = f.pc[1], z = f.pc[2];
  float u, v;
  if constexpr (MODEL == KB8) {
    const float r = __fsqrt_rn(radd(radd(rmul(px, px), rmul(py, py)), 1e-18f));
    const float scale = __fdiv_rn(kb8_r(c, atan2f(r, z)), r);
    u = radd(rmul(rmul(c.fx, scale), px), c.cx);
    v = radd(rmul(rmul(c.fy, scale), py), c.cy);
  } else {
    const float iz = inv_guarded(z, 1e-9f);
    float x = rmul(px, iz), y = rmul(py, iz);
    if constexpr (MODEL == PINHOLE_DISTORTED) {
      const float k1 = c.k[0], k2 = c.k[1], p1 = c.k[2], p2 = c.k[3], k3 = c.k[4];
      const float r2 = radd(rmul(x, x), rmul(y, y));
      const float radial = radd(1.f, rmul(r2, radd(k1, rmul(r2, radd(k2, rmul(r2, k3))))));
      const float xd = radd(radd(rmul(x, radial), rmul(rmul(rmul(2.f, p1), x), y)),
                            rmul(p2, radd(r2, rmul(rmul(2.f, x), x))));
      const float yd = radd(radd(rmul(y, radial), rmul(p1, radd(r2, rmul(rmul(2.f, y), y)))),
                            rmul(rmul(rmul(2.f, p2), x), y));
      x = xd;
      y = yd;
    }
    u = radd(rmul(c.fx, x), c.cx);
    v = radd(rmul(c.fy, y), c.cy);
  }
  f.stereo = MODEL != KB8 && ur >= 0.f;
  f.r[0] = rsub(uv.x, u);
  f.r[1] = rsub(uv.y, v);
  f.r[2] = f.stereo ? rsub(ur, rsub(u, rmul(c.bf, inv_guarded(z, 1e-6f)))) : 0.f;
  f.chi2 = rmul(radd(radd(rmul(f.r[0], f.r[0]), rmul(f.r[1], f.r[1])), rmul(f.r[2], f.r[2])),
                is2);
  f.w_rob = 1.f;
  if constexpr (HUBER) {
    const float delta = f.stereo ? c.huber_stereo : c.huber_mono;
    const float e = __fsqrt_rn(f.chi2 < 1e-12f ? 1e-12f : f.chi2);   // NaN stays NaN
    f.w_rob = e > delta ? __fdiv_rn(delta, e) : 1.f;
  }
  f.depth_ok = z > 1e-3f;
  f.term = f.depth_ok ? rmul(f.chi2 > 1e7f ? 1e7f : f.chi2, f.w_rob) : 1e7f;
  f.w = f.depth_ok ? rmul(is2, f.w_rob) : 0.f;
}

// Jp (3 x 6) and Jl (3 x 3) of a fitted slot: d(u, v, uR)/d(pc) (the pinhole's
// distortion-free form, or KB8's), then -Jproj [I | -[pc]x] and -Jproj R; the
// uR row zero without a stereo row.
template <int MODEL>
__device__ __forceinline__ void slot_jacobians(const Camera& c, const float* q, const SlotFit& f,
                                               float* jp, float* jl) {
  const float x = f.pc[0], y = f.pc[1], z = f.pc[2];
  float a[3][3];
  if constexpr (MODEL == KB8) {
    const float x2 = rmul(x, x), y2 = rmul(y, y);
    const float rr = radd(radd(x2, y2), 1e-18f);
    const float r = __fsqrt_rn(rr);
    const float th = atan2f(r, z);
    const float d = kb8_r(c, th), dd = kb8_dr(c, th);
    const float fz = radd(rr, rmul(z, z));
    const float al = __fdiv_rn(rmul(dd, z), rmul(rr, fz));
    const float be = __fdiv_rn(d, rmul(r, rr));
    const float xy = rmul(rmul(x, y), rsub(al, be));
    a[0][0] = rmul(c.fx, radd(rmul(al, x2), rmul(be, radd(y2, 1e-18f))));
    a[0][1] = rmul(c.fx, xy);
    a[0][2] = __fdiv_rn(rmul(rmul(-c.fx, dd), x), fz);
    a[1][0] = rmul(c.fy, xy);
    a[1][1] = rmul(c.fy, radd(rmul(al, y2), rmul(be, radd(x2, 1e-18f))));
    a[1][2] = __fdiv_rn(rmul(rmul(-c.fy, dd), y), fz);
  } else {
    const float iz = inv_guarded(z, 1e-9f);
    const float iz2 = rmul(iz, iz);
    a[0][0] = rmul(c.fx, iz);
    a[0][1] = 0.f;
    a[0][2] = rmul(rmul(-c.fx, x), iz2);
    a[1][0] = 0.f;
    a[1][1] = rmul(c.fy, iz);
    a[1][2] = rmul(rmul(-c.fy, y), iz2);
  }
  const float iz6 = inv_guarded(z, 1e-6f);
  a[2][0] = a[0][0];
  a[2][1] = a[0][1];
  a[2][2] = radd(a[0][2], rmul(rmul(c.bf, iz6), iz6));
  // R of q (lie.quat_to_matrix)
  const float w = q[0], qx = q[1], qy = q[2], qz = q[3];
  const float xx = qx * qx, yy = qy * qy, zz = qz * qz;
  const float wx = w * qx, wy = w * qy, wz = w * qz;
  const float xy = qx * qy, xz = qx * qz, yz = qy * qz;
  const float R[3][3] = {{1.f - 2.f * (yy + zz), 2.f * (xy - wz), 2.f * (xz + wy)},
                         {2.f * (xy + wz), 1.f - 2.f * (xx + zz), 2.f * (yz - wx)},
                         {2.f * (xz - wy), 2.f * (yz + wx), 1.f - 2.f * (xx + yy)}};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    if (i == 2 && !f.stereo) {
#pragma unroll
      for (int j = 0; j < 6; ++j) jp[12 + j] = 0.f;
#pragma unroll
      for (int j = 0; j < 3; ++j) jl[6 + j] = 0.f;
      continue;
    }
    const float a0 = a[i][0], a1 = a[i][1], a2 = a[i][2];
    jp[6 * i + 0] = -a0;
    jp[6 * i + 1] = -a1;
    jp[6 * i + 2] = -a2;
    jp[6 * i + 3] = fmaf(a1, z, -(a2 * y));
    jp[6 * i + 4] = fmaf(a2, x, -(a0 * z));
    jp[6 * i + 5] = fmaf(a0, y, -(a1 * x));
#pragma unroll
    for (int j = 0; j < 3; ++j) jl[3 * i + j] = -fmaf(a2, R[2][j], fmaf(a1, R[1][j], a0 * R[0][j]));
  }
}

// The sums of a float and an int over a block, in a fixed order (a shuffle
// tree in each warp, then the warps in order); the same on every thread.
__device__ __forceinline__ void block_sum2(float& v, int& n, float* red, int* redn) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v += __shfl_xor_sync(FULL, v, o);
    n += __shfl_xor_sync(FULL, n, o);
  }
  if (lane == 0) {
    red[warp] = v;
    redn[warp] = n;
  }
  __syncthreads();
  float s = 0.f;
  int m = 0;
#pragma unroll
  for (int i = 0; i < THREADS / 32; ++i) {
    s += red[i];
    m += redn[i];
  }
  v = s;
  n = m;
}

// The cost and active count of a linearization or an accept test from its
// nb blocks' partials, in one fixed order: thread t adds entries t, t +
// THREADS, ... in turn, then block_sum2: gba_pose_blocks' last block.
__device__ __forceinline__ void sum_partials(const float* __restrict__ cost_part,
                                             const int* __restrict__ count_part, int nb,
                                             float* red, int* redn, float* __restrict__ cost,
                                             long long* __restrict__ count) {
  float s = 0.f;
  int n = 0;
  for (int j = threadIdx.x; j < nb; j += THREADS) {
    s += __ldg(cost_part + j);
    n += __ldg(count_part + j);
  }
  block_sum2(s, n, red, redn);
  if (threadIdx.x == 0) {
    cost[0] = s;
    count[0] = n;
  }
}

// Copies the `ns` slots' blocks of W floats from shared memory src to
// dst[off ..]: 16-byte stores where dst + off is 16-byte aligned, one float a
// thread otherwise and in the tail.
template <int W>
__device__ __forceinline__ void store_tile(const float* src, int ns, float* __restrict__ dst,
                                           long long off) {
  const int n = ns * W;
  float* d = dst + off;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(d) & 15) == 0) {
    const int n4 = n >> 2;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(d);
    for (int c = threadIdx.x; c < n4; c += THREADS) d4[c] = s4[c];
    done = 4 * n4;
  }
  for (int f = done + threadIdx.x; f < n; f += THREADS) d[f] = src[f];
}

// The slots of a block of gba_linearize: landmarks m0 ..
// m0 + nl - 1, slots s0 .. s0 + ns - 1.
struct Tile {
  long long m0, s0;
  int nl, ns;
};

__device__ __forceinline__ Tile tile_of(int M, int D, int lpb) {
  Tile b;
  b.m0 = (long long)blockIdx.x * lpb;
  const long long left = (long long)M - b.m0;
  b.nl = left <= 0 ? 0 : (left < lpb ? (int)left : lpb);
  b.ns = b.nl * D;
  b.s0 = b.m0 * D;
  return b;
}

// Whether slot s of landmark m counts: its mask, then the landmark's and its
// keyframe's validity (a masked slot reads nothing more). kf: its keyframe.
__device__ __forceinline__ bool considered(long long s, long long m,
                                           const unsigned char* __restrict__ obs_mask,
                                           const long long* __restrict__ obs_kf,
                                           const unsigned char* __restrict__ lm_valid,
                                           const unsigned char* __restrict__ pose_valid,
                                           long long& kf) {
  if (!obs_mask[s]) return false;
  kf = __ldg(obs_kf + s);
  return lm_valid[m] && pose_valid[kf];
}

// JAC: the linearization (Jacobians, w r, g_l, Hll); without it the cost
// pass of the accept test and the final classification, fit_slot alone. Both
// write each block's partial cost and active count; with chi2 non-null also
// every slot's chi^2 (0 where not considered) and active mask.
template <int MODEL, bool HUBER, bool JAC>
__global__ void __launch_bounds__(THREADS)
gba_linearize_kernel(const float* __restrict__ poses, const float* __restrict__ lms,
                     const unsigned char* __restrict__ lm_valid,
                     const unsigned char* __restrict__ pose_valid,
                     const long long* __restrict__ obs_kf, const float* __restrict__ obs_uv,
                     const float* __restrict__ obs_ur, const float* __restrict__ obs_is2,
                     const unsigned char* __restrict__ obs_mask,
                     const unsigned char* __restrict__ lm_free, const Camera cam, int M, int D,
                     int lpb, float* __restrict__ Jp, float* __restrict__ Jl,
                     float* __restrict__ w, float* __restrict__ wr, float* __restrict__ g_l,
                     float* __restrict__ Hll, float* __restrict__ chi2,
                     unsigned char* __restrict__ active, float* __restrict__ cost_part,
                     int* __restrict__ count_part) {
  constexpr int TS = JAC ? THREADS : 1;  // the shared tiles, only where Jacobians are made
  __shared__ __align__(16) float sJp[TS * JP];
  __shared__ __align__(16) float sJl[TS * JL];
  __shared__ __align__(16) float sWr[TS * WR];
  __shared__ float sL[TS * 9];          // a slot's Jl^T w r (3) and w Jl^T Jl (6)
  __shared__ float red[THREADS / 32];
  __shared__ int redn[THREADS / 32];

  const int t = threadIdx.x;
  const Tile b = tile_of(M, D, lpb);
  float term = 0.f, ws = 0.f, c2 = 0.f;
  int act = 0;
  float lp[9];
  if constexpr (JAC) {
#pragma unroll
    for (int i = 0; i < 9; ++i) lp[i] = 0.f;
    // a slot of weight 0 writes zeros: nothing reads it, and nothing that does
    // finds unwritten memory
#pragma unroll
    for (int i = 0; i < JP; ++i) sJp[t * JP + i] = 0.f;
#pragma unroll
    for (int i = 0; i < JL; ++i) sJl[t * JL + i] = 0.f;
#pragma unroll
    for (int i = 0; i < WR; ++i) sWr[t * WR + i] = 0.f;
  }
  long long kf;
  if (t < b.ns && considered(b.s0 + t, b.m0 + t / D, obs_mask, obs_kf, lm_valid, pose_valid, kf)) {
    const long long s = b.s0 + t, m = b.m0 + t / D;
    const float* T = poses + 7 * kf;
    SlotFit f;
    fit_slot<MODEL, HUBER>(cam, T, lms + 3 * m, __ldg(reinterpret_cast<const float2*>(obs_uv) + s),
                           __ldg(obs_ur + s), __ldg(obs_is2 + s), f);
    term = f.term;
    act = f.depth_ok ? 1 : 0;
    ws = f.w;
    c2 = f.chi2;
    if constexpr (JAC) {
      if (ws != 0.f) {
        float q[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) q[i] = __ldg(T + i);
        float* jp = sJp + t * JP;
        float* jl = sJl + t * JL;
        slot_jacobians<MODEL>(cam, q, f, jp, jl);
        float u[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          u[i] = rmul(ws, f.r[i]);
          sWr[WR * t + i] = u[i];
        }
#pragma unroll
        for (int j = 0; j < 3; ++j)
          lp[j] = fmaf(jl[6 + j], u[2], fmaf(jl[3 + j], u[1], jl[j] * u[0]));
        int h = 3;
#pragma unroll
        for (int j = 0; j < 3; ++j)
#pragma unroll
          for (int k = j; k < 3; ++k, ++h)
            lp[h] = fmaf(ws * jl[6 + j], jl[6 + k], fmaf(ws * jl[3 + j], jl[3 + k],
                                                         (ws * jl[j]) * jl[k]));
      }
    }
  }
  if (chi2 != nullptr && t < b.ns) {
    chi2[b.s0 + t] = c2;
    active[b.s0 + t] = (unsigned char)act;
  }
  if constexpr (JAC) {
#pragma unroll
    for (int i = 0; i < 9; ++i) sL[9 * t + i] = lp[i];
    if (t < b.ns) w[b.s0 + t] = ws;
    __syncthreads();
    store_tile<JP>(sJp, b.ns, Jp, b.s0 * JP);
    store_tile<JL>(sJl, b.ns, Jl, b.s0 * JL);
    store_tile<WR>(sWr, b.ns, wr, b.s0 * WR);
    if (t < b.nl) {
      const long long m = b.m0 + t;
      float h[9];
#pragma unroll
      for (int i = 0; i < 9; ++i) h[i] = 0.f;
      for (int k = 0; k < D; ++k) {
        const float* l = sL + 9 * (t * D + k);
#pragma unroll
        for (int i = 0; i < 9; ++i) h[i] += l[i];
      }
      const float fr = lm_free[m] ? 1.f : 0.f;
#pragma unroll
      for (int i = 0; i < 3; ++i) g_l[3 * m + i] = rmul(h[i], fr);
      float* H = Hll + 9 * m;
      H[0] = h[3]; H[1] = h[4]; H[2] = h[5];
      H[3] = h[4]; H[4] = h[6]; H[5] = h[7];
      H[6] = h[5]; H[7] = h[7]; H[8] = h[8];
    }
  }
  block_sum2(term, act, red, redn);
  if (t == 0) {
    cost_part[blockIdx.x] = term;
    count_part[blockIdx.x] = act;
  }
}

// Block k < K: pose k's gradient Jp^T (w r) and block (w Jp)^T Jp, summed
// over the live entries of its PoseSegments row (each thread a strided
// subset, then a fixed shuffle tree and the warps in order). Block K: the
// linearization's cost and active count from gba_linearize's partials.
__global__ void __launch_bounds__(THREADS)
gba_pose_blocks_kernel(const float* __restrict__ Jp, const float* __restrict__ w,
                       const float* __restrict__ wr, const long long* __restrict__ table, int K,
                       int L, long long n_obs, const float* __restrict__ cost_part,
                       const int* __restrict__ count_part, int nb, float* __restrict__ g_p,
                       float* __restrict__ Hpp, float* __restrict__ cost,
                       long long* __restrict__ count) {
  constexpr int NA = 6 + 21;            // gradient, then the upper triangle row by row
  __shared__ float red[NA][THREADS / 32];
  __shared__ int redn[THREADS / 32];
  const int k = blockIdx.x, t = threadIdx.x;
  if (k == K) {
    sum_partials(cost_part, count_part, nb, red[0], redn, cost, count);
    return;
  }
  const int lane = t & 31, warp = t >> 5;
  float acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.f;
  const long long* row = table + (long long)k * L;
  for (int j = t; j < L; j += THREADS) {
    const long long idx = __ldg(row + j);
    if (idx < 0 || idx >= n_obs) continue;
    const float ws = __ldg(w + idx);
    if (ws == 0.f) continue;
    float jp[JP], u[3];
    const float2* p = reinterpret_cast<const float2*>(Jp + JP * idx);
#pragma unroll
    for (int c = 0; c < JP / 2; ++c) {
      const float2 v = __ldg(p + c);
      jp[2 * c] = v.x;
      jp[2 * c + 1] = v.y;
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) u[i] = __ldg(wr + WR * idx + i);
#pragma unroll
    for (int c = 0; c < 6; ++c)
      acc[c] += fmaf(jp[12 + c], u[2], fmaf(jp[6 + c], u[1], jp[c] * u[0]));
    int h = 6;
#pragma unroll
    for (int c = 0; c < 6; ++c)
#pragma unroll
      for (int e = c; e < 6; ++e, ++h)
        acc[h] += fmaf(ws * jp[12 + c], jp[12 + e],
                       fmaf(ws * jp[6 + c], jp[6 + e], (ws * jp[c]) * jp[e]));
  }
#pragma unroll
  for (int i = 0; i < NA; ++i) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc[i] += __shfl_xor_sync(FULL, acc[i], o);
    if (lane == 0) red[i][warp] = acc[i];
  }
  __syncthreads();
  if (t < NA) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < THREADS / 32; ++i) s += red[t][i];
    if (t < 6) {
      g_p[6 * k + t] = s;
    } else {
      int c = 0, h = t - 6;             // the upper-triangle entry (c, e) of index h
      while (h >= 6 - c) {
        h -= 6 - c;
        ++c;
      }
      const int e = c + h;
      Hpp[36 * k + 6 * c + e] = s;
      Hpp[36 * k + 6 * e + c] = s;
    }
  }
}

// Thread i < K: pose i moved by its step dp as lie.se3_normalize(lie.se3_mul(
// lie.se3_exp(dp), T)) computes it; then one landmark value X + dl a thread.
__global__ void __launch_bounds__(THREADS)
gba_apply_step_kernel(const float* __restrict__ dp, const float* __restrict__ poses,
                      const float* __restrict__ dl, const float* __restrict__ lms,
                      float* __restrict__ new_poses, float* __restrict__ new_lms, int K, int M) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= K) {
    const long long e = i - K;
    if (e < 3LL * M) new_lms[e] = radd(__ldg(lms + e), __ldg(dl + e));
    return;
  }
  float rho[3], om[3], T[7];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    rho[j] = __ldg(dp + 6 * i + j);
    om[j] = __ldg(dp + 6 * i + 3 + j);
  }
#pragma unroll
  for (int j = 0; j < 7; ++j) T[j] = __ldg(poses + 7 * i + j);
  // so3_exp and so3_left_jacobian share theta^2 and theta (lie._EPS = 1e-8)
  const float th2 = radd(radd(rmul(om[0], om[0]), rmul(om[1], om[1])), rmul(om[2], om[2]));
  const float th = __fsqrt_rn(radd(th2, 1e-16f));
  const bool small = th2 < 1e-8f;
  const float half = rmul(0.5f, th);
  const float kq = small ? rsub(0.5f, __fdiv_rn(th2, 48.f)) : __fdiv_rn(sinf(half), th);
  const float qe[4] = {small ? rsub(1.f, __fdiv_rn(th2, 8.f)) : cosf(half), rmul(kq, om[0]),
                       rmul(kq, om[1]), rmul(kq, om[2])};
  const float safe = small ? 1.f : th2;
  const float a = small ? rsub(0.5f, __fdiv_rn(th2, 24.f))
                        : __fdiv_rn(rsub(1.f, cosf(th)), safe);
  const float bcoef = small ? rsub(1.f / 6.f, __fdiv_rn(th2, 120.f))
                            : __fdiv_rn(rsub(th, sinf(th)), rmul(safe, th));
  const float W[3][3] = {{0.f, -om[2], om[1]}, {om[2], 0.f, -om[0]}, {-om[1], om[0], 0.f}};
  float te[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float w2 = 0.f;                   // (W W)[r][c]
#pragma unroll
      for (int k = 0; k < 3; ++k) w2 = fmaf(W[r][k], W[k][c], w2);
      const float J = radd(radd(r == c ? 1.f : 0.f, rmul(a, W[r][c])), rmul(bcoef, w2));
      acc = fmaf(J, rho[c], acc);
    }
    te[r] = acc;
  }
  // se3_mul: q = qe (x) q_T, t = qe . t_T + te; then q / |q|
  const float aw = qe[0], ax = qe[1], ay = qe[2], az = qe[3];
  const float bw = T[0], bx = T[1], by = T[2], bz = T[3];
  float q[4];
  q[0] = rsub(rsub(rsub(rmul(aw, bw), rmul(ax, bx)), rmul(ay, by)), rmul(az, bz));
  q[1] = rsub(radd(radd(rmul(aw, bx), rmul(ax, bw)), rmul(ay, bz)), rmul(az, by));
  q[2] = radd(radd(rsub(rmul(aw, by), rmul(ax, bz)), rmul(ay, bw)), rmul(az, bx));
  q[3] = radd(rsub(radd(rmul(aw, bz), rmul(ax, by)), rmul(ay, bx)), rmul(az, bw));
  float rt[3];
  quat_rotate_rn(qe, T + 4, rt);
  const float n = __fsqrt_rn(radd(radd(radd(rmul(q[0], q[0]), rmul(q[1], q[1])),
                                       rmul(q[2], q[2])), rmul(q[3], q[3])));
  float* out = new_poses + 7 * i;
#pragma unroll
  for (int j = 0; j < 4; ++j) out[j] = __fdiv_rn(q[j], n);
#pragma unroll
  for (int j = 0; j < 3; ++j) out[4 + j] = radd(rt[j], te[j]);
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

namespace {

// The template instance of a camera model (PINHOLE, PINHOLE_DISTORTED, KB8)
// and a Huber flag: launch(Model<m, h>{}); cudaErrorInvalidValue for another model.
template <int M_, bool H_>
struct Model {
  static constexpr int model = M_;
  static constexpr bool huber = H_;
};

template <typename F>
int by_model(int model, int huber, F launch) {
  switch (model) {
    case PINHOLE: huber ? launch(Model<PINHOLE, true>{}) : launch(Model<PINHOLE, false>{}); break;
    case PINHOLE_DISTORTED:
      huber ? launch(Model<PINHOLE_DISTORTED, true>{}) : launch(Model<PINHOLE_DISTORTED, false>{});
      break;
    case KB8: huber ? launch(Model<KB8, true>{}) : launch(Model<KB8, false>{}); break;
    default: return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

// The 12 floats of ops/gba_cuda.py camera_params: fx, fy, cx, cy, bf, the
// five distortion terms, the Huber thresholds (stereo, mono).
Camera camera_of(const float* p) {
  Camera c;
  c.fx = p[0];
  c.fy = p[1];
  c.cx = p[2];
  c.cy = p[3];
  c.bf = p[4];
  for (int i = 0; i < 5; ++i) c.k[i] = p[5 + i];
  c.huber_stereo = p[10];
  c.huber_mono = p[11];
  return c;
}

bool tiles_ok(int D, int lpb, int nb) {
  return D >= 1 && D <= MAX_D && lpb >= 1 && lpb * D <= THREADS && nb >= 1;
}

}  // namespace

// One pass over the visual whole-map problem's slots: nb blocks' cost and
// count partials; with `jacobians` also Jp, Jl and w r of the live slots, w
// of every slot, g_l and Hll (the linearization), without it none of those
// (the cost pass: they and lm_free may be null); with chi2 non-null each
// slot's chi^2 and active mask. `cam`: 12 floats on the host (camera_of);
// `model`: PINHOLE, PINHOLE_DISTORTED or KB8; `huber` 0 or 1.
extern "C" int gba_linearize_f32(const float* poses, const float* lms,
                                 const unsigned char* lm_valid, const unsigned char* pose_valid,
                                 const long long* obs_kf, const float* obs_uv, const float* obs_ur,
                                 const float* obs_is2, const unsigned char* obs_mask,
                                 const unsigned char* lm_free, const float* cam, int model,
                                 int huber, int jacobians, int M, int D, int lpb, int nb,
                                 float* Jp, float* Jl, float* w, float* wr, float* g_l, float* Hll,
                                 float* chi2, unsigned char* active, float* cost_part,
                                 int* count_part, cudaStream_t stream) {
  if (!tiles_ok(D, lpb, nb)) return cudaErrorInvalidValue;
  const Camera c = camera_of(cam);
  return by_model(model, huber, [&](auto m) {
    constexpr int model_ = decltype(m)::model;
    constexpr bool huber_ = decltype(m)::huber;
    if (jacobians)
      gba_linearize_kernel<model_, huber_, true><<<nb, THREADS, 0, stream>>>(
          poses, lms, lm_valid, pose_valid, obs_kf, obs_uv, obs_ur, obs_is2, obs_mask, lm_free, c,
          M, D, lpb, Jp, Jl, w, wr, g_l, Hll, chi2, active, cost_part, count_part);
    else
      gba_linearize_kernel<model_, huber_, false><<<nb, THREADS, 0, stream>>>(
          poses, lms, lm_valid, pose_valid, obs_kf, obs_uv, obs_ur, obs_is2, obs_mask, lm_free, c,
          M, D, lpb, Jp, Jl, w, wr, g_l, Hll, chi2, active, cost_part, count_part);
  });
}

// Each pose's gradient (K x 6) and diagonal block (K x 36) from a
// linearization's live slots in PoseSegments order, and the cost and count
// from gba_linearize's nb partials (with K = 0 the sum alone: Jp, w, wr,
// table, g_p and Hpp may be null).
extern "C" int gba_pose_blocks_f32(const float* Jp, const float* w, const float* wr,
                                   const long long* table, int K, int L, long long n_obs,
                                   const float* cost_part, const int* count_part, int nb,
                                   float* g_p, float* Hpp, float* cost, long long* count,
                                   cudaStream_t stream) {
  if (K < 0 || (K > 0 && L < 1) || nb < 1) return cudaErrorInvalidValue;
  gba_pose_blocks_kernel<<<K + 1, THREADS, 0, stream>>>(Jp, w, wr, table, K, L, n_obs, cost_part,
                                                        count_part, nb, g_p, Hpp, cost, count);
  return static_cast<int>(cudaGetLastError());
}

// new_poses = normalize(exp(dp) T) (K x 7), new_lms = lms + dl (M x 3).
extern "C" int gba_apply_step_f32(const float* dp, const float* poses, const float* dl,
                                  const float* lms, float* new_poses, float* new_lms, int K, int M,
                                  cudaStream_t stream) {
  const int blocks = grid_for((long long)K + 3LL * M);
  if (blocks < 1) return cudaSuccess;
  gba_apply_step_kernel<<<blocks, THREADS, 0, stream>>>(dp, poses, dl, lms, new_poses, new_lms, K,
                                                        M);
  return static_cast<int>(cudaGetLastError());
}
