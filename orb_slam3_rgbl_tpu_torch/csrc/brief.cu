// K2: steered BRIEF-256 with per-keypoint continuous rotation, all pyramid
// levels in one launch: angles (as cos and sin) in, descriptor words out.
// K3 (below K2): the binned variant.
//
// Replaces the Pallas TPU kernel orb_slam3_rgbl_tpu/ops/brief_pallas.py
// (_brief_kernel_cont via brief_continuous_pallas) together with the index
// tables it consumed (brief_pallas.continuous_index_tables). Plain PyTorch
// versions: ops/brief_cuda.py brief_continuous_plain o
// continuous_index_tables (tables, then gather) and ops/orb.py
// brief_descriptors (gather form, same result on the composite).
//
// What bounds it on an H100: bytes, and at 2000 keypoints mostly latency.
// The work is 512 rotated positions and 256 compares per keypoint. The
// least traffic is the composite pixels the tests sample (each once, ~160
// distinct ones a keypoint), the corners, cos, sin, the 4 KB pattern and
// the output: ~1.4 MB, 0.4 us at 3.35 TB/s, the same order as the
// rotation's ~13 M operations. The TPU kernel selected samples with one-hot
// MXU products and therefore needed every keypoint's 512 integer positions
// ahead of the grid: a (2000, 512) int32 table, 4.1 MB written by a dozen
// elementwise launches and read back once. A GPU thread gathers by index
// at full speed, so the table never exists here.
//
// Design (the direct form): thread t of a 256-thread block owns
// test t: it loads its two pattern points once (one float4, (ax, ay, bx,
// by), the layout of orb_pattern.npy) and, for each of the block's K2_KPB
// keypoints, rotates them with the keypoint's cos and sin and reads the two
// samples straight from the composite through the read-only path. The
// loads of all K2_KPB keypoints are started before the first compare. Warp w
// produces word w: one __ballot_sync packs 32 tests, so bit l of word w is
// test 32w + l, the JAX package's packing.
// The rotation repeats continuous_index_tables op for op: each product and
// each sum rounds once (__fmul_rn, __fadd_rn, __fsub_rn: no fused
// multiply-add), rintf rounds half to even as torch.round, the patch index
// (y + 18) * 40 + (x + 18) is formed in f32 and truncated, then clamped as
// the plain version clamps it. cos and sin come from torch.cos/torch.sin
// in the wrapper, as in the plain version: cosf/sinf in the kernel are a
// different library build, and one ulp flips a rounded position. (With
// CUDA 12.8 on both sides they differed at none of 1,024,000 positions of
// a frame's 2000 angles; the wrapper's two calls agree on any toolkit.)
//
// Measured and dropped: the staged form, the first version's layout. A
// block staged the 40x40 patches of 4 keypoints in shared memory (25,600 B,
// 40 registers) and read the samples from there, with the positions
// computed before the patch loads and row-wise staging without a division.
// It moved 6.4 KB a keypoint for ~160 sampled pixels and took 0.0060 ms on
// the device where the direct form took 0.0039 ms (2000 keypoints, H100
// 80GB HBM3 at 700 W; PERF.md).
//
// Resources (nvcc 12.8 -Xptxas -v, sm_90a): brief_kernel 30 registers, no
// shared memory; K3 brief_binned_kernel 32 registers at its 8 slots a block
// (20, 29 and 36 at 2, 4 and 16 in the sweep), no shared memory, no barrier.

#include <cuda_runtime.h>

namespace {

constexpr int PATCH = 40;          // patch side (brief_pallas.PATCH)
constexpr int PP = PATCH * PATCH;
constexpr int HALF = 18;           // pattern centre inside the patch
constexpr int K2_KPB = 2;          // keypoints per block (K2)
constexpr int K3_KPB = 8;          // slots per block (K3), the sweep's best
constexpr int NTHREADS = 256;      // 8 warps = 8 descriptor words
constexpr int NB = 30;             // angle bins (brief_pallas.NB)
constexpr int BLK = 64;            // slots per bin-pure block (brief_pallas.BLK)

// Patch position of pattern point (px, py) rotated by (c, s): the f32
// arithmetic of ops/brief_cuda.py continuous_index_tables, op for op.
__device__ __forceinline__ int rotated_index(float px, float py, float c, float s) {
  const float x = rintf(__fsub_rn(__fmul_rn(px, c), __fmul_rn(py, s)));
  const float y = rintf(__fadd_rn(__fmul_rn(px, s), __fmul_rn(py, c)));
  const float i = __fadd_rn(__fmul_rn(__fadd_rn(y, (float)HALF), (float)PATCH),
                            __fadd_rn(x, (float)HALF));
  return static_cast<int>(i);
}

__device__ __forceinline__ int clamp_index(int i) { return min(max(i, 0), PP - 1); }

__global__ void __launch_bounds__(NTHREADS)
brief_kernel(const float* __restrict__ img, int Hc, int Wc, const int* __restrict__ corners,
             const float* __restrict__ cosv, const float* __restrict__ sinv,
             const float4* __restrict__ pattern, int* __restrict__ out, int N) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const float4 p = __ldg(pattern + tid);
  const int k0 = blockIdx.x * K2_KPB;
  float a[K2_KPB], b[K2_KPB];
#pragma unroll
  for (int k = 0; k < K2_KPB; ++k) {
    const int kp = min(k0 + k, N - 1);       // a padding slot repeats the last keypoint
    const float c = __ldg(cosv + kp), s = __ldg(sinv + kp);
    const int u = min(max(__ldg(corners + 2 * kp), 0), Wc - PATCH);
    const int v = min(max(__ldg(corners + 2 * kp + 1), 0), Hc - PATCH);
    const int ia = clamp_index(rotated_index(p.x, p.y, c, s));
    const int ib = clamp_index(rotated_index(p.z, p.w, c, s));
    const float* base = img + (size_t)v * Wc + u;
    a[k] = __ldg(base + (ia / PATCH) * Wc + ia % PATCH);
    b[k] = __ldg(base + (ib / PATCH) * Wc + ib % PATCH);
  }
#pragma unroll
  for (int k = 0; k < K2_KPB; ++k) {
    const unsigned word = __ballot_sync(0xffffffffu, a[k] < b[k]);
    if (lane == 0 && k0 + k < N) out[(size_t)(k0 + k) * 8 + warp] = static_cast<int>(word);
  }
}

// The (N, 512) patch positions as K2 computes them (A points then B
// points, unclamped), for checks against continuous_index_tables.
__global__ void __launch_bounds__(NTHREADS)
brief_rotation_tables_kernel(const float* __restrict__ cosv, const float* __restrict__ sinv,
                             const float4* __restrict__ pattern, int* __restrict__ out) {
  const int kp = blockIdx.x, tid = threadIdx.x;
  const float4 p = __ldg(pattern + tid);
  const float c = cosv[kp], s = sinv[kp];
  out[(size_t)kp * 512 + tid] = rotated_index(p.x, p.y, c, s);
  out[(size_t)kp * 512 + 256 + tid] = rotated_index(p.z, p.w, c, s);
}

// K3: binned rBRIEF. Replaces the Pallas TPU kernel
// orb_slam3_rgbl_tpu/ops/brief_pallas.py (_brief_kernel via
// brief_blocks_pallas). Plain PyTorch versions: ops/brief_cuda.py
// brief_blocks_plain (same inputs) and brief_binned_plain (gather form).
//
// Slot s reads the patch at corners[s] through the 512-entry pattern table
// of bin block_bins[s / 64]; slots come bin-pure in blocks of 64
// (bin_pure_layout), so every block of KPB slots shares one table.
//
// What bounds it on an H100: bytes, and at ~3900 slots mostly latency. The
// least traffic is the composite pixels the tests sample (each once), the
// 30 x 512 tables (61 KB in all, not a 2 KB table per keypoint as in K2),
// the corners, the bins and the output. The TPU kernel selected samples
// with one-hot MXU products because TPU gathers are slow; a GPU thread
// gathers by index at full speed.
//
// Design (K2's direct form without the rotation): thread t of a
// 256-thread block owns test t. It reads its two table entries of the
// block's bin once, clamps them and turns each into an offset inside the
// composite; then, for each of the block's KPB slots, it reads the corner
// and its two samples straight from the composite through the read-only
// path, all KPB slots' loads started before the first compare. Warp w packs
// word w of each slot with one __ballot_sync, bit l = test 32w + l (the JAX
// packing). No shared memory, no barrier. Padding slots (corner (1, 1),
// nearly half of them at 2000 keypoints) are computed like any other: the
// ones of a block read one patch, which stays in L1.
//
// Measured and dropped: the staged form, the first version. A block staged
// its bin's 2 KB table and the whole 40x40 patches of 4 slots (25,600 B) in
// shared memory behind one barrier: 25 MB of patch pixels read for ~1.3 MB
// sampled. On 3904 slots (2000 keypoints, H100 80GB HBM3 at 700 W) it took
// 0.0157 ms on the device where the direct form took 0.0043-0.0050 ms at
// 2, 4, 8 and 16 slots a block (two turns each: 0.0049 0.0048; 0.0045
// 0.0050; 0.0043 0.0046; 0.0049 0.0049; the same order in the next run); 8
// stays: the sweep is flat within its run-to-run spread, so the other
// widths are not kept. An empty launch at its grid of 488 blocks takes
// 0.0011 ms (PERF.md).
__global__ void __launch_bounds__(NTHREADS)
brief_binned_kernel(const float* __restrict__ img, int Hc, int Wc,
                    const int* __restrict__ corners, const int* __restrict__ block_bins,
                    const int* __restrict__ tables, int* __restrict__ out, int S) {
  static_assert(BLK % K3_KPB == 0, "a K3 block of K3_KPB slots must not straddle two bins");
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int k0 = blockIdx.x * K3_KPB;
  const int b = min(max(__ldg(block_bins + k0 / BLK), 0), NB - 1);
  const int ia = clamp_index(__ldg(tables + b * 512 + tid));
  const int ib = clamp_index(__ldg(tables + b * 512 + 256 + tid));
  const int oa = (ia / PATCH) * Wc + ia % PATCH;
  const int ob = (ib / PATCH) * Wc + ib % PATCH;
  float va[K3_KPB], vb[K3_KPB];
#pragma unroll
  for (int k = 0; k < K3_KPB; ++k) {
    const int s = min(k0 + k, S - 1);        // a slot past the end repeats the last one
    // callers clamp corners so the patch lies inside the composite;
    // the clamp here keeps a bad corner from reading out of bounds
    const int u = min(max(__ldg(corners + 2 * s), 0), Wc - PATCH);
    const int v = min(max(__ldg(corners + 2 * s + 1), 0), Hc - PATCH);
    const float* base = img + (size_t)v * Wc + u;
    va[k] = __ldg(base + oa);
    vb[k] = __ldg(base + ob);
  }
#pragma unroll
  for (int k = 0; k < K3_KPB; ++k) {
    const unsigned word = __ballot_sync(0xffffffffu, va[k] < vb[k]);
    if (lane == 0 && k0 + k < S) out[(size_t)(k0 + k) * 8 + warp] = static_cast<int>(word);
  }
}

}  // namespace

extern "C" int brief_continuous_i32(const float* img, int Hc, int Wc, const int* corners,
                                    const float* cosv, const float* sinv,
                                    const float* pattern, int* out, int N,
                                    cudaStream_t stream) {
  brief_kernel<<<(N + K2_KPB - 1) / K2_KPB, NTHREADS, 0, stream>>>(
      img, Hc, Wc, corners, cosv, sinv, reinterpret_cast<const float4*>(pattern), out, N);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int brief_rotation_tables_i32(const float* cosv, const float* sinv,
                                         const float* pattern, int* out, int N,
                                         cudaStream_t stream) {
  brief_rotation_tables_kernel<<<N, NTHREADS, 0, stream>>>(
      cosv, sinv, reinterpret_cast<const float4*>(pattern), out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int brief_binned_i32(const float* img, int Hc, int Wc, const int* corners,
                                const int* block_bins, const int* tables, int* out, int S,
                                cudaStream_t stream) {
  brief_binned_kernel<<<(S + K3_KPB - 1) / K3_KPB, NTHREADS, 0, stream>>>(
      img, Hc, Wc, corners, block_bins, tables, out, S);
  return static_cast<int>(cudaGetLastError());
}
