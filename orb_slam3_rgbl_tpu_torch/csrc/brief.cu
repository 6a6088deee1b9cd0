// K2: steered BRIEF-256 with per-keypoint continuous rotation, all pyramid
// levels in one launch. K3 (below K2): the binned variant.
//
// Replaces the Pallas TPU kernel orb_slam3_rgbl_tpu/ops/brief_pallas.py
// (_brief_kernel_cont via brief_continuous_pallas). Plain PyTorch
// versions: ops/brief_cuda.py brief_continuous_plain (same inputs) and
// ops/orb.py brief_descriptors (gather form, same result on the
// composite).
//
// What bounds it on an H100: bytes, and at 2000 keypoints mostly latency.
// The work is 256 compares per keypoint; the least traffic is the
// composite pixels the tests sample (each once) and each keypoint's
// 512-entry index table (2 KB), which is the larger part. The kernel reads
// each keypoint's whole 40x40 patch (6.4 KB, mostly L2 hits since
// neighbouring keypoints overlap), more than that least. The TPU kernel selected
// samples with one-hot MXU products because TPU gathers are slow; a GPU
// reads shared memory by index at full speed, so that detour is gone.
//
// Design: one block of 256 threads per 4 keypoints. The block stages the
// 4 patches in shared memory (25.6 KB, one coalesced 40-float row at a
// time), then warp w produces word w of each keypoint: lane l compares
// test 32w + l and one __ballot_sync packs the 32 results, so bit l of
// word w is test 32w + l, the JAX package's packing. The index tables
// come from ops/brief_cuda.py continuous_index_tables, computed outside
// the kernel so that kernel and plain version consume the same integers.

#include <cuda_runtime.h>

namespace {

constexpr int PATCH = 40;          // patch side (brief_pallas.PATCH)
constexpr int PP = PATCH * PATCH;
constexpr int KPB = 4;             // keypoints per block
constexpr int NTHREADS = 256;      // 8 warps = 8 descriptor words
constexpr int NB = 30;             // angle bins (brief_pallas.NB)
constexpr int BLK = 64;            // slots per bin-pure block (brief_pallas.BLK)
static_assert(BLK % KPB == 0, "a K3 block of KPB slots must not straddle two bins");

// Stage the 40x40 patches of slots k0 .. k0+KPB-1 in shared memory.
__device__ __forceinline__ void load_patches(float (*patch)[PP], const float* __restrict__ img,
                                             int Hc, int Wc, const int* __restrict__ corners,
                                             int k0, int N) {
  for (int i = threadIdx.x; i < KPB * PP; i += NTHREADS) {
    const int k = i / PP, p = i % PP;
    const int kp = k0 + k;
    if (kp < N) {
      // callers clamp corners so the patch lies inside the composite;
      // the clamp here keeps a bad corner from reading out of bounds
      const int u = min(max(corners[2 * kp], 0), Wc - PATCH);
      const int v = min(max(corners[2 * kp + 1], 0), Hc - PATCH);
      patch[k][p] = img[(size_t)(v + p / PATCH) * Wc + (u + p % PATCH)];
    }
  }
}

__global__ void __launch_bounds__(NTHREADS)
brief_kernel(const float* __restrict__ img, int Hc, int Wc,
             const int* __restrict__ corners, const int* __restrict__ idx,
             int* __restrict__ out, int N) {
  __shared__ float patch[KPB][PP];
  const int k0 = blockIdx.x * KPB;
  const int tid = threadIdx.x;
  load_patches(patch, img, Hc, Wc, corners, k0, N);
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const int bit = warp * 32 + lane;
  for (int k = 0; k < KPB; ++k) {
    const int kp = k0 + k;
    if (kp >= N) break;            // uniform across the block
    const int* row = idx + (size_t)kp * 512;
    const int ia = min(max(row[bit], 0), PP - 1);
    const int ib = min(max(row[256 + bit], 0), PP - 1);
    const unsigned word = __ballot_sync(0xffffffffu, patch[k][ia] < patch[k][ib]);
    if (lane == 0) out[(size_t)kp * 8 + warp] = static_cast<int>(word);
  }
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
// with one-hot MXU products because TPU gathers are slow; here the block
// stages its bin's table (2 KB) and its 4 patches (25.6 KB) in shared
// memory and reads them by index, as K2 does. Warp w makes word w of each
// slot with one __ballot_sync, bit l = test 32w + l (the JAX packing).
__global__ void __launch_bounds__(NTHREADS)
brief_binned_kernel(const float* __restrict__ img, int Hc, int Wc,
                    const int* __restrict__ corners, const int* __restrict__ block_bins,
                    const int* __restrict__ tables, int* __restrict__ out, int S) {
  __shared__ float patch[KPB][PP];
  __shared__ int tab[512];
  const int k0 = blockIdx.x * KPB;
  const int tid = threadIdx.x;
  const int b = min(max(block_bins[k0 / BLK], 0), NB - 1);
  for (int i = tid; i < 512; i += NTHREADS)
    tab[i] = min(max(tables[b * 512 + i], 0), PP - 1);
  load_patches(patch, img, Hc, Wc, corners, k0, S);
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const int bit = warp * 32 + lane;
  const int ia = tab[bit];
  const int ib = tab[256 + bit];
  for (int k = 0; k < KPB; ++k) {
    const int s = k0 + k;
    if (s >= S) break;             // uniform across the block
    const unsigned word = __ballot_sync(0xffffffffu, patch[k][ia] < patch[k][ib]);
    if (lane == 0) out[(size_t)s * 8 + warp] = static_cast<int>(word);
  }
}

}  // namespace

extern "C" int brief_continuous_i32(const float* img, int Hc, int Wc,
                                    const int* corners, const int* idx,
                                    int* out, int N, cudaStream_t stream) {
  const int blocks = (N + KPB - 1) / KPB;
  brief_kernel<<<blocks, NTHREADS, 0, stream>>>(img, Hc, Wc, corners, idx, out, N);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int brief_binned_i32(const float* img, int Hc, int Wc, const int* corners,
                                const int* block_bins, const int* tables, int* out, int S,
                                cudaStream_t stream) {
  const int blocks = (S + KPB - 1) / KPB;
  brief_binned_kernel<<<blocks, NTHREADS, 0, stream>>>(img, Hc, Wc, corners, block_bins,
                                                       tables, out, S);
  return static_cast<int>(cudaGetLastError());
}
