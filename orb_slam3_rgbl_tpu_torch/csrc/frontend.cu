// K1: fused FAST-9/16 score + 7-tap Gaussian blur of one pyramid level.
//
// Replaces the Pallas TPU kernel orb_slam3_rgbl_tpu/ops/frontend_pallas.py
// (_frontend_kernel via fast_and_blur). Plain PyTorch version beside it:
// ops/fast.py fast_score + ops/pyramid.py gaussian_blur.
//
// What bounds it on an H100: operations. Per pixel it reads 4 B, writes
// 8 B (score + blur) and issues ~205 single f32 instructions (sub, min,
// max, and the blur's unfused mul and add). None is a fused multiply-add,
// so they retire at most one per lane per clock, 33.5 T/s (half the
// data sheet's 67 TFLOP/s, which counts an FMA as two): 12 B / 3.35 TB/s
// = 3.6 ps a pixel against 205 / 33.5 T/s = 6.1 ps. At pyramid sizes
// (1.44 M pixels a frame, 105x346 at the top level) the launch itself is
// the same order as both.
//
// Design: one block per 32x32 output tile, 32x8 threads, 4 rows each.
// The block stages the tile with a 3-px reflect-101 halo in shared memory
// once; both outputs are computed from it, so each input byte is read
// from device memory about 1.4 times (halo overlap) and the 16 circle
// neighbours and the 7x7 blur footprint come from shared memory. The blur
// runs as a vertical pass into a second shared buffer, then a horizontal
// pass, in the plain version's order and without fused multiply-adds, so
// it reproduces the plain version's rounding. The score is subtractions
// and min/max only, hence bit-identical in any order.

#include <cuda_runtime.h>

namespace {

constexpr int TW = 32;        // output tile width
constexpr int TH = 32;        // output tile height
constexpr int R = 3;          // halo radius (FAST circle and blur taps)
constexpr int SW = TW + 2 * R;
constexpr int SH = TH + 2 * R;

// Circle of radius 3, clockwise from 12 o'clock (ops/fast.py CIRCLE_OFFSETS).
__constant__ int kDY[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int kDX[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};

__device__ __forceinline__ int reflect101(int i, int n) {
  // n >= 4 (checked by the wrapper); rows/cols far outside the image only
  // feed outputs that are never stored, so clamp after one reflection
  if (i < 0) i = -i;
  if (i >= n) i = 2 * n - 2 - i;
  return min(max(i, 0), n - 1);
}

__global__ void __launch_bounds__(256)
fast_blur_kernel(const float* __restrict__ img, float* __restrict__ score,
                 float* __restrict__ blur, const float* __restrict__ taps,
                 int H, int W) {
  __shared__ float tile[SH][SW];
  __shared__ float vbuf[TH][SW];

  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;

  for (int i = tid; i < SH * SW; i += nthreads) {
    const int ty = i / SW, tx = i % SW;
    const int gy = reflect101(y0 + ty - R, H);
    const int gx = reflect101(x0 + tx - R, W);
    tile[ty][tx] = img[(size_t)gy * W + gx];
  }
  float k[7];
#pragma unroll
  for (int t = 0; t < 7; ++t) k[t] = taps[t];
  __syncthreads();

  // vertical blur pass over every staged column
  for (int i = tid; i < TH * SW; i += nthreads) {
    const int r = i / SW, c = i % SW;
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < 7; ++t) acc = __fadd_rn(acc, __fmul_rn(k[t], tile[r + t][c]));
    vbuf[r][c] = acc;
  }
  __syncthreads();

  const int c = threadIdx.x;
  const int x = x0 + c;
  for (int r = threadIdx.y; r < TH; r += blockDim.y) {
    const int y = y0 + r;
    if (x >= W || y >= H) continue;

    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < 7; ++t) acc = __fadd_rn(acc, __fmul_rn(k[t], vbuf[r][c + t]));
    blur[(size_t)y * W + x] = acc;

    float s = 0.f;
    if (y >= 3 && y < H - 3 && x >= 3 && x < W - 3) {
      const float center = tile[r + R][c + R];
      float d[16];
#pragma unroll
      for (int a = 0; a < 16; ++a) d[a] = tile[r + R + kDY[a]][c + R + kDX[a]] - center;
      // 9-long circular windows: prefix windows of 2, 4, 8, then one more
      float mn2[16], mx2[16], mn4[16], mx4[16];
#pragma unroll
      for (int a = 0; a < 16; ++a) {
        mn2[a] = fminf(d[a], d[(a + 1) & 15]);
        mx2[a] = fmaxf(d[a], d[(a + 1) & 15]);
      }
#pragma unroll
      for (int a = 0; a < 16; ++a) {
        mn4[a] = fminf(mn2[a], mn2[(a + 2) & 15]);
        mx4[a] = fmaxf(mx2[a], mx2[(a + 2) & 15]);
      }
      float bright = -INFINITY, dark = INFINITY;
#pragma unroll
      for (int a = 0; a < 16; ++a) {
        const float mn9 = fminf(fminf(mn4[a], mn4[(a + 4) & 15]), d[(a + 8) & 15]);
        const float mx9 = fmaxf(fmaxf(mx4[a], mx4[(a + 4) & 15]), d[(a + 8) & 15]);
        bright = fmaxf(bright, mn9);
        dark = fminf(dark, mx9);
      }
      // "+ 0" turns a -0 into +0, as the plain version does
      s = __fadd_rn(fmaxf(fmaxf(bright, -dark), 0.f), 0.f);
    }
    score[(size_t)y * W + x] = s;
  }
}

}  // namespace

extern "C" int fast_and_blur_f32(const float* img, float* score, float* blur,
                                 const float* taps, int H, int W,
                                 cudaStream_t stream) {
  dim3 block(32, 8);
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH);
  fast_blur_kernel<<<grid, block, 0, stream>>>(img, score, blur, taps, H, W);
  return static_cast<int>(cudaGetLastError());
}
