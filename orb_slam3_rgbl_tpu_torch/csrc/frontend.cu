// K1: fused FAST-9/16 score + 7-tap Gaussian blur of a whole image pyramid
// in one launch, with the BRIEF composite written by the kernel itself.
//
// Replaces the Pallas TPU kernel orb_slam3_rgbl_tpu/ops/frontend_pallas.py
// (_frontend_kernel via fast_and_blur), which runs once per level, and the
// composite assembly of brief_pallas.descriptors_multilevel (round + slice
// copy per level). Plain PyTorch version beside it: ops/frontend_cuda.py
// fast_and_blur_levels_plain (fast.fast_score + pyramid.gaussian_blur per
// level, then brief_cuda.composite).
//
// What bounds it on an H100: bytes, narrowly. A launch reads every level
// once (4 B a pixel), writes its score (4 B) and writes the whole composite,
// zero padding included (9.9 MB for a KITTI pyramid, 5.8 MB of it pixels):
// 21.4 MB, 6.4 us at 3.35 TB/s. In the leanest form known to give the same
// bits (the one below) a pixel costs 120 single instructions (2 to make its
// order key, 80 three-input min/max, 4 to turn two keys back, 2 sub, 3 for
// the score, 28 unfused mul/add for the blur, 1 rounding). None is a fused
// multiply-add, so they retire at most one per lane per clock, 33.5 T/s:
// 5.2 us for the pyramid's 1.44 M pixels. (As the plain version computes
// it, 16 sub and 158 two-input min/max, a pixel costs 205 and the work was
// bound by operations at 8.8 us.) At this size a launch's own ramp and tail
// weigh as much as either, which is why the eight per-level launches of the
// first version (468 ... 44 blocks, each under one wave) became one.
//
// Design.
// * One grid over the 32x32 tiles of every level, largest level first
//   (1492 blocks of 128 threads for 1241x376 x 8 levels). The level table
//   (pointers, sizes, first tile) and the 7 taps travel by value in the
//   kernel's parameters, so a launch allocates and copies nothing.
// * After them come the fill blocks (166 for that pyramid), each zeroing
//   32 rows x 256 columns of the composite's padding: right of every level
//   and below the last. The wrapper hands over an uninitialised composite;
//   a zero fill of all 9.9 MB ahead of the launch cost 0.0039 ms of device
//   time and one more launch a frame.
// * A block stages its tile with a 3-px halo (38x38) in shared memory, one
//   row per warp at a time, no division, all of a warp's loads started
//   before its first store; interior tiles skip reflect-101. The tile holds
//   each pixel's *order key*: the int whose signed order is the float's
//   order, an involution of two integer ops.
// * FAST runs on the keys with Hopper's three-input integer min/max
//   (__vimin3_s32/__vimax3_s32): a 9-long arc is min3 of three min3, so
//   the 128 two-input min/max of the arcs become 64, the reductions over
//   the 16 arcs 16. Subtracting the centre is monotone, so an arc's least
//   contrast is its least pixel minus the centre: the 16 subtractions
//   shrink to 2. Both steps keep the score bit-identical (the plain
//   version's "+ 0" already hides the sign of a zero).
// * One barrier. After it each warp owns 8 rows x 32 columns and walks
//   down: a lane keeps a 7-row window of its column in registers (one
//   shared load per pixel instead of seven), computes the vertical blur sum
//   from it, and passes it sideways through a per-warp row buffer (lanes
//   0..5 also carry the six halo columns) for the horizontal pass. The row
//   loop is unrolled, so the window never moves between registers.
// * The blur keeps the plain version's order (vertical then horizontal,
//   taps accumulated from 0) with __fmul_rn/__fadd_rn, so nvcc cannot
//   contract it into fused multiply-adds and it stays bit-identical; the
//   composite gets rintf (round half to even, as torch.round).
// * Not used: cp.async and TMA. Rows of a 1241-wide level are only 4-byte
//   aligned (TMA wants 16-byte pitches), staging is ~3% of the block's
//   machine code, and a copy that bypasses the registers cannot turn a
//   pixel into its key. The first form of this kernel staged interior
//   tiles with 4-byte cp.async and ran FAST on f32 min/max (1296 FMNMX in
//   its 2830 SASS lines); it took 0.0260 ms on the device where this one
//   takes 0.020 (PERF.md).
//
// Resources (nvcc 12.8 -Xptxas -v, sm_90a): 55 registers, 7056 B of shared
// memory, no spills. 2544 SASS lines in all (staging, the fill blocks'
// loop and the 8 unrolled rows of a warp): ~318 a row, so a pixel costs
// about 318 machine instructions where the count above has 120 operations;
// 640 are VIMNMX3 (80 a pixel, as counted), 360 FADD/FMUL, 204 LDS, the
// rest addresses, predicates and moves. chip_smoke.py prints both reports.

#include <cuda_runtime.h>

namespace {

constexpr int TW = 32;        // output tile width (one lane per column)
constexpr int TH = 32;        // output tile height
constexpr int R = 3;          // halo radius (FAST circle and blur taps)
constexpr int SW = TW + 2 * R;
constexpr int SH = TH + 2 * R;
constexpr int NWARPS = 4;
constexpr int RPW = TH / NWARPS;   // rows a warp walks down
constexpr int MAX_LEVELS = 16;
constexpr int FW = 256;       // columns of composite padding one fill block zeroes (TH rows)

struct Level {
  const float* img;
  float* score;
  float* blur;     // unrounded blur, or null
  float* comp;     // this level's first row in the composite, or null
  int H, W, first_tile, tiles_x;
  int first_fill, fills_x;   // fill blocks zero columns W .. comp_pitch of the level's rows
};

struct Params {
  Level lv[MAX_LEVELS + 1];  // + the composite's slack rows: a level of width 0, all padding
  float taps[7];
  int n_levels;
  int n_fill;                // levels with padding to zero (0 without a composite)
  int n_tiles;               // blocks before the first fill block
  int comp_pitch;
};

__device__ __forceinline__ int reflect101(int i, int n) {
  // n >= 4 (checked by the wrapper); rows/cols far outside the image only
  // feed outputs that are never stored, so clamp after one reflection
  if (i < 0) i = -i;
  if (i >= n) i = 2 * n - 2 - i;
  return min(max(i, 0), n - 1);
}

// An int whose signed order is the float's order (-0 below +0), and back:
// the same involution both ways.
__device__ __forceinline__ int order_key(float f) {
  const int b = __float_as_int(f);
  return b ^ ((b >> 31) & 0x7fffffff);
}
__device__ __forceinline__ float key_value(int k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
}

__global__ void __launch_bounds__(NWARPS * 32)
fast_blur_kernel(const __grid_constant__ Params p) {
  __shared__ int tile[SH][SW];                 // order keys of the staged pixels
  __shared__ float vrow[NWARPS][2][SW + 2];

  const int bid = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int l = 0;
  if (bid >= p.n_tiles) {
    // a fill block: TH rows x FW columns of the composite's padding
    const int f = bid - p.n_tiles;
    while (l + 1 < p.n_fill && f >= p.lv[l + 1].first_fill) ++l;
    const int t = f - p.lv[l].first_fill;
    const int ty = t / p.lv[l].fills_x;
    const int c0 = p.lv[l].W + (t - ty * p.lv[l].fills_x) * FW;
    const int c1 = min(c0 + FW, p.comp_pitch);
    const int r1 = min(ty * TH + TH, p.lv[l].H);
    for (int r = ty * TH + warp; r < r1; r += NWARPS) {
      float* row = p.lv[l].comp + (size_t)r * p.comp_pitch;
      for (int c = c0 + lane; c < c1; c += 32) row[c] = 0.f;
    }
    return;
  }
  while (l + 1 < p.n_levels && bid >= p.lv[l + 1].first_tile) ++l;
  const float* __restrict__ img = p.lv[l].img;
  float* __restrict__ score = p.lv[l].score;
  float* __restrict__ blur = p.lv[l].blur;
  float* __restrict__ comp = p.lv[l].comp;
  const int H = p.lv[l].H, W = p.lv[l].W;
  const int t = bid - p.lv[l].first_tile;
  const int ty = t / p.lv[l].tiles_x;
  const int x0 = (t - ty * p.lv[l].tiles_x) * TW;
  const int y0 = ty * TH;

  // warp w stages rows w, w + NWARPS, ...: 38 columns as 32 + 6
  constexpr int ROWS_PER_WARP = (SH + NWARPS - 1) / NWARPS;
  if (x0 >= R && x0 + TW + R <= W && y0 >= R && y0 + TH + R <= H) {
    const float* src = img + (size_t)(y0 - R) * W + (x0 - R) + lane;
#pragma unroll
    for (int j = 0; j < ROWS_PER_WARP; ++j) {
      const int r = warp + j * NWARPS;
      if (r < SH) {
        tile[r][lane] = order_key(__ldg(src + r * W));
        if (lane < 2 * R) tile[r][TW + lane] = order_key(__ldg(src + r * W + TW));
      }
    }
  } else {
    const int gx0 = reflect101(x0 + lane - R, W);
    const int gx1 = reflect101(x0 + TW + lane - R, W);
#pragma unroll
    for (int j = 0; j < ROWS_PER_WARP; ++j) {
      const int r = warp + j * NWARPS;
      if (r < SH) {
        const float* row = img + (size_t)reflect101(y0 + r - R, H) * W;
        tile[r][lane] = order_key(__ldg(row + gx0));
        if (lane < 2 * R) tile[r][TW + lane] = order_key(__ldg(row + gx1));
      }
    }
  }
  __syncthreads();

  const int r0 = warp * RPW;
  const int c = lane + R;                      // own staged column
  // lanes 0..2 also carry staged columns 0..2, lanes 3..5 columns 35..37;
  // the other lanes repeat their own column (same cost as a divergent
  // branch, and no branch)
  const bool extra = lane < 2 * R;
  const int ce = extra ? (lane < R ? lane : TW + lane) : c;
  const int x = x0 + lane;
  const bool x_stored = x < W;
  const bool x_scored = x >= R && x < W - R;

  float w[7], we[7];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    w[i] = key_value(tile[r0 + i][c]);
    we[i] = key_value(tile[r0 + i][ce]);
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = r0 + i;                      // staged rows r .. r+6 feed output row r
    const int y = y0 + r;
    if (y >= H) break;                         // uniform across the warp
    const int* q = &tile[r + R][c];            // the pixel itself, pitch SW
    const int k_below = q[3 * SW];
    w[6] = key_value(k_below);
    we[6] = key_value(tile[r + 6][ce]);

    float v = 0.f, ve = 0.f;
#pragma unroll
    for (int k = 0; k < 7; ++k) {
      v = __fadd_rn(v, __fmul_rn(p.taps[k], w[k]));
      ve = __fadd_rn(ve, __fmul_rn(p.taps[k], we[k]));
    }
    float* vr = vrow[warp][i & 1];
    vr[c] = v;
    if (extra) vr[ce] = ve;
    __syncwarp();
    float b = 0.f;
#pragma unroll
    for (int k = 0; k < 7; ++k) b = __fadd_rn(b, __fmul_rn(p.taps[k], vr[lane + k]));

    // FAST on the order keys. Subtracting the centre is monotone, so the
    // least (greatest) contrast of an arc is the arc's least (greatest)
    // pixel minus the centre: the 16 subtractions of the plain version
    // shrink to 2, bit for bit. Circle of radius 3, clockwise from 12
    // o'clock (ops/fast.py CIRCLE_OFFSETS).
#define CIRC(dy, dx) q[(dy) * SW + (dx)]
    const int kk[16] = {CIRC(-3, 0), CIRC(-3, 1), CIRC(-2, 2), CIRC(-1, 3), CIRC(0, 3),
                        CIRC(1, 3),  CIRC(2, 2),  CIRC(3, 1),  k_below,
                        CIRC(3, -1), CIRC(2, -2), CIRC(1, -3), CIRC(0, -3),
                        CIRC(-1, -3), CIRC(-2, -2), CIRC(-3, -1)};
#undef CIRC
    // 9-long circular windows from windows of 3, three inputs an op
    int mn3[16], mx3[16], mn9[16], mx9[16];
#pragma unroll
    for (int a = 0; a < 16; ++a) {
      mn3[a] = __vimin3_s32(kk[a], kk[(a + 1) & 15], kk[(a + 2) & 15]);
      mx3[a] = __vimax3_s32(kk[a], kk[(a + 1) & 15], kk[(a + 2) & 15]);
    }
#pragma unroll
    for (int a = 0; a < 16; ++a) {
      mn9[a] = __vimin3_s32(mn3[a], mn3[(a + 3) & 15], mn3[(a + 6) & 15]);
      mx9[a] = __vimax3_s32(mx3[a], mx3[(a + 3) & 15], mx3[(a + 6) & 15]);
    }
    int hi[5], lo[5];
#pragma unroll
    for (int a = 0; a < 5; ++a) {
      hi[a] = __vimax3_s32(mn9[3 * a], mn9[3 * a + 1], mn9[3 * a + 2]);
      lo[a] = __vimin3_s32(mx9[3 * a], mx9[3 * a + 1], mx9[3 * a + 2]);
    }
    const int bright_k = __vimax3_s32(__vimax3_s32(hi[0], hi[1], hi[2]), hi[3],
                                      __vimax3_s32(hi[4], mn9[15], mn9[15]));
    const int dark_k = __vimin3_s32(__vimin3_s32(lo[0], lo[1], lo[2]), lo[3],
                                    __vimin3_s32(lo[4], mx9[15], mx9[15]));
    const float center = w[3];
    const float bright = key_value(bright_k) - center;
    const float dark = key_value(dark_k) - center;
    // "+ 0" turns a -0 into +0, as the plain version does
    float s = 0.f;
    if (x_scored && y >= R && y < H - R)
      s = __fadd_rn(fmaxf(fmaxf(bright, -dark), 0.f), 0.f);

    if (x_stored) {
      const int o = y * W + x;
      score[o] = s;
      if (blur != nullptr) blur[o] = b;
      if (comp != nullptr) comp[(size_t)y * p.comp_pitch + x] = rintf(b);
    }
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      w[k] = w[k + 1];
      we[k] = we[k + 1];
    }
  }
}

}  // namespace

// Launch K1 over n levels. img/score/blur hold one device pointer per
// level (blur may be null: no unrounded blur is written); comp is the
// (comp_rows, comp_pitch) composite or null, comp_off the first composite
// row of each level: levels stacked in order without gaps, as
// brief_cuda.composite_layout places them. The kernel writes every element
// of the composite, the zero padding too. Everything but the pixels is
// read on the host, here.
extern "C" int fast_and_blur_levels_f32(int n, const void* const* img, void* const* score,
                                        void* const* blur, const int* H, const int* W,
                                        float* comp, const int* comp_off, int comp_rows,
                                        int comp_pitch, const float* taps,
                                        cudaStream_t stream) {
  if (n < 1 || n > MAX_LEVELS) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  int tiles = 0, fills = 0;
  for (int l = 0; l < n; ++l) {
    Level& L = p.lv[l];
    L.img = static_cast<const float*>(img[l]);
    L.score = static_cast<float*>(score[l]);
    L.blur = blur != nullptr ? static_cast<float*>(blur[l]) : nullptr;
    L.comp = comp != nullptr ? comp + (size_t)comp_off[l] * comp_pitch : nullptr;
    L.H = H[l];
    L.W = W[l];
    L.first_tile = tiles;
    L.tiles_x = (W[l] + TW - 1) / TW;
    tiles += L.tiles_x * ((H[l] + TH - 1) / TH);
    L.first_fill = fills;
    L.fills_x = comp != nullptr ? (comp_pitch - W[l] + FW - 1) / FW : 0;
    fills += L.fills_x * ((H[l] + TH - 1) / TH);
  }
  for (int l = n; l <= MAX_LEVELS; ++l) p.lv[l] = Level{};
  p.n_fill = 0;
  if (comp != nullptr) {
    // the rows below the last level
    const int end = comp_off[n - 1] + H[n - 1];
    Level& L = p.lv[n];
    L.comp = comp + (size_t)end * comp_pitch;
    L.H = comp_rows - end;
    L.first_fill = fills;
    L.fills_x = (comp_pitch + FW - 1) / FW;
    fills += L.fills_x * ((L.H + TH - 1) / TH);
    p.n_fill = n + 1;
  }
  for (int k = 0; k < 7; ++k) p.taps[k] = taps[k];
  p.n_levels = n;
  p.n_tiles = tiles;
  p.comp_pitch = comp_pitch;
  fast_blur_kernel<<<tiles + fills, NWARPS * 32, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}
