// Pyramidal Lucas-Kanade tracking for a batch of keypoints.
//
// Two kernels over one implementation of the maths (`lk_level_body`):
//
//   lk_fwd_rev_kernel  the whole track of a frame pair in ONE launch: for
//                      every keypoint the initial guess, all pyramid levels
//                      coarse to fine, the forward status rules, the reverse
//                      track from the forward result, its status rules and
//                      the back-track error test. Wrapper:
//                      ops/image/klt.py::lk_track_fwd_rev; plain version:
//                      klt.lk_track_fwd_rev_plain.
//   lk_level_kernel    one pyramid level (window loads, bilinear template,
//                      gradients, 2x2 normal matrix, Gauss-Newton
//                      iterations). Wrapper: klt.lk_level; plain version:
//                      klt.lk_level_plain.
//
// Both replace the JAX package's Pallas kernel
// rd_vio_tpu/ops/image/klt_pallas.py::_lk_iter_kernel (launched by
// lk_level_pallas) together with the XLA code around it: klt.prepare_level,
// and for the fused kernel also the level loop, the guess scaling and the
// status rules of klt.lk_track_pyramid / klt.lk_track_fwd_rev. The maths is
// that of the XLA tracker klt._lk_level_windowed.
//
// What bounds it on an H100, and what the design does about it. The work is
// tiny. By bytes: both pyramids read once are 3.85 MB at 752x480 with 4
// levels, 1.15 us at 3.35 TB/s (one level-0 call: 2.89 MB, 0.86 us). By
// operations: per keypoint and level ~9.2 kflop of set-up plus ~5.3 kflop
// per iteration (441 pixels x 12), 100-150 MFLOP for 384 keypoints x 8
// levels, about 2 us at 67 TFLOP/s in f32. So the bound is about 2 us, and
// no launch of a few hundred keypoints can come near it: 384 keypoints are
// about 3 per SM on 132 SMs, the card is never full, and the time of a
// launch is the serial chain of its SLOWEST keypoint: per level one round
// trip to L2 for the two windows, the template, then up to 30 dependent
// iterations of ~0.3 us each (offsets -> 4-tap samples -> sum over the
// group -> 2x2 step), 8 levels. The design shortens that chain and removes
// everything around it:
//
//   - one launch per frame pair, not 8 launches and ~70 small tensor
//     operations: nothing in the chain crosses keypoints, so the level loop,
//     both directions and the status rules run inside the kernel;
//   - a group of GROUP threads per keypoint, one group per block. The
//     template I and its gradients Ix, Iy live in registers (7 pixels per
//     thread, their window offsets computed once), so an iteration reads only
//     the search window. The sums are reduced with __shfl_xor_sync inside a
//     warp and through two alternating shared buffers across the group's
//     warps, one named barrier per iteration; every thread adds the same
//     partial sums in the same order, so all take bitwise the same step and
//     leave the loop together (the step^2 < eps^2 test, NaN included, as in
//     the JAX trackers). Timed on the card, 64 threads per keypoint gave the
//     shortest launch: a warp per keypoint needs no barrier at all but walks
//     14 pixels per lane and builds the template four times slower; 128 and
//     256 threads shorten the set-up no further and idle in the iterations
//     (tools/lk_bench.py repeats the comparison);
//   - both windows of a level are fetched with 4-byte cp.async copies, all in
//     flight at once and awaited once: a level costs one memory round trip,
//     not one per batch of register-staged loads. The template source is not
//     fetched further ahead (it depends on the keypoint alone, not on the
//     level above): it already travels together with the search window,
//     which has to wait for the level above, so nothing would leave the chain;
//   - the search window is stored with a row stride of 53 floats: 53 = 21
//     (mod 32), so pixel p = 21 r + u of the 21x21 patch sits in bank
//     (p + const) mod 32 and the four bilinear taps of 32 consecutive pixels
//     never collide;
//   - a keypoint whose forward status is false skips its reverse track, and
//     an invalid keypoint skips the image work altogether;
//   - no tensor cores: the Pallas kernel wrote the bilinear sample as
//     Wy . S . Wx^T to feed the TPU's matrix unit, with 21x40 matrices of
//     two non-zeros per row; here the 4-tap blend is computed directly and
//     wgmma would have nothing to multiply.
//
// The PADB edge padding of the JAX version is emulated by clamping every
// read to the level's bounds, and the blend offsets are clamped exactly as
// klt._blend_matrix clamps them (integer part in [0, SW - rows - 1],
// fraction in [0, 1]), so the per-level flow clamp to the search window
// matches the JAX trackers.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int MAX_LEVELS = 8;

// The two pyramids of a frame pair, fine to coarse: an argument of the C
// entry point (so outside the unnamed namespace) that the kernel takes by
// value; klt._Pyramids is its ctypes twin.
struct Pyramids {
  const float* prev[MAX_LEVELS];
  const float* next[MAX_LEVELS];
  int H[MAX_LEVELS];
  int W[MAX_LEVELS];
  int levels;
};

namespace {

constexpr int HALF = 10;
constexpr int WIN = 2 * HALF + 1;            // 21
constexpr int EXT = WIN + 2;                 // 23: template + gradient ring
constexpr int MARGIN = 8;
constexpr int SW = EXT + 1 + 2 * MARGIN;     // 40: search window side
constexpr int PADB = HALF + 2 + MARGIN;      // 20: edge padding of the JAX version
constexpr int TPL = EXT + 1;                 // 24: source side of the template
constexpr int NPIX = WIN * WIN;              // 441
constexpr int S2S = 53;                      // row stride of the search window

// threads per keypoint, and threads per block (BLOCK / GROUP keypoints)
constexpr int GROUP = 64;
constexpr int BLOCK = 64;

// shared memory of one keypoint group, in floats
constexpr int S2_SIZE = (SW - 1) * S2S + SW;
constexpr int RED_SIZE = 2 * 3 * (GROUP / 32);  // two buffers, used in turn
constexpr int GROUP_SMEM = S2_SIZE + TPL * TPL + EXT * EXT + RED_SIZE;

static_assert(GROUP % 32 == 0 && BLOCK % GROUP == 0, "whole warps per keypoint");
static_assert(GROUP == 32 || BLOCK / GROUP <= 15, "one named barrier per group");
static_assert(SW <= 64 && TPL <= 32, "row loads assume two columns per lane");

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// klt._extract_windows: clip(floor(c) - (HALF + 1) - MARGIN, 0, limit)
__device__ __forceinline__ int window_origin(float c, int limit) {
  float o = floorf(c) - (float)(HALF + 1 + MARGIN);
  o = fminf(fmaxf(o, 0.0f), (float)limit);  // NaN -> 0
  return (int)o;
}

// klt._blend_matrix: offset = i + f, i clamped to [0, SW - rows - 1]
__device__ __forceinline__ void blend(float offset, int rows, int& i, float& f) {
  const float fi = fminf(fmaxf(floorf(offset), 0.0f), (float)(SW - rows - 1));
  f = fminf(fmaxf(offset - fi, 0.0f), 1.0f);
  i = (int)fi;
}

// barrier over the G threads of one keypoint group; `bar` is the group's
// named barrier (unused for a warp)
template <int G>
__device__ __forceinline__ void group_sync(int bar) {
  if constexpr (G == 32) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(bar), "n"(G) : "memory");
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of K <= 3 per-thread values over the group; every thread receives the
// same totals (same summation order everywhere). Across warps the partial
// sums go through one of two buffers, chosen by the parity of `turn`, which
// the caller advances by one per call: a warp can only reach the call after
// next, which writes this buffer again, once every warp has passed the next
// call's barrier and so has read this one. One barrier per sum.
template <int G, int K>
__device__ __forceinline__ void group_sum(float (&v)[K], float* red, int t, int bar,
                                          int turn) {
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = warp_sum(v[k]);
  if constexpr (G > 32) {
    constexpr int NW = G / 32;
    float* buf = red + (turn & 1) * 3 * NW;
    if ((t & 31) == 0) {
#pragma unroll
      for (int k = 0; k < K; ++k) buf[k * NW + (t >> 5)] = v[k];
    }
    group_sync<G>(bar);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < NW; ++w) s += buf[k * NW + w];
      v[k] = s;
    }
  }
}

// 4-byte asynchronous copy from global to shared memory: the load needs no
// register and the thread does not wait for it until async_copy_wait()
__device__ __forceinline__ void async_copy(float* dst_shared, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst_shared)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void async_copy_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// One pyramid level for one keypoint, run by the G threads of its group
// (t = 0 .. G-1). px, py, gx0, gy0: template centre and initial guess in
// PADB-padded coordinates. sm: the group's GROUP_SMEM floats. Every thread
// returns the same tracked position (padded coordinates), min_eig and
// iteration count. With iterate == false the flow stays at the guess.
template <int G>
__device__ __forceinline__ void lk_level_body(
    const float* __restrict__ prev, const float* __restrict__ next, int H, int W,
    float px, float py, float gx0, float gy0, bool iterate, int iters, float eps2,
    float* sm, int t, int bar, float& out_x, float& out_y, float& min_eig,
    int& n_iter) {
  constexpr int NW = G / 32;
  constexpr int PER = (NPIX + G - 1) / G;  // 7 pixels per thread for G = 64
  float* s2 = sm;                   // next-image search window, stride S2S
  float* s1 = s2 + S2_SIZE;         // previous-image template source (24x24)
  float* ext = s1 + TPL * TPL;      // bilinear template with gradient ring
  float* red = ext + EXT * EXT;
  const int lane = t & 31, warp = t >> 5;
  const int Hp = H + 2 * PADB, Wp = W + 2 * PADB;

  const int oy1 = window_origin(py, Hp - SW), ox1 = window_origin(px, Wp - SW);
  const int oy2 = window_origin(gy0, Hp - SW), ox2 = window_origin(gx0, Wp - SW);

  // template offsets inside the previous-image window (klt.prepare_level)
  int iy1, ix1;
  float fy1, fx1;
  blend(py - (float)(HALF + 1) - (float)oy1, EXT, iy1, fy1);
  blend(px - (float)(HALF + 1) - (float)ox1, EXT, ix1, fx1);

  // the previous level's readers of this shared memory are done
  group_sync<G>(bar);

  // row-wise loads: a lane keeps its (clamped) columns, a warp walks rows;
  // all copies of both regions are in flight at once
  {
    const int x = clampi(ox1 + ix1 + lane - PADB, 0, W - 1);
    if (lane < TPL) {
#pragma unroll 4
      for (int r = warp; r < TPL; r += NW) {
        const int y = clampi(oy1 + iy1 + r - PADB, 0, H - 1);
        async_copy(s1 + r * TPL + lane, prev + y * W + x);
      }
    }
    const int x0 = clampi(ox2 + lane - PADB, 0, W - 1);
    const int x1 = clampi(ox2 + 32 + lane - PADB, 0, W - 1);
#pragma unroll 4
    for (int r = warp; r < SW; r += NW) {
      const float* row = next + clampi(oy2 + r - PADB, 0, H - 1) * W;
      async_copy(s2 + r * S2S + lane, row + x0);
      if (lane < SW - 32) async_copy(s2 + r * S2S + 32 + lane, row + x1);
    }
  }
  async_copy_wait();
  group_sync<G>(bar);

  for (int e = t; e < EXT * EXT; e += G) {
    const float* q = s1 + (e / EXT) * TPL + (e % EXT);
    ext[e] = (1.0f - fy1) * ((1.0f - fx1) * q[0] + fx1 * q[1]) +
             fy1 * ((1.0f - fx1) * q[TPL] + fx1 * q[TPL + 1]);
  }
  group_sync<G>(bar);

  // template, gradients, window offsets (all in registers) and the normal
  // matrix; a slot past the 441st pixel holds zeros and a harmless offset
  float tI[PER], tIx[PER], tIy[PER];
  int off[PER];
  float abc[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int p = t + j * G;
    tI[j] = tIx[j] = tIy[j] = 0.0f;
    off[j] = 0;
    if (p < NPIX) {
      const int r = p / WIN, u = p % WIN;
      const float* q = ext + (r + 1) * EXT + (u + 1);
      tI[j] = q[0];
      tIx[j] = 0.5f * (q[1] - q[-1]);
      tIy[j] = 0.5f * (q[EXT] - q[-EXT]);
      off[j] = r * S2S + u;
      abc[0] += tIx[j] * tIx[j];
      abc[1] += tIx[j] * tIy[j];
      abc[2] += tIy[j] * tIy[j];
    }
  }
  group_sum<G, 3>(abc, red, t, bar, 0);
  const float a = abc[0], b = abc[1], c = abc[2];
  const float det = a * c - b * b;
  const float tr = a + c;
  min_eig = 0.5f * (tr - sqrtf(fmaxf(tr * tr - 4.0f * det, 0.0f))) / (float)NPIX;
  const float inv_det = fabsf(det) > 1e-12f ? 1.0f / det : 0.0f;

  float flx = gx0 - px, fly = gy0 - py;
  n_iter = 0;
  if (iterate) {
    for (int it = 0; it < iters; ++it) {
      int iy, ix;
      float fy, fx;
      blend(py + fly - (float)HALF - (float)oy2, WIN, iy, fy);
      blend(px + flx - (float)HALF - (float)ox2, WIN, ix, fx);
      const float* base = s2 + iy * S2S + ix;
      const float w00 = (1.0f - fy) * (1.0f - fx), w01 = (1.0f - fy) * fx;
      const float w10 = fy * (1.0f - fx), w11 = fy * fx;
      float g[2] = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const float* q = base + off[j];
        const float J = w00 * q[0] + w01 * q[1] + w10 * q[S2S] + w11 * q[S2S + 1];
        const float res = tI[j] - J;
        g[0] += tIx[j] * res;
        g[1] += tIy[j] * res;
      }
      group_sum<G, 2>(g, red, t, bar, it + 1);
      const float dx = inv_det * (c * g[0] - b * g[1]);
      const float dy = inv_det * (a * g[1] - b * g[0]);
      flx += dx;
      fly += dy;
      ++n_iter;
      // same exit as the JAX trackers: stop once step^2 < eps^2 (or NaN)
      if (!(dx * dx + dy * dy >= eps2)) break;
    }
  }
  out_x = px + flx;
  out_y = py + fly;
}

template <int G>
__global__ void __launch_bounds__(BLOCK)
lk_level_kernel(const float* __restrict__ prev, const float* __restrict__ next,
                int H, int W, const float* __restrict__ pts,
                const float* __restrict__ guess, const uint8_t* __restrict__ valid,
                int n, int iters, float eps2, float* __restrict__ tracked,
                float* __restrict__ min_eig_out, int* __restrict__ iters_out) {
  __shared__ float sm[BLOCK / G][GROUP_SMEM];
  const int grp = threadIdx.x / G, t = threadIdx.x % G;
  const int k = blockIdx.x * (BLOCK / G) + grp;
  if (k >= n) return;  // the whole group leaves; barriers are per group
  float tx, ty, me;
  int nit;
  lk_level_body<G>(prev, next, H, W, pts[2 * k], pts[2 * k + 1], guess[2 * k],
                   guess[2 * k + 1], valid[k] != 0, iters, eps2, sm[grp], t,
                   grp + 1, tx, ty, me, nit);
  if (t == 0) {
    tracked[2 * k] = tx;
    tracked[2 * k + 1] = ty;
    min_eig_out[k] = me;
    if (iters_out != nullptr) iters_out[k] = nit;
  }
}

// klt.lk_track_pyramid for one keypoint: track (px, py) from pyramid A to
// pyramid B starting at the prediction; the float operations keep the order
// of the plain version (divide by 2^L, add PADB, subtract it, times 2; the
// scalings are exact). Returns the status of the track.
template <int G>
__device__ __forceinline__ bool track_pyramid(
    const float* const* A, const float* const* B, const int* Hs, const int* Ws,
    int levels, float px, float py, float pred_x, float pred_y, bool valid,
    int iters, float eps2, float min_eig_thresh, float* sm, int t, int bar,
    float& out_x, float& out_y) {
  const float inv_top = 1.0f / (float)(1 << (levels - 1));
  float gx = px * inv_top + (pred_x - px) * inv_top;
  float gy = py * inv_top + (pred_y - py) * inv_top;
  float min_eig = 0.0f;
  for (int L = levels - 1; L >= 0; --L) {
    const float inv_s = 1.0f / (float)(1 << L);
    const float lx = px * inv_s + (float)PADB, ly = py * inv_s + (float)PADB;
    const float qx = gx + (float)PADB, qy = gy + (float)PADB;
    float tx, ty;
    if (valid) {
      int nit;
      lk_level_body<G>(A[L], B[L], Hs[L], Ws[L], lx, ly, qx, qy, true, iters,
                       eps2, sm, t, bar, tx, ty, min_eig, nit);
    } else {  // the flow stays at the guess
      tx = lx + (qx - lx);
      ty = ly + (qy - ly);
    }
    tx -= (float)PADB;
    ty -= (float)PADB;
    gx = L > 0 ? tx * 2.0f : tx;
    gy = L > 0 ? ty * 2.0f : ty;
  }
  out_x = gx;
  out_y = gy;
  const int H = Hs[0], W = Ws[0];
  const float dx = gx - px, dy = gy - py;
  const bool inb = gx >= (float)HALF && gx < (float)(W - HALF) &&
                   gy >= (float)HALF && gy < (float)(H - HALF);
  const bool finite = isfinite(gx) && isfinite(gy);
  // reference opencv_image.cpp: max displacement rows / 4
  return valid && inb && finite && sqrtf(dx * dx + dy * dy) < (float)H / 4.0f &&
         min_eig > min_eig_thresh;
}

template <int G>
__global__ void __launch_bounds__(BLOCK)
lk_fwd_rev_kernel(const __grid_constant__ Pyramids pyr, const float* __restrict__ pts,
                  const float* __restrict__ pred, const uint8_t* __restrict__ valid,
                  int n, int iters, float eps2, float min_eig_thresh, float max_err,
                  float* __restrict__ tracked, uint8_t* __restrict__ status) {
  __shared__ float sm[BLOCK / G][GROUP_SMEM];
  const int grp = threadIdx.x / G, t = threadIdx.x % G;
  const int k = blockIdx.x * (BLOCK / G) + grp;
  if (k >= n) return;  // the whole group leaves; barriers are per group
  const float px = pts[2 * k], py = pts[2 * k + 1];
  float tx, ty;
  bool st = track_pyramid<G>(pyr.prev, pyr.next, pyr.H, pyr.W, pyr.levels, px, py,
                             pred[2 * k], pred[2 * k + 1], valid[k] != 0, iters,
                             eps2, min_eig_thresh, sm[grp], t, grp + 1, tx, ty);
  if (st) {
    // reverse-flow check (reference opencv_image.cpp:130-150): track back
    // from the forward result and require it to land within max_err px
    float bx, by;
    st = track_pyramid<G>(pyr.next, pyr.prev, pyr.H, pyr.W, pyr.levels, tx, ty, px,
                          py, true, iters, eps2, min_eig_thresh, sm[grp], t,
                          grp + 1, bx, by);
    const float ex = bx - px, ey = by - py;
    st = st && sqrtf(ex * ex + ey * ey) <= max_err;
  }
  if (t == 0) {
    tracked[2 * k] = tx;
    tracked[2 * k + 1] = ty;
    status[k] = st ? 1 : 0;
  }
}

}  // namespace

// Plain C entry points (loaded with ctypes). Both launch on `stream`, do not
// synchronise, allocate nothing and return cudaGetLastError().

// One level. Inputs: level images (H, W) f32, pts / guess (n, 2) f32 [x, y]
// in PADB-padded coordinates, valid (n,) bool bytes, eps2 the squared step
// threshold. Outputs: tracked (n, 2) f32 in padded coordinates, min_eig (n,)
// f32 and, unless iters_out is null, the iterations run per keypoint (n,)
// int32.
extern "C" int rdvio_lk_level(const float* prev, const float* next, int H, int W,
                              const float* pts, const float* guess,
                              const uint8_t* valid, int n, int iters, float eps2,
                              float* tracked, float* min_eig, int* iters_out,
                              void* stream) {
  if (n <= 0) return 0;
  constexpr int KPB = BLOCK / GROUP;
  lk_level_kernel<GROUP><<<(n + KPB - 1) / KPB, BLOCK, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      prev, next, H, W, pts, guess, valid, n, iters, eps2, tracked, min_eig,
      iters_out);
  return static_cast<int>(cudaGetLastError());
}

// The whole forward + reverse track. pyr: level pointers and sizes, fine to
// coarse, passed on to the kernel by value. pts / pred (n, 2) f32 [x, y] in
// image coordinates, valid (n,) bool bytes. Outputs: tracked (n, 2) f32,
// status (n,) bool bytes.
extern "C" int rdvio_lk_fwd_rev(const Pyramids* pyr, const float* pts,
                                const float* pred, const uint8_t* valid, int n,
                                int iters, float eps2, float min_eig_thresh,
                                float max_err, float* tracked, uint8_t* status,
                                void* stream) {
  if (n <= 0) return 0;
  if (pyr->levels < 1 || pyr->levels > MAX_LEVELS)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int KPB = BLOCK / GROUP;
  lk_fwd_rev_kernel<GROUP><<<(n + KPB - 1) / KPB, BLOCK, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      *pyr, pts, pred, valid, n, iters, eps2, min_eig_thresh, max_err, tracked,
      status);
  return static_cast<int>(cudaGetLastError());
}
