// Pupil/landmark regression-tree walk for Hopper (sm_90a): one warp per
// walker, one lane per tree, every stage of the cascade in one launch.
//
// Replaces the TPU kernel pigo_tpu/ops/pupil_pallas.py::_stage_kernel
// (launched once per stage per patch geometry), which keeps an image patch
// per walk group in VMEM, reads probe pixels with one-hot matmuls, and
// returns an overflow flag when a probe leaves the patch so that the
// caller re-runs that group on the gather path. None of that carries over:
// here every probe reads the frame (a few MB at most, resident in the
// 50 MB L2) at its clamped address, so there is no patch, no overflow flag
// and no retry.
//
// Per walker (reference core/puploc.go:106-217), for each stage:
//   upright:  ri = 256*int(r), ci = 256*int(c), si = round_half_away(s);
//             probe (clamp((ri + k0*si) >> 8), clamp((ci + cs*k1*si) >> 8))
//             and bintest p1 > p2;
//   rotated:  qsin = int(s*QSIN[a]), qcos = int(s*QCOS[a]),
//             ri = 65536*int(r), ci = 65536*int(c); probe
//             clamp(max(0, ri + qcos*k0 - qsin*cs*k1) >> 16) (and the column
//             likewise) and bintest p1 <= p2 (a reference quirk);
//   each tree walks `depth` levels from node 0 (idx = 2*idx + 1 + bit);
//   dr, dc = the leaves' (dr, cs*dc) summed over trees strictly in tree
//   order from tree 0; then r += dr*s, c += dc*s, s *= scale_mult.
// Every f32 product and sum is an explicit round-to-nearest intrinsic
// (__fmul_rn / __fadd_rn, never contracted into an FMA), and the build
// passes --fmad=false as well (pigo_tpu_torch/utils/build.py). `>>` on a
// negative int is a floor shift, as in torch and NumPy.
//
// What bounds it: not bytes. One launch reads the pixels its probes hit,
// the code words and leaves its walkers visit, and 32 B of walker state
// per walker: a few MB at most, microseconds at 3.35 TB/s. Each walker's result is the end of
// a chain of stages x depth dependent code-word -> pixel loads (5 x 10 = 50
// for puploc, 6 x 9 = 54 for the landmark cascades), each load's address
// depending on the previous pixel compare. The kernel's time is that
// chain's latency.
// What the design does about it: the T (<= 32) trees of a stage are
// independent, so they walk in parallel lanes and the dependent chain per
// stage is one tree's depth, not T x depth. The in-order tree sum is a
// loop of warp shuffles that every lane computes alike, so the new (r, c,
// s) is in every lane without a broadcast; the stages loop inside the
// kernel, so nothing crosses blocks or launches. Tables stay in global
// memory behind __ldg: a block's walkers may belong to different landmark
// cascades (up to 9 x 737 KB of tables), so shared-memory staging buys
// little before walkers are grouped by cascade.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float round_half_away(float x) {
  return x >= 0.0f ? floorf(__fadd_rn(x, 0.5f)) : ceilf(__fsub_rn(x, 0.5f));
}

__device__ __forceinline__ int clamp_index(int v, int n) {
  return min(max(v, 0), n - 1);
}

template <bool kRotated>
__global__ void pupil_walk_kernel(
    const uint8_t* __restrict__ pixels,  // [nrows * dim], row stride dim
    int nrows, int ncols, int dim,
    const char4* __restrict__ codes,     // [NC, S, T, 1 << depth]
    const float2* __restrict__ preds,    // [NC, S, T, 1 << depth] (dr, dc)
    int num_cascades, int stages, int trees, int depth, float scale_mult,
    float qsin_v, float qcos_v,          // rotated only
    const int* __restrict__ casc_id,     // [n], each in [0, NC)
    const int* __restrict__ col_sign,    // [n] +1 or -1 (vertical flip)
    const float* __restrict__ r0, const float* __restrict__ c0,
    const float* __restrict__ s0,        // [n] walker starts
    long long n, float* __restrict__ out)  // [3, n] = (r, c, s)
{
  const long long w = blockIdx.x * (long long)kWarpsPerBlock
                      + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (w >= n) return;  // the whole warp: one walker per warp
  const int leaves = 1 << depth;
  const int cs = __ldg(col_sign + w);
  const float sign = static_cast<float>(cs);
  const int cid = __ldg(casc_id + w);
  // An id outside the stacked forest faults the launch before any table
  // read, as a device-side index check does (the wrapper checks host ids).
  if (cid < 0 || cid >= num_cascades) __trap();
  const long long casc_base = (long long)cid * stages * trees * leaves;
  float r = __ldg(r0 + w);
  float c = __ldg(c0 + w);
  float s = __ldg(s0 + w);

  for (int i = 0; i < stages; ++i) {
    int ri, ci, si = 0, qsin = 0, qcos = 0;
    if constexpr (kRotated) {
      qsin = static_cast<int>(__fmul_rn(s, qsin_v));
      qcos = static_cast<int>(__fmul_rn(s, qcos_v));
      ri = 65536 * static_cast<int>(r);
      ci = 65536 * static_cast<int>(c);
    } else {
      ri = 256 * static_cast<int>(r);
      ci = 256 * static_cast<int>(c);
      si = static_cast<int>(round_half_away(s));
    }
    float dr_t = 0.0f, dc_t = 0.0f;
    if (lane < trees) {
      const long long tree = casc_base + ((long long)i * trees + lane) * leaves;
      const char4* node = codes + tree;
      int idx = 0;
      for (int d = 0; d < depth; ++d) {
        const char4 k = __ldg(node + idx);
        int r1, c1, r2, c2;
        if constexpr (kRotated) {
          const int col1 = cs * k.y, col2 = cs * k.w;
          r1 = clamp_index(max(0, ri + qcos * k.x - qsin * col1) >> 16, nrows);
          c1 = clamp_index(max(0, ci + qsin * k.x + qcos * col1) >> 16, ncols);
          r2 = clamp_index(max(0, ri + qcos * k.z - qsin * col2) >> 16, nrows);
          c2 = clamp_index(max(0, ci + qsin * k.z + qcos * col2) >> 16, ncols);
        } else {
          r1 = clamp_index((ri + k.x * si) >> 8, nrows);
          r2 = clamp_index((ri + k.z * si) >> 8, nrows);
          c1 = clamp_index((ci + cs * k.y * si) >> 8, ncols);
          c2 = clamp_index((ci + cs * k.w * si) >> 8, ncols);
        }
        const int p1 = __ldg(pixels + (long long)r1 * dim + c1);
        const int p2 = __ldg(pixels + (long long)r2 * dim + c2);
        const bool bit = kRotated ? (p1 <= p2) : (p1 > p2);
        idx = 2 * idx + 1 + (bit ? 1 : 0);
      }
      const float2 leaf = __ldg(preds + tree + (idx - (leaves - 1)));
      dr_t = leaf.x;
      dc_t = __fmul_rn(sign, leaf.y);
    }
    // strict left-to-right f32 sum over trees, from tree 0
    float dr = __shfl_sync(kFullMask, dr_t, 0);
    float dc = __shfl_sync(kFullMask, dc_t, 0);
    for (int t = 1; t < trees; ++t) {
      dr = __fadd_rn(dr, __shfl_sync(kFullMask, dr_t, t));
      dc = __fadd_rn(dc, __shfl_sync(kFullMask, dc_t, t));
    }
    r = __fadd_rn(r, __fmul_rn(dr, s));
    c = __fadd_rn(c, __fmul_rn(dc, s));
    s = __fmul_rn(s, scale_mult);
  }
  if (lane == 0) {
    out[w] = r;
    out[n + w] = c;
    out[2 * n + w] = s;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream`, does not
// synchronise, allocates nothing; returns cudaGetLastError() of the launch.
extern "C" int pigo_pupil_walk(
    const void* pixels, int nrows, int ncols, int dim,
    const void* codes, const void* preds, int num_cascades, int stages,
    int trees, int depth,
    float scale_mult, int rotated, float qsin_v, float qcos_v,
    const void* casc_id, const void* col_sign,
    const void* r0, const void* c0, const void* s0, long long n,
    void* out, void* stream) {
  if (n == 0) return 0;
  const long long blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  auto kernel = rotated ? pupil_walk_kernel<true> : pupil_walk_kernel<false>;
  kernel<<<(unsigned)blocks, 32 * kWarpsPerBlock, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(pixels), nrows, ncols, dim,
      static_cast<const char4*>(codes), static_cast<const float2*>(preds),
      num_cascades, stages, trees, depth, scale_mult, qsin_v, qcos_v,
      static_cast<const int*>(casc_id), static_cast<const int*>(col_sign),
      static_cast<const float*>(r0), static_cast<const float*>(c0),
      static_cast<const float*>(s0), n, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pigo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
