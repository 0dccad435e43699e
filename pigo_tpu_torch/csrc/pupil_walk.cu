// Pupil/landmark regression-tree walk for Hopper (sm_90a), kernel C: one
// warp per walker, one lane per tree, every stage of the cascade in one
// launch.
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
//             clamp(max(0, ri + qcos*k0 - qsin*cs*k1) >> 16) (and the
//             column likewise) and bintest p1 <= p2 (a reference quirk);
//   each tree walks `depth` levels from its root to a leaf;
//   dr, dc = the leaves' (dr, cs*dc) summed over trees strictly in tree
//   order from tree 0; then r += dr*s, c += dc*s, s *= scale_mult.
// Every f32 product and sum is an explicit round-to-nearest intrinsic
// (__fmul_rn / __fadd_rn, never contracted into an FMA), and the build
// passes --fmad=false as well (pigo_tpu_torch/utils/build.py). `>>` on a
// negative int is a floor shift, as in torch and NumPy.
//
// What bounds it: not bytes. One launch reads the pixels its probes hit,
// the code words and leaves its walkers visit, and 32 B of walker state
// per walker: a few MB at most, microseconds at 3.35 TB/s. A walker's
// result is the end of a chain of stages x depth levels (5 x 10 for
// puploc, 6 x 9 for the landmark cascades), each level's loads depending
// on the previous level's pixel compare. The T (<= 32) trees of a stage
// are independent, so they walk in parallel lanes and the chain of a stage
// is one tree's depth, not T x depth. At one face (126 eye walkers, 945
// landmark walkers) what is left is the latency of each level's loads, L1
// or L2 round trips; at 15 faces (14,175 landmark walkers, more warps than
// the card holds at once) it is the throughput of those scattered loads
// and of the warps' instructions.
//
// What the design does about it:
//   - Both children's code words beside the pixels. The card's codes are
//     stored one word into their buffer (convert.card_codes), so that from
//     the word before them node k of each tree sits at 1-based slot k + 1,
//     as in kernel A's layout: the children of 1-based node j are 2j and
//     2j + 1, one aligned 8-byte word. A level loads that pair together
//     with its two pixels, so it waits on the pixels alone; it used to wait
//     on its own code word, then on the pixels. The pair costs no more
//     load wavefronts than one 4-byte word: the lanes' trees lie far apart,
//     one sector each either way.
//   - Both leaves beside the last level's pixels. The two candidate leaves
//     of a last-level node, (2j, 2j + 1) - L, start at an even index: one
//     aligned 16-byte (dr, dc, dr, dc) load, issued with the last pixel
//     pair, so the leaf is off the chain as well.
//   - The ordered sum over a compile-time 32 trees (tree j added when
//     j < T), so the shuffles are unrolled off the add chain. The adds are
//     still strictly in tree order from tree 0, one __fadd_rn a tree.
//   - kWarpsPerBlock = 8 walkers a block. The 63 walkers of one anchor are
//     consecutive (ops/pupil_dense.walker_starts), so a larger block keeps
//     more of an anchor's walkers, which read overlapping pixels and the
//     same trees, on one SM's L1; a smaller one spreads a small launch over
//     more SMs.
// On an H100 (pigo_tpu_torch/tools/face_sweep.py; PERF.md) the one-face
// launches fell by 14-25% and the 15-face ones by 8-10%; a level still
// waits on one L1/L2 round trip for its pixels.
//
// Measured and rejected (same tool; "one face" and "15 faces" as above):
//   - Loading the next stage's roots during a stage (they do not depend on
//     the walk): 1-2% slower at one face and 3% at 15 faces.
//   - The runtime-trip sum loop: 4-5% slower at one face, 3% faster at 15
//     faces, where the unrolled loop's 24 idle shuffles a stage (T = 20)
//     cost issue slots. The sum through shared memory (each lane stores
//     its leaf, every lane reads them back two trees to a 16-byte load):
//     4% slower at one face and 5% faster at 15 faces, or with 16 walkers
//     a block 10% slower and 19% faster.
//   - Blocks of 4 walkers: as fast at one face, 19% slower at 15 faces; of
//     16: 13% slower at one face, 12% faster at 15 faces; of 32: slower
//     than 16 at both.
//   - Staging a stage's tables in shared memory (not built). One puploc
//     stage's codes are 20 trees x 1024 nodes x 4 B = 80 KB, of which a
//     walker reads 10 code words a tree, and the walkers of a block may
//     belong to different landmark cascades (9 x 6 stages of 20 x 512
//     nodes): a block would stage far more than it reads, and the code
//     words it would save are now loaded beside the pixels, off the chain.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float round_half_away(float x) {
  return x >= 0.0f ? floorf(__fadd_rn(x, 0.5f)) : ceilf(__fsub_rn(x, 0.5f));
}

__device__ __forceinline__ int clamp_index(int v, int n) {
  return min(max(v, 0), n - 1);
}

__device__ __forceinline__ char4 unpack(int k) {
  return make_char4((signed char)k, (signed char)(k >> 8),
                    (signed char)(k >> 16), (signed char)(k >> 24));
}

// One stage's probe geometry for a walker at (r, c, s).
template <bool kRotated>
struct Probe {
  const uint8_t* pixels;
  int nrows, ncols, dim, cs, ri, ci, si, qsin, qcos;

  // bintest of node code k: p1 > p2 upright, p1 <= p2 rotated
  __device__ __forceinline__ bool operator()(char4 k) const {
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
    return kRotated ? (p1 <= p2) : (p1 > p2);
  }
};

template <bool kRotated>
__global__ void __launch_bounds__(32 * kWarpsPerBlock) pupil_walk_kernel(
    const uint8_t* __restrict__ pixels,  // [nrows * dim], row stride dim
    int nrows, int ncols, int dim,
    const char4* __restrict__ codes1,    // the word before the codes
                                         // [NC, S, T, 1 << depth]
    const float4* __restrict__ leaf_pairs,  // preds [NC, S, T, L / 2]
                                            // (dr, dc, dr, dc)
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
  const long long stage_nodes = (long long)trees * leaves;
  float r = __ldg(r0 + w);
  float c = __ldg(c0 + w);
  float s = __ldg(s0 + w);
  // this lane's tree in stage 0 (lanes past T walk no tree)
  long long tree = casc_base + (long long)lane * leaves;

  for (int i = 0; i < stages; ++i, tree += stage_nodes) {
    Probe<kRotated> bintest{pixels, nrows, ncols, dim, cs, 0, 0, 0, 0, 0};
    if constexpr (kRotated) {
      bintest.qsin = static_cast<int>(__fmul_rn(s, qsin_v));
      bintest.qcos = static_cast<int>(__fmul_rn(s, qcos_v));
      bintest.ri = 65536 * static_cast<int>(r);
      bintest.ci = 65536 * static_cast<int>(c);
    } else {
      bintest.ri = 256 * static_cast<int>(r);
      bintest.ci = 256 * static_cast<int>(c);
      bintest.si = static_cast<int>(round_half_away(s));
    }
    float dr_t = 0.0f, dc_t = 0.0f;
    if (lane < trees) {
      const char4* node = codes1 + tree;  // 1-based: node j at node[j]
      char4 code = __ldg(node + 1);
      int j = 1;
      for (int d = 0; d + 1 < depth; ++d) {
        const int2 kids = __ldg(reinterpret_cast<const int2*>(node) + j);
        const bool bit = bintest(code);
        j = 2 * j + (bit ? 1 : 0);
        code = unpack(bit ? kids.y : kids.x);
      }
      // the last level: leaves (2j, 2j + 1) - L, a 16-byte pair
      const float4 pair = __ldg(leaf_pairs + (tree >> 1) + (j - leaves / 2));
      const bool bit = bintest(code);
      dr_t = bit ? pair.z : pair.x;
      dc_t = __fmul_rn(sign, bit ? pair.w : pair.y);
    }
    // strict left-to-right f32 sum over trees, from tree 0
    float dr = __shfl_sync(kFullMask, dr_t, 0);
    float dc = __shfl_sync(kFullMask, dc_t, 0);
#pragma unroll
    for (int t = 1; t < 32; ++t) {
      const float vr = __shfl_sync(kFullMask, dr_t, t);
      const float vc = __shfl_sync(kFullMask, dc_t, t);
      if (t < trees) {
        dr = __fadd_rn(dr, vr);
        dc = __fadd_rn(dc, vc);
      }
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

// Plain C entry point (bound with ctypes). `codes` is the card's copy of
// the codes [NC, S, T, L, 4] (the word before it is 8-byte aligned), `preds`
// [NC, S, T, L, 2] is 16-byte aligned. Launches on `stream`, does not
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
      static_cast<const char4*>(codes) - 1,
      static_cast<const float4*>(preds), num_cascades, stages, trees, depth,
      scale_mult, qsin_v, qcos_v, static_cast<const int*>(casc_id),
      static_cast<const int*>(col_sign), static_cast<const float*>(r0),
      static_cast<const float*>(c0), static_cast<const float*>(s0), n,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The walk's schedule constant: out[0] = walkers (warps) a block.
extern "C" void pigo_pupil_schedule(int* out) { out[0] = kWarpsPerBlock; }

extern "C" const char* pigo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
