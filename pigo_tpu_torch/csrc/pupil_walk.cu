// Pupil/landmark regression-tree walk for Hopper (sm_90a), kernel C: one
// warp per walker, one lane per tree, every stage of the cascade in one
// launch. Two modes share the walk's device code (`walk`): the plain walk
// of given starts (pigo_pupil_walk), and the ensemble (pigo_pupil_ensemble),
// which also jitters each walker's start and votes each group's median,
// so that a frame's post stage is two launches (below).
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
// The ensemble mode. A launch walks G groups of P walkers (the post
// stage's perturbations: P = 63). For each group it takes an anchor (row,
// col, scale), a cascade id and a flip, and the row of the uniforms
// [R, P, 3] that feeds it; walker p reads u[(row * P + p) * 3 + k].
//   - Jitter, as ops/pupil_dense.make_perturbations, one rounding an
//     operation in its order: j = scale * 0.15f; r = row + j * (0.5f -
//     u0); c = col + j * (0.5f - u1); s = scale * (0.925f + 0.15f * u2).
//   - Landmark anchors (the second launch): a group with no anchor takes
//     face g / npts's from the eye medians the first launch wrote, as
//     pigo_tpu_torch.detector.landmark_anchors: the medians truncated,
//     d and e their differences, dist = sqrt(d * d + e * e), row =
//     trunc((l + r) / 2 + 0.25f * dist), col = trunc((l + r) / 2 + 0.15f *
//     dist), scale = 3 * dist; __fsqrt_rn and __fdiv_rn are the correctly
//     rounded f32 sqrt and division that torch's kernels compute.
//   - The vote: the element at index mid = round(P / 2), clamped, of
//     torch.sort's order, per axis. Floats are compared as unsigned keys
//     (order_key); the walker whose key has `mid` keys before it, ties
//     broken by walker index, is the median. That is the order torch.sort
//     gives more than 32 votes on the card (P = 63): stable, with -0.0 and
//     +0.0 equal (measured at P = 33 to 200), so the result is bit for bit
//     the sort's. Of 2 to 32 votes its order of a -0.0 and a +0.0 is
//     another (measured); any other equal votes have equal bits, and a
//     walk ends at -0.0 only from an anchor of scale 0.
//   - Placement: one group per thread-block cluster of min(8, ceil(P / 8))
//     blocks of kWarpsPerBlock walkers (64 warp slots for P = 63, so the
//     block keeps the 8 warps measured above; a wider group walks in
//     rounds). Each walker stores its (r, c, s) into the shared memory of
//     the cluster's first block (distributed shared memory); after a
//     cluster barrier that block's threads rank the 3P values and write
//     the medians. A block arrives on the cluster barrier at its start and
//     waits before its first remote store, so the first block's shared
//     memory exists when it is written, and the walk overlaps the wait.
//     The cluster primitives are inline PTX, as CUTLASS writes them:
//     with cooperative_groups' header the library took 5.8-6.6 s to build
//     against 3.1-3.2 s (3.2 and 2.8 s before the ensemble mode).
// On an H100 (tools/face_sweep.py, case post: both launches of a frame's
// post stage; PERF.md) the two launches take 0.041 ms at one face and
// 0.171 ms at 15, against 0.039 and 0.154 ms for the plain walks alone,
// which the composition around them (jitter, three sorts a walk, landmark
// anchors: some 30 small kernels) surrounded.
//
// Measured and rejected (same tool; "one face" and "15 faces" as above):
//   - The ensemble's vote by ticket: a group's blocks run independent, each
//     stores its walkers' results in global scratch, and the last block to
//     arrive (an atomicInc ticket that resets itself) reads them back and
//     selects. 15% slower at one face (0.047 against 0.041 ms), 1.5% faster
//     at 15 faces (0.169 against 0.171), and it needs a scratch buffer and
//     zeroed tickets on every launch's stream. Clusters of at most 4
//     blocks (32 walkers at once, two rounds): 73% slower at one face and
//     14% at 15 faces.
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
// The most blocks of one ensemble group's thread-block cluster (the
// portable cluster size): 64 walkers of a group walk at once.
constexpr int kEnsembleBlocks = 8;
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

// What every walker of a launch reads: the frame and the stacked forest.
struct Forest {
  const uint8_t* pixels;  // [nrows * dim], row stride dim
  int nrows, ncols, dim;
  const char4* codes1;    // the word before the codes [NC, S, T, 1 << depth]
  const float4* leaf_pairs;  // preds [NC, S, T, L / 2] (dr, dc, dr, dc)
  int num_cascades, stages, trees, depth;
  float scale_mult, qsin_v, qcos_v;  // qsin_v, qcos_v: rotated only
};

// One walker's every stage, in the calling warp (lane = its tree): (r, c,
// s) in, refined (r, c, s) out, the same in every lane.
template <bool kRotated>
__device__ __forceinline__ void walk(const Forest& f, int lane, int cid,
                                     int cs, float& r, float& c, float& s) {
  // An id outside the stacked forest faults the launch before any table
  // read, as a device-side index check does (the wrapper checks host ids).
  if (cid < 0 || cid >= f.num_cascades) __trap();
  const int leaves = 1 << f.depth;
  const float sign = static_cast<float>(cs);
  const long long stage_nodes = (long long)f.trees * leaves;
  // this lane's tree in stage 0 (lanes past T walk no tree)
  long long tree = (long long)cid * f.stages * stage_nodes
                   + (long long)lane * leaves;

  for (int i = 0; i < f.stages; ++i, tree += stage_nodes) {
    Probe<kRotated> bintest{f.pixels, f.nrows, f.ncols, f.dim, cs,
                            0, 0, 0, 0, 0};
    if constexpr (kRotated) {
      bintest.qsin = static_cast<int>(__fmul_rn(s, f.qsin_v));
      bintest.qcos = static_cast<int>(__fmul_rn(s, f.qcos_v));
      bintest.ri = 65536 * static_cast<int>(r);
      bintest.ci = 65536 * static_cast<int>(c);
    } else {
      bintest.ri = 256 * static_cast<int>(r);
      bintest.ci = 256 * static_cast<int>(c);
      bintest.si = static_cast<int>(round_half_away(s));
    }
    float dr_t = 0.0f, dc_t = 0.0f;
    if (lane < f.trees) {
      const char4* node = f.codes1 + tree;  // 1-based: node j at node[j]
      char4 code = __ldg(node + 1);
      int j = 1;
      for (int d = 0; d + 1 < f.depth; ++d) {
        const int2 kids = __ldg(reinterpret_cast<const int2*>(node) + j);
        const bool bit = bintest(code);
        j = 2 * j + (bit ? 1 : 0);
        code = unpack(bit ? kids.y : kids.x);
      }
      // the last level: leaves (2j, 2j + 1) - L, a 16-byte pair
      const float4 pair =
          __ldg(f.leaf_pairs + (tree >> 1) + (j - leaves / 2));
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
      if (t < f.trees) {
        dr = __fadd_rn(dr, vr);
        dc = __fadd_rn(dc, vc);
      }
    }
    r = __fadd_rn(r, __fmul_rn(dr, s));
    c = __fadd_rn(c, __fmul_rn(dc, s));
    s = __fmul_rn(s, f.scale_mult);
  }
}

// The plain walk: one walker per warp from given starts.
template <bool kRotated>
__global__ void __launch_bounds__(32 * kWarpsPerBlock) pupil_walk_kernel(
    const Forest f,
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
  float r = __ldg(r0 + w);
  float c = __ldg(c0 + w);
  float s = __ldg(s0 + w);
  walk<kRotated>(f, lane, __ldg(casc_id + w), __ldg(col_sign + w), r, c, s);
  if (lane == 0) {
    out[w] = r;
    out[n + w] = c;
    out[2 * n + w] = s;
  }
}

// The ensemble: G groups of P jittered walkers and each group's median.
struct Ensemble {
  Forest f;
  const int* casc_id;       // [G], or null: cascade 0
  const uint8_t* flips;     // [G] bool, or null: no flip
  // [G] anchors each, or null: group g anchors on face g / npts's
  // landmark anchor, from the eye medians in out's columns 2 (g / npts)
  // (left) and 2 (g / npts) + 1 (right)
  const float *anchor_r, *anchor_c, *anchor_s;
  int npts;
  const float* u;           // [u_nrows, P, 3] uniforms
  const long long* u_rows;  // [G] group g's row of u, or null: row g
  long long u_nrows, groups;
  int perturbs, mid;        // P; the median's index in sorted order
  float* out;               // [3, out_stride]: group g's median at
  long long out_stride, out_col0;  // column out_col0 + g
};

// pigo_tpu_torch.detector.landmark_anchors for one face, in its order of
// f32 roundings: the voted eyes truncated, then the geometry.
__device__ __forceinline__ void landmark_anchor(const Ensemble& e,
                                                long long face, float& row,
                                                float& col, float& scale) {
  const float* eyes = e.out + 2 * face;
  const float ler = truncf(eyes[0]), rer = truncf(eyes[1]);
  const float lec = truncf(eyes[e.out_stride]);
  const float rec = truncf(eyes[e.out_stride + 1]);
  const float d = __fsub_rn(ler, rer), dc = __fsub_rn(lec, rec);
  const float dist =
      __fsqrt_rn(__fadd_rn(__fmul_rn(d, d), __fmul_rn(dc, dc)));
  row = truncf(__fadd_rn(__fdiv_rn(__fadd_rn(ler, rer), 2.0f),
                         __fmul_rn(0.25f, dist)));
  col = truncf(__fadd_rn(__fdiv_rn(__fadd_rn(lec, rec), 2.0f),
                         __fmul_rn(0.15f, dist)));
  scale = __fmul_rn(3.0f, dist);
}

// Thread-block cluster primitives (PTX, sm_90), as CUTLASS writes them.
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_blocks() {
  unsigned n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(n));
  return n;
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// Every block's stores before it are seen by every block after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\n\t"
               "barrier.cluster.wait.aligned;" ::: "memory");
}

// Stores v at `addr`, a place in this block's shared memory, in the
// shared memory of the cluster's block `rank`.
__device__ __forceinline__ void store_in_block(float* addr, unsigned rank,
                                               float v) {
  const unsigned local =
      static_cast<unsigned>(__cvta_generic_to_shared(addr));
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote) : "r"(local), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;"
               :: "r"(remote), "f"(v) : "memory");
}

// A float's place in torch.sort's order as an unsigned key. -0.0 and
// +0.0 get one key: the card's sort of a group's votes holds them equal
// and keeps them in walker order, as it does every tie.
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned b = v == 0.0f ? 0u : __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// One group per thread-block cluster; its walkers' results meet in the
// shared memory of the cluster's first block, which selects the medians.
template <bool kRotated>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
pupil_walk_kernel_ensemble(const Ensemble e) {
  extern __shared__ float votes[];  // the first block's: [3, P]
  const unsigned blocks = cluster_blocks(), rank = cluster_rank();
  const long long g = blockIdx.x / blocks;
  const int lane = threadIdx.x % 32;
  const int P = e.perturbs;
  const int slots = blocks * kWarpsPerBlock;
  // Arrive now, wait before the first store into the first block's
  // shared memory: by then every block of the cluster has started.
  cluster_arrive_relaxed();
  float row0, col0, scale0;
  if (e.anchor_r != nullptr) {
    row0 = __ldg(e.anchor_r + g);
    col0 = __ldg(e.anchor_c + g);
    scale0 = __ldg(e.anchor_s + g);
  } else {
    landmark_anchor(e, g / e.npts, row0, col0, scale0);
  }
  const int cid = e.casc_id != nullptr ? __ldg(e.casc_id + g) : 0;
  const int cs = (e.flips != nullptr && __ldg(e.flips + g)) ? -1 : 1;
  long long row = g;
  if (e.u_rows != nullptr) {
    row = __ldg(e.u_rows + g);
    if (row < 0 || row >= e.u_nrows) __trap();
  }
  const float* u = e.u + row * P * 3;
  // pupil_dense.make_perturbations: one f32 rounding an operation
  const float jitter = __fmul_rn(scale0, 0.15f);
  const int rounds = (P + slots - 1) / slots;
  for (int k = 0; k < rounds; ++k) {
    const int p = k * slots + rank * kWarpsPerBlock + threadIdx.x / 32;
    float r = 0.0f, c = 0.0f, s = 0.0f;
    if (p < P) {  // the whole warp
      const float* up = u + 3 * p;
      r = __fadd_rn(row0, __fmul_rn(jitter, __fsub_rn(0.5f, __ldg(up))));
      c = __fadd_rn(col0, __fmul_rn(jitter, __fsub_rn(0.5f, __ldg(up + 1))));
      s = __fmul_rn(scale0,
                    __fadd_rn(0.925f, __fmul_rn(0.15f, __ldg(up + 2))));
      walk<kRotated>(e.f, lane, cid, cs, r, c, s);
    }
    if (k == 0) cluster_wait();
    if (p < P && lane == 0) {
      store_in_block(votes + p, 0, r);
      store_in_block(votes + P + p, 0, c);
      store_in_block(votes + 2 * P + p, 0, s);
    }
  }
  cluster_sync();  // the votes are in; only the first block goes on
  if (rank != 0) return;
  // Each (axis, walker) counts the votes that sort before it (ties by
  // walker index); the one with `mid` below it is the median.
  for (int i = threadIdx.x; i < 3 * P; i += blockDim.x) {
    const int axis = i / P, p = i - axis * P;
    const float* v = votes + axis * P;
    const unsigned key = order_key(v[p]);
    int below = 0;
    for (int j = 0; j < P; ++j) {
      const unsigned kj = order_key(v[j]);
      below += (kj < key) || (kj == key && j < p);
    }
    if (below == e.mid) e.out[axis * e.out_stride + e.out_col0 + g] = v[p];
  }
}

Forest forest(const void* pixels, int nrows, int ncols, int dim,
              const void* codes, const void* preds, int num_cascades,
              int stages, int trees, int depth, float scale_mult,
              float qsin_v, float qcos_v) {
  return Forest{static_cast<const uint8_t*>(pixels), nrows, ncols, dim,
                static_cast<const char4*>(codes) - 1,
                static_cast<const float4*>(preds), num_cascades, stages,
                trees, depth, scale_mult, qsin_v, qcos_v};
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
      forest(pixels, nrows, ncols, dim, codes, preds, num_cascades, stages,
             trees, depth, scale_mult, qsin_v, qcos_v),
      static_cast<const int*>(casc_id), static_cast<const int*>(col_sign),
      static_cast<const float*>(r0), static_cast<const float*>(c0),
      static_cast<const float*>(s0), n, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The ensemble entry point: `groups` groups of `perturbs` walkers, each
// group's medians into out[:, out_col0 + g] (Ensemble's fields). One
// cluster of min(kEnsembleBlocks, ceil(P / kWarpsPerBlock)) blocks a
// group, 12 P bytes of shared memory a block. Same contract as
// pigo_pupil_walk.
extern "C" int pigo_pupil_ensemble(
    const void* pixels, int nrows, int ncols, int dim,
    const void* codes, const void* preds, int num_cascades, int stages,
    int trees, int depth,
    float scale_mult, int rotated, float qsin_v, float qcos_v,
    const void* casc_id, const void* flips, const void* anchor_r,
    const void* anchor_c, const void* anchor_s, int npts, const void* u,
    const void* u_rows, long long u_nrows, long long groups, int perturbs,
    int mid, void* out, long long out_stride, long long out_col0,
    void* stream) {
  if (groups == 0) return 0;
  const int blocks = min(kEnsembleBlocks,
                         (perturbs + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const Ensemble e{
      forest(pixels, nrows, ncols, dim, codes, preds, num_cascades, stages,
             trees, depth, scale_mult, qsin_v, qcos_v),
      static_cast<const int*>(casc_id), static_cast<const uint8_t*>(flips),
      static_cast<const float*>(anchor_r),
      static_cast<const float*>(anchor_c),
      static_cast<const float*>(anchor_s), npts,
      static_cast<const float*>(u), static_cast<const long long*>(u_rows),
      u_nrows, groups, perturbs, mid, static_cast<float*>(out), out_stride,
      out_col0};
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = blocks;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(groups * blocks));
  cfg.blockDim = dim3(32 * kWarpsPerBlock);
  cfg.dynamicSmemBytes = 3 * sizeof(float) * perturbs;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const cudaError_t rc =
      rotated ? cudaLaunchKernelEx(&cfg, pupil_walk_kernel_ensemble<true>, e)
              : cudaLaunchKernelEx(&cfg, pupil_walk_kernel_ensemble<false>, e);
  return static_cast<int>(rc != cudaSuccess ? rc : cudaGetLastError());
}

// The walk's schedule constant: out[0] = walkers (warps) a block.
extern "C" void pigo_pupil_schedule(int* out) { out[0] = kWarpsPerBlock; }

extern "C" const char* pigo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
