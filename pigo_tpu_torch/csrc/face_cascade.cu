// Soft-cascade face classifier for Hopper (sm_90a) over a range of the
// pyramid's windows of every frame, in one launch; upright or rotated node
// reads (face_walk.cuh).
//
// Replaces the TPU kernel pigo_tpu/ops/face_pallas.py::_kernel_body, which
// evaluates one scale per launch over 16x128-window tiles of
// phase-decimated planes (for rotated scales, planes of a clamp-extended
// image). None of that layout carries over: here each window's pixels are
// read straight from the uint8 frame, at the reference's rotated and
// clamped coordinates where the frame is rotated.
//
// Per window (reference core/pigo.go:113-191): for each tree t < t_limit,
// walk the depth-level tree from node 1, comparing p1 <= p2 at the node's
// pixel pair; add the leaf value to an f32 running sum, left to right; stop
// for good on sum <= thresh[t]. Output: -1 for a failed window,
// PREFIX_MARK for a survivor when t_limit < n_trees, else
// sum - thresh[n_trees - 1].
//
// Two entry points:
//   pigo_face_cascade — the above over a window range (the dense scales,
//     capped at t_limit trees when a tree cap is set);
//   pigo_face_finish — the exact finish of marked windows, in place of the
//     JAX package's _resolve_consts / host finish
//     (pigo_tpu/models/face.py:313-449): every window whose score is
//     PREFIX_MARK gets its full-forest score, every other score stays.
//     Launched over the range that holds every mark, so it needs no
//     compaction, no capacity and no host sync, and keeps scan order.
//
// What bounds it: not bytes. The whole input (frame, codes, preds, thresh,
// window tables) is a few MB, read in microseconds at 3.35 TB/s. Most
// windows fail after about two trees (442,974 tree evaluations for the
// 218,449 windows of the 400x320 headline pyramid), but a few walk all 468
// trees (22 at the headline, 312 at 1080p), and a walk is a chain of
// dependent loads: code word -> pixel pair -> next code word. With a
// thread per window that chain, 468 x 6 levels, set the time of the whole
// launch (about 1.2 us a tree on an H100). The trees of one window are
// independent, though; only the f32 sum and the sticky fail test take them
// in order. So the kernel runs in two phases per block of kThreads windows:
//
//   1. A thread per window walks trees [0, min(kPhase1Trees, t_limit)) as
//      a plain sequential walk (pigo::survives). Most windows fail here, at
//      the cost they had with a thread per window (97% of the 1080p
//      pyramid's windows within 4 trees). A window still alive with trees
//      left puts its index in the block and its exact f32 sum on a
//      worklist in shared memory (at most kThreads entries, 2 KB). The
//      finish walks no tree here: each mark goes on the list with the sum 0
//      and starts from tree 0 (marks survived 32 trees or more, so a
//      sequential start would only lengthen their chain).
//   2. A warp per worklist entry, the entries taken in turn by the block's
//      warps: one tree per lane, 32 trees a round, the leaves then added in
//      tree order (survives_warp). A long walker's chain is ceil(T / 32)
//      rounds of (depth levels + 32 ordered adds) instead of T x depth
//      levels. The trees past a window's fail, within its last round, are
//      walked for nothing, off the chain.
//
// What bounds it now is phase 2's memory traffic: the 32 lanes of a warp
// read 32 trees' code words and each lane its own pixels, so every level's
// loads touch up to 32 cache lines, where a thread per window read one
// code word for the whole warp and neighbouring pixels. A round takes
// about 2 us, not the 0.4 us of its latency alone, when several warps of
// an SM run rounds at once; a block whose worklist holds several long
// walkers sets the launch's time.
//
// Worst case: when every window of a block survives, its warps would walk
// the block's windows 32 at a time with those scattered loads, about 2.4x
// the time of a thread per window. A worklist longer than kDenseItems
// therefore goes on a thread per window from its phase-1 sum (the
// sequential walk, as exact), so a dense block costs what it cost before.
//
// kPhase1Trees = 4 and kThreads = 256 were chosen on an H100 by
// pigo_tpu_torch/tools/face_sweep.py (phase-1 lengths 1 to 8, blocks of 32
// to 1024 windows, 1 to 4 trees a lane): shorter phase 1 puts too many
// windows on the worklists, longer lengthens every survivor's chain;
// smaller blocks leave a block's long walkers fewer warps to share.
//
// Tables stay in global memory, read through the read-only path (__ldg):
// codes plus preds (about 240 KB for the facefinder forest) exceed the
// 227 KB of shared memory a block may have (the 32-tree prefix kernel,
// face_prefix.cu, stages its tables in shared memory). The wrapper checks
// that codes are 8-byte aligned for the paired code-word loads.
//
// Upright node offsets do not depend on the window:
//   ((r*256 + code*s) >> 8) == r + ((code*s) >> 8)   (>> is a floor shift)
// so they are computed inline from the int8 codes [T, L, 4] (119,808 B for
// the facefinder forest) instead of per-scale offset tables.

#include <cuda_runtime.h>

#include "face_walk.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFullMask = 0xffffffffu;
// Trees each window walks alone (phase 1) before a survivor goes to a warp.
constexpr int kPhase1Trees = 4;
// A longer worklist goes on a thread per window (see the note above).
constexpr int kDenseItems = 7 * kThreads / 8;

struct Launch {
  const uint8_t* frames;  // [n_frames, nrows, dim]
  long long frame_pixels;
  int nrows, dim, cols;
  const int* base;    // [n_windows] r*cols + c
  const int* scale;   // [n_windows]
  long long n_windows, n_total;
  const char4* codes;  // [n_trees, 1 << depth] (r1, c1, r2, c2)
  const float* preds;  // [n_trees, 1 << depth]
  const float* thresh; // [n_trees]
  int depth, n_trees, t_limit, qcos, qsin;
  float* out;           // [n_frames, out_stride], the range's first column
  long long out_stride;
};

// Window i (frame-major over the range) of the launch.
struct Window {
  float* q;  // its score
  pigo::WindowArgs args;
};

__device__ __forceinline__ Window window(const Launch& p, long long i) {
  const long long f = i / p.n_windows;
  const long long w = i - f * p.n_windows;
  return Window{p.out + f * p.out_stride + w,
                pigo::WindowArgs{p.frames + f * p.frame_pixels,
                                 __ldg(p.base + w), p.cols, p.dim, p.nrows,
                                 __ldg(p.scale + w), p.qcos, p.qsin}};
}

// The score of a window that survived all t_limit trees with sum `sum`.
__device__ __forceinline__ float survivor_score(const Launch& p, float sum) {
  return p.t_limit < p.n_trees ? pigo::kPrefixMark
                               : sum - __ldg(p.thresh + p.n_trees - 1);
}

// Walks trees [t_start, t_limit) of one window with the whole warp (every
// lane calls it with the same window and sum), 32 trees a round: lane l
// walks tree t0 + l to its leaf (lanes past t_limit walk the last tree
// again; their leaves are never added), loading both children's code words
// as one 8-byte pair (nodes 2 idx and 2 idx + 1) beside the node's pixel
// pair, so that a level waits on the pixels alone. Then every lane forms
// the same running sum over the round's leaves in tree order, one
// __shfl_sync and one __fadd_rn a tree, and keeps the sum after its own
// tree; one ballot says whether any of them is <= its tree's threshold.
// These are the sums of the sequential walk, so the window fails here
// exactly when it fails there. True when it survives, with the sum in
// *sum.
template <class Read>
__device__ __forceinline__ bool survives_warp(const Read& read,
                                              const Launch& p, int t_start,
                                              float* sum) {
  const int lane = threadIdx.x & 31;
  const int leaves = 1 << p.depth;
  float acc = *sum;
  for (int t0 = t_start; t0 < p.t_limit; t0 += 32) {
    const int t = min(t0 + lane, p.t_limit - 1);
    const char4* node = p.codes + t * leaves;
    int idx = 1;
    char4 code = __ldg(node + 1);
    for (int d = 0; d < p.depth; ++d) {
      int2 kids = make_int2(0, 0);
      if (d + 1 < p.depth) {
        kids = __ldg(reinterpret_cast<const int2*>(node) + idx);
      }
      const bool right = read(code.x, code.y) <= read(code.z, code.w);
      idx = 2 * idx + (right ? 1 : 0);
      const int k = right ? kids.y : kids.x;
      code = make_char4((signed char)k, (signed char)(k >> 8),
                        (signed char)(k >> 16), (signed char)(k >> 24));
    }
    const float leaf = __ldg(p.preds + t * leaves + (idx - leaves));
    const int m = min(32, p.t_limit - t0);  // the round's trees
    float run = acc, mine = 0.0f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float v = __shfl_sync(kFullMask, leaf, j);
      if (j < m) run = __fadd_rn(run, v);
      mine = lane == j ? run : mine;
    }
    if (__ballot_sync(kFullMask, lane < m && mine <= __ldg(p.thresh + t))) {
      return false;
    }
    acc = run;
  }
  *sum = acc;
  return true;
}

template <bool kRotated, bool kFinish>
__global__ void __launch_bounds__(kThreads)
    face_cascade_kernel(const Launch p) {
  __shared__ int s_item[kThreads];   // worklist: the window's thread index
  __shared__ float s_sum[kThreads];  // and its sum after phase 1
  __shared__ int s_count, s_next;
  if (threadIdx.x == 0) {
    s_count = 0;
    s_next = 0;
  }
  __syncthreads();

  // Phase 1: a thread per window. No thread returns before the barrier
  // below, neither one past n_total nor a finish thread without a mark.
  const long long first = blockIdx.x * (long long)kThreads;
  const long long i = first + threadIdx.x;
  const int t_start = kFinish ? 0 : min(kPhase1Trees, p.t_limit);
  float sum = 0.0f;
  bool queued = false;
  Window win;
  if (i < p.n_total) {
    win = window(p, i);
    if (kFinish) {
      queued = *win.q == pigo::kPrefixMark;
    } else {
      const pigo::Reader<kRotated> read(win.args);
      if (!pigo::survives<true>(read, p.codes, p.preds, p.thresh, p.depth,
                                t_start, &sum)) {
        *win.q = -1.0f;
      } else if (t_start == p.t_limit) {
        *win.q = survivor_score(p, sum);
      } else {
        queued = true;
      }
    }
    if (queued) {
      const int slot = atomicAdd(&s_count, 1);
      s_item[slot] = threadIdx.x;
      s_sum[slot] = sum;
    }
  }
  __syncthreads();

  const int n_items = s_count;
  if (n_items > kDenseItems) {
    // a dense worklist: each window goes on in its own thread
    if (queued) {
      const pigo::Reader<kRotated> read(win.args);
      const int leaves = 1 << p.depth;
      bool alive = true;
      for (int t = t_start; alive && t < p.t_limit; ++t) {
        const int idx =
            pigo::leaf_slot<true>(read, p.codes + t * leaves, p.depth);
        sum += __ldg(p.preds + t * leaves + (idx - leaves));
        alive = !(sum <= __ldg(p.thresh + t));
      }
      *win.q = alive ? survivor_score(p, sum) : -1.0f;
    }
    return;
  }

  // Phase 2: a warp per worklist entry, taken in turn.
  for (;;) {
    int e = 0;
    if ((threadIdx.x & 31) == 0) e = atomicAdd(&s_next, 1);
    e = __shfl_sync(kFullMask, e, 0);
    if (e >= n_items) break;
    const Window item = window(p, first + s_item[e]);
    const pigo::Reader<kRotated> read(item.args);
    float acc = s_sum[e];
    const bool alive = survives_warp(read, p, t_start, &acc);
    if ((threadIdx.x & 31) == 0) {
      *item.q = alive ? survivor_score(p, acc) : -1.0f;
    }
  }
}

template <bool kFinish>
int launch(const Launch& p, int rotated, cudaStream_t stream) {
  if (p.n_total == 0) return 0;
  const long long blocks = (p.n_total + kThreads - 1) / kThreads;
  if (rotated) {
    face_cascade_kernel<true, kFinish><<<(unsigned)blocks, kThreads, 0,
                                         stream>>>(p);
  } else {
    face_cascade_kernel<false, kFinish><<<(unsigned)blocks, kThreads, 0,
                                          stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

Launch make_launch(const void* frames, long long n_frames, int nrows,
                   int dim, int cols, const void* base, const void* scale,
                   long long n_windows, const void* codes, const void* preds,
                   const void* thresh, int depth, int n_trees, int t_limit,
                   int qcos, int qsin, void* out, long long out_stride) {
  return Launch{static_cast<const uint8_t*>(frames),
                (long long)nrows * dim, nrows, dim, cols,
                static_cast<const int*>(base), static_cast<const int*>(scale),
                n_windows, n_frames * n_windows,
                static_cast<const char4*>(codes),
                static_cast<const float*>(preds),
                static_cast<const float*>(thresh), depth, n_trees, t_limit,
                qcos, qsin, static_cast<float*>(out), out_stride};
}

}  // namespace

// Plain C entry points (bound with ctypes). Each launches on `stream`, does
// not synchronise, allocates nothing, and returns cudaGetLastError() of the
// launch. `rotated` selects the rotated reads with the table entries
// qcos, qsin; `out` is row f of the scores at out + f * out_stride.
extern "C" int pigo_face_cascade(
    const void* frames, long long n_frames, int nrows, int dim, int cols,
    const void* base, const void* scale, long long n_windows,
    const void* codes, const void* preds, const void* thresh, int depth,
    int n_trees, int t_limit, int rotated, int qcos, int qsin, void* out,
    long long out_stride, void* stream) {
  return launch<false>(
      make_launch(frames, n_frames, nrows, dim, cols, base, scale, n_windows,
                  codes, preds, thresh, depth, n_trees, t_limit, qcos, qsin,
                  out, out_stride),
      rotated, static_cast<cudaStream_t>(stream));
}

extern "C" int pigo_face_finish(
    const void* frames, long long n_frames, int nrows, int dim, int cols,
    const void* base, const void* scale, long long n_windows,
    const void* codes, const void* preds, const void* thresh, int depth,
    int n_trees, int rotated, int qcos, int qsin, void* scores,
    long long out_stride, void* stream) {
  return launch<true>(
      make_launch(frames, n_frames, nrows, dim, cols, base, scale, n_windows,
                  codes, preds, thresh, depth, n_trees, n_trees, qcos, qsin,
                  scores, out_stride),
      rotated, static_cast<cudaStream_t>(stream));
}

// The two-phase schedule's constants: out[0] = the trees a window walks
// alone (phase 1), out[1] = the windows (threads) of a block, which bound
// a block's worklist.
extern "C" void pigo_face_schedule(int* out) {
  out[0] = kPhase1Trees;
  out[1] = kThreads;
}

extern "C" const char* pigo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
