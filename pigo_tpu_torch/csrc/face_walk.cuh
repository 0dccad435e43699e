// Soft-cascade window walk and block schedule shared by the face kernels
// (face_cascade.cu: kernel A and the finish; face_prefix.cu: kernel B):
// the node reads, upright and rotated; the forest's tables, in global
// memory or swizzled in shared memory; the walk of one tree to its leaf;
// the walk of one window through its trees, alone or with a warp; and the
// two-phase block schedule (the design note atop face_cascade.cu).
//
// Reference semantics (core/pigo.go:113-191); the plain PyTorch version is
// pigo_tpu_torch/ops/face_dense.py, whose docstring states the reads:
//   upright: img[(r + ((cr*s) >> 8)) * dim + c + ((cc*s) >> 8)], unclamped;
//   rotated: r' = min(nrows-1, max(0, r*65536 + qc*cr - qs*cc) >> 16),
//            c' = min(nrows-1, max(0, c*65536 + qs*cr + qc*cc) >> 16),
//            img[min(r'*dim + c', nrows*dim - 1)]  (both axes clamp with
//            nrows-1, the reference's quirk; the flat clamp keeps a tall
//            frame's last-row reads inside the buffer, as the JAX gather).
// The only f32 operations are the leaf adds, the compares and the final
// subtract, so FMA contraction cannot change a result; the build still
// passes --fmad=false (pigo_tpu_torch/utils/build.py).

#pragma once

#include <cstdint>

namespace pigo {

constexpr float kPrefixMark = 1e30f;
constexpr unsigned kFullMask = 0xffffffffu;
// Trees a warp walks in one round of phase 2: one a lane.
constexpr int kRoundTrees = 32;

// The forest's tables in global memory, tree-major (node k of tree t at
// t * leaves + k), read through the read-only path. Kernel A and the finish.
struct GlobalForest {
  const char4* codes;   // [T, 1 << depth] (r1, c1, r2, c2)
  const float* preds;   // [T, 1 << depth]
  const float* thresh;  // [T]
  int depth;

  __device__ __forceinline__ char4 node(int t, int k) const {
    return __ldg(codes + (t << depth) + k);
  }
  // Nodes 2 idx (.x) and 2 idx + 1 (.y) of tree t, one 8-byte load.
  __device__ __forceinline__ int2 kids(int t, int idx) const {
    return __ldg(reinterpret_cast<const int2*>(codes + (t << depth)) + idx);
  }
  __device__ __forceinline__ float leaf(int t, int k) const {
    return __ldg(preds + (t << depth) + k);
  }
  __device__ __forceinline__ float threshold(int t) const {
    return __ldg(thresh + t);
  }
};

// The XOR mask of tree t's slots in shared memory. Bits 1-4 are t mod 16
// and bit 0 is bit 4 of t, so over any 32 consecutive trees the masks are
// the 32 values 0-31, and over any 16 their bits 1-4 differ. Cut to the
// tree's slots when it has fewer than 32.
__device__ __forceinline__ int swizzle(int t, int depth) {
  return (((t & 15) << 1) | ((t >> 4) & 1)) & ((1 << depth) - 1);
}

// The forest's first t_limit trees staged in shared memory (face_prefix.cu),
// with node (and leaf) k of tree t at slot t * leaves + (k ^ swizzle(t)).
// Banks: a slot of 4 bytes is bank slot mod 32, and t * leaves is a
// multiple of 32 from depth 5 up. When the 32 lanes of a warp read the same
// node (or leaf) of 32 consecutive trees, as phase 2 does at the root, the
// masks send the reads to 32 distinct banks; unswizzled, all 32 would fall
// in one bank. The children pair (2 idx, 2 idx + 1) stays one aligned
// 8-byte word at pair idx ^ (mask >> 1), its halves swapped when bit 0 of
// the mask is set, and a half-warp's 16 pair reads of the same idx fall in
// distinct bank pairs. When one thread per window reads one tree (phase 1),
// the nodes of a level are distinct mod 32, so they stay in distinct banks.
struct SwizzledForest {
  const char4* codes;   // [t_limit << depth] swizzled slots
  const float* preds;   // [t_limit << depth] swizzled slots
  const float* thresh;  // [t_limit]
  int depth;

  __device__ __forceinline__ char4 node(int t, int k) const {
    return codes[(t << depth) + (k ^ swizzle(t, depth))];
  }
  __device__ __forceinline__ int2 kids(int t, int idx) const {
    const int m = swizzle(t, depth);
    const int2 v =
        reinterpret_cast<const int2*>(codes + (t << depth))[idx ^ (m >> 1)];
    return (m & 1) ? make_int2(v.y, v.x) : v;
  }
  __device__ __forceinline__ float leaf(int t, int k) const {
    return preds[(t << depth) + (k ^ swizzle(t, depth))];
  }
  __device__ __forceinline__ float threshold(int t) const {
    return thresh[t];
  }
};

// The frame and the window a thread classifies. `base` is r*cols + c.
struct WindowArgs {
  const uint8_t* frame;  // this frame's first pixel, row stride dim
  int base, cols, dim, nrows, s;
  int qcos, qsin;  // QCOS/QSIN table entries (rotated only)
};

template <bool kRotated>
struct Reader;

template <>
struct Reader<false> {
  const uint8_t* img;  // the window centre's pixel
  int s, dim;
  __device__ __forceinline__ explicit Reader(const WindowArgs& a)
      : s(a.s), dim(a.dim) {
    // upright frames are contiguous (cols == dim): base is r*dim + c
    img = a.frame + a.base;
  }
  __device__ __forceinline__ int operator()(int cr, int cc) const {
    return __ldg(img + ((cr * s) >> 8) * dim + ((cc * s) >> 8));
  }
};

template <>
struct Reader<true> {
  const uint8_t* frame;
  long long r16, c16, last;
  int qc, qs, hi, dim;
  __device__ __forceinline__ explicit Reader(const WindowArgs& a)
      : frame(a.frame), qc(a.s * a.qcos), qs(a.s * a.qsin),
        hi(a.nrows - 1), dim(a.dim) {
    const int r = a.base / a.cols;
    r16 = (long long)r << 16;
    c16 = (long long)(a.base - r * a.cols) << 16;
    last = (long long)a.nrows * a.dim - 1;
  }
  __device__ __forceinline__ int operator()(int cr, int cc) const {
    // |qc*cr| + |qs*cc| <= s*256*128*2: int32 for any scale s < 2^15
    long long vr = r16 + (qc * cr - qs * cc);
    long long vc = c16 + (qs * cr + qc * cc);
    vr = min((long long)hi, (vr < 0 ? 0 : vr) >> 16);
    vc = min((long long)hi, (vc < 0 ? 0 : vc) >> 16);
    return __ldg(frame + min(vr * dim + vc, last));
  }
};

// The leaf slot, in [leaves, 2 * leaves), that tree t sends the window to:
// from node 1, depth comparisons p1 <= p2 at the node's pixel pair.
template <class Forest, class Read>
__device__ __forceinline__ int leaf_slot(const Read& read, const Forest& f,
                                         int t) {
  int idx = 1;
  for (int d = 0; d < f.depth; ++d) {
    const char4 c = f.node(t, idx);
    const int p1 = read(c.x, c.y);
    const int p2 = read(c.z, c.w);
    idx = 2 * idx + (p1 <= p2 ? 1 : 0);
  }
  return idx;
}

// Walks trees [t_start, t_limit) of one window in one thread, tree by
// tree, from the running sum *sum; true when the window survives them all,
// with the sum in *sum.
template <class Forest, class Read>
__device__ __forceinline__ bool survives(const Read& read, const Forest& f,
                                         int t_start, int t_limit,
                                         float* sum) {
  const int leaves = 1 << f.depth;
  float acc = *sum;
  for (int t = t_start; t < t_limit; ++t) {
    acc += f.leaf(t, leaf_slot(read, f, t) - leaves);
    if (acc <= f.threshold(t)) return false;
  }
  *sum = acc;
  return true;
}

// Walks trees [t_start, t_limit) of one window with the whole warp (every
// lane calls it with the same window and sum), kRoundTrees trees a round:
// lane l walks tree t0 + l to its leaf (lanes past t_limit walk the last
// tree again; their leaves are never added), loading both children's code
// words as one 8-byte pair beside the node's pixel pair, so that a level
// waits on the pixels alone. Then every lane forms the same running sum
// over the round's leaves in tree order, one __shfl_sync and one __fadd_rn
// a tree, and keeps the sum after its own tree; one ballot says whether
// any of them is <= its tree's threshold. These are the sums of the
// sequential walk, so the window fails here exactly when it fails there.
// True when it survives, with the sum in *sum.
template <class Forest, class Read>
__device__ __forceinline__ bool survives_warp(const Read& read,
                                              const Forest& f, int t_start,
                                              int t_limit, float* sum) {
  const int lane = threadIdx.x & 31;
  const int leaves = 1 << f.depth;
  float acc = *sum;
  for (int t0 = t_start; t0 < t_limit; t0 += kRoundTrees) {
    const int t = min(t0 + lane, t_limit - 1);
    int idx = 1;
    char4 code = f.node(t, 1);
    for (int d = 0; d < f.depth; ++d) {
      int2 kids = make_int2(0, 0);
      if (d + 1 < f.depth) kids = f.kids(t, idx);
      const bool right = read(code.x, code.y) <= read(code.z, code.w);
      idx = 2 * idx + (right ? 1 : 0);
      const int k = right ? kids.y : kids.x;
      code = make_char4((signed char)k, (signed char)(k >> 8),
                        (signed char)(k >> 16), (signed char)(k >> 24));
    }
    const float leaf = f.leaf(t, idx - leaves);
    const int m = min(kRoundTrees, t_limit - t0);  // the round's trees
    float run = acc, mine = 0.0f;
#pragma unroll
    for (int j = 0; j < kRoundTrees; ++j) {
      const float v = __shfl_sync(kFullMask, leaf, j);
      if (j < m) run = __fadd_rn(run, v);
      mine = lane == j ? run : mine;
    }
    if (__ballot_sync(kFullMask, lane < m && mine <= f.threshold(t))) {
      return false;
    }
    acc = run;
  }
  *sum = acc;
  return true;
}

// The windows of a launch: window i (frame-major) is window i mod
// n_windows of frame i / n_windows, and its score goes to
// out[f * out_stride + w].
struct Windows {
  const uint8_t* frames;  // [n_frames, nrows, dim]
  long long frame_pixels;
  int nrows, dim, cols;
  const int* base;   // [n_windows] r*cols + c
  const int* scale;  // [n_windows]
  long long n_windows, n_total;
  int qcos, qsin;
  float* out;  // [n_frames, out_stride], the range's first column
  long long out_stride;
};

struct Window {
  float* q;  // its score
  WindowArgs args;
};

__device__ __forceinline__ Window window(const Windows& p, long long i) {
  const long long f = i / p.n_windows;
  const long long w = i - f * p.n_windows;
  return Window{p.out + f * p.out_stride + w,
                WindowArgs{p.frames + f * p.frame_pixels, __ldg(p.base + w),
                           p.cols, p.dim, p.nrows, __ldg(p.scale + w),
                           p.qcos, p.qsin}};
}

// The two-phase schedule of one block of kThreads threads over kWindows
// <= kThreads windows (windows blockIdx.x * kWindows + [0, kWindows) of
// the launch) and trees [0, t_limit) of forest f:
//   1. thread k < kWindows walks window k's trees
//      [0, min(kPhase1Trees, t_limit)); a window still alive with trees
//      left puts its index and exact f32 sum on the block's worklist
//      (with kFinish: no tree is walked; every window whose score is
//      PREFIX_MARK goes on the list, sum 0);
//   2. a worklist of at most kDenseItems entries is walked a warp per
//      entry, the entries taken in turn by all kThreads / 32 warps
//      (survives_warp); a longer one goes on a thread per window from its
//      phase-1 sum (survives).
// A survivor's score is sum - *last_thresh, or PREFIX_MARK when last_thresh
// is null; a failed window's is -1. Every thread of the block must call it
// (it holds barriers).
template <int kThreads, int kWindows, int kPhase1Trees, int kDenseItems,
          bool kRotated, bool kFinish, class Forest>
__device__ __forceinline__ void classify_block(const Windows& p,
                                               const Forest& f, int t_limit,
                                               const float* last_thresh) {
  static_assert(kWindows <= kThreads && kDenseItems <= kWindows);
  __shared__ int s_item[kWindows];   // worklist: the window's index
  __shared__ float s_sum[kWindows];  // and its sum after phase 1
  __shared__ int s_count, s_next;
  if (threadIdx.x == 0) {
    s_count = 0;
    s_next = 0;
  }
  __syncthreads();
  const auto score = [last_thresh](float sum) {
    return last_thresh ? sum - __ldg(last_thresh) : kPrefixMark;
  };

  // Phase 1: a thread per window. No thread returns before the barrier
  // below, neither one past n_total or kWindows nor a finish thread
  // without a mark.
  const long long first = blockIdx.x * (long long)kWindows;
  const long long i = first + threadIdx.x;
  const int t_start = kFinish ? 0 : min(kPhase1Trees, t_limit);
  float sum = 0.0f;
  bool queued = false;
  Window win;
  if ((kWindows == kThreads || threadIdx.x < kWindows) && i < p.n_total) {
    win = window(p, i);
    if (kFinish) {
      queued = *win.q == kPrefixMark;
    } else {
      const Reader<kRotated> read(win.args);
      if (!survives(read, f, 0, t_start, &sum)) {
        *win.q = -1.0f;
      } else if (t_start == t_limit) {
        *win.q = score(sum);
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
      const Reader<kRotated> read(win.args);
      *win.q = survives(read, f, t_start, t_limit, &sum) ? score(sum) : -1.0f;
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
    const Reader<kRotated> read(item.args);
    float acc = s_sum[e];
    const bool alive = survives_warp(read, f, t_start, t_limit, &acc);
    if ((threadIdx.x & 31) == 0) *item.q = alive ? score(acc) : -1.0f;
  }
}

inline Windows make_windows(const void* frames, long long n_frames,
                            int nrows, int dim, int cols, const void* base,
                            const void* scale, long long n_windows, int qcos,
                            int qsin, void* out, long long out_stride) {
  return Windows{static_cast<const uint8_t*>(frames),
                 (long long)nrows * dim, nrows, dim, cols,
                 static_cast<const int*>(base), static_cast<const int*>(scale),
                 n_windows, n_frames * n_windows, qcos, qsin,
                 static_cast<float*>(out), out_stride};
}

}  // namespace pigo
