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
// The schedule itself (pigo::classify_block, survives_warp) lives in
// face_walk.cuh, templated on where the tables live: kernel B
// (face_prefix.cu) runs it with its trees staged in shared memory, with
// its own constants. Here the tables stay in global memory, read through
// the read-only path (__ldg, pigo::GlobalForest): codes plus preds (about
// 240 KB for the facefinder forest) exceed the 227 KB of shared memory a
// block may have. The wrapper checks that codes are 8-byte aligned for the
// paired code-word loads.
//
// Upright node offsets do not depend on the window:
//   ((r*256 + code*s) >> 8) == r + ((code*s) >> 8)   (>> is a floor shift)
// so they are computed inline from the int8 codes [T, L, 4] (119,808 B for
// the facefinder forest) instead of per-scale offset tables.

#include <cuda_runtime.h>

#include "face_walk.cuh"

namespace {

constexpr int kThreads = 256;
// Trees each window walks alone (phase 1) before a survivor goes to a warp.
constexpr int kPhase1Trees = 4;
// A worklist longer than kDenseEighths / 8 of the block goes on a thread
// per window (see the note above).
constexpr int kDenseEighths = 7;
constexpr int kDenseItems = kDenseEighths * kThreads / 8;

// The kernel's arguments as one parameter. Passed as four (windows,
// forest, t_limit, last_thresh) they gave the same instructions in every
// loop, but the compiler allocated the registers otherwise, and the
// all-survive case (every block on its dense fallback) ran 16% slower at
// the headline on an H100 (pigo_tpu_torch/tools/face_sweep.py, PERF.md).
struct Launch {
  pigo::Windows p;
  pigo::GlobalForest f;
  int t_limit;
  const float* last_thresh;  // null: survivors get PREFIX_MARK
};

template <bool kRotated, bool kFinish>
__global__ void __launch_bounds__(kThreads)
    face_cascade_kernel(const Launch l) {
  pigo::classify_block<kThreads, kThreads, kPhase1Trees, kDenseItems,
                       kRotated, kFinish>(l.p, l.f, l.t_limit,
                                          l.last_thresh);
}

template <bool kFinish>
int launch(const pigo::Windows& p, const pigo::GlobalForest& f, int t_limit,
           int n_trees, int rotated, cudaStream_t stream) {
  if (p.n_total == 0) return 0;
  const long long blocks = (p.n_total + kThreads - 1) / kThreads;
  // survivors of the whole forest get sum - thresh[T-1], others the mark
  const Launch l{p, f, t_limit,
                 t_limit < n_trees ? nullptr : f.thresh + n_trees - 1};
  if (rotated) {
    face_cascade_kernel<true, kFinish><<<(unsigned)blocks, kThreads, 0,
                                         stream>>>(l);
  } else {
    face_cascade_kernel<false, kFinish><<<(unsigned)blocks, kThreads, 0,
                                          stream>>>(l);
  }
  return static_cast<int>(cudaGetLastError());
}

pigo::GlobalForest forest(const void* codes, const void* preds,
                          const void* thresh, int depth) {
  return pigo::GlobalForest{static_cast<const char4*>(codes),
                            static_cast<const float*>(preds),
                            static_cast<const float*>(thresh), depth};
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
      pigo::make_windows(frames, n_frames, nrows, dim, cols, base, scale,
                         n_windows, qcos, qsin, out, out_stride),
      forest(codes, preds, thresh, depth), t_limit, n_trees, rotated,
      static_cast<cudaStream_t>(stream));
}

extern "C" int pigo_face_finish(
    const void* frames, long long n_frames, int nrows, int dim, int cols,
    const void* base, const void* scale, long long n_windows,
    const void* codes, const void* preds, const void* thresh, int depth,
    int n_trees, int rotated, int qcos, int qsin, void* scores,
    long long out_stride, void* stream) {
  return launch<true>(
      pigo::make_windows(frames, n_frames, nrows, dim, cols, base, scale,
                         n_windows, qcos, qsin, scores, out_stride),
      forest(codes, preds, thresh, depth), n_trees, n_trees, rotated,
      static_cast<cudaStream_t>(stream));
}

// The schedule's constants of kernel A and the finish: out[0] = the trees a
// window walks alone (phase 1), out[1] = the windows of a block, which
// bound a block's worklist, out[2] = its threads, out[3] = the longest
// worklist walked a warp per entry. Kernel B's follow at out[4..7]
// (face_prefix.cu).
extern "C" void pigo_prefix_schedule(int* out);

extern "C" void pigo_face_schedule(int* out) {
  out[0] = kPhase1Trees;
  out[1] = kThreads;
  out[2] = kThreads;
  out[3] = kDenseItems;
  pigo_prefix_schedule(out + 4);
}

extern "C" const char* pigo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
