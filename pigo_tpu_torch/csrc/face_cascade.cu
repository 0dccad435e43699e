// Soft-cascade face classifier for Hopper (sm_90a): one thread per
// (frame, window) over a range of the pyramid's windows of every frame, in
// one launch; upright or rotated node reads (face_walk.cuh).
//
// Replaces the TPU kernel pigo_tpu/ops/face_pallas.py::_kernel_body, which
// evaluates one scale per launch over 16x128-window tiles of
// phase-decimated planes (for rotated scales, planes of a clamp-extended
// image). None of that layout carries over: here each thread reads its own
// pixels straight from the uint8 frame, computing the reference's rotated
// and clamped coordinates itself.
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
//     (pigo_tpu/models/face.py:313-449): a thread whose score is not
//     PREFIX_MARK returns at once; any other walks all n_trees trees from
//     tree 0 and overwrites its score. Launched over the range that holds
//     every mark, so it needs no compaction, no capacity and no host sync,
//     and keeps scan order.
//
// Upright node offsets do not depend on the window:
//   ((r*256 + code*s) >> 8) == r + ((code*s) >> 8)   (>> is a floor shift)
// so they are computed inline from the int8 codes [T, L, 4] (119,808 B for
// the facefinder forest) instead of per-scale offset tables.
//
// What bounds it: not bytes. The whole input (frame, codes, preds, thresh,
// window tables) is a few MB, read in microseconds at 3.35 TB/s. Most
// windows fail after about two trees (442,974 tree evaluations for the
// 218,449 windows of the 400x320 headline pyramid; 2,389,054 for the
// 831,136 windows at 1080p), but the 22 (headline) or 312 (1080p) windows
// that walk all 468 trees each run a chain of 468 x 6 dependent
// code-word -> pixel loads. The kernel's time is that chain's latency. The
// design keeps the chain short per step: codes, preds and thresh are read
// through the read-only path (__ldg), where the first trees, which every
// window walks, stay in L1; the frame is read as uint8 the same way.
// Tables stay in global memory: codes plus preds exceed the 227 KB of
// shared memory a block may have (the 32-tree prefix kernel,
// face_prefix.cu, stages its tables in shared memory).

#include <cuda_runtime.h>

#include "face_walk.cuh"

namespace {

constexpr int kThreads = 256;

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

template <bool kRotated, bool kFinish>
__global__ void face_cascade_kernel(const Launch p) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= p.n_total) return;
  const long long f = i / p.n_windows;
  const long long w = i - f * p.n_windows;
  float* q = p.out + f * p.out_stride + w;
  if (kFinish && *q != pigo::kPrefixMark) return;
  const pigo::WindowArgs a{p.frames + f * p.frame_pixels, __ldg(p.base + w),
                           p.cols, p.dim, p.nrows, __ldg(p.scale + w),
                           p.qcos, p.qsin};
  const pigo::Reader<kRotated> read(a);
  float sum;
  const bool alive = pigo::survives<true>(read, p.codes, p.preds, p.thresh,
                                          p.depth, p.t_limit, &sum);
  if (!alive) {
    *q = -1.0f;
  } else if (p.t_limit < p.n_trees) {
    *q = pigo::kPrefixMark;
  } else {
    *q = sum - __ldg(p.thresh + p.n_trees - 1);
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

extern "C" const char* pigo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
