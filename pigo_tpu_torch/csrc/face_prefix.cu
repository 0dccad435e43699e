// Tree-prefix face classifier for Hopper (sm_90a), kernel B: the first
// t_limit trees of the soft cascade for every window of the prefix range
// (the sparse tail scales of the pyramid) of every frame, in one launch,
// with the t_limit trees' tables staged in shared memory. Output per
// window: -1 when it failed within t_limit trees, PREFIX_MARK when it
// survived them (the exact finish, pigo_face_finish in face_cascade.cu,
// then walks all trees for those windows). Built into one library with
// face_cascade.cu, which also holds the error-string entry point
// (pigo_tpu_torch/utils/build.py).
//
// Replaces the TPU kernel pigo_tpu/ops/face_pallas.py::_multi_kernel_body
// (launched by _multi_call, fed by prefix_group_scores), which evaluates
// the concatenated 16x128-window tiles of many tail scales, each tile's
// geometry (tr, ct, nr, nc, R, planes_off, table_off, valid) in SMEM, over
// phase-decimated planes, in groups sized to the TPU's VMEM and SMEM. None
// of that carries over: each window reads its own pixels from the uint8
// frame (through __ldg), upright or rotated (face_walk.cuh), and every
// prefix window of a frame batch goes to this one launch.
//
// What bounds it: not bytes (the frame, 16.5 KB of tables and 4 B of score
// a window, under a microsecond at 3.35 TB/s). Every window walks tree 0
// and most fail within a few trees, but a window that survives all
// t_limit = 32 trees walked them, on a thread of its own, as a chain of
// 32 x depth dependent code-word -> pixel loads: about 1.4 us a tree, the
// pixels' round trip to L1/L2 (the code words already came from shared
// memory). That chain set the launch's time (0.046 ms at the headline).
//
// The design is kernel A's two-phase schedule (pigo::classify_block in
// face_walk.cuh; the note atop face_cascade.cu), with the tables in
// shared memory and more warps than windows:
//   1. the block stages the t_limit trees' codes (char4), preds and thresh
//      (t_limit * (8 << depth) + 4 * t_limit bytes: 16,512 B for 32 trees
//      of depth 6) once, then a thread per window walks the first
//      kPrefixPhase1Trees = 4 trees from shared memory (kPrefixWindows =
//      128 windows a block);
//   2. a window still alive goes to the block's worklist, and all 16 warps
//      of the block (kPrefixThreads = 512) take the entries in turn, one
//      tree per lane: at t_limit = 32 one round walks the remaining trees
//      at once, every lane forms the running sums in tree order
//      (__shfl_sync + __fadd_rn) and one __ballot_sync fails the window. A
//      t_limit above 32 + the phase-1 trees takes more rounds, as in
//      kernel A. A worklist longer than kPrefixDenseEighths / 8 of the
//      block's windows goes on a thread per window.
// A survivor's chain falls from 32 x depth levels to 4 x depth levels,
// then depth levels and 32 ordered adds. The tail scales are few windows
// of large scale, so a face's survivors crowd a few blocks: a block of 128
// windows and 16 warps gives each warp of the busiest block one to three
// entries, where kernel A's shape (256 windows, 8 warps) gave it five to
// eight.
//
// Shared-memory banks (pigo::SwizzledForest): phase 2's 32 lanes read the
// same node of 32 trees at every root and whenever their paths agree. With
// node k of tree t at slot t * 64 + k those reads all fell in one bank, a
// 32-way conflict. Here node k sits at slot t * leaves + (k ^ mask(t)),
// with a mask that takes all 32 values over 32 consecutive trees (bits 1-4
// = t mod 16, bit 0 = bit 4 of t): the 32 reads of one node fall in 32
// banks, the 8-byte children pairs of a half-warp in 16 bank pairs (bit 0
// only swaps a pair's halves, so each pair stays one aligned 8-byte word),
// and phase 1's reads of one tree by a warp stay in distinct banks per
// level. The leaves share the mask. Reads of different nodes can still
// meet in a bank; no layout avoids that for both phases, since phase 1
// reads up to 32 nodes of one tree and phase 2 one node of each of 32.
//
// The staging is plain loads (coalesced, 16.5 KB a block), with one
// barrier before phase 1 reads the tables. The wrapper refuses a t_limit
// whose tables exceed the shared memory it asks for (ops/face_cuda.py).
//
// What bounds it now, as kernel A: the block that holds a face's
// survivors. Of the headline's 26,411 tail windows 877 are alive after 4
// trees, up to 20 in one 128-window block (2,236 and 38 of 22,834 at
// 1080p), and a round of scattered pixel loads costs about 2 us when
// several warps of an SM run rounds. On an H100
// (pigo_tpu_torch/tools/face_sweep.py; PERF.md) the launch fell from 0.046
// to 0.014 ms at the headline and from 0.050 to 0.021 ms at 1080p.
//
// Measured and rejected (same tool): kPrefixPhase1Trees 2 or 8 (2 floods
// the worklists, 8 lengthens every survivor's chain; each slower at every
// block shape it was tried with); kernel A's shape of 256 windows and 256
// threads (0.019 and 0.031 ms), 256 windows with 512 or 1024 threads (0.015 and
// 0.021 ms at best), 128 windows with 256 threads (0.016 and 0.023 ms) or
// with 768 or 1024 (one block an SM, 0.020 ms at the headline), 64
// windows (0.017 ms or slower, and 1.5-2.6x slower when every window
// survives); with 256-window blocks, a dense fallback from 2/8 of a block
// (taken on the rotated 1080p pyramid, 51% slower there) or never (the
// all-survive case 56-75% slower). Staging with cp.async while phase 1
// reads its trees through __ldg from global memory (256-window blocks):
// 1-4% faster on three of the four pyramids and 5% slower at 1080p
// upright, no gain worth a second table path, so the barrier before
// phase 1 stays.

#include <cuda_runtime.h>

#include "face_walk.cuh"

namespace {

// Windows of a block, and its threads: phase 1 needs a thread per window,
// phase 2 a warp per worklist entry, so a block may have more threads
// than windows, to give a face's survivors more warps.
constexpr int kPrefixWindows = 128;
constexpr int kPrefixThreads = 512;
// Trees each window walks alone (phase 1) before a survivor goes to a warp.
constexpr int kPrefixPhase1Trees = 4;
// A worklist longer than kPrefixDenseEighths / 8 of the block's windows
// goes on a thread per window.
constexpr int kPrefixDenseEighths = 7;
constexpr int kPrefixDenseItems = kPrefixDenseEighths * kPrefixWindows / 8;

template <bool kRotated>
__global__ void __launch_bounds__(kPrefixThreads) face_prefix_kernel(
    const pigo::Windows p, const char4* __restrict__ codes,
    const float* __restrict__ preds, const float* __restrict__ thresh,
    int depth, int t_limit) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_nodes = t_limit << depth;
  const int leaves = 1 << depth;
  char4* s_codes = reinterpret_cast<char4*>(smem);
  float* s_preds = reinterpret_cast<float*>(s_codes + n_nodes);
  float* s_thresh = s_preds + n_nodes;
  for (int k = threadIdx.x; k < n_nodes; k += kPrefixThreads) {
    const int t = k >> depth;
    const int slot =
        (t << depth) + ((k & (leaves - 1)) ^ pigo::swizzle(t, depth));
    s_codes[slot] = __ldg(codes + k);
    s_preds[slot] = __ldg(preds + k);
  }
  for (int k = threadIdx.x; k < t_limit; k += kPrefixThreads) {
    s_thresh[k] = __ldg(thresh + k);
  }
  __syncthreads();
  pigo::classify_block<kPrefixThreads, kPrefixWindows, kPrefixPhase1Trees,
                       kPrefixDenseItems, kRotated, false>(
      p, pigo::SwizzledForest{s_codes, s_preds, s_thresh, depth}, t_limit,
      nullptr);
}

template <bool kRotated>
int launch(const pigo::Windows& p, const void* codes, const void* preds,
           const void* thresh, int depth, int t_limit, int smem_bytes,
           cudaStream_t stream) {
  // the worklist's static shared memory comes on top of the tables: allow
  // the dynamic part above the default 48 KB less the static part
  const auto kernel = face_prefix_kernel<kRotated>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (p.n_total + kPrefixWindows - 1) / kPrefixWindows;
  kernel<<<(unsigned)blocks, kPrefixThreads, smem_bytes, stream>>>(
      p, static_cast<const char4*>(codes), static_cast<const float*>(preds),
      static_cast<const float*>(thresh), depth, t_limit);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream` with
// `smem_bytes` of dynamic shared memory (the staged tables,
// t_limit * ((8 << depth) + 4) bytes), does not synchronise, allocates
// nothing; returns cudaGetLastError() of the launch. `out` is row f of the
// scores at out + f * out_stride.
extern "C" int pigo_face_prefix(
    const void* frames, long long n_frames, int nrows, int dim, int cols,
    const void* base, const void* scale, long long n_windows,
    const void* codes, const void* preds, const void* thresh, int depth,
    int t_limit, int rotated, int qcos, int qsin, void* out,
    long long out_stride, int smem_bytes, void* stream) {
  const pigo::Windows p =
      pigo::make_windows(frames, n_frames, nrows, dim, cols, base, scale,
                         n_windows, qcos, qsin, out, out_stride);
  if (p.n_total == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  return rotated ? launch<true>(p, codes, preds, thresh, depth, t_limit,
                                smem_bytes, s)
                 : launch<false>(p, codes, preds, thresh, depth, t_limit,
                                 smem_bytes, s);
}

// Kernel B's schedule constants, as pigo_face_schedule reports kernel A's
// (face_cascade.cu): phase-1 trees, windows and threads of a block,
// longest worklist walked a warp per entry.
extern "C" void pigo_prefix_schedule(int* out) {
  out[0] = kPrefixPhase1Trees;
  out[1] = kPrefixWindows;
  out[2] = kPrefixThreads;
  out[3] = kPrefixDenseItems;
}
