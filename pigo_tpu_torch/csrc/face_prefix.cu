// Tree-prefix face classifier for Hopper (sm_90a): the first t_limit trees
// of the soft cascade for every window of the prefix range (the sparse
// tail scales of the pyramid) of every frame, in one launch, with the
// t_limit trees staged in shared memory. Output per window: -1 when it
// failed within t_limit trees, PREFIX_MARK when it survived them (the
// exact finish, pigo_face_finish in face_cascade.cu, then walks all trees
// for those windows). Built into one library with face_cascade.cu, which
// also holds the error-string entry point (pigo_tpu_torch/utils/build.py).
//
// Replaces the TPU kernel pigo_tpu/ops/face_pallas.py::_multi_kernel_body
// (launched by _multi_call, fed by prefix_group_scores), which evaluates
// the concatenated 16x128-window tiles of many tail scales, each tile's
// geometry (tr, ct, nr, nc, R, planes_off, table_off, valid) in SMEM, over
// phase-decimated planes, in groups sized to the TPU's VMEM and SMEM. None
// of that carries over: one thread per (frame, window) reads its own pixels
// from the uint8 frame (through __ldg), upright or rotated (face_walk.cuh),
// and every prefix window of a frame batch goes to this one launch.
//
// What bounds it: not bytes (the frame, 16.5 KB of tables and 4 B of score
// a window). Every window walks tree 0 and most fail within a few trees,
// but the windows that survive all t_limit = 32 trees run a chain of
// 32 x depth dependent code-word -> pixel loads. The design shortens each
// step of the chain: the block stages the t_limit trees' codes (char4),
// preds and thresh in shared memory once (32 x 64 x 8 B + 128 B = 16.5 KB
// at depth 6), so a node's code word comes from shared memory instead of
// L1 or L2. The dense kernel cannot do this: its 468 trees (about 240 KB)
// exceed the 227 KB a block may have. The wrapper refuses a t_limit whose
// tables exceed the shared memory it asks for (ops/face_cuda.py).

#include <cuda_runtime.h>

#include "face_walk.cuh"

namespace {

constexpr int kThreads = 256;

template <bool kRotated>
__global__ void face_prefix_kernel(
    const uint8_t* __restrict__ frames, long long frame_pixels, int nrows,
    int dim, int cols, const int* __restrict__ base,
    const int* __restrict__ scale, long long n_windows, long long n_total,
    const char4* __restrict__ codes, const float* __restrict__ preds,
    const float* __restrict__ thresh, int depth, int t_limit, int qcos,
    int qsin, float* __restrict__ out, long long out_stride) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_nodes = t_limit << depth;
  char4* s_codes = reinterpret_cast<char4*>(smem);
  float* s_preds = reinterpret_cast<float*>(s_codes + n_nodes);
  float* s_thresh = s_preds + n_nodes;
  for (int k = threadIdx.x; k < n_nodes; k += blockDim.x) {
    s_codes[k] = __ldg(codes + k);
    s_preds[k] = __ldg(preds + k);
  }
  for (int k = threadIdx.x; k < t_limit; k += blockDim.x) {
    s_thresh[k] = __ldg(thresh + k);
  }
  // every thread of the block reaches the barrier: out-of-range threads
  // leave only after it
  __syncthreads();
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n_total) return;
  const long long f = i / n_windows;
  const long long w = i - f * n_windows;
  const pigo::WindowArgs a{frames + f * frame_pixels, __ldg(base + w), cols,
                           dim, nrows, __ldg(scale + w), qcos, qsin};
  const pigo::Reader<kRotated> read(a);
  float sum;
  const bool alive = pigo::survives<false>(read, s_codes, s_preds, s_thresh,
                                           depth, t_limit, &sum);
  out[f * out_stride + w] = alive ? pigo::kPrefixMark : -1.0f;
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
  const long long n_total = n_frames * n_windows;
  if (n_total == 0) return 0;
  const long long blocks = (n_total + kThreads - 1) / kThreads;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* fr = static_cast<const uint8_t*>(frames);
  const auto* b = static_cast<const int*>(base);
  const auto* sc = static_cast<const int*>(scale);
  const auto* cd = static_cast<const char4*>(codes);
  const auto* pr = static_cast<const float*>(preds);
  const auto* th = static_cast<const float*>(thresh);
  auto* o = static_cast<float*>(out);
  const long long fp = (long long)nrows * dim;
  if (rotated) {
    face_prefix_kernel<true><<<(unsigned)blocks, kThreads, smem_bytes, s>>>(
        fr, fp, nrows, dim, cols, b, sc, n_windows, n_total, cd, pr, th,
        depth, t_limit, qcos, qsin, o, out_stride);
  } else {
    face_prefix_kernel<false><<<(unsigned)blocks, kThreads, smem_bytes, s>>>(
        fr, fp, nrows, dim, cols, b, sc, n_windows, n_total, cd, pr, th,
        depth, t_limit, qcos, qsin, o, out_stride);
  }
  return static_cast<int>(cudaGetLastError());
}
