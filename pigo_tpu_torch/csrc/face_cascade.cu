// Soft-cascade face classifier for Hopper (sm_90a): one thread per
// (frame, window), every pyramid scale of every frame in one launch.
//
// Replaces the TPU kernel pigo_tpu/ops/face_pallas.py::_kernel_body, which
// evaluates one scale per launch over 16x128-window tiles of
// phase-decimated planes. None of that layout carries over: here each
// thread reads its own pixels straight from the uint8 frame.
//
// Per window (reference core/pigo.go:113-147): for each tree t < t_limit,
// walk the depth-level tree from node 1, comparing p1 <= p2 at the node's
// pixel pair; add the leaf value to an f32 running sum, left to right; stop
// for good on sum <= thresh[t]. Output: -1 for a failed window,
// PREFIX_MARK for a survivor when t_limit < n_trees, else
// sum - thresh[n_trees - 1].
// The only f32 operations are those adds, the compares and the final
// subtract, so FMA contraction cannot change a result; the build still
// passes --fmad=false (pigo_tpu_torch/utils/build.py).
//
// Node offsets do not depend on the window:
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
// shared memory a block may have.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kPrefixMark = 1e30f;
constexpr int kThreads = 256;

__global__ void face_cascade_kernel(
    const uint8_t* __restrict__ frames,  // [n_frames, frame_pixels]
    long long frame_pixels, int cols,
    const int* __restrict__ base,    // [n_windows] r*cols + c
    const int* __restrict__ scale,   // [n_windows]
    long long n_windows, long long n_total,
    const char4* __restrict__ codes, // [n_trees, 1 << depth] (r1, c1, r2, c2)
    const float* __restrict__ preds, // [n_trees, 1 << depth]
    const float* __restrict__ thresh,// [n_trees]
    int depth, int n_trees, int t_limit,
    float* __restrict__ out)         // [n_frames, n_windows]
{
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n_total) return;
  const long long f = i / n_windows;
  const long long w = i - f * n_windows;
  const uint8_t* img = frames + f * frame_pixels + __ldg(base + w);
  const int s = __ldg(scale + w);
  const int leaves = 1 << depth;

  float sum = 0.0f;
  bool failed = false;
  for (int t = 0; t < t_limit; ++t) {
    const char4* node = codes + (long long)t * leaves;
    int idx = 1;
    for (int d = 0; d < depth; ++d) {
      const char4 c = __ldg(node + idx);
      const int p1 = __ldg(img + ((c.x * s) >> 8) * cols + ((c.y * s) >> 8));
      const int p2 = __ldg(img + ((c.z * s) >> 8) * cols + ((c.w * s) >> 8));
      idx = 2 * idx + (p1 <= p2 ? 1 : 0);
    }
    sum += __ldg(preds + (long long)t * leaves + (idx - leaves));
    if (sum <= __ldg(thresh + t)) {
      failed = true;
      break;
    }
  }
  float q;
  if (failed) {
    q = -1.0f;
  } else if (t_limit < n_trees) {
    q = kPrefixMark;
  } else {
    q = sum - __ldg(thresh + n_trees - 1);
  }
  out[i] = q;
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream`, does not
// synchronise, allocates nothing; returns cudaGetLastError() of the launch.
extern "C" int pigo_face_cascade(
    const void* frames, long long n_frames, long long frame_pixels, int cols,
    const void* base, const void* scale, long long n_windows,
    const void* codes, const void* preds, const void* thresh,
    int depth, int n_trees, int t_limit, void* out, void* stream) {
  const long long n_total = n_frames * n_windows;
  if (n_total == 0) return 0;
  const long long blocks = (n_total + kThreads - 1) / kThreads;
  face_cascade_kernel<<<(unsigned)blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(frames), frame_pixels, cols,
      static_cast<const int*>(base), static_cast<const int*>(scale),
      n_windows, n_total, static_cast<const char4*>(codes),
      static_cast<const float*>(preds), static_cast<const float*>(thresh),
      depth, n_trees, t_limit, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pigo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
