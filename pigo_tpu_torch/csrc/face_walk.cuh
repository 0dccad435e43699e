// Soft-cascade window walk shared by the face kernels (face_cascade.cu,
// face_prefix.cu): the node reads, upright and rotated, the walk of one
// tree to its leaf, and the walk of one window through the first t_limit
// trees.
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

// Table loads: through the read-only path for tables in global memory,
// plain loads for tables staged in shared memory (__ldg takes only global
// addresses).
template <bool kGlobal, class T>
__device__ __forceinline__ T load(const T* p) {
  if constexpr (kGlobal) {
    return __ldg(p);
  } else {
    return *p;
  }
}

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

// The leaf slot, in [leaves, 2 * leaves), that one tree sends the window to:
// from node 1, depth comparisons p1 <= p2 at the node's pixel pair (codes
// [1 << depth] char4 of the tree).
template <bool kGlobalTables, class Read>
__device__ __forceinline__ int leaf_slot(const Read& read, const char4* node,
                                         int depth) {
  int idx = 1;
  for (int d = 0; d < depth; ++d) {
    const char4 c = load<kGlobalTables>(node + idx);
    const int p1 = read(c.x, c.y);
    const int p2 = read(c.z, c.w);
    idx = 2 * idx + (p1 <= p2 ? 1 : 0);
  }
  return idx;
}

// Walks trees [0, t_limit) of the forest (codes [T, 1 << depth] char4,
// preds [T, 1 << depth], thresh [T]); true when the window survives them
// all, with the running sum in *sum.
template <bool kGlobalTables, class Read>
__device__ __forceinline__ bool survives(const Read& read,
                                         const char4* codes,
                                         const float* preds,
                                         const float* thresh, int depth,
                                         int t_limit, float* sum) {
  const int leaves = 1 << depth;
  float acc = 0.0f;
  for (int t = 0; t < t_limit; ++t) {
    const int idx = leaf_slot<kGlobalTables>(read, codes + t * leaves, depth);
    acc += load<kGlobalTables>(preds + t * leaves + (idx - leaves));
    if (acc <= load<kGlobalTables>(thresh + t)) return false;
  }
  *sum = acc;
  return true;
}

}  // namespace pigo
