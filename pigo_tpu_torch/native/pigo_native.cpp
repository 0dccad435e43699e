// pigo_tpu_torch native engine: the C++ host runtime of the PICO detection
// stack, the PyTorch/CUDA port's own copy of the JAX package's engine
// (native/pigo_native.cpp at the repository root), loaded through
// pigo_tpu_torch/native/__init__.py. It provides:
//
//   * binary-exact cascade parsers for the three frozen model formats,
//   * a scalar/threaded CPU implementation of the full PICO semantics
//     (face cascade, rotated path, IoU clustering, pupil regression walks,
//     perturbation ensemble + median vote, landmark anchors), used as the
//     host tail engine of the face stage and as an independent oracle,
//   * fast host-side ops (grayscale conversion, detection clustering),
//   * a C ABI consumed from Python via ctypes and from any C program,
//     mirroring the reference's FindFaces export shape (count header +
//     flattened rows).
//
// It is the same engine as the JAX package's, with two changes: the scan
// pool's thread count is an argument of the entry points that scan (0
// picks min(hardware threads, 16)), and the AVX-512 paths are chosen per
// cascade handle by a flag given at parse time (still gated by a run-time
// check of the CPU). It reads no environment variable.
//
// Semantics are an independent re-implementation of the reference
// behaviours (core/pigo.go, core/puploc.go, core/flploc.go); float32
// accumulation orders match the reference exactly (compile with
// -ffp-contract=off: no FMA contraction). Build: pigo_tpu_torch/utils/
// build.py (g++ -O3 -march=native -shared -fPIC -ffp-contract=off).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#if defined(__AVX512F__)
#include <immintrin.h>
#endif

namespace {

// ---------------------------------------------------------------------------
// Model containers (SoA, same layouts as pigo_tpu_torch/cascade/format.py)
// ---------------------------------------------------------------------------

struct FaceForest {
  int depth = 0;
  int num_trees = 0;
  int leaves = 0;                // 2^depth; also node-slot count (slot 0 pad)
  std::vector<int8_t> codes;     // [T, L, 4], node 0 zeroed
  std::vector<float> preds;      // [T, L]
  std::vector<float> thresh;     // [T]
  bool simd = false;             // AVX-512 paths allowed (use_simd)
};

struct PupilForest {
  int stages = 0;
  float scale_mult = 0.f;
  int trees = 0;
  int depth = 0;
  int leaves = 0;                // 2^depth
  std::vector<int8_t> codes;     // [S, T, L, 4]; slots [0, L-1) real
  std::vector<float> preds;      // [S, T, L, 2]
  bool simd = false;             // AVX-512 paths allowed (use_simd)
};

struct Detection {
  int row, col, scale;
  float q;
};

uint32_t read_u32le(const uint8_t* p) {
  return uint32_t(p[0]) | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16) |
         (uint32_t(p[3]) << 24);
}

float read_f32le(const uint8_t* p) {
  uint32_t u = read_u32le(p);
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

// Face cascade binary: 8-byte header skip, u32 depth, u32 tree count, then
// per tree 4*2^d-4 int8 codes + 2^d f32 leaf preds + 1 f32 threshold
// (reference layout: core/pigo.go:51-110).
bool parse_face(const uint8_t* data, int64_t len, FaceForest* out,
                std::string* err) {
  if (len < 16) {
    *err = "face cascade truncated: header";
    return false;
  }
  int depth = int(read_u32le(data + 8));
  int num_trees = int(read_u32le(data + 12));
  if (depth < 1 || depth > 16 || num_trees < 1 || num_trees > 1000000) {
    *err = "invalid face cascade header: depth=" + std::to_string(depth) +
           " trees=" + std::to_string(num_trees);
    return false;
  }
  int64_t leaves = int64_t(1) << depth;
  int64_t code_bytes = 4 * leaves - 4;
  int64_t rec_bytes = code_bytes + 4 * leaves + 4;
  if (len < 16 + num_trees * rec_bytes) {
    *err = "face cascade truncated: need " +
           std::to_string(16 + num_trees * rec_bytes) + " bytes";
    return false;
  }
  out->depth = depth;
  out->num_trees = num_trees;
  out->leaves = int(leaves);
  out->codes.assign(size_t(num_trees) * leaves * 4, 0);
  out->preds.resize(size_t(num_trees) * leaves);
  out->thresh.resize(num_trees);
  const uint8_t* p = data + 16;
  for (int t = 0; t < num_trees; ++t) {
    // node slot 0 stays zero; slots [1, L) hold the packed codes
    std::memcpy(&out->codes[(size_t(t) * leaves + 1) * 4], p, code_bytes);
    p += code_bytes;
    for (int64_t l = 0; l < leaves; ++l, p += 4)
      out->preds[size_t(t) * leaves + l] = read_f32le(p);
    out->thresh[t] = read_f32le(p);
    p += 4;
  }
  return true;
}

// Pupil/landmark binary: u32 stages, f32 scale_mult, u32 trees, u32 depth,
// then per (stage, tree) 4*2^d-4 int8 codes + 2^d (dr, dc) f32 pairs
// (reference layout: core/puploc.go:38-103).
bool parse_pupil(const uint8_t* data, int64_t len, PupilForest* out,
                 std::string* err) {
  if (len < 16) {
    *err = "pupil cascade truncated: header";
    return false;
  }
  int stages = int(read_u32le(data));
  float scale_mult = read_f32le(data + 4);
  int trees = int(read_u32le(data + 8));
  int depth = int(read_u32le(data + 12));
  if (stages < 1 || stages > 64 || trees < 1 || trees > 4096 || depth < 1 ||
      depth > 16) {
    *err = "invalid pupil cascade header: stages=" + std::to_string(stages) +
           " trees=" + std::to_string(trees) +
           " depth=" + std::to_string(depth);
    return false;
  }
  int64_t leaves = int64_t(1) << depth;
  int64_t code_bytes = 4 * leaves - 4;
  int64_t rec_bytes = code_bytes + 8 * leaves;
  int64_t total = int64_t(stages) * trees;
  if (len < 16 + total * rec_bytes) {
    *err = "pupil cascade truncated: need " +
           std::to_string(16 + total * rec_bytes) + " bytes";
    return false;
  }
  out->stages = stages;
  out->scale_mult = scale_mult;
  out->trees = trees;
  out->depth = depth;
  out->leaves = int(leaves);
  out->codes.assign(size_t(total) * leaves * 4, 0);
  out->preds.resize(size_t(total) * leaves * 2);
  const uint8_t* p = data + 16;
  for (int64_t k = 0; k < total; ++k) {
    // node slots [0, L-1) are real; slot L-1 stays zero (uniform indexing pad)
    std::memcpy(&out->codes[size_t(k) * leaves * 4], p, code_bytes);
    p += code_bytes;
    for (int64_t l = 0; l < 2 * leaves; ++l, p += 4)
      out->preds[size_t(k) * leaves * 2 + l] = read_f32le(p);
  }
  return true;
}

// ---------------------------------------------------------------------------
// Face cascade classifiers (semantics: SURVEY.md 2.1, core/pigo.go:113-191)
// ---------------------------------------------------------------------------

// Quantized 256-scaled cos/sin, indexed by int(32*angle), angle in [0, 1]
// as a fraction of 2*pi (reference core/pigo.go:156-157).
const int kQCos[33] = {256,  251,  236,  212,  181,  142,  97,   49,  0,
                       -49,  -97,  -142, -181, -212, -236, -251, -256, -251,
                       -236, -212, -181, -142, -97,  -49,  0,    49,  97,
                       142,  181,  212,  236,  251,  256};
const int kQSin[33] = {0,    49,   97,   142,  181,  212,  236,  251, 256,
                       251,  236,  212,  181,  142,  97,   49,   0,   -49,
                       -97,  -142, -181, -212, -236, -251, -256, -251, -236,
                       -212, -181, -142, -97,  -49,  0};

// Upright window classifier: depth-d walk per tree with 8.8 fixed-point
// window math, bintest px1 <= px2 -> right child, strict f32 accumulation,
// soft-cascade early exit, final score = sum - last threshold.
float classify_region(const FaceForest& f, int r, int c, int s,
                      const uint8_t* pix, int dim, int t0 = 0,
                      float out0 = 0.f) {
  const int64_t r256 = int64_t(r) * 256;
  const int64_t c256 = int64_t(c) * 256;
  const int L = f.leaves;
  float out = out0;
  for (int t = t0; t < f.num_trees; ++t) {
    const int8_t* codes = &f.codes[size_t(t) * L * 4];
    int idx = 1;
    for (int d = 0; d < f.depth; ++d) {
      const int8_t* n = codes + 4 * idx;
      int64_t x1 = ((r256 + int64_t(n[0]) * s) >> 8) * dim +
                   ((c256 + int64_t(n[1]) * s) >> 8);
      int64_t x2 = ((r256 + int64_t(n[2]) * s) >> 8) * dim +
                   ((c256 + int64_t(n[3]) * s) >> 8);
      idx = 2 * idx + (pix[x1] <= pix[x2] ? 1 : 0);
    }
    out += f.preds[size_t(t) * L + (idx - L)];
    if (out <= f.thresh[t]) return -1.0f;
  }
  return out - f.thresh[f.num_trees - 1];
}

// Rotated classifier: 16.16 fixed point with the quantized tables; preserves
// the reference quirks (both axes clamped with nrows-1; max(0,.) before the
// >>16 shift; abs() after) — see core/pigo.go:150-191.
float classify_rotated_region(const FaceForest& f, int r, int c, int s,
                              double a, int nrows, const uint8_t* pix,
                              int dim, int t0 = 0, float out0 = 0.f) {
  const int ti = int(32.0 * a);
  const int64_t qsin = int64_t(s) * kQSin[ti];
  const int64_t qcos = int64_t(s) * kQCos[ti];
  const int64_t r65536 = int64_t(r) * 65536;
  const int64_t c65536 = int64_t(c) * 65536;
  const int64_t hi = nrows - 1;
  const int L = f.leaves;
  auto rot = [&](int64_t base_r, int64_t base_c, int64_t cr,
                 int64_t cc) -> int64_t {
    int64_t rr = std::abs(
        std::min(hi, std::max(int64_t(0), base_r + qcos * cr - qsin * cc) >> 16));
    int64_t col = std::abs(
        std::min(hi, std::max(int64_t(0), base_c + qsin * cr + qcos * cc) >> 16));
    return rr * dim + col;
  };
  float out = out0;
  for (int t = t0; t < f.num_trees; ++t) {
    const int8_t* codes = &f.codes[size_t(t) * L * 4];
    int idx = 1;
    for (int d = 0; d < f.depth; ++d) {
      const int8_t* n = codes + 4 * idx;
      int64_t x1 = rot(r65536, c65536, n[0], n[1]);
      int64_t x2 = rot(r65536, c65536, n[2], n[3]);
      idx = 2 * idx + (pix[x1] <= pix[x2] ? 1 : 0);
    }
    out += f.preds[size_t(t) * L + (idx - L)];
    if (out <= f.thresh[t]) return -1.0f;
  }
  return out - f.thresh[f.num_trees - 1];
}

// ---------------------------------------------------------------------------
// AVX-512 window classifiers: 16 windows per pass, bit-exact vs the scalar
// paths above (same f32 accumulation order per lane; soft-cascade exit is a
// lane mask, so a lane's score sequence is identical to the scalar walk).
// The hot loop is 3 gathers/level (code quad, two pixels); pixels are
// fetched as aligned 32-bit words + in-word byte extract, which cannot
// cross a page boundary (no overread faults on the caller's buffer).
// Reference semantics: core/pigo.go:113-191.
// ---------------------------------------------------------------------------

#if defined(__AVX512F__)
namespace simd {

// Sign-extended byte b (0..3) of each 32-bit lane (the packed node quad).
static inline __m512i sx8(__m512i quads, int b) {
  return _mm512_srai_epi32(_mm512_slli_epi32(quads, 24 - 8 * b), 24);
}

// Pixel-byte gather plan: fetch the 4-byte-ALIGNED word holding each byte,
// then shift/mask the byte out. An aligned word never crosses a page, so
// no gather can fault past the caller's buffer. `words` is the buffer
// aligned down to 4; `bias` re-biases byte offsets for that alignment.
struct PixWords {
  const int* words;
  __m512i bias;
  explicit PixWords(const uint8_t* pix) {
    const uintptr_t mis = reinterpret_cast<uintptr_t>(pix) & 3;
    words = reinterpret_cast<const int*>(pix - mis);
    bias = _mm512_set1_epi32(int(mis));
  }
};

static inline __m512i gather_px(__mmask16 m, __m512i x, const PixWords& pw) {
  x = _mm512_add_epi32(x, pw.bias);
  __m512i w = _mm512_mask_i32gather_epi32(
      _mm512_setzero_si512(), m, _mm512_srli_epi32(x, 2), pw.words, 4);
  __m512i sh =
      _mm512_slli_epi32(_mm512_and_si512(x, _mm512_set1_epi32(3)), 3);
  return _mm512_and_si512(_mm512_srlv_epi32(w, sh), _mm512_set1_epi32(0xFF));
}

// Upright classifier for 16 windows (per-lane row/col/scale). Returns per
// lane the f32 score, or -1.0f on soft-cascade early exit / masked lane.
static inline __m512 classify16(const FaceForest& f, const uint8_t* pix,
                                int dim, __m512i rv, __m512i cv, __m512i sv,
                                __mmask16 all) {
  const int L = f.leaves;
  const PixWords pw(pix);
  const __m512i dimv = _mm512_set1_epi32(dim);
  const __m512i one = _mm512_set1_epi32(1);
  const __m512i r256 = _mm512_slli_epi32(rv, 8);
  const __m512i c256 = _mm512_slli_epi32(cv, 8);
  __mmask16 active = all;
  __m512 outv = _mm512_setzero_ps();
  for (int t = 0; t < f.num_trees; ++t) {
    const int8_t* codes = &f.codes[size_t(t) * L * 4];
    __m512i idx = one;
    for (int d = 0; d < f.depth; ++d) {
      __m512i quads = _mm512_mask_i32gather_epi32(
          _mm512_setzero_si512(), active, idx,
          reinterpret_cast<const int*>(codes), 4);
      __m512i rp1 = _mm512_srai_epi32(
          _mm512_add_epi32(r256, _mm512_mullo_epi32(sx8(quads, 0), sv)), 8);
      __m512i cp1 = _mm512_srai_epi32(
          _mm512_add_epi32(c256, _mm512_mullo_epi32(sx8(quads, 1), sv)), 8);
      __m512i rp2 = _mm512_srai_epi32(
          _mm512_add_epi32(r256, _mm512_mullo_epi32(sx8(quads, 2), sv)), 8);
      __m512i cp2 = _mm512_srai_epi32(
          _mm512_add_epi32(c256, _mm512_mullo_epi32(sx8(quads, 3), sv)), 8);
      __m512i x1 = _mm512_add_epi32(_mm512_mullo_epi32(rp1, dimv), cp1);
      __m512i x2 = _mm512_add_epi32(_mm512_mullo_epi32(rp2, dimv), cp2);
      __m512i p1 = gather_px(active, x1, pw);
      __m512i p2 = gather_px(active, x2, pw);
      __mmask16 b = _mm512_cmple_epu32_mask(p1, p2);
      idx = _mm512_add_epi32(idx, idx);
      idx = _mm512_mask_add_epi32(idx, b, idx, one);
    }
    __m512i pidx = _mm512_sub_epi32(idx, _mm512_set1_epi32(L));
    __m512 pred = _mm512_mask_i32gather_ps(_mm512_setzero_ps(), active, pidx,
                                           &f.preds[size_t(t) * L], 4);
    outv = _mm512_mask_add_ps(outv, active, outv, pred);
    // stay condition is the scalar's !(out <= thresh) — NLE, unordered
    active = _mm512_mask_cmp_ps_mask(active, outv,
                                     _mm512_set1_ps(f.thresh[t]), _CMP_NLE_UQ);
    if (active == 0) break;
  }
  return _mm512_mask_sub_ps(_mm512_set1_ps(-1.0f), active, outv,
                            _mm512_set1_ps(f.thresh[f.num_trees - 1]));
}

// Rotated classifier for 16 windows, preserving the reference quirks
// (both axes clamp with nrows-1; max(0,.) before >>16; abs after).
static inline __m512 classify16_rotated(const FaceForest& f,
                                        const uint8_t* pix, int nrows,
                                        int dim, __m512i rv, __m512i cv,
                                        __m512i sv, int ti, __mmask16 all) {
  const int L = f.leaves;
  const PixWords pw(pix);
  const __m512i dimv = _mm512_set1_epi32(dim);
  const __m512i one = _mm512_set1_epi32(1);
  const __m512i zero = _mm512_setzero_si512();
  const __m512i hi = _mm512_set1_epi32(nrows - 1);
  const __m512i qsin = _mm512_mullo_epi32(sv, _mm512_set1_epi32(kQSin[ti]));
  const __m512i qcos = _mm512_mullo_epi32(sv, _mm512_set1_epi32(kQCos[ti]));
  const __m512i r65536 = _mm512_slli_epi32(rv, 16);
  const __m512i c65536 = _mm512_slli_epi32(cv, 16);
  auto rot_axis = [&](__m512i base, __m512i a, __m512i b) -> __m512i {
    // abs(min(hi, max(0, base + a) >> 16)) with a = qcos*n -+ qsin*m folded
    // by the caller into one vector
    __m512i v = _mm512_srai_epi32(
        _mm512_max_epi32(zero, _mm512_add_epi32(base, _mm512_add_epi32(a, b))),
        16);
    return _mm512_abs_epi32(_mm512_min_epi32(hi, v));
  };
  __mmask16 active = all;
  __m512 outv = _mm512_setzero_ps();
  for (int t = 0; t < f.num_trees; ++t) {
    const int8_t* codes = &f.codes[size_t(t) * L * 4];
    __m512i idx = one;
    for (int d = 0; d < f.depth; ++d) {
      __m512i quads = _mm512_mask_i32gather_epi32(
          zero, active, idx, reinterpret_cast<const int*>(codes), 4);
      __m512i n0 = sx8(quads, 0), n1 = sx8(quads, 1);
      __m512i n2 = sx8(quads, 2), n3 = sx8(quads, 3);
      __m512i r1 = rot_axis(r65536, _mm512_mullo_epi32(qcos, n0),
                            _mm512_sub_epi32(zero, _mm512_mullo_epi32(qsin, n1)));
      __m512i c1 = rot_axis(c65536, _mm512_mullo_epi32(qsin, n0),
                            _mm512_mullo_epi32(qcos, n1));
      __m512i r2 = rot_axis(r65536, _mm512_mullo_epi32(qcos, n2),
                            _mm512_sub_epi32(zero, _mm512_mullo_epi32(qsin, n3)));
      __m512i c2 = rot_axis(c65536, _mm512_mullo_epi32(qsin, n2),
                            _mm512_mullo_epi32(qcos, n3));
      __m512i x1 = _mm512_add_epi32(_mm512_mullo_epi32(r1, dimv), c1);
      __m512i x2 = _mm512_add_epi32(_mm512_mullo_epi32(r2, dimv), c2);
      __m512i p1 = gather_px(active, x1, pw);
      __m512i p2 = gather_px(active, x2, pw);
      __mmask16 b = _mm512_cmple_epu32_mask(p1, p2);
      idx = _mm512_add_epi32(idx, idx);
      idx = _mm512_mask_add_epi32(idx, b, idx, one);
    }
    __m512i pidx = _mm512_sub_epi32(idx, _mm512_set1_epi32(L));
    __m512 pred = _mm512_mask_i32gather_ps(_mm512_setzero_ps(), active, pidx,
                                           &f.preds[size_t(t) * L], 4);
    outv = _mm512_mask_add_ps(outv, active, outv, pred);
    active = _mm512_mask_cmp_ps_mask(active, outv,
                                     _mm512_set1_ps(f.thresh[t]), _CMP_NLE_UQ);
    if (active == 0) break;
  }
  return _mm512_mask_sub_ps(_mm512_set1_ps(-1.0f), active, outv,
                            _mm512_set1_ps(f.thresh[f.num_trees - 1]));
}

// Tree-major phased row scan: the host mirror of the TPU kernel's phase
// decimation (ops/face_pallas.py). Lane-parallel soft cascades waste lanes
// — a 16-window chunk runs until its SLOWEST window exits, and most windows
// exit within a few trees — so instead evaluate tree t across a compacted
// array of still-alive windows and compress-store the survivors. Work done
// is then proportional to the number of truly-alive (window, tree) pairs,
// exactly like the scalar walk, but 16 windows per instruction.
// Bit-exact: each window still accumulates the same f32 preds in the same
// tree order and exits on the same !(out <= thresh) test.
template <bool kRot>
static void classify_row_phased(const FaceForest& f, const uint8_t* pix,
                                int nrows, int dim, int r, int c0, int step,
                                int count, int s, double angle, int ti,
                                float* qs) {
  static thread_local std::vector<int32_t> tl_c, tl_k;
  static thread_local std::vector<float> tl_o;
  if (int(tl_c.size()) < count) {
    tl_c.resize(count);
    tl_k.resize(count);
    tl_o.resize(count);
  }
  int32_t* cb = tl_c.data();
  int32_t* kb = tl_k.data();
  float* ob = tl_o.data();
  for (int k = 0; k < count; ++k) {
    cb[k] = c0 + k * step;
    kb[k] = k;
    ob[k] = 0.f;
    qs[k] = -1.0f;
  }

  const int L = f.leaves;
  const int T = f.num_trees;
  const PixWords pw(pix);
  const __m512i dimv = _mm512_set1_epi32(dim);
  const __m512i one = _mm512_set1_epi32(1);
  const __m512i zero = _mm512_setzero_si512();
  // upright consts (8.8 fixed point)
  const __m512i r256 = _mm512_set1_epi32(r * 256);
  const __m512i sv = _mm512_set1_epi32(s);
  // rotated consts (16.16 fixed point, quantized tables)
  const __m512i hi = _mm512_set1_epi32(nrows - 1);
  const __m512i qsin = _mm512_set1_epi32(s * kQSin[ti]);
  const __m512i qcos = _mm512_set1_epi32(s * kQCos[ti]);
  const __m512i r65536 = _mm512_set1_epi32(r * 65536);
  const __m512 last_thresh = _mm512_set1_ps(f.thresh[T - 1]);

  // Once few windows remain alive, a full 16-wide chunk per remaining tree
  // (up to T-t of them) costs more than finishing each survivor's walk
  // scalar — a window that survives hundreds of trees (a real face) would
  // otherwise drag a whole chunk through every one of them.
  constexpr int kScalarFinish = 4;
  int na = count;
  for (int t = 0; t < T && na > 0; ++t) {
    if (na <= kScalarFinish && t > 0) {
      for (int j = 0; j < na; ++j) {
        const float q =
            kRot ? classify_rotated_region(f, r, cb[j], s, angle, nrows, pix,
                                           dim, t, ob[j])
                 : classify_region(f, r, cb[j], s, pix, dim, t, ob[j]);
        qs[kb[j]] = q;
      }
      return;
    }
    const int8_t* codes = &f.codes[size_t(t) * L * 4];
    const float* preds = &f.preds[size_t(t) * L];
    const __m512 threshv = _mm512_set1_ps(f.thresh[t]);
    int nn = 0;
    for (int i = 0; i < na; i += 16) {
      const int n = std::min(16, na - i);
      const __mmask16 m = __mmask16((1u << n) - 1);
      __m512i cv = _mm512_maskz_loadu_epi32(m, cb + i);
      __m512i kv = _mm512_maskz_loadu_epi32(m, kb + i);
      __m512 ov = _mm512_maskz_loadu_ps(m, ob + i);
      __m512i idx = one;
      for (int d = 0; d < f.depth; ++d) {
        __m512i quads = _mm512_mask_i32gather_epi32(
            zero, m, idx, reinterpret_cast<const int*>(codes), 4);
        __m512i x1, x2;
        if (kRot) {
          __m512i n0 = sx8(quads, 0), n1 = sx8(quads, 1);
          __m512i n2 = sx8(quads, 2), n3 = sx8(quads, 3);
          const __m512i c65536 = _mm512_slli_epi32(cv, 16);
          auto axis = [&](__m512i base, __m512i a, __m512i b) {
            __m512i v = _mm512_srai_epi32(
                _mm512_max_epi32(zero,
                                 _mm512_add_epi32(base, _mm512_add_epi32(a, b))),
                16);
            return _mm512_abs_epi32(_mm512_min_epi32(hi, v));
          };
          __m512i r1 = axis(r65536, _mm512_mullo_epi32(qcos, n0),
                            _mm512_sub_epi32(zero, _mm512_mullo_epi32(qsin, n1)));
          __m512i c1 = axis(c65536, _mm512_mullo_epi32(qsin, n0),
                            _mm512_mullo_epi32(qcos, n1));
          __m512i r2 = axis(r65536, _mm512_mullo_epi32(qcos, n2),
                            _mm512_sub_epi32(zero, _mm512_mullo_epi32(qsin, n3)));
          __m512i c2 = axis(c65536, _mm512_mullo_epi32(qsin, n2),
                            _mm512_mullo_epi32(qcos, n3));
          x1 = _mm512_add_epi32(_mm512_mullo_epi32(r1, dimv), c1);
          x2 = _mm512_add_epi32(_mm512_mullo_epi32(r2, dimv), c2);
        } else {
          const __m512i c256 = _mm512_slli_epi32(cv, 8);
          __m512i rp1 = _mm512_srai_epi32(
              _mm512_add_epi32(r256, _mm512_mullo_epi32(sx8(quads, 0), sv)), 8);
          __m512i cp1 = _mm512_srai_epi32(
              _mm512_add_epi32(c256, _mm512_mullo_epi32(sx8(quads, 1), sv)), 8);
          __m512i rp2 = _mm512_srai_epi32(
              _mm512_add_epi32(r256, _mm512_mullo_epi32(sx8(quads, 2), sv)), 8);
          __m512i cp2 = _mm512_srai_epi32(
              _mm512_add_epi32(c256, _mm512_mullo_epi32(sx8(quads, 3), sv)), 8);
          x1 = _mm512_add_epi32(_mm512_mullo_epi32(rp1, dimv), cp1);
          x2 = _mm512_add_epi32(_mm512_mullo_epi32(rp2, dimv), cp2);
        }
        __m512i p1 = gather_px(m, x1, pw);
        __m512i p2 = gather_px(m, x2, pw);
        __mmask16 b = _mm512_cmple_epu32_mask(p1, p2);
        idx = _mm512_add_epi32(idx, idx);
        idx = _mm512_mask_add_epi32(idx, b, idx, one);
      }
      __m512i pidx = _mm512_sub_epi32(idx, _mm512_set1_epi32(L));
      __m512 pred =
          _mm512_mask_i32gather_ps(_mm512_setzero_ps(), m, pidx, preds, 4);
      ov = _mm512_mask_add_ps(ov, m, ov, pred);
      const __mmask16 stay = _mm512_mask_cmp_ps_mask(m, ov, threshv, _CMP_NLE_UQ);
      if (t == T - 1) {
        // survivors of the last tree: q = out - last threshold
        _mm512_mask_i32scatter_ps(qs, stay, kv, _mm512_sub_ps(ov, last_thresh),
                                  4);
      } else if (stay != 0) {
        // compact survivors toward the front (nn <= i: in-place safe)
        _mm512_mask_compressstoreu_epi32(cb + nn, stay, cv);
        _mm512_mask_compressstoreu_epi32(kb + nn, stay, kv);
        _mm512_mask_compressstoreu_ps(ob + nn, stay, ov);
        nn += __builtin_popcount(unsigned(stay));
      }
    }
    na = nn;
  }
}

}  // namespace simd
#endif  // __AVX512F__

// Run-time gate: the build machine is the run machine (-march=native), but
// the library could outlive a VM migration; verify the CPU agrees. `want`
// is the cascade handle's flag (the caller's simd= argument).
bool cpu_has_simd() {
#if defined(__AVX512F__)
  static const bool ok = bool(__builtin_cpu_supports("avx512f"));
  return ok;
#else
  return false;
#endif
}

bool use_simd(bool want) { return want && cpu_has_simd(); }

// int32 headroom guard for the vector fixed-point math (the scalar paths use
// int64): 16.16 rotated terms are bounded by rows*65536 + s*256*128.
bool simd_fits_i32(int nrows, int dim, int scale) {
  return int64_t(nrows) * 65536 + int64_t(scale) * 32768 < (int64_t(1) << 31) &&
         int64_t(nrows) * dim < (int64_t(1) << 31);
}

// Classify one strided row of windows: cols c0, c0+step, ... (count of
// them), all at (r, scale, angle). Writes the per-window score (or -1 on
// early exit) into qs. Dispatches to the AVX-512 path when available.
void classify_row(const FaceForest& f, const uint8_t* pix, int nrows, int dim,
                  int r, int c0, int step, int count, int scale, double angle,
                  float* qs) {
#if defined(__AVX512F__)
  if (use_simd(f.simd) && simd_fits_i32(nrows, dim, scale)) {
    const int ti = int(32.0 * angle);
    if (angle > 0.0) {
      simd::classify_row_phased<true>(f, pix, nrows, dim, r, c0, step, count,
                                      scale, angle, ti, qs);
    } else {
      simd::classify_row_phased<false>(f, pix, nrows, dim, r, c0, step, count,
                                       scale, angle, ti, qs);
    }
    return;
  }
#endif
  for (int i = 0; i < count; ++i) {
    const int c = c0 + i * step;
    qs[i] = (angle > 0.0)
                ? classify_rotated_region(f, r, c, scale, angle, nrows, pix, dim)
                : classify_region(f, r, c, scale, pix, dim);
  }
}

// Classify an explicit window list (int32 [n, 3] = row, col, scale), all at
// one angle. The (r, c, s) triples ride per lane.
void classify_list(const FaceForest& f, const uint8_t* pix, int nrows,
                   int dim, const int32_t* windows, int64_t n, double angle,
                   float* qs) {
#if defined(__AVX512F__)
  if (use_simd(f.simd)) {
    const int ti = int(32.0 * angle);
    int64_t i = 0;
    while (i < n) {
      const int m = int(std::min<int64_t>(16, n - i));
      alignas(64) int32_t rb[16] = {0}, cb[16] = {0}, sb[16] = {0};
      bool fits = true;
      for (int k = 0; k < m; ++k) {
        const int32_t* w = windows + 3 * (i + k);
        rb[k] = w[0];
        cb[k] = w[1];
        sb[k] = w[2];
        fits = fits && simd_fits_i32(nrows, dim, w[2]);
      }
      if (!fits) break;  // absurd sizes: finish the rest on the scalar path
      const __mmask16 all = __mmask16((1u << m) - 1);
      __m512i rv = _mm512_load_si512(rb);
      __m512i cv = _mm512_load_si512(cb);
      __m512i sv = _mm512_load_si512(sb);
      __m512 q = (angle > 0.0)
                     ? simd::classify16_rotated(f, pix, nrows, dim, rv, cv, sv,
                                                ti, all)
                     : simd::classify16(f, pix, dim, rv, cv, sv, all);
      _mm512_mask_storeu_ps(qs + i, all, q);
      i += m;
    }
    if (i >= n) return;
    windows += 3 * i;
    qs += i;
    n -= i;
  }
#endif
  for (int64_t i = 0; i < n; ++i) {
    const int32_t* w = windows + 3 * i;
    qs[i] = (angle > 0.0)
                ? classify_rotated_region(f, w[0], w[1], w[2], angle, nrows,
                                          pix, dim)
                : classify_region(f, w[0], w[1], w[2], pix, dim);
  }
}

// Scan-pool size: `threads` when positive, else min(hardware threads, 16).
int pool_threads(int threads) {
  if (threads > 0) return threads;
  unsigned hc = std::thread::hardware_concurrency();
  return hc == 0 ? 1 : int(std::min(hc, 16u));
}

// Multi-scale sliding-window scan (reference loop bounds core/pigo.go:
// 212-258: step = max(shift*scale, 1), offset = scale/2+1, scale update
// scale += max(2, scale*scale_factor - scale), angle clamped to <= 1).
// Scan order (scale-major, then row, then col) is preserved; rows of a scale
// are split across a thread pool.
std::vector<Detection> run_cascade(const FaceForest& f, const uint8_t* pix,
                                   int rows, int cols, int dim, int min_size,
                                   int max_size, double shift, double scale_f,
                                   double angle, int threads) {
  std::vector<Detection> dets;
  if (angle > 1.0) angle = 1.0;
  const int nthreads = pool_threads(threads);
  for (int scale = min_size; scale <= max_size;
       scale += std::max(2, int(double(scale) * scale_f) - scale)) {
    int step = std::max(int(shift * scale), 1);
    int offset = (scale >> 1) + 1;
    int nrow = (rows - 2 * offset) / step + 1;
    if (nrow < 1 || offset > cols - offset) {
      if (rows - offset < offset) continue;
    }
    std::vector<int> row_vals;
    for (int r = offset; r <= rows - offset; r += step) row_vals.push_back(r);
    if (row_vals.empty()) continue;
    const int ncols_w = (cols - 2 * offset) / step + 1;
    if (ncols_w < 1) continue;
    std::vector<std::vector<Detection>> per_row(row_vals.size());
    std::atomic<size_t> next{0};
    auto work = [&]() {
      std::vector<float> qs(static_cast<size_t>(ncols_w));
      for (;;) {
        size_t i = next.fetch_add(1);
        if (i >= row_vals.size()) break;
        int r = row_vals[i];
        auto& local = per_row[i];
        classify_row(f, pix, rows, dim, r, offset, step, ncols_w, scale,
                     angle, qs.data());
        for (int k = 0; k < ncols_w; ++k)
          if (qs[k] > 0.f) local.push_back({r, offset + k * step, scale, qs[k]});
      }
    };
    int nt = std::min<int>(nthreads, int(row_vals.size()));
    if (nt <= 1) {
      work();
    } else {
      std::vector<std::thread> pool;
      pool.reserve(nt);
      for (int i = 0; i < nt; ++i) pool.emplace_back(work);
      for (auto& th : pool) th.join();
    }
    for (auto& local : per_row)
      dets.insert(dets.end(), local.begin(), local.end());
  }
  return dets;
}

// ---------------------------------------------------------------------------
// IoU clustering (reference core/pigo.go:262-308; see pigo_tpu_torch/ops/cluster.py)
// ---------------------------------------------------------------------------

// Sort ascending by q (stable), then for each unvisited detection union every
// detection with IoU > threshold into an averaged cluster: integer-truncated
// mean (row, col, scale), f32-summed q. IoU treats detections as square boxes
// with union s1^2 + s2^2 - inter.
std::vector<Detection> cluster_detections(std::vector<Detection> d,
                                          double iou_threshold) {
  const size_t n = d.size();
  std::stable_sort(d.begin(), d.end(),
                   [](const Detection& a, const Detection& b) {
                     return a.q < b.q;
                   });
  std::vector<bool> assigned(n, false);
  std::vector<Detection> clusters;
  for (size_t i = 0; i < n; ++i) {
    if (assigned[i]) continue;
    int64_t sr = 0, sc = 0, ss = 0;
    int64_t cnt = 0;
    float sq = 0.f;
    for (size_t j = 0; j < n; ++j) {
      double s1 = d[i].scale, s2 = d[j].scale;
      double over_row = std::max(
          0.0, std::min(d[i].row + s1 / 2, d[j].row + s2 / 2) -
                   std::max(d[i].row - s1 / 2, d[j].row - s2 / 2));
      double over_col = std::max(
          0.0, std::min(d[i].col + s1 / 2, d[j].col + s2 / 2) -
                   std::max(d[i].col - s1 / 2, d[j].col - s2 / 2));
      double inter = over_row * over_col;
      double iou = inter / (s1 * s1 + s2 * s2 - inter);
      if (iou > iou_threshold) {
        assigned[j] = true;
        sr += d[j].row;
        sc += d[j].col;
        ss += d[j].scale;
        sq += d[j].q;  // f32 accumulation in ascending-q order
        ++cnt;
      }
    }
    if (cnt > 0)
      clusters.push_back(
          {int(sr / cnt), int(sc / cnt), int(ss / cnt), sq});
  }
  return clusters;
}

// ---------------------------------------------------------------------------
// Pupil / landmark regression walks (core/puploc.go:106-284, flploc.go:36-56)
// ---------------------------------------------------------------------------

// Go math.Round semantics: round half away from zero.
int64_t round_away(double x) {
  return int64_t(x >= 0 ? std::floor(x + 0.5) : std::ceil(x - 0.5));
}

// Upright regression walk. Per stage: sum (dr, dc) over all trees (bintest
// polarity p1 > p2 -> right here), then r += dr*s, c += dc*s, s *= mult, all
// in f32. flipV negates column codes and dc (mirror trick for right-side
// landmarks). Per-axis clamps: rows by nrows-1, cols by ncols-1.
void pupil_walk(const PupilForest& f, float* r, float* c, float* s, int nrows,
                int ncols, const uint8_t* pix, int dim, bool flip_v) {
  const int L = f.leaves;
  const int col_sign = flip_v ? -1 : 1;
  for (int i = 0; i < f.stages; ++i) {
    int64_t ri = 256 * int64_t(*r);  // float->int truncation toward zero
    int64_t ci = 256 * int64_t(*c);
    int64_t si = round_away(double(*s));
    float dr = 0.f, dc = 0.f;
    for (int j = 0; j < f.trees; ++j) {
      const size_t base = (size_t(i) * f.trees + j) * L;
      const int8_t* codes = &f.codes[base * 4];
      int64_t idx = 0;
      for (int d = 0; d < f.depth; ++d) {
        const int8_t* n = codes + 4 * idx;
        int64_t r1 = std::min<int64_t>(
            nrows - 1, std::max<int64_t>(0, (ri + int64_t(n[0]) * si) >> 8));
        int64_t c1 = std::min<int64_t>(
            ncols - 1,
            std::max<int64_t>(0, (ci + col_sign * int64_t(n[1]) * si) >> 8));
        int64_t r2 = std::min<int64_t>(
            nrows - 1, std::max<int64_t>(0, (ri + int64_t(n[2]) * si) >> 8));
        int64_t c2 = std::min<int64_t>(
            ncols - 1,
            std::max<int64_t>(0, (ci + col_sign * int64_t(n[3]) * si) >> 8));
        idx = 2 * idx + 1 + (pix[r1 * dim + c1] > pix[r2 * dim + c2] ? 1 : 0);
      }
      int64_t leaf = idx - (L - 1);
      dr += f.preds[(base + leaf) * 2 + 0];
      dc += float(col_sign) * f.preds[(base + leaf) * 2 + 1];
    }
    *r += dr * *s;
    *c += dc * *s;
    *s *= f.scale_mult;
  }
}

// Rotated regression walk. NOTE the bintest polarity here is px1 <= px2 ->
// right — the opposite of the upright pupil walk; this internal inconsistency
// exists in the reference (core/puploc.go:193-199) and is preserved.
void pupil_rotated_walk(const PupilForest& f, float* r, float* c, float* s,
                        double angle, int nrows, int ncols, const uint8_t* pix,
                        int dim, bool flip_v) {
  const int L = f.leaves;
  const int col_sign = flip_v ? -1 : 1;
  const int ti = int(32.0 * angle);
  for (int i = 0; i < f.stages; ++i) {
    int64_t qsin = int64_t(*s * float(kQSin[ti]));  // f32 product, truncated
    int64_t qcos = int64_t(*s * float(kQCos[ti]));
    int64_t ri = 65536 * int64_t(*r);
    int64_t ci = 65536 * int64_t(*c);
    float dr = 0.f, dc = 0.f;
    for (int j = 0; j < f.trees; ++j) {
      const size_t base = (size_t(i) * f.trees + j) * L;
      const int8_t* codes = &f.codes[base * 4];
      int64_t idx = 0;
      for (int d = 0; d < f.depth; ++d) {
        const int8_t* n = codes + 4 * idx;
        int64_t row1 = n[0], row2 = n[2];
        int64_t col1 = col_sign * int64_t(n[1]);
        int64_t col2 = col_sign * int64_t(n[3]);
        int64_t r1 = std::min<int64_t>(
            nrows - 1,
            std::max<int64_t>(0, ri + qcos * row1 - qsin * col1) >> 16);
        int64_t c1 = std::min<int64_t>(
            ncols - 1,
            std::max<int64_t>(0, ci + qsin * row1 + qcos * col1) >> 16);
        int64_t r2 = std::min<int64_t>(
            nrows - 1,
            std::max<int64_t>(0, ri + qcos * row2 - qsin * col2) >> 16);
        int64_t c2 = std::min<int64_t>(
            ncols - 1,
            std::max<int64_t>(0, ci + qsin * row2 + qcos * col2) >> 16);
        idx =
            2 * idx + 1 + (pix[r1 * dim + c1] <= pix[r2 * dim + c2] ? 1 : 0);
      }
      int64_t leaf = idx - (L - 1);
      dr += f.preds[(base + leaf) * 2 + 0];
      dc += float(col_sign) * f.preds[(base + leaf) * 2 + 1];
    }
    *r += dr * *s;
    *c += dc * *s;
    *s *= f.scale_mult;
  }
}

#if defined(__AVX512F__)
namespace simd {

// Pupil/landmark regression walk, 16 perturbations per pass. Unlike the
// face cascade there is no early exit — every perturbation runs all
// stages x trees x depth — so plain lanes hit full utilization with no
// compaction. The per-stage fixed-point state (float->int truncations,
// round-half-away, f32 qsin/qcos products) is prepared with the exact
// scalar helpers per lane, so every lane reproduces pupil_walk /
// pupil_rotated_walk bit-for-bit (reference core/puploc.go:106-217,
// including the <= polarity quirk on the rotated path).
template <bool kRot>
static void pupil_walk16(const PupilForest& f, float* rs, float* cs,
                         float* ss, int m, double angle, int nrows, int ncols,
                         const uint8_t* pix, int dim, bool flip_v) {
  const int L = f.leaves;
  const int ti = kRot ? int(32.0 * angle) : 0;
  const __mmask16 msk = __mmask16((1u << m) - 1);
  const PixWords pw(pix);
  const __m512i zero = _mm512_setzero_si512();
  const __m512i one = _mm512_set1_epi32(1);
  const __m512i dimv = _mm512_set1_epi32(dim);
  const __m512i rhi = _mm512_set1_epi32(nrows - 1);
  const __m512i chi = _mm512_set1_epi32(ncols - 1);
  const __m512i signv = _mm512_set1_epi32(flip_v ? -1 : 1);
  const __m512 signf = _mm512_set1_ps(flip_v ? -1.f : 1.f);
  const __m512 multv = _mm512_set1_ps(f.scale_mult);
  __m512 rv = _mm512_maskz_loadu_ps(msk, rs);
  __m512 cv = _mm512_maskz_loadu_ps(msk, cs);
  __m512 sv = _mm512_maskz_loadu_ps(msk, ss);
  alignas(64) float rbuf[16], cbuf[16], sbuf[16];
  alignas(64) int32_t ai[16], bi[16], di[16];  // per-stage fixed-point state
  for (int i = 0; i < f.stages; ++i) {
    _mm512_mask_storeu_ps(rbuf, msk, rv);
    _mm512_mask_storeu_ps(cbuf, msk, cv);
    _mm512_mask_storeu_ps(sbuf, msk, sv);
    for (int k = 0; k < m; ++k) {
      if (kRot) {
        ai[k] = 65536 * int32_t(rbuf[k]);
        bi[k] = 65536 * int32_t(cbuf[k]);
        di[k] = int32_t(int64_t(sbuf[k] * float(kQSin[ti])));  // qsin
      } else {
        ai[k] = 256 * int32_t(rbuf[k]);
        bi[k] = 256 * int32_t(cbuf[k]);
        di[k] = int32_t(round_away(double(sbuf[k])));
      }
    }
    __m512i riv = _mm512_maskz_loadu_epi32(msk, ai);
    __m512i civ = _mm512_maskz_loadu_epi32(msk, bi);
    __m512i siv = _mm512_maskz_loadu_epi32(msk, di);  // si, or qsin when kRot
    __m512i qcv = zero;
    if (kRot) {
      for (int k = 0; k < m; ++k)
        ai[k] = int32_t(int64_t(sbuf[k] * float(kQCos[ti])));
      qcv = _mm512_maskz_loadu_epi32(msk, ai);
    }
    __m512 drv = _mm512_setzero_ps(), dcv = _mm512_setzero_ps();
    for (int j = 0; j < f.trees; ++j) {
      const size_t base = (size_t(i) * f.trees + j) * L;
      const int8_t* codes = &f.codes[base * 4];
      const float* preds = &f.preds[base * 2];
      __m512i idx = zero;
      for (int d = 0; d < f.depth; ++d) {
        __m512i quads = _mm512_mask_i32gather_epi32(
            zero, msk, idx, reinterpret_cast<const int*>(codes), 4);
        __m512i n0 = sx8(quads, 0);
        __m512i n1 = _mm512_mullo_epi32(sx8(quads, 1), signv);
        __m512i n2 = sx8(quads, 2);
        __m512i n3 = _mm512_mullo_epi32(sx8(quads, 3), signv);
        __m512i r1, c1, r2, c2;
        if (kRot) {
          // max(0, .) BEFORE >>16; per-axis clamps (puploc.go:157-217)
          auto axis = [&](__m512i base_v, __m512i a, __m512i b, __m512i hiv) {
            __m512i v = _mm512_srai_epi32(
                _mm512_max_epi32(
                    zero, _mm512_add_epi32(base_v, _mm512_add_epi32(a, b))),
                16);
            return _mm512_min_epi32(hiv, v);
          };
          r1 = axis(riv, _mm512_mullo_epi32(qcv, n0),
                    _mm512_sub_epi32(zero, _mm512_mullo_epi32(siv, n1)), rhi);
          c1 = axis(civ, _mm512_mullo_epi32(siv, n0),
                    _mm512_mullo_epi32(qcv, n1), chi);
          r2 = axis(riv, _mm512_mullo_epi32(qcv, n2),
                    _mm512_sub_epi32(zero, _mm512_mullo_epi32(siv, n3)), rhi);
          c2 = axis(civ, _mm512_mullo_epi32(siv, n2),
                    _mm512_mullo_epi32(qcv, n3), chi);
        } else {
          // >>8 BEFORE max(0, .) (puploc.go:106-154)
          auto axis = [&](__m512i base_v, __m512i n, __m512i hiv) {
            __m512i v = _mm512_srai_epi32(
                _mm512_add_epi32(base_v, _mm512_mullo_epi32(n, siv)), 8);
            return _mm512_min_epi32(hiv, _mm512_max_epi32(zero, v));
          };
          r1 = axis(riv, n0, rhi);
          c1 = axis(civ, n1, chi);
          r2 = axis(riv, n2, rhi);
          c2 = axis(civ, n3, chi);
        }
        __m512i x1 = _mm512_add_epi32(_mm512_mullo_epi32(r1, dimv), c1);
        __m512i x2 = _mm512_add_epi32(_mm512_mullo_epi32(r2, dimv), c2);
        __m512i p1 = gather_px(msk, x1, pw);
        __m512i p2 = gather_px(msk, x2, pw);
        // polarity quirk: upright goes right on p1 > p2, rotated on p1 <= p2
        __mmask16 b = kRot ? _mm512_cmple_epu32_mask(p1, p2)
                           : _mm512_cmpgt_epu32_mask(p1, p2);
        idx = _mm512_add_epi32(_mm512_add_epi32(idx, idx), one);
        idx = _mm512_mask_add_epi32(idx, b, idx, one);
      }
      __m512i leaf2 = _mm512_add_epi32(
          _mm512_sub_epi32(idx, _mm512_set1_epi32(L - 1)),
          _mm512_sub_epi32(idx, _mm512_set1_epi32(L - 1)));
      __m512 pr = _mm512_mask_i32gather_ps(_mm512_setzero_ps(), msk, leaf2,
                                           preds, 4);
      __m512 pc = _mm512_mask_i32gather_ps(
          _mm512_setzero_ps(), msk, _mm512_add_epi32(leaf2, one), preds, 4);
      drv = _mm512_mask_add_ps(drv, msk, drv, pr);
      dcv = _mm512_mask_add_ps(dcv, msk, dcv, _mm512_mul_ps(signf, pc));
    }
    rv = _mm512_mask_add_ps(rv, msk, rv, _mm512_mul_ps(drv, sv));
    cv = _mm512_mask_add_ps(cv, msk, cv, _mm512_mul_ps(dcv, sv));
    sv = _mm512_mask_mul_ps(sv, msk, sv, multv);
  }
  _mm512_mask_storeu_ps(rs, msk, rv);
  _mm512_mask_storeu_ps(cs, msk, cv);
  _mm512_mask_storeu_ps(ss, msk, sv);
}

}  // namespace simd
#endif  // __AVX512F__

// Perturbation ensemble + per-axis median vote (core/puploc.go:239-277):
// run the walk from each jittered start, sort each axis, take element
// round(P/2) (clamped to P-1).
void run_detector(const PupilForest& f, const float* starts, int64_t p,
                  const uint8_t* pix, int nrows, int ncols, int dim,
                  double angle, bool flip_v, double* out3) {
  std::vector<float> rs(p), cs(p), ss(p);
  if (angle > 1.0) angle = 1.0;
  for (int64_t i = 0; i < p; ++i) {
    rs[i] = starts[3 * i];
    cs[i] = starts[3 * i + 1];
    ss[i] = starts[3 * i + 2];
  }
  bool done = false;
#if defined(__AVX512F__)
  if (use_simd(f.simd)) {
    // i32 headroom for the vector fixed point: bound the walk's scale
    // (it can only grow by scale_mult per stage when scale_mult > 1)
    double smax = 0;
    for (int64_t i = 0; i < p; ++i) smax = std::max(smax, std::fabs(double(ss[i])));
    if (f.scale_mult > 1.f)
      smax *= std::pow(double(f.scale_mult), f.stages);
    if (smax < 3e4 && int64_t(nrows) * 65536 < (int64_t(1) << 30) &&
        int64_t(ncols) * 65536 < (int64_t(1) << 30)) {
      for (int64_t i = 0; i < p; i += 16) {
        const int m = int(std::min<int64_t>(16, p - i));
        if (angle > 0.0)
          simd::pupil_walk16<true>(f, &rs[i], &cs[i], &ss[i], m, angle, nrows,
                                   ncols, pix, dim, flip_v);
        else
          simd::pupil_walk16<false>(f, &rs[i], &cs[i], &ss[i], m, angle,
                                    nrows, ncols, pix, dim, flip_v);
      }
      done = true;
    }
  }
#endif
  if (!done) {
    for (int64_t i = 0; i < p; ++i) {
      float r = rs[i], c = cs[i], s = ss[i];
      if (angle > 0.0)
        pupil_rotated_walk(f, &r, &c, &s, angle, nrows, ncols, pix, dim,
                           flip_v);
      else
        pupil_walk(f, &r, &c, &s, nrows, ncols, pix, dim, flip_v);
      rs[i] = r;
      cs[i] = c;
      ss[i] = s;
    }
  }
  std::sort(rs.begin(), rs.end());
  std::sort(cs.begin(), cs.end());
  std::sort(ss.begin(), ss.end());
  int64_t mid = std::min<int64_t>(round_away(double(p) / 2.0), p - 1);
  out3[0] = double(int64_t(rs[mid]));  // reference returns int row/col
  out3[1] = double(int64_t(cs[mid]));
  out3[2] = double(ss[mid]);
}

// splitmix64: deterministic counter-based PRNG for the perturbation jitter
// (replaces the reference's global math/rand, which is nondeterministic).
uint64_t splitmix64(uint64_t* state) {
  uint64_t z = (*state += 0x9E3779B97F4A7C15ull);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

float uniform01(uint64_t* state) {
  return float((splitmix64(state) >> 40) * (1.0 / 16777216.0));
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

// ---- face cascade ----------------------------------------------------------

// Parse a face cascade binary. Returns an opaque handle, or null (with a
// message in err) on malformed bytes.
void* pigo_face_new(const uint8_t* data, int64_t len, int simd, char* err,
                    int64_t err_cap) {
  auto* f = new FaceForest();
  f->simd = simd != 0;
  std::string msg;
  if (!parse_face(data, len, f, &msg)) {
    delete f;
    if (err != nullptr && err_cap > 0)
      std::snprintf(err, size_t(err_cap), "%s", msg.c_str());
    return nullptr;
  }
  return f;
}

void pigo_face_free(void* h) { delete static_cast<FaceForest*>(h); }

int pigo_face_depth(void* h) { return static_cast<FaceForest*>(h)->depth; }
int pigo_face_trees(void* h) { return static_cast<FaceForest*>(h)->num_trees; }

// Score one window (upright when angle <= 0, rotated otherwise).
float pigo_classify_region(void* h, int row, int col, int scale,
                           const uint8_t* pixels, int nrows, int dim,
                           double angle) {
  const auto& f = *static_cast<FaceForest*>(h);
  if (angle > 0.0)
    return classify_rotated_region(f, row, col, scale,
                                   angle > 1.0 ? 1.0 : angle, nrows, pixels,
                                   dim);
  return classify_region(f, row, col, scale, pixels, dim);
}

// Full multi-scale pass. Writes up to cap detections as (row, col, scale, q)
// doubles into out; returns the total number found (callers grow the buffer
// and retry when the return value exceeds cap).
int64_t pigo_face_run(void* h, const uint8_t* pixels, int rows, int cols,
                      int dim, int min_size, int max_size, double shift,
                      double scale_f, double angle, int threads, double* out,
                      int64_t cap) {
  const auto& f = *static_cast<FaceForest*>(h);
  auto dets =
      run_cascade(f, pixels, rows, cols, dim, min_size, max_size, shift,
                  scale_f, angle, threads);
  int64_t n = int64_t(dets.size());
  int64_t m = std::min(n, cap);
  for (int64_t i = 0; i < m; ++i) {
    out[4 * i + 0] = dets[i].row;
    out[4 * i + 1] = dets[i].col;
    out[4 * i + 2] = dets[i].scale;
    out[4 * i + 3] = dets[i].q;
  }
  return n;
}

// Scan an explicit list of pyramid scales (same loop bounds as
// pigo_face_run). Used by the face stage to route sparse tail scales to
// the host engine, overlapped with the card's computation.
int64_t pigo_face_run_scales(void* h, const uint8_t* pixels, int rows,
                             int cols, int dim, const int32_t* scales,
                             int64_t n_scales, double shift, double angle,
                             int threads, double* out, int64_t cap) {
  const auto& f = *static_cast<FaceForest*>(h);
  if (angle > 1.0) angle = 1.0;
  std::vector<Detection> dets;
  const int nthreads = pool_threads(threads);
  for (int64_t si = 0; si < n_scales; ++si) {
    int scale = scales[si];
    int step = std::max(int(shift * scale), 1);
    int offset = (scale >> 1) + 1;
    std::vector<int> row_vals;
    for (int r = offset; r <= rows - offset; r += step) row_vals.push_back(r);
    if (row_vals.empty()) continue;
    const int ncols_w = (cols - 2 * offset) / step + 1;
    if (ncols_w < 1) continue;
    std::vector<std::vector<Detection>> per_row(row_vals.size());
    std::atomic<size_t> next{0};
    auto work = [&]() {
      std::vector<float> qs(static_cast<size_t>(ncols_w));
      for (;;) {
        size_t i = next.fetch_add(1);
        if (i >= row_vals.size()) break;
        int r = row_vals[i];
        classify_row(f, pixels, rows, dim, r, offset, step, ncols_w, scale,
                     angle, qs.data());
        for (int k = 0; k < ncols_w; ++k)
          if (qs[k] > 0.f)
            per_row[i].push_back({r, offset + k * step, scale, qs[k]});
      }
    };
    int nt = std::min<int>(nthreads, int(row_vals.size()));
    if (nt <= 1) {
      work();
    } else {
      std::vector<std::thread> pool;
      pool.reserve(nt);
      for (int i = 0; i < nt; ++i) pool.emplace_back(work);
      for (auto& th : pool) th.join();
    }
    for (auto& local : per_row)
      dets.insert(dets.end(), local.begin(), local.end());
  }
  int64_t n = int64_t(dets.size());
  int64_t m = std::min(n, cap);
  for (int64_t i = 0; i < m; ++i) {
    out[4 * i + 0] = dets[i].row;
    out[4 * i + 1] = dets[i].col;
    out[4 * i + 2] = dets[i].scale;
    out[4 * i + 3] = dets[i].q;
  }
  return n;
}

// Exact scores for an explicit window list (int32 [n, 3] = row, col,
// scale).
void pigo_classify_batch(void* h, const uint8_t* pixels, int nrows, int dim,
                         const int32_t* windows, int64_t n, double angle,
                         float* out) {
  const auto& f = *static_cast<FaceForest*>(h);
  if (angle > 1.0) angle = 1.0;
  classify_list(f, pixels, nrows, dim, windows, n, angle, out);
}

// Border-band scan for the rotated dense plan: for each band row
// (scale, r_lo, r_hi, c_lo, c_hi), scan the scale's full reference grid
// EXCLUDING the inclusive interior rectangle [r_lo..r_hi]x[c_lo..c_hi] of
// window centers (those windows never hit the rotated clamps and run on
// the device). Same loop bounds as pigo_face_run (core/pigo.go:226-250).
int64_t pigo_face_run_band(void* h, const uint8_t* pixels, int rows,
                           int cols, int dim, const int32_t* bands,
                           int64_t n_bands, double shift, double angle,
                           double* out, int64_t cap) {
  const auto& f = *static_cast<FaceForest*>(h);
  if (angle > 1.0) angle = 1.0;
  std::vector<Detection> dets;
  for (int64_t bi = 0; bi < n_bands; ++bi) {
    const int32_t* b = bands + 5 * bi;
    int scale = b[0], r_lo = b[1], r_hi = b[2], c_lo = b[3], c_hi = b[4];
    int step = std::max(int(shift * scale), 1);
    int offset = (scale >> 1) + 1;
    const int ncols_w = (cols - 2 * offset) / step + 1;
    if (ncols_w < 1) continue;
    std::vector<float> qs(static_cast<size_t>(ncols_w));
    // The grid col of window k is offset + k*step; the device's interior
    // [c_lo..c_hi] is a contiguous k-range, so an excluded row splits into
    // a left segment [0, kx_lo) and a right segment [kx_hi+1, ncols_w).
    for (int r = offset; r <= rows - offset; r += step) {
      bool r_in = r >= r_lo && r <= r_hi;
      int kx_lo = ncols_w, kx_hi = -1;  // excluded k-range (empty by default)
      if (r_in) {
        kx_lo = c_lo <= offset ? 0
                               : std::min(ncols_w, (c_lo - offset + step - 1) / step);
        kx_hi = c_hi < offset ? -1 : std::min(ncols_w - 1, (c_hi - offset) / step);
      }
      auto seg = [&](int k0, int k1) {  // classify windows k in [k0, k1)
        if (k1 <= k0) return;
        classify_row(f, pixels, rows, dim, r, offset + k0 * step, step,
                     k1 - k0, scale, angle, qs.data());
        for (int k = 0; k < k1 - k0; ++k)
          if (qs[k] > 0.f)
            dets.push_back({r, offset + (k0 + k) * step, scale, qs[k]});
      };
      if (kx_hi < kx_lo) {
        seg(0, ncols_w);
      } else {
        seg(0, kx_lo);
        seg(kx_hi + 1, ncols_w);
      }
    }
  }
  int64_t n = int64_t(dets.size());
  int64_t m = std::min(n, cap);
  for (int64_t i = 0; i < m; ++i) {
    out[4 * i + 0] = dets[i].row;
    out[4 * i + 1] = dets[i].col;
    out[4 * i + 2] = dets[i].scale;
    out[4 * i + 3] = dets[i].q;
  }
  return n;
}

// IoU clustering over (row, col, scale, q) rows. Returns cluster count,
// writing up to cap clusters into out.
int64_t pigo_cluster(const double* dets, int64_t n, double iou_threshold,
                     double* out, int64_t cap) {
  std::vector<Detection> d(n);
  for (int64_t i = 0; i < n; ++i)
    d[size_t(i)] = {int(dets[4 * i]), int(dets[4 * i + 1]),
                    int(dets[4 * i + 2]), float(dets[4 * i + 3])};
  auto clusters = cluster_detections(std::move(d), iou_threshold);
  int64_t m = std::min<int64_t>(int64_t(clusters.size()), cap);
  for (int64_t i = 0; i < m; ++i) {
    out[4 * i + 0] = clusters[i].row;
    out[4 * i + 1] = clusters[i].col;
    out[4 * i + 2] = clusters[i].scale;
    out[4 * i + 3] = clusters[i].q;
  }
  return int64_t(clusters.size());
}

// One-call detect pipeline with the cgo-bridge result shape
// (reference examples/facedet/pigo.go:23-98): out[0] = count N, then N rows
// of (row, col, scale) int64. q-filtered at q_thresh after clustering.
int64_t pigo_find_faces(void* h, const uint8_t* pixels, int rows, int cols,
                        int min_size, int max_size, double shift,
                        double scale_f, double angle, double iou_threshold,
                        double q_thresh, int threads, int64_t* out,
                        int64_t cap) {
  const auto& f = *static_cast<FaceForest*>(h);
  auto dets = run_cascade(f, pixels, rows, cols, cols, min_size, max_size,
                          shift, scale_f, angle, threads);
  auto clusters = cluster_detections(std::move(dets), iou_threshold);
  int64_t n = 0;
  for (const auto& cl : clusters) {
    if (cl.q <= q_thresh) continue;
    if (1 + 3 * (n + 1) <= cap) {
      out[1 + 3 * n + 0] = cl.row;
      out[1 + 3 * n + 1] = cl.col;
      out[1 + 3 * n + 2] = cl.scale;
    }
    ++n;
  }
  out[0] = n;
  return n;
}

// ---- pupil / landmark cascades ---------------------------------------------

void* pigo_pupil_new(const uint8_t* data, int64_t len, int simd, char* err,
                     int64_t err_cap) {
  auto* f = new PupilForest();
  f->simd = simd != 0;
  std::string msg;
  if (!parse_pupil(data, len, f, &msg)) {
    delete f;
    if (err != nullptr && err_cap > 0)
      std::snprintf(err, size_t(err_cap), "%s", msg.c_str());
    return nullptr;
  }
  return f;
}

void pigo_pupil_free(void* h) { delete static_cast<PupilForest*>(h); }

int pigo_pupil_stages(void* h) { return static_cast<PupilForest*>(h)->stages; }

// Deterministic jitter triples for the perturbation ensemble
// (formula: core/puploc.go:248-250; RNG: splitmix64(seed), not math/rand).
void pigo_pupil_jitter(double row, double col, double scale, int perturbs,
                       uint64_t seed, float* starts_out) {
  uint64_t st = seed;
  for (int i = 0; i < perturbs; ++i) {
    float u1 = uniform01(&st), u2 = uniform01(&st), u3 = uniform01(&st);
    starts_out[3 * i + 0] =
        float(row) + float(scale) * 0.15f * (0.5f - u1);
    starts_out[3 * i + 1] =
        float(col) + float(scale) * 0.15f * (0.5f - u2);
    starts_out[3 * i + 2] = float(scale) * (0.925f + 0.15f * u3);
  }
}

// Ensemble walk + median vote from explicit start triples [p, 3].
// out3 = (row, col, scale).
void pigo_pupil_run(void* h, const float* starts, int64_t p,
                    const uint8_t* pixels, int nrows, int ncols, int dim,
                    double angle, int flip_v, double* out3) {
  const auto& f = *static_cast<PupilForest*>(h);
  run_detector(f, starts, p, pixels, nrows, ncols, dim, angle, flip_v != 0,
               out3);
}

// Landmark anchor geometry from the two pupils + delegate to the ensemble
// (reference core/flploc.go:36-56): dist = ||eyeL - eyeR||,
// row = avg_row + 0.25*dist, col = avg_col + 0.15*dist, scale = 3*dist.
void pigo_landmark_run(void* h, double left_row, double left_col,
                       double right_row, double right_col, int perturbs,
                       uint64_t seed, const uint8_t* pixels, int nrows,
                       int ncols, int dim, double angle, int flip_v,
                       double* out3) {
  double drow = left_row - right_row;
  double dcol = left_col - right_col;
  double dist = std::sqrt(drow * drow + dcol * dcol);
  double row = (left_row + right_row) / 2.0 + 0.25 * dist;
  double col = (left_col + right_col) / 2.0 + 0.15 * dist;
  double scale = 3.0 * dist;
  std::vector<float> starts(size_t(perturbs) * 3);
  pigo_pupil_jitter(row, col, scale, perturbs, seed, starts.data());
  pigo_pupil_run(h, starts.data(), perturbs, pixels, nrows, ncols, dim, angle,
                 flip_v, out3);
}

// ---- image ops --------------------------------------------------------------

// Exact reference grayscale (core/grayscale.go:8-23): channels are widened to
// 16 bits (v*257; alpha-premultiplied for transparent pixels), then
// (0.299R + 0.587G + 0.114B)/256 truncated to uint8.
void pigo_grayscale(const uint8_t* img, int64_t npix, int channels,
                    uint8_t* out) {
  if (channels < 3) {
    // 1-channel (grayscale) and 2-channel (gray+alpha) inputs: the single
    // luma channel passes through (alpha-premultiplied like NRGBA.RGBA()
    // with r=g=b). Reading p[1]/p[2] here would run past the buffer.
    for (int64_t i = 0; i < npix; ++i) {
      const uint8_t* p = img + i * channels;
      int64_t v = int64_t(p[0]) * 257;
      if (channels == 2 && p[1] != 255) v = v * p[1] / 255;
      out[i] = uint8_t(double(v) / 256.0);
    }
    return;
  }
  for (int64_t i = 0; i < npix; ++i) {
    const uint8_t* p = img + i * channels;
    int64_t r = int64_t(p[0]) * 257;
    int64_t g = int64_t(p[1]) * 257;
    int64_t b = int64_t(p[2]) * 257;
    if (channels == 4 && p[3] != 255) {
      int64_t a = p[3];
      r = r * a / 255;
      g = g * a / 255;
      b = b * a / 255;
    }
    double lum = (0.299 * double(r) + 0.587 * double(g) + 0.114 * double(b)) /
                 256.0;
    out[i] = uint8_t(lum);
  }
}

// 1 when the AVX-512 paths can run on this CPU (a handle parsed with
// simd=1 then takes them), else 0.
int pigo_simd_available() { return cpu_has_simd() ? 1 : 0; }

const char* pigo_version() { return "pigo-tpu-torch-native 0.1.0"; }

}  // extern "C"
