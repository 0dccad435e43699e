// On-card IoU union clustering for Hopper (sm_90a): one cooperative launch
// per call, its phases spread over the card.
//
// Replaces no TPU kernel: the JAX package clusters on the device with
// pigo_tpu/ops/cluster_device.py::cluster_device, a jnp fori_loop over the
// whole capacity (an f32 IoU test and an XLA-ordered q sum, both only
// within tolerance of the host). This kernel gives the host clustering's
// answer bit for bit (pigo_tpu_torch/ops/cluster.py, reference
// core/pigo.go:262-308):
//   - entries: the first n = min(count, capacity) rows of dets with valid
//     set, where count is read on the card, so the work follows the count
//     and not the capacity;
//   - order: ascending q, stable (ties keep their input order): the rank
//     of entry i is #{valid j: q_j < q_i} + #{valid j < i: q_j == q_i};
//   - each unassigned seed i, in that order, unions every valid entry j
//     with IoU(i, j) > threshold, assigned or not; the IoU is the host's,
//     in f64, every operation rounded on its own (--fmad=false and the
//     __d*_rn intrinsics; see row_word);
//   - the cluster of seed i goes to slot i (its position in that order):
//     the integer means (sum // n, over the coordinates truncated to
//     integers) of (row, col, scale) and the f32 sum of the members' q,
//     added one by one in sorted order. Every other slot is zero with its
//     valid flag clear. A seed that does not join itself (a scale of 0, or
//     a threshold of 1 or more) still marks its row, and makes a cluster
//     only where that row is not empty, as the host's nn > 0.
//
// Two facts make most of the work parallel. A seed's members do not
// depend on the chain (it unions every j over the threshold, assigned or
// not), so the membership matrix M[i][j] = joins(sorted i, sorted j) can be
// computed all at once; only the choice of seeds is a chain. And joins is
// symmetric bit for bit, so one test fills M[i][j] and M[j][i].
//
// Phases (kClusterThreads threads a block, at most one block per SM; the
// grid covers the largest matrix the capacity allows):
//   0. every block zeroes its share of the slots [n, capacity), stages the
//      n keys (q, NaN where not valid) in shared memory and counts the
//      valid ones (nv); a warp per entry counts its rank over the keys and
//      writes its table row (the entry, an int32 member record, the f64
//      edges) at that rank.
//   -- grid barrier (cooperative launch)
//   1. M as 32-bit words, rows padded to 4 words: a tile of 32 x 32 on or
//      above the diagonal per four warps of a block, each warp a quarter of
//      the columns, each lane a row; the transposed words by ballots.
//   -- grid barrier; block 0 goes on alone
//   2. M comes into shared memory whole where it fits (else band by band,
//      cp.async, kClusterStages - 1 bands ahead of the chain); one warp
//      runs the chain word by word: in a round, every candidate that no
//      lower candidate joins is a seed (a ballot), the seeds strike the
//      positions they join (a warp OR reduction), and at the end their
//      rows are ORed into the later words' assigned masks; the seeds go to
//      a list in order. Then a thread per seed walks its row's members in
//      sorted order and writes its cluster, and a thread per other slot
//      zeroes it.
// At n <= kClusterSoloEntries, block 0 runs the three phases alone in
// shared memory with block barriers, and the other blocks only zero their
// share of the slots: the grid barriers cost more than such a matrix.
//
// What bounds it: neither bytes nor operations. It reads at most
// capacity x 17 B and writes capacity x 17 B (under 0.05 us at 3.35 TB/s
// for 4096 slots), and the chain needs seeds x entries f64 IoU tests
// (1080p: 21 seeds x 312 hits); this design runs all nv^2 / 2 of them,
// spread over the card. The time is latency: the launch and, past the solo
// counts, two grid barriers; the L2 round trips from phase to phase; the
// chain, serial over words, at a few rounds of a ballot and a reduction
// each and no block barrier, division or member walk; and the longest
// member walk, serial over one cluster's members because the q sum must
// keep the host's order (a tree reduction would reorder the f32 sum). At
// thousands of entries, the band loads and the chain's words set the pace.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kClusterThreads = 512;
constexpr int kClusterWarps = kClusterThreads / 32;
// Bands of the seed chain in flight (one being scanned, the rest loading).
constexpr int kClusterStages = 4;
// Counts up to which block 0 clusters alone, in shared memory.
constexpr int kClusterSoloEntries = 128;
// Words a row can hold: ops/cluster_device.py MAX_CAPACITY / 32.
constexpr int kClusterMaxWords = 256;
constexpr int kClusterMaxChunks = kClusterMaxWords / 32;
// A block's dynamic shared memory: the H100's 232448 bytes less room for
// the static arrays (membership's).
constexpr long long kSharedLimit = 232448 - 8192;

constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr long long round_up(long long x, long long m) {
  return (x + m - 1) / m * m;
}

__host__ __device__ constexpr long long max2(long long a, long long b) {
  return a > b ? a : b;
}

// Row words padded to 4, so that every row starts on 16 bytes.
__host__ __device__ constexpr int padded_words(int entries) {
  return static_cast<int>(round_up((entries + 31) / 32, 4));
}

// A band's row stride in shared memory: 4 mod 8 words, so that the 32
// lanes' reads of one column of a band fall in 8 banks, not one.
__host__ __device__ constexpr int band_stride(int wp) { return wp | 4; }

// Per sorted entry: the entry (row, col, scale, q); its member record,
// the coordinates truncated to integers and q, where every coordinate is
// below kNarrow in magnitude (so that the sums of up to MAX_CAPACITY of
// them fit in int32), else kWide in the row; and its exact f64 edges
// r -+ s/2, c -+ s/2 and s^2 (s / 2 is exact as s * 0.5).
constexpr long long kEntryBytes = 16 + 16 + 5 * 8;
constexpr float kNarrow = 262144.f;  // 2^31 / (kClusterMaxWords * 32)
constexpr int kWide = -2147483647 - 1;

// The scratch buffer (global memory, from the wrapper): the sorted
// entries' table at its start, then M (from matrix_offset on; 32-row
// blocks of padded_words(capacity) words a row at most).
__host__ __device__ constexpr long long matrix_offset(int capacity) {
  return round_up(kEntryBytes * capacity, 256);
}

__host__ __device__ constexpr long long scratch_bytes(int capacity) {
  return matrix_offset(capacity) +
         round_up(capacity, 32) * padded_words(capacity) * 4;
}

// Shared memory. Two masks of padded_words(capacity) words (assigned,
// seeds) and the list of seeds (an int per slot), then one region that
// holds in turn:
//   solo:  the loaded rows, the keys, the table and M of at most
//          kClusterSoloEntries entries;
//   grid:  the keys (phase 0), then the band ring, or all of M where it
//          fits there, and the member records (phase 2), side by side
//          where both fit, else the records after the chain.
constexpr long long kSoloBytes =
    kClusterSoloEntries *
    (16LL + 4 + kEntryBytes + 4 * padded_words(kClusterSoloEntries));

__host__ __device__ constexpr long long ring_bytes(int capacity) {
  return 4LL * kClusterStages * 32 * band_stride(padded_words(capacity));
}

__host__ __device__ constexpr long long chain_bytes(int capacity) {
  return 8LL * padded_words(capacity) + round_up(4LL * capacity, 16);
}

__host__ __device__ constexpr bool members_beside_ring(int capacity) {
  return chain_bytes(capacity) + ring_bytes(capacity) + 16LL * capacity <=
         kSharedLimit;
}

__host__ __device__ constexpr long long shared_bytes(int capacity) {
  const long long chain =
      members_beside_ring(capacity)
          ? ring_bytes(capacity) + 16LL * capacity
          : max2(ring_bytes(capacity), 16LL * capacity);
  return chain_bytes(capacity) +
         max2(max2(kSoloBytes, 4LL * capacity), chain);
}

// The most any capacity asks for (shared_bytes is not monotone in it).
__host__ __device__ constexpr long long most_shared_bytes() {
  long long most = 0;
  for (int c = 1; c <= kClusterMaxWords * 32; ++c)
    most = max2(most, shared_bytes(c));
  return most;
}

static_assert(most_shared_bytes() <= kSharedLimit,
              "a capacity's shared memory exceeds a block's");
static_assert(kClusterSoloEntries <= kClusterThreads,
              "the solo path gives each entry a thread");

// The sorted entries, one array per field (kEntryBytes each).
struct Table {
  float4* entry;
  int4* member;   // trunc(r), trunc(c), trunc(s), bits of q; or kWide
  double* lor;    // r - s/2
  double* hir;    // r + s/2
  double* loc;    // c - s/2
  double* hic;    // c + s/2
  double* ss;     // s * s
};

__device__ __forceinline__ Table table_at(uint8_t* base, int n) {
  float4* f = reinterpret_cast<float4*>(base);
  double* d = reinterpret_cast<double*>(f + 2 * n);
  return Table{f, reinterpret_cast<int4*>(f + n), d, d + n, d + 2 * n,
               d + 3 * n, d + 4 * n};
}

__device__ __forceinline__ Table offset(const Table& t, int k) {
  return Table{t.entry + k, t.member + k, t.lor + k, t.hir + k,
               t.loc + k, t.hic + k, t.ss + k};
}

__device__ __forceinline__ void put_entry(const Table& t, int k, float4 d) {
  const double r = d.x, c = d.y, s = d.z;
  const double h = __dmul_rn(s, 0.5);
  const double lor = __dsub_rn(r, h), hir = __dadd_rn(r, h);
  const double loc = __dsub_rn(c, h), hic = __dadd_rn(c, h);
  t.entry[k] = d;
  t.member[k] = fabsf(d.x) < kNarrow && fabsf(d.y) < kNarrow &&
                        fabsf(d.z) < kNarrow
                    ? make_int4(static_cast<int>(d.x), static_cast<int>(d.y),
                                static_cast<int>(d.z), __float_as_int(d.w))
                    : make_int4(kWide, 0, 0, __float_as_int(d.w));
  t.lor[k] = lor;
  t.hir[k] = hir;
  t.loc[k] = loc;
  t.hic[k] = hic;
  t.ss[k] = __dmul_rn(s, s);
}

// One entry's box, in registers.
struct Box {
  double lor, hir, loc, hic, ss;
};

__device__ __forceinline__ Box box_at(const Table& t, int k) {
  return Box{t.lor[k], t.hir[k], t.loc[k], t.hic[k], t.ss[k]};
}

// The host's IoU test, ops/cluster.py::iou_matrix(...)[a, b] > thr,
// operation by operation in f64: inter = over_r * over_c with
// over = max(0, min(hi) - max(lo)), uni = (s_a^2 + s_b^2) - inter,
// iou = inter / uni. It is symmetric in a and b bit for bit (IEEE add,
// multiply, fmin and fmax commute).
//   - where the boxes do not overlap, inter is 0 and iou is 0 / uni: over
//     thr exactly when thr < 0 and uni > 0 (0 / 0 is NaN);
//   - where they do (inter > 0, so uni >= inter > 0), RN(inter / uni) >
//     thr is false where thr * uni > inter (the quotient is below thr,
//     and RN is monotone) and true where up * uni < inter (up: the double
//     after thr); __fma_rn rounds each product less inter once, which
//     keeps its sign. Only a quotient between thr and up, or a product
//     that rounds to 0, is left to the division.
__device__ __forceinline__ double overlap(double lo_a, double hi_a,
                                          double lo_b, double hi_b) {
  return __dsub_rn(fmin(hi_a, hi_b), fmax(lo_a, lo_b));
}

__device__ __noinline__ bool iou_over(const Box& a, const Box& b,
                                      double thr) {
  const double inter = __dmul_rn(overlap(a.lor, a.hir, b.lor, b.hir),
                                 overlap(a.loc, a.hic, b.loc, b.hic));
  const double uni = __dsub_rn(__dadd_rn(a.ss, b.ss), inter);
  return __ddiv_rn(inter, uni) > thr;
}

// The word of box a against the first `cols` (<= 32) boxes of `col`: bit
// c is the IoU test of a and col[c]. Every test runs in full and without
// branches, four at a time; the rare undecided ones divide after.
__device__ __forceinline__ uint32_t row_word(const Box& a, const Table& col,
                                             int cols, double thr,
                                             double up) {
  uint32_t word = 0, undecided = 0;
  const bool neg = thr < 0.0;
#pragma unroll 4
  for (int c = 0; c < cols; ++c) {
    const Box b = box_at(col, c);
    const double over_r = overlap(a.lor, a.hir, b.lor, b.hir);
    const double over_c = overlap(a.loc, a.hic, b.loc, b.hic);
    const double sum = __dadd_rn(a.ss, b.ss);
    const double inter = __dmul_rn(over_r, over_c);
    const double uni = __dsub_rn(sum, inter);
    const bool both = over_r > 0.0 && over_c > 0.0;
    const bool below = __fma_rn(thr, uni, -inter) > 0.0;
    const bool above = __fma_rn(up, uni, -inter) < 0.0;
    word |= static_cast<uint32_t>(both ? above : neg && sum > 0.0) << c;
    undecided |= static_cast<uint32_t>(both && !below && !above) << c;
  }
  for (uint32_t bits = undecided; bits; bits &= bits - 1u) {
    const int c = __ffs(bits) - 1;
    word |= static_cast<uint32_t>(iou_over(a, box_at(col, c), thr)) << c;
  }
  return word;
}

// The seeds among a word's candidates `cand`, given each lane's own word
// of that column (`own`: lane l holds the word of sorted row 32w + l). A
// candidate that no lower candidate joins is a seed (joins is symmetric,
// so the lower candidates that join lane l are bits of its own word); the
// lowest candidate always is one. Each round takes all such seeds and
// strikes the positions they join (a ballot and a warp OR reduction).
__device__ __forceinline__ uint32_t resolve_word(uint32_t cand,
                                                 uint32_t own) {
  const int lane = threadIdx.x & 31;
  const uint32_t below = (1u << lane) - 1u;
  uint32_t found = 0;
  while (cand) {
    const bool seed = ((cand >> lane) & 1u) && !(own & cand & below);
    const uint32_t now = __ballot_sync(kFull, seed);
    const uint32_t hit = __reduce_or_sync(kFull, seed ? own : 0u);
    found |= now;
    cand &= ~(now | hit);
  }
  return found;
}

// ORs the rows of the seeds `found` of word w (row p at band + p * stride,
// shared memory, words at their own column) into the assigned masks of
// words w + 1 .. w_rows - 1.
__device__ __forceinline__ void propagate(const uint32_t* band, int stride,
                                          uint32_t found, int w, int w_rows,
                                          uint32_t* assigned) {
  const int lane = threadIdx.x & 31;
  uint32_t acc[kClusterMaxChunks];
#pragma unroll
  for (int c = 0; c < kClusterMaxChunks; ++c) acc[c] = 0;
  for (uint32_t s = found; s; s &= s - 1u) {
    const uint32_t* row = band + (__ffs(s) - 1) * stride;
#pragma unroll
    for (int c = 0; c < kClusterMaxChunks; ++c) {
      const int k = w + 1 + lane + 32 * c;
      if (k < w_rows) acc[c] |= row[k];
    }
  }
#pragma unroll
  for (int c = 0; c < kClusterMaxChunks; ++c) {
    const int k = w + 1 + lane + 32 * c;
    if (k < w_rows) assigned[k] |= acc[c];
  }
}

// The chain's state in shared memory: the assigned and seed masks and the
// seeds in order.
struct Chain {
  uint32_t* assigned;
  uint32_t* seeds;
  int* list;
  int* count;
};

// Records word w's seeds `found` (one warp): their bits, and their
// positions after the `total` seeds before them.
__device__ __forceinline__ void record(const Chain& ch, uint32_t found,
                                       int w, int& total) {
  const int lane = threadIdx.x & 31;
  if ((found >> lane) & 1u)
    ch.list[total + __popc(found & ((1u << lane) - 1u))] = 32 * w + lane;
  if (lane == 0) ch.seeds[w] = found;
  total += __popc(found);
}

// One word of the chain (one warp): `band` holds the rows 32w.. at stride
// `stride` in shared memory, each word at its own column.
__device__ __forceinline__ void chain_word(const uint32_t* band, int stride,
                                           int w, int nv, const Chain& ch,
                                           int& total) {
  const int lane = threadIdx.x & 31;
  const int rows = min(32, nv - 32 * w);
  const uint32_t cand =
      ~ch.assigned[w] & (rows == 32 ? kFull : (1u << rows) - 1u);
  const uint32_t own = lane < rows ? band[lane * stride + w] : 0u;
  const uint32_t found = resolve_word(cand, own);
  propagate(band, stride, found, w, (nv + 31) / 32, ch.assigned);
  record(ch, found, w, total);
  __syncwarp();
}

// The chain word by word over M in shared memory (row stride `stride`),
// one warp. `assigned` starts at zero.
__device__ void chain_shared(const uint32_t* m, int stride, int nv,
                             const Chain& ch) {
  int total = 0;
  for (int w = 0; w < (nv + 31) / 32; ++w)
    chain_word(m + 32 * w * stride, stride, w, nv, ch, total);
  if ((threadIdx.x & 31) == 0) *ch.count = total;
}

// The host's integer mean, sum // n (a floor, as Python's), as f32; in
// int32 where the sum fits (an int64 division is a long sequence).
__device__ __forceinline__ float floor_div(long long sum, int n) {
  if (sum >= -0x7fffffffLL && sum <= 0x7fffffffLL) {
    const int s = static_cast<int>(sum);
    const int m = s / n;
    return static_cast<float>(m - (m * n != s && s < 0));
  }
  const long long m = sum / n;
  return static_cast<float>(m - (m * n != sum && sum < 0));
}

struct Args {
  const float* dets;
  const uint8_t* valid;
  const int* count;
  int capacity;
  double thr;
  float* out;
  uint8_t* out_valid;
  uint8_t* scratch;
};

// A seed's sums: q one member at a time with __fadd_rn in sorted order,
// as the host, and the truncated coordinates in int32 from the member
// records. A kWide record only marks the cluster, whose coordinates are
// then summed again in int64 from the exact entries.
struct Sums {
  unsigned r, c, s;  // two's complement: narrow sums fit in int32
  float q;
  bool wide;
};

__device__ __forceinline__ void add_member(Sums& t, int4 e) {
  t.q = __fadd_rn(t.q, __int_as_float(e.w));
  t.r += static_cast<unsigned>(e.x);
  t.c += static_cast<unsigned>(e.y);
  t.s += static_cast<unsigned>(e.z);
  t.wide |= e.x == kWide;
}

// The members of one row word (sorted positions at + bit), two at a time.
__device__ __forceinline__ void add_word(Sums& t, uint32_t bits, int at,
                                         const int4* members) {
  while (bits) {
    const int j0 = at + __ffs(bits) - 1;
    bits &= bits - 1u;
    if (!bits) {
      add_member(t, members[j0]);
      break;
    }
    const int j1 = at + __ffs(bits) - 1;
    bits &= bits - 1u;
    const int4 e0 = members[j0];
    const int4 e1 = members[j1];
    add_member(t, e0);
    add_member(t, e1);
  }
}

template <bool kL2>
__device__ __forceinline__ uint32_t row_at(const uint32_t* row, int w) {
  return kL2 ? __ldcg(row + w) : row[w];
}

// The cluster of the seed whose row (w_rows words, 16-byte aligned) is
// `row`, one thread. kL2: the row is in global memory, read from L2
// sixteen words at a time; else it is in shared memory. `members` holds
// the sorted entries' member records (shared memory), `exact` the
// entries. Returns false for an empty row.
template <bool kL2>
__device__ bool cluster_of(const uint32_t* row, int w_rows,
                           const int4* members, const float4* exact,
                           float4& cluster) {
  Sums t{0, 0, 0, 0.f, false};
  int count = 0;
  if (kL2) {
    for (int base = 0; base < w_rows; base += 16) {
      uint4 words[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        words[v] = base + 4 * v < w_rows
                       ? __ldcg(reinterpret_cast<const uint4*>(row + base) + v)
                       : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const uint32_t ws[4] = {words[v].x, words[v].y, words[v].z,
                                words[v].w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int w = base + 4 * v + u;
          // the padding words past w_rows are never written
          const uint32_t bits = w < w_rows ? ws[u] : 0u;
          count += __popc(bits);
          add_word(t, bits, 32 * w, members);
        }
      }
    }
  } else {
    for (int w = 0; w < w_rows; ++w) {
      const uint32_t bits = row[w];
      count += __popc(bits);
      add_word(t, bits, 32 * w, members);
    }
  }
  if (count == 0) return false;
  long long sr = static_cast<int>(t.r), sc = static_cast<int>(t.c),
            ss = static_cast<int>(t.s);
  if (t.wide) {
    sr = sc = ss = 0;
    for (int w = 0; w < w_rows; ++w) {
      for (uint32_t bits = row_at<kL2>(row, w); bits; bits &= bits - 1u) {
        const float4 d = exact[32 * w + __ffs(bits) - 1];
        sr += static_cast<long long>(d.x);
        sc += static_cast<long long>(d.y);
        ss += static_cast<long long>(d.z);
      }
    }
  }
  cluster = make_float4(floor_div(sr, count), floor_div(sc, count),
                        floor_div(ss, count), t.q);
  return true;
}

// The slots [0, n): a thread each zeroes those that hold no seed, and
// writes the cluster of a seed (rows of M at stride `stride`), the seeds
// in the chain's order. A seed with an empty row is zeroed.
template <bool kL2>
__device__ void write_slots(const Args& a, int n, int nv, const Chain& ch,
                            const uint32_t* m, int stride,
                            const int4* members, const float4* exact) {
  const int tid = threadIdx.x;
  const int w_rows = (nv + 31) / 32;
  float4* out = reinterpret_cast<float4*>(a.out);
  for (int k = tid; k < n; k += kClusterThreads) {
    if (k >= nv || !((ch.seeds[k >> 5] >> (k & 31)) & 1u)) {
      out[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      a.out_valid[k] = 0;
    }
  }
  const int seeds = *ch.count;
  for (int i = tid; i < seeds; i += kClusterThreads) {
    const int p = ch.list[i];
    float4 cluster = make_float4(0.f, 0.f, 0.f, 0.f);
    const bool made = cluster_of<kL2>(m + static_cast<long long>(p) * stride,
                                      w_rows, members, exact, cluster);
    out[p] = cluster;
    a.out_valid[p] = made;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

__device__ __forceinline__ float4 load_row(const float* dets, int i) {
  // dets need not be 16-byte aligned (a contiguous view may start anywhere)
  return make_float4(dets[4 * i], dets[4 * i + 1], dets[4 * i + 2],
                     dets[4 * i + 3]);
}

__device__ __forceinline__ float key_of(bool valid, float q) {
  return valid ? q : __int_as_float(0x7fffffff);  // NaN: never counted
}

// Phase 1: M, tile by tile on or above the diagonal (I <= J), for group
// `group` of `groups`. A group is four warps of one block; they take the
// four column quarters of a tile, and each lane tests its row (32I + lane)
// against the quarter's 8 columns. The quarters' bits meet in the group's
// shared word of each row, which quarter 0 stores. The transposed words
// (rows 32J + 8q + b, word I) are whole in one quarter: 8 ballots, and
// each quarter stores its own. stage: the columns come from global memory,
// through the warp's shared memory; else the table is in shared memory.
__device__ void membership(const Table& t, uint32_t* m, int stride, int nv,
                           double thr, double up, int group, int groups,
                           bool stage) {
  __shared__ uint32_t direct[kClusterWarps / 4][32];
  __shared__ double staged[kClusterWarps][5 * 8];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int quarter = warp & 3;
  const unsigned bar = 1 + (warp >> 2);  // 0 is __syncthreads'
  uint32_t* word = direct[warp >> 2];
  double* sd = staged[warp];
  const Table local{nullptr, nullptr, sd, sd + 8, sd + 16, sd + 24, sd + 32};
  if (quarter == 0) word[lane] = 0;
  const int w_rows = (nv + 31) / 32;
  const int tiles = w_rows * (w_rows + 1) / 2;
  for (int tile = group; tile < tiles; tile += groups) {
    int tj = static_cast<int>((sqrtf(8.f * tile + 1.f) - 1.f) * 0.5f);
    while (tj * (tj + 1) / 2 > tile) --tj;
    while ((tj + 1) * (tj + 2) / 2 <= tile) ++tj;
    const int ti = tile - tj * (tj + 1) / 2;
    const int row = 32 * ti + lane;
    const int c0 = 32 * tj + 8 * quarter;
    const int cols = min(8, nv - c0);  // none past nv
    const Box me = row < nv ? box_at(t, row) : Box{};
    Table col = offset(t, c0);
    if (stage) {
      __syncwarp();  // the previous tile's columns are read
      if (lane < cols) {
        sd[lane] = t.lor[c0 + lane];
        sd[8 + lane] = t.hir[c0 + lane];
        sd[16 + lane] = t.loc[c0 + lane];
        sd[24 + lane] = t.hic[c0 + lane];
        sd[32 + lane] = t.ss[c0 + lane];
      }
      __syncwarp();
      col = local;
    }
    const uint32_t piece = row < nv ? row_word(me, col, cols, thr, up) : 0u;
    // the group's words are zero: quarter 0 cleared them before
    asm volatile("bar.sync %0, 128;" ::"r"(bar) : "memory");
    if (piece) atomicOr(word + lane, piece << (8 * quarter));
    if (ti != tj) {
      uint32_t t_word = 0;
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const uint32_t v = __ballot_sync(kFull, (piece >> b) & 1u);
        if (lane == b) t_word = v;
      }
      if (lane < cols)
        m[static_cast<long long>(c0 + lane) * stride + ti] = t_word;
    }
    asm volatile("bar.sync %0, 128;" ::"r"(bar) : "memory");
    if (quarter == 0) {
      if (row < nv) m[static_cast<long long>(row) * stride + tj] = word[lane];
      word[lane] = 0;
    }
  }
}

// Block 0 alone, for n <= kClusterSoloEntries: every stage in shared
// memory, a thread per entry for the ranks.
__device__ void cluster_solo(const Args& a, int n, double up,
                             const Chain& ch, uint8_t* region) {
  constexpr int kN = kClusterSoloEntries;
  constexpr int kWp = padded_words(kN);
  const int tid = threadIdx.x;
  const Table t = table_at(region, kN);
  float4* rows = reinterpret_cast<float4*>(region + kEntryBytes * kN);
  float* key = reinterpret_cast<float*>(rows + kN);
  uint32_t* m = reinterpret_cast<uint32_t*>(key + kN);

  const bool mine = tid < n && a.valid[tid] != 0;
  if (tid < n) {
    rows[tid] = load_row(a.dets, tid);
    key[tid] = key_of(mine, rows[tid].w);
  }
  if (tid < kWp) ch.assigned[tid] = 0;
  const int nv = __syncthreads_count(mine);
  if (mine) {
    const float qi = key[tid];
    int rank = 0;
    for (int j = 0; j < n; ++j) rank += j < tid ? key[j] <= qi : key[j] < qi;
    put_entry(t, rank, rows[tid]);
  }
  __syncthreads();
  membership(t, m, kWp, nv, a.thr, up, tid >> 7, kClusterWarps / 4, false);
  __syncthreads();
  if (tid < 32) chain_shared(m, kWp, nv, ch);
  __syncthreads();
  write_slots<false>(a, n, nv, ch, m, kWp, t.member, t.entry);
}

// Phase 0 of the grid path, for warp `worker` of `workers`: the ranks of
// entries worker + k * workers (k < 32: the launch gives enough warps),
// counted over the staged keys; each entry goes to the table at its rank.
// The warp's entries are loaded before the keys are staged, so that the
// two loads overlap.
struct Mine {
  float4 row;
  bool valid;
};

__device__ __forceinline__ Mine load_mine(const Args& a, int n, int worker,
                                          int workers) {
  const int i = worker + (threadIdx.x & 31) * workers;
  Mine m{make_float4(0.f, 0.f, 0.f, 0.f), false};
  if (i < n) {
    m.valid = a.valid[i] != 0;
    if (m.valid) m.row = load_row(a.dets, i);
  }
  return m;
}

__device__ void rank_entries(const Table& t, const float* key, int n,
                             int worker, int workers, const Mine& mine) {
  const int lane = threadIdx.x & 31;
  const unsigned held = __ballot_sync(kFull, mine.valid);
  for (int k = 0; k < 32; ++k) {
    const int i = worker + k * workers;
    if (i >= n) break;
    if (!((held >> k) & 1u)) continue;
    const float qi = key[i];
    int below = 0;
    for (int j = lane; j < n; j += 32) {
      const float qj = key[j];
      below += j < i ? qj <= qi : qj < qi;
    }
    const int rank = __reduce_add_sync(kFull, below);
    if (lane == k) put_entry(t, rank, mine.row);
  }
}

// Phase 2a of the grid path where M does not fit in shared memory, one
// warp: the chain, with the rows of each word brought in through the band
// ring (band w: rows 32w.. below nv, words from w rounded down to 4 on, in
// 16-byte cp.async pieces, the lanes walking rows x pieces 32 at a time).
// The bands do not depend on the chain, so kClusterStages - 1 are in
// flight ahead of it. `assigned` starts at zero.
__device__ void chain_banded(const uint32_t* m, int nv, const Chain& ch,
                             uint32_t* ring) {
  const int lane = threadIdx.x & 31;
  const int w_rows = (nv + 31) / 32;
  const int wp = padded_words(nv);
  const int stride = band_stride(wp);
  auto issue = [&](int w) {
    if (w < w_rows) {
      const int w0 = w & ~3;
      const int pieces = (wp - w0) >> 2;
      const int rows = min(32, nv - 32 * w);
      uint32_t* band = ring + (w % kClusterStages) * 32 * stride;
      const uint32_t* src = m + static_cast<long long>(32 * w) * wp + w0;
      const int step_r = 32 / pieces, step_p = 32 % pieces;
      int r = lane / pieces, p = lane % pieces;
      while (r < rows) {
        cp_async16(band + r * stride + w0 + 4 * p, src + r * wp + 4 * p);
        r += step_r;
        p += step_p;
        if (p >= pieces) {
          p -= pieces;
          ++r;
        }
      }
    }
    cp_async_commit();  // an empty group past the last band keeps the count
  };
  for (int w = 0; w < kClusterStages - 1; ++w) issue(w);
  int total = 0;
  for (int w = 0; w < w_rows; ++w) {
    issue(w + kClusterStages - 1);
    cp_async_wait<kClusterStages - 1>();
    __syncwarp();  // every lane's part of band w has landed
    // (chain_word ends in __syncwarp: band w's slot may then be reloaded)
    chain_word(ring + (w % kClusterStages) * 32 * stride, stride, w, nv, ch,
               total);
  }
  cp_async_wait<0>();
  if (lane == 0) *ch.count = total;
}

__global__ void __launch_bounds__(kClusterThreads, 1)
cluster_kernel(Args a) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ int s_nv;
  __shared__ int s_seeds;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int n = min(max(*a.count, 0), a.capacity);
  const double up = nextafter(a.thr, __longlong_as_double(0x7ffLL << 52));

  // the slots past the count, over the grid
  float4* out = reinterpret_cast<float4*>(a.out);
  for (int k = n + blockIdx.x * kClusterThreads + tid; k < a.capacity;
       k += gridDim.x * kClusterThreads) {
    out[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    a.out_valid[k] = 0;
  }
  const int wp_cap = padded_words(a.capacity);
  const Chain ch{smem, smem + wp_cap,
                 reinterpret_cast<int*>(smem + 2 * wp_cap), &s_seeds};
  uint8_t* region =  // 16-byte aligned: wp_cap % 4 == 0
      reinterpret_cast<uint8_t*>(smem) + chain_bytes(a.capacity);
  if (n <= kClusterSoloEntries) {
    if (blockIdx.x == 0) cluster_solo(a, n, up, ch, region);
    return;
  }

  // phase 0: this warp's entries, the keys and the valid count, the ranks
  const Table table = table_at(a.scratch, a.capacity);
  uint32_t* m =
      reinterpret_cast<uint32_t*>(a.scratch + matrix_offset(a.capacity));
  const int worker = warp * gridDim.x + blockIdx.x;  // block-minor: a small
  const int workers = kClusterWarps * gridDim.x;     // count spreads out
  const Mine mine = load_mine(a, n, worker, workers);
  float* key = reinterpret_cast<float*>(region);
  if (tid == 0) s_nv = 0;
  __syncthreads();
  int valid_here = 0;
#pragma unroll 4
  for (int k = tid; k < n; k += kClusterThreads) {
    const bool v = a.valid[k] != 0;
    key[k] = key_of(v, a.dets[4 * k + 3]);
    valid_here += v;
  }
  valid_here = __reduce_add_sync(kFull, valid_here);
  if ((tid & 31) == 0 && valid_here) atomicAdd(&s_nv, valid_here);
  __syncthreads();
  const int nv = s_nv;
  const int wp = padded_words(nv);
  rank_entries(table, key, n, worker, workers, mine);
  cg::this_grid().sync();

  // phase 1: the membership matrix
  membership(table, m, wp, nv, a.thr, up,
             (warp >> 2) * gridDim.x + blockIdx.x,
             kClusterWarps / 4 * gridDim.x, true);
  cg::this_grid().sync();
  if (blockIdx.x != 0) return;

  // phase 2, block 0: all of M comes into shared memory where it fits in
  // the ring's place, the member records beside it where both fit; then
  // the chain (one warp), then the slots.
  const bool whole = static_cast<long long>(nv) * wp * 4 <=
                     ring_bytes(a.capacity);
  const bool beside = members_beside_ring(a.capacity);
  uint32_t* ring = reinterpret_cast<uint32_t*>(region);
  int4* members = reinterpret_cast<int4*>(
      region + (beside ? ring_bytes(a.capacity) : 0));
  for (int k = tid; k < wp; k += kClusterThreads) ch.assigned[k] = 0;
  if (whole) {
    for (int k = tid; k < nv * wp / 4; k += kClusterThreads)
      cp_async16(ring + 4 * k, m + 4 * k);
  }
  if (beside) {
    for (int k = tid; k < nv; k += kClusterThreads)
      cp_async16(members + k, table.member + k);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (warp == 0) {
    if (whole)
      chain_shared(ring, wp, nv, ch);
    else
      chain_banded(m, nv, ch, ring);
  }
  __syncthreads();
  if (!beside) {  // the members take the ring's place
    for (int k = tid; k < nv; k += kClusterThreads)
      members[k] = __ldcg(table.member + k);
    __syncthreads();
  }
  if (whole && beside)
    write_slots<false>(a, n, nv, ch, ring, wp, members, table.entry);
  else
    write_slots<true>(a, n, nv, ch, m, wp, members, table.entry);
}

// Set once per device: the dynamic shared memory a launch may ask for.
bool g_configured[64] = {};

}  // namespace

// Bytes of the scratch buffer a call at `capacity` slots needs.
extern "C" long long pigo_cluster_scratch_bytes(int capacity) {
  return scratch_bytes(capacity);
}

// dets f32 [capacity, 4] (row, col, scale, q), valid u8 [capacity], count
// int32 [1] on the card; out f32 [capacity, 4] (16-byte aligned),
// out_valid u8 [capacity], scratch pigo_cluster_scratch_bytes(capacity)
// bytes (256-byte aligned, contents ignored). Returns a cudaError_t.
extern "C" int pigo_cluster_device(const void* dets, const void* valid,
                                   const void* count, int capacity,
                                   double thr, void* out, void* out_valid,
                                   void* scratch, void* stream) {
  if (capacity < 1 || capacity > kClusterMaxWords * 32)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && (dev >= 64 || !g_configured[dev])) {
    err = cudaFuncSetAttribute(cluster_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(most_shared_bytes()));
    if (err == cudaSuccess && dev < 64) g_configured[dev] = true;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // four warps for every tile of the largest matrix the capacity allows,
  // and a warp for every 32 entries of phase 0; at most one block per SM
  const long long wc = (capacity + 31) / 32;
  const long long rank_blocks =
      (capacity + 32 * kClusterWarps - 1) / (32 * kClusterWarps);
  if (rank_blocks > sms) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long want = max2(wc * (wc + 1) / 2 / (kClusterWarps / 4) + 1,
                              rank_blocks);
  const int grid = static_cast<int>(want < sms ? want : sms);
  Args a{static_cast<const float*>(dets),
         static_cast<const uint8_t*>(valid),
         static_cast<const int*>(count),
         capacity,
         thr,
         static_cast<float*>(out),
         static_cast<uint8_t*>(out_valid),
         static_cast<uint8_t*>(scratch)};
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(cluster_kernel), dim3(grid),
      dim3(kClusterThreads), params,
      static_cast<size_t>(shared_bytes(capacity)),
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pigo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
