// On-card IoU union clustering for Hopper (sm_90a): one thread block per
// frame, one launch per call.
//
// Replaces no TPU kernel: the JAX package clusters on the device with
// pigo_tpu/ops/cluster_device.py::cluster_device, a jnp fori_loop over the
// whole capacity (an f32 IoU test and an XLA-ordered q sum, both only
// within tolerance of the host). This kernel gives the host clustering's
// answer bit for bit (pigo_tpu_torch/ops/cluster.py, reference
// core/pigo.go:262-308):
//   - entries: the first min(count, capacity) rows of dets with valid set,
//     where count is read on the card, so the work follows the count and
//     not the capacity;
//   - order: ascending q, stable (ties keep their input order), by a rank
//     sort in shared memory: rank(i) = #{valid j: q_j < q_i} +
//     #{valid j < i: q_j == q_i};
//   - each unassigned seed i, in that order, unions every valid entry j
//     with IoU(i, j) > threshold, assigned or not; the IoU is the host's,
//     in f64: inter / (s_i^2 + s_j^2 - inter) with half-widths s / 2 and
//     every operation rounded on its own (--fmad=false, and the
//     intrinsics below);
//   - the cluster of seed i goes to slot i (its position in that order):
//     the integer means (sum // n, over the coordinates truncated to
//     integers) of (row, col, scale) and the f32 sum of
//     the members' q, added one by one in sorted order. Every other slot is
//     zero with its valid flag clear.
//
// What bounds it: neither bytes nor operations. It reads at most
// capacity x 17 B and writes capacity x 17 B (under 0.05 us at 3.35 TB/s
// for 4096 slots), and a frame's IoU tests are seeds x entries f64
// expressions (1080p: 21 seeds x 312 hits). The seed loop is sequential:
// seed i's work depends on which earlier seeds assigned it. So the time is
// the latency of that chain: per seed, the block's IoU tests over the
// entries, a ballot and two barriers per chunk of kClusterThreads entries,
// and one thread's ordered walk over the members.
//
// What the design does about it:
//   - one block, so a seed's barrier is __syncthreads and not a launch;
//   - the sorted entries (16 B each) and the assigned flags stay in
//     shared memory for the whole loop, so a seed reads no global memory;
//   - a seed's members are compacted in sorted order (ballot, then the
//     warps' counts through shared memory) into a list, so the thread that
//     sums q walks the members only, not every entry;
//   - that thread also adds the integer coordinates: it visits every
//     member for the q sum anyway, and integer sums are exact in any order.
// A tree reduction of q would reorder the f32 sum and lose bit-equality
// with the host, so q is added by one thread.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kClusterThreads = 512;
constexpr int kClusterWarps = kClusterThreads / 32;

// Shared memory: sorted entries (float4, 16 B), a 4-byte scratch (the
// unsorted q during the sort, the member list after it) and a 1-byte flag
// (valid during the sort, assigned after it) per slot.
constexpr int kClusterSlotBytes = 16 + 4 + 1;

__device__ __forceinline__ bool joins(const float4& a, const float4& b,
                                      double thr) {
  // ops/cluster.py::iou_matrix, operation by operation, in f64
  const double ha = __ddiv_rn(static_cast<double>(a.z), 2.0);
  const double hb = __ddiv_rn(static_cast<double>(b.z), 2.0);
  const double ra = a.x, rb = b.x, ca = a.y, cb = b.y;
  const double over_r = fmax(
      0.0, __dsub_rn(fmin(__dadd_rn(ra, ha), __dadd_rn(rb, hb)),
                     fmax(__dsub_rn(ra, ha), __dsub_rn(rb, hb))));
  const double over_c = fmax(
      0.0, __dsub_rn(fmin(__dadd_rn(ca, ha), __dadd_rn(cb, hb)),
                     fmax(__dsub_rn(ca, ha), __dsub_rn(cb, hb))));
  const double inter = __dmul_rn(over_r, over_c);
  const double sa = a.z, sb = b.z;
  const double uni =
      __dsub_rn(__dadd_rn(__dmul_rn(sa, sa), __dmul_rn(sb, sb)), inter);
  return __ddiv_rn(inter, uni) > thr;
}

// The host's integer mean, sum // n (a floor, as Python's), as f32.
__device__ __forceinline__ float floor_div(long long sum, int n) {
  long long m = sum / n;
  if (sum % n != 0 && sum < 0) --m;
  return static_cast<float>(m);
}

__global__ void __launch_bounds__(kClusterThreads)
cluster_kernel(const float* __restrict__ dets,
               const uint8_t* __restrict__ valid,
               const int* __restrict__ count, int capacity, double thr,
               float* __restrict__ out, uint8_t* __restrict__ out_valid) {
  extern __shared__ float4 smem[];
  float4* sorted = smem;
  float* key = reinterpret_cast<float*>(sorted + capacity);
  int* list = reinterpret_cast<int*>(key);
  uint8_t* flag = reinterpret_cast<uint8_t*>(key + capacity);
  __shared__ int warp_count[kClusterWarps];
  __shared__ int n_valid;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n = min(max(*count, 0), capacity);

  for (int k = tid; k < capacity; k += kClusterThreads) {
    reinterpret_cast<float4*>(out)[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    out_valid[k] = 0;
  }
  for (int k = tid; k < n; k += kClusterThreads) {
    key[k] = dets[4 * k + 3];
    flag[k] = valid[k] != 0;
  }
  if (tid == 0) n_valid = 0;
  __syncthreads();

  // stable ascending rank sort of the valid entries
  for (int i = tid; i < n; i += kClusterThreads) {
    if (!flag[i]) continue;
    const float qi = key[i];
    int rank = 0;
    for (int j = 0; j < n; ++j) {
      const float qj = key[j];
      rank += flag[j] && (qj < qi || (qj == qi && j < i));
    }
    sorted[rank] = make_float4(dets[4 * i], dets[4 * i + 1],
                               dets[4 * i + 2], dets[4 * i + 3]);
    atomicAdd(&n_valid, 1);
  }
  __syncthreads();
  const int nv = n_valid;
  for (int k = tid; k < nv; k += kClusterThreads) flag[k] = 0;  // assigned
  __syncthreads();

  const unsigned below = (1u << lane) - 1u;
  for (int i = 0; i < nv; ++i) {
    if (flag[i]) continue;  // the same shared value in every thread
    const float4 seed = sorted[i];
    int members = 0;
    for (int base = 0; base < nv; base += kClusterThreads) {
      const int j = base + tid;
      const bool m = j < nv && joins(seed, sorted[j], thr);
      const unsigned ballot = __ballot_sync(0xffffffffu, m);
      if (lane == 0) warp_count[warp] = __popc(ballot);
      __syncthreads();
      int at = members, chunk = 0;
      for (int w = 0; w < kClusterWarps; ++w) {
        at += w < warp ? warp_count[w] : 0;
        chunk += warp_count[w];
      }
      if (m) {
        list[at + __popc(ballot & below)] = j;
        flag[j] = 1;
      }
      members += chunk;
      __syncthreads();
    }
    if (tid == 0 && members > 0) {
      long long sr = 0, sc = 0, ss = 0;
      float q = 0.f;
      for (int k = 0; k < members; ++k) {
        const float4 e = sorted[list[k]];
        sr += static_cast<long long>(e.x);
        sc += static_cast<long long>(e.y);
        ss += static_cast<long long>(e.z);
        q = __fadd_rn(q, e.w);
      }
      reinterpret_cast<float4*>(out)[i] =
          make_float4(floor_div(sr, members), floor_div(sc, members),
                      floor_div(ss, members), q);
      out_valid[i] = 1;
    }
    __syncthreads();  // the list is rewritten by the next seed
  }
}

}  // namespace

// dets f32 [capacity, 4] (row, col, scale, q), valid u8 [capacity], count
// int32 [1] on the card; out f32 [capacity, 4] (16-byte aligned) and
// out_valid u8 [capacity]. Returns a cudaError_t.
extern "C" int pigo_cluster_device(const void* dets, const void* valid,
                                   const void* count, int capacity,
                                   double thr, void* out, void* out_valid,
                                   void* stream) {
  const int smem = capacity * kClusterSlotBytes;
  cudaError_t err = cudaFuncSetAttribute(
      cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cluster_kernel<<<1, kClusterThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dets), static_cast<const uint8_t*>(valid),
      static_cast<const int*>(count), capacity, thr,
      static_cast<float*>(out), static_cast<uint8_t*>(out_valid));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pigo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
