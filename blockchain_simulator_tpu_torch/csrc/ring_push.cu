// In-place ring-buffer pushes for the tick engines' future-inbox rings, many
// pushes in one launch.
//
// Replaces blockchain_simulator_tpu/ops/ring_kernel.py `fused_push` (the
// Pallas TPU kernel).  One push is, for every bucket b < B <= D,
//
//     buf[(t + lo + b) % D, :] op= contrib[b, :]      op in {add, max}
//
// on an int32 ring flattened to [D, L] and a contribution [B, L]; the other
// D - B slices are not touched.  The update is in place: PyTorch tensors are
// mutable, so the ring the caller passes in is the ring it gets back (the
// Pallas kernel needed input_output_aliases for the same effect).  A launch
// applies a GROUP of such pushes (up to kMaxMembers), each on its own ring:
// the PBFT tick engine makes its four pushes of a tick in one launch.
//
// Bound.  Memory: each element reads the ring slot and the contribution and
// writes the ring slot back, 12 * B * L bytes per push.  At the PBFT tick
// engine's n = 1000 shapes a tick's four pushes move 8.5 MB, about 2.5 us at
// 3.35 TB/s.  Launched one by one, each push paid the launch's fixed cost
// (about 1.4 us of device time, more than the bytes of three of the four
// pushes), so the design attacks that first and the access width second:
//
// - One launch per group.  The member descriptors travel BY VALUE as a
//   __grid_constant__ kernel parameter (no host-to-device copy, so a CUDA
//   graph can capture the launch).  A 1-D grid covers every member's
//   (bucket, chunk) tiles; a block finds its member by scanning the block
//   prefixes, then its bucket, and computes its slot once, in int32, with a
//   non-negative modulo.  The tick `t` is read from a device pointer, never
//   from the host.
// - 16-byte accesses.  A member whose L is a multiple of 4 and whose ring and
//   contribution are 16-byte aligned takes the int4 path (the host decides,
//   and says so in `vec`); any other takes the scalar path with a masked
//   tail.  Each thread issues all its loads before its stores, 32 bytes of
//   contribution and 32 of ring.  A tick's group is 355 blocks of 256
//   threads, all resident at once (8 a SM), so all 5.7 MB it reads are in
//   flight together.  The contribution is read once: streaming loads
//   (__ldcs).
// - Buckets of one push address distinct slices (B <= D) and members address
//   distinct rings (the wrapper refuses shared rings and contributions that
//   overlap a ring), so no two threads write one element and no atomics are
//   needed.
//
// Hopper's other units add nothing here: this is a one-touch stream with no
// reuse, so shared memory, TMA and wgmma buy nothing.  The levers are fewer
// launches and wider accesses.  Fusing the push into the op that produces
// `contrib`, and a CUDA graph over the tick loop, are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libring_push.so ring_push.cu
// Binding: plain C entry points loaded with ctypes
// (blockchain_simulator_tpu_torch/ops/ring_kernel.py, which mirrors PushDesc
// and the constants below and checks them against ring_push_layout).

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecPerThread = 2;  // int4 per thread and operand
constexpr int kElemsPerBlock = kThreads * kVecPerThread * 4;  // int32 per (bucket, chunk)
constexpr int kScalarPerThread = kElemsPerBlock / kThreads;
constexpr int kMaxMembers = 32;

struct PushDesc {
  int32_t* buf;            // ring [D, L]
  const int32_t* contrib;  // contribution [B, L]
  long long len;           // L
  int lo;                  // slot offset of bucket 0
  int depth;               // D
  int buckets;             // B
  int op;                  // 0 = add, 1 = max
  int vec;                 // 1 = int4 path (L % 4 == 0, both bases 16-byte aligned)
  int chunks;              // blocks per bucket: ceil(L / kElemsPerBlock)
  int first_block;         // block prefix: the member's first block index
  int reserved;
};

struct PushGroup {
  PushDesc d[kMaxMembers];
  int count;
};
static_assert(sizeof(PushGroup) <= 4000, "group must fit the kernel-parameter space");

__device__ __forceinline__ int32_t combine(int32_t cur, int32_t c, bool is_max) {
  // add: two's-complement wraparound, as the int32 add of the JAX package
  return is_max ? (cur > c ? cur : c)
                : static_cast<int32_t>(static_cast<uint32_t>(cur) + static_cast<uint32_t>(c));
}

__global__ void __launch_bounds__(kThreads)
ring_push_group_kernel(const __grid_constant__ PushGroup g, const int32_t* __restrict__ t) {
  const int bid = static_cast<int>(blockIdx.x);
  int m = g.count - 1;
  while (m > 0 && bid < g.d[m].first_block) --m;
  const PushDesc& p = g.d[m];
  const int local = bid - p.first_block;
  const int b = local / p.chunks;
  const int chunk = local - b * p.chunks;
  const int depth = p.depth;
  int slot = (__ldg(t) % depth + p.lo % depth + b) % depth;  // in (-D, D)
  if (slot < 0) slot += depth;
  const long long start = static_cast<long long>(chunk) * kElemsPerBlock;
  int32_t* dst = p.buf + static_cast<long long>(slot) * p.len + start;
  const int32_t* src = p.contrib + static_cast<long long>(b) * p.len + start;
  const long long left = p.len - start;
  const int n = static_cast<int>(left < kElemsPerBlock ? left : kElemsPerBlock);
  const bool is_max = p.op != 0;

  if (p.vec) {
    int4* d4 = reinterpret_cast<int4*>(dst);
    const int4* s4 = reinterpret_cast<const int4*>(src);
    const int n4 = n >> 2;
    int4 c[kVecPerThread], r[kVecPerThread];
#pragma unroll
    for (int k = 0; k < kVecPerThread; ++k) {
      const int i = k * kThreads + static_cast<int>(threadIdx.x);
      if (i < n4) {
        c[k] = __ldcs(s4 + i);
        r[k] = d4[i];
      }
    }
#pragma unroll
    for (int k = 0; k < kVecPerThread; ++k) {
      const int i = k * kThreads + static_cast<int>(threadIdx.x);
      if (i < n4) {
        r[k].x = combine(r[k].x, c[k].x, is_max);
        r[k].y = combine(r[k].y, c[k].y, is_max);
        r[k].z = combine(r[k].z, c[k].z, is_max);
        r[k].w = combine(r[k].w, c[k].w, is_max);
        d4[i] = r[k];
      }
    }
  } else {
    int32_t c[kScalarPerThread], r[kScalarPerThread];
#pragma unroll
    for (int k = 0; k < kScalarPerThread; ++k) {
      const int i = k * kThreads + static_cast<int>(threadIdx.x);
      if (i < n) {
        c[k] = __ldcs(src + i);
        r[k] = dst[i];
      }
    }
#pragma unroll
    for (int k = 0; k < kScalarPerThread; ++k) {
      const int i = k * kThreads + static_cast<int>(threadIdx.x);
      if (i < n) dst[i] = combine(r[k], c[k], is_max);
    }
  }
}

}  // namespace

extern "C" {

// Writes {kMaxMembers, kElemsPerBlock, sizeof(PushDesc)} for the binding to
// check against its own copy of the layout.
void ring_push_layout(int* out) {
  out[0] = kMaxMembers;
  out[1] = kElemsPerBlock;
  out[2] = static_cast<int>(sizeof(PushDesc));
}

// Applies `count` pushes in one launch on `stream`.  The descriptors (block
// prefixes included) are planned by the caller; they are copied into the
// kernel's parameter, so `descs` may be reused as soon as this returns.
// Returns the cudaError_t of the launch (0 = ok).
// (`descs` is typed void: a parameter of a type in the unnamed namespace
// would give the entry point internal linkage.)
int ring_push_group_i32(const void* descs_in, int count, const int32_t* t, void* stream) {
  if (count <= 0 || count > kMaxMembers) return static_cast<int>(cudaErrorInvalidValue);
  const PushDesc* descs = static_cast<const PushDesc*>(descs_in);
  PushGroup g;
  memset(&g, 0, sizeof(g));
  memcpy(g.d, descs, sizeof(PushDesc) * count);
  g.count = count;
  const PushDesc& last = descs[count - 1];
  const long long blocks =
      static_cast<long long>(last.first_block) + static_cast<long long>(last.buckets) * last.chunks;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  ring_push_group_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(g, t);
  return static_cast<int>(cudaGetLastError());
}

const char* ring_push_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
