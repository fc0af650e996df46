// Hand-written Hopper kernels of the PyTorch port (sm_90a), bound through
// ctypes by ops/kernels.py with a plain C interface. Each launch function
// enqueues on the caller's stream, allocates nothing (the wrapper passes
// every output) and returns cudaGetLastError() as an int.
//
// 1. fused_metrics: one pass over (mask [B, T] bytes, plane [T] int32) per
//    query -> exact count, int64 sum, min and max. Replaces the JAX
//    package's ops/pallas_kernels.py fused_metrics + _kernel.
// 2. chain_blocks: per query of a [B, P] param matrix, the chain mask
//    (a mask program, query/compile.py) evaluated in-kernel over a
//    bucket-sorted layout's planes -> per-32-row-block matched counts and
//    int64 payload sums. Replaces _chain_blocks_batched / make_chain_blocks.
// 3. chain_counts: the same at 128-row groups, counts only (rank
//    percentiles). Replaces _chain_counts_batched / make_chain_counts.
// 4. chain_slot_counts: per query, the chain mask's matched rows in each
//    32-row block split by a static composite slot plane -> [B, ns, R/32]
//    (slot_rank nested percentiles). Replaces _chain_slot_counts_batched /
//    make_chain_slot_counts.
// 5. gather_rows: B whole rows of a row-major operand, picked by an int32
//    index array in device memory (member operands). Replaces
//    _gather_rows_batched / make_gather_rows.
//
// The chain kernels give each warp one row group: the warp loads the
// group's plane values ONCE into shared memory and then loops over the B
// queries, so HBM traffic is one plane pass per batch, not per query (the
// point of the TPU kernels' batching rule).

#include <cuda_runtime.h>
#include <climits>

namespace {

// opcodes: keep in step with query/compile.py
constexpr int OP_TRUE = 0;
constexpr int OP_AND = 1;
constexpr int OP_OR = 2;
constexpr int OP_NOT = 3;
constexpr int OP_RANGE32 = 4;
constexpr int OP_EQ32 = 5;
constexpr int OP_EQ32_GUARD = 6;
constexpr int OP_RANGE_WIDE = 7;
constexpr int OP_EQ_WIDE_GUARD = 8;
constexpr int OP_WIDTH = 8;

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 8;  // warps per block of the chain kernels

// Evaluate one row's mask. `vals` points at this lane's slot of plane 0 in
// shared memory; plane p sits 32 ints further per p. `prm` is the query's
// param row (uniform across the warp, so the loads broadcast).
__device__ __forceinline__ bool eval_row(const int* ops, int n_ops,
                                         const int* vals,
                                         const int* __restrict__ prm) {
  unsigned stack = 0u;
  int sp = 0;
  for (int i = 0; i < n_ops; ++i) {
    const int* o = ops + i * OP_WIDTH;
    bool r;
    switch (o[0]) {
      case OP_TRUE:
        r = true;
        break;
      case OP_AND:
      case OP_OR: {
        const bool b = (stack >> (sp - 1)) & 1u;
        const bool a = (stack >> (sp - 2)) & 1u;
        sp -= 2;
        r = (o[0] == OP_AND) ? (a && b) : (a || b);
        break;
      }
      case OP_NOT:
        sp -= 1;
        r = !((stack >> sp) & 1u);
        break;
      case OP_RANGE32: {
        const int v = vals[o[1] * 32];
        r = (v >= prm[o[2]]) && (v <= prm[o[3]]);
        break;
      }
      case OP_EQ32:
        r = vals[o[1] * 32] == prm[o[2]];
        break;
      case OP_EQ32_GUARD:
        r = (vals[o[1] * 32] == prm[o[2]]) && (prm[o[3]] > 0);
        break;
      case OP_RANGE_WIDE: {
        const int hi = vals[o[1] * 32];
        const int lo = vals[o[2] * 32];
        const bool ge = (hi > prm[o[3]]) || (hi == prm[o[3]] && lo >= prm[o[4]]);
        const bool le = (hi < prm[o[5]]) || (hi == prm[o[5]] && lo <= prm[o[6]]);
        r = ge && le;
        break;
      }
      case OP_EQ_WIDE_GUARD:
        r = (vals[o[1] * 32] == prm[o[3]]) && (vals[o[2] * 32] == prm[o[4]]) &&
            (prm[o[5]] > 0);
        break;
      default:
        r = false;
        break;
    }
    stack = (stack & ~(1u << sp)) | (static_cast<unsigned>(r) << sp);
    ++sp;
  }
  return stack & 1u;
}

__device__ __forceinline__ long long warp_sum64(long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(FULL, v, off);
  return v;
}

// ROWS rows per lane: a warp owns ROWS*32 consecutive layout rows.
// ROWS == 1: chain_blocks (counts + payload sums per 32-row block);
// ROWS == 4: chain_counts (counts per 128-row group, no payloads).
template <int ROWS>
__global__ void chain_kernel(const int* __restrict__ pmat, int B, int P,
                             const int* __restrict__ ops, int n_ops,
                             const int* const* __restrict__ planes,
                             int n_planes,
                             const signed char* __restrict__ avalid,
                             const int* const* __restrict__ pays, int n_pay,
                             long long n_groups, int* __restrict__ counts,
                             long long* __restrict__ sums) {
  extern __shared__ int smem[];
  int* s_ops = smem;
  for (int i = threadIdx.x; i < n_ops * OP_WIDTH; i += blockDim.x)
    s_ops[i] = ops[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int per_row = n_planes + n_pay;  // ints per row slot, x32 lanes
  int* wv = smem + n_ops * OP_WIDTH + warp * (ROWS * per_row * 32);

  for (long long g = static_cast<long long>(blockIdx.x) * WARPS + warp;
       g < n_groups; g += static_cast<long long>(gridDim.x) * WARPS) {
    bool av[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const long long row = (g * ROWS + r) * 32 + lane;
      av[r] = avalid[row] > 0;
      int* slot = wv + r * per_row * 32 + lane;
      for (int p = 0; p < n_planes; ++p) slot[p * 32] = planes[p][row];
      for (int l = 0; l < n_pay; ++l) slot[(n_planes + l) * 32] = pays[l][row];
    }
    for (int b = 0; b < B; ++b) {
      const int* prm = pmat + static_cast<long long>(b) * P;
      int cnt = 0;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int* slot = wv + r * per_row * 32 + lane;
        const bool m = av[r] && eval_row(s_ops, n_ops, slot, prm);
        cnt += __popc(__ballot_sync(FULL, m));
        if (ROWS == 1) {
          for (int l = 0; l < n_pay; ++l) {
            const long long s =
                warp_sum64(m ? static_cast<long long>(slot[(n_planes + l) * 32])
                             : 0LL);
            if (lane == 0) sums[(static_cast<long long>(b) * n_pay + l) * n_groups + g] = s;
          }
        }
      }
      if (lane == 0) counts[static_cast<long long>(b) * n_groups + g] = cnt;
    }
  }
}

// chain_slot_counts: chain_kernel<1>'s block walk, with the matched rows of
// each query split by the block's static slot values. Bound on the H100: one
// pass over the chain planes + avalid + slot per BATCH, then per query one
// mask evaluation and ns int32 stores, strided by n_groups (the [B, ns, G]
// layout the cumsum along G wants; the strided stores are a known cost).
// The slot ballots sb (lane j of a 32-slot chunk holds the rows of slot
// base + j) do not depend on the query, so they are built once per block
// and chunk; past 32 slots the chunk loop re-evaluates each query's mask.
__global__ void chain_slot_kernel(const int* __restrict__ pmat, int B, int P,
                                  const int* __restrict__ ops, int n_ops,
                                  const int* const* __restrict__ planes,
                                  int n_planes,
                                  const signed char* __restrict__ avalid,
                                  const int* __restrict__ slot, int ns,
                                  long long n_groups, int* __restrict__ counts) {
  extern __shared__ int smem[];
  int* s_ops = smem;
  for (int i = threadIdx.x; i < n_ops * OP_WIDTH; i += blockDim.x)
    s_ops[i] = ops[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int* wv = smem + n_ops * OP_WIDTH + warp * (n_planes * 32);

  for (long long g = static_cast<long long>(blockIdx.x) * WARPS + warp;
       g < n_groups; g += static_cast<long long>(gridDim.x) * WARPS) {
    const long long row = g * 32 + lane;
    const bool av = avalid[row] > 0;
    const int sv = slot[row];
    int* vals = wv + lane;
    for (int p = 0; p < n_planes; ++p) vals[p * 32] = planes[p][row];
    for (int base = 0; base < ns; base += 32) {
      const int n_here = min(32, ns - base);
      unsigned sb = 0u;
      for (int j = 0; j < n_here; ++j) {
        const unsigned bj = __ballot_sync(FULL, sv == base + j);
        if (lane == j) sb = bj;
      }
      for (int b = 0; b < B; ++b) {
        const int* prm = pmat + static_cast<long long>(b) * P;
        const bool m = av && eval_row(s_ops, n_ops, vals, prm);
        const unsigned bm = __ballot_sync(FULL, m);
        if (lane < n_here)
          counts[(static_cast<long long>(b) * ns + base + lane) * n_groups + g] =
              __popc(bm & sb);
      }
    }
  }
}

// gather_rows: out[b] = op[idx[b]] for rows of row_vec 16-byte words.
// Bound: HBM bytes, 2 x B x row bytes (a read and a write of each row).
// The grid is (B, row chunks): blockIdx.x walks the batch, so the blocks in
// flight copy the same chunk of every picked row, and a row picked twice in
// a batch is read the second time from L2. Each thread makes one pass: it
// starts GR_UNROLL int4 loads before its stores (several loads in flight
// per thread), neighbouring threads on neighbouring addresses. The index
// lives in device memory (the TPU kernel's scalar prefetch) and is clamped
// into [0, n_rows) so a bad index cannot read outside the operand; callers
// clamp it already.
constexpr int GR_THREADS = 256;
constexpr int GR_UNROLL = 4;

__global__ void gather_rows_kernel(const int* __restrict__ idx,
                                   const int4* __restrict__ op,
                                   long long n_rows, long long row_vec,
                                   int4* __restrict__ out) {
  const long long b = blockIdx.x;
  const long long r = min(max(static_cast<long long>(idx[b]), 0LL), n_rows - 1);
  const int4* src = op + r * row_vec;
  int4* dst = out + b * row_vec;
  const long long step = static_cast<long long>(gridDim.y) * blockDim.x;
  for (long long i0 = static_cast<long long>(blockIdx.y) * blockDim.x + threadIdx.x;
       i0 < row_vec; i0 += step * GR_UNROLL) {
    int4 v[GR_UNROLL];
#pragma unroll
    for (int u = 0; u < GR_UNROLL; ++u)
      if (i0 + u * step < row_vec) v[u] = src[i0 + u * step];
#pragma unroll
    for (int u = 0; u < GR_UNROLL; ++u)
      if (i0 + u * step < row_vec) dst[i0 + u * step] = v[u];
  }
}

__global__ void fused_metrics_kernel(const unsigned char* __restrict__ mask,
                                     const int* __restrict__ plane,
                                     long long T,
                                     unsigned long long* __restrict__ cnt,
                                     unsigned long long* __restrict__ sum,
                                     int* __restrict__ mn,
                                     int* __restrict__ mx) {
  const int b = blockIdx.y;
  const uchar4* m4 = reinterpret_cast<const uchar4*>(mask + b * T);
  const int4* v4 = reinterpret_cast<const int4*>(plane);
  const long long n4 = T / 4;
  long long c = 0, s = 0;
  int lo = INT_MAX, hi = INT_MIN;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n4; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const uchar4 m = m4[i];
    const int4 v = v4[i];
    if (m.x) { ++c; s += v.x; lo = min(lo, v.x); hi = max(hi, v.x); }
    if (m.y) { ++c; s += v.y; lo = min(lo, v.y); hi = max(hi, v.y); }
    if (m.z) { ++c; s += v.z; lo = min(lo, v.z); hi = max(hi, v.z); }
    if (m.w) { ++c; s += v.w; lo = min(lo, v.w); hi = max(hi, v.w); }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    c += __shfl_down_sync(FULL, c, off);
    s += __shfl_down_sync(FULL, s, off);
    lo = min(lo, __shfl_down_sync(FULL, lo, off));
    hi = max(hi, __shfl_down_sync(FULL, hi, off));
  }
  __shared__ long long sc[32], ss[32];
  __shared__ int slo[32], shi[32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) { sc[warp] = c; ss[warp] = s; slo[warp] = lo; shi[warp] = hi; }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    c = lane < nw ? sc[lane] : 0;
    s = lane < nw ? ss[lane] : 0;
    lo = lane < nw ? slo[lane] : INT_MAX;
    hi = lane < nw ? shi[lane] : INT_MIN;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      c += __shfl_down_sync(FULL, c, off);
      s += __shfl_down_sync(FULL, s, off);
      lo = min(lo, __shfl_down_sync(FULL, lo, off));
      hi = max(hi, __shfl_down_sync(FULL, hi, off));
    }
    if (lane == 0 && c > 0) {
      // two's-complement wraparound makes the unsigned add an exact signed add
      atomicAdd(cnt + b, static_cast<unsigned long long>(c));
      atomicAdd(sum + b, static_cast<unsigned long long>(s));
      atomicMin(mn + b, lo);
      atomicMax(mx + b, hi);
    }
  }
}

int grid_for(long long work, int per_block, int cap) {
  long long g = (work + per_block - 1) / per_block;
  if (g > cap) g = cap;
  return g < 1 ? 1 : static_cast<int>(g);
}

template <int ROWS>
int launch_chain(const int* pmat, int B, int P, const int* ops, int n_ops,
                 const int* const* planes, int n_planes,
                 const signed char* avalid, const int* const* pays, int n_pay,
                 long long n_groups, int* counts, long long* sums,
                 cudaStream_t stream) {
  const size_t shmem =
      sizeof(int) * (static_cast<size_t>(n_ops) * OP_WIDTH +
                     static_cast<size_t>(WARPS) * ROWS * (n_planes + n_pay) * 32);
  if (shmem > 48 * 1024) {
    cudaFuncSetAttribute(chain_kernel<ROWS>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(shmem));
  }
  // 132 SMs: a few resident blocks each; the group loop strides the rest
  const int grid = grid_for(n_groups, WARPS, 132 * 16);
  chain_kernel<ROWS><<<grid, WARPS * 32, shmem, stream>>>(
      pmat, B, P, ops, n_ops, planes, n_planes, avalid, pays, n_pay, n_groups,
      counts, sums);
  return static_cast<int>(cudaGetLastError());
}

int launch_chain_slot(const int* pmat, int B, int P, const int* ops, int n_ops,
                      const int* const* planes, int n_planes,
                      const signed char* avalid, const int* slot, int ns,
                      long long n_groups, int* counts, cudaStream_t stream) {
  const size_t shmem =
      sizeof(int) * (static_cast<size_t>(n_ops) * OP_WIDTH +
                     static_cast<size_t>(WARPS) * n_planes * 32);
  if (shmem > 48 * 1024) {
    cudaFuncSetAttribute(chain_slot_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(shmem));
  }
  const int grid = grid_for(n_groups, WARPS, 132 * 16);
  chain_slot_kernel<<<grid, WARPS * 32, shmem, stream>>>(
      pmat, B, P, ops, n_ops, planes, n_planes, avalid, slot, ns, n_groups,
      counts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int tat_fused_metrics(const void* mask, const void* plane, int B, long long T,
                      void* cnt, void* sum, void* mn, void* mx, void* stream) {
  const int threads = 256;
  const int gx = grid_for(T / 4, threads, (132 * 8 + B - 1) / B);
  dim3 grid(gx, B);
  fused_metrics_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(mask), static_cast<const int*>(plane), T,
      static_cast<unsigned long long*>(cnt), static_cast<unsigned long long*>(sum),
      static_cast<int*>(mn), static_cast<int*>(mx));
  return static_cast<int>(cudaGetLastError());
}

int tat_chain_blocks(const void* pmat, int B, int P, const void* ops,
                     int n_ops, const void* planes, int n_planes,
                     const void* avalid, const void* pays, int n_pay,
                     long long n_groups, void* counts, void* sums,
                     void* stream) {
  return launch_chain<1>(
      static_cast<const int*>(pmat), B, P, static_cast<const int*>(ops), n_ops,
      static_cast<const int* const*>(planes), n_planes,
      static_cast<const signed char*>(avalid),
      static_cast<const int* const*>(pays), n_pay, n_groups,
      static_cast<int*>(counts), static_cast<long long*>(sums),
      static_cast<cudaStream_t>(stream));
}

int tat_chain_counts(const void* pmat, int B, int P, const void* ops,
                     int n_ops, const void* planes, int n_planes,
                     const void* avalid, long long n_groups, void* counts,
                     void* stream) {
  return launch_chain<4>(
      static_cast<const int*>(pmat), B, P, static_cast<const int*>(ops), n_ops,
      static_cast<const int* const*>(planes), n_planes,
      static_cast<const signed char*>(avalid), nullptr, 0, n_groups,
      static_cast<int*>(counts), nullptr, static_cast<cudaStream_t>(stream));
}

int tat_chain_slot_counts(const void* pmat, int B, int P, const void* ops,
                          int n_ops, const void* planes, int n_planes,
                          const void* avalid, const void* slot, int ns,
                          long long n_groups, void* counts, void* stream) {
  return launch_chain_slot(
      static_cast<const int*>(pmat), B, P, static_cast<const int*>(ops), n_ops,
      static_cast<const int* const*>(planes), n_planes,
      static_cast<const signed char*>(avalid), static_cast<const int*>(slot),
      ns, n_groups, static_cast<int*>(counts),
      static_cast<cudaStream_t>(stream));
}

int tat_gather_rows(const void* idx, int B, const void* op, long long n_rows,
                    long long row_vec, void* out, void* stream) {
  // one pass per thread: GR_UNROLL words each (the wrapper keeps the chunk
  // count within gridDim.y's 65535)
  const int gy = grid_for(row_vec, GR_THREADS * GR_UNROLL, INT_MAX);
  dim3 grid(B, gy);
  gather_rows_kernel<<<grid, GR_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const int4*>(op), n_rows,
      row_vec, static_cast<int4*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
