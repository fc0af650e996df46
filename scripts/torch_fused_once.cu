// A variant of the grid-stride fused_metrics kernel (one CTA row per
// query, a branch per mask byte, int64 count and sum, min and max) that
// reads the plane once per CTA instead: each thread keeps FM0_K int4
// plane groups in registers and loops the B queries over them, with a
// block reduction and one set of atomics per (CTA, query). A measurement
// aid for scripts/torch_fused_step0.py, not part of the port.
#include <cuda_runtime.h>
#include <climits>

constexpr int FM0_K = 8;
constexpr unsigned FULL0 = 0xffffffffu;

__global__ void fm_once(const unsigned char* __restrict__ mask,
                        const int* __restrict__ plane, long long T, int B,
                        unsigned long long* cnt, unsigned long long* sum,
                        int* mn, int* mx) {
  const long long n4 = T / 4;
  const long long g0 = static_cast<long long>(blockIdx.x) * blockDim.x * FM0_K;
  int4 v[FM0_K];
  bool ok[FM0_K];
#pragma unroll
  for (int k = 0; k < FM0_K; ++k) {
    const long long i = g0 + k * blockDim.x + threadIdx.x;
    ok[k] = i < n4;
    if (ok[k]) v[k] = reinterpret_cast<const int4*>(plane)[i];
  }
  __shared__ long long sc[32], ss[32];
  __shared__ int slo[32], shi[32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int b = 0; b < B; ++b) {
    const uchar4* m4 = reinterpret_cast<const uchar4*>(mask + b * T);
    long long c = 0, s = 0;
    int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
    for (int k = 0; k < FM0_K; ++k) {
      if (!ok[k]) continue;
      const uchar4 m = m4[g0 + k * blockDim.x + threadIdx.x];
      const int4 x = v[k];
      if (m.x) { ++c; s += x.x; lo = min(lo, x.x); hi = max(hi, x.x); }
      if (m.y) { ++c; s += x.y; lo = min(lo, x.y); hi = max(hi, x.y); }
      if (m.z) { ++c; s += x.z; lo = min(lo, x.z); hi = max(hi, x.z); }
      if (m.w) { ++c; s += x.w; lo = min(lo, x.w); hi = max(hi, x.w); }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      c += __shfl_down_sync(FULL0, c, off);
      s += __shfl_down_sync(FULL0, s, off);
      lo = min(lo, __shfl_down_sync(FULL0, lo, off));
      hi = max(hi, __shfl_down_sync(FULL0, hi, off));
    }
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
        c += __shfl_down_sync(FULL0, c, off);
        s += __shfl_down_sync(FULL0, s, off);
        lo = min(lo, __shfl_down_sync(FULL0, lo, off));
        hi = max(hi, __shfl_down_sync(FULL0, hi, off));
      }
      if (lane == 0 && c > 0) {
        atomicAdd(cnt + b, static_cast<unsigned long long>(c));
        atomicAdd(sum + b, static_cast<unsigned long long>(s));
        atomicMin(mn + b, lo);
        atomicMax(mx + b, hi);
      }
    }
    __syncthreads();
  }
}

extern "C" int step0_once(const void* mask, const void* plane, int B,
                          long long T, void* cnt, void* sum, void* mn,
                          void* mx, void* stream) {
  const long long n4 = T / 4;
  const long long per = 256LL * FM0_K;
  const int grid = static_cast<int>((n4 + per - 1) / per);
  fm_once<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(mask), static_cast<const int*>(plane),
      T, B, static_cast<unsigned long long*>(cnt),
      static_cast<unsigned long long*>(sum), static_cast<int*>(mn),
      static_cast<int*>(mx));
  return static_cast<int>(cudaGetLastError());
}
