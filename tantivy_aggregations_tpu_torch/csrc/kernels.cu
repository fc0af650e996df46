// Hand-written Hopper kernels of the PyTorch port (sm_90a), bound through
// ctypes by ops/kernels.py with a plain C interface. Each launch function
// enqueues on the caller's stream, allocates nothing (the wrapper passes
// every output) and returns cudaGetLastError() as an int.
//
// 1. fused_metrics: per query of a mask [B, T] of bytes, the exact count,
//    int64 sum and (optionally) min and max of an int32 plane [T] over the
//    selected rows. Replaces the JAX package's ops/pallas_kernels.py
//    fused_metrics + _kernel. A tile kernel and a fold.
// 2. chain_blocks: per query of a [B, P] param matrix, the chain mask
//    (a mask program, query/compile.py) evaluated in-kernel over a
//    bucket-sorted layout's planes -> per-32-row-block matched counts and
//    int64 payload sums. Replaces _chain_blocks_batched / make_chain_blocks.
// 3. chain_counts: the same at 128-row groups, counts only (rank
//    percentiles). Replaces _chain_counts_batched / make_chain_counts.
// 4. chain_slot_counts: per query, the chain mask's matched rows in each
//    32-row block split by a static composite slot plane -> [B, ns, R/32]
//    (slot_rank nested percentiles). Replaces _chain_slot_counts_batched /
//    make_chain_slot_counts. The same tile kernel as 2 and 3.
// 5. gather_rows: B whole rows of a row-major operand, picked by an int32
//    index array in device memory (member operands). Replaces
//    _gather_rows_batched / make_gather_rows.
// 6. dense_buckets: per query of a mask [B, T] of bytes, the exact count
//    of the selected rows in each bucket of a static int32 bucket-id plane,
//    or the exact int64 sum of a static int32 payload over them. Replaces
//    the one-hot products of the JAX package's ops/reductions.py
//    dense_bucket_counts_mxu / dense_bucket_sum_mxu. A tile kernel and a
//    fold.
// 7. dense_extremes: per query of a mask [B, T] of bytes, the exact min
//    and / or max of a static payload (an int32 plane or a wide (hi, lo)
//    pair) over the selected rows in each bucket of a static int32
//    bucket-id plane. Replaces the JAX package's ops/reductions.py
//    dense_bucket_min / dense_bucket_max. A tile kernel and a fold.
//
// fused_metrics, dense_buckets and every chain kernel read each plane once
// per BATCH (per query tile for dense_buckets), not per query (the point of
// the TPU kernels' batching rule).

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
constexpr int OP_SET32 = 9;
constexpr int OP_SET_WIDE = 10;
constexpr int OP_GT_IMM = 11;  // plane > the immediate o[2] (a guard)
// 12 and up are doc-space only (value-row scatters): _check_chain keeps
// them out of every kernel
constexpr int OP_WIDTH = 8;

constexpr unsigned FULL = 0xffffffffu;

// ---------------------------------------------------------------------------
// chain_blocks / chain_counts / chain_slot_counts: lane per 32-row block
// ---------------------------------------------------------------------------
//
// Bound on the H100: one pass over the chain planes, the payload planes and
// avalid per BATCH (HBM bytes; ~0.019 ms for c4's 63.6 MB with the outputs
// of B = 1), plus per query and row one compare per leaf and one add per
// payload (int32 ALU at B = 128), plus the per-query outputs (4 bytes per
// block count, 8 per block sum).
//
// Design. A lane owns one 32-row block and builds, per query, its block's
// mask as a 32-bit word (bit r = row r): Boolean ops are single word ops,
// the count is __popc(word & avalid word), and the op list is decoded once
// per (tile, query) uniformly across the warp, not once per row. A CTA
// stages a tile of 32 consecutive blocks (1024 rows) of every source plane
// in shared memory with 16-byte cp.async copies, double-buffered so the
// next tile's copies are in flight while this one's queries run (only for
// programs whose two stages fit DOUBLE_BUFFER_MAX, ops/kernels.py: a wide
// program's second stage would halve the resident CTAs, whose copies
// already overlap each other's queries, so it gets one); its warps
// share the tile and split the queries (warp w takes b = w, w + W, ...), so
// shared memory does not grow with the warps and any B works. Each staged
// block is padded to BLOCK_STRIDE = 36 ints: lane j's 128-bit reads of its
// own block (8 x 16 B) fall on distinct banks within each quarter warp.
// avalid blocks are padded to 48 bytes for the same reason. The query's
// param row is copied into shared memory once per (tile, query): the
// launch keeps fewer warps where the rows of 8 would not fit. Payload
// sums, no shuffles: once a tile, the CTA rewrites each staged payload
// block as byte slices (byte_slice); a lane then sums its block's masked
// payloads with four __dp4a per 4 rows and recombines the slices in int64
// (exact for any int32, INT32_MIN and INT32_MAX included), skipping empty
// words: a fixed 32 __dp4a per block and payload, where a loop over set
// bits costs up to 32 dependent int64 adds and payload bit-planes 32
// popcounts. Outputs: lane j writes block g0 + j, so a warp stores 32
// consecutive counts (128 B) and 32 consecutive sums (256 B) per query and
// payload. chain_counts keeps the 32-row lane and tile (the wide programs'
// 8 planes would not double-buffer at 4096-row tiles within 227 KB) and
// folds four lanes' counts with two shuffles; lane 4k stores group
// g0/4 + k, 8 consecutive int32 per warp and query. Plane and payload
// pointers arrive by value in a __grid_constant__ struct (no device
// pointer array, no per-call copy).
//
// chain_slot_counts (SLOTS) on the same tile. Bound: one pass over the
// chain planes, the slot plane and avalid per batch, plus ns int32 stores
// per query and 32-row block ([B, ns, R/32], most of the bytes at B = 128).
// The slot plane is staged as one more source of the tile. Slot words are
// query-independent (the TPU kernel's hoisted one-hots): for a chunk of up
// to SLOT_CHUNK slots, word j of lane l's block has bit r set where row r
// holds slot base + j; the CTA builds them in shared memory once per tile
// and chunk (zeroed, then each thread ORs in 4 rows of one block with
// shared atomicOr; lanes sit on distinct blocks, so distinct banks). Per
// query a lane evaluates w = eval_word(...) & avalid word once per tile;
// for each slot j it stores __popc(w & word j) at block g0 + lane, so a
// warp's stores are 32 consecutive int32 (128 B) per (query, slot). When
// ns spans several chunks, each query's word is kept in shared memory
// (qb queries at a time) and the chunks loop over the kept words, so the
// mask is still evaluated once per (tile, query).

// sources (chain planes, then payloads or the slot plane): the most whose
// staged tile fits 227 KB of shared memory (ops/kernels.py MAX_SOURCES)
constexpr int MAX_SRC = 50;
constexpr int MAX_STACK = 32;           // query/compile.py MAX_STACK
constexpr int TILE_BLOCKS = 32;         // one 32-row block per lane
constexpr int TILE_ROWS = TILE_BLOCKS * 32;
constexpr int BLOCK_STRIDE = 36;        // staged ints per 32-row block
constexpr int SRC_INTS = TILE_BLOCKS * BLOCK_STRIDE;
constexpr int AV_STRIDE = 48;           // staged avalid bytes per block
constexpr int AV_BYTES = TILE_BLOCKS * AV_STRIDE;
constexpr int CHAIN_THREADS = 256;      // at most 8 warps (ops/kernels.py)
constexpr int SLOT_CHUNK = 32;          // slots whose words a CTA holds

// what a chain tile kernel computes
enum ChainMode { BLOCKS = 0, COUNTS = 1, SLOTS = 2 };

struct ChainSrc {
  const int* p[MAX_SRC];  // chain planes, then payloads or the slot plane
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy tile `tile` (blocks tile*32 ...) of every source and of avalid into
// `buf`; rows past the last block are not copied (the lanes that own them
// store nothing).
__device__ __forceinline__ void stage_tile(unsigned char* buf,
                                           const ChainSrc& src, int n_src,
                                           const signed char* avalid,
                                           long long n_blocks,
                                           long long tile) {
  const long long row0 = tile * TILE_ROWS;
  const long long left = (n_blocks - tile * TILE_BLOCKS) * 32;
  const int rows = left < TILE_ROWS ? static_cast<int>(left) : TILE_ROWS;
  int* ints = reinterpret_cast<int*>(buf);
  for (int c = threadIdx.x; c < n_src * (TILE_ROWS / 4); c += blockDim.x) {
    const int s = c / (TILE_ROWS / 4);
    const int t = (c % (TILE_ROWS / 4)) * 4;
    if (t < rows)
      cp_async16(ints + s * SRC_INTS + (t >> 5) * BLOCK_STRIDE + (t & 31),
                 src.p[s] + row0 + t);
  }
  unsigned char* av = buf + n_src * SRC_INTS * 4;
  for (int c = threadIdx.x; c < TILE_ROWS / 16; c += blockDim.x) {
    const int t = c * 16;
    if (t < rows)
      cp_async16(av + (c >> 1) * AV_STRIDE + (c & 1) * 16, avalid + row0 + t);
  }
}

// bit i = (signed byte i of x) > 0, for i < 4
__device__ __forceinline__ unsigned positive_bytes(unsigned x) {
  const unsigned m = (__vcmpgts4(x, 0u) >> 7) & 0x01010101u;
  return (m * 0x10204080u) >> 28;
}

// 32-bit row word of a staged block: bit r = f(v[r])
template <class F>
__device__ __forceinline__ unsigned word_of(const int* v, F f) {
  const int4* v4 = reinterpret_cast<const int4*>(v);
  unsigned w = 0u;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int4 x = v4[q];
    w |= (static_cast<unsigned>(f(x.x)) << (4 * q)) |
         (static_cast<unsigned>(f(x.y)) << (4 * q + 1)) |
         (static_cast<unsigned>(f(x.z)) << (4 * q + 2)) |
         (static_cast<unsigned>(f(x.w)) << (4 * q + 3));
  }
  return w;
}

// the same over two planes: bit r = f(h[r], l[r])
template <class F>
__device__ __forceinline__ unsigned word_of2(const int* h, const int* l, F f) {
  const int4* h4 = reinterpret_cast<const int4*>(h);
  const int4* l4 = reinterpret_cast<const int4*>(l);
  unsigned w = 0u;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int4 x = h4[q];
    const int4 y = l4[q];
    w |= (static_cast<unsigned>(f(x.x, y.x)) << (4 * q)) |
         (static_cast<unsigned>(f(x.y, y.y)) << (4 * q + 1)) |
         (static_cast<unsigned>(f(x.z, y.z)) << (4 * q + 2)) |
         (static_cast<unsigned>(f(x.w, y.w)) << (4 * q + 3));
  }
  return w;
}

// (hi, lo) as one unsigned key whose order is the signed lexicographic one
__device__ __forceinline__ unsigned long long wide_key(int hi, int lo) {
  return (static_cast<unsigned long long>(static_cast<unsigned>(hi) ^ 0x80000000u)
          << 32) |
         (static_cast<unsigned>(lo) ^ 0x80000000u);
}

// The word of an opcode of the extended set (op list entry `o`):
// OP_GT_IMM, a plane compared with an immediate (the multi-valued planes'
// guards: a position's -1 fill, the wide value count, a keyword's missing
// ordinal), or a set opcode (OP_SET32 / OP_SET_WIDE), the OR of its S run
// slots' RANGE32 (or RANGE_WIDE) compare words; an empty slot (lo > hi:
// extract_params pads the runs with (1, 0)) is skipped by a branch uniform
// across the warp.
__device__ __forceinline__ unsigned set_word(const int* o, const int* blk,
                                             const int* prm) {
  unsigned r = 0u;
  if (o[0] == OP_GT_IMM) {
    const int imm = o[2];
    return word_of(blk + o[1] * SRC_INTS, [=](int x) { return x > imm; });
  }
  if (o[0] == OP_SET32) {
    const int* v = blk + o[1] * SRC_INTS;
    for (int s = 0; s < o[3]; ++s) {
      const int lo = prm[o[2] + 2 * s], hi = prm[o[2] + 2 * s + 1];
      if (lo > hi) continue;
      const unsigned span = static_cast<unsigned>(hi) - static_cast<unsigned>(lo);
      r |= word_of(v, [=](int x) {
        return static_cast<unsigned>(x) - static_cast<unsigned>(lo) <= span;
      });
    }
    return r;
  }
  const int* h = blk + o[1] * SRC_INTS;
  const int* l = blk + o[2] * SRC_INTS;
  for (int s = 0; s < o[4]; ++s) {
    const int* q = prm + o[3] + 4 * s;
    const unsigned long long klo = wide_key(q[0], q[1]);
    const unsigned long long khi = wide_key(q[2], q[3]);
    if (klo > khi) continue;
    const unsigned long long span = khi - klo;
    r |= word_of2(h, l, [=](int a, int b) { return wide_key(a, b) - klo <= span; });
  }
  return r;
}

// The mask program over lane's block `blk` (plane p at blk + p * SRC_INTS)
// under params `prm` -> the block's 32-bit mask word. The op list and the
// params are uniform across the warp; `top` holds the stack's top word.
// SETS: the program may hold an opcode of the extended set (set_word: the
// set loops and OP_GT_IMM). A program without one runs the SETS = false
// instance, which carries none of that code: the set loops cost the other
// chains registers and 2-5% of their time (PERF.md).
template <bool SETS>
__device__ __forceinline__ unsigned eval_word(const int* ops, int n_ops,
                                              const int* blk, const int* prm) {
  unsigned stk[MAX_STACK];
  unsigned top = 0u;
  int sp = 0;  // entries, top included
  for (int i = 0; i < n_ops; ++i) {
    const int* o = ops + i * OP_WIDTH;
    const int op = o[0];
    if (op == OP_AND || op == OP_OR) {
      const unsigned a = stk[sp - 2];
      top = op == OP_AND ? (a & top) : (a | top);
      --sp;
      continue;
    }
    if (op == OP_NOT) {
      top = ~top;
      continue;
    }
    unsigned r = 0u;
    if (SETS && op >= OP_SET32) {
      r = set_word(o, blk, prm);
    } else {
      switch (op) {
        case OP_TRUE:
          r = FULL;
          break;
        case OP_RANGE32: {
          const int lo = prm[o[2]], hi = prm[o[3]];
          if (lo <= hi) {
            const unsigned span = static_cast<unsigned>(hi) - static_cast<unsigned>(lo);
            r = word_of(blk + o[1] * SRC_INTS, [=](int v) {
              return static_cast<unsigned>(v) - static_cast<unsigned>(lo) <= span;
            });
          }
          break;
        }
        case OP_EQ32:
        case OP_EQ32_GUARD: {
          const int t = prm[o[2]];
          if (op == OP_EQ32 || prm[o[3]] > 0)
            r = word_of(blk + o[1] * SRC_INTS, [=](int v) { return v == t; });
          break;
        }
        case OP_RANGE_WIDE: {
          const unsigned long long klo = wide_key(prm[o[3]], prm[o[4]]);
          const unsigned long long khi = wide_key(prm[o[5]], prm[o[6]]);
          if (klo <= khi) {
            const unsigned long long span = khi - klo;
            r = word_of2(blk + o[1] * SRC_INTS, blk + o[2] * SRC_INTS,
                         [=](int h, int l) { return wide_key(h, l) - klo <= span; });
          }
          break;
        }
        case OP_EQ_WIDE_GUARD: {
          const int th = prm[o[3]], tl = prm[o[4]];
          if (prm[o[5]] > 0)
            r = word_of2(blk + o[1] * SRC_INTS, blk + o[2] * SRC_INTS,
                         [=](int h, int l) { return h == th && l == tl; });
          break;
        }
        default:
          break;
      }
    }
    if (sp > 0) stk[sp - 1] = top;
    top = r;
    ++sp;
  }
  return top;
}

// The byte slices of 4 rows x = (a, b, c, d): P_k = [byte k of a, b, c,
// d], k = 0..3 (query-independent, once a tile).
__device__ __forceinline__ int4 sliced(int4 x) {
  const unsigned t0 = __byte_perm(x.x, x.y, 0x5140);  // a0 b0 a1 b1
  const unsigned t1 = __byte_perm(x.z, x.w, 0x5140);  // c0 d0 c1 d1
  const unsigned t2 = __byte_perm(x.x, x.y, 0x7362);  // a2 b2 a3 b3
  const unsigned t3 = __byte_perm(x.z, x.w, 0x7362);  // c2 d2 c3 d3
  return make_int4(__byte_perm(t0, t1, 0x5410), __byte_perm(t0, t1, 0x7632),
                   __byte_perm(t2, t3, 0x5410), __byte_perm(t2, t3, 0x7632));
}

// Rewrite 4 staged payload rows in place as their byte slices.
__device__ __forceinline__ void byte_slice(int* v) {
  int4* v4 = reinterpret_cast<int4*>(v);
  *v4 = sliced(*v4);
}

// Sum of a byte-sliced payload block `v` over the rows set in `w`: per 4
// rows, the rows' 0/1 mask bytes dotted with each byte slice (__dp4a; the
// top slice signed). Each slice's sum over 32 rows is under 2^13 in
// magnitude, so the int64 recombination is exact for any int32.
__device__ __forceinline__ long long masked_sum(const int* v, unsigned w) {
  const int4* v4 = reinterpret_cast<const int4*>(v);
  unsigned s0 = 0u, s1 = 0u, s2 = 0u;
  int s3 = 0;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int4 p = v4[q];
    // bit i of the nibble -> byte i (shifted copies 7 bits apart: no carry)
    const unsigned m = (((w >> (4 * q)) & 0xFu) * 0x00204081u) & 0x01010101u;
    s0 = __dp4a(static_cast<unsigned>(p.x), m, s0);
    s1 = __dp4a(static_cast<unsigned>(p.y), m, s1);
    s2 = __dp4a(static_cast<unsigned>(p.z), m, s2);
    s3 = __dp4a(p.w, static_cast<int>(m), s3);
  }
  return static_cast<long long>(s0) + (static_cast<long long>(s1) << 8) +
         (static_cast<long long>(s2) << 16) + static_cast<long long>(s3) * (1LL << 24);
}

// Slot words of the staged slot blocks `sv` for slots [base, base + n):
// s_sw[j * 32 + l] has bit r set where row r of block l holds slot
// base + j. The whole CTA builds them (it must reach this call together).
__device__ __forceinline__ void slot_words(unsigned* s_sw, const int* sv,
                                           int base, int n) {
  for (int i = threadIdx.x; i < n * 32; i += blockDim.x) s_sw[i] = 0u;
  __syncthreads();
  const int l = threadIdx.x & 31;
  const int4* v4 = reinterpret_cast<const int4*>(sv + l * BLOCK_STRIDE);
  for (int q = threadIdx.x >> 5; q < 8; q += blockDim.x >> 5) {
    const int4 x = v4[q];
    const int v[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      // unsigned: slot -1, and what a dead tail block holds, fall outside
      const unsigned j =
          static_cast<unsigned>(v[k]) - static_cast<unsigned>(base);
      if (j < static_cast<unsigned>(n))
        atomicOr(s_sw + j * 32 + l, 1u << (4 * q + k));
    }
  }
  __syncthreads();
}

// The query's param row into the warp's s_prm (the caller syncs the warp).
__device__ __forceinline__ void load_params(int* s_prm, const int* pmat,
                                            int b, int P, int lane) {
  for (int i = lane; i < P; i += 32)
    s_prm[i] = pmat[static_cast<long long>(b) * P + i];
}

// MODE BLOCKS: chain_blocks (counts [B, n_blocks] + sums [B, n_aux,
// n_blocks]; n_aux payloads). COUNTS: chain_counts (counts
// [B, n_blocks / 4]; n_aux 0). SLOTS: chain_slot_counts (counts
// [B, ns, n_blocks]; n_aux 1, the slot plane; qb queries' words kept at a
// time when ns > SLOT_CHUNK). Four CTAs of 8 warps an SM: the bounds keep
// every mode within 64 registers a thread (SLOTS spills a few bytes).
template <int MODE, bool SETS>
__global__ void __launch_bounds__(CHAIN_THREADS, 4)
chain_tile_kernel(const __grid_constant__ ChainSrc src, int n_planes,
                  int n_aux, const int* __restrict__ pmat, int B, int P,
                  const int* __restrict__ ops, int n_ops,
                  const signed char* __restrict__ avalid, long long n_blocks,
                  int stages, int ns, int qb, int* __restrict__ counts,
                  long long* __restrict__ sums) {
  extern __shared__ __align__(16) unsigned char tile_smem[];
  const int n_src = n_planes + n_aux;
  const int stage_bytes = n_src * SRC_INTS * 4 + AV_BYTES;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  int* s_ops = reinterpret_cast<int*>(tile_smem + stages * stage_bytes);
  int* s_prm = s_ops + n_ops * OP_WIDTH + warp * P;
  // SLOTS: the chunk's slot words, then the kept query words
  unsigned* s_sw =
      reinterpret_cast<unsigned*>(s_ops + n_ops * OP_WIDTH + n_warps * P);
  unsigned* s_qw = s_sw + SLOT_CHUNK * 32;
  for (int i = threadIdx.x; i < n_ops * OP_WIDTH; i += blockDim.x)
    s_ops[i] = ops[i];

  const long long n_tiles = (n_blocks + TILE_BLOCKS - 1) / TILE_BLOCKS;
  long long tile = blockIdx.x;
  if (tile < n_tiles) stage_tile(tile_smem, src, n_src, avalid, n_blocks, tile);
  cp_async_commit();
  for (int it = 0; tile < n_tiles; ++it, tile += gridDim.x) {
    const long long next = tile + gridDim.x;
    if (stages == 2) {
      if (next < n_tiles)
        stage_tile(tile_smem + ((it + 1) & 1) * stage_bytes, src, n_src, avalid,
                   n_blocks, next);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    unsigned char* buf = tile_smem + (stages == 2 ? (it & 1) * stage_bytes : 0);
    if (MODE == BLOCKS && n_aux > 0) {
      int* pv = reinterpret_cast<int*>(buf) + n_planes * SRC_INTS;
      for (int i = threadIdx.x; i < n_aux * TILE_BLOCKS * 8; i += blockDim.x)
        byte_slice(pv + (i >> 8) * SRC_INTS + ((i >> 3) & 31) * BLOCK_STRIDE +
                   (i & 7) * 4);
      __syncthreads();
    }
    const long long g = tile * TILE_BLOCKS + lane;
    const bool live = g < n_blocks;
    const uint4* a4 = reinterpret_cast<const uint4*>(
        buf + n_src * SRC_INTS * 4 + lane * AV_STRIDE);
    const uint4 a0 = a4[0], a1 = a4[1];
    const unsigned av =
        live ? positive_bytes(a0.x) | positive_bytes(a0.y) << 4 |
                   positive_bytes(a0.z) << 8 | positive_bytes(a0.w) << 12 |
                   positive_bytes(a1.x) << 16 | positive_bytes(a1.y) << 20 |
                   positive_bytes(a1.z) << 24 | positive_bytes(a1.w) << 28
             : 0u;
    const int* blk = reinterpret_cast<const int*>(buf) + lane * BLOCK_STRIDE;
    if (MODE == SLOTS) {
      const int* sv = reinterpret_cast<const int*>(buf) + n_planes * SRC_INTS;
      const bool keep = ns > SLOT_CHUNK;
      for (int q0 = 0; q0 < B; q0 += qb) {
        const int q1 = min(B, q0 + qb);
        if (keep) {  // this warp's queries of the group, read back by it
          for (int b = q0 + warp; b < q1; b += n_warps) {
            load_params(s_prm, pmat, b, P, lane);
            __syncwarp();
            s_qw[(b - q0) * 32 + lane] =
                eval_word<SETS>(s_ops, n_ops, blk, s_prm) & av;
            __syncwarp();
          }
        }
        for (int base = 0; base < ns; base += SLOT_CHUNK) {
          const int n_here = min(SLOT_CHUNK, ns - base);
          slot_words(s_sw, sv, base, n_here);
          for (int b = q0 + warp; b < q1; b += n_warps) {
            unsigned w;
            if (keep) {
              w = s_qw[(b - q0) * 32 + lane];
            } else {
              load_params(s_prm, pmat, b, P, lane);
              __syncwarp();
              w = eval_word<SETS>(s_ops, n_ops, blk, s_prm) & av;
              __syncwarp();
            }
            if (live) {
              int* out =
                  counts + (static_cast<long long>(b) * ns + base) * n_blocks + g;
              for (int j = 0; j < n_here; ++j)
                out[j * n_blocks] = __popc(w & s_sw[j * 32 + lane]);
            }
          }
          __syncthreads();  // s_sw is rebuilt for the next chunk
        }
      }
    } else {
      for (int b = warp; b < B; b += n_warps) {
        load_params(s_prm, pmat, b, P, lane);
        __syncwarp();
        const unsigned w = eval_word<SETS>(s_ops, n_ops, blk, s_prm) & av;
        int c = __popc(w);
        if (MODE == COUNTS) {
          c += __shfl_down_sync(FULL, c, 1);
          c += __shfl_down_sync(FULL, c, 2);
          if (live && (lane & 3) == 0)
            counts[static_cast<long long>(b) * (n_blocks >> 2) + (g >> 2)] = c;
        } else if (live) {
          counts[static_cast<long long>(b) * n_blocks + g] = c;
          for (int l = 0; l < n_aux; ++l) {
            const long long s =
                w ? masked_sum(blk + (n_planes + l) * SRC_INTS, w) : 0LL;
            sums[(static_cast<long long>(b) * n_aux + l) * n_blocks + g] = s;
          }
        }
        __syncwarp();  // s_prm is rewritten by the next query
      }
    }
    __syncthreads();  // the buffer is restaged next
    if (stages == 1) {
      if (next < n_tiles) stage_tile(tile_smem, src, n_src, avalid, n_blocks, next);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();
}

// gather_rows: out[b] = op[idx[b]] for rows of row_vec 16-byte words.
// Bound on the H100: HBM bytes, each distinct picked row read once and B
// rows written (c7 at B = 128: 51 MB read, 205 MB written). Design: one
// CTA per work item of GR_CHUNK words (16 KB), items chunk-major: CTA i
// copies chunk i / B of row idx[i % B], so the CTAs in flight copy one
// stretch of every picked row and a row picked twice is read the second
// time from L2. A thread starts GR_UNROLL 16-byte loads on the read-only
// path before its stores, neighbouring threads on neighbouring words. The
// stores are streaming (st.global.cs, evict-first), so the B written rows
// do not push the picked rows out of the 50 MB L2. (A persistent grid of
// the resident CTAs walking the same items, and 1-D bulk copies through
// shared memory, both copied slower on the card.) The index lives in
// device memory (the TPU kernel's scalar prefetch) and is clamped into
// [0, n_rows), so a bad index cannot read outside the operand; callers
// clamp it already.
constexpr int GR_THREADS = 256;
constexpr int GR_UNROLL = 4;
constexpr int GR_CHUNK = GR_THREADS * GR_UNROLL;

__global__ void __launch_bounds__(GR_THREADS)
gather_rows_kernel(const int* __restrict__ idx, int B,
                   const int4* __restrict__ op, long long n_rows,
                   long long row_vec, int4* __restrict__ out) {
  const long long c = blockIdx.x / B;
  const int b = static_cast<int>(blockIdx.x - c * B);
  const long long r =
      min(max(static_cast<long long>(__ldg(idx + b)), 0LL), n_rows - 1);
  const int4* src = op + r * row_vec;
  int4* dst = out + b * row_vec;
  const long long end = min((c + 1) * GR_CHUNK, row_vec);
  const long long w0 = c * GR_CHUNK + threadIdx.x;
  int4 v[GR_UNROLL];
#pragma unroll
  for (int u = 0; u < GR_UNROLL; ++u) {
    const long long w = w0 + u * GR_THREADS;
    if (w < end) v[u] = __ldg(src + w);
  }
#pragma unroll
  for (int u = 0; u < GR_UNROLL; ++u) {
    const long long w = w0 + u * GR_THREADS;
    if (w < end) __stcs(dst + w, v[u]);
  }
}

// fused_metrics: per query b of a [B, T] byte mask, the exact count, int64
// sum, min and max of an int32 plane [T] over the rows whose mask byte is
// nonzero.
//
// Bound on the H100: HBM bytes, each of the B mask rows and the plane read
// once per batch (c5 at B = 128: 1.32 GB, 0.395 ms), beside 2 int32 ops per
// (row, query) for count and sum and 2 more for min and max.
//
// Design. A persistent grid of the card's resident CTAs walks 4096-row
// tiles of the plane (tile, tile + grid, ...). A tile is staged once in
// shared memory by 16-byte cp.async copies, FM_STAGES - 1 tiles ahead (a
// ring, so a small batch still keeps the plane's bytes in flight), and
// rewritten once as byte slices (sliced); then the CTA loops the B queries
// over it, so the plane is read once per batch (per FM_QB queries past
// 512). Warp w takes the units u = w, w + 8, ...: a unit is one query over
// the tile, or where B < 8 one of S = 2, 4 or 8 segments of it, so small
// batches still use most warps. Lane l reads 16 consecutive mask bytes
// with one 16-byte streaming load (4-byte loads where T % 16 != 0 or in a
// tile tail), so a warp reads 512 consecutive bytes of the query's row; a
// unit's loads are all issued before its math, and the next unit's before
// this one's warp reduction, so loads stay in flight across units. Per 4
// rows: nonzero_bytes turns the 4 mask bytes into 0x80 / 0x00 (three
// integer ops; nonzero = selected for bool, int8 and uint8 masks), one
// __dp4a against 0x01010101 counts them, and four __dp4a dot them with the
// rows' byte slices. No int64 add per row: the slice sums stay in 32 bits
// until the unit ends (bounds below), are summed across the warp with
// redux.sync (__reduce_add_sync) and recombined in int64 once per (tile,
// query) by lane 0 into the unit's slot in shared memory (each slot is
// owned by one warp: no atomics). min / max only in the MINMAX
// instantiation: the selected bytes' sign fans out into a row mask (prmt),
// one lop3 per row and side puts the sentinel on unselected rows, and
// Hopper's three-way __vimin3_s32 / __vimax3_s32 fold two rows per
// instruction. No float anywhere. Tile, stages and occupancy were chosen
// on the card among 1024-4096-row tiles, 3-8 stages and 3-4 CTAs an SM
// (scripts/torch_fused_variants.py): 4096 rows and 3 stages read B = 1
// fastest at the same B = 128 time.
//
// Exactness bounds (the 0x80 mask bytes scale every dot by 128): per 4 rows
// an unsigned slice dot is at most 4 * 255 * 128 = 130,560 and the signed
// top slice's at most 4 * 128 * 128 = 65,536 in magnitude (its mask bytes
// read as -128, so it holds minus the slice sum); a lane covers at most
// FM_STEPS * 4 = 32 groups of 4 rows per unit, so across the warp the
// unsigned sums stay at most 32 * 32 * 130,560 < 2^27, the signed one at
// most 32 * 32 * 65,536 = 2^26 in magnitude, and the count dot (at most
// 512 per 4 rows) at most 2^19. 128 * the unit's sum is then recombined in
// int64 and shifted right by 7 (exact: a multiple of 128). A CTA's count
// stays below T < 2^31, so its slots and partials hold it in int32.
//
// Reduction across CTAs without fills or atomics on pre-set outputs: at the
// end each CTA writes one partial per query into a scratch [B, grid] (int64
// sums, int32 counts, mins and maxes); a second small launch folds each
// query's partials (one warp per query) and writes the four outputs,
// sentinels included, `rep` times each (a shared mask run once at B = 1
// writes its result to all of the batch's rows).
constexpr int FM_THREADS = 256;
constexpr int FM_WARPS = FM_THREADS / 32;
constexpr int FM_TILE = 4096;             // plane rows staged per tile
constexpr int FM_STEPS = FM_TILE / 512;   // 16-row chunks per lane per unit
constexpr int FM_QB = 512;                // queries whose slots a CTA holds
constexpr int FM_STAGES = 3;             // plane tiles in flight per CTA
constexpr int FM_SMEM = (FM_STAGES + 1) * FM_TILE * 4 + FM_QB * 20;

// 0x80 in each byte of m that is nonzero, 0 elsewhere
__device__ __forceinline__ unsigned nonzero_bytes(unsigned m) {
  return (((m & 0x7f7f7f7fu) + 0x7f7f7f7fu) | m) & 0x80808080u;
}

// 0xffffffff where byte SEL - 8 of n has its top bit set, else 0 (prmt's
// sign-replicating selector)
template <unsigned SEL>
__device__ __forceinline__ int fan_out(unsigned n) {
  unsigned r;
  asm("prmt.b32 %0, %1, %2, %3;"
      : "=r"(r)
      : "r"(n), "r"(0u), "n"(SEL * 0x1111u));
  return static_cast<int>(r);
}

// Shared-memory slot of 16-byte group g of a tile (4 rows): lane l of a
// quarter warp reads group 4l + k, so the xor spreads the 8 lanes over the 8
// bank quads.
__device__ __forceinline__ int fm_swz(int g) { return g ^ ((g >> 3) & 3); }

// Copy tile `tile` of the plane into `dst` (swizzled groups); groups past T
// are not copied (their mask bytes are read as 0).
__device__ __forceinline__ void stage_plane(int* dst, const int* plane,
                                            long long T, long long tile) {
  const long long row0 = tile * FM_TILE;
  const long long left = T - row0;
  const int rows = left < FM_TILE ? static_cast<int>(left) : FM_TILE;
  for (int g = threadIdx.x; g * 4 < rows; g += blockDim.x)
    cp_async16(dst + fm_swz(g) * 4, plane + row0 + g * 4);
}

// Lane's 16-byte mask chunks of unit u (query q0 + u / S, segment u % S
// of the tile at row0): one streaming 16-byte load each, or 4-byte loads
// where the rows are not 16-byte aligned or the tile ends; 0 past T.
__device__ __forceinline__ void load_unit(uint4 (&mv)[FM_STEPS],
                                          const unsigned char* mask,
                                          long long T, long long row0,
                                          int rows, int q0, int u, int S,
                                          int steps, int lane, bool vec16) {
  const unsigned char* mrow =
      mask + static_cast<long long>(q0 + u / S) * T + row0;
  const int seg = u % S;
#pragma unroll
  for (int jj = 0; jj < FM_STEPS; ++jj) {
    mv[jj] = make_uint4(0u, 0u, 0u, 0u);
    if (jj >= steps) continue;
    const int r = (seg * steps + jj) * 512 + lane * 16;
    if (vec16 && r + 16 <= rows) {
      mv[jj] = __ldcs(reinterpret_cast<const uint4*>(mrow + r));
    } else {
      const unsigned* m32 = reinterpret_cast<const unsigned*>(mrow + r);
      if (r < rows) mv[jj].x = __ldcs(m32);
      if (r + 4 < rows) mv[jj].y = __ldcs(m32 + 1);
      if (r + 8 < rows) mv[jj].z = __ldcs(m32 + 2);
      if (r + 12 < rows) mv[jj].w = __ldcs(m32 + 3);
    }
  }
}

template <bool MINMAX>
__global__ void __launch_bounds__(FM_THREADS, 3)
fused_metrics_kernel(const unsigned char* __restrict__ mask,
                     const int* __restrict__ plane, long long T, int B,
                     int S, bool vec16, long long* __restrict__ part_sum,
                     int* __restrict__ part_cnt, int* __restrict__ part_mn,
                     int* __restrict__ part_mx) {
  extern __shared__ __align__(16) unsigned char fm_smem[];
  int* raw = reinterpret_cast<int*>(fm_smem);  // FM_STAGES stages
  int4* sl = reinterpret_cast<int4*>(fm_smem + FM_STAGES * FM_TILE * 4);
  long long* s_sum =
      reinterpret_cast<long long*>(fm_smem + (FM_STAGES + 1) * FM_TILE * 4);
  int* s_cnt = reinterpret_cast<int*>(s_sum + FM_QB);
  int* s_mn = s_cnt + FM_QB;
  int* s_mx = s_mn + FM_QB;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long n_tiles = (T + FM_TILE - 1) / FM_TILE;
  const int steps = FM_STEPS / S;

  for (int q0 = 0; q0 < B; q0 += FM_QB) {
    const int nu = min(FM_QB, B - q0) * S;
    for (int i = threadIdx.x; i < nu; i += blockDim.x) {
      s_sum[i] = 0;
      s_cnt[i] = 0;
      s_mn[i] = INT_MAX;
      s_mx[i] = INT_MIN;
    }
    long long tile = blockIdx.x;
    // the first FM_STAGES - 1 tiles in flight, then one more per tile
#pragma unroll
    for (int k = 0; k < FM_STAGES - 1; ++k) {
      const long long t = tile + static_cast<long long>(k) * gridDim.x;
      if (t < n_tiles) stage_plane(raw + k * FM_TILE, plane, T, t);
      cp_async_commit();
    }
    for (int it = 0; tile < n_tiles; ++it, tile += gridDim.x) {
      const long long ahead =
          tile + static_cast<long long>(FM_STAGES - 1) * gridDim.x;
      if (ahead < n_tiles)
        stage_plane(raw + ((it + FM_STAGES - 1) % FM_STAGES) * FM_TILE,
                    plane, T, ahead);
      cp_async_commit();
      const long long row0 = tile * FM_TILE;
      const long long left = T - row0;
      const int rows = left < FM_TILE ? static_cast<int>(left) : FM_TILE;
      // a unit's mask chunks are loaded before any is used (the warp's first
      // unit's while the tile lands), and the next unit's are in flight
      // during this unit's warp reduction
      uint4 mv[FM_STEPS];
      if (warp < nu) load_unit(mv, mask, T, row0, rows, q0, warp, S, steps,
                               lane, vec16);
      cp_async_wait<FM_STAGES - 1>();
      __syncthreads();
      const int4* rv =
          reinterpret_cast<const int4*>(raw + (it % FM_STAGES) * FM_TILE);
      for (int g = threadIdx.x; g < FM_TILE / 4; g += blockDim.x)
        sl[g] = sliced(rv[g]);
      __syncthreads();

      for (int u = warp; u < nu; u += FM_WARPS) {
        const int seg = u % S;
        unsigned c = 0u, a0 = 0u, a1 = 0u, a2 = 0u;
        int a3 = 0, lo = INT_MAX, hi = INT_MIN;
#pragma unroll
        for (int jj = 0; jj < FM_STEPS; ++jj) {
          if (jj >= steps) break;
          const int r = (seg * steps + jj) * 512 + lane * 16;
          const unsigned w4[4] = {mv[jj].x, mv[jj].y, mv[jj].z, mv[jj].w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const unsigned n = nonzero_bytes(w4[k]);
            const int g = fm_swz((r >> 2) + k);
            const int4 p = sl[g];
            c = __dp4a(n, 0x01010101u, c);
            a0 = __dp4a(static_cast<unsigned>(p.x), n, a0);
            a1 = __dp4a(static_cast<unsigned>(p.y), n, a1);
            a2 = __dp4a(static_cast<unsigned>(p.z), n, a2);
            a3 = __dp4a(p.w, static_cast<int>(n), a3);
            if (MINMAX) {
              const int4 v = rv[g];
              const int f0 = fan_out<8>(n), f1 = fan_out<9>(n);
              const int f2 = fan_out<10>(n), f3 = fan_out<11>(n);
              lo = __vimin3_s32(lo, (v.x & f0) | (INT_MAX & ~f0),
                                (v.y & f1) | (INT_MAX & ~f1));
              lo = __vimin3_s32(lo, (v.z & f2) | (INT_MAX & ~f2),
                                (v.w & f3) | (INT_MAX & ~f3));
              hi = __vimax3_s32(hi, (v.x & f0) | (INT_MIN & ~f0),
                                (v.y & f1) | (INT_MIN & ~f1));
              hi = __vimax3_s32(hi, (v.z & f2) | (INT_MIN & ~f2),
                                (v.w & f3) | (INT_MIN & ~f3));
            }
          }
        }
        if (u + FM_WARPS < nu)
          load_unit(mv, mask, T, row0, rows, q0, u + FM_WARPS, S, steps, lane,
                    vec16);
        c = __reduce_add_sync(FULL, c);
        a0 = __reduce_add_sync(FULL, a0);
        a1 = __reduce_add_sync(FULL, a1);
        a2 = __reduce_add_sync(FULL, a2);
        a3 = __reduce_add_sync(FULL, a3);
        if (MINMAX) {
          lo = __reduce_min_sync(FULL, lo);
          hi = __reduce_max_sync(FULL, hi);
        }
        if (lane == 0) {
          // 128 * the unit's sum; a3 holds minus 128 * the top slice's sum
          const long long t128 = static_cast<long long>(a0) +
                                 (static_cast<long long>(a1) << 8) +
                                 (static_cast<long long>(a2) << 16) -
                                 static_cast<long long>(a3) * (1LL << 24);
          s_sum[u] += t128 >> 7;
          s_cnt[u] += static_cast<int>(c >> 7);
          if (MINMAX) {
            s_mn[u] = min(s_mn[u], lo);
            s_mx[u] = max(s_mx[u], hi);
          }
        }
      }
      __syncthreads();  // the stage and the slices are rewritten next
    }
    cp_async_wait<0>();
    // the CTA's partial per query, its segments folded in order
    for (int i = threadIdx.x; i * S < nu; i += blockDim.x) {
      long long s = 0;
      int c = 0, lo = INT_MAX, hi = INT_MIN;
      for (int k = i * S; k < (i + 1) * S; ++k) {
        s += s_sum[k];
        c += s_cnt[k];
        lo = min(lo, s_mn[k]);
        hi = max(hi, s_mx[k]);
      }
      const long long o =
          static_cast<long long>(q0 + i) * gridDim.x + blockIdx.x;
      part_sum[o] = s;
      part_cnt[o] = c;
      if (MINMAX) {
        part_mn[o] = lo;
        part_mx[o] = hi;
      }
    }
    __syncthreads();  // the slots are reset for the next queries
  }
}

// One warp per query: fold its n_part partials and write the outputs at
// b * rep ... b * rep + rep - 1.
template <bool MINMAX>
__global__ void __launch_bounds__(FM_THREADS)
fused_metrics_fold(const long long* __restrict__ part_sum,
                   const int* __restrict__ part_cnt,
                   const int* __restrict__ part_mn,
                   const int* __restrict__ part_mx, int n_part, int B,
                   int rep, long long* __restrict__ cnt,
                   long long* __restrict__ sum, int* __restrict__ mn,
                   int* __restrict__ mx) {
  const int lane = threadIdx.x & 31;
  const long long b =
      static_cast<long long>(blockIdx.x) * FM_WARPS + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp
  const long long base = b * n_part;
  long long c = 0, s = 0;
  int lo = INT_MAX, hi = INT_MIN;
  for (int i = lane; i < n_part; i += 32) {
    c += part_cnt[base + i];
    s += part_sum[base + i];
    if (MINMAX) {
      lo = min(lo, part_mn[base + i]);
      hi = max(hi, part_mx[base + i]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    c += __shfl_xor_sync(FULL, c, off);
    s += __shfl_xor_sync(FULL, s, off);
    if (MINMAX) {
      lo = min(lo, __shfl_xor_sync(FULL, lo, off));
      hi = max(hi, __shfl_xor_sync(FULL, hi, off));
    }
  }
  for (int r = lane; r < rep; r += 32) {
    const long long o = b * rep + r;
    cnt[o] = c;
    sum[o] = s;
    if (MINMAX) {
      mn[o] = lo;
      mx[o] = hi;
    }
  }
}

// dense_buckets: per query b of a [B, T] byte mask, the exact int64 count of
// the rows whose mask byte is nonzero in each bucket j of a static int32
// bucket-id plane bid [T] (ids outside [0, nb) match nothing), or (SUM)
// the exact int64 sum of a static int32 payload [T] over those rows.
//
// Bound on the H100: HBM bytes, the bid plane and the payload read once per
// query tile and each mask row once (c3's sum at B = 1: 90 MB, 0.027 ms),
// beside one 32-bit shared-memory atomic per (selected row, query, piece).
//
// Design. A histogram of few buckets is a streaming reduction with the
// partials in shared memory. Each CTA takes one item: a tile of qt queries,
// a tile of nbt buckets and a chunk of rows (items ordered with the query
// tiles fastest, so the CTAs in flight share their chunk's plane reads in
// L2). A warp step covers 512 rows: lane l keeps rows 4l .. 4l + 3 of each
// of its four 128-row groups in registers (16-byte loads of bid and the
// payload), so they are read once for all qt queries; per query the lane
// loads its four 4-byte mask words (the next query's are in flight) and adds
// each selected row into the CTA's table with a 32-bit shared atomic. The
// table is privatized C ways (C a power of two up to 32, as many as fit qt x
// nbt buckets in the wrapper's shared-memory budget): lane l adds into copy
// l % C, and copy c of bucket j is word j * C + c, so at C = 32 no two lanes
// share a bank or an address whatever the ids (sorted ids included), and
// with fewer copies at most 32 / C lanes do. No 64-bit atomics: counts are
// 32-bit, and a sum adds two 16-bit pieces of the payload (the low 16
// bits unsigned and the high 16 bits signed, two counters). The table is
// folded into the item's int64 partial every `flush` rows, at most
// DB_FLUSH_ROWS for a sum, so a low piece's counter holds at most 65,536 x
// 65,535 < 2^32 and a high piece's, signed, a value in [-2^31, 2^31); a
// count counter at most T < 2^31. The fold gives each bucket a group of C lanes, lane c reading copy
// c, summed by shuffles in int64, and zeroes the table. Each item writes its
// partials to a scratch [B, nb, n_rc] (the row chunk innermost), and a
// second launch adds each (query, bucket)'s n_rc partials, a warp each. No
// global atomics, so the result is deterministic, and every step is an
// integer add, so it is exact. The wrapper (ops/kernels.py dense_tile,
// dense_chunks) sets qt, C, nbt, the chunks and the flush from (B, nb, SUM,
// T), the card's resident CTAs and this layout, which it reads through
// tat_dense_buckets_layout.
constexpr int DB_THREADS = 256;
constexpr int DB_WARPS = DB_THREADS / 32;
constexpr int DB_GROUPS = 4;                      // 128-row groups a warp step
constexpr int DB_WARP_ROWS = DB_GROUPS * 128;     // rows a warp step
constexpr int DB_STEP = DB_WARPS * DB_WARP_ROWS;  // rows a CTA step (4096)
constexpr int DB_FLUSH_ROWS = 1 << 16;            // rows a sum's pieces hold
constexpr int DB_COPIES = 32;                     // most copies of a table
// a table's shared memory: two CTAs of the largest stay resident on an SM
constexpr int DB_TABLE_MAX = 112640;

// Lane's rows r = s + 128k + 4 lane + i of a warp step: bucket ids (-1 at
// and past `end`, so they match nothing) and, with PAY, payloads.
template <bool PAY>
__device__ __forceinline__ void db_rows(int4 (&b)[DB_GROUPS],
                                        int4 (&v)[DB_GROUPS],
                                        const int* bid, const int* pay,
                                        long long s, long long end, int lane,
                                        bool vec) {
#pragma unroll
  for (int k = 0; k < DB_GROUPS; ++k) {
    const long long r = s + k * 128 + lane * 4;
    if (vec && r + 4 <= end) {
      b[k] = __ldg(reinterpret_cast<const int4*>(bid + r));
      if (PAY) v[k] = __ldg(reinterpret_cast<const int4*>(pay + r));
    } else {
      int t[4] = {-1, -1, -1, -1}, u[4] = {0, 0, 0, 0};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (r + i < end) {
          t[i] = bid[r + i];
          if (PAY) u[i] = pay[r + i];
        }
      }
      b[k] = make_int4(t[0], t[1], t[2], t[3]);
      v[k] = make_int4(u[0], u[1], u[2], u[3]);
    }
  }
}

// The same rows' mask bytes of one query row `mrow`, four to a word (byte i
// = row i of the group; 0 at and past `end`).
__device__ __forceinline__ void db_mask(unsigned (&m)[DB_GROUPS],
                                        const unsigned char* mrow,
                                        long long s, long long end, int lane,
                                        bool vec) {
#pragma unroll
  for (int k = 0; k < DB_GROUPS; ++k) {
    const long long r = s + k * 128 + lane * 4;
    if (vec && r + 4 <= end) {
      m[k] = __ldcs(reinterpret_cast<const unsigned*>(mrow + r));
    } else {
      unsigned w = 0u;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (r + i < end) w |= static_cast<unsigned>(mrow[r + i]) << (8 * i);
      m[k] = w;
    }
  }
}

// Fold the table's nq x nj buckets into the item's int64 partials (the
// first flush of an item writes them, later ones add) and zero the table:
// a group of C lanes per bucket, lane c reading copy c, summed by
// shuffles within the group (the trip count is the CTA's, so every lane
// reaches every shuffle).
template <bool SUM>
__device__ __forceinline__ void db_fold(unsigned* tab, int nq, int nj,
                                        int C, int q0, int j0, int nb,
                                        int rc, int n_rc, bool first,
                                        long long* part) {
  constexpr int WP = SUM ? 2 : 1;
  const int c = threadIdx.x & (C - 1);
  const int groups = DB_THREADS / C;
  const int n = nq * nj;
  for (int e0 = 0; e0 < n; e0 += groups) {
    const int e = e0 + static_cast<int>(threadIdx.x) / C;
    const int q = e / nj, j = e - q * nj;
    long long s = 0;
    if (e < n) {
      unsigned* t = tab + (q * WP * nj + j) * C + c;
      if (!SUM) {
        s = t[0];
      } else {
        s = static_cast<long long>(t[0]) +
            static_cast<long long>(static_cast<int>(t[nj * C])) * 65536LL;
        t[nj * C] = 0u;
      }
      t[0] = 0u;
    }
    for (int off = C / 2; off > 0; off >>= 1)
      s += __shfl_xor_sync(FULL, s, off);
    if (e < n && c == 0) {
      long long* o =
          part + (static_cast<long long>(q0 + q) * nb + j0 + j) * n_rc + rc;
      *o = first ? s : *o + s;
    }
  }
}

// One item per CTA: item = (rc x n_bt + bt) x n_qt + qi (query tile qi,
// bucket tile bt, row chunk rc); the grid is n_qt x n_bt x n_rc.
template <bool SUM>
__global__ void __launch_bounds__(DB_THREADS, 2)
dense_buckets_kernel(const int* __restrict__ bid,
                     const int* __restrict__ pay,
                     const unsigned char* __restrict__ mask, long long T,
                     int B, int nb, int qt, int C, int nbt, int n_qt,
                     int n_bt, long long chunk, long long flush, bool vec,
                     long long* __restrict__ part) {
  extern __shared__ unsigned db_tab[];
  constexpr int WP = SUM ? 2 : 1;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x % n_qt;
  const int bt = (blockIdx.x / n_qt) % n_bt;
  const int rc = blockIdx.x / (n_qt * n_bt);
  const int n_rc = gridDim.x / (n_qt * n_bt);
  const int q0 = qi * qt, nq = min(qt, B - q0);
  const int j0 = bt * nbt, nj = min(nbt, nb - j0);
  const long long r0 = rc * chunk;
  const long long r1 = min(T, r0 + chunk);
  const int words = nq * WP * nj * C;
  for (int i = threadIdx.x; i < words; i += DB_THREADS) db_tab[i] = 0u;
  __syncthreads();
  const int cls = lane & (C - 1);
  const unsigned nju = static_cast<unsigned>(nj);
  const unsigned j0u = static_cast<unsigned>(j0);
  for (long long f0 = r0; f0 < r1; f0 += flush) {
    const long long f1 = min(r1, f0 + flush);
    for (long long s = f0 + warp * DB_WARP_ROWS; s < f1; s += DB_STEP) {
      int4 b[DB_GROUPS], v[DB_GROUPS];
      db_rows<SUM>(b, v, bid, pay, s, f1, lane, vec);
      unsigned m[DB_GROUPS], mn[DB_GROUPS];
      db_mask(m, mask + static_cast<long long>(q0) * T, s, f1, lane, vec);
      for (int q = 0; q < nq; ++q) {
        if (q + 1 < nq)
          db_mask(mn, mask + static_cast<long long>(q0 + q + 1) * T, s, f1,
                  lane, vec);
        unsigned* t = db_tab + q * WP * nj * C + cls;
#pragma unroll
        for (int k = 0; k < DB_GROUPS; ++k) {
          const int ids[4] = {b[k].x, b[k].y, b[k].z, b[k].w};
          const int vals[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            // ids below j0 (and -1) wrap past nj
            const unsigned id = static_cast<unsigned>(ids[i]) - j0u;
            if (((m[k] >> (8 * i)) & 0xffu) != 0u && id < nju) {
              unsigned* cnt = t + id * C;
              if (!SUM) {
                atomicAdd(cnt, 1u);
              } else {
                atomicAdd(cnt, static_cast<unsigned>(vals[i]) & 0xffffu);
                atomicAdd(cnt + nj * C, static_cast<unsigned>(vals[i] >> 16));
              }
            }
          }
        }
#pragma unroll
        for (int k = 0; k < DB_GROUPS; ++k) m[k] = mn[k];
      }
    }
    __syncthreads();
    db_fold<SUM>(db_tab, nq, nj, C, q0, j0, nb, rc, n_rc, f0 == r0, part);
    __syncthreads();
  }
}

// One warp per (query, bucket) output i: its n_rc partials summed.
__global__ void __launch_bounds__(DB_THREADS)
dense_buckets_fold(const long long* __restrict__ part, int n_rc,
                   long long n_out, long long* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long i =
      static_cast<long long>(blockIdx.x) * DB_WARPS + (threadIdx.x >> 5);
  if (i >= n_out) return;  // the whole warp
  long long s = 0;
  for (int r = lane; r < n_rc; r += 32) s += part[i * n_rc + r];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
  if (lane == 0) out[i] = s;
}

// dense_extremes: per query b of a [B, T] byte mask and bucket j of a
// static int32 bucket-id plane bid [T] (ids outside [0, nb) match nothing),
// the exact min and / or max of a static payload over the rows whose mask
// byte is nonzero: an int32 plane (int32 out, I32_MAX / I32_MIN for an
// empty bucket) or a wide (hi, lo) pair (int64 out in the rm domain,
// hi * 2^32 + (lo + 2^31), I64_MAX / I64_MIN for an empty bucket). The min
// and the max may read different payloads (a multi-valued field's per-doc
// min and max planes). Replaces the JAX package's ops/reductions.py
// dense_bucket_min / dense_bucket_max (:327, :338), XLA one-hot
// reductions with no Pallas kernel; the port ran them as two int64
// scatter_reduce_ passes whose atomics serialize on the few buckets.
//
// Bound on the H100: HBM bytes, the bid plane and the payload planes read
// once per query tile and each mask row once (a 41.3M-row wide payload at
// B = 1: 165 MB of ids, 41 MB of mask, 330 MB of (hi, lo): 0.160 ms at
// 3.35 TB/s).
//
// Design: dense_buckets' streaming pass (same items, warp steps, db_rows /
// db_mask loads and C-way privatized table), with a table of 64-bit
// extremes. Each payload value becomes an order-preserving unsigned key
// once per warp step (a wide pair: its rm value with the sign bit flipped;
// a narrow value: its bits with the sign bit flipped), kept in registers
// for all the tile's queries. A selected row reads its copy's current
// extreme and only where the key improves on it issues Hopper's native
// 64-bit shared atomicMin / atomicMax, so after the first rows of a chunk
// almost no row costs an atomic. An item folds its table once, at the end
// of its chunk (extremes cannot overflow), by shuffles within each group
// of C lanes, into a scratch [ne, B, nb, n_rc] of keys; a second launch
// folds each output's n_rc keys, a warp each, and writes it in the
// payload's domain. No global atomics, no float: exact and deterministic.
// The wrapper (ops/kernels.py extremes_tile, dense_chunks) sets qt, C, nbt
// and the chunks as for dense_buckets, with 8 bytes per extreme a bucket.
constexpr unsigned long long DE_MIN_NONE = ~0ull;  // a min's identity key
constexpr unsigned long long DE_SIGN = 1ull << 63;

// The key of each of the lane's 16 rows of a warp step (as db_rows lays
// them out) from payload a (narrow) or the pair (a, b) = (hi, lo) (wide).
template <bool WIDE>
__device__ __forceinline__ void de_keys(
    unsigned long long (&key)[DB_GROUPS * 4], const int* a, const int* b,
    long long s, long long end, int lane, bool vec) {
  int4 x[DB_GROUPS], y[DB_GROUPS];
  if (WIDE)
    db_rows<true>(x, y, a, b, s, end, lane, vec);
  else
    db_rows<false>(x, y, a, nullptr, s, end, lane, vec);
#pragma unroll
  for (int k = 0; k < DB_GROUPS; ++k) {
    const int xs[4] = {x[k].x, x[k].y, x[k].z, x[k].w};
    const int ys[4] = {y[k].x, y[k].y, y[k].z, y[k].w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned long long lo =
          static_cast<unsigned>(WIDE ? ys[i] : xs[i]) ^ 0x80000000u;
      key[k * 4 + i] =
          WIDE ? (static_cast<unsigned long long>(
                      static_cast<unsigned>(xs[i]) ^ 0x80000000u)
                  << 32) | lo
               : lo;
    }
  }
}

__device__ __forceinline__ unsigned long long de_pick(bool is_min,
                                                      unsigned long long a,
                                                      unsigned long long b) {
  return is_min ? (b < a ? b : a) : (b > a ? b : a);
}

// Fold the table's nq x ne x nj entries (ne extremes: the min's first
// where asked) into the item's keys in `part` [ne, B, nb, n_rc]: a group of
// C lanes per entry, lane c reading copy c, folded by shuffles within the
// group (the trip count is the CTA's, so every lane reaches every shuffle).
__device__ __forceinline__ void de_fold(const unsigned long long* tab,
                                        int nq, int ne, int nj, int C,
                                        bool do_min, int q0, int j0, int B,
                                        int nb, int rc, int n_rc,
                                        unsigned long long* part) {
  const int c = threadIdx.x & (C - 1);
  const int groups = DB_THREADS / C;
  const int n = nq * ne * nj;
  for (int e0 = 0; e0 < n; e0 += groups) {
    const int e = e0 + static_cast<int>(threadIdx.x) / C;
    const int q = e / (ne * nj), r = e - q * ne * nj;
    const int x = r / nj, j = r - x * nj;
    const bool is_min = do_min && x == 0;
    unsigned long long s = is_min ? DE_MIN_NONE : 0ull;
    if (e < n) s = tab[static_cast<long long>(e) * C + c];
    for (int off = C / 2; off > 0; off >>= 1)
      s = de_pick(is_min, s, __shfl_xor_sync(FULL, s, off));
    if (e < n && c == 0)
      part[((static_cast<long long>(x) * B + q0 + q) * nb + j0 + j) * n_rc +
           rc] = s;
  }
}

// One item per CTA, as dense_buckets_kernel's: item = (rc x n_bt + bt) x
// n_qt + qi. Payloads: (a0, b0) for every extreme asked, or with SEP (a0,
// b0) for the min and (a1, b1) for the max; b0, b1 null unless WIDE.
template <bool WIDE, bool SEP>
__global__ void __launch_bounds__(DB_THREADS, 2)
dense_extremes_kernel(const int* __restrict__ bid,
                      const int* __restrict__ a0, const int* __restrict__ b0,
                      const int* __restrict__ a1, const int* __restrict__ b1,
                      const unsigned char* __restrict__ mask, long long T,
                      int B, int nb, int qt, int C, int nbt, int n_qt,
                      int n_bt, long long chunk, bool vec, bool do_min,
                      bool do_max, unsigned long long* __restrict__ part) {
  extern __shared__ unsigned long long de_tab[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x % n_qt;
  const int bt = (blockIdx.x / n_qt) % n_bt;
  const int rc = blockIdx.x / (n_qt * n_bt);
  const int n_rc = gridDim.x / (n_qt * n_bt);
  const int q0 = qi * qt, nq = min(qt, B - q0);
  const int j0 = bt * nbt, nj = min(nbt, nb - j0);
  const long long r0 = rc * chunk;
  const long long r1 = min(T, r0 + chunk);
  const int ne = static_cast<int>(do_min) + static_cast<int>(do_max);
  // a query's entries: the min's nj x C words (where asked), the max's
  const int min_words = do_min ? nj * C : 0;
  const int per_q = ne * nj * C;
  for (int i = threadIdx.x; i < nq * per_q; i += DB_THREADS)
    de_tab[i] = i % per_q < min_words ? DE_MIN_NONE : 0ull;
  __syncthreads();
  const int cls = lane & (C - 1);
  const unsigned nju = static_cast<unsigned>(nj);
  const unsigned j0u = static_cast<unsigned>(j0);
  for (long long s = r0 + warp * DB_WARP_ROWS; s < r1; s += DB_STEP) {
    int4 b[DB_GROUPS], unused[DB_GROUPS];
    db_rows<false>(b, unused, bid, nullptr, s, r1, lane, vec);
    unsigned long long k0[DB_GROUPS * 4], k1[DB_GROUPS * 4];
    de_keys<WIDE>(k0, a0, b0, s, r1, lane, vec);
    if (SEP) de_keys<WIDE>(k1, a1, b1, s, r1, lane, vec);
    unsigned m[DB_GROUPS], mn[DB_GROUPS];
    db_mask(m, mask + static_cast<long long>(q0) * T, s, r1, lane, vec);
    for (int q = 0; q < nq; ++q) {
      if (q + 1 < nq)
        db_mask(mn, mask + static_cast<long long>(q0 + q + 1) * T, s, r1,
                lane, vec);
      unsigned long long* t = de_tab + q * per_q + cls;
#pragma unroll
      for (int k = 0; k < DB_GROUPS; ++k) {
        const int ids[4] = {b[k].x, b[k].y, b[k].z, b[k].w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // ids below j0 (and -1) wrap past nj
          const unsigned id = static_cast<unsigned>(ids[i]) - j0u;
          if (((m[k] >> (8 * i)) & 0xffu) != 0u && id < nju) {
            unsigned long long* w = t + id * C;
            if (do_min) {
              const unsigned long long v = k0[k * 4 + i];
              if (v < *reinterpret_cast<volatile unsigned long long*>(w))
                atomicMin(w, v);
            }
            if (do_max) {
              const unsigned long long v =
                  SEP ? k1[k * 4 + i] : k0[k * 4 + i];
              unsigned long long* x = w + min_words;
              if (v > *reinterpret_cast<volatile unsigned long long*>(x))
                atomicMax(x, v);
            }
          }
        }
      }
#pragma unroll
      for (int k = 0; k < DB_GROUPS; ++k) m[k] = mn[k];
    }
  }
  __syncthreads();
  de_fold(de_tab, nq, ne, nj, C, do_min, q0, j0, B, nb, rc, n_rc, part);
}

// One warp per output (extreme x, query, bucket): its n_rc keys folded and
// written in the payload's domain (WIDE: int64 rm, else int32).
template <bool WIDE>
__global__ void __launch_bounds__(DB_THREADS)
dense_extremes_fold(const unsigned long long* __restrict__ part, int n_rc,
                    long long n_out, int ne, bool do_min,
                    void* __restrict__ out_min, void* __restrict__ out_max) {
  const int lane = threadIdx.x & 31;
  const long long g =
      static_cast<long long>(blockIdx.x) * DB_WARPS + (threadIdx.x >> 5);
  if (g >= ne * n_out) return;  // the whole warp
  const int x = static_cast<int>(g / n_out);
  const long long i = g - x * n_out;
  const bool is_min = do_min && x == 0;
  unsigned long long s = is_min ? DE_MIN_NONE : 0ull;
  for (int r = lane; r < n_rc; r += 32)
    s = de_pick(is_min, s, part[g * n_rc + r]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s = de_pick(is_min, s, __shfl_xor_sync(FULL, s, off));
  if (lane != 0) return;
  void* out = is_min ? out_min : out_max;
  if (WIDE)
    static_cast<long long*>(out)[i] = static_cast<long long>(s ^ DE_SIGN);
  else
    static_cast<int*>(out)[i] =
        static_cast<int>(static_cast<unsigned>(s) ^ 0x80000000u);
}

int grid_for(long long work, int per_block, int cap) {
  long long g = (work + per_block - 1) / per_block;
  if (g > cap) g = cap;
  return g < 1 ? 1 : static_cast<int>(g);
}

// Resident CTAs of `kern` on the current device at (threads, smem), with
// the dynamic shared memory attribute raised first where smem needs it;
// cached per shape in `c`, one Occupancy per kernel.
struct Occupancy {
  int smem_attr = 48 * 1024, threads = -1, smem = -1, dev = -1, resident = 0;
};

template <class K>
int resident_ctas(Occupancy& c, K kern, int threads, int smem) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev != c.dev) c.smem_attr = 48 * 1024;
  if (smem > c.smem_attr) {
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    c.smem_attr = smem;
  }
  if (threads != c.threads || smem != c.smem || dev != c.dev) {
    int per_sm = 0, sms = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    c.resident = (per_sm > 0 ? per_sm : 1) * sms;
    c.threads = threads;
    c.smem = smem;
    c.dev = dev;
  }
  return c.resident;
}

// The launch shape (warps, stages, smem bytes, and for SLOTS the kept
// query words qb) comes from the wrapper (ops/kernels.py chain_plan /
// slot_plan), and so does `sets` (the op list holds an opcode of the
// extended set: the SETS = true instance); the grid is the resident CTAs of the card, each
// walking tiles tile, tile + grid, ...
template <int MODE>
int launch_chain_tiles(const void* const* srcs, int n_planes, int n_aux,
                       const int* pmat, int B, int P, const int* ops,
                       int n_ops, const signed char* avalid,
                       long long n_blocks, int warps, int stages, int smem,
                       int sets, int ns, int qb, int* counts, long long* sums,
                       cudaStream_t stream) {
  if (n_planes < 0 || n_aux < 0 || n_planes + n_aux > MAX_SRC || warps < 1 ||
      warps * 32 > CHAIN_THREADS || (stages != 1 && stages != 2) ||
      (MODE == SLOTS && (n_aux != 1 || ns < 1 || qb < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  ChainSrc src{};
  for (int i = 0; i < n_planes + n_aux; ++i)
    src.p[i] = static_cast<const int*>(srcs[i]);
  static Occupancy occ[2];
  auto kern =
      sets ? chain_tile_kernel<MODE, true> : chain_tile_kernel<MODE, false>;
  const int resident = resident_ctas(occ[sets != 0], kern, warps * 32, smem);
  const long long n_tiles = (n_blocks + TILE_BLOCKS - 1) / TILE_BLOCKS;
  const int grid = grid_for(n_tiles, 1, resident);
  kern<<<grid, warps * 32, smem, stream>>>(src, n_planes, n_aux, pmat, B, P,
                                           ops, n_ops, avalid, n_blocks,
                                           stages, ns, qb, counts, sums);
  return static_cast<int>(cudaGetLastError());
}

// One CTA per (chunk, row) item; the wrapper keeps the items within
// gridDim.x's 2^31 - 1.
int launch_gather(const int* idx, int B, const int4* op, long long n_rows,
                  long long row_vec, int4* out, cudaStream_t stream) {
  const long long items = (row_vec + GR_CHUNK - 1) / GR_CHUNK * B;
  if (B < 1 || n_rows < 1 || row_vec < 1 || items > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  gather_rows_kernel<<<static_cast<unsigned>(items), GR_THREADS, 0, stream>>>(
      idx, B, op, n_rows, row_vec, out);
  return static_cast<int>(cudaGetLastError());
}

template <bool MINMAX>
int fused_resident() {
  static Occupancy occ;
  return resident_ctas(occ, fused_metrics_kernel<MINMAX>, FM_THREADS,
                       FM_SMEM);
}

// The tile kernel on `grid` CTAs, then the fold (one warp per query). A
// batch under 8 queries splits each tile into S = 2, 4 or 8 segments.
template <bool MINMAX>
int launch_fused(const unsigned char* mask, const int* plane, int B,
                 long long T, int grid, int rep, void* scratch,
                 long long* cnt, long long* sum, int* mn, int* mx,
                 cudaStream_t stream) {
  const long long n_tiles = (T + FM_TILE - 1) / FM_TILE;
  if (B < 1 || T < 4 || T % 4 != 0 || T > INT_MAX || grid < 1 ||
      grid > n_tiles || rep < 1 ||
      static_cast<long long>(B) * rep > LLONG_MAX / 8 ||
      reinterpret_cast<unsigned long long>(plane) % 16 != 0 ||
      reinterpret_cast<unsigned long long>(mask) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int S = 1;
  while (S < FM_STEPS && B <= FM_WARPS / (2 * S)) S *= 2;
  const bool vec16 =
      T % 16 == 0 && reinterpret_cast<unsigned long long>(mask) % 16 == 0;
  const long long n_part = static_cast<long long>(B) * grid;
  long long* part_sum = static_cast<long long*>(scratch);
  int* part_cnt = reinterpret_cast<int*>(part_sum + n_part);
  int* part_mn = part_cnt + n_part;
  int* part_mx = part_mn + n_part;
  fused_resident<MINMAX>();
  fused_metrics_kernel<MINMAX><<<grid, FM_THREADS, FM_SMEM, stream>>>(
      mask, plane, T, B, S, vec16, part_sum, part_cnt, part_mn, part_mx);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long folds = (static_cast<long long>(B) + FM_WARPS - 1) / FM_WARPS;
  fused_metrics_fold<MINMAX><<<static_cast<unsigned>(folds), FM_THREADS, 0,
                               stream>>>(part_sum, part_cnt, part_mn, part_mx,
                                         grid, B, rep, cnt, sum, mn, mx);
  return static_cast<int>(cudaGetLastError());
}

// dense_buckets' tile kernel (counts or sums) and the occupancy state of
// its launches
using DbKernel = void (*)(const int*, const int*, const unsigned char*,
                          long long, int, int, int, int, int, int, int,
                          long long, long long, bool, long long*);

DbKernel db_kernel(bool sum) {
  return sum ? dense_buckets_kernel<true> : dense_buckets_kernel<false>;
}

int db_resident(bool sum, int smem) {
  static Occupancy occ[2];
  return resident_ctas(occ[sum], db_kernel(sum), DB_THREADS, smem);
}

// The tile kernel over the n_qt x n_bt x n_rc items, then the fold (a warp
// per output). The shape comes from the wrapper and is checked here.
int launch_dense(const unsigned char* mask, const int* bid, const int* pay,
                 long long T, int B, int nb, int qt, int C, int nbt,
                 int n_rc, long long chunk, long long flush, bool vec,
                 long long* part, long long* out, cudaStream_t stream) {
  const bool sum = pay != nullptr;
  const long long smem =
      static_cast<long long>(qt) * nbt * (sum ? 2 : 1) * C * 4;
  if (T < 1 || T > INT_MAX || B < 1 || nb < 1 || qt < 1 || qt > B ||
      C < 1 || C > DB_COPIES ||
      (C & (C - 1)) != 0 || nbt < 1 || nbt > nb || n_rc < 1 ||
      chunk < DB_STEP || chunk % DB_STEP != 0 || flush < DB_STEP ||
      flush % DB_STEP != 0 || flush > chunk ||
      (sum && flush > DB_FLUSH_ROWS) || (n_rc - 1) * chunk >= T ||
      n_rc * chunk < T || smem > DB_TABLE_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_qt = (B + qt - 1) / qt, n_bt = (nb + nbt - 1) / nbt;
  const long long grid = n_qt * n_bt * n_rc;
  const long long n_out = static_cast<long long>(B) * nb;
  const long long folds = (n_out + DB_WARPS - 1) / DB_WARPS;
  if (grid > INT_MAX || folds > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec && (T % 4 != 0 ||
              reinterpret_cast<unsigned long long>(bid) % 16 != 0 ||
              reinterpret_cast<unsigned long long>(pay) % 16 != 0 ||
              reinterpret_cast<unsigned long long>(mask) % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  db_resident(sum, static_cast<int>(smem));  // raises the smem attribute
  const DbKernel kern = db_kernel(sum);
  kern<<<static_cast<unsigned>(grid), DB_THREADS, static_cast<size_t>(smem),
         stream>>>(bid, pay, mask, T, B, nb, qt, C, nbt,
                   static_cast<int>(n_qt), static_cast<int>(n_bt), chunk,
                   flush, vec, part);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dense_buckets_fold<<<static_cast<unsigned>(folds), DB_THREADS, 0,
                       stream>>>(part, n_rc, n_out, out);
  return static_cast<int>(cudaGetLastError());
}

// dense_extremes' tile kernel (narrow or wide payload, one payload or a
// min's and a max's) and the occupancy state of its launches
using DeKernel = void (*)(const int*, const int*, const int*, const int*,
                          const int*, const unsigned char*, long long, int,
                          int, int, int, int, int, int, long long, bool, bool,
                          bool, unsigned long long*);

DeKernel de_kernel(bool wide, bool sep) {
  if (wide)
    return sep ? dense_extremes_kernel<true, true>
               : dense_extremes_kernel<true, false>;
  return sep ? dense_extremes_kernel<false, true>
             : dense_extremes_kernel<false, false>;
}

int de_resident(bool wide, bool sep, int smem) {
  static Occupancy occ[4];
  return resident_ctas(occ[2 * wide + sep], de_kernel(wide, sep), DB_THREADS,
                       smem);
}

// The tile kernel over the n_qt x n_bt x n_rc items, then the fold (a warp
// per output). The shape comes from the wrapper and is checked here. The
// payload is wide where b0 is given; the max reads (a1, b1) where a1 is
// given (sep), else (a0, b0) as the min does.
int launch_extremes(const unsigned char* mask, const int* bid, const int* a0,
                    const int* b0, const int* a1, const int* b1, long long T,
                    int B, int nb, int qt, int C, int nbt, int n_rc,
                    long long chunk, bool vec, bool do_min, bool do_max,
                    unsigned long long* part, void* out_min, void* out_max,
                    cudaStream_t stream) {
  const bool wide = b0 != nullptr, sep = a1 != nullptr;
  const int ne = static_cast<int>(do_min) + static_cast<int>(do_max);
  const long long smem = static_cast<long long>(qt) * nbt * ne * C * 8;
  if (T < 1 || T > INT_MAX || B < 1 || nb < 1 || qt < 1 || qt > B ||
      C < 1 || C > DB_COPIES || (C & (C - 1)) != 0 || nbt < 1 || nbt > nb ||
      n_rc < 1 || chunk < DB_STEP || chunk % DB_STEP != 0 ||
      (n_rc - 1) * chunk >= T || n_rc * chunk < T || smem > DB_TABLE_MAX ||
      ne < 1 || a0 == nullptr || (sep && !(do_min && do_max)) ||
      (sep && wide != (b1 != nullptr)) || (!sep && b1 != nullptr) ||
      (do_min && out_min == nullptr) || (do_max && out_max == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_qt = (B + qt - 1) / qt, n_bt = (nb + nbt - 1) / nbt;
  const long long grid = n_qt * n_bt * n_rc;
  const long long n_out = static_cast<long long>(B) * nb;
  const long long folds = (ne * n_out + DB_WARPS - 1) / DB_WARPS;
  if (grid > INT_MAX || folds > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec) {
    const int* planes[5] = {bid, a0, b0, a1, b1};
    bool ok = T % 4 == 0 &&
              reinterpret_cast<unsigned long long>(mask) % 4 == 0;
    for (const int* p : planes)
      ok = ok && reinterpret_cast<unsigned long long>(p) % 16 == 0;
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  }
  de_resident(wide, sep, static_cast<int>(smem));  // raises the smem attribute
  const DeKernel kern = de_kernel(wide, sep);
  kern<<<static_cast<unsigned>(grid), DB_THREADS, static_cast<size_t>(smem),
         stream>>>(bid, a0, b0, a1, b1, mask, T, B, nb, qt, C, nbt,
                   static_cast<int>(n_qt), static_cast<int>(n_bt), chunk,
                   vec, do_min, do_max, part);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto fold = wide ? dense_extremes_fold<true> : dense_extremes_fold<false>;
  fold<<<static_cast<unsigned>(folds), DB_THREADS, 0, stream>>>(
      part, n_rc, n_out, ne, do_min, out_min, out_max);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The grid of fused_metrics' tile kernel over T rows on the current
// device: its resident CTAs, at most one per tile (the wrapper sizes the
// scratch by it).
int tat_fused_metrics_grid(long long T, int minmax) {
  const long long n_tiles = (T + FM_TILE - 1) / FM_TILE;
  const int resident =
      minmax ? fused_resident<true>() : fused_resident<false>();
  return n_tiles < resident ? static_cast<int>(n_tiles) : resident;
}

// mask [B, T] bytes (rows T apart, 4-byte aligned), plane [T] int32
// (16-byte aligned), T % 4 == 0; grid <= the tile count; scratch holds
// B * grid partials (int64 sums, then int32 counts, and with minmax int32
// mins and maxes); cnt, sum [B * rep] int64, mn, mx [B * rep] int32 (unused
// without minmax).
int tat_fused_metrics(const void* mask, const void* plane, int B, long long T,
                      int grid, int rep, int minmax, void* scratch, void* cnt,
                      void* sum, void* mn, void* mx, void* stream) {
  auto launch = minmax ? launch_fused<true> : launch_fused<false>;
  return launch(static_cast<const unsigned char*>(mask),
                static_cast<const int*>(plane), B, T, grid, rep, scratch,
                static_cast<long long*>(cnt), static_cast<long long*>(sum),
                static_cast<int*>(mn), static_cast<int*>(mx),
                static_cast<cudaStream_t>(stream));
}

// srcs: host array of n_planes chain-plane pointers, then n_pay payload
// pointers (copied into the kernel's parameter struct)
int tat_chain_blocks(const void* const* srcs, int n_planes, int n_pay,
                     const void* pmat, int B, int P, const void* ops,
                     int n_ops, const void* avalid, long long n_blocks,
                     int warps, int stages, int smem, int sets,
                     void* counts, void* sums, void* stream) {
  return launch_chain_tiles<BLOCKS>(
      srcs, n_planes, n_pay, static_cast<const int*>(pmat), B, P,
      static_cast<const int*>(ops), n_ops,
      static_cast<const signed char*>(avalid), n_blocks, warps, stages, smem,
      sets, 0, 0, static_cast<int*>(counts), static_cast<long long*>(sums),
      static_cast<cudaStream_t>(stream));
}

// the same arguments as tat_chain_blocks; n_pay must be 0 and sums unused
int tat_chain_counts(const void* const* srcs, int n_planes, int n_pay,
                     const void* pmat, int B, int P, const void* ops,
                     int n_ops, const void* avalid, long long n_blocks,
                     int warps, int stages, int smem, int sets,
                     void* counts, void* sums, void* stream) {
  if (n_pay != 0 || sums != nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_chain_tiles<COUNTS>(
      srcs, n_planes, 0, static_cast<const int*>(pmat), B, P,
      static_cast<const int*>(ops), n_ops,
      static_cast<const signed char*>(avalid), n_blocks, warps, stages, smem,
      sets, 0, 0, static_cast<int*>(counts), nullptr,
      static_cast<cudaStream_t>(stream));
}

// srcs: host array of n_planes chain-plane pointers, then the slot plane's
int tat_chain_slot_counts(const void* const* srcs, int n_planes,
                          const void* pmat, int B, int P, const void* ops,
                          int n_ops, const void* avalid, long long n_blocks,
                          int warps, int stages, int smem, int sets,
                          int ns, int qb, void* counts, void* stream) {
  return launch_chain_tiles<SLOTS>(
      srcs, n_planes, 1, static_cast<const int*>(pmat), B, P,
      static_cast<const int*>(ops), n_ops,
      static_cast<const signed char*>(avalid), n_blocks, warps, stages, smem,
      sets, ns, qb, static_cast<int*>(counts), nullptr,
      static_cast<cudaStream_t>(stream));
}

// dense_buckets' layout, for the wrapper's launch shapes: out[0] rows a CTA
// step covers, out[1] the most rows a sum's pieces are added over before a
// fold, out[2] the most copies of a table, out[3] a table's most bytes.
void tat_dense_buckets_layout(int* out) {
  out[0] = DB_STEP;
  out[1] = DB_FLUSH_ROWS;
  out[2] = DB_COPIES;
  out[3] = DB_TABLE_MAX;
}

// Resident CTAs of dense_buckets' tile kernel (sum: the sums', else the
// counts') at `smem` bytes of table on the current device (the wrapper
// sizes the row chunks by it).
int tat_dense_buckets_resident(int sum, int smem) {
  if (smem < 0 || smem > DB_TABLE_MAX) return 0;
  return db_resident(sum != 0, smem);
}

// mask [B, T] bytes (rows T apart); bid [T] int32; pay [T] int32 for sums,
// null for counts; vec: T % 4 == 0, bid and pay 16-byte and mask
// 4-byte aligned (16- and 4-byte loads); part: B * nb * n_rc int64 scratch;
// out: [B, nb] int64.
int tat_dense_buckets(const void* mask, const void* bid, const void* pay,
                      long long T, int B, int nb, int qt, int C, int nbt,
                      int n_rc, long long chunk, long long flush, int vec,
                      void* part, void* out, void* stream) {
  return launch_dense(static_cast<const unsigned char*>(mask),
                      static_cast<const int*>(bid),
                      static_cast<const int*>(pay), T, B, nb, qt, C, nbt,
                      n_rc, chunk, flush, vec != 0,
                      static_cast<long long*>(part),
                      static_cast<long long*>(out),
                      static_cast<cudaStream_t>(stream));
}

// Resident CTAs of dense_extremes' tile kernel (a wide or narrow payload,
// sep: a min's and a max's) at `smem` bytes of table on the current device.
int tat_dense_extremes_resident(int wide, int sep, int smem) {
  if (smem < 0 || smem > DB_TABLE_MAX) return 0;
  return de_resident(wide != 0, sep != 0, smem);
}

// mask [B, T] bytes (rows T apart); bid [T] int32; a0 [T] int32 the payload
// (wide: its hi plane, b0 its lo plane; narrow: b0 null); a1, b1 the max's
// where it reads other planes than the min (both extremes asked), else
// null; vec: T % 4 == 0, every plane 16-byte and mask 4-byte aligned;
// part: ne * B * nb * n_rc 8-byte scratch (ne = do_min + do_max); out_min,
// out_max [B, nb] (wide int64, else int32), null where not asked.
int tat_dense_extremes(const void* mask, const void* bid, const void* a0,
                       const void* b0, const void* a1, const void* b1,
                       long long T, int B, int nb, int qt, int C, int nbt,
                       int n_rc, long long chunk, int vec, int do_min,
                       int do_max, void* part, void* out_min, void* out_max,
                       void* stream) {
  return launch_extremes(
      static_cast<const unsigned char*>(mask), static_cast<const int*>(bid),
      static_cast<const int*>(a0), static_cast<const int*>(b0),
      static_cast<const int*>(a1), static_cast<const int*>(b1), T, B, nb, qt,
      C, nbt, n_rc, chunk, vec != 0, do_min != 0, do_max != 0,
      static_cast<unsigned long long*>(part), out_min, out_max,
      static_cast<cudaStream_t>(stream));
}

int tat_gather_rows(const void* idx, int B, const void* op, long long n_rows,
                    long long row_vec, void* out, void* stream) {
  return launch_gather(static_cast<const int*>(idx), B,
                       static_cast<const int4*>(op), n_rows, row_vec,
                       static_cast<int4*>(out),
                       static_cast<cudaStream_t>(stream));
}

}  // extern "C"
