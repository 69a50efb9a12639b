// Matrix-unit rate probe for Hopper (sm_90a): a persistent, warp-specialised
// kernel. One producer warp keeps a ring of (A, B) tiles in flight with TMA;
// two consumer warpgroups multiply them, on the tensor cores with wgmma or,
// for the FP32 leg, with FMA on the CUDA cores.
//
// Replaces the JAX package's Pallas TPU kernel benchmarks/mxu_probe.py::
// probe_pallas (inner `body` at :42-48, pl.pallas_call at :50). For each of
// `grid` steps s it computes
//
//   out[s] = sum over y < y_iters of  a @ b          (accumulated in f32)
//
// with a (n, k), b (k, lanes) and out (grid, n, lanes) row-major. Every step
// computes the same product: the point is the rate, not the result.
//
// Precisions, one template:
//   F32     FP32 FMA on the CUDA cores (the JAX f32 leg at HIGHEST).
//   F32X3   the same f32 product on the tensor cores as 3xTF32: wgmma
//           m64n128k8 TF32, d += lo*hi + hi*lo + hi*hi a k-step, small terms
//           first (lo*lo dropped, ~2^-22 relative).
//   BF16    bf16 inputs, wgmma m64n128k16 with f32 accumulation (the JAX
//           bf16 leg).
//
// Operands, packed and split once a call. The wrapper
// (ops/mma_probe.py::pack_operands) packs both operands, K-major and
// zero-padded in K to whole 128-byte chunks: a_p (n, Kp) and bt_p
// (lanes, Kp), Kp a multiple of 64 bf16 or 32 f32 values. TMA needs 16-byte
// row strides, which the raw operands lack at shapes the probe uses (bf16 a
// at k = 1156 has a 2312-byte stride), and TF32 wgmma reads only K-major
// operands. The padding adds exact zeros. For 3xTF32, split_tf32 below
// writes each packed operand once a call as two planes, hi = tf32(x) and
// lo = tf32(x - hi) (cvt.rna.tf32.f32), instead of splitting every staged
// fragment again for every product. Packing and split are inside the timed
// call.
//
// The pipeline:
// - Tiles are 128 rows x 128 lanes of one grid step. Every tile reads the
//   same a rows and the same b, so both stay in the 50 MB L2, and the tiles
//   of two grid steps read the same operands: a cluster of two blocks takes
//   the same tile of a pair of grid steps, and each block loads half the
//   rows of every stage with TMA multicast into both, so L2 streams each
//   stage once for two tiles.
// - Persistent blocks: min(units, the clusters the card holds at once)
//   clusters walk the units (grid step pair, row tile, lane tile, part). A
//   tile's y_iters products may be cut into up to 4 equal parts, each a
//   unit of its own, where that evens the last round of units across the
//   clusters (200 tiles on 66 clusters at n = 512 leave a last round of 2;
//   cut in 3 parts, 600 units leave a last round of 6 of 66). Each part's
//   sum goes to scratch, and sum_parts adds the parts in order.
// - Warpgroup 0 is the producer: setmaxnreg gives its registers to the
//   consumers, and one of its threads issues the TMA loads. For each unit
//   and each product it streams the K chunks of A (128 rows x 128 bytes, a
//   plane) and B (128 lanes x 128 bytes, a plane) into a ring of stages,
//   128-byte swizzled, each guarded by a full mbarrier (TMA's bytes from
//   both blocks) and an empty one (every consumer warp of both blocks): 5
//   stages of 32 KB for bf16, 4 for FP32, and 3 of 64 KB for 3xTF32, whose
//   stage holds the hi and lo planes of both operands. TMA zero-fills the
//   ragged row and lane edges. Before the block exits, the producer waits
//   until the other block's consumers have freed every stage for the last
//   time, so no arrival reaches a block that has gone.
// - Warpgroups 1 and 2 are the consumers. On the tensor cores each
//   multiplies its 64 rows of the tile by all 128 lanes with
//   wgmma.mma_async, A and B both read from shared memory through
//   descriptors in the same 128-byte swizzle that TMA wrote, and frees a
//   stage once the products that read it are done. For FP32 each of the 256
//   consumer threads owns an 8 x 8 micro-tile (rows t / 16 + 16 i, lanes
//   t % 16 + 16 j) and reads both tiles as TMA wrote them: a float4 is four
//   consecutive k of one row, so A needs no transpose and a warp's loads
//   fall on every bank evenly (fma_chunk).
// - The accumulator. The TPU body adds onto a VMEM scratch that is never
//   zeroed and carries it across grid steps (the grid runs in order on one
//   core). Hopper blocks run in no order, so here each tile sums from zero.
//   The tensor cores round their FP32 accumulator toward zero, so each
//   y-iteration's product goes into a fresh fragment and joins its part's
//   running total with an FP32 add (rounded to nearest), as the TPU body
//   adds each dot: one accumulator takes one product, Kp / 16 = 76 bf16
//   steps or 3 x Kp / 8 = 444 TF32 steps at k = 1156. The FP32 leg sums in
//   the same levels, each product's k in order. No atomics: every tile is
//   cut into the same parts and summed in one order, so every grid step
//   gives the same bits.
//
// What bounds it on this card: the route's peak (FP32 67, TF32 495 with three
// products per f32 product, bf16 989 TFLOP/s), unless L2 cannot feed the
// stream first. Neither operand fits one SM's shared memory (A is 296 KB a
// row tile at k = 1156 in bf16), so every product streams its K chunks from
// L2 again: (128 + 128) rows x 128 bytes a plane per 2 x 128 x 128 x (64
// bf16 or 32 f32) FLOP, i.e. 0.0156 B/FLOP in bf16, 0.031 in FP32 and 0.0625
// in 3xTF32 for one block's tile, half that with the cluster's multicast
// (ops/mma_probe.py::l2_bytes counts a call: 6 GB at n = 512 in bf16). At the
// bf16 peak one block a tile would need 15 TB/s, more than L2 delivers;
// multicast halves it. The FP32 leg is bound by its FMAs. The cluster and
// the parts go beyond a plain persistent ring because each met a measured
// limit on an H100 SXM (PERF.md): L2 (bf16 at n = 1400: 3.4 -> 2.8 ms with
// the cluster) and the last round of tiles (FP32 at n = 512: 21.3 -> 17.6 ms
// with the parts). A later design
// could keep a K-slice resident across the products (the TPU kernel's
// VMEM-resident operands), which needs a deterministic reduction across
// K-slices.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched from the driver at run time
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;                     // rows per tile
constexpr int kBN = 128;                     // lanes per tile
constexpr int kRowBytes = 128;               // one K chunk of one tile row: one swizzle row
constexpr int kTileBytes = kBM * kRowBytes;  // one operand plane of one stage (kBN == kBM)
constexpr int kConsumers = 2;                // consumer warpgroups, 64 rows each
constexpr int kCluster = 2;                  // blocks a cluster: two grid steps share each stage
constexpr int kHalf = kBM / kCluster;        // rows of a plane each block of the cluster loads
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kConsumerWarps = 4 * kConsumers;
constexpr int kProducerRegs = 40;   // setmaxnreg: 128 x 40 + 256 x 232 <= 65,536
constexpr int kConsumerRegs = 232;
constexpr int kEncodeFailed = 10000;  // + CUresult: cuTensorMapEncodeTiled refused a map

enum Precision { F32 = 0, F32X3 = 1, BF16 = 2 };

template <int P>
struct Leg;
template <>
struct Leg<F32> {
  static constexpr int kElem = 4, kPlanes = 1, kStages = 4;
};
template <>
struct Leg<BF16> {
  static constexpr int kElem = 2, kPlanes = 1, kStages = 5;
};
template <>
struct Leg<F32X3> {  // hi and lo planes of both operands: 64 KB a stage
  static constexpr int kElem = 4, kPlanes = 2, kStages = 3;
};

template <int P>
__host__ __device__ constexpr int stage_bytes() {
  return 2 * Leg<P>::kPlanes * kTileBytes;
}
template <int P>
__host__ __device__ constexpr int smem_bytes() {
  // the stages, a full and an empty barrier per stage, and slack to align
  // the ring to 1024 bytes (the 128-byte swizzle repeats every 8 rows)
  return Leg<P>::kStages * stage_bytes<P>() + 2 * 8 * Leg<P>::kStages + 1024;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// arrive on the barrier at `bar`'s offset in block `rank` of the cluster
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, uint32_t rank) {
  asm volatile(
      "{\n.reg .b32 remote;\nmapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(smem_u32(bar)),
      "r"(rank)
      : "memory");
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\nbarrier.cluster.wait.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// one kHalf-row x 128-byte box of a K-major operand (column k, row `row`),
// written at `dst` in both blocks of the cluster, each block's `bar`
// counting its bytes
__device__ __forceinline__ void tma_load_both(void* dst, const CUtensorMap* map, uint64_t* bar,
                                              int k, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%4, %5}], [%2], %3;\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
      "h"((uint16_t)((1 << kCluster) - 1)), "r"(k), "r"(row)
      : "memory");
}

// shared-memory matrix descriptor of a K-major tile in the 128-byte swizzle
// TMA writes: 8-row x 128-byte atoms, 1024 bytes apart (SBO); the leading
// offset is unused for this layout. A k-step inside the 128-byte row moves
// the start address by its bytes.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3ffff) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accesses to d across the asynchronous products
__device__ __forceinline__ void pin(float* d) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WGMMA_D64                                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "   \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, " \
  "%37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, " \
  "%55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define WGMMA_OUT64                                                                           \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),          \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),  \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),            \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),            \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),            \
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),            \
      "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),            \
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),            \
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),            \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),            \
      "+f"(d[62]), "+f"(d[63])

// d (64 x 128) = a (64 x 16) * b (16 x 128) [+ d when acc != 0], both
// K-major in shared memory
__device__ __forceinline__ void wgmma_bf16(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WGMMA_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WGMMA_OUT64
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x 128) = a (64 x 8) * b (8 x 128) [+ d when acc != 0], TF32, both
// K-major in shared memory
__device__ __forceinline__ void wgmma_tf32(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " WGMMA_D64
      ", %64, %65, p, 1, 1;\n}\n"
      : WGMMA_OUT64
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// The 3xTF32 split, once a call: x -> hi = tf32(x) into planes[i] and
// lo = tf32(x - hi) into planes[count4 + i] (x - hi is exact in f32), for
// the packed operand x of count4 float4s.
__global__ void split_tf32(const float4* __restrict__ x, uint4* __restrict__ planes,
                           long long count4) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < count4;
       i += (long long)gridDim.x * blockDim.x) {
    const float4 v = x[i];
    const uint4 hi = make_uint4(to_tf32(v.x), to_tf32(v.y), to_tf32(v.z), to_tf32(v.w));
    planes[i] = hi;
    planes[count4 + i] =
        make_uint4(to_tf32(v.x - __uint_as_float(hi.x)), to_tf32(v.y - __uint_as_float(hi.y)),
                   to_tf32(v.z - __uint_as_float(hi.z)), to_tf32(v.w - __uint_as_float(hi.w)));
  }
}

// FP32 FMA on one stage: part[8 i + j] += the chunk's 32-deep dot of tile
// row ty + 16 i with tile lane tx + 16 j, k in order (part starts from zero
// when fresh). Both tiles are read as TMA wrote them, K-major and swizzled:
// a float4 is four consecutive k of one row, and a warp's 16 B rows (16
// consecutive lanes) land on every bank twice, the fewest wavefronts.
__device__ __forceinline__ void fma_chunk(float* part, const unsigned char* st, int ty, int tx,
                                          bool fresh) {
  if (fresh) {
#pragma unroll
    for (int i = 0; i < 64; ++i) part[i] = 0.f;
  }
  const unsigned char* as = st + ty * kRowBytes;
  const unsigned char* bs = st + kTileBytes + tx * kRowBytes;
#pragma unroll 2
  for (int c = 0; c < kRowBytes / 16; ++c) {
    // 16-byte unit c of a row sits at unit c ^ (row % 8); ty + 16 i and
    // tx + 16 j keep the row's residue mod 8
    const int ua = (c ^ (ty & 7)) * 16, ub = (c ^ (tx & 7)) * 16;
    float4 av[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      av[i] = *reinterpret_cast<const float4*>(as + 16 * i * kRowBytes + ua);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 bv = *reinterpret_cast<const float4*>(bs + 16 * j * kRowBytes + ub);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float p = part[8 * i + j];
        p = fmaf(av[i].x, bv.x, p);
        p = fmaf(av[i].y, bv.y, p);
        p = fmaf(av[i].z, bv.z, p);
        p = fmaf(av[i].w, bv.w, p);
        part[8 * i + j] = p;
      }
    }
  }
}

// out[i] = the parts' sums of products added in order: part 0 + part 1 + ...
__global__ void sum_parts(const float* __restrict__ partial, float* __restrict__ out,
                          long long count, int parts) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < count;
       i += (long long)gridDim.x * blockDim.x) {
    float s = partial[i];
    for (int j = 1; j < parts; ++j) s += partial[j * count + i];
    out[i] = s;
  }
}

// Warpgroup 0 produces, warpgroups 1 and 2 consume; see the note at the top.
template <int P>
__global__ void __launch_bounds__(kThreads, 1)
    probe_kernel(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap ma_lo,
                 const __grid_constant__ CUtensorMap mb, const __grid_constant__ CUtensorMap mb_lo,
                 float* __restrict__ out, int n, int lanes, int grid, int n_chunks, int products,
                 int parts, int m_tiles, int n_tiles, int units) {
  constexpr int S = Leg<P>::kStages;
  constexpr int kStage = stage_bytes<P>();
  constexpr int kPlanes = Leg<P>::kPlanes;  // a stage: A planes, then B planes
  constexpr int kChunk = kRowBytes / Leg<P>::kElem;  // K values a chunk
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S * kStage);
  uint64_t* empty = full + S;

  const int tid = threadIdx.x;
  // the cluster's two blocks take the same tile of two grid steps: unit u
  // is (grid step pair, row tile, lane tile, part), and block `rank` loads
  // rows [kHalf rank, kHalf rank + kHalf) of every plane into both blocks
  const uint32_t rank = blockIdx.x % kCluster;
  const int cluster = blockIdx.x / kCluster, clusters = gridDim.x / kCluster;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kCluster * kConsumerWarps);  // both blocks' consumers read the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // both blocks' barriers exist before either loads into or arrives on them

  const int wg = tid / 128;
  if (wg == 0) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == 0) {
      int stage = 0;
      uint32_t phase = 0;
      const int half = rank * kHalf * kRowBytes;
      for (int u = cluster; u < units; u += clusters) {
        const int t = u / parts;
        const int m0 = (t / n_tiles) % m_tiles * kBM + rank * kHalf;
        const int n0 = t % n_tiles * kBN + rank * kHalf;
        for (int y = 0; y < products; ++y)
          for (int kc = 0; kc < n_chunks; ++kc) {
            mbar_wait(&empty[stage], phase ^ 1);  // both blocks freed it
            unsigned char* st = smem + stage * kStage + half;
            mbar_expect_tx(&full[stage], kStage);  // half from each block
            tma_load_both(st, &ma, &full[stage], kc * kChunk, m0);
            tma_load_both(st + kPlanes * kTileBytes, &mb, &full[stage], kc * kChunk, n0);
            if constexpr (kPlanes == 2) {
              tma_load_both(st + kTileBytes, &ma_lo, &full[stage], kc * kChunk, m0);
              tma_load_both(st + 3 * kTileBytes, &mb_lo, &full[stage], kc * kChunk, n0);
            }
            if (++stage == S) {
              stage = 0;
              phase ^= 1;
            }
          }
      }
      // the other block's consumers still arrive on these barriers: this
      // block may exit only once every stage has been freed for the last time
      for (int i = 0; i < S; ++i) {
        mbar_wait(&empty[stage], phase ^ 1);
        if (++stage == S) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int cw = wg - 1;  // tensor cores: this warpgroup's rows are [64 cw, 64 cw + 64)
  const int ct = tid - 128;  // FMA: this thread's rows are ct / 16 + 16 i, lanes ct % 16 + 16 j
  const int warp = (tid % 128) / 32, lane = tid % 32;
  float part[64], total[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) part[i] = 0.f;
  // a stage is free once every consumer warp of both blocks has read it
  auto release = [](uint64_t* bar) {
#pragma unroll
    for (uint32_t r = 0; r < kCluster; ++r) mbar_arrive_cluster(bar, r);
  };
  int stage = 0;
  uint32_t phase = 0;
  for (int u = cluster; u < units; u += clusters) {
#pragma unroll
    for (int i = 0; i < 64; ++i) total[i] = 0.f;
    for (int y = 0; y < products; ++y) {
      int prev = 0;
      for (int kc = 0; kc < n_chunks; ++kc) {
        mbar_wait(&full[stage], phase);
        if constexpr (P == F32) {
          fma_chunk(part, smem + stage * kStage, ct / 16, ct % 16, kc == 0);
          __syncwarp();
          if (lane == 0) release(&empty[stage]);
        } else {
          const uint32_t st = smem_u32(smem + stage * kStage);
          const uint32_t sa = st + cw * 64 * kRowBytes, sb = st + kPlanes * kTileBytes;
          pin(part);
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < kRowBytes / 32; ++ks) {  // 32 bytes a k-step
            const uint64_t da = desc_sw128(sa + 32 * ks), db = desc_sw128(sb + 32 * ks);
            if constexpr (P == BF16) {
              wgmma_bf16(part, da, db, kc | ks);
            } else {  // lo*hi + hi*lo + hi*hi, small terms first (lo*lo dropped, ~2^-22 relative)
              const uint64_t da_lo = desc_sw128(sa + kTileBytes + 32 * ks);
              const uint64_t db_lo = desc_sw128(sb + kTileBytes + 32 * ks);
              wgmma_tf32(part, da_lo, db, kc | ks);
              wgmma_tf32(part, da, db_lo, 1);
              wgmma_tf32(part, da, db, 1);
            }
          }
          wgmma_commit();
          if (kc > 0) {  // the previous chunk's products are done: free its stage
            wgmma_wait<1>();
            if (lane == 0) release(&empty[prev]);
          }
          prev = stage;
        }
        if (++stage == S) {
          stage = 0;
          phase ^= 1;
        }
      }
      if constexpr (P != F32) {
        wgmma_wait<0>();
        pin(part);
        if (lane == 0) release(&empty[prev]);
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) total[i] += part[i];
    }

    // an odd grid's last pair has one grid step: its second block only loads
    const int t = u / parts, step = t / (m_tiles * n_tiles) * kCluster + rank;
    if (step >= grid) continue;
    const int m0 = (t / n_tiles) % m_tiles * kBM, n0 = t % n_tiles * kBN;
    float* o = out + ((size_t)(u % parts) * grid + step) * n * lanes;
    if constexpr (P == F32) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int row = m0 + ct / 16 + 16 * i, col = n0 + ct % 16 + 16 * j;
          if (row < n && col < lanes) o[(size_t)row * lanes + col] = total[8 * i + j];
        }
    } else {
      // fragment element 4 j + r: row 16 warp + lane / 4 + 8 (r / 2), lane
      // column 8 j + 2 (lane % 4) + r % 2
      const int r0 = m0 + 64 * cw + 16 * warp + lane / 4, c0 = n0 + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = r0 + 8 * (r / 2), col = c0 + 8 * j + r % 2;
          if (row < n && col < lanes) o[(size_t)row * lanes + col] = total[4 * j + r];
        }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side.

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so the
// library needs no -lcuda
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t rc =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (rc == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a 2-D map over a K-major (rows, kp) operand: kHalf-row x 128-byte boxes,
// 128-byte swizzle, zeros out of bounds
int make_map(CUtensorMap* map, const void* base, int rows, int kp, int elem) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {(cuuint64_t)kp, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)kp * elem};
  const cuuint32_t box[2] = {(cuuint32_t)(kRowBytes / elem), (cuuint32_t)kHalf};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r =
      fn(map, elem == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
         const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + (int)r;
}

int sm_count(int* sms) {
  int dev = 0;
  int rc = (int)cudaGetDevice(&dev);
  if (rc != 0) return rc;
  return (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// the split of one packed operand of `count` floats into its two planes
int launch_split(const void* x, void* planes, long long count, int sms, cudaStream_t s) {
  const long long count4 = count / 4;
  const long long want = (count4 + 255) / 256;
  const int blocks = (int)(want < 8LL * sms ? want : 8LL * sms);
  split_tf32<<<blocks, 256, 0, s>>>(static_cast<const float4*>(x), static_cast<uint4*>(planes),
                                    count4);
  return (int)cudaGetLastError();
}

// A launch of the kernel. A unit is one part of the products of one tile
// of a pair of grid steps; min(units, the clusters the card holds at once)
// clusters of kCluster blocks walk them, all resident together
// (persistent). A tile's y_iters products are cut into `parts` equal parts
// when that evens the last round of units across the clusters; the parts'
// sums then meet in sum_parts, in order.
struct Launch {
  int m_tiles, n_tiles, parts, units, blocks;
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
};

constexpr int kMaxParts = 4;

template <int P>
int plan_launch(int n, int lanes, int y_iters, int grid, cudaStream_t s, Launch* l) {
  l->m_tiles = (n + kBM - 1) / kBM;
  l->n_tiles = (lanes + kBN - 1) / kBN;
  const long long tiles = (long long)((grid + kCluster - 1) / kCluster) * l->m_tiles * l->n_tiles;
  if (tiles * kMaxParts > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  int rc = (int)cudaFuncSetAttribute(probe_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     smem_bytes<P>());
  if (rc != 0) return rc;
  int sms = 0;
  rc = sm_count(&sms);
  if (rc != 0) return rc;
  l->attr.id = cudaLaunchAttributeClusterDimension;
  l->attr.val.clusterDim.x = kCluster;
  l->attr.val.clusterDim.y = 1;
  l->attr.val.clusterDim.z = 1;
  l->config = cudaLaunchConfig_t{};
  l->config.gridDim = dim3(sms / kCluster * kCluster);
  l->config.blockDim = dim3(kThreads);
  l->config.dynamicSmemBytes = smem_bytes<P>();
  l->config.stream = s;
  l->config.attrs = &l->attr;
  l->config.numAttrs = 1;
  int clusters = 0;
  rc = (int)cudaOccupancyMaxActiveClusters(&clusters, probe_kernel<P>, &l->config);
  if (rc != 0) return rc;
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  // rounds of units a cluster walks, per product of a tile: cut the
  // products into parts only where that saves at least 3 % of it
  l->parts = 1;
  double best = (double)((tiles + clusters - 1) / clusters);
  for (int j = 2; j <= kMaxParts && j <= y_iters; ++j) {
    if (y_iters % j != 0) continue;
    const double rounds = (double)((tiles * j + clusters - 1) / clusters) / j;
    if (rounds < 0.97 * best) {
      best = rounds;
      l->parts = j;
    }
  }
  l->units = (int)(tiles * l->parts);
  l->blocks = kCluster * (l->units < clusters ? l->units : clusters);
  l->config.gridDim = dim3(l->blocks);
  return 0;
}

// Scratch bytes a call needs: the 3xTF32 planes (A hi, A lo, B hi, B lo),
// then the parts' sums when the products are cut into parts.
long long scratch_bytes(int precision, int n, int kp, int lanes, int grid, int parts) {
  const long long planes = precision == F32X3 ? 2LL * (n + lanes) * kp * 4 : 0;
  const long long sums = parts > 1 ? (long long)parts * grid * n * lanes * 4 : 0;
  return planes + sums;
}

// maps: A (hi), A lo, B (hi), B lo; the lo maps are read only by two-plane legs
template <int P>
int launch(const CUtensorMap* maps, float* sums, float* out, int n, int kp, int lanes,
           int y_iters, int grid, const Launch& l, cudaStream_t s) {
  int rc = (int)cudaLaunchKernelEx(&l.config, probe_kernel<P>, maps[0], maps[1], maps[2],
                                   maps[3], l.parts > 1 ? sums : out, n, lanes, grid,
                                   kp / (kRowBytes / Leg<P>::kElem), y_iters / l.parts, l.parts,
                                   l.m_tiles, l.n_tiles, l.units);
  if (rc != 0 || l.parts == 1) return rc;
  const long long count = (long long)grid * n * lanes;
  const long long want = (count + 255) / 256;
  sum_parts<<<(int)(want < 4096 ? want : 4096), 256, 0, s>>>(sums, out, count, l.parts);
  return (int)cudaGetLastError();
}

template <int P>
int run(const void* a_p, const void* bt_p, void* scratch, float* out, int n, int kp, int lanes,
        int y_iters, int grid, cudaStream_t s) {
  Launch l;
  int rc = plan_launch<P>(n, lanes, y_iters, grid, s, &l);
  if (rc != 0) return rc;
  if (scratch == nullptr && scratch_bytes(P, n, kp, lanes, grid, l.parts) > 0)
    return (int)cudaErrorInvalidValue;
  constexpr int elem = Leg<P>::kElem;
  CUtensorMap maps[4];
  float* sums = static_cast<float*>(scratch);
  if constexpr (P == F32X3) {
    int sms = 0;
    rc = sm_count(&sms);
    const long long na = (long long)n * kp, nb = (long long)lanes * kp;
    float* sa = static_cast<float*>(scratch);
    float* sb = sa + 2 * na;
    sums = sb + 2 * nb;
    if (rc == 0) rc = launch_split(a_p, sa, na, sms, s);
    if (rc == 0) rc = launch_split(bt_p, sb, nb, sms, s);
    if (rc == 0) rc = make_map(&maps[0], sa, n, kp, elem);
    if (rc == 0) rc = make_map(&maps[1], sa + na, n, kp, elem);
    if (rc == 0) rc = make_map(&maps[2], sb, lanes, kp, elem);
    if (rc == 0) rc = make_map(&maps[3], sb + nb, lanes, kp, elem);
  } else {
    rc = make_map(&maps[0], a_p, n, kp, elem);
    if (rc == 0) rc = make_map(&maps[2], bt_p, lanes, kp, elem);
    maps[1] = maps[0];
    maps[3] = maps[2];
  }
  if (rc != 0) return rc;
  return launch<P>(maps, sums, out, n, kp, lanes, y_iters, grid, l, s);
}

template <int P>
void fill_geometry(int* geo) {
  geo[0] = kBM;
  geo[1] = kBN;
  geo[2] = kRowBytes / Leg<P>::kElem;
  geo[3] = Leg<P>::kStages;
  geo[4] = kConsumers;
  geo[5] = kThreads;
  geo[6] = smem_bytes<P>();
  geo[7] = kCluster;
}

}  // namespace

extern "C" {

// The launch geometry of one precision: block tile (rows, lanes, K values a
// chunk), ring stages, consumer warpgroups, threads and dynamic shared
// memory a block, blocks a cluster. Returns 0, or cudaErrorInvalidValue for
// an unknown precision.
int mma_probe_geometry(int precision, int* geo) {
  switch (precision) {
    case F32:
      fill_geometry<F32>(geo);
      return 0;
    case F32X3:
      fill_geometry<F32X3>(geo);
      return 0;
    case BF16:
      fill_geometry<BF16>(geo);
      return 0;
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The plan of a call: persistent blocks on the current device, kCluster x
// min(units, the clusters the card holds at once), the parts each tile's
// products are cut into, and the scratch bytes the call needs.
int mma_probe_plan(int precision, int n, int kp, int lanes, int y_iters, int grid, int* blocks,
                   int* parts, long long* scratch) {
  Launch l;
  int rc;
  switch (precision) {
    case F32:
      rc = plan_launch<F32>(n, lanes, y_iters, grid, 0, &l);
      break;
    case F32X3:
      rc = plan_launch<F32X3>(n, lanes, y_iters, grid, 0, &l);
      break;
    case BF16:
      rc = plan_launch<BF16>(n, lanes, y_iters, grid, 0, &l);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  *blocks = l.blocks;
  *parts = l.parts;
  *scratch = scratch_bytes(precision, n, kp, lanes, grid, l.parts);
  return 0;
}

// out (grid, n, lanes) float32 from the packed operands a_p (n, kp) and
// bt_p (lanes, kp), K-major, kp a whole number of 128-byte chunks, both
// float32 (precision 0 = FP32 FMA, 1 = 3xTF32) or both bf16 (precision 2),
// 16-byte aligned, on one device. `scratch` holds the bytes mma_probe_plan
// names for these sizes (it may be null when they are 0). Launches on
// `stream` and returns cudaGetLastError(), cudaErrorInvalidValue for
// arguments it refuses, or 10000 + the CUresult when a tensor map
// cannot be made.
int mma_probe(const void* a_p, const void* bt_p, void* scratch, float* out, int n, int kp,
              int lanes, int y_iters, int grid, int precision, void* stream) {
  const int elem = precision == BF16 ? 2 : 4;
  if (n <= 0 || kp <= 0 || lanes <= 0 || y_iters < 0 || grid <= 0 || precision < F32 ||
      precision > BF16 || kp % (kRowBytes / elem) != 0 ||
      (reinterpret_cast<uintptr_t>(a_p) | reinterpret_cast<uintptr_t>(bt_p) |
       reinterpret_cast<uintptr_t>(scratch)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (precision) {
    case F32:
      return run<F32>(a_p, bt_p, scratch, out, n, kp, lanes, y_iters, grid, s);
    case F32X3:
      return run<F32X3>(a_p, bt_p, scratch, out, n, kp, lanes, y_iters, grid, s);
    default:
      return run<BF16>(a_p, bt_p, scratch, out, n, kp, lanes, y_iters, grid, s);
  }
}

const char* mma_probe_error_string(int code) {
  if (code >= kEncodeFailed) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
