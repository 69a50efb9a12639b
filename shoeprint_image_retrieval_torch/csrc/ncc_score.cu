// Fused NCC scorer for Hopper (sm_90a): a warp-specialised 3xTF32
// tensor-core implicit GEMM, with a bf16 leg for tpu.precision = "bfloat16".
//
// Replaces the JAX package's Pallas TPU kernel
// shoeprint_image_retrieval_tpu/ops/pallas/ncc_kernel.py::score_packed_operands
// (body _kernel_body). It computes, for every variant row n and print g,
//
//   out[n, g] = max over g's valid (y, x) of
//               sum_c corr_c[n, g, y, x] * einv_c[g, hw(n), y, x]   / C_true
//
// where corr_c is the centred "same" correlation of the folded template
// K[n, c] (hk x wk) with the demeaned print P0[c, g], and
// einv = 1 / sqrt(max(B2 - B1^2 / (h*w), 0)) (0 where the energy is 0), with
// B1, B2 the box sums of P0 and P0^2 over row n's post-crop window (h, w),
// clipped to the canvas. Semantics are those of the port's plain version,
// ops/ncc_direct.py::score_direct.
//
// What bounds it on this card: operations. At the main-path shapes
// (N = 1400 rows, C = 176, G = 300 prints of <= 42 x 42, a 34 x 34 canvas)
// the correlation needs ~1.2e14 FLOP and one call must read only ~2.3 GB.
// 3xTF32 spends three TF32 tensor-core products on one f32 product, so the
// bound is the needed FLOP at 495 / 3 TFLOP/s: 725 ms (bf16: 121 ms at 989
// TFLOP/s). The kernel executes 1.6x the needed FLOP at tile and block
// granularity (ops/ncc_kernel.py::executed_flop).
//
// What held the earlier single-role body back, and what this one does. In
// that body all 512 threads gathered and split each 32-tap chunk between two
// block-wide barriers, staged each channel's patch and energy table while
// the tensor cores waited, and joined each chunk before issuing the next;
// ptxas also serialised its wgmma (a product issued on a divergent path). A
// model of its two legs, which share that work (3xTF32: X + P = 3480 ms;
// bf16, whose products take a sixth of the time: X + P / 6 = 2058 ms), put
// the work beside the products at X ~ 1774 ms and the products at P ~ 1707
// ms. This body gives that work to a producer warpgroup, beside the
// products, and issues every wgmma asynchronously. Bit for bit the same
// sums as that body; on an H100 80GB HBM3 at 700 W the main-path call
// (PB = 56, benchmarks/kernel_probe.py, both bodies in one run) went from
// 3467 to 2358 ms (3xTF32, 30.5 % of its bound) and from 2065 to 1150 ms
// (bf16, 10.4 %) (PERF.md). What bounds it now is the producer: a chunk's
// 2048 taps are gathered with 4-byte copies and converted by one or two
// warps, the consumers wait for the next chunk part of the time, and the
// tensor cores run the 3xTF32 products at about half their rate.
//
// The design:
// - Per channel the correlation is an implicit GEMM: M = 256 output
//   positions of one print (its valid positions, row-major, so only a
//   print's last block holds positions past its valid region), N = a tile
//   of 64 variant rows, K = the tile's taps. A is the staged print patch
//   read in place at im2col addresses (position offset + tap offset) into
//   registers; no im2col matrix exists anywhere. B is the tile's taps in
//   shared memory.
// - Tap windows. The host's tile plan (ops/ncc_kernel.py::row_plan) orders
//   the rows by post-crop window, so a tile's rows have similar windows, and
//   gives each tile the centred (max h, max w) sub-rectangle of the canvas
//   that holds every nonzero tap of its rows. Each block further clips the
//   rectangle to the tap rows and columns that land inside the print's valid
//   region for at least one of its positions (p0 is zero elsewhere). Both
//   skips drop only exact zeros. A block's taps run on across tap rows in
//   chunks of 32, so only its last chunk is padded.
// - Roles. Producer warpgroups come first, then two consumer warpgroups,
//   which only load A fragments and issue wgmma; each covers 128 positions
//   as two m64 fragments against one B operand, so a block still covers
//   256. The 3xTF32 legs have one producer warpgroup (384 threads;
//   setmaxnreg 64 / 216): two copy warps, one converting warp, one staging
//   warp. The bf16 leg, whose products are a sixth as long, has two (512
//   threads; 48 / 208): four copy warps, two converting warps taking
//   alternate chunks, two staging warps (Roles below).
// - The tap ring. A chunk is (channel, 32 taps). The copy warps gather its
//   64 x 32 taps from the stack in the engine's (N, C, hk, wk) layout with
//   4-byte cp.async into a raw stage (a clipped tap run starts at any
//   alignment, and rows come through the plan's order, so no chunk is a
//   fixed box of a packed operand: TMA tensor maps do not apply), up to S
//   chunks ahead; each copy thread's copies arrive on the stage's mbarrier
//   as they land (cp.async.mbarrier.arrive.noinc). The converting warp turns
//   a landed chunk into the products' K-major planes in a B stage (3xTF32:
//   hi = tf32(x) and lo = tf32(x - hi), cvt.rna; bf16: one plane rounded to
//   nearest even), fences them for the tensor cores' proxy and arrives on
//   the stage's full barrier; the consumers free it on its empty barrier
//   once their products that read it are done. Loops that load from and
//   store to shared memory take a batch's loads before its stores: the
//   compiler cannot move a load past a store that may alias it, so one load
//   at a time would wait out its latency. The split stays in the producer
//   rather than in a one-off pass over the stack: a split copy of the stack
//   would double what the stack costs in device memory at the deepest probe
//   batches. The ring holds S stages (3-6, the deepest that fits shared
//   memory). A 1-D bulk copy (TMA) of each row's aligned tap range, tried
//   where every tap plane is 16-byte aligned, made the converter's gather
//   dearer than the copies it saved, and was dropped.
// - Per-channel work off the products' path. The staging warp writes each
//   channel's print patch (split pairs, floats or bf16) and the inverse
//   energy of every (tile window, position) from the integral images into
//   one of two buffers, up to a channel ahead of the consumers, so they
//   find the next channel's buffers ready. Where two buffers do not fit
//   (the large canvases), one buffer is staged as each channel starts.
// - Sums: the tensor cores round each product's sum into their FP32
//   accumulator toward zero, so a long run of products into one
//   accumulator drifts by up to an ulp of the running sum per product (one
//   accumulator over a channel's 1156 taps drifted ~1e-5 in the scores).
//   So each 32-tap chunk's 12 products go into a fresh fragment, and the
//   chunks join the channel's sum by FP32 adds on the CUDA cores (rounded
//   to nearest), in chunk order. Each consumer waits for its chunk's
//   products before the join; the other consumer warpgroup's products keep
//   the tensor cores busy meanwhile. Joining one fragment while the other's
//   products run (waiting for all but the newest group) made ptxas
//   serialise every wgmma: it treats any accumulator read before a full
//   wait as inside the products' pipeline. Each wgmma is issued on every
//   path with a runtime scale-d, never inside a branch, and no product is
//   in flight across a loop edge. The sum over channels lives in shared
//   memory (64 KB a block); registers hold the two fragments' chunk sums
//   and channel sums (128 floats) and their A fragments.
// - Large canvases: the patch a block stages grows with the kernel canvas
//   and the print's width ((rows + hk - 1) x (Wb + wk - 1)). Where its
//   split (hi, lo) pairs do not fit shared memory (a 73 x 73 canvas over
//   88-wide prints: fusion's stride-8 block of a stride-16 cluster), the
//   block stages the patch as plain floats and the consumers split each A
//   element as they read it: half the patch bytes, the same products and
//   sums (bit-identical), more work per product.
// - Epilogue per channel: the channel's correlation is scaled by
//   einv(c, row window, position) and added to the sum over channels.
//   einv depends on the row only through its window, and sorted tiles hold
//   few distinct windows. After the last channel the masked max over valid
//   positions is folded into (order[row], g) with atomicMax on an
//   order-preserving int encoding; finalize divides by C.
// - Only the stack's true channels are looped over, not the cache's
//   padding channels (zero prints: they add exact zeros).
// - The bf16 leg (the JAX kernel's compute_dtype = bfloat16: both operands
//   of the correlation rounded to bf16, f32 accumulation; the window
//   energies stay f32) runs the same roles, ring and epilogue on
//   wgmma.mma_async m64n64k16 bf16. The patch is rounded once a channel
//   (cvt.rn.bf16x2.f32, as torch's and XLA's casts round) into bf16, and
//   each chunk into one plane, K-major with 8-tap core matrices: tap k of
//   row n at [k / 8][n][k % 8]. A k16 A fragment pairs taps (k, k + 1) of
//   one position in a register; consecutive taps are neighbouring patch
//   columns at any alignment, or the last tap of one tap row and the first
//   of the next, so each element is loaded alone (16 bits) and the pair
//   packed. A 32-tap chunk is two k16 products against twelve TF32
//   products. Products of bf16 values are exact in f32, but the accumulator
//   still truncates, so runs of kBf16Run chunks (8: 256 taps) share a
//   fragment and join the channel's sum by f32 adds.
//
// Device scratch: the kernel reads the variant stack in the engine's own
// (N, C, hk, wk) layout and the cache as it is. Besides the (N, G) int32
// maxima it needs only the tile plan, one int32 array of a few KB: the row
// order and each row's window index in its tile (2 N), and per tile its tap
// rectangle and its distinct windows. The gallery block's byte model
// (ops/ncc_kernel.py) counts the maxima; its margin covers the plan.
//
// Ragged edges: rows past N (a partial last tile) stage zero taps and
// write nothing; positions past a print's valid count read a clamped
// position and are masked; K tails stage zero taps; patch rows and columns
// outside the canvas read as zeros. The host's plans give every block at
// least the canvas centre tap (K >= 1, ops/ncc_kernel.py::block_taps); a
// block with K = 0 would run no chunk in any role and contribute its
// positions' zero correlation.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;        // variant rows per tile (block rows)
constexpr int kBN = 256;       // output positions per block
constexpr int kKC = 32;        // taps per staged chunk
constexpr int kConsumers = 2;  // consumer warpgroups, two m64 position fragments each
constexpr int kConsumerThreads = 128 * kConsumers;
constexpr int kMaxStages = 6;
constexpr int kSA = kKC + 4;   // raw taps [m][k], stride 36 words: 8 rows x 4 taps hit 32 banks
constexpr int kEP = kBN + 8;   // einv table row stride: 4 windows' rows on distinct banks
constexpr int kSmemLimit = 227 * 1024;
constexpr int kBf16Run = 8;     // the bf16 leg's chunks a fragment (the 3xTF32 legs: 1)

// the kernel's legs: 3xTF32 with the patch staged as floats split where
// read (kFloat) or split once a channel into (hi, lo) pairs (kSplit), or
// bf16 with the patch rounded once a channel (kBf16); the values are the
// layout codes ncc_score_geometry reports
enum Leg : int { kFloat = 0, kSplit = 1, kBf16 = 2 };

// The producer warpgroups of a leg and what their warps do: kCopy warps
// copy the taps, then kConvert warps convert them (alternate chunks each),
// then kStage warps stage the patch and einv table; the registers
// setmaxnreg gives a producer and a consumer thread (their sum over the
// block is the register file, 65,536); the staging warps' loads in flight a
// lane. The bf16 leg's short products leave its producer the limit, so it
// has two producer warpgroups; the 3xTF32 legs keep one (with two, the
// split patch's consumers spill at any register split).
template <Leg L>
struct Roles {
  static constexpr int kProducers = 1, kCopy = 2, kConvert = 1, kStage = 1;
  static constexpr int kProducerRegs = 64, kConsumerRegs = 216, kStageBatch = 4;
  static constexpr int kThreads = 128 * (kProducers + kConsumers);
};
template <>
struct Roles<kBf16> {
  static constexpr int kProducers = 2, kCopy = 4, kConvert = 2, kStage = 2;
  static constexpr int kProducerRegs = 48, kConsumerRegs = 208, kStageBatch = 2;
  static constexpr int kThreads = 128 * (kProducers + kConsumers);
};

struct Geometry {
  int C, G, N, Hb, Wb, hk, wk;
  int n_chunks;       // position blocks per print (the most any print needs)
  int patch_rows;     // staged print rows a block needs at most
  int n_windows;      // distinct windows a tile holds at most
  int pitch;          // staged patch row pitch: Wb + wk - 1
  int ktab_len;       // hk * wk rounded up to kKC
  int stages;         // depth of the tap ring
  int patch_buffers;  // 2: channel c + 1 staged while c runs; 1: as c starts
  float true_channels;
};

// Order-preserving float <-> int map: a < b as floats iff enc(a) < enc(b)
// as ints (for non-NaN values), so atomicMax on ints is a float max.
__device__ __forceinline__ int enc(float f) {
  int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float dec(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

__global__ void fill_neg_inf(int* __restrict__ best, int count) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count) best[i] = enc(-INFINITY);
}

__global__ void finalize(const int* __restrict__ best, float* __restrict__ out,
                         int count, float true_channels) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count) out[i] = dec(best[i]) / true_channels;
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));  // x - hi is exact in f32
}

// two floats rounded to bf16 (to nearest, ties to even), `lo` in the low
// half: the order of a bf16 pair in a wgmma fragment or a K-major row
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// d (64 x 64, the warpgroup's accumulator fragment) = a (64 x 8, from
// registers) * b (8 x 64, K-major in shared memory, described by desc),
// plus d itself when acc is nonzero (a runtime predicate: one instruction
// on every path)
__device__ __forceinline__ void wgmma_tf32(float* d, const uint32_t* a, uint64_t desc, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}
// the same product in bf16: a (64 x 16, from registers, bf16 pairs) *
// b (16 x 64, K-major bf16 in shared memory), f32 accumulation
__device__ __forceinline__ void wgmma_bf16(float* d, const uint32_t* a, uint64_t desc, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
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
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// shared-memory matrix descriptor, K-major, no swizzle: 8-row x 16-byte
// core matrices, SBO bytes between 8-row groups, LBO bytes between the two
// 16-byte halves of a k-step
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a >> 4) & 0x3fff) | ((uint64_t)((lbo >> 4) & 0x3fff) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3fff) << 32);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
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
// 4-byte asynchronous copy global -> shared; zero-fills when !valid (no
// bytes are read then)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}
// arrive on `bar` once every cp.async this thread issued so far has landed
// (the arrival is one of the barrier's expected count)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
// the products read shared memory through the tensor cores' asynchronous proxy
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 32-bit words of one staged patch: (hi, lo) pairs, plain floats or bf16,
// rounded up to whole 8-byte words
__host__ __device__ __forceinline__ size_t patch_words(int patch_rows, int pitch, Leg leg) {
  const size_t elems = (size_t)patch_rows * pitch;
  return leg == kSplit ? 2 * elems : leg == kFloat ? (elems + 1) / 2 * 2 : (elems + 3) / 4 * 2;
}

// 32-bit words of one B stage: (hi, lo) planes, or one bf16 plane
__host__ __device__ constexpr int tap_words(Leg leg) { return (leg == kBf16 ? 1 : 4) * kKC * kBM / 2; }

// byte offsets of the block's shared memory; every region starts 8-byte
// aligned, the B stages (read by the tensor cores) 128-byte aligned
struct Layout {
  size_t bstages, raw, accs, patch, etab, koff, rowoff, bars, rows, rslot, win, total;
};

__host__ __device__ __forceinline__ Layout layout_of(const Geometry& geo, Leg leg) {
  Layout l;
  size_t o = 0;
  l.bstages = o;
  o += (size_t)geo.stages * 4 * tap_words(leg);
  l.raw = o;
  o += (size_t)geo.stages * kBM * kSA * 4;
  l.accs = o;  // the sum over channels: 64 floats a consumer thread
  o += (size_t)kConsumerThreads * 64 * 4;
  l.patch = o;
  o += (size_t)geo.patch_buffers * 4 * patch_words(geo.patch_rows, geo.pitch, leg);
  l.etab = o;
  o += (size_t)geo.patch_buffers * geo.n_windows * kEP * 4;
  l.koff = o;  // tap -> patch offset
  o += (size_t)geo.ktab_len * 4;
  l.rowoff = o;  // row -> its taps in the stack, or -1
  o += (size_t)kBM * 8;
  l.bars = o;  // full, empty, raw full, raw empty (stages each), patch full and empty (2 each)
  o += (size_t)(4 * geo.stages + 4) * 8;
  l.rows = o;  // engine row or -1
  o += (size_t)kBM * 4;
  l.rslot = o;  // row's tile window
  o += (size_t)kBM * 4;
  l.win = o;  // tile windows (h, w)
  o += (size_t)2 * geo.n_windows * 4;
  l.total = o;
  return l;
}

// The consumers' A fragments of one chunk for one m64 fragment: 3xTF32
// (hi, lo) per k8 step, or bf16 pairs per k16 step. Element r of a k-step:
// position row gq + 8 (r % 2), tap t + 4 (r / 2) (TF32) or taps 2t, 2t + 1
// (+ 8 for r >= 2) (bf16).
template <Leg L>
struct Frag;
template <>
struct Frag<kSplit> {
  uint32_t hi[kKC / 8][4], lo[kKC / 8][4];
};
template <>
struct Frag<kFloat> : Frag<kSplit> {};
template <>
struct Frag<kBf16> {
  uint32_t v[kKC / 16][4];
};

// keeps a fragment's registers alive, unchanged, until here: the products
// read them asynchronously until the wait that retires them
template <Leg L>
__device__ __forceinline__ void hold(Frag<L>& a) {
  if constexpr (L == kBf16) {
#pragma unroll
    for (int ks = 0; ks < kKC / 16; ++ks)
#pragma unroll
      for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a.v[ks][r])::"memory");
  } else {
#pragma unroll
    for (int ks = 0; ks < kKC / 8; ++ks)
#pragma unroll
      for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a.hi[ks][r]), "+r"(a.lo[ks][r])::"memory");
  }
}

template <Leg L>
__device__ __forceinline__ void load_frag(Frag<L>& a, const void* patch, const int* ko, int off0,
                                          int off1, int t) {
  if constexpr (L == kBf16) {
    const unsigned short* pbf = static_cast<const unsigned short*>(patch);
#pragma unroll
    for (int ks = 0; ks < kKC / 16; ++ks) {
      const int k0 = ko[16 * ks + 2 * t], k1 = ko[16 * ks + 2 * t + 1];
      const int k2 = ko[16 * ks + 2 * t + 8], k3 = ko[16 * ks + 2 * t + 9];
      a.v[ks][0] = pbf[off0 + k0] | ((uint32_t)pbf[off0 + k1] << 16);
      a.v[ks][1] = pbf[off1 + k0] | ((uint32_t)pbf[off1 + k1] << 16);
      a.v[ks][2] = pbf[off0 + k2] | ((uint32_t)pbf[off0 + k3] << 16);
      a.v[ks][3] = pbf[off1 + k2] | ((uint32_t)pbf[off1 + k3] << 16);
    }
  } else {
#pragma unroll
    for (int ks = 0; ks < kKC / 8; ++ks) {
      const int k0 = ko[8 * ks + t], k1 = ko[8 * ks + t + 4];
      if constexpr (L == kSplit) {
        const uint2* p = static_cast<const uint2*>(patch);
        const uint2 v0 = p[off0 + k0], v1 = p[off1 + k0], v2 = p[off0 + k1], v3 = p[off1 + k1];
        a.hi[ks][0] = v0.x; a.hi[ks][1] = v1.x; a.hi[ks][2] = v2.x; a.hi[ks][3] = v3.x;
        a.lo[ks][0] = v0.y; a.lo[ks][1] = v1.y; a.lo[ks][2] = v2.y; a.lo[ks][3] = v3.y;
      } else {
        const float* p = static_cast<const float*>(patch);
        split_tf32(p[off0 + k0], a.hi[ks][0], a.lo[ks][0]);
        split_tf32(p[off1 + k0], a.hi[ks][1], a.lo[ks][1]);
        split_tf32(p[off0 + k1], a.hi[ks][2], a.lo[ks][2]);
        split_tf32(p[off1 + k1], a.hi[ks][3], a.lo[ks][3]);
      }
    }
  }
}

// One fragment's products of one chunk (the caller commits them): d is
// fresh (overwritten by its first product) when `fresh`, else accumulated.
// 3xTF32: lo*hi + hi*lo + hi*hi a k8 step, small terms first (lo*lo
// dropped, ~2^-22 relative).
template <Leg L>
__device__ __forceinline__ void products(float* d, const Frag<L>& a, const uint32_t* bstage,
                                         int fresh) {
  wgmma_fence();
  if constexpr (L == kBf16) {
#pragma unroll
    for (int ks = 0; ks < kKC / 16; ++ks) {
      // 16 taps = two 8-tap core matrices along K, kBM * 16 bytes apart
      const uint64_t desc = smem_desc(bstage + ks * 2 * kBM * 4, kBM * 16, 128);
      wgmma_bf16(d, a.v[ks], desc, ks > 0 || !fresh);
    }
  } else {
    const uint32_t* blo = bstage + kKC * kBM;
#pragma unroll
    for (int ks = 0; ks < kKC / 8; ++ks) {
      const uint64_t dhi = smem_desc(bstage + ks * 2 * kBM * 4, kBM * 16, 128);
      const uint64_t dlo = smem_desc(blo + ks * 2 * kBM * 4, kBM * 16, 128);
      wgmma_tf32(d, a.lo[ks], dhi, ks > 0 || !fresh);
      wgmma_tf32(d, a.hi[ks], dlo, 1);
      wgmma_tf32(d, a.hi[ks], dhi, 1);
    }
  }
}

__device__ __forceinline__ void add32(float* acc, const float* v) {
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] += v[i];
}

// One block: tile blockIdx.y of kBM sorted rows against kBN positions of one
// print (blockIdx.x = print * n_chunks + chunk, so the blocks that share a
// tile's taps run together), in leg L. Warpgroup 0 produces; consumer
// warpgroup w computes positions [128 w, 128 w + 128) against all kBM rows.
template <Leg L>
__global__ void __launch_bounds__(Roles<L>::kThreads, 1)
ncc_score_kernel(const float* __restrict__ p0,    // (C_pad, G, Hb, Wb)
                 const float* __restrict__ int1,  // (C_pad, G, Hb+1, Wb+1)
                 const float* __restrict__ int2,  // (C_pad, G, Hb+1, Wb+1)
                 const float* __restrict__ kern,  // (N, C, hk, wk)
                 const int* __restrict__ gvalid,  // (G, 2) post-crop valid
                 const int* __restrict__ plan,    // the host's tile plan, see ncc_score()
                 int* __restrict__ best,          // (N, G) encoded maxima
                 Geometry geo) {
  extern __shared__ __align__(128) unsigned char smem[];
  using R = Roles<L>;
  constexpr int kThreads = R::kThreads, kProducerThreads = 128 * R::kProducers;
  constexpr int kCopyWarps = R::kCopy, kConvertWarps = R::kConvert, kStageWarps = R::kStage;
  const Layout lay = layout_of(geo, L);
  const int PW = geo.pitch, PR = geo.patch_rows, IW = geo.Wb + 1;
  const int U = geo.n_windows, S = geo.stages, P = geo.patch_buffers;
  uint32_t* bstages = reinterpret_cast<uint32_t*>(smem + lay.bstages);
  float* raw = reinterpret_cast<float*>(smem + lay.raw);
  float* accs = reinterpret_cast<float*>(smem + lay.accs);
  unsigned char* patches = smem + lay.patch;
  const size_t patch_bytes = 4 * patch_words(PR, PW, L);
  float* etabs = reinterpret_cast<float*>(smem + lay.etab);
  int* koff = reinterpret_cast<int*>(smem + lay.koff);
  long long* rowoff = reinterpret_cast<long long*>(smem + lay.rowoff);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars);
  uint64_t* empty = full + S;
  uint64_t* raw_full = empty + S;
  uint64_t* raw_empty = raw_full + S;
  uint64_t* patch_full = raw_empty + S;
  uint64_t* patch_empty = patch_full + 2;
  int* rows = reinterpret_cast<int*>(smem + lay.rows);
  int* rslot = reinterpret_cast<int*>(smem + lay.rslot);
  int* win = reinterpret_cast<int*>(smem + lay.win);

  const int* order = plan;
  const int* row_slot = plan + geo.N;
  const int* taps = plan + 2 * geo.N + 5 * blockIdx.y;
  const int* tile_win = plan + 2 * geo.N + 5 * gridDim.y + 2 * U * blockIdx.y;

  const int tile = blockIdx.y;
  const int g = blockIdx.x / geo.n_chunks;
  const int q = blockIdx.x - g * geo.n_chunks;
  const int vh = gvalid[2 * g], vw = gvalid[2 * g + 1];
  const int npos = vh * vw;
  const int p_begin = q * kBN;
  if (p_begin >= npos) return;  // uniform: this print has fewer positions
  const int p_end = min(p_begin + kBN, npos);
  const int y_first = p_begin / vw, y_last = (p_end - 1) / vw;

  const int hk = geo.hk, wk = geo.wk, Hb = geo.Hb, Wb = geo.Wb;
  // the tile's tap rectangle, clipped to taps that reach the print's valid
  // region from at least one of this block's positions
  const int i_lo = max(taps[0], hk / 2 - y_last);
  const int i_hi = min(taps[0] + taps[1] - 1, vh - 1 + hk / 2 - y_first);
  const int j_lo = max(taps[2], wk / 2 - (vw - 1));
  const int j_hi = min(taps[2] + taps[3] - 1, vw - 1 + wk / 2);
  const int n_win = taps[4];  // distinct windows of the tile's rows
  const int kh = max(i_hi - i_lo + 1, 0), kw = max(j_hi - j_lo + 1, 0);
  const int K = kh * kw;
  const int nkc = (K + kKC - 1) / kKC;
  const int steps = geo.C * nkc;  // chunks: (channel, 32 taps)
  const int prb = (y_last - y_first) + kh;  // patch rows this block stages
  const int py0 = y_first + i_lo - hk / 2;  // print row of patch row 0
  // a plan made for other prints or rows than these would overrun the
  // staging buffers: stop instead
  if (prb > PR || n_win > U) __trap();

  const int tid = threadIdx.x;
  for (int k = tid; k < nkc * kKC; k += kThreads)  // K tail: zero taps against any patch value
    koff[k] = k < K ? (k / kw) * PW + j_lo + k % kw : 0;
  for (int m = tid; m < kBM; m += kThreads) {
    const int r = tile * kBM + m;
    const int n = r < geo.N ? order[r] : -1;
    rows[m] = n;
    rowoff[m] = n >= 0 ? (long long)n * geo.C * hk * wk : -1;
    rslot[m] = r < geo.N ? row_slot[r] : 0;  // rows past N: any window, result unused
  }
  for (int u = tid; u < 2 * n_win; u += kThreads) win[u] = tile_win[u];
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);                    // the converting warp
      mbar_init(&empty[s], kConsumers * 4);      // the consumers' warps
      mbar_init(&raw_full[s], 32 * kCopyWarps);  // each copying thread's copies
      mbar_init(&raw_empty[s], 1);               // the converting warp
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&patch_full[b], kStageWarps);     // the staging warps
      mbar_init(&patch_empty[b], kConsumers * 4);  // the consumers' warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int lane = tid % 32;
  if (tid < kProducerThreads) {
    // ---- the producer warpgroups: the tap ring's copies and conversion, and
    // each channel's patch and einv table
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R::kProducerRegs));
    if (steps == 0) return;
    const int pwarp = tid / 32;
    if (pwarp >= kCopyWarps + kConvertWarps) {
      // the staging warps, up to P channels ahead of the consumers; loads
      // batched so that several are in flight a lane
      const int sl = tid - 32 * (kCopyWarps + kConvertWarps);  // lane of the staging warps
      constexpr int kStride = 32 * kStageWarps;
      const int pelems = prb * PW;
      const int pitems = L == kBf16 ? (pelems + 1) / 2 : pelems;  // bf16: two elements an item
      auto pval = [&](const float* pc, int e) {
        const int r = e / PW, sx = e - r * PW;
        const int yy = py0 + r, xx = sx - wk / 2;
        return e < pelems && yy >= 0 && yy < Hb && xx >= 0 && xx < Wb ? __ldg(pc + yy * Wb + xx)
                                                                      : 0.f;
      };
      for (int c = 0; c < geo.C; ++c) {
        const int b = P == 2 ? c & 1 : 0;
        mbar_wait(&patch_empty[b], ((P == 2 ? c >> 1 : c) & 1) ^ 1);
        const float* pc = p0 + ((size_t)c * geo.G + g) * Hb * Wb;
        uint32_t* pw = reinterpret_cast<uint32_t*>(patches + b * patch_bytes);
        constexpr int kBatch = R::kStageBatch;
        for (int e0 = sl; e0 < pitems; e0 += kStride * kBatch) {
          float v[kBatch], v2[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int e = e0 + kStride * u;
            v[u] = pval(pc, L == kBf16 ? 2 * e : e);
            v2[u] = L == kBf16 ? pval(pc, 2 * e + 1) : 0.f;
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int e = e0 + kStride * u;
            if (e >= pitems) break;
            if constexpr (L == kBf16) {
              pw[e] = pack_bf16(v[u], v2[u]);
            } else if constexpr (L == kSplit) {
              uint32_t hi, lo;
              split_tf32(v[u], hi, lo);
              reinterpret_cast<uint2*>(pw)[e] = make_uint2(hi, lo);
            } else {
              pw[e] = __float_as_uint(v[u]);
            }
          }
        }
        float* etab = etabs + (size_t)b * U * kEP;
        const float* i1 = int1 + ((size_t)c * geo.G + g) * (Hb + 1) * IW;
        const float* i2 = int2 + ((size_t)c * geo.G + g) * (Hb + 1) * IW;
        constexpr int kEBatch = 1;
        for (int e0 = sl; e0 < n_win * kBN; e0 += kStride * kEBatch) {
          float c1[kEBatch][4], c2[kEBatch][4];
          int hw[kEBatch];
#pragma unroll
          for (int u = 0; u < kEBatch; ++u) {
            const int e = min(e0 + kStride * u, n_win * kBN - 1);
            const int w_ = e / kBN, pp = e - w_ * kBN;
            const int h = win[2 * w_], w = win[2 * w_ + 1];
            hw[u] = h * w;
            const int n = min(p_begin + pp, p_end - 1);
            const int y = n / vw, x = n - y * vw;
            const int lo_y = min(max(y - h / 2, 0), Hb) * IW;
            const int hi_y = min(max(y + (h - 1) / 2 + 1, 0), Hb) * IW;
            const int lo_x = min(max(x - w / 2, 0), Wb);
            const int hi_x = min(max(x + (w - 1) / 2 + 1, 0), Wb);
            c1[u][0] = __ldg(i1 + hi_y + hi_x);
            c1[u][1] = __ldg(i1 + lo_y + hi_x);
            c1[u][2] = __ldg(i1 + hi_y + lo_x);
            c1[u][3] = __ldg(i1 + lo_y + lo_x);
            c2[u][0] = __ldg(i2 + hi_y + hi_x);
            c2[u][1] = __ldg(i2 + lo_y + hi_x);
            c2[u][2] = __ldg(i2 + hi_y + lo_x);
            c2[u][3] = __ldg(i2 + lo_y + lo_x);
          }
#pragma unroll
          for (int u = 0; u < kEBatch; ++u) {
            const int e = e0 + kStride * u;
            if (e >= n_win * kBN) break;
            const float b1 = (c1[u][0] - c1[u][1]) - (c1[u][2] - c1[u][3]);
            const float b2 = (c2[u][0] - c2[u][1]) - (c2[u][2] - c2[u][3]);
            const float energy = fmaxf(b2 - b1 * b1 / (float)hw[u], 0.f);
            const int w_ = e / kBN;
            etab[w_ * kEP + (e - w_ * kBN)] = energy > 0.f ? 1.f / sqrtf(energy) : 0.f;
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&patch_full[b]);
      }
      return;
    }

    if (pwarp < kCopyWarps) {
      // the copies of each chunk (channel c, taps [32 kc, 32 kc + 32)) into
      // raw stage s % S once the converting warp has read it: lane = tap,
      // rows pwarp + kCopyWarps r, so a warp reads 32 neighbouring taps of
      // one row
      const size_t chw = (size_t)hk * wk;
      int c = 0, kc = 0, st = 0;
      uint32_t ph = 0;
      for (int s = 0; s < steps; ++s) {
        mbar_wait(&raw_empty[st], ph ^ 1);
        const int k = kc * kKC + lane;
        const bool k_ok = k < K;
        const int ii = k_ok ? k / kw : 0;
        const float* src =
            kern + c * chw + (size_t)(i_lo + ii) * wk + j_lo + (k_ok ? k - ii * kw : 0);
        float* dst = raw + st * (kBM * kSA) + lane;
        // the row offsets of a batch first, then its copies: a load
        // issued after a copy would wait for it
        constexpr int kRows = kBM / kCopyWarps, kB = 4;
#pragma unroll
        for (int r0 = 0; r0 < kRows; r0 += kB) {
          long long ro[kB];
#pragma unroll
          for (int u = 0; u < kB; ++u) ro[u] = rowoff[pwarp + kCopyWarps * (r0 + u)];
#pragma unroll
          for (int u = 0; u < kB; ++u) {
            const int m = pwarp + kCopyWarps * (r0 + u);
            const bool ok = k_ok && ro[u] >= 0;
            cp_async4(dst + m * kSA, ok ? src + ro[u] : kern, ok);
          }
        }
        cp_async_arrive(&raw_full[st]);
        if (++st == S) {
          st = 0;
          ph ^= 1;
        }
        if (++kc == nkc) {
          kc = 0;
          ++c;
        }
      }
    } else {
      // a converting warp: each of its landed chunks (every kConvertWarps-th)
      // into the products' planes of B stage s % S once the consumers have
      // freed it
      const int l4 = lane / 4, l1 = lane % 4;
      int st = pwarp - kCopyWarps;  // stage s % S and phase parity (s / S) % 2
      uint32_t ph = 0;
      for (int s = st; s < steps; s += kConvertWarps) {
        mbar_wait(&raw_full[st], ph);
        mbar_wait(&empty[st], ph ^ 1);
        const float* rs = raw + st * (kBM * kSA);
        uint32_t* bs = bstages + st * tap_words(L) + lane;
        if constexpr (L == kBf16) {
          // word lane + 32 i holds taps (2 p, 2 p + 1), p = lane % 4, of
          // row m = lane / 4 + 8 (i % 8) of the 8-tap core rows i / 8
          // (a batch's loads before its stores, which the compiler cannot
          // move them past)
          const float* r = rs + l4 * kSA + 2 * l1;
          constexpr int kB = 4;
#pragma unroll
          for (int i0 = 0; i0 < kBM * kKC / 64; i0 += kB) {
            float2 v[kB];
#pragma unroll
            for (int u = 0; u < kB; ++u) {
              const int i = i0 + u;
              v[u] = *reinterpret_cast<const float2*>(r + (i % 8) * 8 * kSA + (i / 8) * 8);
            }
#pragma unroll
            for (int u = 0; u < kB; ++u) bs[32 * (i0 + u)] = pack_bf16(v[u].x, v[u].y);
          }
        } else {
          // (hi, lo) planes in their own order: word lane + 32 i is tap
          // 4 (i / 8) + lane % 4 of row lane / 4 + 8 (i % 8); the raw
          // stage's pitch (36) puts a warp's reads on 32 banks
          const float* r = rs + l4 * kSA + l1;
          constexpr int kB = 8;
#pragma unroll
          for (int i0 = 0; i0 < kBM * kKC / 32; i0 += kB) {
            float v[kB];
#pragma unroll
            for (int u = 0; u < kB; ++u) {
              const int i = i0 + u;
              v[u] = r[(i % 8) * 8 * kSA + (i / 8) * 4];
            }
#pragma unroll
            for (int u = 0; u < kB; ++u) {
              uint32_t hi, lo;
              split_tf32(v[u], hi, lo);
              bs[32 * (i0 + u)] = hi;
              bs[kKC * kBM + 32 * (i0 + u)] = lo;
            }
          }
        }
        fence_async_shared();
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(&full[st]);
          mbar_arrive(&raw_empty[st]);
        }
        st += kConvertWarps;  // kConvertWarps <= 2 <= S
        if (st >= S) {
          st -= S;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // ---- the consumers: A fragments and wgmma only, then the epilogues
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R::kConsumerRegs));
  const int ct = tid - kProducerThreads;
  const int cw = ct / 128, warp = (ct / 32) % 4;
  const int gq = lane / 4, t = lane % 4;
  // fragment f's 16 positions of this warp: [pw0 + 64 f, pw0 + 64 f + 16)
  const int pw0 = 128 * cw + 16 * warp;
  // A fragment rows: positions pw0 + 64 f + gq (+ 8), clamped, as offsets
  // into the patch
  int off[2][2];
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = min(p_begin + pw0 + 64 * f + gq + 8 * h, p_end - 1);
      const int y = n / vw;
      off[f][h] = (y - y_first) * PW + (n - y * vw);
    }

  // fragment element 4 j + r: position pw0 + 64 f + gq + 8 (r / 2), row
  // 8 j + 2 t + (r % 2). part is a run's products (a chunk's in the 3xTF32
  // legs), which the run's first product overwrites; corr is the channel's
  // sum of its runs; the sum over channels of element i of fragment f is
  // acc[(32 f + i) * kConsumerThreads].
  float* acc = accs + ct;
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i * kConsumerThreads] = 0.f;
  float corr0[32], corr1[32], part0[32], part1[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) corr0[i] = corr1[i] = part0[i] = part1[i] = 0.f;
  constexpr int kRun = L == kBf16 ? kBf16Run : 1;

  // a channel's correlation of fragment f, scaled by its inverse window
  // energy, into the sum over channels
  auto epilogue = [&](float* corr, int f, const float* etab) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float* et = etab + rslot[8 * j + 2 * t + e] * kEP + pw0 + 64 * f + gq;
        const int i0 = 4 * j + e, i1 = 4 * j + 2 + e;
        float* a0 = acc + (32 * f + i0) * kConsumerThreads;
        float* a1 = acc + (32 * f + i1) * kConsumerThreads;
        *a0 = fmaf(corr[i0], et[0], *a0);
        *a1 = fmaf(corr[i1], et[8], *a1);
        corr[i0] = corr[i1] = 0.f;
      }
  };
  // Each chunk's products are done before its sums are read and before the
  // next chunk's A fragments load, so no product is in flight across a
  // loop edge (ptxas then keeps every wgmma asynchronous); the other
  // consumer warpgroup's products fill the tensor cores meanwhile.
  // Fragment 1's A loads go beside fragment 0's products.
  int st = 0;
  uint32_t ph = 0;
  for (int c = 0; c < geo.C && steps > 0; ++c) {
    const int b = P == 2 ? c & 1 : 0;
    mbar_wait(&patch_full[b], (P == 2 ? c >> 1 : c) & 1);
    const void* patch = patches + b * patch_bytes;
    for (int kc = 0; kc < nkc; ++kc) {
      Frag<L> a0, a1;
      const int* ko = koff + kc * kKC;
      const int fresh = kc % kRun == 0;
      load_frag<L>(a0, patch, ko, off[0][0], off[0][1], t);
      mbar_wait(&full[st], ph);
      __syncwarp();
      const uint32_t* bs = bstages + st * tap_words(L);
      pin(part0);
      pin(part1);
      products<L>(part0, a0, bs, fresh);
      load_frag<L>(a1, patch, ko, off[1][0], off[1][1], t);
      products<L>(part1, a1, bs, fresh);
      wgmma_commit();
      wgmma_wait<0>();
      hold(a0);
      hold(a1);
      pin(part0);
      pin(part1);
      if (kc % kRun == kRun - 1 || kc == nkc - 1) {  // a run ends: its sums join the channel's
        add32(corr0, part0);
        add32(corr1, part1);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
      if (++st == S) {
        st = 0;
        ph ^= 1;
      }
    }
    const float* etab = etabs + (size_t)b * U * kEP;
    epilogue(corr0, 0, etab);
    epilogue(corr1, 1, etab);
    __syncwarp();
    if (lane == 0) mbar_arrive(&patch_empty[b]);  // channel c's patch and table are read
  }

  // masked max over this warp's valid positions (both fragments), folded
  // into (row, g)
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = -INFINITY;
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        const int p = p_begin + pw0 + 64 * f + gq;
        if (p < p_end) v = fmaxf(v, acc[(32 * f + 4 * j + e) * kConsumerThreads]);
        if (p + 8 < p_end) v = fmaxf(v, acc[(32 * f + 4 * j + 2 + e) * kConsumerThreads]);
      }
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 8));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 16));
      const int n = rows[8 * j + 2 * t + e];
      if (gq == 0 && n >= 0 && v > -INFINITY) atomicMax(best + (size_t)n * geo.G + g, enc(v));
    }
}

template <Leg L>
int launch(const float* p0, const float* int1, const float* int2, const float* kern,
           const int* gvalid, const int* plan, int* best, const Geometry& geo, size_t smem,
           cudaStream_t s) {
  int rc = (int)cudaFuncSetAttribute(ncc_score_kernel<L>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != 0) return rc;
  const dim3 grid(geo.G * geo.n_chunks, (geo.N + kBM - 1) / kBM);
  ncc_score_kernel<L><<<grid, Roles<L>::kThreads, smem, s>>>(p0, int1, int2, kern, gvalid, plan,
                                                            best, geo);
  return (int)cudaGetLastError();
}

Geometry make_geometry(int Wb, int hk, int wk, int patch_rows, int n_windows) {
  Geometry geo{};
  geo.Wb = Wb;
  geo.hk = hk;
  geo.wk = wk;
  geo.patch_rows = patch_rows;
  geo.n_windows = n_windows;
  geo.pitch = Wb + wk - 1;
  geo.ktab_len = (hk * wk + kKC - 1) / kKC * kKC;
  return geo;
}

}  // namespace

extern "C" {

// The block tile (rows, positions, taps per staged chunk): the host's tile
// plan reads it here.
void ncc_score_tile(int* bm, int* bn, int* kc) {
  *bm = kBM;
  *bn = kBN;
  *kc = kKC;
}

// The roles of leg `precision` (0 3xTF32, 1 bf16): threads per block,
// producer and consumer warpgroups and the registers setmaxnreg gives a
// producer and a consumer thread. Returns 0, or cudaErrorInvalidValue.
int ncc_score_roles(int precision, int* threads, int* producers, int* consumers,
                    int* producer_regs, int* consumer_regs) {
  if (precision < 0 || precision > 1) return (int)cudaErrorInvalidValue;
  *threads = precision ? Roles<kBf16>::kThreads : Roles<kSplit>::kThreads;
  *producers = precision ? Roles<kBf16>::kProducers : Roles<kSplit>::kProducers;
  *consumers = kConsumers;
  *producer_regs = precision ? Roles<kBf16>::kProducerRegs : Roles<kSplit>::kProducerRegs;
  *consumer_regs = precision ? Roles<kBf16>::kConsumerRegs : Roles<kSplit>::kConsumerRegs;
  return 0;
}

// Tap-ring stages, patch buffers, layout and dynamic shared memory for these
// sizes: the first that fits the card's limit, in the order (layout, then
// two patch buffers, then one), the deepest ring first. Two buffers come
// first at any depth: with one, the staging warps stage each channel while
// the consumers wait. `precision` 0 is the
// 3xTF32 leg, whose layouts are the split patch, then the float patch;
// `patch` -1 takes either, 0 only the float patch, 1 only the split patch.
// `precision` 1 is the bf16 leg (its one layout; `patch` must be -1).
// `layout` is the Leg. Returns 0, or a CUDA error code when none fits.
int ncc_score_geometry(int Wb, int hk, int wk, int patch_rows, int n_windows, int precision,
                       int patch, int* stages, int* buffers, int* layout, long long* smem) {
  Geometry geo = make_geometry(Wb, hk, wk, patch_rows, n_windows);
  if (precision < 0 || precision > 1 || (precision == 1 && patch >= 0))
    return (int)cudaErrorInvalidValue;
  const Leg legs[3] = {kSplit, kFloat, kBf16};
  const int tries[2][3] = {{2, kMaxStages, 2}, {1, kMaxStages, 2}};
  for (int i = precision ? 2 : 0; i < (precision ? 3 : 2); ++i) {
    if (patch >= 0 && legs[i] != patch) continue;
    for (const auto& tr : tries)
      for (int s = tr[1]; s >= tr[2]; --s) {
        geo.patch_buffers = tr[0];
        geo.stages = s;
        const size_t bytes = layout_of(geo, legs[i]).total;
        if (bytes <= (size_t)kSmemLimit) {
          *stages = s;
          *buffers = tr[0];
          *layout = legs[i];
          *smem = (long long)bytes;
          return 0;
        }
      }
  }
  return (int)cudaErrorInvalidConfiguration;
}

// out[n, g] (float32, (N, G)) from device pointers; best is (N, G) int32
// scratch; kern is (N, C, hk, wk). `plan` is the host's tile plan as one
// int32 array: the engine row of each sorted row (N), each sorted row's
// window index within its tile (N), per tile (i0, h, j0, w, windows) (5 T)
// and per tile its n_windows distinct windows (h, w), tallest first
// (2 n_windows T). n_chunks and patch_rows bound every print's
// position blocks; `precision` and `patch` as in ncc_score_geometry.
// Launches on `stream` and returns cudaGetLastError().
int ncc_score(const float* p0, const float* int1, const float* int2, const float* kern,
              const int* gvalid, const int* plan, int* best, float* out, int C, int G, int N,
              int Hb, int Wb, int hk, int wk, int n_chunks, int patch_rows,
              int n_windows, int true_channels, int precision, int patch, void* stream) {
  if (C <= 0 || G <= 0 || N <= 0 || n_chunks <= 0 || patch_rows <= 0 ||
      n_windows <= 0 || (N + kBM - 1) / kBM > 65535 || (long long)G * n_chunks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Geometry geo = make_geometry(Wb, hk, wk, patch_rows, n_windows);
  geo.C = C;
  geo.G = G;
  geo.N = N;
  geo.Hb = Hb;
  geo.n_chunks = n_chunks;
  geo.true_channels = (float)true_channels;
  int layout = 0;
  long long smem = 0;
  int rc = ncc_score_geometry(Wb, hk, wk, patch_rows, n_windows, precision, patch, &geo.stages,
                              &geo.patch_buffers, &layout, &smem);
  if (rc != 0) return rc;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int count = N * G;
  fill_neg_inf<<<(count + 255) / 256, 256, 0, s>>>(best, count);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const size_t bytes = (size_t)smem;
  if (layout == kSplit)
    rc = launch<kSplit>(p0, int1, int2, kern, gvalid, plan, best, geo, bytes, s);
  else if (layout == kFloat)
    rc = launch<kFloat>(p0, int1, int2, kern, gvalid, plan, best, geo, bytes, s);
  else
    rc = launch<kBf16>(p0, int1, int2, kern, gvalid, plan, best, geo, bytes, s);
  if (rc != 0) return rc;
  finalize<<<(count + 255) / 256, 256, 0, s>>>(best, out, count, geo.true_channels);
  return (int)cudaGetLastError();
}

const char* ncc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
