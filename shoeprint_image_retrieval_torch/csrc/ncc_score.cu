// Fused NCC scorer for Hopper (sm_90a): a 3xTF32 tensor-core implicit GEMM,
// with a bf16 leg for tpu.precision = "bfloat16".
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
// bound is the needed FLOP at 495 / 3 TFLOP/s: 725 ms. What holds it back
// now is not memory: the operands are staged once a chunk and reused from
// shared memory and registers, and the per-channel correlation and energy
// maps never reach device memory. It is the work around the tensor cores,
// which each step does before its products start (the split of the taps,
// two barriers, the staging copies) and which the products do not yet overlap,
// and the 1.6x of the needed FLOP it executes at tile and block
// granularity (chip_smoke.py reports both, the latter from a host model).
//
// The design:
// - Per channel the correlation is an implicit GEMM: M = 256 output
//   positions of one print (its valid positions, row-major, so only a
//   print's last block holds positions past its valid region), N = a tile
//   of 64 variant rows, K = the tile's taps. A is the staged print patch
//   read in place at im2col addresses (position offset + tap offset) into
//   registers; no im2col matrix exists anywhere. B is the tile's taps in
//   shared memory. The print patch is read from device memory (L2: every
//   tile's blocks read the same prints) and split once per channel.
// - Tap windows. The host's tile plan (ops/ncc_kernel.py::row_plan) orders
//   the rows by post-crop window, so a tile's rows have similar windows, and
//   gives each tile the centred (max h, max w) sub-rectangle of the canvas
//   that holds every nonzero tap of its rows. Each block further clips the
//   rectangle to the tap rows and columns that land inside the print's valid
//   region for at least one of its positions (p0 is zero elsewhere). Both
//   skips drop only exact zeros.
// - 3xTF32 on wgmma: each warpgroup (4 of them, 512 threads) runs
//   wgmma.mma_async m64n64k8 TF32 with A from registers (its 64 positions)
//   and B from shared memory (K-major, no swizzle: tap k of row n at
//   [k / 4][n][k % 4]). Each operand x is split into hi = tf32(x) and
//   lo = tf32(x - hi) (cvt.rna.tf32.f32), and d += lo*hi + hi*lo + hi*hi
//   (lo*lo dropped, ~2^-22 relative). The patch is split once per
//   channel into (hi, lo) pairs; each staged tap chunk is split into two
//   planes in the layout the products read, double-buffered so that one
//   step's products may still run while the next step's taps are split.
// - Sums: the tensor cores round each product's sum into their FP32
//   accumulator toward zero, so a long run of products into one
//   accumulator drifts by up to an ulp of the running sum per product (one
//   accumulator over a channel's 1156 taps drifted ~1e-5 in the scores).
//   So each 32-tap chunk's 12 products go into a fresh fragment, and the
//   chunks join the channel's sum by FP32 adds on the CUDA cores (rounded
//   to nearest). The sum over channels lives in shared memory (64 KB a
//   block), so the registers hold two fragments, the chunk's and the
//   channel's. A warpgroup whose 64 positions all lie past the print skips
//   its products.
// - Staging: a ring of 3 (or 2, when shared memory is short) stages filled
//   with cp.async over (channel, 32-tap chunk): the next chunks' taps load
//   while the tensor cores work on the current chunk. The copies are 4
//   bytes wide: a clipped tap run does not start 16-byte aligned in
//   general.
// - Large canvases: the patch a block stages grows with the kernel canvas
//   and the print's width ((rows + hk - 1) x (Wb + wk - 1)). Where its
//   split (hi, lo) pairs do not fit shared memory even with 2 stages (a
//   73 x 73 canvas over 88-wide prints: fusion's stride-8 block of a
//   stride-16 cluster), the block stages the patch as plain floats and
//   splits each A element as it reads it: half the patch bytes, the same
//   products and sums (bit-identical), more work per product, one A buffer
//   instead of two and its k-steps not unrolled (the registers the split
//   needs: 122, no spills), so a k-step's loads wait for the previous
//   k-step's products.
// - Epilogue per channel: the channel's correlation is scaled by
//   einv(c, row window, position) and added to the sum over channels.
//   einv depends on the row only through its window, and sorted tiles hold
//   few distinct windows, so each block computes it once per channel for
//   every (tile window, position) into a shared-memory table, from the
//   integral images in device memory. After
//   the last channel the masked max over valid positions is folded into
//   (order[row], g) with atomicMax on an order-preserving int encoding;
//   finalize divides by C.
// - Only the stack's true channels are looped over, not the cache's
//   padding channels (zero prints: they add exact zeros).
// - The bf16 leg (the JAX kernel's compute_dtype = bfloat16: both operands
//   of the correlation rounded to bf16, f32 accumulation; the window
//   energies stay f32) runs the same blocks, staging and epilogue on
//   wgmma.mma_async m64n64k16 bf16. It reads the same f32 operands and
//   rounds them where the 3xTF32 leg splits them, round-to-nearest-even
//   (cvt.rn.bf16x2.f32, as torch's and XLA's casts round): the patch once a
//   channel, into bf16 (a quarter of the split patch's bytes, so one layout
//   fits every canvas the 3xTF32 leg takes), and each staged tap chunk into
//   one bf16 plane, K-major with 8-tap core matrices: tap k of row n at
//   [k / 8][n][k % 8]. A k16 A fragment pairs taps (k, k + 1) of one
//   position in a register; consecutive taps are neighbouring patch columns
//   at any alignment, or the last tap of one tap row and the first of the
//   next, so each element is loaded alone (16 bits) and the pair packed.
//   A 32-tap chunk is two k16 products against twelve TF32 products.
//   Products of bf16 values are exact in f32, but the accumulator still
//   truncates, so runs of kBf16Run chunks (8: 256 taps) share a fragment
//   and join the channel's sum by f32 adds. At the main-path shapes every
//   run length up to a whole channel stayed within 1e-5 of the plain
//   version, the drift growing with the run, and longer runs took a few
//   per cent less time (PERF.md); a fixed run bounds the drift at any
//   canvas. Its bound is the needed
//   FLOP at the bf16 rate, 989 TFLOP/s: ~121 ms at the main-path shapes.
//   The staging copies, the rounding pass and the barriers weigh ~6x more a
//   product than in the 3xTF32 leg, and the products do not overlap them.
//   The tap chunks are the same 32 taps, so the FLOP it executes are the
//   3xTF32 leg's (ops/ncc_kernel.py::executed_flop).
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
// outside the canvas read as zeros.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;        // variant rows per tile (block rows)
constexpr int kBN = 256;       // output positions per block
constexpr int kKC = 32;        // taps per staged chunk
constexpr int kThreads = 512;  // 4 warpgroups, 64 positions x 64 rows each
constexpr int kSA = kKC + 4;   // staged taps [m][k], stride 36 words: 8 rows x 4 taps hit 32 banks
constexpr int kEP = kBN + 8;   // einv table row stride: 4 windows' rows on distinct banks
constexpr int kSmemLimit = 227 * 1024;
constexpr int kBf16Run = 8;     // the bf16 leg's chunks a fragment (the 3xTF32 legs: 1)

// the kernel's legs: 3xTF32 with the patch staged as floats split where
// read (kFloat) or split once a channel into (hi, lo) pairs (kSplit), or
// bf16 with the patch rounded once a channel (kBf16); the values are the
// layout codes ncc_score_geometry reports
enum Leg : int { kFloat = 0, kSplit = 1, kBf16 = 2 };

struct Geometry {
  int C, G, N, Hb, Wb, hk, wk;
  int n_chunks;    // position blocks per print (the most any print needs)
  int patch_rows;  // staged print rows a block needs at most
  int n_windows;   // distinct windows a tile holds at most
  int pitch;       // staged patch row pitch: Wb + wk - 1
  int ktab_len;    // hk * wk rounded up to kKC
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
// plus d itself when Acc is 1
template <int Acc>
__device__ __forceinline__ void wgmma_tf32(float* d, const uint32_t* a, uint64_t desc) {
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(Acc));
}
// the same product in bf16: a (64 x 16, from registers, bf16 pairs) *
// b (16 x 64, K-major bf16 in shared memory), f32 accumulation
template <int Acc>
__device__ __forceinline__ void wgmma_bf16(float* d, const uint32_t* a, uint64_t desc) {
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(Acc));
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
// 16-byte halves of a k8 step
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a >> 4) & 0x3fff) | ((uint64_t)((lbo >> 4) & 0x3fff) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3fff) << 32);
}

// 4-byte asynchronous copy global -> shared; zero-fills when !valid (no
// bytes are read then).
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 32-bit words of the staged patch: (hi, lo) pairs, plain floats or bf16,
// rounded up to whole 8-byte words (the row offsets after it are 8-byte
// values)
__host__ __device__ __forceinline__ size_t patch_words(int patch_rows, int pitch, Leg leg) {
  const size_t elems = (size_t)patch_rows * pitch;
  return leg == kSplit ? 2 * elems : leg == kFloat ? (elems + 1) / 2 * 2 : (elems + 3) / 4 * 2;
}

// 32-bit words of the two tap buffers the products read: (hi, lo) planes,
// or one bf16 plane
__host__ __device__ constexpr int tap_words(Leg leg) { return (leg == kBf16 ? 1 : 4) * kKC * kBM; }

size_t smem_bytes(int stages, Leg leg, const Geometry& geo) {
  return 4 * (size_t)tap_words(leg) +                              // the products' taps x 2
         4 * 32 * (size_t)kThreads +                               // channel-sum accumulator
         4 * patch_words(geo.patch_rows, geo.pitch, leg) + 8 * kBM +  // patch, row offsets
         4 * ((size_t)geo.n_windows * kEP +                        // einv table
              (size_t)stages * kBM * kSA +                         // staged taps
              2 * (size_t)geo.ktab_len + 2 * kBM + 2 * (size_t)geo.n_windows);
}

// One block: tile blockIdx.y of kBM sorted rows against kBN positions of one
// print (blockIdx.x = print * n_chunks + chunk, so the blocks that share a
// tile's taps run together). Warpgroup wg computes positions
// [64 wg, 64 wg + 64) of the block against all kBM rows, in leg L.
template <int S, Leg L>
__global__ void __launch_bounds__(kThreads, 1)
ncc_score_kernel(const float* __restrict__ p0,    // (C_pad, G, Hb, Wb)
                 const float* __restrict__ int1,  // (C_pad, G, Hb+1, Wb+1)
                 const float* __restrict__ int2,  // (C_pad, G, Hb+1, Wb+1)
                 const float* __restrict__ kern,  // (N, C, hk, wk)
                 const int* __restrict__ gvalid,  // (G, 2) post-crop valid
                 const int* __restrict__ plan,    // the host's tile plan, see ncc_score()
                 int* __restrict__ best,          // (N, G) encoded maxima
                 Geometry geo) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int PW = geo.pitch, PR = geo.patch_rows, IW = geo.Wb + 1;
  const int U = geo.n_windows;
  // the products' taps, K-major in wgmma's canonical no-swizzle form: split
  // (hi, lo) planes with tap k of row n at [k / 4][n][k % 4], or one bf16
  // plane with it at [k / 8][n][k % 8] (two buffers, alternating by step,
  // so one step's products can still run while the next step's taps are
  // split or rounded)
  uint32_t* bsplit = reinterpret_cast<uint32_t*>(smem_raw);
  // the sum over channels, element i of thread tid at [i][tid]: each
  // thread reads and writes only its own 32 words
  float* accs = reinterpret_cast<float*>(bsplit + tap_words(L));
  // the patch, pitch PW: (hi, lo) pairs, floats or bf16
  uint32_t* patchw = reinterpret_cast<uint32_t*>(accs + 32 * kThreads);
  uint2* patch = reinterpret_cast<uint2*>(patchw);
  const float* praw = reinterpret_cast<const float*>(patchw);
  const unsigned short* pbf = reinterpret_cast<const unsigned short*>(patchw);
  long long* rowoff = reinterpret_cast<long long*>(  // row's tap slab
      patchw + patch_words(PR, PW, L));
  float* etab = reinterpret_cast<float*>(rowoff + kBM);  // einv per (tile window, position)
  float* araw = etab + (size_t)U * kEP;
  int* ktab = reinterpret_cast<int*>(araw + S * kBM * kSA);  // tap -> tap slab offset
  int* koff = ktab + geo.ktab_len;                                     // tap -> patch offset
  int* rows = koff + geo.ktab_len;                                     // engine row or -1
  int* rslot = rows + kBM;                                             // row's tile window
  int* win = rslot + kBM;                                              // tile windows (h, w)

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
  const int steps = geo.C * nkc;
  const int prb = (y_last - y_first) + kh;  // patch rows this block stages
  const int py0 = y_first + i_lo - hk / 2;  // print row of patch row 0
  // a plan made for other prints or rows than these would overrun the
  // staging buffers: stop instead
  if (prb > PR || n_win > U) __trap();

  const int tid = threadIdx.x;
  for (int k = tid; k < nkc * kKC; k += kThreads) {
    if (k < K) {
      const int i = i_lo + k / kw, j = j_lo + k % kw;
      ktab[k] = i * wk + j;
      koff[k] = (i - i_lo) * PW + j;
    } else {  // K tail: zero taps against any patch value
      ktab[k] = -1;
      koff[k] = 0;
    }
  }
  for (int m = tid; m < kBM; m += kThreads) {
    const int r = tile * kBM + m;
    const int n = r < geo.N ? order[r] : -1;
    rows[m] = n;
    rowoff[m] = n >= 0 ? (long long)n * geo.C * hk * wk : -1;
    rslot[m] = r < geo.N ? row_slot[r] : 0;  // rows past N: any window, result unused
  }
  for (int u = tid; u < 2 * n_win; u += kThreads) win[u] = tile_win[u];
  __syncthreads();

  // stage `step` = (channel, tap chunk): the taps of the tile's rows; one
  // commit group per call
  auto issue = [&](int step) {
    if (step < steps) {
      const int c = step / nkc, kc = step - c * nkc, slot = step % S;
      float* as = araw + slot * kBM * kSA;
      for (int e = tid; e < kBM * kKC; e += kThreads) {
        const int m = e / kKC, kk = e % kKC;  // neighbouring threads on neighbouring taps
        const int kt = ktab[kc * kKC + kk];
        const long long ro = rowoff[m];
        const bool ok = ro >= 0 && kt >= 0;
        const float* src = ok ? kern + ro + c * hk * wk + kt : kern;
        cp_async4(as + m * kSA + kk, src, ok);
      }
    }
    cp_async_commit();
  };

  const int warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, t = lane % 4;
  const int wg = warp / 4;                      // warpgroup: positions [64 wg, 64 wg + 64)
  const int pw0 = 64 * wg + 16 * (warp % 4);    // this warp's 16 positions

  // A fragment rows: positions pw0 + gq and pw0 + gq + 8 (clamped), as
  // offsets into the patch
  int off[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = min(p_begin + pw0 + gq + 8 * h, p_end - 1);
    const int y = n / vw;
    off[h] = (y - y_first) * PW + (n - y * vw);
  }

  // fragment element 4 j + r: position pw0 + gq + 8 (r / 2), row
  // 8 j + 2 t + (r % 2). part is one run's products (a chunk's in the
  // 3xTF32 legs), which the run's first product overwrites; corr is the
  // channel's sum of its runs.
  float* acc = accs + tid;  // element i at acc[i * kThreads]
  float corr[32], part[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i * kThreads] = 0.f;
  // a warpgroup whose positions all lie past the print skips its products
  // (uniform over the warpgroup, as wgmma needs)
  const bool wg_live = p_begin + 64 * wg < p_end;

#pragma unroll
  for (int s = 0; s < S - 1; ++s) issue(s);

  for (int step = 0; step < steps; ++step) {
    cp_async_wait<S - 2>();
    // stage `step` has landed; every read of step - 1 is done, and of the
    // products only step - 1's last k-step can still be running
    __syncthreads();
    issue(step + S - 1);
    const int c = step / nkc, kc = step - c * nkc, slot = step % S;
    uint32_t* bhi = bsplit + (step & 1) * (tap_words(L) / 2);
    uint32_t* blo = bhi + kKC * kBM;  // the 3xTF32 legs' lo plane
    const float* as = araw + slot * kBM * kSA;
    if constexpr (L == kBf16) {
      // the chunk's taps rounded to bf16 in the products' layout: word e
      // holds taps (2 p, 2 p + 1) of one 8-tap core row, p = e % 4
      for (int e = tid; e < kBM * kKC / 2; e += kThreads) {
        const int m = (e / 4) % kBM, kk = (e / (4 * kBM)) * 8 + 2 * (e % 4);
        const float2 v = *reinterpret_cast<const float2*>(as + m * kSA + kk);
        bhi[e] = pack_bf16(v.x, v.y);
      }
    } else {
      // the chunk's taps as (hi, lo) in the products' layout, walked in that
      // layout's order: a warp writes 32 consecutive words and reads 8 rows
      // x 4 taps of the staged chunk, whose pitch (36) puts them on 32 banks
      for (int e = tid; e < kBM * kKC; e += kThreads) {
        const int m = (e / 4) % kBM, kk = (e / (4 * kBM)) * 4 + e % 4;
        uint32_t hi, lo;
        split_tf32(as[m * kSA + kk], hi, lo);
        bhi[e] = hi;
        blo[e] = lo;
      }
    }
    if (kc == 0) {
      // the channel's patch as (hi, lo) pairs, floats or bf16, and its
      // inverse window energy for every (tile window, position) from the
      // integral images, read once a channel from device memory (L2: every
      // tile's blocks read the same print)
      const float* pc = p0 + ((size_t)c * geo.G + g) * Hb * Wb;
      const int pelems = prb * PW;
      auto pval = [&](int e) {
        const int r = e / PW, sx = e - r * PW;
        const int yy = py0 + r, xx = sx - wk / 2;
        return e < pelems && yy >= 0 && yy < Hb && xx >= 0 && xx < Wb ? pc[yy * Wb + xx] : 0.f;
      };
      if constexpr (L == kBf16) {
        // two elements a word; the last word's second half past the patch is 0
        for (int e = tid; e < (pelems + 1) / 2; e += kThreads)
          patchw[e] = pack_bf16(pval(2 * e), pval(2 * e + 1));
      } else {
#pragma unroll 4
        for (int e = tid; e < pelems; e += kThreads) {
          const float v = pval(e);
          if constexpr (L == kSplit) {
            uint32_t hi, lo;
            split_tf32(v, hi, lo);
            patch[e] = make_uint2(hi, lo);
          } else {
            patchw[e] = __float_as_uint(v);
          }
        }
      }
      const size_t ib = ((size_t)c * geo.G + g) * (Hb + 1) * IW;
      const float* i1 = int1 + ib;
      const float* i2 = int2 + ib;
      for (int e = tid; e < n_win * kBN; e += kThreads) {
        const int u = e / kBN, pp = e - u * kBN;
        const int h = win[2 * u], w = win[2 * u + 1];
        const int n = min(p_begin + pp, p_end - 1);
        const int y = n / vw, x = n - y * vw;
        const int lo_y = min(max(y - h / 2, 0), Hb);
        const int hi_y = min(max(y + (h - 1) / 2 + 1, 0), Hb);
        const int lo_x = min(max(x - w / 2, 0), Wb);
        const int hi_x = min(max(x + (w - 1) / 2 + 1, 0), Wb);
        const float b1 = (i1[hi_y * IW + hi_x] - i1[lo_y * IW + hi_x]) -
                         (i1[hi_y * IW + lo_x] - i1[lo_y * IW + lo_x]);
        const float b2 = (i2[hi_y * IW + hi_x] - i2[lo_y * IW + hi_x]) -
                         (i2[hi_y * IW + lo_x] - i2[lo_y * IW + lo_x]);
        const float energy = fmaxf(b2 - b1 * b1 / (float)(h * w), 0.f);
        etab[u * kEP + pp] = energy > 0.f ? 1.f / sqrtf(energy) : 0.f;
      }
      // the previous channel's products were waited for by its epilogue
#pragma unroll
      for (int i = 0; i < 32; ++i) corr[i] = 0.f;
    }
    // the split taps are read by the tensor cores' asynchronous proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (!wg_live) continue;
    // chunks a fragment: one in the 3xTF32 legs, kBf16Run in the bf16 leg
    constexpr int kRun = L == kBf16 ? kBf16Run : 1;
    if (kc > 0 && kc % kRun == 0) {
      // the previous run's products, which ran on beside this step's
      // split, join the channel's sum in FP32
      wgmma_wait<0>();
      pin(part);
#pragma unroll
      for (int i = 0; i < 32; ++i) corr[i] += part[i];
    }

    const int* ko = koff + kc * kKC;
    if constexpr (L == kBf16) {
      // two k16 steps a chunk; A double-buffered, so that a k-step's loads
      // overlap the previous k-step's product
      uint32_t a[2][4];
#pragma unroll
      for (int ks = 0; ks < kKC / 16; ++ks) {
        const int cur = ks % 2;
        wgmma_wait<1>();  // the product that read this A buffer is done
        // a[0] (pos g, taps 2t, 2t + 1), a[1] (pos g + 8, the same taps),
        // a[2] (pos g, taps 2t + 8, 2t + 9), a[3] (pos g + 8, the same)
        const int k0 = ko[16 * ks + 2 * t], k1 = ko[16 * ks + 2 * t + 1];
        const int k2 = ko[16 * ks + 2 * t + 8], k3 = ko[16 * ks + 2 * t + 9];
        a[cur][0] = pbf[off[0] + k0] | ((uint32_t)pbf[off[0] + k1] << 16);
        a[cur][1] = pbf[off[1] + k0] | ((uint32_t)pbf[off[1] + k1] << 16);
        a[cur][2] = pbf[off[0] + k2] | ((uint32_t)pbf[off[0] + k3] << 16);
        a[cur][3] = pbf[off[1] + k2] | ((uint32_t)pbf[off[1] + k3] << 16);
        // 16 taps = two 8-tap core matrices along K, kBM * 16 bytes apart
        const uint64_t desc = smem_desc(bhi + ks * 2 * kBM * 4, kBM * 16, 128);
        pin(part);
        wgmma_fence();
        if (ks == 0 && kc % kRun == 0)  // a run's first product starts its fragment
          wgmma_bf16<0>(part, a[cur], desc);
        else
          wgmma_bf16<1>(part, a[cur], desc);
        wgmma_commit();
      }
    } else {
    // A fragments, double-buffered so that a k-step's loads overlap the
    // previous k-step's products; one buffer with the float patch, whose
    // split where it is read needs the registers
    constexpr int kABuf = L == kSplit ? 2 : 1;
    uint32_t ahi[kABuf][4], alo[kABuf][4];
    // the float patch's k-steps are not unrolled: unrolled, they spill
    constexpr int kKsUnroll = L == kSplit ? kKC / 8 : 1;
#pragma unroll (kKsUnroll)
    for (int ks = 0; ks < kKC / 8; ++ks) {
      const int cur = ks % kABuf;
      wgmma_wait<kABuf - 1>();  // the products that read this A buffer are done
      const int k0 = ko[8 * ks + t], k1 = ko[8 * ks + t + 4];
      // a0 (pos g, tap t), a1 (pos g + 8, tap t), a2 (pos g, tap t + 4),
      // a3 (pos g + 8, tap t + 4)
      if constexpr (L == kSplit) {
        const uint2 v0 = patch[off[0] + k0], v1 = patch[off[1] + k0];
        const uint2 v2 = patch[off[0] + k1], v3 = patch[off[1] + k1];
        ahi[cur][0] = v0.x; ahi[cur][1] = v1.x; ahi[cur][2] = v2.x; ahi[cur][3] = v3.x;
        alo[cur][0] = v0.y; alo[cur][1] = v1.y; alo[cur][2] = v2.y; alo[cur][3] = v3.y;
      } else {
        split_tf32(praw[off[0] + k0], ahi[cur][0], alo[cur][0]);
        split_tf32(praw[off[1] + k0], ahi[cur][1], alo[cur][1]);
        split_tf32(praw[off[0] + k1], ahi[cur][2], alo[cur][2]);
        split_tf32(praw[off[1] + k1], ahi[cur][3], alo[cur][3]);
      }
      const uint64_t dhi = smem_desc(bhi + ks * 2 * kBM * 4, kBM * 16, 128);
      const uint64_t dlo = smem_desc(blo + ks * 2 * kBM * 4, kBM * 16, 128);
      pin(part);
      wgmma_fence();
      if (ks == 0)
        wgmma_tf32<0>(part, alo[cur], dhi);  // small terms first
      else
        wgmma_tf32<1>(part, alo[cur], dhi);
      wgmma_tf32<1>(part, ahi[cur], dlo);
      wgmma_tf32<1>(part, ahi[cur], dhi);
      wgmma_commit();
    }
    }

    if (kc == nkc - 1) {
      wgmma_wait<0>();
      pin(part);
      // scale this channel's correlation by its inverse window energy
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float* et = etab + rslot[8 * j + 2 * t + e] * kEP + pw0 + gq;
          const int i0 = 4 * j + e, i1 = 4 * j + 2 + e;
          acc[i0 * kThreads] = fmaf(corr[i0] + part[i0], et[0], acc[i0 * kThreads]);
          acc[i1 * kThreads] = fmaf(corr[i1] + part[i1], et[8], acc[i1 * kThreads]);
        }
    }
  }
  cp_async_wait<0>();  // only empty groups can be pending here

  // masked max over this warp's valid positions, folded into (row, g)
  const bool ok0 = p_begin + pw0 + gq < p_end, ok1 = p_begin + pw0 + gq + 8 < p_end;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = fmaxf(ok0 ? acc[(4 * j + e) * kThreads] : -INFINITY,
                      ok1 ? acc[(4 * j + 2 + e) * kThreads] : -INFINITY);
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 8));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 16));
      const int n = rows[8 * j + 2 * t + e];
      if (gq == 0 && n >= 0 && v > -INFINITY) atomicMax(best + (size_t)n * geo.G + g, enc(v));
    }
}

template <int S, Leg L>
int launch(const float* p0, const float* int1, const float* int2, const float* kern,
           const int* gvalid, const int* plan, int* best, const Geometry& geo, size_t smem,
           cudaStream_t s) {
  int rc = (int)cudaFuncSetAttribute(ncc_score_kernel<S, L>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != 0) return rc;
  const dim3 grid(geo.G * geo.n_chunks, (geo.N + kBM - 1) / kBM);
  ncc_score_kernel<S, L><<<grid, kThreads, smem, s>>>(p0, int1, int2, kern, gvalid, plan, best,
                                                      geo);
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

// The block tile (rows, positions, taps per staged chunk) and threads per
// block: the host's tile plan reads them here.
void ncc_score_tile(int* bm, int* bn, int* kc, int* threads) {
  *bm = kBM;
  *bn = kBN;
  *kc = kKC;
  *threads = kThreads;
}

// Stages, layout and dynamic shared memory for these sizes. `precision` 0
// is the 3xTF32 leg: the first that fits the card's limit of 3 stages with
// the split patch, 2 with it, 3 with the float patch, 2 with it; `patch` -1
// takes either layout, 0 only the float patch, 1 only the split patch.
// `precision` 1 is the bf16 leg (its one patch layout; `patch` must be -1):
// 3 stages, else 2. `layout` is the Leg. Returns 0, or a CUDA error code
// when none fits.
int ncc_score_geometry(int Wb, int hk, int wk, int patch_rows, int n_windows, int precision,
                       int patch, int* stages, int* layout, long long* smem) {
  const Geometry geo = make_geometry(Wb, hk, wk, patch_rows, n_windows);
  if (precision < 0 || precision > 1 || (precision == 1 && patch >= 0))
    return (int)cudaErrorInvalidValue;
  const Leg legs[3] = {kSplit, kFloat, kBf16};
  for (int i = precision ? 2 : 0; i < (precision ? 3 : 2); ++i)
    for (int s = 3; s >= 2; --s) {
      if (patch >= 0 && legs[i] != patch) continue;
      const size_t bytes = smem_bytes(s, legs[i], geo);
      if (bytes <= (size_t)kSmemLimit) {
        *stages = s;
        *layout = legs[i];
        *smem = (long long)bytes;
        return 0;
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
  int stages = 0, layout = 0;
  long long smem = 0;
  int rc = ncc_score_geometry(Wb, hk, wk, patch_rows, n_windows, precision, patch, &stages,
                              &layout, &smem);
  if (rc != 0) return rc;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int count = N * G;
  fill_neg_inf<<<(count + 255) / 256, 256, 0, s>>>(best, count);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const size_t bytes = (size_t)smem;
#define NCC_LAUNCH(S, L) launch<S, L>(p0, int1, int2, kern, gvalid, plan, best, geo, bytes, s)
  if (layout == kSplit)
    rc = stages == 3 ? NCC_LAUNCH(3, kSplit) : NCC_LAUNCH(2, kSplit);
  else if (layout == kFloat)
    rc = stages == 3 ? NCC_LAUNCH(3, kFloat) : NCC_LAUNCH(2, kFloat);
  else
    rc = stages == 3 ? NCC_LAUNCH(3, kBf16) : NCC_LAUNCH(2, kBf16);
#undef NCC_LAUNCH
  if (rc != 0) return rc;
  finalize<<<(count + 255) / 256, 256, 0, s>>>(best, out, count, geo.true_channels);
  return (int)cudaGetLastError();
}

const char* ncc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
