// Matrix-unit rate probe for Hopper (sm_90a): FP32 FMA, 3xTF32 and bf16 mma.sync.
//
// Replaces the JAX package's Pallas TPU kernel benchmarks/mxu_probe.py::
// probe_pallas (inner `body`, pl.pallas_call at :50). For each of `grid`
// steps s it computes
//
//   out[s] = sum over y < y_iters of  a @ b          (accumulated in f32)
//
// with a (n, k), b (k, lanes) row-major and out (grid, n, lanes). Every
// step computes the same product: the point is the rate, not the result.
//
// The accumulator. The TPU body adds onto a VMEM scratch that is never
// zeroed and carries it from one grid step to the next (the grid runs in
// order on one core). Hopper blocks run in no order, so here every block
// zeroes its own accumulator and every grid step writes its own slice of
// `out`. As in the TPU body, each y-iteration's product is formed on its
// own and then added to the accumulator (a fresh fragment per iteration,
// added with an FP32 add), so the sum is that of the plain version
// ops/mma_probe.py::probe_plain, up to the order of the k sum.
//
// Precisions, one template:
//   F32     FP32 FMA on the CUDA cores (the JAX f32 leg at HIGHEST).
//   F32X3   the same f32 product on the tensor cores as 3xTF32:
//           mma.sync m16n8k8 TF32 with each operand split into
//           hi = tf32(x) and lo = tf32(x - hi) (cvt.rna.tf32.f32), and
//           d += lo*hi + hi*lo + hi*hi (lo*lo dropped, ~2^-22 relative).
//   BF16    bf16 inputs, mma.sync m16n8k16 with f32 accumulation (the JAX
//           bf16 leg).
//
// What bounds it on this card: operations, at the route's peak (FP32 67,
// TF32 495 with three products per f32 product, bf16 989 TFLOP/s); the
// operands are a few MB and out is written once. But neither operand fits
// one SM's shared memory (a is 2.4 MB at 512 x 1156 f32), so every
// y-iteration re-streams its K chunks from L2. A block owns a 64 x 128
// output tile and stages 32-deep K chunks: (64 + 128) * 32 elements moved
// per 2 * 64 * 128 * 32 FLOP, i.e. 0.047 B/FLOP in f32 and 0.023 in bf16.
// Ragged K (k = 1156 is no multiple of 8 or 16) and M (n = 1400 is no
// multiple of 64) tails are zero-filled when staged and masked when stored.
// Simple first: one shared-memory buffer, scalar loads, two barriers per
// chunk and no overlap of staging with the tensor cores; wgmma and TMA are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;        // output rows per block
constexpr int kBN = 128;       // output columns (lanes) per block
constexpr int kBK = 32;        // depth of one staged K chunk
constexpr int kThreads = 256;  // 8 warps: 2 (rows) x 4 (columns) of 32 x 32
constexpr int kAcc = 32;       // accumulators per thread: 64 * 128 / 256

enum Precision { F32 = 0, F32X3 = 1, BF16 = 2 };

template <int P>
struct Traits {
  using T = float;
  static constexpr int kPadA = 1;  // As row stride 33: the FMA loop reads As[m][k] as broadcasts
  static constexpr int kPadB = 0;
};
template <>
struct Traits<F32X3> {
  using T = float;
  static constexpr int kPadA = 4;  // stride 36 words: fragment rows g, columns t hit 32 banks
  static constexpr int kPadB = 8;  // stride 136 words: fragment rows t, columns g hit 32 banks
};
template <>
struct Traits<BF16> {
  using T = __nv_bfloat16;
  static constexpr int kPadA = 8;  // stride 40 halves = 20 words
  static constexpr int kPadB = 8;  // stride 136 halves = 68 words
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() { return __float2bfloat16(0.0f); }

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));  // x - hi is exact in f32
}

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two bf16 values as one 32-bit fragment register, the lower index in the
// low half (the mma.sync operand layout).
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// Accumulator index -> (row, column) in the block's 64 x 128 tile.
//   F32: thread (ty = tid / 16, tx = tid % 16) owns rows ty + 16 i (i < 4)
//        and columns tx + 16 j (j < 8); index i * 8 + j.
//   mma: warp w owns rows (w % 2) * 32 + [0, 32) and columns (w / 2) * 32 +
//        [0, 32) as 2 x 4 m16n8 tiles; index (mi * 4 + ni) * 4 + c, with c
//        the C-fragment register (rows g, g + 8; columns 2t, 2t + 1).
template <int P>
__device__ __forceinline__ void acc_coord(int idx, int tid, int& row, int& col) {
  if constexpr (P == F32) {
    row = tid / 16 + 16 * (idx / 8);
    col = tid % 16 + 16 * (idx % 8);
  } else {
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int tile = idx / 4, c = idx % 4;
    const int mi = tile / 4, ni = tile % 4;
    row = (warp % 2) * 32 + mi * 16 + g + (c >= 2 ? 8 : 0);
    col = (warp / 2) * 32 + ni * 8 + 2 * t + (c & 1);
  }
}

template <int P>
__global__ void __launch_bounds__(kThreads)
    mma_probe_kernel(const typename Traits<P>::T* __restrict__ a,
                     const typename Traits<P>::T* __restrict__ b, float* __restrict__ out,
                     int n, int k, int lanes, int y_iters) {
  using T = typename Traits<P>::T;
  constexpr int kSA = kBK + Traits<P>::kPadA;  // As[m][k] row stride
  constexpr int kSB = kBN + Traits<P>::kPadB;  // Bs[k][n] row stride
  __shared__ __align__(16) T As[kBM * kSA];
  __shared__ __align__(16) T Bs[kBK * kSB];

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kBN;  // first lane of the tile
  const int m0 = blockIdx.y * kBM;  // first row of the tile
  const int step = blockIdx.z;      // grid step: its own output slice
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = (warp % 2) * 32, wn = (warp / 2) * 32;

  float total[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) total[i] = 0.0f;

  for (int y = 0; y < y_iters; ++y) {
    float part[kAcc];  // this iteration's a @ b, added to total at its end
#pragma unroll
    for (int i = 0; i < kAcc; ++i) part[i] = 0.0f;

    for (int k0 = 0; k0 < k; k0 += kBK) {
      __syncthreads();  // every read of the previous chunk is done
      // stage A (64 x 32) and B (32 x 128), zero past the ragged edges;
      // neighbouring threads read neighbouring addresses of both operands
#pragma unroll
      for (int i = 0; i < kBM * kBK / kThreads; ++i) {
        const int e = tid + i * kThreads;
        const int r = e / kBK, kk = e % kBK;
        const int gr = m0 + r, gk = k0 + kk;
        As[r * kSA + kk] = (gr < n && gk < k) ? a[(size_t)gr * k + gk] : zero<T>();
      }
#pragma unroll
      for (int i = 0; i < kBK * kBN / kThreads; ++i) {
        const int e = tid + i * kThreads;
        const int kk = e / kBN, c = e % kBN;
        const int gk = k0 + kk, gc = n0 + c;
        Bs[kk * kSB + c] = (gk < k && gc < lanes) ? b[(size_t)gk * lanes + gc] : zero<T>();
      }
      __syncthreads();

      if constexpr (P == F32) {
        const int ty = tid / 16, tx = tid % 16;
#pragma unroll 4
        for (int kk = 0; kk < kBK; ++kk) {
          float av[4], bv[8];
#pragma unroll
          for (int i = 0; i < 4; ++i) av[i] = As[(ty + 16 * i) * kSA + kk];
#pragma unroll
          for (int j = 0; j < 8; ++j) bv[j] = Bs[kk * kSB + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) part[i * 8 + j] = fmaf(av[i], bv[j], part[i * 8 + j]);
        }
      } else if constexpr (P == F32X3) {
#pragma unroll
        for (int kk = 0; kk < kBK; kk += 8) {
          uint32_t ahi[2][4], alo[2][4], bhi[4][2], blo[4][2];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            const int r0 = wm + mi * 16 + g;
            // a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
            split_tf32(to_float(As[r0 * kSA + kk + t]), ahi[mi][0], alo[mi][0]);
            split_tf32(to_float(As[(r0 + 8) * kSA + kk + t]), ahi[mi][1], alo[mi][1]);
            split_tf32(to_float(As[r0 * kSA + kk + t + 4]), ahi[mi][2], alo[mi][2]);
            split_tf32(to_float(As[(r0 + 8) * kSA + kk + t + 4]), ahi[mi][3], alo[mi][3]);
          }
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            const int c = wn + ni * 8 + g;
            // b0 (k = t, n = g), b1 (k = t + 4, n = g)
            split_tf32(to_float(Bs[(kk + t) * kSB + c]), bhi[ni][0], blo[ni][0]);
            split_tf32(to_float(Bs[(kk + t + 4) * kSB + c]), bhi[ni][1], blo[ni][1]);
          }
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) {
              float* d = &part[(mi * 4 + ni) * 4];
              mma_tf32(d, alo[mi], bhi[ni]);  // small terms first
              mma_tf32(d, ahi[mi], blo[ni]);
              mma_tf32(d, ahi[mi], bhi[ni]);
            }
        }
      } else {  // BF16
#pragma unroll
        for (int kk = 0; kk < kBK; kk += 16) {
          uint32_t af[2][4], bf[4][2];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            const int r0 = wm + mi * 16 + g;
            const T* p0 = &As[r0 * kSA + kk + 2 * t];
            const T* p1 = &As[(r0 + 8) * kSA + kk + 2 * t];
            // a0 (g, 2t..2t+1), a1 (g + 8, 2t..), a2 (g, 2t+8..), a3 (g + 8, 2t+8..)
            af[mi][0] = *reinterpret_cast<const uint32_t*>(p0);
            af[mi][1] = *reinterpret_cast<const uint32_t*>(p1);
            af[mi][2] = *reinterpret_cast<const uint32_t*>(p0 + 8);
            af[mi][3] = *reinterpret_cast<const uint32_t*>(p1 + 8);
          }
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            const int c = wn + ni * 8 + g;
            const int k2 = kk + 2 * t;
            // b0 (k = 2t, 2t+1; n = g), b1 (k = 2t+8, 2t+9; n = g)
            bf[ni][0] = pack_bf16(Bs[k2 * kSB + c], Bs[(k2 + 1) * kSB + c]);
            bf[ni][1] = pack_bf16(Bs[(k2 + 8) * kSB + c], Bs[(k2 + 9) * kSB + c]);
          }
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) mma_bf16(&part[(mi * 4 + ni) * 4], af[mi], bf[ni]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kAcc; ++i) total[i] += part[i];
  }

  float* o = out + (size_t)step * n * lanes;
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    int r, c;
    acc_coord<P>(i, tid, r, c);
    if (m0 + r < n && n0 + c < lanes) o[(size_t)(m0 + r) * lanes + n0 + c] = total[i];
  }
}

template <int P>
int launch(const void* a, const void* b, float* out, int n, int k, int lanes, int y_iters,
           int grid, cudaStream_t s) {
  using T = typename Traits<P>::T;
  const dim3 blocks((lanes + kBN - 1) / kBN, (n + kBM - 1) / kBM, grid);
  mma_probe_kernel<P><<<blocks, kThreads, 0, s>>>(static_cast<const T*>(a),
                                                  static_cast<const T*>(b), out, n, k,
                                                  lanes, y_iters);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The block tile (rows, lanes, K depth) and threads per block, so that the
// wrapper's bytes-per-FLOP report matches what runs.
void mma_probe_tile(int* bm, int* bn, int* bk, int* threads) {
  *bm = kBM;
  *bn = kBN;
  *bk = kBK;
  *threads = kThreads;
}

// out (grid, n, lanes) float32 from a (n, k) and b (k, lanes), both float32
// (precision 0 = FP32 FMA, 1 = 3xTF32) or both bf16 (precision 2), all
// contiguous on one device. Launches on `stream` and returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments it refuses.
int mma_probe(const void* a, const void* b, float* out, int n, int k, int lanes, int y_iters,
              int grid, int precision, void* stream) {
  if (n <= 0 || k <= 0 || lanes <= 0 || y_iters < 0 || grid <= 0 || grid > 65535 ||
      (n + kBM - 1) / kBM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (precision) {
    case F32:
      return launch<F32>(a, b, out, n, k, lanes, y_iters, grid, s);
    case F32X3:
      return launch<F32X3>(a, b, out, n, k, lanes, y_iters, grid, s);
    case BF16:
      return launch<BF16>(a, b, out, n, k, lanes, y_iters, grid, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* mma_probe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
