// Fused NCC scorer for Hopper (sm_90a), FP32 on the CUDA cores.
//
// Replaces the JAX package's Pallas TPU kernel
// shoeprint_image_retrieval_tpu/ops/pallas/ncc_kernel.py::score_packed_operands
// (body _kernel_body). It computes, for every variant row n and print g,
//
//   out[n, g] = max over g's valid (y, x) of
//               sum_c corr_c[n, g, y, x] * einv_c[g, hw(n), y, x]   / C_true
//
// where corr_c is the centred "same" correlation of the folded template
// K[c, n] (hk x wk) with the demeaned print P0[c, g], and
// einv = 1 / sqrt(max(B2 - B1^2 / (h*w), 0)) (0 where the energy is 0), with
// B1, B2 the box sums of P0 and P0^2 over row n's post-crop window (h, w),
// clipped to the canvas. Semantics are those of the port's plain version,
// ops/ncc_direct.py::score_direct.
//
// What bounds it on this card: operations. At the main-path shapes
// (N = 1400 rows, C = 176, G = 300 prints of <= 42 x 42, a 34 x 34 canvas)
// one call does ~2.5e14 FLOP and must read only ~2.3 GB, i.e. ~1e5 FLOP per
// byte: far above the H100's ~20 FLOP/byte FP32 balance point.
//
// What the design does about it: every byte is reused from shared memory and
// registers, and the per-channel correlation and energy maps never reach
// device memory (writing einv alone would take ~32 GB at the main path).
// A block owns one print, 16 variant rows and 8 output rows (all columns).
// It loops over ALL channels itself (the TPU grid walked channels in order
// and carried the sum in VMEM; Hopper blocks run in no order, so the channel
// loop moves inside the block). Per channel it stages the 16 rows' taps, the
// print rows its outputs read and the print's two integral images in shared
// memory. Each thread holds an 8-row x 4-y register tile: per tap it reads
// two broadcast float4 tap vectors and one new print value (a 4-deep sliding
// window down the column) for 32 FMAs, so the FMA pipes, not shared memory,
// set the pace. The channel's einv is computed in the block from the
// integral images and applied per channel before the channel sum (it
// depends on c). After the last channel each thread takes the masked max of
// its tile and folds it into the (n, g) result with atomicMax on an
// order-preserving int encoding; blocks whose output rows all lie below the
// print's valid height exit at once. A later PR moves the correlation onto
// the tensor cores (3xTF32 wgmma) and overlaps staging with compute.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerThread = 8;   // variant rows in a thread's register tile
constexpr int kYPerThread = 4;      // output rows in a thread's register tile
constexpr int kMaxThreads = 512;

struct Geometry {
  int C, G, N, Hb, Wb, hk, wk;
  int nt;        // variant rows per block (multiple of kRowsPerThread)
  int ty;        // output rows per block (multiple of kYPerThread)
  int n_ytiles;  // ceil(Hb / ty)
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

__global__ void __launch_bounds__(kMaxThreads)
ncc_score_kernel(const float* __restrict__ p0,     // (C, G, Hb, Wb)
                 const float* __restrict__ int1,   // (C, G, Hb+1, Wb+1)
                 const float* __restrict__ int2,   // (C, G, Hb+1, Wb+1)
                 const float* __restrict__ kern,   // (C, N, hk, wk)
                 const int* __restrict__ row_hw,   // (N, 2) post-crop windows
                 const int* __restrict__ gvalid,   // (G, 2) post-crop valid
                 int* __restrict__ best,           // (N, G) encoded maxima
                 Geometry geo) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int g = blockIdx.x / geo.n_ytiles;
  const int y0 = (blockIdx.x % geo.n_ytiles) * geo.ty;
  const int n0 = blockIdx.y * geo.nt;
  const int vh = gvalid[2 * g];
  const int vw = gvalid[2 * g + 1];
  if (y0 >= vh) return;  // uniform: every output row is masked for this print

  const int Hb = geo.Hb, Wb = geo.Wb, hk = geo.hk, wk = geo.wk, nt = geo.nt;
  const int taps = hk * wk;
  const int pw = Wb + wk - 1;            // staged print row pitch
  const int ph = geo.ty + hk - 1;        // staged print rows
  const int iw = Wb + 1;                 // integral row pitch
  const int isize = (Hb + 1) * (Wb + 1);

  float* ks = smem;                      // taps: [tap][row], row fastest
  float* ps = ks + nt * taps;            // print rows with zero halo
  float* i1s = ps + ph * pw;             // integral image of P0
  float* i2s = i1s + isize;              // integral image of P0^2
  int* rhw = reinterpret_cast<int*>(i2s + isize);  // (nt, 2) windows

  const int tid = threadIdx.x;
  const int x = tid % Wb;
  const int rest = tid / Wb;
  const int y_groups = geo.ty / kYPerThread;
  const int yl = (rest % y_groups) * kYPerThread;   // local first output row
  const int rg = (rest / y_groups) * kRowsPerThread; // local first variant row

  for (int r = tid; r < nt; r += blockDim.x) {
    const int n = n0 + r;
    // padded rows get a 1x1 window: finite energy terms, result unused
    rhw[2 * r] = n < geo.N ? row_hw[2 * n] : 1;
    rhw[2 * r + 1] = n < geo.N ? row_hw[2 * n + 1] : 1;
  }

  float acc[kRowsPerThread][kYPerThread];
#pragma unroll
  for (int m = 0; m < kRowsPerThread; ++m)
#pragma unroll
    for (int t = 0; t < kYPerThread; ++t) acc[m][t] = 0.f;

  for (int c = 0; c < geo.C; ++c) {
    __syncthreads();  // the previous channel's reads of shared memory are done
    const float* kc = kern + ((size_t)c * geo.N + n0) * taps;
    for (int idx = tid; idx < nt * taps; idx += blockDim.x) {
      const int r = idx / taps;
      const int tap = idx - r * taps;
      ks[tap * nt + r] = (n0 + r < geo.N) ? kc[idx] : 0.f;
    }
    const float* pc = p0 + ((size_t)c * geo.G + g) * Hb * Wb;
    for (int idx = tid; idx < ph * pw; idx += blockDim.x) {
      const int r = idx / pw;
      const int s = idx - r * pw;
      const int gy = y0 - hk / 2 + r;
      const int gx = s - wk / 2;
      ps[idx] = (gy >= 0 && gy < Hb && gx >= 0 && gx < Wb) ? pc[gy * Wb + gx] : 0.f;
    }
    const size_t ioff = ((size_t)c * geo.G + g) * isize;
    for (int idx = tid; idx < isize; idx += blockDim.x) {
      i1s[idx] = int1[ioff + idx];
      i2s[idx] = int2[ioff + idx];
    }
    __syncthreads();

    // correlation: corr[m][t] = sum_ij K[rg+m][i][j] * P[yl+t+i][x+j]
    float corr[kRowsPerThread][kYPerThread];
#pragma unroll
    for (int m = 0; m < kRowsPerThread; ++m)
#pragma unroll
      for (int t = 0; t < kYPerThread; ++t) corr[m][t] = 0.f;

    for (int j = 0; j < wk; ++j) {
      const float* col = ps + yl * pw + x + j;
      float w0 = col[0], w1 = col[pw], w2 = col[2 * pw];
      const float* kj = ks + j * nt + rg;
#pragma unroll 2
      for (int i = 0; i < hk; ++i) {
        const float w3 = col[(i + 3) * pw];
        const float4 ka = *reinterpret_cast<const float4*>(kj + i * wk * nt);
        const float4 kb = *reinterpret_cast<const float4*>(kj + i * wk * nt + 4);
        const float kv[kRowsPerThread] = {ka.x, ka.y, ka.z, ka.w, kb.x, kb.y, kb.z, kb.w};
#pragma unroll
        for (int m = 0; m < kRowsPerThread; ++m) {
          corr[m][0] = fmaf(kv[m], w0, corr[m][0]);
          corr[m][1] = fmaf(kv[m], w1, corr[m][1]);
          corr[m][2] = fmaf(kv[m], w2, corr[m][2]);
          corr[m][3] = fmaf(kv[m], w3, corr[m][3]);
        }
        w0 = w1;
        w1 = w2;
        w2 = w3;
      }
    }

    // scale by this channel's inverse window energy and accumulate
#pragma unroll
    for (int m = 0; m < kRowsPerThread; ++m) {
      const int h = rhw[2 * (rg + m)];
      const int w = rhw[2 * (rg + m) + 1];
      const float area = (float)(h * w);
      const int lo_x = min(max(x - w / 2, 0), Wb);
      const int hi_x = min(max(x + (w - 1) / 2 + 1, 0), Wb);
#pragma unroll
      for (int t = 0; t < kYPerThread; ++t) {
        const int y = y0 + yl + t;
        const int lo_y = min(max(y - h / 2, 0), Hb);
        const int hi_y = min(max(y + (h - 1) / 2 + 1, 0), Hb);
        const float b1 = (i1s[hi_y * iw + hi_x] - i1s[lo_y * iw + hi_x]) -
                         (i1s[hi_y * iw + lo_x] - i1s[lo_y * iw + lo_x]);
        const float b2 = (i2s[hi_y * iw + hi_x] - i2s[lo_y * iw + hi_x]) -
                         (i2s[hi_y * iw + lo_x] - i2s[lo_y * iw + lo_x]);
        const float energy = fmaxf(b2 - b1 * b1 / area, 0.f);
        const float einv = energy > 0.f ? 1.f / sqrtf(energy) : 0.f;
        acc[m][t] = fmaf(corr[m][t], einv, acc[m][t]);
      }
    }
  }

  // masked max over this thread's valid positions, folded into (n, g)
  if (x >= vw) return;
#pragma unroll
  for (int m = 0; m < kRowsPerThread; ++m) {
    const int n = n0 + rg + m;
    if (n >= geo.N) break;
    float v = -INFINITY;
#pragma unroll
    for (int t = 0; t < kYPerThread; ++t) {
      if (y0 + yl + t < vh) v = fmaxf(v, acc[m][t]);
    }
    if (v > -INFINITY) atomicMax(best + (size_t)n * geo.G + g, enc(v));
  }
}

size_t smem_bytes(const Geometry& geo) {
  return sizeof(float) * ((size_t)geo.nt * geo.hk * geo.wk +
                          (size_t)(geo.ty + geo.hk - 1) * (geo.Wb + geo.wk - 1) +
                          2 * (size_t)(geo.Hb + 1) * (geo.Wb + 1)) +
         sizeof(int) * 2 * geo.nt;
}

}  // namespace

extern "C" {

// Launch geometry for the given shapes: variant rows and output rows per
// block, threads per block and dynamic shared memory. Returns 0, or a CUDA
// error code when no geometry fits the card's limits.
int ncc_score_geometry(int Hb, int Wb, int hk, int wk, int* nt, int* ty,
                       int* threads, long long* smem) {
  Geometry geo{};
  geo.Hb = Hb;
  geo.Wb = Wb;
  geo.hk = hk;
  geo.wk = wk;
  for (int rows = 2 * kRowsPerThread; rows >= kRowsPerThread; rows -= kRowsPerThread) {
    for (int ys = 2 * kYPerThread; ys >= kYPerThread; ys -= kYPerThread) {
      geo.nt = rows;
      geo.ty = ys;
      const int thr = Wb * (ys / kYPerThread) * (rows / kRowsPerThread);
      const size_t bytes = smem_bytes(geo);
      if (thr <= kMaxThreads && bytes <= 227 * 1024) {
        *nt = rows;
        *ty = ys;
        *threads = thr;
        *smem = (long long)bytes;
        return 0;
      }
    }
  }
  return (int)cudaErrorInvalidConfiguration;
}

// out[n, g] (float32, (N, G)) from device pointers; best is (N, G) int32
// scratch. Launches on `stream` and returns cudaGetLastError().
int ncc_score(const float* p0, const float* int1, const float* int2,
              const float* kern, const int* row_hw, const int* gvalid,
              int* best, float* out, int C, int G, int N, int Hb, int Wb,
              int hk, int wk, int true_channels, void* stream) {
  Geometry geo{};
  geo.C = C;
  geo.G = G;
  geo.N = N;
  geo.Hb = Hb;
  geo.Wb = Wb;
  geo.hk = hk;
  geo.wk = wk;
  geo.true_channels = (float)true_channels;
  int threads = 0;
  long long smem = 0;
  int rc = ncc_score_geometry(Hb, Wb, hk, wk, &geo.nt, &geo.ty, &threads, &smem);
  if (rc != 0) return rc;
  geo.n_ytiles = (Hb + geo.ty - 1) / geo.ty;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int count = N * G;
  fill_neg_inf<<<(count + 255) / 256, 256, 0, s>>>(best, count);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;

  rc = (int)cudaFuncSetAttribute(ncc_score_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
  if (rc != 0) return rc;
  dim3 grid(G * geo.n_ytiles, (N + geo.nt - 1) / geo.nt);
  ncc_score_kernel<<<grid, threads, smem, s>>>(p0, int1, int2, kern, row_hw,
                                               gvalid, best, geo);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;

  finalize<<<(count + 255) / 256, 256, 0, s>>>(best, out, count, geo.true_channels);
  return (int)cudaGetLastError();
}

const char* ncc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
