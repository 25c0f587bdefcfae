// The MultiscaleConvMax stage for Hopper (sm_90a), one launch per output
// scale.
//
// Replaces the TPU kernel mpnn_tpu/ops/kernels.py:fused_mcm_forward (body
// _mcm_kernel). It computes one scale j of the stage:
//
//   out[j] = b_j + conv3x3(x_j, wh_j) + conv3x3(pool2(out[j-1]), wv_{j-1})
//
// with SAME zero padding, fp32 accumulation and the output written in the
// input type (fp32 or bf16). The wrapper (ops/kernels.py:fused_mcm) launches
// the scales coarse-ward on one stream, so out[j-1] is complete when scale j
// starts. Layouts: activations NHWC, weights HWIO (= the (9*Cin, Cout)
// tap-major matrix of _pack_w), bias fp32.
//
// What bounds it on an H100 SXM: the bytes it must move are the L input
// scales, the weights and the L outputs, each once, over 3.35 TB/s; its
// operations are 2 * n_ops * B (n_ops = MultiscaleConvMax.n_ops) over the
// rate of the type: 67 TFLOP/s for fp32 outside the tensor cores, 989
// TFLOP/s for bf16 on them. At the flagship's widths (3-128 channels) the
// fp32 stages are bound by operations; in bf16 the wide, coarse stages are
// bound by operations and the others by bytes. chip_smoke.py computes both
// bounds for every stage from its shapes.
//
// What this simple design does about it: it runs on the FP32 pipes from
// registers and L1, with no shared memory. Each thread keeps a 4x4 tile in
// fp32 registers: QX=4 neighbouring output pixels by CO=4 output channels.
// A warp's threads take consecutive channel groups of the same pixels, so
// weight reads coalesce and input reads are shared. Input channels are read
// four at a time (one 16-byte load for fp32, 8-byte for bf16) where the
// count allows; per tap row, a window of QX+2 input vectors and 3x4 weight
// vectors feed 192 FMAs, where one channel a thread gave 12 FMAs per 9
// loads and took three times as long on an H100. The pooled previous scale is
// formed on the fly from out[j-1] (four loads and three maxes per value,
// served by L1/L2) and never goes to device memory, as in the TPU kernel.
// For bf16, pooling the bf16 outputs equals pooling the fp32 sums and then
// rounding, because max commutes with monotone rounding. Tensor cores
// (wgmma over an implicit-GEMM tile), TMA and staging tiles in shared memory
// are left for later work.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int KS = 3;         // taps per spatial dim
constexpr int QX = 4;         // output pixels along W per thread
constexpr int CO = 4;         // output channels per thread
constexpr int THREADS = 256;  // threads per block

// N consecutive values from p as floats: one 16-byte (fp32) or 8-byte
// (bf16) load when N == 4. The wrapper checks the 16-byte alignment of
// every base pointer, and offsets are multiples of N elements.
template <int N>
__device__ __forceinline__ void loadv(const float* p, float (&o)[N]) {
  if constexpr (N == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = __ldg(p + i);
  }
}
template <int N>
__device__ __forceinline__ void loadv(const __nv_bfloat16* p, float (&o)[N]) {
  if constexpr (N == 4) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = __bfloat162float(p[i]);
  }
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// acc[i][o] += conv3x3 at output (b, y, x0+i), channels co+o, over one
// input: x of shape (B, H, W, C), or with POOL the 2x2 max-pool of x of
// shape (B, 2H, 2W, C), pooled as it is read. w is HWIO (3, 3, C, Cout).
// Input channels go VC at a time (4 when C % 4 == 0, else 1).
template <typename T, bool POOL, int VC>
__device__ __forceinline__ void accumulate(float (&acc)[QX][CO],
                                           const T* __restrict__ x,
                                           const T* __restrict__ w, int b,
                                           int y, int x0, int H, int W,
                                           int C, int Cout, int co) {
  const int XW = POOL ? 2 * W : W;            // row length of x
  const long long kstep = (long long)C * Cout;  // one kx step in HWIO
  for (int ky = 0; ky < KS; ++ky) {
    const int yy = y + ky - 1;
    if (yy < 0 || yy >= H) continue;
    const T* r0 =
        x + ((long long)b * (POOL ? 2 * H : H) + (POOL ? 2 * yy : yy)) * XW * C;
    const T* r1 = r0 + (long long)XW * C;  // the pool's second row
    const T* wrow = w + (long long)ky * KS * kstep + co;
    for (int ci = 0; ci < C; ci += VC) {
      float v[QX + 2][VC];
#pragma unroll
      for (int i = 0; i < QX + 2; ++i) {
        const int xx = x0 + i - 1;
        if (xx >= 0 && xx < W) {
          if constexpr (POOL) {
            const long long o = 2LL * xx * C + ci;
            float a[VC], b2[VC], c[VC], d[VC];
            loadv<VC>(r0 + o, a);
            loadv<VC>(r0 + o + C, b2);
            loadv<VC>(r1 + o, c);
            loadv<VC>(r1 + o + C, d);
#pragma unroll
            for (int k = 0; k < VC; ++k)
              v[i][k] = fmaxf(fmaxf(a[k], b2[k]), fmaxf(c[k], d[k]));
          } else {
            loadv<VC>(r0 + (long long)xx * C + ci, v[i]);
          }
        } else {
#pragma unroll
          for (int k = 0; k < VC; ++k) v[i][k] = 0.f;
        }
      }
#pragma unroll
      for (int kx = 0; kx < KS; ++kx) {
#pragma unroll
        for (int k = 0; k < VC; ++k) {
          float wv[CO];
          loadv<CO>(wrow + kx * kstep + (long long)(ci + k) * Cout, wv);
#pragma unroll
          for (int i = 0; i < QX; ++i) {
#pragma unroll
            for (int o = 0; o < CO; ++o)
              acc[i][o] = fmaf(v[i + kx][k], wv[o], acc[i][o]);
          }
        }
      }
    }
  }
}

// One thread: output pixels (b, y, x0 .. x0+QX-1) x channels co .. co+CO-1.
// A warp's threads take consecutive channel groups of the same pixels
// first, so weight reads coalesce and input reads are shared. Two blocks an
// SM: up to 128 registers a thread for the 16 accumulators and the windows.
// x: (B, H, W, Cin); prev: (B, 2H, 2W, Cprev) or null; out: (B, H, W, Cout).
template <typename T, int VC>
__global__ void __launch_bounds__(THREADS, 2)
mcm_scale_kernel(const T* __restrict__ x, const T* __restrict__ wh,
                 const T* __restrict__ prev, const T* __restrict__ wv,
                 const float* __restrict__ bias, T* __restrict__ out,
                 int B, int H, int W, int Cin, int Cprev, int Cout) {
  const int nq = (W + QX - 1) / QX;
  const int ng = Cout / CO;
  const long long total = (long long)B * H * nq * ng;
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= total) return;
  const int co = (int)(t % ng) * CO;
  long long r = t / ng;
  const int x0 = (int)(r % nq) * QX;
  r /= nq;
  const int y = (int)(r % H);
  const int b = (int)(r / H);

  float acc[QX][CO];
#pragma unroll
  for (int o = 0; o < CO; ++o) {
    const float bv = bias[co + o];
#pragma unroll
    for (int i = 0; i < QX; ++i) acc[i][o] = bv;
  }
  accumulate<T, false, VC>(acc, x, wh, b, y, x0, H, W, Cin, Cout, co);
  if (prev != nullptr)
    accumulate<T, true, 4>(acc, prev, wv, b, y, x0, H, W, Cprev, Cout, co);

  T* op = out + (((long long)b * H + y) * W + x0) * Cout + co;
#pragma unroll
  for (int i = 0; i < QX; ++i) {
    if (x0 + i < W) {
#pragma unroll
      for (int o = 0; o < CO; ++o) store(op + (long long)i * Cout + o, acc[i][o]);
    }
  }
}

template <typename T, int VC>
cudaError_t launch(const void* x, const void* wh, const void* prev,
                   const void* wv, const void* bias, void* out, int B, int H,
                   int W, int Cin, int Cprev, int Cout, cudaStream_t stream) {
  const long long nq = (W + QX - 1) / QX;
  const long long total = (long long)B * H * nq * (Cout / CO);
  const long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks == 0) return cudaSuccess;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  mcm_scale_kernel<T, VC><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wh),
      static_cast<const T*>(prev), static_cast<const T*>(wv),
      static_cast<const float*>(bias), static_cast<T*>(out), B, H, W, Cin,
      Cprev, Cout);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const void* x, const void* wh, const void* prev,
                     const void* wv, const void* bias, void* out, int B,
                     int H, int W, int Cin, int Cprev, int Cout,
                     cudaStream_t stream) {
  if (Cin % 4 == 0)
    return launch<T, 4>(x, wh, prev, wv, bias, out, B, H, W, Cin, Cprev,
                        Cout, stream);
  return launch<T, 1>(x, wh, prev, wv, bias, out, B, H, W, Cin, Cprev, Cout,
                      stream);
}

}  // namespace

// Launch one output scale on `stream`. dtype: 0 = fp32, 1 = bf16 (x, wh,
// prev, wv and out share it; bias is fp32). prev and wv are null for the
// finest kept scale. Cout and Cprev must be multiples of 4, and every
// pointer 16-byte aligned. Returns the launch's cudaError_t (0 on success).
extern "C" int mcm_scale_forward(const void* x, const void* wh,
                                 const void* prev, const void* wv,
                                 const void* bias, void* out, int B, int H,
                                 int W, int Cin, int Cprev, int Cout,
                                 int dtype, void* stream) {
  if (B < 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || Cout % CO != 0 ||
      (prev != nullptr && (wv == nullptr || Cprev <= 0 || Cprev % 4 != 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch_t<float>(x, wh, prev, wv, bias, out, B, H, W, Cin,
                                  Cprev, Cout, s);
    case 1:
      return (int)launch_t<__nv_bfloat16>(x, wh, prev, wv, bias, out, B, H,
                                          W, Cin, Cprev, Cout, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* mcm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
