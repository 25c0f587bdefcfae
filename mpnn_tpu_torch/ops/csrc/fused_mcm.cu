// The MultiscaleConvMax stage for Hopper (sm_90a), one launch per output
// scale, for one net or for a sweep of N nets at once.
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
// tap-major matrix of _pack_w), bias fp32. The pooled previous scale is
// formed while it is read (four loads and three maxes per value) and never
// goes to device memory, as in the TPU kernel. Pooling the rounded outputs
// of scale j-1 equals pooling their fp32 sums and then rounding, because max
// commutes with monotone rounding.
//
// What bounds it on an H100 SXM: the bytes it must move are the L input
// scales, the weights and the L outputs, each once, over 3.35 TB/s; its
// operations are 2 * n_ops * B (n_ops = MultiscaleConvMax.n_ops) over the
// rate of the type: 67 TFLOP/s for fp32 outside the tensor cores, 989
// TFLOP/s for bf16 on them. At the flagship's widths (3-128 channels) the
// fp32 stages are bound by operations. In bf16, stages 0-4 (32^2 to 8^2,
// 3-64 channels) are bound by bytes and stages 5-7 (8^2 and 4^2, 64-128
// channels) by operations. chip_smoke.py computes both bounds for every
// stage from its shapes.
//
// bf16 (the serving type): an implicit GEMM on the tensor cores. Scale j is
// the product of M = B*H*W output pixels (rows over batch and space) by
// N = Cout, over K = 9*Cin taps of x_j followed by 9*Cprev taps of
// pool2(out[j-1]); both segments accumulate into the same fp32 registers,
// and the epilogue adds the bias and rounds to bf16 once. A block owns BM
// pixels by BN (up to 128) output channels, which is all of Cout at the
// flagship's widths, so each staged input feeds every output channel. Each
// K step is one tap and 16 input channels: the block stages an A tile
// (BM x 16, zero where the tap leaves the image or past the channel count)
// and a B tile (16 rows of the weight matrix by BN) in shared memory. The
// steps go three to a barrier, from registers loaded one group ahead (a
// double buffer), so each thread has three loads in flight. Each warp takes
// 16 rows: ldmatrix (.trans for the row-major B) feeds
// mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32. The A rows are 24 bf16 apart
// (48 bytes: 16-byte aligned, and the 8 rows an ldmatrix phase reads fall
// in distinct banks), the B rows BN + 8. Channel counts that are a
// multiple of 8 are read as 16-byte vectors, others (stage 0's 3) one value
// at a time. BM = 64: at batch 1024 it is as fast as 128 on the 32^2
// stages and faster on the deep ones, whose M = 16,384 gives 256 blocks
// instead of 128 on 132 SMs. What bounds this design is latency, not
// bytes or operations: each group of K steps waits for its global loads
// and a barrier, and a small M (the routed engine's 32-row buffers) leaves
// most SMs idle. Next steps: more K steps in flight (a cp.async ring, or a
// halo tile of the input read by all 9 taps), wgmma with TMA-fed tiles,
// and the scale chain kept on chip with one launch per stage.
//
// The net axis (mcm_scale_forward_nets): a vmapped k_cpt sweep trains N
// nets of one architecture on one shared batch. Each launch then computes
// scale j for all N nets: the grid gains a dimension over nets (y in fp32,
// z in bf16), and each block offsets its six pointers by net x that
// tensor's per-net element stride; a stride of 0 shares the tensor by
// every net (stage 0's pyramid, made from the shared batch). Everything
// else is the single-net kernel, so a net's outputs are bit for bit those
// of a single-net launch on its tensors. The wrapper keeps every net's
// slice 16-byte aligned.
//
// fp32 (the checks' type): the FP32 pipes, from registers and L1, with no
// shared memory. Each thread keeps a 4x4 tile in fp32 registers: QX=4
// neighbouring output pixels by CO=4 output channels. A warp's threads take
// consecutive channel groups of the same pixels, so weight reads coalesce
// and input reads are shared. Input channels are read four at a time (one
// 16-byte load) where the count allows; per tap row, a window of QX+2 input
// vectors and 3x4 weight vectors feed 192 FMAs. Without TF32 this beats
// cuDNN's fp32 convs at the flagship's shapes.

#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// Per-net element strides of the six tensors (0: shared by every net).
struct NetStrides {
  long long x, wh, prev, wv, bias, out;
};

constexpr int KS = 3;  // taps per spatial dim
constexpr int CO = 4;  // output channels per fp32 thread, and the unit of Cout

// ---------------------------------------------------------------- fp32 ----

constexpr int QX = 4;         // output pixels along W per thread
constexpr int THREADS = 256;  // threads per block

// N consecutive floats from p: one 16-byte load when N == 4. The wrapper
// checks the 16-byte alignment of every base pointer, and offsets are
// multiples of N elements.
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

// acc[i][o] += conv3x3 at output (b, y, x0+i), channels co+o, over one
// input: x of shape (B, H, W, C), or with POOL the 2x2 max-pool of x of
// shape (B, 2H, 2W, C), pooled as it is read. w is HWIO (3, 3, C, Cout).
// Input channels go VC at a time (4 when C % 4 == 0, else 1).
template <bool POOL, int VC>
__device__ __forceinline__ void accumulate(float (&acc)[QX][CO],
                                           const float* __restrict__ x,
                                           const float* __restrict__ w, int b,
                                           int y, int x0, int H, int W,
                                           int C, int Cout, int co) {
  const int XW = POOL ? 2 * W : W;            // row length of x
  const long long kstep = (long long)C * Cout;  // one kx step in HWIO
  for (int ky = 0; ky < KS; ++ky) {
    const int yy = y + ky - 1;
    if (yy < 0 || yy >= H) continue;
    const float* r0 =
        x + ((long long)b * (POOL ? 2 * H : H) + (POOL ? 2 * yy : yy)) * XW * C;
    const float* r1 = r0 + (long long)XW * C;  // the pool's second row
    const float* wrow = w + (long long)ky * KS * kstep + co;
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
template <int VC>
__global__ void __launch_bounds__(THREADS, 2)
mcm_scale_kernel(const float* __restrict__ x, const float* __restrict__ wh,
                 const float* __restrict__ prev, const float* __restrict__ wv,
                 const float* __restrict__ bias, float* __restrict__ out,
                 int B, int H, int W, int Cin, int Cprev, int Cout,
                 NetStrides ns) {
  const long long net = blockIdx.y;
  x += net * ns.x;
  wh += net * ns.wh;
  if (prev != nullptr) {
    prev += net * ns.prev;
    wv += net * ns.wv;
  }
  bias += net * ns.bias;
  out += net * ns.out;
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
  accumulate<false, VC>(acc, x, wh, b, y, x0, H, W, Cin, Cout, co);
  if (prev != nullptr)
    accumulate<true, 4>(acc, prev, wv, b, y, x0, H, W, Cprev, Cout, co);

  float* op = out + (((long long)b * H + y) * W + x0) * Cout + co;
#pragma unroll
  for (int i = 0; i < QX; ++i) {
    if (x0 + i < W) {
#pragma unroll
      for (int o = 0; o < CO; ++o) op[(long long)i * Cout + o] = acc[i][o];
    }
  }
}

template <int VC>
cudaError_t launch_fp32(const void* x, const void* wh, const void* prev,
                        const void* wv, const void* bias, void* out, int N,
                        const NetStrides& ns, int B, int H, int W, int Cin,
                        int Cprev, int Cout, cudaStream_t stream) {
  const long long nq = (W + QX - 1) / QX;
  const long long total = (long long)B * H * nq * (Cout / CO);
  const long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks == 0) return cudaSuccess;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)N);
  mcm_scale_kernel<VC><<<grid, THREADS, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(wh),
      static_cast<const float*>(prev), static_cast<const float*>(wv),
      static_cast<const float*>(bias), static_cast<float*>(out), B, H, W,
      Cin, Cprev, Cout, ns);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- bf16 ----

using bf16 = __nv_bfloat16;

constexpr int KSTEP = 16;  // K of one mma step: one tap, 16 input channels
constexpr int KGROUP = 3;  // K steps staged per barrier; divides 9 * chunks
constexpr int A_LD = 24;   // A tile row stride in bf16 (48 bytes)
constexpr int BM_BF16 = 64;  // output pixels a block owns

// Channels c .. c+7 of one pixel (p points at channel c) as four bf16
// pairs; n_valid of them exist and the rest read as zeros. vec: the channel
// count is a multiple of 8, so the eight are one aligned 16-byte vector.
__device__ __forceinline__ uint4 load8(const bf16* p, int n_valid, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t lo = 2 * i < n_valid ? __ldg(q + 2 * i) : 0u;
    const uint32_t hi = 2 * i + 1 < n_valid ? __ldg(q + 2 * i + 1) : 0u;
    w[i] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Elementwise max of two bf16 pairs.
__device__ __forceinline__ uint32_t max2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("max.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint4 max4(uint4 a, uint4 b, uint4 e, uint4 f) {
  return make_uint4(max2(max2(a.x, b.x), max2(e.x, f.x)),
                    max2(max2(a.y, b.y), max2(e.y, f.y)),
                    max2(max2(a.z, b.z), max2(e.z, f.z)),
                    max2(max2(a.w, b.w), max2(e.w, f.w)));
}

// Where the K loop is: segment 0 runs over the 9 taps x ceil(Cin/16)
// channel chunks of x, segment 1 over those of pool2(prev) with Cprev.
struct KPos {
  int seg, tap, c0;
};

__device__ __forceinline__ void advance(KPos& k, int Cin, int Cprev) {
  k.c0 += KSTEP;
  if (k.c0 >= (k.seg ? Cprev : Cin)) {
    k.c0 = 0;
    if (++k.tap == KS * KS) {
      k.tap = 0;
      ++k.seg;
    }
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a) : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a) : "memory");
}

// d += a (16x16, row-major) * b (16x8, column-major), fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One block: output pixels m0 .. m0+BM-1 (flattened over b, y, x) by
// channels n0 .. n0+BN-1, with 2*BM threads: BM/16 warps of 16 rows each.
// x: (B, H, W, Cin); prev: (B, 2H, 2W, Cprev) or null; out: (B, H, W, Cout).
template <int BM, int BN>
__global__ void __launch_bounds__(2 * BM)
mcm_scale_mma(const bf16* __restrict__ x, const bf16* __restrict__ wh,
              const bf16* __restrict__ prev, const bf16* __restrict__ wv,
              const float* __restrict__ bias, bf16* __restrict__ out, int B,
              int H, int W, int Cin, int Cprev, int Cout, NetStrides ns) {
  constexpr int NTHREADS = 2 * BM;
  constexpr int NT = BN / 8;        // mma n-tiles a warp holds
  constexpr int B_LD = BN + 8;      // B tile row stride in bf16
  constexpr int B_ROW4 = BN / 4;    // 4-channel (8-byte) chunks in a B row
  constexpr int B_PER_THREAD = (KSTEP * B_ROW4 + NTHREADS - 1) / NTHREADS;
  __shared__ __align__(16) bf16 As[2][KGROUP][BM][A_LD];
  __shared__ __align__(16) bf16 Bs[2][KGROUP][KSTEP][B_LD];

  const long long net = blockIdx.z;
  x += net * ns.x;
  wh += net * ns.wh;
  if (prev != nullptr) {
    prev += net * ns.prev;
    wv += net * ns.wv;
  }
  bias += net * ns.bias;
  out += net * ns.out;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long M = (long long)B * H * W;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // A staging: this thread stages channels ah .. ah+7 of row ar.
  const int ar = tid >> 1, ah = (tid & 1) * 8;
  const long long am = m0 + ar;
  const bool arow = am < M;
  int ax = 0, ay = 0;
  long long ab = 0;
  if (arow) {
    ax = (int)(am % W);
    const long long r = am / W;
    ay = (int)(r % H);
    ab = r / H;
  }
  const bool vec_x = Cin % 8 == 0, vec_p = Cprev % 8 == 0;

  // Global -> registers for the K step at k: the A row's 8 channels and
  // this thread's 8-byte chunks of the B tile, zero where out of range.
  auto fetch = [&](const KPos& k, uint4& ra, uint2 (&rb)[B_PER_THREAD]) {
    const bool pool = k.seg != 0;
    const int C = pool ? Cprev : Cin;
    const int ky = k.tap / KS, kx = k.tap % KS;
    const int yy = ay + ky - 1, xx = ax + kx - 1, c = k.c0 + ah;
    ra = make_uint4(0, 0, 0, 0);
    if (arow && yy >= 0 && yy < H && xx >= 0 && xx < W && c < C) {
      const int nv = min(8, C - c);
      if (!pool) {
        ra = load8(x + ((ab * H + yy) * W + xx) * Cin + c, nv, vec_x);
      } else {
        const bf16* p = prev + ((ab * 2 * H + 2 * yy) * 2 * W + 2 * xx) *
                                   (long long)Cprev + c;
        const long long rs = 2LL * W * Cprev;  // one row of prev
        ra = max4(load8(p, nv, vec_p), load8(p + Cprev, nv, vec_p),
                  load8(p + rs, nv, vec_p), load8(p + rs + Cprev, nv, vec_p));
      }
    }
    const bf16* w = pool ? wv : wh;
#pragma unroll
    for (int i = 0; i < B_PER_THREAD; ++i) {
      const int q = tid + i * NTHREADS;
      const int row = q / B_ROW4, n = n0 + (q % B_ROW4) * 4;
      rb[i] = make_uint2(0, 0);
      if (row < KSTEP && k.c0 + row < C && n < Cout)
        rb[i] = __ldg(reinterpret_cast<const uint2*>(
            w + ((long long)k.tap * C + k.c0 + row) * Cout + n));
    }
  };
  auto stage = [&](int buf, int u, const uint4& ra,
                   const uint2 (&rb)[B_PER_THREAD]) {
    *reinterpret_cast<uint4*>(&As[buf][u][ar][ah]) = ra;
#pragma unroll
    for (int i = 0; i < B_PER_THREAD; ++i) {
      const int q = tid + i * NTHREADS;
      if (q < KSTEP * B_ROW4)
        *reinterpret_cast<uint2*>(
            &Bs[buf][u][q / B_ROW4][(q % B_ROW4) * 4]) = rb[i];
    }
  };

  const int n_steps = KS * KS * ((Cin + KSTEP - 1) / KSTEP +
                                 (prev ? (Cprev + KSTEP - 1) / KSTEP : 0));
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  // K steps go KGROUP to a barrier, loaded into registers one group
  // ahead (KGROUP loads in flight per thread), so the load latency and the
  // barrier are paid once per group.
  KPos k{0, 0, 0};  // the next K step to fetch
  uint4 ra[KGROUP];
  uint2 rb[KGROUP][B_PER_THREAD];
  auto fetch_group = [&]() {
#pragma unroll
    for (int u = 0; u < KGROUP; ++u) {
      fetch(k, ra[u], rb[u]);
      advance(k, Cin, Cprev);
    }
  };
  auto stage_group = [&](int buf) {
#pragma unroll
    for (int u = 0; u < KGROUP; ++u) stage(buf, u, ra[u], rb[u]);
  };
  const int n_groups = n_steps / KGROUP;
  fetch_group();
  stage_group(0);
  __syncthreads();
  for (int g = 0; g < n_groups; ++g) {
    const int cur = g & 1;
    const bool more = g + 1 < n_groups;
    if (more) fetch_group();  // in flight during this group's products
#pragma unroll
    for (int u = 0; u < KGROUP; ++u) {
      uint32_t a[4];
      ldsm_x4(a, &As[cur][u][warp * 16 + (lane & 15)][(lane >> 4) * 8]);
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        uint32_t b[4];
        ldsm_x4_trans(b, &Bs[cur][u][lane & 15][j * 16 + (lane >> 4) * 8]);
        mma_bf16(acc[2 * j], a, b[0], b[1]);
        mma_bf16(acc[2 * j + 1], a, b[2], b[3]);
      }
    }
    // The other buffer was last read before the previous barrier.
    if (more) stage_group(cur ^ 1);
    __syncthreads();
  }

  // Epilogue: thread holds rows g and g+8 of its warp's 16, columns
  // 2t, 2t+1 of each n-tile. Bias, one rounding, bf16 pairs to NHWC.
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long m = m0 + warp * 16 + g + 8 * h;
    if (m >= M) continue;
    bf16* orow = out + m * Cout;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = n0 + j * 8 + 2 * t;
      if (n < Cout)  // Cout is even, so n + 1 < Cout too
        *reinterpret_cast<__nv_bfloat162*>(orow + n) = __floats2bfloat162_rn(
            acc[j][2 * h] + __ldg(bias + n),
            acc[j][2 * h + 1] + __ldg(bias + n + 1));
    }
  }
}

template <int BN>
cudaError_t launch_mma(const void* x, const void* wh, const void* prev,
                       const void* wv, const void* bias, void* out, int N,
                       const NetStrides& ns, int B, int H, int W, int Cin,
                       int Cprev, int Cout, cudaStream_t stream) {
  const long long M = (long long)B * H * W;
  const long long blocks = (M + BM_BF16 - 1) / BM_BF16;
  if (blocks == 0) return cudaSuccess;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)((Cout + BN - 1) / BN),
                  (unsigned)N);
  mcm_scale_mma<BM_BF16, BN><<<grid, 2 * BM_BF16, 0, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wh),
      static_cast<const bf16*>(prev), static_cast<const bf16*>(wv),
      static_cast<const float*>(bias), static_cast<bf16*>(out), B, H, W, Cin,
      Cprev, Cout, ns);
  return cudaGetLastError();
}

}  // namespace

// Launch one output scale for N nets on `stream`. dtype: 0 = fp32, 1 =
// bf16 (x, wh, prev, wv and out share it; bias is fp32). prev and wv are
// null for the finest kept scale. s_*: the per-net element stride of each
// tensor, 0 where every net shares it. Cout and Cprev must be multiples of
// 4, every pointer and every net's slice 16-byte aligned, and
// 1 <= N <= 65535. Returns the launch's cudaError_t (0 on success).
extern "C" int mcm_scale_forward_nets(
    const void* x, const void* wh, const void* prev, const void* wv,
    const void* bias, void* out, int N, long long s_x, long long s_wh,
    long long s_prev, long long s_wv, long long s_bias, long long s_out,
    int B, int H, int W, int Cin, int Cprev, int Cout, int dtype,
    void* stream) {
  if (N < 1 || N > 65535 || s_x < 0 || s_wh < 0 || s_prev < 0 || s_wv < 0 ||
      s_bias < 0 || s_out < 0 || B < 0 || H <= 0 || W <= 0 || Cin <= 0 ||
      Cout <= 0 || Cout % CO != 0 ||
      (prev != nullptr && (wv == nullptr || Cprev <= 0 || Cprev % 4 != 0)))
    return (int)cudaErrorInvalidValue;
  const NetStrides ns{s_x, s_wh, s_prev, s_wv, s_bias, s_out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      if (Cin % 4 == 0)
        return (int)launch_fp32<4>(x, wh, prev, wv, bias, out, N, ns, B, H,
                                   W, Cin, Cprev, Cout, s);
      return (int)launch_fp32<1>(x, wh, prev, wv, bias, out, N, ns, B, H, W,
                                 Cin, Cprev, Cout, s);
    case 1:
      // The block's width: the least of 16, 32, 64, 128 that holds Cout
      // (every flagship width), else 128-wide column tiles.
      if (Cout <= 16)
        return (int)launch_mma<16>(x, wh, prev, wv, bias, out, N, ns, B, H,
                                   W, Cin, Cprev, Cout, s);
      if (Cout <= 32)
        return (int)launch_mma<32>(x, wh, prev, wv, bias, out, N, ns, B, H,
                                   W, Cin, Cprev, Cout, s);
      if (Cout <= 64)
        return (int)launch_mma<64>(x, wh, prev, wv, bias, out, N, ns, B, H,
                                   W, Cin, Cprev, Cout, s);
      return (int)launch_mma<128>(x, wh, prev, wv, bias, out, N, ns, B, H, W,
                                  Cin, Cprev, Cout, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Launch one output scale of one net: mcm_scale_forward_nets with N = 1.
extern "C" int mcm_scale_forward(const void* x, const void* wh,
                                 const void* prev, const void* wv,
                                 const void* bias, void* out, int B, int H,
                                 int W, int Cin, int Cprev, int Cout,
                                 int dtype, void* stream) {
  return mcm_scale_forward_nets(x, wh, prev, wv, bias, out, 1, 0, 0, 0, 0, 0,
                                0, B, H, W, Cin, Cprev, Cout, dtype, stream);
}

extern "C" const char* mcm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
