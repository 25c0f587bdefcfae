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
// rate of the instructions that carry them: 989 TFLOP/s for bf16 on the
// tensor cores, and for fp32 a third of the TF32 rate of 495 TFLOP/s,
// since each fp32 product costs three TF32 products (3xTF32, below). At the
// flagship's widths (3-128 channels) the fp32 stages are bound by
// operations. In bf16, stages 0-4 (32^2 to 8^2, 3-64 channels) are bound by
// bytes and stages 5-7 (8^2 and 4^2, 64-128 channels) by operations.
// chip_smoke.py computes both bounds for every stage from its shapes.
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
// scale j for all N nets: the grid gains a dimension over nets (z), and
// each block offsets its six pointers by net x that tensor's per-net
// element stride; a stride of 0 shares the tensor by every net (stage 0's
// pyramid, made from the shared batch). Everything
// else is the single-net kernel, so a net's outputs are bit for bit those
// of a single-net launch on its tensors. The wrapper keeps every net's
// slice 16-byte aligned.
//
// fp32 (the checks' and the training CLI's type): an implicit GEMM on the
// tensor cores in 3xTF32, so that it keeps fp32's accuracy. Each value v
// of A and B is split into hi = tf32(v) and lo = tf32(v - hi) (cvt.rna),
// and each product is a_lo*b_hi + a_hi*b_lo + a_hi*b_hi, small terms
// first, through mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32; a_lo*b_lo,
// below fp32's precision, is dropped. A plain TF32 product keeps 11 bits
// and errs by ~3e-4 of max|out|; 3xTF32 keeps ~22. The tensor cores round
// their fp32 sums toward zero, a bias that grows with the length of the
// chain of mma instructions into one accumulator, so every FLUSH mma steps
// the warp adds its accumulators into fp32 totals (rounded to nearest) and
// restarts them from zero. The K loop runs over chunks of 8 channels (of
// x, then of pool2(out[j-1])) and, in each, over the 9 taps. A block owns
// a tile of 128 output pixels (64 for 128-channel blocks): whole image
// rows, or several whole images at the 4^2 and 8^2 scales. Each chunk's
// halo patch (the tile plus a 1-pixel border, zero outside the images) is
// staged once and read by all 9 taps, instead of once a tap. Patches and
// the chunk's 9 B tiles come through a ring of RING slots in shared
// memory, filled by cp.async (16-byte vectors, .cg, zero-filled by a
// source size of 0; input channel counts that are not a multiple of 4, as
// stage 0's 3, one 4-byte .ca copy per value), so two chunks (18 K steps)
// are in flight while one is multiplied. cp.async cannot take a max, so a
// pooled chunk stages the raw 2x2 windows of out[j-1] as four planes. The
// block then splits the chunk's patch into (hi, lo) pairs once (taking the
// windows' max first; in fp32 that equals the max of the TPU kernel's fp32
// accumulators), in rows padded to 12 pairs so that a fragment's 64-bit
// loads fall in distinct banks; B values are split as they are read, from
// rows swizzled for the same purpose. Each output's products are summed in
// the same order whatever the block shape and the number of nets. What
// bounds this design is not the tensor cores (the mma instructions alone
// are a fraction of its time) but the block's phases: the chunk's split
// and its 9 taps' shared-memory traffic, each between barriers. Next
// steps: wgmma with TMA-fed tiles, and warps that split and load while
// others multiply.

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

// ---------------------------------------------------------------- fp32 ----

constexpr int KC = 8;            // channels of a chunk (one mma's depth)
constexpr int RING = 3;          // raw chunk slots of the cp.async ring
constexpr int FLUSH = 8;         // mma K steps per tensor-core chain
constexpr int MIN_BLOCKS = 512;  // smaller blocks below this grid
constexpr int SMEM_TWO = 113 * 1024;  // bytes a block may take, 2 an SM
constexpr int P_MAX = 264;       // pixels of a halo patch, at most
constexpr int S_LD = KC + 4;     // split patch row stride, in pairs
constexpr int THREADS_F32 = 128;

// A block's pixels: NB images x TH rows x TW columns, at most bm (NB > 1
// only where a tile holds whole images), and its halo patch NB x (TH+2) x
// (TW+2) of p pixels.
struct Tile {
  int nb, th, tw, ph, pw, p;
  int nbg, nty, ntx;  // tiles along the batch, rows and columns
};

Tile make_tile(int B, int H, int W, int bm) {
  Tile t;
  t.tw = W < 64 ? W : 64;
  t.th = H < bm / t.tw ? H : bm / t.tw;
  while (t.th > 1 && (t.th + 2) * (t.tw + 2) > P_MAX) --t.th;
  t.ph = t.th + 2;
  t.pw = t.tw + 2;
  t.nb = 1;
  if (t.th == H && t.tw == W) {
    t.nb = bm / (H * W);
    if (t.nb * t.ph * t.pw > P_MAX) t.nb = P_MAX / (t.ph * t.pw);
    if (t.nb < 1) t.nb = 1;
  }
  t.p = t.nb * t.ph * t.pw;
  t.nbg = (B + t.nb - 1) / t.nb;
  t.nty = (H + t.th - 1) / t.th;
  t.ntx = (W + t.tw - 1) / t.tw;
  return t;
}

// Shared memory of a block, in floats: RING raw slots (a chunk's patch as
// loaded, then its 9 taps' B tiles), the split patch (TF32 (hi, lo)
// pairs), then where each patch pixel starts in x and, with a pooled
// segment, where its 2x2 window starts in prev (element offsets, -1
// outside the images).
struct Smem {
  int raw_a, raw, split, tables;
  __host__ __device__ Smem(int p, int bn, bool pooled)
      : raw_a(p * KC * (pooled ? 4 : 1)),
        raw(raw_a + KS * KS * KC * bn),
        split(p * S_LD * 2),
        tables(p * 2 * (pooled ? 2 : 1)) {}
  __host__ __device__ int offsets() const { return RING * raw + split; }
  __host__ __device__ int bytes() const {
    return (offsets() + tables) * (int)sizeof(float);
  }
};

// Where column n of B row k sits in its row: B tiles are stored BN wide,
// with 8-column groups swizzled by the row so that the rows t and t + 4
// (t < 4) that a fragment reads fall in distinct banks.
__host__ __device__ constexpr int b_swizzle(int bn, int k) {
  return bn == 16 ? (k & 2) << 2 : (k & 3) << 3;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from src to shared dst, or 16 zeros where !valid (source size
// 0: nothing is read, src only has to be a global address).
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// One float, or a zero where !valid.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// v = hi + lo + r, hi and lo TF32 values (round to nearest, ties away),
// |r| <= 2^-22 |v|.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(v));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(v - __uint_as_float(hi)));
}

// Four values as two float4s of (hi, lo) pairs at d.
__device__ __forceinline__ void store_split4(float2* d, float4 a) {
  uint32_t h[4], l[4];
  split_tf32(a.x, h[0], l[0]);
  split_tf32(a.y, h[1], l[1]);
  split_tf32(a.z, h[2], l[2]);
  split_tf32(a.w, h[3], l[3]);
  float4* q = reinterpret_cast<float4*>(d);
  q[0] = make_float4(__uint_as_float(h[0]), __uint_as_float(l[0]),
                     __uint_as_float(h[1]), __uint_as_float(l[1]));
  q[1] = make_float4(__uint_as_float(h[2]), __uint_as_float(l[2]),
                     __uint_as_float(h[3]), __uint_as_float(l[3]));
}

// d += a (16x8, row-major) * b (8x8, column-major) in TF32, fp32 sums.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One block: the tile's pixels (up to BM, flattened as image, row, column)
// by channels n0 .. n0+BN-1, 4 warps of WM x WN. The K loop runs over
// chunks of KC channels (of x, then of pool2(prev)) and, in each, over the
// 9 taps. A chunk (its halo patch and its 9 taps' B tiles) comes in by
// cp.async while the previous one is multiplied. Its patch is then split
// into TF32 hi and lo parts once (for a pooled chunk, after the max of
// each 2x2 window) and read by all 9 taps; B values are split as they are
// read. x: (B, H, W, Cin); prev: (B, 2H, 2W, Cprev) or null; out: (B, H,
// W, Cout). Dynamic shared memory: Smem.
template <int BM, int BN>
__global__ void __launch_bounds__(THREADS_F32)
mcm_scale_tf32(const float* __restrict__ x, const float* __restrict__ wh,
               const float* __restrict__ prev, const float* __restrict__ wv,
               const float* __restrict__ bias, float* __restrict__ out, int B,
               int H, int W, int Cin, int Cprev, int Cout, NetStrides ns,
               Tile tl) {
  constexpr int WARPS_N = BN >= 64 && BM == 64 ? 2 : 1;
  constexpr int WARPS_M = THREADS_F32 / 32 / WARPS_N;
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  constexpr int MT = WM / 16, NT = WN / 8;  // mma tiles a warp holds
  constexpr int B_ROW4 = BN / 4;            // 16-byte vectors in a B row
  extern __shared__ __align__(16) float smem[];

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
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.y * BN;
  int r = blockIdx.x;
  const int x0 = (r % tl.ntx) * tl.tw;
  r /= tl.ntx;
  const int y0 = (r % tl.nty) * tl.th;
  const int b0 = (r / tl.nty) * tl.nb;
  const int tpix = tl.th * tl.tw;  // pixels of one image in the tile
  const Smem sm(tl.p, BN, prev != nullptr);
  float2* const split = reinterpret_cast<float2*>(smem + RING * sm.raw);
  long long* const xoff = reinterpret_cast<long long*>(smem + sm.offsets());
  long long* const poff = xoff + tl.p;
  for (int q = tid; q < tl.p; q += THREADS_F32) {
    const int pp = tl.ph * tl.pw, img = q / pp, rq = q % pp;
    const int yy = y0 + rq / tl.pw - 1, xx = x0 + rq % tl.pw - 1;
    const long long b = (long long)b0 + img;
    const bool in = b < B && yy >= 0 && yy < H && xx >= 0 && xx < W;
    xoff[q] = in ? ((b * H + yy) * W + xx) * Cin : -1;
    if (prev != nullptr)
      poff[q] = in ? ((b * 2 * H + 2 * yy) * 2 * W + 2 * xx) * Cprev : -1;
  }

  // This lane's output pixels (rows g and g+8 of each m-tile): where each
  // sits in the patch (its tap (0, 0) corner), and where it goes in `out`
  // (-1 where the tile runs past the images).
  int pb[MT][2];
  long long om[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = wm * WM + i * 16 + g + 8 * h;
      const int img = p / tpix, ty = p % tpix / tl.tw, tx = p % tl.tw;
      const bool ok = img < tl.nb && b0 + img < B && y0 + ty < H &&
                      x0 + tx < W;
      pb[i][h] = ok ? (img * tl.ph + ty) * tl.pw + tx : 0;
      om[i][h] = ok ? (((long long)b0 + img) * H + y0 + ty) * W + x0 + tx
                    : -1;
    }
  }

  // Chunks: x's ceil(Cin / KC), then pool2(prev)'s ceil(Cprev / KC).
  const int nx = (Cin + KC - 1) / KC;
  const int n_chunks = nx + (prev ? (Cprev + KC - 1) / KC : 0);

  // Global -> raw, asynchronously: chunk c's halo patch, zero outside the
  // images and past the channel count (for x, pixel q's KC channels; for
  // pool2(prev), plane u of q holds pixel u of its 2x2 window of prev),
  // and its 9 taps' B tiles (rows: the chunk's channels of the weight
  // matrix; columns n0 .. n0+BN-1).
  auto issue_chunk = [&](int c, float* raw) {
    const bool pool = c >= nx;
    const int c0 = (pool ? c - nx : c) * KC;
    if (pool) {  // 4 planes x KC / 4 vectors a pixel
      for (int v = tid; v < tl.p * KC; v += THREADS_F32) {
        const int q = v / KC, u = v % KC / (KC / 4), c4 = v % (KC / 4) * 4;
        const long long o = poff[q];
        const bool ok = o >= 0 && c0 + c4 < Cprev;  // Cprev % 4 == 0
        cp_async16(raw + (u * tl.p + q) * KC + c4,
                   ok ? prev + o + ((u >> 1) * 2LL * W + (u & 1)) * Cprev +
                            c0 + c4
                      : prev,
                   ok);
      }
    } else if (Cin % 4 == 0) {  // KC / 4 vectors a pixel
      for (int v = tid; v < tl.p * (KC / 4); v += THREADS_F32) {
        const int q = v / (KC / 4), c4 = v % (KC / 4) * 4;
        const long long o = xoff[q];
        const bool ok = o >= 0 && c0 + c4 < Cin;
        cp_async16(raw + q * KC + c4, ok ? x + o + c0 + c4 : x, ok);
      }
    } else {  // one float at a time
      for (int v = tid; v < tl.p * KC; v += THREADS_F32) {
        const int q = v / KC, e = v % KC;
        const long long o = xoff[q];
        const bool ok = o >= 0 && c0 + e < Cin;
        cp_async4(raw + q * KC + e, ok ? x + o + c0 + e : x, ok);
      }
    }
    const float* w = pool ? wv : wh;
    const int C = pool ? Cprev : Cin;
    for (int v = tid; v < KS * KS * KC * B_ROW4; v += THREADS_F32) {
      const int col = (v % B_ROW4) * 4, tr = v / B_ROW4;  // tap * KC + row
      const int row = tr % KC, n = n0 + col;
      const bool ok = c0 + row < C && n < Cout;  // Cout % 4 == 0
      cp_async16(raw + sm.raw_a + tr * BN + (col ^ b_swizzle(BN, row)),
                 ok ? w + ((long long)(tr / KC) * C + c0 + row) * Cout + n
                    : w,
                 ok);
    }
  };

  // Raw slot -> split patch: each value of chunk c's patch (for a pooled
  // chunk the max of its 2x2 window) as its TF32 (hi, lo) pair.
  auto split_chunk = [&](int c, const float* raw) {
    const float4* r4 = reinterpret_cast<const float4*>(raw);
    const int n4 = tl.p * (KC / 4);  // float4s of a plane
    if (c >= nx) {
      for (int v = tid; v < n4; v += THREADS_F32) {
        const float4 a0 = r4[v], a1 = r4[v + n4], a2 = r4[v + 2 * n4],
                     a3 = r4[v + 3 * n4];
        store_split4(split + v / (KC / 4) * S_LD + v % (KC / 4) * 4,
                     make_float4(fmaxf(fmaxf(a0.x, a1.x), fmaxf(a2.x, a3.x)),
                                 fmaxf(fmaxf(a0.y, a1.y), fmaxf(a2.y, a3.y)),
                                 fmaxf(fmaxf(a0.z, a1.z), fmaxf(a2.z, a3.z)),
                                 fmaxf(fmaxf(a0.w, a1.w),
                                       fmaxf(a2.w, a3.w))));
      }
    } else {
      for (int v = tid; v < n4; v += THREADS_F32)
        store_split4(split + v / (KC / 4) * S_LD + v % (KC / 4) * 4, r4[v]);
    }
  };

  float acc[MT][NT][4];  // the current tensor-core chain
  float tot[MT][NT][4];  // fp32 totals of the finished chains
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = tot[i][j][e] = 0.f;
  int chain = 0;  // mma steps in the current chain
  auto flush = [&]() {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          tot[i][j][e] += acc[i][j][e];
          acc[i][j][e] = 0.f;
        }
    chain = 0;
  };

  // This lane's B columns within a tile row, swizzled (b_swizzle).
  int bcol[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j)
    bcol[j] = (wn * WN + j * 8 + g) ^ b_swizzle(BN, t);

  // One tap: A fragments from the split patch shifted by the tap, B
  // fragments from the tap's tile in the raw slot `raw`, split as read;
  // each tile takes the small terms, then the large one.
  auto mma_tap = [&](const float* raw, int tap) {
    uint32_t ahi[MT][4], alo[MT][4], bhi[NT][2], blo[NT][2];
    const float2* as = split + ((tap / KS) * tl.pw + tap % KS) * S_LD + t;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
        const float2 v = as[pb[i][e & 1] * S_LD + (e >> 1) * 4];
        ahi[i][e] = __float_as_uint(v.x);
        alo[i][e] = __float_as_uint(v.y);
      }
    }
    const float* bs = raw + sm.raw_a + (tap * KC + t) * BN;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      // b0 (k t, n g), b1 (k t+4, n g): one swizzle, as (t+4) & 3 == t
      split_tf32(bs[bcol[j]], bhi[j][0], blo[j][0]);
      split_tf32(bs[4 * BN + bcol[j]], bhi[j][1], blo[j][1]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < MT; ++i)
        mma_tf32(acc[i][j], alo[i], bhi[j][0], bhi[j][1]);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < MT; ++i)
        mma_tf32(acc[i][j], ahi[i], blo[j][0], blo[j][1]);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < MT; ++i)
        mma_tf32(acc[i][j], ahi[i], bhi[j][0], bhi[j][1]);
    if (++chain == FLUSH) flush();
  };

  // A ring of RING raw slots and one split patch: chunks c + 1 .. c +
  // RING - 1 load while chunk c is split and multiplied, one commit group
  // a chunk (empty past the last, so the count of groups stays exact); two
  // barriers a chunk.
  __syncthreads();  // the offset tables are complete
#pragma unroll
  for (int c = 0; c < RING - 1; ++c) {
    if (c < n_chunks) issue_chunk(c, smem + c * sm.raw);
    cp_async_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    const float* raw = smem + (c % RING) * sm.raw;
    cp_async_wait<RING - 2>();  // this thread's copies of chunk c landed
    // Everyone's copies of chunk c are visible, and everyone is done with
    // chunk c - 1: the split patch, and the raw slot that the next issue
    // takes.
    __syncthreads();
    const int f = c + RING - 1;
    if (f < n_chunks) issue_chunk(f, smem + (f % RING) * sm.raw);
    cp_async_commit();
    split_chunk(c, raw);
    __syncthreads();  // the split patch is complete
#pragma unroll 1
    for (int tap = 0; tap < KS * KS; ++tap) mma_tap(raw, tap);
  }
  flush();

  // Epilogue: the thread holds rows g and g+8 of each of its warp's m-tiles,
  // columns 2t, 2t+1 of each n-tile. Bias, then float pairs to NHWC.
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (om[i][h] < 0) continue;
      float* orow = out + om[i][h] * Cout;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = n0 + wn * WN + j * 8 + 2 * t;
        if (n < Cout)  // Cout is even, so n + 1 < Cout too
          *reinterpret_cast<float2*>(orow + n) =
              make_float2(tot[i][j][2 * h] + __ldg(bias + n),
                          tot[i][j][2 * h + 1] + __ldg(bias + n + 1));
      }
    }
  }
}

template <int BM, int BN>
cudaError_t launch_tf32(const void* x, const void* wh, const void* prev,
                        const void* wv, const void* bias, void* out, int N,
                        const NetStrides& ns, int B, int H, int W, int Cin,
                        int Cprev, int Cout, const Tile& tl,
                        long long blocks, cudaStream_t stream) {
  constexpr int MAX_DEVICES = 64;
  static int opted_in[MAX_DEVICES];  // bytes allowed so far, per device
  const int smem = Smem(tl.p, BN, prev != nullptr).bytes();
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && smem > opted_in[dev]) {
    err = cudaFuncSetAttribute(mcm_scale_tf32<BM, BN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    opted_in[dev] = smem;
  }
  const dim3 grid((unsigned)blocks, (unsigned)((Cout + BN - 1) / BN),
                  (unsigned)N);
  mcm_scale_tf32<BM, BN><<<grid, THREADS_F32, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(wh),
      static_cast<const float*>(prev), static_cast<const float*>(wv),
      static_cast<const float*>(bias), static_cast<float*>(out), B, H, W, Cin,
      Cprev, Cout, ns, tl);
  return cudaGetLastError();
}

// The fp32 block: BN channels, the least of 16, 32, 64 and 128 that holds
// Cout (else 128-wide column tiles), by 128 pixels (64 where BN = 128).
// Where that grid has fewer than MIN_BLOCKS blocks (a small M: the deep
// stages at a small batch), the block takes 64 pixels, then halves BN, so
// that the work still spreads over the SMs; and BN halves while a block
// needs more shared memory than two blocks an SM leave it. Each output's
// arithmetic is the same in every block shape.
cudaError_t launch_fp32(const void* x, const void* wh, const void* prev,
                        const void* wv, const void* bias, void* out, int N,
                        const NetStrides& ns, int B, int H, int W, int Cin,
                        int Cprev, int Cout, cudaStream_t s) {
  if (B == 0) return cudaSuccess;
  int bn = Cout <= 16 ? 16 : Cout <= 32 ? 32 : Cout <= 64 ? 64 : 128;
  int bm = bn == 128 ? 64 : 128;
  Tile tl = make_tile(B, H, W, bm);
  long long blocks = (long long)tl.nbg * tl.nty * tl.ntx;
  auto grid = [&]() { return blocks * ((Cout + bn - 1) / bn) * N; };
  if (bm == 128 && grid() < MIN_BLOCKS) {
    bm = 64;
    tl = make_tile(B, H, W, bm);
    blocks = (long long)tl.nbg * tl.nty * tl.ntx;
  }
  while (bn > 16 && grid() < MIN_BLOCKS) bn /= 2;
  while (bn > 16 && Smem(tl.p, bn, prev != nullptr).bytes() > SMEM_TWO)
    bn /= 2;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
#define MCM_TF32(BM_, BN_)                                                 \
  return launch_tf32<BM_, BN_>(x, wh, prev, wv, bias, out, N, ns, B, H, W, \
                               Cin, Cprev, Cout, tl, blocks, s)
  if (bm == 128) {
    if (bn == 16) MCM_TF32(128, 16);
    if (bn == 32) MCM_TF32(128, 32);
    MCM_TF32(128, 64);
  }
  if (bn == 16) MCM_TF32(64, 16);
  if (bn == 32) MCM_TF32(64, 32);
  if (bn == 64) MCM_TF32(64, 64);
  MCM_TF32(64, 128);
#undef MCM_TF32
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
      Cout <= 0 || Cout % 4 != 0 ||
      (prev != nullptr && (wv == nullptr || Cprev <= 0 || Cprev % 4 != 0)))
    return (int)cudaErrorInvalidValue;
  const NetStrides ns{s_x, s_wh, s_prev, s_wv, s_bias, s_out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch_fp32(x, wh, prev, wv, bias, out, N, ns, B, H, W,
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
