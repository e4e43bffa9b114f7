// Fused Fisher-vector encoding for Hopper (sm_90a).
//
// Replaces the TPU kernel keystone_tpu/ops/fisher_vector_pallas.py::_fv_kernel
// (launched by _fv_pallas through pl.pallas_call). Per image b, over its m
// descriptors x_i (d-dim) and a diagonal GMM of k components:
//
//   logit_ij = bias_j + x_i²·(-½ inv_j) + x_i·(mu/var)_j,
//              bias_j = log w_j + log N-normaliser_j - ½ Σ mu²/var_j
//   r_ij     = softmax_j(logit_ij)          (rows i >= m contribute nothing)
//   rs_j = Σ_i r_ij,  g1_j = Σ_i r_ij (x_i - mu_j),  c2_j = Σ_i r_ij (x_i - mu_j)²
//   gmu_j  = g1_j / sigma_j                    · 1/(m √w_j)
//   gvar_j = (c2_j inv_j - rs_j)               · 1/(m √(2 w_j))
//
// out[b] = [gmu | gvar], each k-major: (B, 2·k·d). The responsibilities r never
// leave the SM, as on the TPU.
//
// The statistics are summed in centred form. The TPU kernel sums rᵀx and rᵀx²
// and forms t2 - 2 mu t1 + rs mu²: on a GMM fitted to real descriptors, with
// variances at the 1e-4 floor and |mu| near 1, those terms are 10⁴ times the
// result, and float32 loses it. Here x - mu is formed first, as the native
// encoder does.
//
// What bounds it on the H100: operations. The logits product (m × 2d × k) is
// 4·m·k·d FLOP an image, on the tensor cores in 3xTF32: every float32 operand
// v is split into hi = tf32(v) and lo = tf32(v - hi), and a·b is hi·hi +
// hi·lo + lo·hi with float32 accumulation, which keeps float32-level accuracy
// (plain TF32 keeps ~3 digits, and on a fitted GMM the terms of the quadratic
// form are ~10³ while the logits are ~1): 3 × 4·m·k·d TF32 FLOP at the
// published 495 TFLOP/s. The centred statistics are 5·m·k·d float32 FLOP on
// the CUDA cores (a difference, a product, a sum and a fused multiply-add for
// each of the m·k·d terms) at 67 TFLOP/s: 0.291 ms for a 64-image bucket at
// m = 3721, k = 256, d = 64, three times the logits' 0.095 ms. The bytes are
// never the limit (61 MB of descriptors at B = 64 take 0.018 ms at 3.35 TB/s).
//
// The design:
// - One block of 4 warpgroups (16 warps) per SM. Warpgroup w owns components
//   [64w, 64w + 64), the M side of the logits product, as wgmma.m64n32k8
//   (tf32, float32 accumulators) with A from registers and B from shared
//   memory.
// - Descriptor tiles of 32 rows stream through a ring of 3 stages in shared
//   memory filled by cp.async (16 bytes a thread, zero-filled past the range),
//   so the next two tiles load while this one is used. Once a tile has
//   landed, the block splits it once into TF32 hi/lo pairs of x and x² and
//   writes them as the B operand of the product, K-major in 8 × 16-byte core
//   matrices (no swizzle): [x² | x] with K = the 2d features and N = the 32
//   rows. Tile rows are padded to d + 4 floats, which keeps the split's loads
//   free of bank conflicts.
// - The product, transposed: logitsᵀ (64 comps × 32 rows) = W'ᵀ · [x² | x]ᵀ,
//   depth 2d, W' = [-½ inv ; -½ m2] (the wrapper's (d, k) constants). W' sits
//   in shared memory once per block as float32 in A-fragment order (one
//   16-byte load per fragment, no bank conflicts), 128 KB at d=64, and is
//   split into hi/lo in registers, two k-steps at a time; hi/lo pairs of W'
//   would not fit (256 KB).
// - Softmax over all k in registers: each warp takes its rows' max and sum of
//   exponentials over its 16 components with warp shuffles, the 16 warps
//   exchange (max, sum) per row through 4 KB of shared memory, and each row
//   gets one scale exp(max_w - max)/sum. Padding components (k up to 256)
//   have logit -inf and r = 0; rows past the block's range get r = 0.
// - r goes to shared memory, (32 rows × 256 comps), and thread (comp, half)
//   sums rs, g1 and c2 of its component over the tile's rows for the d/2
//   features of its half: 2 × d/2 float32 sums in registers across the
//   block's whole row range, 64 of the 128 registers a thread can have at
//   512 threads. Threads of padding components skip the sums.
// - Shared memory at d=64: W' 128 KB, the split tile 32 KB, r 32.5 KB, the
//   ring 3 × 8.5 KB, the softmax exchange 6 KB: 224 KB of the 227 KB a block
//   may have.
// - Split plan (ops/fisher_vector.py::split_plan): each image's m axis is cut
//   into S splits of whole tiles, at least 2 tiles (64 rows) each, with S
//   chosen so that the B·S blocks make as few, as full waves as they can:
//   S = 59 at B=1, 30 at B=4, 8 at B=16, 2 at B=64 on 132 SMs. Block (s, b)
//   writes its split's rs, g1, c2 to a (B, S, ...) scratch, and a second
//   kernel sums the S partials of each image in a fixed order (no atomics:
//   the same bits from run to run) and applies the scalings.
//
// Interface: plain C, called through ctypes. The caller allocates every
// buffer; the launches go on the given stream and the function returns
// cudaGetLastError() (0 on success) without synchronising.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kK = 256;                  // components, padded; k <= 256
constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;    // 512
constexpr int kTileM = 32;               // descriptor rows per tile
constexpr int kRowTiles = kTileM / 8;    // 8-row groups of a tile in product 1's accumulators
constexpr int kStages = 3;               // depth of the cp.async ring
constexpr int kChunk = 2;                // product 1's k-steps per wgmma group
constexpr int kRStride = kK + 4;         // padded row of the responsibilities in shared memory
constexpr unsigned kFull = 0xffffffffu;

static_assert(kK == 16 * kWarps, "each warp owns 16 components, each warpgroup 64");
static_assert(kTileM * kWarps == kThreads, "the softmax exchange maps one thread to (row, warp)");
static_assert(2 * kK == kThreads, "the statistics map one thread to (component, half of the features)");

// Round to TF32 (10 mantissa bits), to nearest with ties away from zero: what
// cvt.rna.tf32.f32 does for finite v, in two integer operations (on sm_90a
// that cvt compiles to a longer sequence that also handles NaN).
__device__ __forceinline__ uint32_t to_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v ≈ hi + lo, both TF32: hi = tf32(v), and lo = v - hi (exact in float32)
// cut to TF32 toward zero, one AND where rounding takes two dependent
// operations. The cut loses under 2^-21 of v, the order of the lo·lo term
// (under 2^-22 of the product) that 3xTF32 drops.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(v);
  lo = __float_as_uint(v - __uint_as_float(hi)) & 0xffffe000u;
}

__device__ __forceinline__ void split4(float4 v, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split(v.x, hi[0], lo[0]);
  split(v.y, hi[1], lo[1]);
  split(v.z, hi[2], lo[2]);
  split(v.w, hi[3], lo[3]);
}

// d += a·b over one k-step of 8: wgmma.m64nNk8, tf32 in, float32 out. A (64
// × 8) from registers, in mma.sync's A-fragment layout per warp; B (8 × N)
// from shared memory through the descriptor. d[j][0..3] are this thread's
// (row g, col 8j + 2t), (g, 8j + 2t + 1), (g + 8, 8j + 2t), (g + 8, 8j + 2t + 1)
// of its warp's 16 rows.
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 8][4], const uint32_t (&a)[4],
                                           uint64_t desc);

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[4][4], const uint32_t (&a)[4],
                                                 uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      :
        "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Shared-memory writes of this thread become visible to the tensor cores'
// (async proxy's) reads after the next barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma matrix descriptor of a K-major operand in 8-row × 16-byte core
// matrices, no swizzle: lbo is the byte step between core matrices along K,
// sbo the step between 8-row groups.
__device__ __forceinline__ uint64_t smem_desc(const float* p, uint32_t lbo, uint32_t sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// 16 bytes global → shared, asynchronously; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int D>
constexpr size_t smem_bytes() {
  // W' fragments, product 1's split tile (hi and lo), the tile's
  // responsibilities, the tile ring, the (max, sum) exchange and the row
  // scales.
  return sizeof(float) * ((size_t)kK * 2 * D + 4 * D * kTileM + (size_t)kTileM * kRStride +
                          kStages * kTileM * (D + 4) + 3 * kTileM * kWarps);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
fv_partial_kernel(const float* __restrict__ X,      // (B, m, D)
                  const float* __restrict__ inv_t,  // (D, k)  1/var, transposed
                  const float* __restrict__ m2_t,   // (D, k)  -2 mu/var, transposed
                  const float* __restrict__ bias,   // (k)     logw_norm - 0.5 Σ mu²/var
                  const float* __restrict__ mu,     // (k, D)
                  float* __restrict__ part,         // (B, S, 2, k, D)  g1, c2
                  float* __restrict__ part_rs,      // (B, S, k)
                  int m, int k, int S, int rows_per_split) {
  constexpr int kGroups = D / 8;      // 8-feature groups: k-steps of each half of product 1
  constexpr int kSteps = 2 * kGroups; // k-steps of product 1 (depth 2D)
  constexpr int kStride = D + 4;      // padded row of a descriptor tile
  constexpr int kHalf = D / 2;        // features of one thread's statistics
  constexpr int kPass = kHalf < 16 ? kHalf : 16;  // of them per pass over the tile
  extern __shared__ __align__(128) float smem[];
  float4* s_w = reinterpret_cast<float4*>(smem);  // [warp][step][lane] A fragments
  float* s_p1h = smem + (size_t)kK * 2 * D;       // product 1's B, hi and lo,
  float* s_p1l = s_p1h + 2 * D * kTileM;          //   in core matrices [row / 8][K / 4]
  float* s_r = s_p1l + 2 * D * kTileM;            // [row][kRStride] responsibilities
  float* s_x = s_r + kTileM * kRStride;           // [stage][kTileM][kStride]
  float2* s_red = reinterpret_cast<float2*>(s_x + kStages * kTileM * kStride);  // [row][warp]
  float* s_scale = reinterpret_cast<float*>(s_red + kTileM * kWarps);           // [row][warp]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // MMA fragment coordinates
  const int s = blockIdx.x, b = blockIdx.y;
  const int row0 = s * rows_per_split;
  const int row1 = min(m, row0 + rows_per_split);
  const int ntiles = (row1 - row0 + kTileM - 1) / kTileM;
  const float* Xb = X + (size_t)b * m * D;

  // Tile i of the split into ring stage i % kStages; one commit group per
  // call, empty past the last tile, so that the wait below counts uniformly.
  auto load_tile = [&](int i) {
    if (i < ntiles) {
      float* dst = s_x + (i % kStages) * kTileM * kStride;
      const int base = row0 + i * kTileM;
      for (int c = tid; c < kTileM * D / 4; c += kThreads) {
        const int r = c / (D / 4), c4 = c % (D / 4);
        const bool ok = base + r < row1;
        cp_async16(dst + r * kStride + 4 * c4, ok ? Xb + (size_t)(base + r) * D + 4 * c4 : Xb, ok);
      }
    }
    cp_async_commit();
  };
  for (int i = 0; i < kStages - 1; ++i) load_tile(i);

  // W'(comp, f) = -½ inv (f < D) or -½ m2 = mu/var (f >= D), 0 past k, as
  // the A fragments of product 1: fragment n = (warp wq, k-step st, lane
  // (g', t')) holds comps 16 wq + g' (+ 8) × features 8 st + t' (+ 4). One
  // 16-byte store each, consecutive across the threads.
  auto w_elem = [&](int comp, int f) {
    if (comp >= k) return 0.f;
    return -0.5f * (f < D ? inv_t[f * k + comp] : m2_t[(f - D) * k + comp]);
  };
#pragma unroll 4
  for (int n = tid; n < kWarps * kSteps * 32; n += kThreads) {
    const int ln = n & 31, st = (n >> 5) % kSteps, wq = (n >> 5) / kSteps;
    const int comp = 16 * wq + (ln >> 2), f = 8 * st + (ln & 3);
    s_w[n] = make_float4(w_elem(comp, f), w_elem(comp + 8, f), w_elem(comp, f + 4),
                         w_elem(comp + 8, f + 4));
  }
  const int c_lo = 16 * warp + g, c_hi = c_lo + 8;  // this thread's two components in product 1
  const float bias_lo = c_lo < k ? bias[c_lo] : -INFINITY;
  const float bias_hi = c_hi < k ? bias[c_hi] : -INFINITY;
  const float4* w_frag = s_w + warp * kSteps * 32 + lane;

  // The statistics: thread (comp, half) sums, for its component and the
  // kHalf features of its half, g1 = Σ r (x - mu) and c2 = Σ r (x - mu)²,
  // and rs = Σ r. Warp w keeps the components w owns in product 1.
  const int comp = tid >> 1, f0 = (tid & 1) * kHalf;
  const float* mu_c = mu + (size_t)comp * D + f0;
  float g1[kHalf] = {}, c2[kHalf] = {};
  float rs = 0.f;

  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<kStages - 2>();  // tile i has landed (for this thread's copies)
    __syncthreads();               // ... for everyone's; tile i - 1 is consumed
    load_tile(i + kStages - 1);
    const float* xs = s_x + (i % kStages) * kTileM * kStride;
    const int base = row0 + i * kTileM;

    // Split tile i once into TF32 hi/lo of x and x², written as product 1's
    // B, [x² | x] (K = 2D features, N = rows), K-major in 8-row × 16-byte
    // core matrices: element (row rho, K) at core matrix (rho / 8, K / 4),
    // its row rho % 8, column K % 4.
    for (int e = tid; e < kTileM * D; e += kThreads) {
      const int f_lo = e & 7, kq = (e >> 3) & 3, rest = e >> 5;
      const int fb = rest % kGroups, par = (rest / kGroups) & 1, st = rest / (2 * kGroups);
      const int rho = 8 * st + 2 * kq + par, f = 8 * fb + f_lo;
      const float v = xs[rho * kStride + f];
      uint32_t h, l, h2, l2;
      split(v, h, l);
      split(v * v, h2, l2);
      const int q1 = (st * (D / 2) + f / 4) * 32 + (rho & 7) * 4 + (f & 3);  // x², K = f
      const int q2 = q1 + (D / 4) * 32;                                      // x, K = D + f
      s_p1h[q1] = __uint_as_float(h2);
      s_p1l[q1] = __uint_as_float(l2);
      s_p1h[q2] = __uint_as_float(h);
      s_p1l[q2] = __uint_as_float(l);
    }
    fence_proxy_async();

    // Product 1: logitsᵀ of comps (c_lo, c_hi) × rows 8j + (2t, 2t + 1). A =
    // W' fragments split in registers, kChunk k-steps a group; B = [x² | x]
    // (k-step st starts at core matrix 2 st, 8-row groups (D / 2) · 128 bytes
    // apart).
    float acc1[kRowTiles][4] = {};
    __syncthreads();  // the split tile is complete
#pragma unroll
    for (int st = 0; st < kSteps; st += kChunk) {
      uint32_t a_hi[kChunk][4], a_lo[kChunk][4];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) split4(w_frag[(st + u) * 32], a_hi[u], a_lo[u]);
      wgmma_fence();
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const uint64_t dh = smem_desc(s_p1h + 2 * (st + u) * 32, 128, (D / 2) * 128);
        const uint64_t dl = smem_desc(s_p1l + 2 * (st + u) * 32, 128, (D / 2) * 128);
        wgmma_tf32<kTileM>(acc1, a_lo[u], dh);
        wgmma_tf32<kTileM>(acc1, a_hi[u], dl);
        wgmma_tf32<kTileM>(acc1, a_hi[u], dh);
      }
      wgmma_commit();
      wgmma_wait_all();
    }

    // Softmax, step 1: each warp's max and sum of exponentials over its 16
    // components, for each row. A warp of padding components has max -inf
    // and sum 0.
#pragma unroll
    for (int j = 0; j < kRowTiles; ++j) {
      float* c = acc1[j];
      c[0] += bias_lo;
      c[1] += bias_lo;
      c[2] += bias_hi;
      c[3] += bias_hi;
      float m0 = fmaxf(c[0], c[2]), m1 = fmaxf(c[1], c[3]);
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        m0 = fmaxf(m0, __shfl_xor_sync(kFull, m0, off));
        m1 = fmaxf(m1, __shfl_xor_sync(kFull, m1, off));
      }
      const float z0 = m0 == -INFINITY ? 0.f : m0, z1 = m1 == -INFINITY ? 0.f : m1;
      c[0] = expf(c[0] - z0);
      c[1] = expf(c[1] - z1);
      c[2] = expf(c[2] - z0);
      c[3] = expf(c[3] - z1);
      float s0 = c[0] + c[2], s1 = c[1] + c[3];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s0 += __shfl_xor_sync(kFull, s0, off);
        s1 += __shfl_xor_sync(kFull, s1, off);
      }
      if (g == 0) {
        s_red[(8 * j + 2 * t) * kWarps + warp] = make_float2(m0, s0);
        s_red[(8 * j + 2 * t + 1) * kWarps + warp] = make_float2(m1, s1);
      }
    }
    __syncthreads();

    // Step 2: thread (row, warp) turns the 16 warps' (max, sum) of its row
    // into that warp's scale exp(max_w - max) / sum, 0 for rows past the
    // range. The row max is finite: component 0 is real.
    {
      const int row = tid >> 4, wq = tid & 15;
      const float2 p = s_red[row * kWarps + wq];
      float mx = p.x;
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float f = expf(p.x - mx);
      float tot = p.y * f;
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) tot += __shfl_xor_sync(kFull, tot, off);
      s_scale[row * kWarps + wq] = base + row < row1 ? f / tot : 0.f;
    }
    __syncthreads();

    // Step 3: r = exponential · scale, to shared memory as [row][comp]. The
    // row stride kRStride = kK + 4 puts a warp's 32 stores in 32 banks.
#pragma unroll
    for (int j = 0; j < kRowTiles; ++j) {
      const int row = 8 * j + 2 * t;
      const float sc0 = s_scale[row * kWarps + warp];
      const float sc1 = s_scale[(row + 1) * kWarps + warp];
      const float* c = acc1[j];
      s_r[row * kRStride + c_lo] = c[0] * sc0;
      s_r[(row + 1) * kRStride + c_lo] = c[1] * sc1;
      s_r[row * kRStride + c_hi] = c[2] * sc0;
      s_r[(row + 1) * kRStride + c_hi] = c[3] * sc1;
    }
    __syncthreads();

    // The centred statistics of the tile, on the CUDA cores in float32:
    // the differences x - mu are formed before any product, so no large
    // terms cancel, however small the variances. kPass features a pass
    // keep their means in registers; the tile's r and x are read from
    // shared memory (a warp reads 16 consecutive r, and x at two addresses).
    if (comp < k) {
#pragma unroll
      for (int p = 0; p < kHalf; p += kPass) {
        float mu_p[kPass];
#pragma unroll
        for (int q = 0; q < kPass; q += 4) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(mu_c + p + q));
          mu_p[q] = v.x;
          mu_p[q + 1] = v.y;
          mu_p[q + 2] = v.z;
          mu_p[q + 3] = v.w;
        }
#pragma unroll 1
        for (int row = 0; row < kTileM; ++row) {
          const float r = s_r[row * kRStride + comp];
          if (p == 0) rs += r;
          const float* xr = xs + row * kStride + f0 + p;
#pragma unroll
          for (int q = 0; q < kPass; q += 4) {
            const float4 x4 = *reinterpret_cast<const float4*>(xr + q);
            const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const float dx = xv[u] - mu_p[q + u];
              const float rd = r * dx;
              g1[p + q + u] += rd;
              c2[p + q + u] = fmaf(rd, dx, c2[p + q + u]);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // The split's partials.
  if (comp < k) {
    const size_t slot = (size_t)b * S + s;
    if (f0 == 0) part_rs[slot * k + comp] = rs;
    float* p1 = part + (slot * 2 * k + comp) * D + f0;
    float* p2 = p1 + (size_t)k * D;
#pragma unroll
    for (int q = 0; q < kHalf; q += 4) {
      *reinterpret_cast<float4*>(p1 + q) = make_float4(g1[q], g1[q + 1], g1[q + 2], g1[q + 3]);
      *reinterpret_cast<float4*>(p2 + q) = make_float4(c2[q], c2[q + 1], c2[q + 2], c2[q + 3]);
    }
  }
}

// Sums the S partials of one (image, component) in a fixed order and applies
// the Fisher-vector scalings. Block (j, b); thread (c, p) sums, for feature
// c, the splits p, p + kReduceWays, ... in increasing order, and thread
// (c, 0) adds the kReduceWays sums in the order of p.
constexpr int kReduceWays = 4;

template <int D>
__global__ void __launch_bounds__(D * kReduceWays)
fv_reduce_kernel(const float* __restrict__ part,     // (B, S, 2, k, D)
                 const float* __restrict__ part_rs,  // (B, S, k)
                 const float* __restrict__ sigma,    // (k, D)
                 const float* __restrict__ inv,      // (k, D)
                 const float* __restrict__ w,        // (k) floored weights
                 float* __restrict__ out,            // (B, 2·k·D)
                 int m, int k, int S) {
  __shared__ float sums[3][kReduceWays][D];
  const int j = blockIdx.x;
  const int b = blockIdx.y;
  const int c = threadIdx.x, p = threadIdx.y;
  float s1 = 0.f, s2 = 0.f, rs = 0.f;
#pragma unroll 4
  for (int s = p; s < S; s += kReduceWays) {
    const size_t slot = (size_t)b * S + s;
    s1 += part[(slot * 2 + 0) * k * D + (size_t)j * D + c];
    s2 += part[(slot * 2 + 1) * k * D + (size_t)j * D + c];
    rs += part_rs[slot * k + j];
  }
  sums[0][p][c] = s1;
  sums[1][p][c] = s2;
  sums[2][p][c] = rs;
  __syncthreads();
  if (p != 0) return;
#pragma unroll
  for (int q = 1; q < kReduceWays; ++q) {
    s1 += sums[0][q][c];
    s2 += sums[1][q][c];
    rs += sums[2][q][c];
  }
  const float gmu = s1 / sigma[j * D + c];
  const float gvar = s2 * inv[j * D + c] - rs;
  const float wj = w[j];
  const float cm = 1.f / ((float)m * sqrtf(wj));
  const float cv = 1.f / ((float)m * sqrtf(2.f * wj));
  float* ob = out + (size_t)b * 2 * k * D;
  ob[(size_t)j * D + c] = gmu * cm;
  ob[(size_t)k * D + (size_t)j * D + c] = gvar * cv;
}

template <int D>
int launch(const float* X, const float* inv_t, const float* m2_t, const float* bias,
           const float* mu, const float* sigma, const float* inv, const float* w,
           float* part, float* part_rs, float* out, int B, int m, int k, int S,
           int rows_per_split, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      fv_partial_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fv_partial_kernel<D><<<dim3(S, B), kThreads, smem, stream>>>(
      X, inv_t, m2_t, bias, mu, part, part_rs, m, k, S, rows_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fv_reduce_kernel<D><<<dim3(k, B), dim3(D, kReduceWays), 0, stream>>>(
      part, part_rs, sigma, inv, w, out, m, k, S);
  return (int)cudaGetLastError();
}

// Blocks of fv_partial_kernel<D> resident on one SM, as the runtime counts
// them from its registers, threads and shared memory; -1 on an error.
template <int D>
int resident_blocks() {
  const size_t smem = smem_bytes<D>();
  if (cudaFuncSetAttribute(fv_partial_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess) {
    return -1;
  }
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fv_partial_kernel<D>, kThreads, smem) !=
      cudaSuccess) {
    return -1;
  }
  return n;
}

}  // namespace

extern "C" int keystone_fv_encode(const float* X, const float* inv_t, const float* m2_t,
                                  const float* bias, const float* mu, const float* sigma,
                                  const float* inv, const float* w, float* part,
                                  float* part_rs, float* out, int B, int m, int d, int k,
                                  int S, int rows_per_split, void* stream) {
  if (B < 1 || m < 1 || k < 1 || k > kK || S < 1 || rows_per_split < 1 ||
      rows_per_split % kTileM != 0 || (S - 1) * rows_per_split >= m) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 8:
      return launch<8>(X, inv_t, m2_t, bias, mu, sigma, inv, w, part, part_rs, out, B, m,
                       k, S, rows_per_split, st);
    case 16:
      return launch<16>(X, inv_t, m2_t, bias, mu, sigma, inv, w, part, part_rs, out, B, m,
                        k, S, rows_per_split, st);
    case 32:
      return launch<32>(X, inv_t, m2_t, bias, mu, sigma, inv, w, part, part_rs, out, B, m,
                        k, S, rows_per_split, st);
    case 64:
      return launch<64>(X, inv_t, m2_t, bias, mu, sigma, inv, w, part, part_rs, out, B, m,
                        k, S, rows_per_split, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int keystone_fv_tile_rows() { return kTileM; }
extern "C" int keystone_fv_max_components() { return kK; }

// Blocks of kThreads threads resident per SM for descriptors of width d; -1
// for a width the kernel does not take.
extern "C" int keystone_fv_resident_blocks(int d) {
  switch (d) {
    case 8: return resident_blocks<8>();
    case 16: return resident_blocks<16>();
    case 32: return resident_blocks<32>();
    case 64: return resident_blocks<64>();
    default: return -1;
  }
}
